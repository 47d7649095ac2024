"""The continuous batcher and page allocator of arcquant_tpu_torch held
against the JAX package's.

  - PageAllocator: the same random alloc / share / register / release
    sequences (with evictions under pool pressure) leave both allocators
    in the same state after every operation.
  - ContinuousBatcher: the mixes of the JAX package's tests/test_engine.py
    (chunked prefill with dynamic pages; prefix sharing with pool
    accounting; decode bursts with mid-burst eos and stop; an
    oversubscribed pool that forces preemption) and the deterministic
    request features (logit_bias ban and force, min_new_tokens, presence
    and frequency penalties) give token-identical greedy outputs.
Both engines run the W4A4 NVFP4 + ARC path on test-tiny with f32 params
and hold the same packed weights; JAX runs its Pallas kernels in
interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import ContinuousBatcher as JBatcher
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.engine import InferenceEngine as JEngine
from arcquant_tpu.engine import Request as JRequest
from arcquant_tpu.engine.scheduler import PageAllocator as JPageAllocator
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import (ContinuousBatcher, EngineConfig,
                                       InferenceEngine, PageAllocator,
                                       Request)

QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
           act_scale="row", w_scale="channel", quantize_lm_head=True)
BASE = dict(max_batch=2, max_seq_len=64, page_size=16)
ECFGS = {
    "dyn_chunk": dict(dynamic_pages=True, prefill_chunk=16),
    "share": dict(dynamic_pages=True, prefill_chunk=16,
                  prefix_sharing=True),
    "static": {},
    "over": dict(dynamic_pages=True, num_pages=9),
    "tight": dict(dynamic_pages=True, num_pages=5),
}
PROMPT = [5, 17, 301, 42, 8]


# -- PageAllocator -----------------------------------------------------------

def _state(a):
    return (a.capacity, list(a.free), dict(a.owned), dict(a.ref),
            list(a.cached.items()), dict(a.page_key), a.available())


def _apply(a, op):
    """One operation; its choices read only the allocator's own state."""
    kind, slot, x = op
    if kind == "alloc":
        return a.alloc(slot, x)
    if kind == "register":
        pages = a.owned.get(slot)
        if pages:
            a.register(x, pages[len(pages) // 2])
        return None
    if kind == "share":
        pg = a.lookup_shared(x)
        if pg is not None:
            a.share(slot, pg)
        return pg
    a.release(slot)
    return None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, j = PageAllocator(12), JPageAllocator(12)
    for _ in range(120):
        r, slot = rng.random(), int(rng.integers(0, 4))
        key = f"k{int(rng.integers(0, 10))}"
        op = (("alloc", slot, int(rng.integers(1, 5))) if r < 0.35 else
              ("register", slot, key) if r < 0.55 else
              ("share", slot, key) if r < 0.75 else ("release", slot, None))
        assert _apply(a, op) == _apply(j, op), op
        assert _state(a) == _state(j), op


# -- ContinuousBatcher -------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """make(pkg, name): a JAX or port engine of configuration `name`,
    both over the same packed test-tiny weights."""
    cfg = jax_model_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    calib = jquantized.identity_calib(cfg, select_frac=0.125)
    packed = JEngine(cfg, params, calib, JQuantConfig(**QKW),
                     JEngineConfig(**BASE)).qparams
    qp = jax.tree.map(np.asarray, packed)
    tcfg = get_model_config("test-tiny")

    @functools.lru_cache(maxsize=None)
    def make(pkg, name):
        kw = {**BASE, **ECFGS[name]}
        if pkg == "jax":
            return JEngine(cfg, packed, calib, JQuantConfig(**QKW),
                           JEngineConfig(**kw), quantize_params=False)
        return InferenceEngine(tcfg, convert.qparams_from_numpy(qp),
                               convert.calib_from_numpy(calib),
                               QuantConfig(**QKW), EngineConfig(**kw),
                               device="cpu", quantize_params=False)
    return make


PKGS = {"jax": (JBatcher, JRequest), "torch": (ContinuousBatcher, Request)}


def _serve(make, pkg, name, waves, burst=0):
    """Run request waves (lists of Request kwargs) through one batcher,
    each wave to completion. Returns (outputs, requests, batcher)."""
    batcher_cls, request_cls = PKGS[pkg]
    bt = batcher_cls(make(pkg, name), decode_burst=burst)
    reqs = []
    for wave in waves:
        batch = [request_cls(**kw) for kw in wave]
        for r in batch:
            bt.submit(r)
        bt.run()
        reqs += batch
    assert all(r.error is None for r in reqs)
    return [r.output for r in reqs], reqs, bt


def _mix_chunked():
    return [[dict(prompt=list(PROMPT), max_new_tokens=4),
             dict(prompt=[100, 200, 33], max_new_tokens=3)],
            [dict(prompt=list(range(1, 29)), max_new_tokens=3)]]


def test_batcher_chunked_prefill_dynamic_pages_matches_jax(engines):
    want, _, _ = _serve(engines, "jax", "dyn_chunk", _mix_chunked())
    got, reqs, bt = _serve(engines, "torch", "dyn_chunk", _mix_chunked())
    assert got == want
    assert [len(o) for o in got] == [4, 3, 3]
    assert bt.alloc.available() == bt.alloc.capacity


def _mix_sharing():
    prefix = list(range(1, 17))               # exactly one full page
    return [[dict(prompt=prefix + [100, 101, 102], max_new_tokens=4)],
            [dict(prompt=prefix + [200, 201], max_new_tokens=4)],
            [dict(prompt=prefix + [42], max_new_tokens=2),
             dict(prompt=prefix + [43], max_new_tokens=2)]]


def test_batcher_prefix_sharing_matches_jax(engines):
    want, _, _ = _serve(engines, "jax", "share", _mix_sharing())
    got, _, bt = _serve(engines, "torch", "share", _mix_sharing())
    assert got == want
    # pool accounting: every slot drained, cached pages evictable
    a = bt.alloc
    assert not a.owned and a.available() == a.capacity and a.cached
    # a fresh sharer maps the cached prefix page instead of a new one
    r = Request(prompt=list(range(1, 17)) + [7, 8], max_new_tokens=2)
    bt.submit(r)
    bt._admit()
    slot = bt.slots.index(r)
    first = int(bt._pt[slot, 0])
    assert a.page_key.get(first) is not None and a.ref[first] == 1
    assert int(bt.state[2][slot]) == 18
    bt.run()
    assert len(r.output) == 2


def _mix_bursts(base):
    return [[dict(prompt=list(PROMPT), max_new_tokens=12),
             dict(prompt=[100, 200, 7], max_new_tokens=9),
             # eos mid-burst: the 4th greedy token of the first request
             dict(prompt=list(PROMPT), max_new_tokens=12, eos_id=base[3]),
             # stop sequence mid-burst
             dict(prompt=list(PROMPT), max_new_tokens=12,
                  stop=[base[5:7]])]]


def test_batcher_decode_bursts_match_jax(engines):
    base, _, _ = _serve(engines, "jax", "static",
                        [[dict(prompt=list(PROMPT), max_new_tokens=12)]])
    want, _, _ = _serve(engines, "jax", "static", _mix_bursts(base[0]),
                        burst=3)
    assert want[0] == base[0]
    for burst in (3, 8, 0):
        got, _, _ = _serve(engines, "torch", "static",
                           _mix_bursts(base[0]), burst=burst)
        assert got == want, burst


def _mix_oversubscribed():
    return [[dict(prompt=list(PROMPT), max_new_tokens=10),
             dict(prompt=[100, 200, 7], max_new_tokens=10),
             dict(prompt=[9, 9, 9, 9], max_new_tokens=8)]]


def test_batcher_bursts_with_dynamic_pages_match_jax(engines):
    want, _, _ = _serve(engines, "jax", "over", _mix_oversubscribed())
    for burst in (0, 4):
        got, _, bt = _serve(engines, "torch", "over",
                            _mix_oversubscribed(), burst=burst)
        assert got == want, burst
        assert bt.alloc.available() == bt.alloc.capacity


def _mix_preempting():
    # 4 usable pages; the first two requests grow to 3 pages each
    return [[dict(prompt=list(range(1, 21)), max_new_tokens=24),
             dict(prompt=[100, 200, 7] * 4, max_new_tokens=30),
             dict(prompt=[9, 9, 9, 9], max_new_tokens=8)]]


def test_batcher_preemption_matches_jax(engines):
    want, jreqs, _ = _serve(engines, "jax", "tight", _mix_preempting())
    got, reqs, bt = _serve(engines, "torch", "tight", _mix_preempting())
    assert got == want
    assert [r.preempts for r in reqs] == [r.preempts for r in jreqs]
    assert sum(r.preempts for r in reqs) > 0     # the pool forced it
    assert bt.alloc.available() == bt.alloc.capacity


FEATURES = {
    "bias_ban_first": lambda base: dict(logit_bias={base[0]: -1e9}),
    "bias_force": lambda base: dict(logit_bias={7: 1e9}),
    "min_new_tokens": lambda base: dict(eos_id=base[0], min_new_tokens=4),
    "eos_at_once": lambda base: dict(eos_id=base[0]),
    "presence_penalty": lambda base: dict(presence_penalty=1e9),
    "frequency_penalty": lambda base: dict(frequency_penalty=0.5),
}


@pytest.fixture(scope="module")
def jax_base(engines):
    out, _, _ = _serve(engines, "jax", "static",
                       [[dict(prompt=list(PROMPT), max_new_tokens=10)]])
    return out[0]


@pytest.mark.parametrize("feature", list(FEATURES))
def test_request_features_match_jax(engines, jax_base, feature):
    kw = dict(prompt=list(PROMPT), max_new_tokens=10,
              **FEATURES[feature](jax_base))
    want, _, _ = _serve(engines, "jax", "static", [[kw]])
    got, _, _ = _serve(engines, "torch", "static", [[kw]])
    assert got == want
    if feature == "bias_force":
        assert got[0] == [7] * 10
    if feature == "eos_at_once":
        assert got[0] == []
    if feature == "min_new_tokens":
        assert len(got[0]) >= 4 and jax_base[0] not in got[0][:4]
