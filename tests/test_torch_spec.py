"""Speculative decoding in arcquant_tpu_torch (engine.verify_step,
engine/spec.py, the batcher's spec_window) held against the JAX
package's and against the port's own plain greedy decode, after the JAX
package's tests/test_spec.py.

Both engines run the W4A4 NVFP4 + ARC path (select_frac 0.125, w8,
per-row activation and per-channel weight scales, W4A16 packed head,
pages of 16, batch 2) on test-tiny and test-qwen-tiny with f32 params
(tests/test_torch_engine.py's docstring says why), the port on the JAX
engine's packed weights; JAX runs its Pallas kernels in interpret mode.
The bars, stated at each test:
  - greedy spec tokens (host loop with garbage, self-model and n-gram
    drafters; the on-device round loop; the batcher) equal to plain
    greedy generate's, the port's and JAX's, and to the JAX
    SpeculativeEngine's;
  - verify_step against sequential decode_step position by position
    (JAX's bar: equal argmax, logits within 2e-2), and against JAX's
    verify_step (the engine-level bar: cosine >= 0.999, equal argmax);
  - the round body of generate_ondevice (what the card captures as a
    CUDA graph, run here eagerly in chunks of rounds) bitwise equal to
    the eager while-any(active) loop: history, stats, seq_lens and
    every page of the pool but the sink;
  - sample_verify's first token distributed as the warped target
    (chi-square) whatever the draft, its acceptance rate p(draft), and
    temperature-0 rows exactly greedy.
The card's side (the verify and round graphs against their eager
references, the paged prefill kernel at Tq = W under capture) is in
tests/test_torch_kernels_gpu.py.
"""

import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.engine import InferenceEngine as JEngine
from arcquant_tpu.engine import NgramDrafter as JNgramDrafter
from arcquant_tpu.engine import SpeculativeEngine as JSpeculativeEngine
from arcquant_tpu.engine.spec import device_ngram_draft as j_device_ngram
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert, serve
from arcquant_tpu_torch.benchmarks import bench_spec
from arcquant_tpu_torch.benchmarks.common import Timing
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import (ContinuousBatcher, EngineConfig,
                                       EngineDrafter, InferenceEngine,
                                       NgramDrafter, Request,
                                       SpeculativeEngine)
from arcquant_tpu_torch.engine import spec as spec_mod
from arcquant_tpu_torch.engine.sampling import SamplingParams, warp_logits
from arcquant_tpu_torch.engine.server import ServingLoop, make_server
from arcquant_tpu_torch.models import quantized
from arcquant_tpu_torch.testing import cosine, to_numpy

QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
           act_scale="row", w_scale="channel", quantize_lm_head=True)
EKW = dict(max_batch=2, max_seq_len=64, page_size=16)
PROMPTS = [[5, 17, 301, 42, 8], [100, 200, 7]]
LOOPING = [[1, 2, 3, 4] * 6, [5, 17, 301, 42, 8]]
STEPS = 12


class GarbageDrafter:
    """Always proposes token 0: every round rejects (the rollback
    path)."""

    def begin(self, prompts, max_batch):
        pass

    def propose(self, cur, k, active):
        return np.zeros((len(cur), k), np.int32)

    def commit(self, committed, accepted, new_lens, active):
        pass


@pytest.fixture(scope="module", params=["test-tiny", "test-qwen-tiny"])
def ref(request):
    """The JAX engine's plain greedy generate, SpeculativeEngine.generate
    (n-gram, W 3), generate_ondevice (W 4) and verify_step logits, with
    its packed params."""
    name = request.param
    cfg = jax_model_config(name)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(0)
    for layer in params["layers"]:     # non-zero qkv biases (Qwen2)
        for proj in ("q", "k", "v"):
            if "b" in layer[proj]:
                layer[proj]["b"] = jnp.asarray(
                    rng.standard_normal(layer[proj]["b"].shape) * 0.1,
                    jnp.float32)
    calib = jquantized.identity_calib(cfg, select_frac=0.125)
    eng = JEngine(cfg, params, calib, JQuantConfig(**QKW),
                  JEngineConfig(**EKW))
    out = dict(name=name, calib=calib,
               qparams=jax.tree.map(np.asarray, eng.qparams),
               plain=eng.generate(LOOPING, STEPS),
               spec=JSpeculativeEngine(eng, JNgramDrafter(), window=3)
               .generate(LOOPING, STEPS),
               ondevice=JSpeculativeEngine(eng, JNgramDrafter(), window=4)
               .generate_ondevice(LOOPING, STEPS))
    toks, lens, _ = eng._pad_prompts(PROMPTS)
    _, state = eng.prefill(eng.new_state(), jnp.asarray(toks),
                           jnp.asarray(lens))
    logits, _ = eng.verify_step(state, jnp.asarray(FED),
                                jnp.asarray([4, 4], jnp.int32))
    out.update(toks=toks, lens=lens, verify=np.asarray(logits))
    return out


FED = np.asarray([[9, 15, 33, 2], [4, 88, 12, 51]], np.int32)


def _port(run, cuda_graphs=True, qkw=None, **ekw):
    """The port's engine on the JAX engine's packed weights."""
    return InferenceEngine(
        get_model_config(run["name"]), convert.qparams_from_numpy(
            run["qparams"]), convert.calib_from_numpy(run["calib"]),
        QuantConfig(**(qkw or QKW)), EngineConfig(**{**EKW, **ekw}),
        device="cpu", quantize_params=False, cuda_graphs=cuda_graphs)


# -- verify_step --------------------------------------------------------------

def test_verify_step_matches_sequential_decode(ref):
    """verify_step's W positions against W sequential decode steps fed
    the same tokens (the int4 pool holds the same codes): equal argmax,
    logits within 2e-2 (JAX's bar); seq_lens unchanged by the verify."""
    eng = _port(ref)
    lens = ref["lens"]
    _, sa = eng.prefill(eng.new_state(), ref["toks"], lens)
    seq = []
    for i in range(4):
        lg, sa = eng.decode_step(sa, torch.as_tensor(FED[:, i]),
                                 torch.ones(2, dtype=torch.bool))
        seq.append(to_numpy(lg))
    _, sb = eng.prefill(eng.new_state(), ref["toks"], lens)
    vlog, sb = eng.verify_step(sb, FED, [4, 4])
    vlog = to_numpy(vlog)
    for i in range(4):
        np.testing.assert_array_equal(vlog[:, i].argmax(-1),
                                      seq[i].argmax(-1))
        np.testing.assert_allclose(vlog[:, i], seq[i], rtol=2e-2, atol=2e-2)
    assert sb[2].tolist() == lens.tolist()


def test_verify_step_ragged_valid(ref):
    """A row with valid 1 of W 4: its position 0 matches the decode step
    (equal argmax, within 2e-2); a row with valid 0 appends nothing (the
    pool's live pages stay as they were); seq_lens unchanged."""
    eng = _port(ref)
    lens = ref["lens"]
    _, sa = eng.prefill(eng.new_state(), ref["toks"], lens)
    lg0, _ = eng.decode_step(sa, torch.as_tensor(FED[:, 0]),
                             torch.ones(2, dtype=torch.bool))
    _, sb = eng.prefill(eng.new_state(), ref["toks"], lens)
    before = [c[1:].clone() for c in sb[0].codes]
    vlog, sb = eng.verify_step(sb, FED, [0, 1])
    np.testing.assert_array_equal(to_numpy(vlog)[1, 0].argmax(-1),
                                  to_numpy(lg0)[1].argmax(-1))
    np.testing.assert_allclose(to_numpy(vlog)[1, 0], to_numpy(lg0)[1],
                               rtol=2e-2, atol=2e-2)
    assert sb[2].tolist() == lens.tolist()
    pps = eng.ecfg.pages_per_seq
    for c, c0 in zip(sb[0].codes, before):     # row 0's pages untouched
        assert torch.equal(c[1:1 + pps], c0[:pps])


def test_verify_step_matches_jax(ref):
    """The port's verify_step logits against the JAX engine's on the same
    packed weights and tokens: cosine >= 0.999 and equal argmax at every
    position."""
    eng = _port(ref)
    _, state = eng.prefill(eng.new_state(), ref["toks"], ref["lens"])
    vlog, _ = eng.verify_step(state, FED, [4, 4])
    got, want = to_numpy(vlog), ref["verify"]
    assert cosine(got, want) >= 0.999
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_verify_uses_the_decode_qcfg(ref):
    """Under hybrid prefill (prefill_act_bits 16) the verify runs the
    decode qcfg: bitwise the chunk forward at qcfg, not at
    qcfg_prefill."""
    eng = _port(ref, qkw=dict(QKW, prefill_act_bits=16))
    assert eng.qcfg_prefill.act_bits == 16 and eng.qcfg.act_bits == 4
    outs = {}
    for what in ("verify", "decode qcfg", "prefill qcfg"):
        _, (cache, pt, sl) = eng.prefill(eng.new_state(), ref["toks"],
                                         ref["lens"])
        if what == "verify":
            lg, _ = eng.verify_step((cache, pt, sl), FED, [4, 4])
        else:
            lg = eng._prefill_chunk_forward(
                cache, pt, torch.as_tensor(FED).long(), sl + 4, sl,
                all_logits=True,
                qcfg=eng.qcfg if what == "decode qcfg" else None)
        outs[what] = lg
    assert torch.equal(outs["verify"], outs["decode qcfg"])
    assert not torch.equal(outs["verify"], outs["prefill qcfg"])


def test_alloc_prompt_pages_margin():
    """Dynamic pages: the span covers prompt + new tokens + margin, and
    raises past pages_per_seq."""
    cfg = get_model_config("test-tiny")
    eng = InferenceEngine.dummy(
        cfg, quantized.identity_calib(cfg, 0.125), QuantConfig(**QKW),
        EngineConfig(**EKW, dynamic_pages=True, num_pages=9), device="cpu")
    lens = np.asarray([16, 0], np.int32)
    _, pt, _ = eng._alloc_prompt_pages(eng.new_state(), lens, 1, 16,
                                       margin=1)
    assert pt[0].tolist() == [1, 2, 3, 0]
    with pytest.raises(ValueError, match="margin 17"):
        eng._alloc_prompt_pages(eng.new_state(), np.asarray([16, 0]), 1,
                                32, margin=17)


# -- the host loop ------------------------------------------------------------

@pytest.mark.parametrize("drafter", ["garbage", "self", "ngram"])
def test_spec_tokens_equal_plain_greedy(ref, drafter):
    """Every drafter's greedy spec tokens equal the port's plain greedy
    generate, the JAX engine's, and the JAX SpeculativeEngine's (n-gram,
    W 3); garbage drafts are never accepted, self drafts nearly always."""
    plain = _port(ref).generate(LOOPING, STEPS)
    assert plain == ref["plain"] == ref["spec"]
    d = {"garbage": GarbageDrafter(), "ngram": NgramDrafter(),
         "self": EngineDrafter(_port(ref))}[drafter]
    spec = SpeculativeEngine(_port(ref), d, window=3 if drafter == "ngram"
                             else 4)
    assert spec.generate(LOOPING, STEPS) == plain
    st = spec.stats
    if drafter == "garbage":
        assert st["accepted"] == 0
    if drafter == "self":
        assert st["accepted"] > 0 and st["rounds"] < STEPS


def test_spec_eos_and_dynamic_pages(ref):
    """An eos mid-window stops the row where plain decode stops; dynamic
    pages map the rollback margin."""
    eng = _port(ref)
    eos = ref["plain"][0][3]
    want = eng.generate(LOOPING, STEPS, eos_id=eos)
    spec = SpeculativeEngine(_port(ref, dynamic_pages=True, num_pages=11),
                             GarbageDrafter(), window=4)
    assert spec.generate(LOOPING, STEPS, eos_id=eos) == want
    assert len(want[0]) < STEPS


def test_ngram_matcher():
    d = NgramDrafter(max_ngram=3)
    d.begin([[1, 2, 3, 4, 1, 2, 3]], max_batch=1)
    # the context's suffix (2, 3) + cur 4: the trigram (2, 3, 4) occurs
    # at 1..3, so what followed it is proposed
    assert d.propose(np.asarray([4]), 3, np.asarray([True]))[0].tolist() \
        == [1, 2, 3]
    d2 = NgramDrafter()
    d2.begin([[9, 8, 7]], max_batch=1)       # no match: repeat the last
    assert d2.propose(np.asarray([6]), 2, np.asarray([True]))[0].tolist() \
        == [6, 6]


def test_device_ngram_matches_host_drafter_and_jax():
    """device_ngram_draft equals NgramDrafter.draft and JAX's
    device_ngram_draft on random histories over a 4-token vocabulary
    (frequent matches), a batch of rows at once."""
    rng = np.random.RandomState(0)
    d = NgramDrafter(max_ngram=4)
    for k in (1, 3, 4):
        lens = rng.randint(1, 40, size=8)
        hist = np.zeros((8, 64), np.int32)
        for i, n in enumerate(lens):
            hist[i, :n] = rng.randint(0, 4, size=n)
        got = spec_mod.device_ngram_draft(torch.from_numpy(hist),
                                          torch.from_numpy(lens), k)
        want = [d.draft(hist[i, :n].tolist(), k) for i, n in enumerate(lens)]
        assert got.tolist() == want
        jgot = j_device_ngram(jnp.asarray(hist), jnp.asarray(lens, jnp.int32),
                              k)
        np.testing.assert_array_equal(np.asarray(jgot), got.numpy())


# -- the loop on the device ---------------------------------------------------

def test_ondevice_tokens_equal_plain_and_jax(ref):
    """generate_ondevice (W 4): the port's plain greedy tokens and JAX's
    generate_ondevice; with an eos id, where plain decode stops."""
    eng = _port(ref)
    spec = SpeculativeEngine(_port(ref), NgramDrafter(), window=4)
    got = spec.generate_ondevice(LOOPING, STEPS)
    assert got == ref["plain"] == ref["ondevice"]
    assert spec.stats["rounds"] <= 2 * STEPS
    eos = ref["plain"][1][2]
    assert spec.generate_ondevice(LOOPING, STEPS, eos_id=eos) == \
        eng.generate(LOOPING, STEPS, eos_id=eos)


def _ondevice_run(eng, sampling=None, eos_id=None):
    """generate_ondevice on eng, with the state it decodes on."""
    spec = SpeculativeEngine(eng, NgramDrafter(), window=4)
    out = spec.generate_ondevice(LOOPING, STEPS, eos_id=eos_id,
                                 sampling=sampling, seed=7)
    return out, spec.stats, spec.state


@pytest.mark.parametrize("sampling", [None, SamplingParams(1.0, top_k=8)],
                         ids=["greedy", "sampled"])
def test_ondevice_body_bitwise_equals_round_loop(ref, sampling):
    """The round body replayed in chunks (what the card captures) against
    the eager while-any(active) loop: the same tokens, stats and
    seq_lens, and every pool page but the sink bitwise equal; rounds
    past the last change nothing else. Sampled: the same seed, the same
    draws."""
    eos = ref["plain"][0][5]
    body = _ondevice_run(_port(ref), sampling, eos)
    loop = _ondevice_run(_port(ref, cuda_graphs=False), sampling, eos)
    assert body[0] == loop[0] and body[1] == loop[1]
    assert torch.equal(body[2][2], loop[2][2])
    for a, b in zip((*body[2][0].codes, *body[2][0].params),
                    (*loop[2][0].codes, *loop[2][0].params)):
        assert torch.equal(a[1:], b[1:])
    if sampling is not None:
        again = _ondevice_run(_port(ref), sampling, eos)
        assert again[0] == body[0]


def test_spec_engine_reuses_one_state(ref):
    """Every generate and generate_ondevice call of a SpeculativeEngine
    runs on one state, emptied in place (so its graphs are captured
    once): a second batch on the first's stale pool gives plain greedy's
    tokens, in both loops and with the engine drafter."""
    eng = _port(ref)
    spec = SpeculativeEngine(eng, NgramDrafter(), window=4)
    first = spec.generate_ondevice(LOOPING, STEPS)
    state = spec.state
    other = [[5, 6, 5, 6, 5], [11, 3]]
    assert spec.generate_ondevice(other, STEPS) == eng.generate(other, STEPS)
    assert spec.state is state
    assert spec.generate(LOOPING, STEPS) == first == ref["plain"]
    assert spec.state is state
    draft = EngineDrafter(_port(ref))
    spec = SpeculativeEngine(eng, draft, window=3)
    assert spec.generate(other, STEPS) == eng.generate(other, STEPS)
    dstate = draft.state
    assert spec.generate(LOOPING, STEPS) == ref["plain"]
    assert all(a is b for a, b in zip(draft.state[1:], dstate[1:]))


def test_reset_state_is_new_state(ref):
    """reset_state empties a used state in place to new_state's page
    table and seq_lens, static and dynamic layouts."""
    for dynamic in (False, True):
        eng = _port(ref, dynamic_pages=dynamic)
        toks, lens, b = eng._pad_prompts(LOOPING)
        state = eng._alloc_prompt_pages(eng.new_state(), lens, b, STEPS)
        _, state = eng.prefill(state, toks, lens)
        assert int(state[2].sum()) > 0
        ids = [id(t) for t in state[1:]]
        got, fresh = eng.reset_state(state), eng.new_state()
        assert [id(t) for t in got[1:]] == ids
        assert torch.equal(got[1], fresh[1]) and torch.equal(got[2],
                                                             fresh[2])


def test_accept_is_the_prefix_rule():
    """accept's greedy rule: the longest prefix of drafts equal to the
    argmax, against a scalar loop on random drafts with planted
    matches; with per-row temperatures, sample_verify's draws."""
    rng = np.random.default_rng(3)
    b, w, v = 6, 5, 11
    logits = torch.from_numpy(rng.standard_normal((b, w, v)).astype(
        np.float32))
    g = logits.argmax(-1).numpy()
    toksw = rng.integers(0, v, (b, w)).astype(np.int32)
    for i in range(b):
        toksw[i, 1:1 + i % w] = g[i, :i % w]
    n_acc, got = spec_mod.accept(logits, toksw)
    for i in range(b):
        n = 0
        while n < w - 1 and toksw[i, n + 1] == g[i, n]:
            n += 1
        assert n_acc[i] == n
    np.testing.assert_array_equal(got, g)
    temps = np.asarray([0, 1, 0, 1, 0.5, 0], np.float32)
    n1, g1 = spec_mod.accept(logits, toksw, torch.Generator().manual_seed(1),
                    temperature=temps, top_p=np.ones(b, np.float32))
    n2, g2 = spec_mod.sample_verify(
        logits, torch.from_numpy(toksw[:, 1:]),
        torch.Generator().manual_seed(1),
        temperature=torch.from_numpy(temps), top_p=torch.ones(b))
    np.testing.assert_array_equal(n1, n2.numpy())
    np.testing.assert_array_equal(g1, g2.numpy())
    greedy = temps == 0
    np.testing.assert_array_equal(n1[greedy], n_acc[greedy])


def test_ondevice_accepts_on_looping_output(ref):
    """On output that loops, the device drafter wins rounds: fewer rounds
    than emitted tokens, tokens equal to plain greedy."""
    prompts = [[9, 9, 9, 9], [2, 7, 2, 7, 2, 7]]
    want = _port(ref).generate(prompts, 16)
    spec = SpeculativeEngine(_port(ref), NgramDrafter(), window=4)
    assert spec.generate_ondevice(prompts, 16) == want
    assert spec.stats["accepted"] > 0
    assert spec.stats["rounds"] < sum(len(o) for o in want)


class NoHostRead(TorchDispatchMode):
    """Raises on the ops that read a device value back to the host."""
    BANNED = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
              torch.ops.aten.is_nonzero)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.BANNED:
            raise AssertionError(f"host read in the round: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("config", ["greedy", "sampled", "moe"])
def test_round_reads_nothing_back(config):
    """The round body (n-gram draft, verify, acceptance, commit,
    retirement) and verify_step make no host read: greedy and sampled
    (top-k, top-p) on test-tiny, greedy on test-tiny-moe (dense mode)."""
    cfg = get_model_config("test-tiny-moe" if config == "moe"
                           else "test-tiny")
    eng = InferenceEngine.dummy(cfg, quantized.identity_calib(cfg, 0.125),
                                QuantConfig(**QKW), EngineConfig(**EKW),
                                seed=3, device="cpu")
    sampling = (SamplingParams(0.8, top_k=8, top_p=0.9)
                if config == "sampled" else None)
    spec = SpeculativeEngine(eng, NgramDrafter(), window=4)
    toks, lens, _ = eng._pad_prompts(LOOPING)
    _, state = eng.prefill(eng.new_state(), toks, lens)
    g = spec._round_graph(state, 4, sampling)
    io = g.io
    io.hist[:, :toks.shape[1]] = torch.as_tensor(toks)
    io.hist_len.copy_(torch.as_tensor(lens))
    io.plen.copy_(torch.as_tensor(lens))
    io.act.fill_(True)
    io.max_new.fill_(16)
    with NoHostRead():
        for _ in range(3):
            g.replay(state)
        logits, _ = eng.verify_step(state, torch.as_tensor(FED),
                                    torch.full((2,), 4))
    assert int(io.stats[0]) == 3 and torch.isfinite(logits).all()
    assert (io.hist_len > torch.as_tensor(lens)).all()


def test_cached_graphs_hold_their_engine_weakly():
    """An engine whose cache holds decode, verify and spec-round bodies is
    freed as soon as its last reference goes, with the garbage collector
    off: no cycle runs through the cached graphs (on the card the cyclic
    collector could free a graph's pool in the middle of another
    capture)."""
    import gc
    import weakref
    cfg = get_model_config("test-tiny")
    eng = InferenceEngine.dummy(cfg, quantized.identity_calib(cfg, 0.125),
                                QuantConfig(**QKW), EngineConfig(**EKW),
                                seed=3, device="cpu")
    spec = SpeculativeEngine(eng, NgramDrafter(), window=3)
    spec.generate_ondevice(LOOPING, 4)
    spec.generate_ondevice(LOOPING, 4, sampling=SamplingParams(0.7))
    toks, lens, _ = eng._pad_prompts(PROMPTS)
    _, state = eng.prefill(eng.new_state(), toks, lens)
    eng.verify_step(state, FED, [4, 4])
    eng.decode_step(state, FED[:, 0], [True, True])
    assert len(eng._graphs) >= 3
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng, spec, state
        assert ref() is None
    finally:
        gc.enable()


# -- sampling -----------------------------------------------------------------

def test_sample_verify_exact_marginal():
    """The first emitted token's marginal equals the warped target softmax
    whatever the (deterministic) draft proposes: chi-square over 8
    tokens with 7 degrees of freedom below 24.32 (p = 0.001) over 20000
    draws; the acceptance rate equals p(draft) within 0.015 (about 5
    standard deviations)."""
    n = 20000
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5, 1.5, -2.0, 0.2],
                           [0.0] * 8]).expand(n, 2, 8)
    target = torch.softmax(logits[0, 0], -1).double()
    for draft_tok in (0, 6):            # a likely and an unlikely draft
        gen = torch.Generator().manual_seed(draft_tok + 1)
        n_acc, out = spec_mod.sample_verify(
            logits, torch.full((n, 1), draft_tok), gen,
            SamplingParams(temperature=1.0))
        counts = torch.bincount(out[:, 0].long(), minlength=8).double()
        chi2 = float(((counts - n * target) ** 2 / (n * target)).sum())
        assert chi2 < 24.32, (draft_tok, chi2)
        assert abs(float(n_acc.double().mean()) - float(target[draft_tok])) \
            < 0.015


def test_sample_verify_greedy_rows_and_warp():
    """Temperature-0 rows are exactly greedy (argmax acceptance, argmax
    token) beside sampled rows of one batch; a sampled row's emitted
    tokens lie in its top-k support."""
    rng = np.random.default_rng(0)
    logits = torch.as_tensor(rng.standard_normal((4, 4, 32)),
                             dtype=torch.float32)
    g = logits.argmax(-1)
    wrong = torch.stack([g[1, 0], (g[1, 1] + 1) % 32, g[1, 2]])
    drafts = torch.stack([g[0, :3], wrong, g[2, :3], g[3, :3]]).to(
        torch.int32)
    temps = torch.tensor([0.0, 0.0, 1.0, 0.5])
    n_acc, out = spec_mod.sample_verify(logits, drafts,
                                        torch.Generator().manual_seed(0),
                                        temperature=temps, top_k=4)
    assert n_acc[:2].tolist() == [3, 1]
    assert out[0].tolist() == g[0].tolist()
    assert out[1, :2].tolist() == [int(g[1, 0]), int(g[1, 1])]
    support = warp_logits(logits.reshape(16, 32), temps.repeat_interleave(4),
                          4).reshape(4, 4, 32) > float("-inf")
    for r in (2, 3):
        for j in range(int(n_acc[r]) + 1):
            assert support[r, j, out[r, j]]


def test_spec_generate_sampled(ref):
    """Sampled spec generate and generate_ondevice: reproducible per seed,
    tokens in the vocabulary, exact lengths; a greedy SamplingParams
    takes the token-identical greedy path."""
    spec = SpeculativeEngine(_port(ref), NgramDrafter(), window=3)
    sp = SamplingParams(temperature=1.0, top_k=8)
    for fn in (spec.generate, spec.generate_ondevice):
        a = fn(LOOPING, 8, sampling=sp, seed=3)
        assert a == fn(LOOPING, 8, sampling=sp, seed=3)
        assert all(0 <= t < 512 for row in a for t in row)
        assert all(len(row) == 8 for row in a)
        assert fn(LOOPING, 8, sampling=SamplingParams(0.0)) == \
            [r[:8] for r in ref["plain"]]


def test_spec_sampled_with_engine_drafter(ref):
    """A draft model under stochastic verify (greedy drafts, a point-mass
    q) keeps its cache coherent over partial acceptance and catch-up:
    reproducible per seed, and near-greedy targets accept most drafts."""
    spec = SpeculativeEngine(_port(ref), EngineDrafter(_port(ref)),
                             window=4)
    sp = SamplingParams(temperature=0.01)
    a = spec.generate(PROMPTS, 10, sampling=sp, seed=2)
    assert a == spec.generate(PROMPTS, 10, sampling=sp, seed=2)
    assert spec.stats["accepted"] > spec.stats["rounds"]


# -- the batcher and the server -----------------------------------------------

def _batcher_outputs(ref, spec_window, reqs, qkw=None, **ekw):
    bt = ContinuousBatcher(_port(ref, qkw=qkw, **ekw),
                           spec_window=spec_window)
    for r in reqs():
        bt.submit(r)
    return {tuple(r.prompt): r.output for r in bt.run()}, bt


SHARED = list(range(1, 17))            # one full page
BATCHER_MIXES = {
    # more requests than slots in a tight pool: preemption and regrowth
    "dynamic": (lambda: [Request(prompt=[1, 2, 3, 4] * 5, max_new_tokens=8),
                         Request(prompt=[7, 8, 7, 8, 7, 8],
                                 max_new_tokens=10),
                         Request(prompt=[5, 17, 301, 42, 8],
                                 max_new_tokens=6)],
                dict(dynamic_pages=True, num_pages=9), None),
    # stale verify appends must not touch shared prefix pages
    "shared-chunked": (lambda: [Request(prompt=SHARED + [31, 32],
                                        max_new_tokens=8),
                                Request(prompt=SHARED + [41, 42, 43],
                                        max_new_tokens=8)],
                       dict(dynamic_pages=True, prefill_chunk=16,
                            prefix_sharing=True, num_pages=12), None),
    # serve's hybrid prefill: W4A16 chunks, W4A4 decode and verify
    "hybrid-a16": (lambda: [Request(prompt=SHARED + [1, 2, 3] * 4,
                                    max_new_tokens=10),
                            Request(prompt=[5, 17, 301], max_new_tokens=9)],
                   dict(dynamic_pages=True, prefill_chunk=16),
                   dict(QKW, prefill_act_bits=16)),
}


@pytest.mark.parametrize("mix", list(BATCHER_MIXES))
def test_batcher_spec_matches_plain(ref, mix):
    """ContinuousBatcher(spec_window=3) gives the plain batcher's greedy
    outputs request for request; on the repetitive prompts drafts are
    accepted."""
    reqs, ekw, qkw = BATCHER_MIXES[mix]
    plain, _ = _batcher_outputs(ref, 0, reqs, qkw, **ekw)
    spec, bt = _batcher_outputs(ref, 3, reqs, qkw, **ekw)
    assert spec == plain
    assert bt.spec_stats["rounds"] > 0
    assert bt.spec_stats["accepted"] > 0 or mix != "dynamic"


def test_batcher_spec_refuses_per_position_edits():
    """Sampled requests are admitted in spec mode; logit_bias,
    min_new_tokens, repetition penalties and per-request seeds are
    refused; decode_burst beside spec_window is refused."""
    cfg = get_model_config("test-tiny")
    eng = InferenceEngine.dummy(cfg, quantized.identity_calib(cfg, 0.125),
                                QuantConfig(**QKW), EngineConfig(**EKW),
                                device="cpu")
    bt = ContinuousBatcher(eng, spec_window=4)
    bt.submit(Request(prompt=[1, 2], temperature=0.7))
    for bad in (dict(logit_bias={0: 1.0}), dict(min_new_tokens=3),
                dict(presence_penalty=0.5), dict(frequency_penalty=0.5),
                dict(seed=1)):
        with pytest.raises(ValueError):
            bt.submit(Request(prompt=[1, 2], **bad))
    with pytest.raises(ValueError, match="exclusive"):
        ContinuousBatcher(eng, spec_window=4, decode_burst=4)


def test_stop_sequence_in_spec_mode(ref):
    """A stop sequence ends a spec-mode request where it ends a plain one,
    trimmed from the output."""
    prompt = PROMPTS[0]

    def run(spec_window, **kw):
        out, _ = _batcher_outputs(ref, spec_window, lambda: [
            Request(prompt=prompt, max_new_tokens=10, **kw)])
        return out[tuple(prompt)]
    base = run(0)
    stop = [base[3:5]]
    got = run(3, stop=stop)
    assert got == run(0, stop=stop)
    assert len(got) <= 3 and got == base[:len(got)]


def test_batcher_spec_sampled_requests(ref):
    """Greedy and sampled requests in one spec batch: the greedy one
    equals the plain batcher's; the sampled one is reproducible per
    batcher seed, in the vocabulary, of full length."""
    prompt = [1, 2, 3, 4] * 5
    plain, _ = _batcher_outputs(
        ref, 0, lambda: [Request(prompt=prompt, max_new_tokens=8)])

    def run():
        eng = _port(ref)
        bt = ContinuousBatcher(eng, top_k=8, seed=11, spec_window=3)
        r1 = Request(prompt=prompt, max_new_tokens=8)
        r2 = Request(prompt=prompt, max_new_tokens=8, temperature=1.2,
                     top_p=0.9)
        bt.submit(r1)
        bt.submit(r2)
        bt.run()
        return r1.output, r2.output
    g1, s1 = run()
    assert g1 == plain[tuple(prompt)]
    assert (g1, s1) == run()
    assert all(0 <= t < 512 for t in s1) and len(s1) == 8


def test_serve_spec_window_and_health():
    """serve --spec_window 4 (on the CPU) answers a request and /health
    reports the spec stats."""
    args = serve.build_parser().parse_args(
        ["--model", "test-tiny", "--cpu", "--max_batch", "2",
         "--max_seq_len", "64", "--prefill_chunk", "16", "--dynamic_pages",
         "--spec_window", "4"])
    loop = serve.build_loop(args)
    assert isinstance(loop, ServingLoop) and loop.batcher.spec_window == 4
    srv = make_server(loop, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                       timeout=300)
        c.request("POST", "/v1/completions",
                  json.dumps({"prompt": [1, 2, 3, 4] * 4, "max_tokens": 6}))
        r = c.getresponse()
        out = json.loads(r.read())
        assert r.status == 200 and len(out["tokens"]) == 6
        c.request("GET", "/health")
        health = json.loads(c.getresponse().read())
        c.close()
        assert health["stats"]["spec"]["rounds"] > 0
    finally:
        srv.shutdown()
        srv.server_close()
        loop.shutdown()


# -- MoE ----------------------------------------------------------------------

def test_moe_spec_token_identical():
    """test-tiny-moe: the W-token verify runs the dense-mode expert path
    (per-token routing does not depend on the batch), so spec tokens,
    host loop and on-device, equal plain greedy generate's."""
    cfg = get_model_config("test-tiny-moe")
    calib = quantized.identity_calib(cfg, 0.125)
    eng = InferenceEngine.dummy(cfg, calib, QuantConfig(**QKW),
                                EngineConfig(**EKW), seed=1, device="cpu",
                                dtype=torch.float32)
    prompts = [[1, 2, 3, 4] * 5, [7, 8, 7, 8, 7, 8]]
    want = eng.generate(prompts, 8)
    spec = SpeculativeEngine(
        InferenceEngine(cfg, eng.qparams, calib, QuantConfig(**QKW),
                        EngineConfig(**EKW), device="cpu",
                        quantize_params=False), NgramDrafter(), window=3)
    assert spec.generate(prompts, 8) == want
    assert spec.generate_ondevice(prompts, 8) == want


# -- the benchmark ------------------------------------------------------------

def test_bench_spec_runs_its_protocol_on_a_given_timer():
    """bench_spec.run() at 1 layer of test-tiny on the CPU with a host
    clock in place of the card's timer: the JAX script's keys, each
    window's speedup(alpha) = (1 + alpha (W - 1)) decode_ms / verify_ms,
    the --ondevice comparison; without a card the default timer raises."""
    args = bench_spec.build_parser().parse_args(
        ["--model", "test-tiny", "--layers", "1", "--batch_size", "2",
         "--prefill_seq_len", "16", "--windows", "2,4", "--ondevice",
         "--gen_tokens", "8", "--repeats", "5"])
    eng = bench_spec.build_engine(args, device="cpu")

    def timer(fn):
        t0 = time.perf_counter()
        fn()
        ms = (time.perf_counter() - t0) * 1e3
        return Timing(ms, ms, ms)
    r = bench_spec.run(args, eng, timer)
    assert (r["model"], r["layers"], r["batch"], r["prefill"]) == (
        "test-tiny", 1, 2, 16)
    assert sorted(r["windows"]) == [2, 4]
    for w, v in r["windows"].items():
        want = (1 + 0.5 * (w - 1)) * r["decode_ms_per_step"] / v["verify_ms"]
        assert v["speedup"]["alpha=0.5"] == pytest.approx(want, rel=1e-2)
    assert r["ondevice"]["rounds"] > 0 and r["device"]["name"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_spec.run(args, eng)
