"""Chunked, suffix and hybrid (W4A16 prefill, W4A4 decode) prefill of
the arcquant_tpu_torch engine held against the JAX engine.

Both engines run the W4A4 NVFP4 + ARC path (select_frac 0.125, w8
weights, per-row activation and per-channel weight scales, packed head,
pages of 16) on test-tiny and test-qwen-tiny with f32 params, as
tests/test_torch_engine.py does (bf16 cascades ulp flips on these tiny
random models). The JAX side runs its Pallas kernels (the paged
flash-prefill included) in interpret mode; the port runs its plain
versions. Both engines hold the same packed weights.

Cases, each a prefill and STEPS decode steps fed the JAX engine's greedy
tokens:
  chunk8, chunk16    prefill_chunk 8 / 16: the 39-token prompt streams
                     through the int4 pool in 5 / 3 chunks;
  suffix             a prefix prefill, then the rest with per-row starts
                     (4, 1, 20, 0), attending over the prefix in the pool;
  hybrid             prefill_act_bits=16, one-shot prefill;
  hybrid_chunk16     prefill_act_bits=16 with prefill_chunk 16 (the
                     serving default's combination).
Bar: the engine-level one of tests/test_torch_engine.py, logits cosine
>= 0.999 and identical greedy tokens at every step.

The hybrid cases split the check in three. W4A16 rounds every activation
to bf16, and an f32 summation-order ulp then flips a few int4 K/V codes;
on these tiny random models one flipped code moves the decode logits by
about 1e-3 in cosine, and the port against itself with every GEMM output
multiplied by (1 + 2^-22 N(0, 1)) moves as far. So:
  * the prefill logits are held to the bar against the JAX engine's;
  * the pool the prefill wrote is held against the JAX engine's, token
    by live token (test_prefill_pools_match_jax);
  * the port decodes from its own pool, held to the bar against the JAX
    engine decoding from that same pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.engine import InferenceEngine as JEngine
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.testing import cosine, to_numpy

PROMPTS = [[5, 17, 301, 42, 8, 9, 10], [100, 200, 7],
           list(range(1, 40)), [3]]
STARTS = [4, 1, 20, 0]
STEPS = 3
QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
           act_scale="row", w_scale="channel", quantize_lm_head=True)
EKW = dict(max_batch=4, max_seq_len=64, page_size=16)
CASES = {
    "chunk8": (dict(prefill_chunk=8), {}),
    "chunk16": (dict(prefill_chunk=16), {}),
    "suffix": (dict(prefill_chunk=16), {}),
    "hybrid": ({}, dict(prefill_act_bits=16)),
    "hybrid_chunk16": (dict(prefill_chunk=16), dict(prefill_act_bits=16)),
}


def _split(toks, lens):
    """(prefix tokens, prefix lens, suffix tokens) for STARTS."""
    st = np.asarray(STARTS, np.int32)
    pre = np.zeros((toks.shape[0], max(STARTS)), toks.dtype)
    suf = np.zeros_like(toks)
    for i, s in enumerate(STARTS):
        pre[i, :s] = toks[i, :s]
        suf[i, :lens[i] - s] = toks[i, s:lens[i]]
    return pre, st, suf


def _drive(prefill, decode, new_state, toks, lens, case, feed=None,
           after_prefill=None):
    """Prefill (one call, or prefix + suffix for 'suffix') and STEPS
    decode steps; returns ([logits as numpy], fed tokens, the state after
    prefill as after_prefill(state) returned it)."""
    state = new_state()
    if case == "suffix":
        pre, st, suf = _split(toks, lens)
        _, state = prefill(state, pre, st, None)
        logits, state = prefill(state, suf, lens, st)
    else:
        logits, state = prefill(state, toks, lens, None)
    if after_prefill is not None:
        state = after_prefill(state)
    prefilled = state
    outs, fed = [np.asarray(to_numpy(logits) if torch.is_tensor(logits)
                            else logits)], []
    for i in range(STEPS):
        cur = (np.asarray(np.argmax(outs[-1], -1), np.int32)
               if feed is None else feed[i])
        fed.append(cur)
        logits, state = decode(state, cur)
        outs.append(np.asarray(to_numpy(logits) if torch.is_tensor(logits)
                               else logits))
    return outs, fed, prefilled


def _live_kv(codes, params, pt, lens, page):
    """Int4 codes [N, 2, H, Dh] and params [N, H, 4] (sk, mk, sv, mv) of
    every live token of a token-major pool, row by row."""
    slots = np.asarray([(pt[b, p // page], p % page)
                        for b in range(len(lens)) for p in range(lens[b])])
    c = codes[slots[:, 0], :, :, slots[:, 1]]
    return (np.concatenate([c & 0xF, c >> 4], axis=-1).astype(np.int32),
            params[slots[:, 0], :, slots[:, 1]])


def _dequant(q, prm):
    """[N, 2, H, Dh] K/V values from live codes and params."""
    return np.stack([q[:, 0] * prm[..., 0:1] + prm[..., 1:2],
                     q[:, 1] * prm[..., 2:3] + prm[..., 3:4]], axis=1)


def _port_pool(jcache):
    """The JAX pool ([P, 2, H, Dh/2, page] codes, [P, H, 4, page]
    params per layer) in the port's token-major layout, as numpy."""
    return ([np.swapaxes(np.array(c), -1, -2) for c in jcache.codes],
            [np.swapaxes(np.array(p), -1, -2) for p in jcache.params])


@pytest.fixture(scope="module", params=["test-tiny", "test-qwen-tiny"])
def jax_runs(request):
    """Every case's JAX logits and fed tokens, the packed params."""
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
    runs, qparams = {}, None
    for case, (ekw, qkw) in CASES.items():
        eng = JEngine(cfg, params, calib, JQuantConfig(**QKW, **qkw),
                      JEngineConfig(**EKW, **ekw))
        if qparams is None:
            qparams = jax.tree.map(np.asarray, eng.qparams)
        toks, lens, _ = eng._pad_prompts(PROMPTS)
        active = jnp.asarray(lens > 0)

        def prefill(state, t, n, st, eng=eng):
            return eng.prefill(state, jnp.asarray(t, jnp.int32),
                               jnp.asarray(n, jnp.int32),
                               starts=None if st is None
                               else jnp.asarray(st))

        def decode(state, cur, eng=eng, active=active):
            return eng.decode_step(state, jnp.asarray(cur), active)

        pool = []           # a copy: decode donates the JAX cache

        def snapshot(state, pool=pool):
            pool.append((_port_pool(state[0]), np.asarray(state[1]),
                         np.asarray(state[2])))
            return state

        logits, fed, _ = _drive(prefill, decode, eng.new_state, toks, lens,
                                case, after_prefill=snapshot)
        (pcodes, pparams), pt, seq_lens = pool[0]
        runs[case] = dict(logits=logits, fed=fed, codes=pcodes,
                          params=pparams, pt=pt, seq_lens=seq_lens,
                          decode=decode)
    return dict(name=name, qparams=qparams, calib=calib, toks=toks,
                lens=lens, runs=runs)


def _jax_decode_from(run, cache):
    """The JAX engine's STEPS decode steps, fed the same tokens, from the
    port's pool `cache` and the JAX state after its prefill."""
    from arcquant_tpu.cache.paged import PagedKVCache
    jcache = PagedKVCache(
        codes=tuple(jnp.asarray(np.swapaxes(c.numpy(), -1, -2))
                    for c in cache.codes),
        params=tuple(jnp.asarray(np.swapaxes(p.numpy(), -1, -2))
                     for p in cache.params))
    state = (jcache, jnp.asarray(run["pt"]), jnp.asarray(run["seq_lens"]))
    outs = []
    for cur in run["fed"]:
        logits, state = run["decode"](state, cur)
        outs.append(np.asarray(logits))
    return outs


def _port_run(jax_runs, case):
    """The port's prefill and STEPS decode steps fed the JAX tokens:
    (logits as numpy, a copy of the pool after prefill)."""
    ekw, qkw = CASES[case]
    eng = InferenceEngine(
        get_model_config(jax_runs["name"]),
        convert.qparams_from_numpy(jax_runs["qparams"]),
        convert.calib_from_numpy(jax_runs["calib"]),
        QuantConfig(**QKW, **qkw), EngineConfig(**EKW, **ekw),
        device="cpu", quantize_params=False)
    toks, lens = jax_runs["toks"], jax_runs["lens"]
    active = torch.as_tensor(lens > 0)

    def prefill(state, t, n, st):
        return eng.prefill(state, t, n, starts=st)

    def decode(state, cur):
        return eng.decode_step(state, torch.from_numpy(cur), active)

    pool = []

    def snapshot(state):
        cache = state[0]
        pool.append(type(cache)(codes=[c.clone() for c in cache.codes],
                                params=[p.clone() for p in cache.params]))
        return state

    got, _, _ = _drive(prefill, decode, eng.new_state, toks, lens, case,
                       feed=jax_runs["runs"][case]["fed"],
                       after_prefill=snapshot)
    return got, pool[0]


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_modes_match_jax(jax_runs, case):
    run = jax_runs["runs"][case]
    got, cache = _port_run(jax_runs, case)
    want = run["logits"]
    if "prefill_act_bits" in CASES[case][1]:
        want = want[:1] + _jax_decode_from(run, cache)
    report = [(("prefill" if i == 0 else f"decode {i}"), cosine(g, w),
               bool((g.argmax(-1) == w.argmax(-1)).all()))
              for i, (g, w) in enumerate(zip(got, want))]
    assert all(c >= 0.999 and same for _, c, same in report), (case, report)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_pools_match_jax(jax_runs, case):
    """The int4 K/V the prefill wrote, token by live token, against the
    JAX engine's pool. A4 prefill: equal codes and params up to f32 sum
    order. A16 prefill: the bf16 K/V differ by summation-order ulps, so
    a few codes move by one step; each dequantized value stays within
    one quantization step of JAX's."""
    run = jax_runs["runs"][case]
    _, cache = _port_run(jax_runs, case)
    page = EKW["page_size"]
    lens = run["seq_lens"]
    hybrid = "prefill_act_bits" in CASES[case][1]
    for li in range(len(cache.codes)):
        q, prm = _live_kv(cache.codes[li].numpy(), cache.params[li].numpy(),
                          run["pt"], lens, page)
        jq, jprm = _live_kv(run["codes"][li], run["params"][li], run["pt"],
                            lens, page)
        differ = float((q != jq).mean())
        step = np.maximum(prm[..., [0, 2]], jprm[..., [0, 2]])   # [N, H, 2]
        err = np.abs(_dequant(q, prm) - _dequant(jq, jprm))
        err = float((err / step.transpose(0, 2, 1)[..., None]).max())
        prm_rel = float((np.abs(prm - jprm)
                         / (np.abs(jprm) + 1e-6)).max())
        what = (case, li, differ, err, prm_rel)
        if hybrid:
            # a code moves by one step at most, on < 2% of live elements;
            # scale and min move by about a bf16 ulp of K/V's extremes
            assert differ < 0.02 and np.abs(q - jq).max() <= 1, what
            assert prm_rel <= 2.0 ** -7 and err <= 1.25, what
        else:
            assert differ == 0.0, what
            assert prm_rel <= 1e-5 and err <= 1e-4, what


def test_hybrid_prefill_runs_no_actq(jax_runs):
    """A16 prefill pads the bf16 activation with unit scale: no site of
    the prefill forward reaches the actq route; decode does."""
    from arcquant_tpu_torch.kernels import quantize as qk
    eng = InferenceEngine(
        get_model_config(jax_runs["name"]),
        convert.qparams_from_numpy(jax_runs["qparams"]),
        convert.calib_from_numpy(jax_runs["calib"]),
        QuantConfig(**QKW, prefill_act_bits=16), EngineConfig(**EKW),
        device="cpu", quantize_params=False)
    calls = []
    orig = qk.actq_plain

    def counting(*a, **k):
        calls.append(k.get("mode"))
        return orig(*a, **k)
    qk.actq_plain = counting
    try:
        logits, state = eng.prefill(eng.new_state(), jax_runs["toks"],
                                    jax_runs["lens"])
        assert calls == []
        eng.decode_step(state, logits.argmax(-1).to(torch.int32),
                        torch.as_tensor(jax_runs["lens"] > 0))
        assert calls
    finally:
        qk.actq_plain = orig
