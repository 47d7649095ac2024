"""The MoE family's qdq and bf16 expert stacks of arcquant_tpu_torch
(models/moe.py: quantize_moe_params, _stacked_linear, the dense and
dispatch FFNs over the stacks, the bf16 shared expert, the calibration
taps) held against the JAX package's models/moe.py on test-tiny-moe.

The same inputs go to both packages: test-tiny-moe's f32 params from the
JAX package's init (PRNGKey 0), a layer calib with random reorder indices
and ARC columns at every site, activations from a numpy seed. The bars:
  - quantize_moe_params: the qdq stacks (w_aug, gs) bit for bit, in every
    format and weight-scale granularity; at BF16 the tree as it is;
  - moe_block, routing included (the same top-k sets are asserted
    first): BF16 within 1e-5 (the f32 params' forward; its outputs are
    bf16-rounded in both packages), the quantized routes (fake tensor,
    fake row, A16) within 0.05, the bound of the JAX package's
    tests/test_moe.py::test_packed_moe_matches_qdq; dense mode, dispatch
    mode (both packages' DENSE_MODE_MAX_T lowered) and dispatch with
    capacity drops. The measured max is stated at each test;
  - the calibration taps: JAX's bits;
  - llama.model_forward and quant_model_forward on test-tiny-moe, in
    dense and dispatch mode: logits cosine >= 0.999 and equal argmax
    (the port contract's bar).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import moe as jmoe
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.models import llama, moe, quantized
from arcquant_tpu_torch.testing import cosine, to_numpy
from tests.test_torch_gemm import assert_summation_order_close

TINY = "test-tiny-moe"
SELECT = 64


@functools.lru_cache(maxsize=None)
def _params():
    """test-tiny-moe's f32 params from the JAX package's init, numpy."""
    return jax.tree.map(np.asarray, jllama.init_params(
        jax_model_config(TINY), jax.random.PRNGKey(0), jnp.float32))


@functools.lru_cache(maxsize=None)
def _calib():
    """One layer's calib, both packages: random reorder indices and
    SELECT ARC columns at every site."""
    cfg = jax_model_config(TINY)
    rng = np.random.default_rng(7)
    sites = {"mlp_in": cfg.hidden_size,
             "down_in": cfg.moe_intermediate_size,
             "sdown_in": cfg.shared_expert_size}
    jcal = {s: jquantized.SiteCalib(
        jnp.asarray(rng.permutation(k).astype(np.int32)), SELECT)
        for s, k in sites.items()}
    return jcal, convert.calib_from_numpy([jcal])[0]


def _moe_params(layer=0):
    raw = _params()["layers"][layer]["moe"]
    return jax.tree.map(jnp.asarray, raw), convert.params_from_numpy(raw)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


SETTINGS = {
    "nvfp4_tensor": dict(),
    "nvfp4_channel": dict(w_scale="channel"),
    "mxfp4": dict(quant_type="MXFP4"),
    "mxfp6": dict(quant_type="MXFP6", w_scale="channel"),
    "int4": dict(quant_type="INT4"),
    "bf16": dict(quant_type="BF16"),
}


def _qcfgs(**kw):
    base = dict(quant_type="NVFP4", use_kernels=False)
    return JQuantConfig(**{**base, **kw}), QuantConfig(**{**base, **kw})


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_quantize_moe_params_bitwise(setting):
    """The qdq stacks and the shared expert's fake linears: w_aug and gs
    bit for bit ([E, N] per channel, [E, 1] per tensor); the router and
    the shared gate as they are; BF16 the tree itself."""
    jq, q = _qcfgs(**SETTINGS[setting])
    jcal, cal = _calib()
    jp, p = _moe_params()
    want = jax.tree.map(np.asarray, jmoe.quantize_moe_params(jp, jcal, jq))
    got = moe.quantize_moe_params(p, cal, q)
    assert sorted(got) == sorted(want)
    for name, leaves in want.items():
        assert sorted(got[name]) == sorted(leaves), name
        for key, w in leaves.items():
            g = to_numpy(got[name][key])
            assert g.shape == w.shape, (name, key)
            assert str(got[name][key].dtype).split(".")[-1] == (
                "bfloat16" if w.dtype.name == "bfloat16" else w.dtype.name)
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"{name}.{key}")
    if setting == "bf16":
        assert all(got[n] is p[n] for n in p)


def _x(seed, b=2, t=10):
    cfg = jax_model_config(TINY)
    return (np.random.default_rng(seed).standard_normal(
        (b, t, cfg.hidden_size)) * 2).astype(np.float32)


ROUTES = {"bf16": dict(quant_type="BF16"),
          "fake_tensor": dict(w_scale="channel"),
          "fake_row": dict(act_scale="row", w_scale="channel"),
          "a16": dict(act_bits=16, act_scale="row", w_scale="channel")}
MODES = {"dense": (256, None), "dispatch": (8, None),
         "dispatch_drops": (8, 3)}


def _same_routes(x, layer=0):
    """Both packages route x to the same top-k sets (an ulp of a router
    logit cannot have swapped an expert here)."""
    jp, p = _moe_params(layer)
    cfg = jax_model_config(TINY)
    x2 = x.reshape(-1, x.shape[-1])
    want = np.asarray(jmoe.route(cfg, jp["router"]["w"], jnp.asarray(x2)))
    got = to_numpy(moe.route(get_model_config(TINY), p["router"]["w"],
                             torch.from_numpy(x2)))
    np.testing.assert_array_equal(got > 0, want > 0)


def _assert_bf16_close(got, want, tol=1e-5):
    """The BF16 block's bar. Both packages round the routed output and the
    shared expert's to bf16 before adding them (the JAX package's dtypes
    on f32 params), so an f32-order ulp in a product can move one of them
    by a bf16 ulp: every element within tol (atol and rtol), but for at
    most 0.1% of them, which are within a bf16 ulp of their row's largest
    output (2^-8 of it)."""
    diff = np.abs(got.astype(np.float64) - want)
    strict = diff <= tol + tol * np.abs(want)
    assert strict.mean() >= 0.999, (strict.mean(), float(diff.max()))
    ulp = 2.0 ** -8 * np.abs(want).max(axis=-1, keepdims=True)
    assert (diff <= ulp).all(), float(diff.max())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_moe_block_matches_jax(route, mode, monkeypatch):
    """moe_block on the bf16 stacks (BF16) or the qdq stacks (the fake
    route's activation qdq, per tensor or per row, or the A16 pad), the
    shared expert included, 20 tokens: dense mode; dispatch mode
    (DENSE_MODE_MAX_T 8, capacity from CAPACITY_FACTOR, no drop); dispatch
    with capacity 3, where each expert drops most of its 10 assignments.
    Measured: the quantized routes bit-exact; BF16 bit-exact but for at
    most one element of 2560 a bf16 ulp apart (0.0039 to 0.0156, where the
    routed and the shared outputs cancel), which run to run differs."""
    max_t, capacity = MODES[mode]
    monkeypatch.setattr(moe, "DENSE_MODE_MAX_T", max_t)
    monkeypatch.setattr(jmoe, "DENSE_MODE_MAX_T", max_t)
    jq, q = _qcfgs(**ROUTES[route])
    jcal, cal = _calib()
    jp, p = _moe_params()
    x = _x(11)
    _same_routes(x)
    cfg = jax_model_config(TINY)
    want = np.asarray(jmoe.moe_block(
        cfg, jmoe.quantize_moe_params(jp, jcal, jq), jnp.asarray(x), jcal,
        jq, capacity=capacity), np.float32)
    got = moe.moe_block(get_model_config(TINY),
                        moe.quantize_moe_params(p, cal, q),
                        torch.from_numpy(x), cal, q, capacity=capacity)
    assert got.shape == x.shape and got.dtype == torch.float32
    if route == "bf16":
        _assert_bf16_close(to_numpy(got), want)
    else:
        np.testing.assert_allclose(to_numpy(got), want, atol=0.05,
                                   rtol=0.05)
    if capacity:
        # the drops are real: some token keeps fewer than k experts
        slot, _ = moe._slots(moe.route(get_model_config(TINY),
                                       p["router"]["w"],
                                       torch.from_numpy(x.reshape(20, -1))),
                             cfg.num_experts_per_tok, capacity)
        assert (slot == cfg.num_experts * capacity).any()


@pytest.mark.parametrize("mode", ["dense", "dispatch"])
def test_taps_match_jax(mode, monkeypatch):
    """The calibration taps of the bf16 block: down_in (dense: the
    routing-masked [T, E, F]; dispatch: the [E, C, F] capacity slots),
    bf16 in both packages, JAX's bits; the shared expert's sdown_in, in
    the params' f32, within the f32 summation order of its products
    (measured: 6 of 2560 elements 1-2 f32 ulps apart)."""
    max_t = MODES[mode][0]
    monkeypatch.setattr(moe, "DENSE_MODE_MAX_T", max_t)
    monkeypatch.setattr(jmoe, "DENSE_MODE_MAX_T", max_t)
    jp, p = _moe_params(layer=1)
    x = _x(12)
    _same_routes(x, layer=1)
    jt, tt = {}, {}
    jmoe.moe_block(jax_model_config(TINY), jp, jnp.asarray(x), taps=jt)
    moe.moe_block(get_model_config(TINY), p, torch.from_numpy(x), taps=tt)
    assert sorted(tt) == sorted(jt) == ["down_in", "sdown_in"]
    cfg = get_model_config(TINY)
    shape = ((20, cfg.num_experts, cfg.moe_intermediate_size)
             if mode == "dense" else
             (cfg.num_experts, 13, cfg.moe_intermediate_size))
    assert tuple(tt["down_in"].shape) == shape
    assert tt["down_in"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(to_numpy(tt["down_in"])),
                                  _bits(jt["down_in"]))
    assert tt["sdown_in"].dtype == torch.float32
    assert_summation_order_close(to_numpy(tt["sdown_in"]),
                                 np.asarray(jt["sdown_in"]), "f32")


def _tokens(seed=1, b=2, t=16):
    return np.random.default_rng(seed).integers(
        0, get_model_config(TINY).vocab_size, (b, t)).astype(np.int32)


def _assert_close(got, want, what):
    got, want = to_numpy(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    c = cosine(got, want)
    assert c >= 0.999, f"{what}: logits cosine {c}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=what)


FORWARDS = {
    "bf16_forward": None,
    "fake_tensor": (dict(), False),
    "fake_row_channel": (dict(act_scale="row", w_scale="channel"), False),
    "mxfp4": (dict(quant_type="MXFP4"), False),
    "packed_w8_row": (dict(act_scale="row"), True),
}


@pytest.mark.parametrize("mode", ["dense", "dispatch"])
@pytest.mark.parametrize("setting", list(FORWARDS))
def test_model_forwards_match_jax(setting, mode, monkeypatch):
    """llama.model_forward (the bf16 reference) and quant_model_forward
    (quantize_model_params' tree: the attention linears fake or packed,
    the experts qdq stacks at every setting) on test-tiny-moe, 2 x 16
    tokens: dense mode, or dispatch with both packages' DENSE_MODE_MAX_T
    lowered to 16. The quantized trees are built by each package and
    held bitwise first. Measured: cosine 1.0000000 in every case."""
    if mode == "dispatch":
        monkeypatch.setattr(moe, "DENSE_MODE_MAX_T", 16)
        monkeypatch.setattr(jmoe, "DENSE_MODE_MAX_T", 16)
    jcfg, cfg = jax_model_config(TINY), get_model_config(TINY)
    params = _params()
    toks = _tokens()
    if FORWARDS[setting] is None:
        got = llama.model_forward(cfg, convert.params_from_numpy(params),
                                  torch.from_numpy(toks))
        want = jllama.model_forward(jcfg, jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(toks))
        _assert_close(got, want, setting)
        return
    kw, use_kernels = FORWARDS[setting]
    jq, q = _qcfgs(**{**kw, "use_kernels": use_kernels})
    jcalib = jquantized.identity_calib(jcfg, 0.25)
    calib = quantized.identity_calib(cfg, 0.25)
    jtree = jquantized.quantize_model_params(
        jcfg, jax.tree.map(jnp.asarray, params), jcalib, jq)
    tree = quantized.quantize_model_params(
        cfg, convert.params_from_numpy(params), calib, q)
    jnp_tree = jax.tree.map(np.asarray, jtree)
    for layer, jlayer in zip(tree["layers"], jnp_tree["layers"]):
        assert sorted(layer) == sorted(jlayer)
        for name in ("gate", "up", "down"):
            for key in ("w_aug", "gs"):
                np.testing.assert_array_equal(
                    _bits(to_numpy(layer["moe"][name][key])),
                    _bits(jlayer["moe"][name][key]))
        assert hasattr(layer["q"], "codes") == use_kernels
    got = quantized.quant_model_forward(cfg, tree, calib, q,
                                        torch.from_numpy(toks))
    want = jquantized.quant_model_forward(jcfg, jtree, jcalib, jq,
                                          jnp.asarray(toks))
    _assert_close(got, want, setting)


def _leaves(tree, name=""):
    """(path, leaf) pairs of a parameter tree, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          f"{name}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{name}/{i}")]
    return [(name, tree)]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_quantize_model_params_consume(use_kernels):
    """consume=True (evaluate's call: each raw layer freed once
    quantized) gives the tree of the default call bit for bit and leaves
    None in every slot of the list it was given; the default leaves the
    caller's layers in place."""
    cfg = get_model_config(TINY)
    _, q = _qcfgs(use_kernels=use_kernels, act_scale="row")
    calib = quantized.identity_calib(cfg, 0.25)
    kept = convert.params_from_numpy(_params())
    want = quantized.quantize_model_params(cfg, kept, calib, q)
    assert all(lp is not None for lp in kept["layers"])
    given = convert.params_from_numpy(_params())
    got = quantized.quantize_model_params(cfg, given, calib, q, consume=True)
    assert given["layers"] == [None] * cfg.num_layers
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        else:
            assert a == b, path
