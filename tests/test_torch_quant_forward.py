"""The accuracy path's forwards of arcquant_tpu_torch held against the
JAX package on test-tiny and test-qwen-tiny (qkv bias): the bf16
reference forward (llama.model_forward), the no-cache quantized forward
(quantized.quant_model_forward) fake-quantized in every format and
setting, and on packed weights (w8, w4) with the JAX package's Pallas
kernels in interpret mode; then the dense-KV-cache decode against the
full forward, and the packed and fake weights against each other.

The quantized weights are made by both packages from the same params
and held bitwise; the forwards then run on identical weights (the JAX
tree carried across by convert.fake_qparams_from_numpy). The bar is the
port contract's engine-level one: logits cosine >= 0.999 and equal
greedy argmax at every position. Params are f32, as in the JAX package's
tests/test_model.py (a bf16 forward of random weights turns ulps of
summation order into e2m1 flips); the bf16 forward is held too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.models import llama, quantized
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import cosine, to_numpy

SELECT = 0.125
B, T = 2, 16


def _params(name, dtype=jnp.float32):
    """JAX params (non-zero qkv biases on Qwen2), numpy leaves."""
    cfg = jax_model_config(name)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), dtype)
    rng = np.random.default_rng(0)
    for layer in params["layers"]:
        for proj in ("q", "k", "v"):
            if "b" in layer[proj]:
                layer[proj]["b"] = jnp.asarray(
                    rng.standard_normal(layer[proj]["b"].shape) * 0.1, dtype)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny():
    return {name: _params(name) for name in ("test-tiny", "test-qwen-tiny")}


def _tokens(cfg, seed=1, b=B, t=T):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def assert_close(got, want, what=""):
    got, want = to_numpy(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    c = cosine(got, want)
    assert c >= 0.999, f"{what}: logits cosine {c}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=what)


@pytest.mark.parametrize("name", ["test-tiny", "test-qwen-tiny"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_model_forward_matches_jax(tiny, name, dtype):
    params = (tiny[name] if dtype == "f32"
              else _params(name, jnp.bfloat16))
    cfg = get_model_config(name)
    toks = _tokens(cfg)
    got = llama.model_forward(cfg, convert.params_from_numpy(params),
                              torch.from_numpy(toks))
    want = jllama.model_forward(jax_model_config(name),
                                jax.tree.map(jnp.asarray, params),
                                jnp.asarray(toks))
    assert got.dtype == torch.float32
    assert_close(got, want, f"{name} {dtype}")


# quantize settings of the accuracy path (evaluate's flags)
FAKE = {
    "nvfp4_tensor": dict(),
    "nvfp4_row_channel": dict(act_scale="row", w_scale="channel"),
    "mxfp4": dict(quant_type="MXFP4"),
    "mxfp6": dict(quant_type="MXFP6"),
    "int4": dict(quant_type="INT4"),
    "nvfp4_kv_quant": dict(kv_quant=True, kv_group_size=64),
    "mxfp4_kv_quant_row": dict(quant_type="MXFP4", kv_quant=True,
                               act_scale="row"),
    "nvfp4_a16": dict(act_bits=16),
    "bf16": dict(quant_type="BF16"),
}
PACKED = {
    "w8_row": dict(act_scale="row"),
    "w8_tensor_channel": dict(w_scale="channel"),
    "w4_row_channel": dict(weight_fmt="w4", act_scale="row",
                           w_scale="channel"),
    "w8_a16": dict(act_bits=16, act_scale="row"),
    "w8_kv_quant": dict(kv_quant=True),
}


def _qcfgs(kw, use_kernels):
    base = dict(quant_type="NVFP4", use_kernels=use_kernels)
    return (JQuantConfig(**{**base, **kw}), QuantConfig(**{**base, **kw}))


def _quantized_pair(params, name, kw, use_kernels):
    """Both packages' quantize_model_params of the same params: (port
    tree, JAX tree as numpy, port calib, JAX calib, qcfgs)."""
    jcfg, cfg = jax_model_config(name), get_model_config(name)
    jq, q = _qcfgs(kw, use_kernels)
    jcalib = jquantized.identity_calib(jcfg, SELECT)
    calib = quantized.identity_calib(cfg, SELECT)
    jtree = jquantized.quantize_model_params(
        jcfg, jax.tree.map(jnp.asarray, params), jcalib, jq)
    tree = quantized.quantize_model_params(
        cfg, convert.params_from_numpy(params), calib, q)
    return tree, jtree, calib, jcalib, q, jq


def _assert_same_weights(tree, jtree):
    """The port's quantized weights equal the JAX package's bit for bit."""
    jtree = jax.tree.map(np.asarray, jtree)
    for layer, jlayer in zip(tree["layers"], jtree["layers"]):
        for proj, p in layer.items():
            jp = jlayer[proj]
            if isinstance(p, dict):
                for key, v in p.items():
                    np.testing.assert_array_equal(
                        to_numpy(v), np.asarray(jp[key], np.float32),
                        err_msg=f"{proj}.{key}")
            elif hasattr(p, "codes"):
                got = convert.packed_from_numpy(jp)
                for key in ("codes", "scales", "global_scale"):
                    assert torch.equal(getattr(p, key), getattr(got, key)), (
                        f"{proj}.{key}")
            else:
                np.testing.assert_array_equal(to_numpy(p),
                                              np.asarray(jp, np.float32))


def _forwards(name, tree, jtree, calib, jcalib, q, jq, toks):
    cfg = get_model_config(name)
    port_tree = convert.fake_qparams_from_numpy(
        jax.tree.map(np.asarray, jtree))
    got = quantized.quant_model_forward(cfg, port_tree, calib, q,
                                        torch.from_numpy(toks))
    want = jquantized.quant_model_forward(jax_model_config(name), jtree,
                                          jcalib, jq, jnp.asarray(toks))
    return got, want


@pytest.mark.parametrize("setting", list(FAKE))
def test_fake_quant_forward_matches_jax(tiny, setting):
    """Every format with ARC, act_scale tensor and row, per-tensor and
    per-channel weight scales, KV fake quant, W4A16 and BF16."""
    name = "test-tiny"
    tree, jtree, calib, jcalib, q, jq = _quantized_pair(
        tiny[name], name, FAKE[setting], use_kernels=False)
    _assert_same_weights(tree, jtree)
    toks = _tokens(get_model_config(name))
    got, want = _forwards(name, tree, jtree, calib, jcalib, q, jq, toks)
    assert_close(got, want, setting)
    # the port's own quantized tree gives the same forward
    assert torch.equal(got, quantized.quant_model_forward(
        get_model_config(name), tree, calib, q, torch.from_numpy(toks)))


@pytest.mark.parametrize("setting", ["nvfp4_tensor", "nvfp4_row_channel"])
def test_fake_quant_forward_qkv_bias(tiny, setting):
    name = "test-qwen-tiny"
    tree, jtree, calib, jcalib, q, jq = _quantized_pair(
        tiny[name], name, FAKE[setting], use_kernels=False)
    _assert_same_weights(tree, jtree)
    got, want = _forwards(name, tree, jtree, calib, jcalib, q, jq,
                          _tokens(get_model_config(name)))
    assert_close(got, want, setting)


@pytest.mark.parametrize("setting", list(PACKED))
def test_packed_forward_matches_jax(tiny, setting):
    """The unfused packed forward (use_kernels: quantize_x_arc, the
    GEMMs, flash attention on the no-cache causal path) against the JAX
    package's, whose Pallas kernels run in interpret mode."""
    name = "test-qwen-tiny" if setting == "w8_row" else "test-tiny"
    tree, jtree, calib, jcalib, q, jq = _quantized_pair(
        tiny[name], name, PACKED[setting], use_kernels=True)
    _assert_same_weights(tree, jtree)
    got, want = _forwards(name, tree, jtree, calib, jcalib, q, jq,
                          _tokens(get_model_config(name)))
    assert_close(got, want, setting)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_kv_quant_at_row_scales_within_the_reference_floor(tiny,
                                                           use_kernels):
    """NVFP4 with kv_quant at per-row activation scales on these weights:
    the asym int4 K/V codes flip on f32 ulps of the layer's input (the
    rms_norm and GEMM summation orders), a flip moves an element by a
    sixteenth of its group's range, and the forward leaves the 0.999 bar
    within the JAX package itself: its jitted forward against its eager
    one (ROADMAP queue 3). The port is held to that floor: at least as
    close to the eager reference as the jitted reference is, by logits
    cosine (the bar of the repository's multi-layer engine checks)."""
    name = "test-tiny"
    kw = dict(act_scale="row", kv_quant=True)
    tree, jtree, calib, jcalib, q, jq = _quantized_pair(
        tiny[name], name, kw, use_kernels)
    _assert_same_weights(tree, jtree)
    toks = _tokens(get_model_config(name))
    got, want = _forwards(name, tree, jtree, calib, jcalib, q, jq, toks)
    jitted = jax.jit(lambda t, x: jquantized.quant_model_forward(
        jax_model_config(name), t, jcalib, jq, x))(jtree, jnp.asarray(toks))
    got, want, jitted = (to_numpy(got), np.asarray(want),
                         np.asarray(jitted))
    floor = cosine(jitted, want)
    assert floor < 0.999       # the bar lies below the reference's floor
    assert cosine(got, want) >= floor


@pytest.mark.parametrize("w_scale", ["tensor", "channel"])
@pytest.mark.parametrize("fmt", ["w8", "w4"])
def test_packed_and_fake_weights_dequantize_alike(tiny, w_scale, fmt):
    """A packed linear decodes to its fake twin's w_aug (the ARC columns
    included, the pad zero) with the same global scale; on quantized
    activations the two forwards then differ only by the epilogue's
    order."""
    cfg = get_model_config("test-tiny")
    params = convert.params_from_numpy(tiny["test-tiny"])
    calib = quantized.identity_calib(cfg, SELECT)
    kw = dict(quant_type="NVFP4", w_scale=w_scale, weight_fmt=fmt,
              act_scale="row")
    packed = quantized.quantize_model_params(
        cfg, params, calib, QuantConfig(use_kernels=True, **kw))
    fake = quantized.quantize_model_params(
        cfg, params, calib, QuantConfig(use_kernels=False, **kw))
    for lp, lf in zip(packed["layers"], fake["layers"]):
        for proj, site in quantized._SITE_OF_PROJ.items():
            pw, fw = lp[proj], lf[proj]
            k_aug = fw["w_aug"].shape[1]
            w = gk.dequant_weight(pw)
            if fmt == "w4":      # split-half k order back to natural
                w = torch.stack([w[:pw.kq // 2], w[pw.kq // 2:]],
                                dim=1).reshape(pw.kq, pw.n)
            sel = calib[0][site].select_num
            assert pw.kq == packing.pad_kq(k_aug - sel, sel)
            assert torch.equal(w[:k_aug].t(), fw["w_aug"]), proj
            assert not bool(w[k_aug:].any())
            assert torch.equal(pw.global_scale.reshape(-1),
                               fw["gs"].reshape(-1)), proj
    toks = torch.from_numpy(_tokens(cfg))
    a = quantized.quant_model_forward(cfg, packed, calib,
                                      QuantConfig(use_kernels=True, **kw),
                                      toks)
    b = quantized.quant_model_forward(cfg, fake, calib,
                                      QuantConfig(use_kernels=False, **kw),
                                      toks)
    assert_close(a, b, f"packed vs fake {fmt} {w_scale}")


def _incremental(cfg, layer_fn, params, toks, split):
    """Prefill toks[:, :split], then decode the rest a token at a time
    through dense caches [B, T, Hkv, Dh]; the logits of every position."""
    b, t = toks.shape
    caches = [(torch.zeros((b, t, cfg.num_kv_heads, cfg.head_dim)),) * 2
              for _ in range(cfg.num_layers)]
    outs = []
    for s0, s1 in [(0, split)] + [(i, i + 1) for i in range(split, t)]:
        x = params["embed"][toks[:, s0:s1].long()]
        cos, sin = llama.rope_cos_sin(
            cfg, torch.arange(s0, s1)[None, :].expand(b, s1 - s0))
        new = []
        for i, (p, c) in enumerate(zip(params["layers"], caches)):
            x, nc = layer_fn(i, p, x, cos, sin, c, s0)
            new.append(nc)
        caches = new
        outs.append(llama.head_logits(params, llama.rms_norm(
            x, params["final_norm"], cfg.rms_eps)))
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("mode", ["bf16", "nvfp4_kv_quant"])
def test_kv_cache_decode_matches_full(tiny, mode):
    """The dense-cache path (llama.attention_block's and
    quant_attention_block's): a prefill of T - 4 tokens then 4 decode
    steps give the full forward's logits (per-row activation scales, so
    each token quantizes alike in both)."""
    cfg = get_model_config("test-tiny")
    params = convert.params_from_numpy(tiny["test-tiny"])
    toks = torch.from_numpy(_tokens(cfg))
    if mode == "bf16":
        full = llama.model_forward(cfg, params, toks)
        inc = _incremental(cfg, lambda i, p, x, c, s, kv, n: llama.
                           layer_forward(cfg, p, x, c, s, kv, n),
                           params, toks, T - 4)
    else:
        calib = quantized.identity_calib(cfg, SELECT)
        qcfg = QuantConfig(use_kernels=False, act_scale="row",
                           kv_quant=True)
        qparams = quantized.quantize_model_params(cfg, params, calib, qcfg)
        full = quantized.quant_model_forward(cfg, qparams, calib, qcfg, toks)
        inc = _incremental(cfg, lambda i, p, x, c, s, kv, n: quantized.
                           quant_layer_forward(cfg, p, x, c, s, calib[i],
                                               qcfg, kv, n),
                           qparams, toks, T - 4)
    assert_close(inc, full, mode)
    np.testing.assert_allclose(to_numpy(inc), to_numpy(full), rtol=2e-2,
                               atol=2e-2)


def test_moe_layers_raise():
    """MoE layers, once refused, run on the accuracy path (their parity
    is tests/test_torch_moe_qdq.py's): quantize_model_params holds the
    experts' qdq stacks beside the attention linears, and both forwards
    give finite logits of the right shape."""
    cfg = get_model_config("test-tiny-moe")
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(cfg, gen)
    calib = quantized.identity_calib(cfg, SELECT)
    qcfg = QuantConfig(use_kernels=False)
    tree = quantized.quantize_model_params(cfg, params, calib, qcfg)
    layer = tree["layers"][0]
    assert sorted(layer) == ["attn_norm", "k", "mlp_norm", "moe", "o", "q",
                             "v"]
    assert layer["moe"]["gate"]["w_aug"].shape == (
        cfg.num_experts, cfg.moe_intermediate_size,
        cfg.hidden_size + calib[0]["mlp_in"].select_num)
    toks = torch.zeros((1, 4), dtype=torch.long)
    for out in (quantized.quant_model_forward(cfg, tree, calib, qcfg, toks),
                llama.model_forward(cfg, params, toks)):
        assert out.shape == (1, 4, cfg.vocab_size)
        assert bool(torch.isfinite(out).all())


def test_init_params_shapes_and_seed():
    cfg = get_model_config("test-qwen-tiny")
    a = llama.init_params(cfg, torch.Generator().manual_seed(3))
    b = llama.init_params(cfg, torch.Generator().manual_seed(3))
    assert a["embed"].shape == (cfg.vocab_size, cfg.hidden_size)
    assert a["embed"].dtype == torch.bfloat16
    assert len(a["layers"]) == cfg.num_layers
    assert "b" in a["layers"][0]["q"]
    assert ("lm_head" in a) == (not cfg.tie_embeddings)
    assert torch.equal(a["layers"][1]["down"]["w"], b["layers"][1]["down"]["w"])


def test_fake_and_packed_routes_differ_as_in_the_reference(tiny):
    """The fake and the packed forward (act_scale row, one layer, bf16)
    are not one function up to summation order: the epilogue (y gx gw
    against y (gx gs)) and the attention (flash against dense) round
    some bf16 outputs an ulp apart, and the next quantize turns that into
    e2m1 flips. The JAX package's two routes differ alike; the port
    reproduces each route and so their distance (ROADMAP queue 3)."""
    name = "test-tiny"
    params = jax.tree.map(np.asarray, _params(name, jnp.bfloat16))
    params["layers"] = params["layers"][:1]
    jcfg = jax_model_config(name).replace(num_layers=1)
    cfg = get_model_config(name).replace(num_layers=1)
    toks = _tokens(cfg, b=2, t=64)
    got, want = [], []
    for use_kernels in (False, True):
        jq, q = _qcfgs(dict(act_scale="row"), use_kernels)
        jcalib = jquantized.identity_calib(jcfg, SELECT)
        jtree = jquantized.quantize_model_params(
            jcfg, jax.tree.map(jnp.asarray, params), jcalib, jq)
        want.append(np.asarray(jquantized.quant_model_forward(
            jcfg, jtree, jcalib, jq, jnp.asarray(toks))))
        got.append(to_numpy(quantized.quant_model_forward(
            cfg, convert.fake_qparams_from_numpy(
                jax.tree.map(np.asarray, jtree)),
            quantized.identity_calib(cfg, SELECT), q,
            torch.from_numpy(toks))))
        assert cosine(got[-1], want[-1]) >= 0.9999999
    ref = cosine(want[0], want[1])
    assert ref < 0.99999               # the reference's own two routes
    assert abs(cosine(got[0], got[1]) - ref) < 1e-6
