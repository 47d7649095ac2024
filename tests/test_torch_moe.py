"""The MoE family of arcquant_tpu_torch (models/moe.py, the batched GEMM,
stacked packs) held against the JAX package's models/moe.py, whose
Pallas kernels run in interpret mode here.

The same inputs (numpy, seeded) go to both packages: the experts' bf16
weights, a random reorder index with ARC columns at every site, the
activations. The bars:
  - packing, stacked dequant: bit-exact;
  - route: the same top-k sets, combine weights within 1e-6;
  - GEMMs (the batched one included): the f32 summation order of
    tests/test_torch_gemm.py (1e-5 of the row's magnitude for f32
    outputs, one bf16 ulp plus 1e-4 of it for bf16);
  - the expert FFNs, fed JAX's combine weights cw so that an ulp in a
    router logit cannot swap a token's experts: the bf16 output within
    the GEMM tolerance of JAX's. The measured max is stated at each test.
    Where an f32-order ulp in the gate/up GEMM moves an intermediate
    across an e2m1 boundary, the two down_in quantizes differ there by
    one e2m1 step; `_dense_requant_moved` shows that and the output bar
    leaves those tokens' rows out;
  - the engine, on f32 params as the dense engine tests use: prefill
    (dispatch mode) and 6 decode steps (dense mode) with logits cosine
    >= 0.999 and equal greedy tokens.
"""

import functools
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.engine import InferenceEngine as JEngine
from arcquant_tpu.kernels import gemm as jgemm
from arcquant_tpu.kernels import quantize as jqk
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import moe as jmoe
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert, serve
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.engine.server import make_server
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.models import llama, moe, quantized
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import cosine, to_numpy, to_torch
from tests.test_torch_gemm import assert_summation_order_close

QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
           act_scale="row", w_scale="channel", quantize_lm_head=True)
TINY = "test-tiny-moe"


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _cfg(width):
    """test-tiny-moe (D = F = Fs = 128, 4 experts, top-2, renormalised),
    or its wide variant: D = F = 1024, no shared expert (as the JAX
    package's packed-memory test), where pad_kq leaves the ARC width."""
    cfg = jax_model_config(TINY)
    if width == "wide":
        cfg = cfg.replace(hidden_size=1024, moe_intermediate_size=1024,
                          num_heads=8, shared_expert_size=0)
    return cfg


@functools.lru_cache(maxsize=None)
def _case(width, fmt):
    """Raw expert weights (bf16) of the width's config, a layer calib with
    random reorder indices and ARC columns (64 at K 128, 128 at K 1024),
    both packages' packed params and calibs, both quant configs. Built
    once a (width, format): the JAX package packs slowly on the CPU.
    Callers read and never write them."""
    cfg = _cfg(width)
    rng = np.random.default_rng(len(width))
    e, d, f = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size

    def w(*shape):
        return _bf16(rng.standard_normal(shape) / np.sqrt(shape[-1]))
    raw = {"router": {"w": w(e, d)}, "gate": {"w": w(e, f, d)},
           "up": {"w": w(e, f, d)}, "down": {"w": w(e, d, f)}}
    sites = {"mlp_in": d, "down_in": f}
    if cfg.shared_expert_size:
        fs = cfg.shared_expert_size
        raw.update(sgate={"w": w(fs, d)}, sup={"w": w(fs, d)},
                   sdown={"w": w(d, fs)}, shared_gate={"w": w(1, d)})
        sites["sdown_in"] = fs
    jcal = {s: jquantized.SiteCalib(
        jnp.asarray(rng.permutation(k).astype(np.int32)), k // 8)
        for s, k in sites.items()}
    jqcfg = JQuantConfig(**{**QKW, "weight_fmt": fmt})
    jp = jmoe.quantize_moe_params_packed(
        jax.tree.map(jnp.asarray, raw), jcal, jqcfg)
    cal = convert.calib_from_numpy([jcal])[0]
    return raw, jp, jcal, cal, jqcfg, QuantConfig(**{**QKW,
                                                     "weight_fmt": fmt})


def _port_params(jp):
    return convert._packed_tree(jax.tree.map(np.asarray, jp), "cpu")


def _x(rng, t, d, scale=2.0):
    return _bf16(rng.standard_normal((t, d)) * scale)


def _quantized_x(rng, t, cfg, jcal):
    """JAX's mlp_in quantize of random activations: (xa, gx)."""
    c = jcal["mlp_in"]
    return jqk.quantize_x_arc(jnp.asarray(_x(rng, t, cfg.hidden_size)),
                              c.reorder_index, c.select_num, per_row=True)


def _jax_cw(cfg, jp, x):
    return jmoe.route(cfg, jp["router"]["w"], jnp.asarray(x))


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=-1, keepdims=True) + 1e-30
    return float((np.abs(got - want) / scale).max())


# -- packing, calibration, converter ------------------------------------------

@pytest.mark.parametrize("fmt", ["w8", "w4"])
def test_stacked_pack_reports_one_experts_kq_and_n(fmt):
    cfg = get_model_config(TINY)
    gen = torch.Generator().manual_seed(1)
    p = moe.init_moe_params(cfg, gen)
    calib = quantized.identity_calib(cfg, 0.5)[0]
    mp = moe.quantize_moe_params_packed(
        p, calib, QuantConfig(**{**QKW, "weight_fmt": fmt}))
    pk = mp["down_pk"]
    assert pk.codes.dim() == 3 and pk.codes.shape[0] == cfg.num_experts
    assert (pk.kq, pk.n) == (512, cfg.hidden_size)
    assert pk.global_scale.shape == (cfg.num_experts, cfg.hidden_size)
    assert mp["gateup_pk"].n == (cfg.num_experts * 2
                                 * cfg.moe_intermediate_size)


@pytest.mark.parametrize("name", [TINY, "qwen1.5-moe-a2.7b",
                                  "mixtral-8x7b", "test-tiny"])
@pytest.mark.parametrize("select_frac", [0.0, 0.125])
def test_identity_calib_and_sites_match_jax(name, select_frac):
    """down_in takes moe_intermediate_size on MoE configs, and a shared
    expert adds sdown_in, as in the JAX package."""
    want = jquantized.identity_calib(jax_model_config(name), select_frac)
    cfg = get_model_config(name)
    got = quantized.identity_calib(cfg, select_frac)
    assert quantized.quant_sites(cfg) == jquantized.quant_sites(
        jax_model_config(name))
    assert len(got) == len(want)
    for g, w in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(w)
        for s in g:
            assert g[s].select_num == w[s].select_num
            np.testing.assert_array_equal(to_numpy(g[s].reorder_index),
                                          np.asarray(w[s].reorder_index))


@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("width", ["tiny", "wide"])
def test_quantize_moe_params_packed_bytes(fmt, width):
    """The port packs all experts' rows at once; with per-channel scales
    that gives the bytes of the JAX package's per-expert loop: codes,
    scale bytes and global scales of gateup_pk, the stacked down_pk and
    the shared expert's packs."""
    cfg = _cfg(width)
    raw, jp, _, cal, _, qcfg = _case(width, fmt)
    got = moe.quantize_moe_params_packed(convert.params_from_numpy(raw), cal,
                                         qcfg)
    assert sorted(got) == sorted(jp)
    cls = packing.PackedWeight if fmt == "w4" else packing.PackedWeightI8
    for name, want in jp.items():
        if not hasattr(want, "codes"):
            np.testing.assert_array_equal(to_numpy(got[name]["w"]),
                                          np.asarray(want["w"], np.float32))
            continue
        pk = got[name]
        assert isinstance(pk, cls) and pk.bias is None
        for a, b in zip(pk[:3], want[:3]):
            assert tuple(a.shape) == tuple(b.shape), name
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b),
                                          err_msg=name)


def test_converter_carries_the_moe_tree():
    """qparams_from_numpy on a packed engine tree whose layer holds the
    nested "moe" dict: stacked packs stay stacked, dicts stay dicts."""
    jp = _case("tiny", "w4")[1]
    tree = {"embed": np.zeros((4, 2), np.float32),
            "layers": [{"attn_norm": np.ones(2, np.float32), "moe": jp}]}
    out = convert.qparams_from_numpy(jax.tree.map(np.asarray, tree))
    m = out["layers"][0]["moe"]
    assert isinstance(m["down_pk"], packing.PackedWeight)
    assert m["down_pk"].codes.shape == tuple(jp["down_pk"].codes.shape)
    assert isinstance(m["router"]["w"], torch.Tensor)
    assert isinstance(out["layers"][0]["attn_norm"], torch.Tensor)


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["tiny", "qwen-like"])
def test_route_matches_jax(variant):
    """The same top-k sets and combine weights within 1e-6 (f32 softmax in
    both; renormalised for the tiny config, not for the Qwen-like 8
    experts top-4)."""
    cfg = _cfg("tiny")
    if variant == "qwen-like":
        cfg = cfg.replace(num_experts=8, num_experts_per_tok=4,
                          norm_topk_prob=False)
    rng = np.random.default_rng(4)
    rw = _bf16(rng.standard_normal((cfg.num_experts, cfg.hidden_size))
               / np.sqrt(cfg.hidden_size))
    x = _x(rng, 64, cfg.hidden_size)
    want = np.asarray(jmoe.route(cfg, jnp.asarray(rw), jnp.asarray(x)))
    got = to_numpy(moe.route(get_model_config(TINY).replace(
        num_experts=cfg.num_experts,
        num_experts_per_tok=cfg.num_experts_per_tok,
        norm_topk_prob=cfg.norm_topk_prob), to_torch(rw), to_torch(x)))
    np.testing.assert_array_equal(got > 0, want > 0)
    assert ((got > 0).sum(-1) == cfg.num_experts_per_tok).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- kernels' plain versions --------------------------------------------------

@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("fold_global", [False, True])
def test_dequant_weight_stacked_bitwise(fmt, fold_global):
    """dequant_weight of the stacked down_pk: JAX's bits ([E, Kq, N], w4
    in the split-half k order of each expert), through the plain decode
    of the whole stack at once."""
    cfg = _cfg("wide")
    jp = _case("wide", fmt)[1]
    want = np.asarray(jgemm.dequant_weight(jp["down_pk"], fold_global),
                      np.float32)
    pk = _port_params(jp)["down_pk"]
    got = to_numpy(gk.dequant_weight(pk, fold_global))
    assert got.shape == want.shape == (cfg.num_experts, pk.kq, pk.n)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("gx_kind", ["scalar", "per_expert", "per_row"])
@pytest.mark.parametrize("m", [1, 6])
def test_gemm_dequant_batched_matches_jax(fmt, gx_kind, m):
    """gemm_dequant_batched's plain version against JAX's (its fused
    kernel under vmap, interpret mode): f32 output within 1e-5 of each
    row's magnitude (the f32 summation order; measured 3.6e-7), bf16
    within one bf16 ulp."""
    cfg = _cfg("wide")
    jp = _case("wide", fmt)[1]
    rng = np.random.default_rng(6 + m)
    e = cfg.num_experts
    pk = _port_params(jp)["down_pk"]
    xa = _bf16(rng.standard_normal((e, m, pk.kq)) * 2)
    gx = {"scalar": np.float32(0.7),
          "per_expert": rng.random(e, np.float32) + 0.5,
          "per_row": rng.random((e, m, 1), np.float32) + 0.5}[gx_kind]
    for jdt, tdt, out in ((jnp.float32, torch.float32, "f32"),
                          (jnp.bfloat16, torch.bfloat16, "bf16")):
        want = np.asarray(jgemm.gemm_dequant_batched(
            jnp.asarray(xa), jp["down_pk"], jnp.asarray(gx), out_dtype=jdt),
            np.float32)
        got = gk.gemm_dequant_batched(to_torch(xa), pk,
                                      float(gx) if gx_kind == "scalar"
                                      else torch.from_numpy(gx), tdt)
        assert got.shape == (e, m, pk.n) and got.dtype == tdt
        assert_summation_order_close(to_numpy(got), want, out)
        if out == "f32":
            assert _max_rel(to_numpy(got), want) <= 1e-5


def test_gemm_batched_plain_is_the_per_expert_gemm():
    """The plain batched GEMM is each expert's gemm_dequant, stacked, bit
    for bit (the identity the card holds its kernel to)."""
    cfg = _cfg("tiny")
    jp = _case("tiny", "w8")[1]
    rng = np.random.default_rng(8)
    pk = _port_params(jp)["down_pk"]
    xa = to_torch(_bf16(rng.standard_normal((cfg.num_experts, 3, pk.kq))))
    gx = torch.from_numpy(rng.random((cfg.num_experts, 3, 1), np.float32))
    got = gk.gemm_dequant_batched(xa, pk, gx)
    for i in range(cfg.num_experts):
        one = type(pk)(pk.codes[i], pk.scales[i], pk.global_scale[i], None)
        assert torch.equal(got[i], gk.gemm_dequant(xa[i], one, gx[i]))


# -- the expert FFN -----------------------------------------------------------

def _one_step(a, b):
    """Each element equal or one e2m1 grid step apart (<= max(|a|, |b|))."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool((np.abs(a - b) <= np.maximum(np.abs(a), np.abs(b)) * 1.0001
                 + 1e-6).all())


def _dense_requant_moved(jp, p, jxa, jgx, jcal, cal, e, t):
    """The dense mode's gate/up GEMM in both packages (within the GEMM
    tolerance) and the tokens where its bf16 output differs from JAX's by
    an f32-order ulp. There, and only there, the down_in quantizes may
    differ; the check shows that they differ by at most one e2m1 step,
    and elsewhere that they are bit-exact. Returns those tokens."""
    gu = gk.gemm_dequant(to_torch(jxa), p["gateup_pk"], to_torch(jgx))
    jgu = jgemm.gemm_dequant(jxa, jp["gateup_pk"], jgx)
    assert_summation_order_close(to_numpy(gu), np.asarray(jgu, np.float32),
                                 "bf16")
    moved = np.nonzero((to_numpy(gu) != np.asarray(jgu, np.float32))
                       .any(-1))[0]
    f = gu.shape[1] // (2 * e)
    g4, jg4 = gu.reshape(t, e, 2, f), jgu.reshape(t, e, 2, f)
    inter = qk._silu_mul(g4[:, :, 0], g4[:, :, 1])
    jinter = (jax.nn.silu(jg4[:, :, 0].astype(jnp.float32))
              * jg4[:, :, 1].astype(jnp.float32)).astype(jnp.bfloat16)
    c, jc = cal["down_in"], jcal["down_in"]
    ia = quantized._act_quantize(inter.transpose(0, 1).reshape(e * t, f),
                                 c, QuantConfig(**QKW))[0]
    jia = jqk.quantize_x_arc(jinter.transpose(1, 0, 2).reshape(e * t, f),
                             jc.reorder_index, jc.select_num,
                             per_row=True)[0]
    ia = to_numpy(ia).reshape(e, t, -1)
    jia = np.asarray(jia, np.float32).reshape(e, t, -1)
    still = np.setdiff1d(np.arange(t), moved)
    np.testing.assert_array_equal(ia[:, still], jia[:, still])
    assert _one_step(ia[:, moved], jia[:, moved])
    return moved


@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("mode,width", [("dense", "tiny"), ("dense", "wide"),
                                        ("dispatch", "tiny")])
def test_ffn_packed_matches_jax(fmt, width, mode):
    """_ffn_dense_packed (16 tokens; at the wide width too, where the
    batched GEMM's K is 1152 + pad) and _ffn_dispatch_packed (40 tokens,
    capacity from CAPACITY_FACTOR) against JAX's, on JAX's xa, gx and
    combine weights. Bar: the bf16 output within the GEMM tolerance (one
    bf16 ulp + 1e-4 of the row's magnitude) of JAX's, the tolerance of
    the dense MLP's parity tests. Measured: bit-exact, except at the wide
    width one element of 1024 x 16 off by 3.7e-9 (a near-zero output).
    Tokens whose gate/up GEMM output moved by an f32-order ulp may
    requantize one e2m1 step apart at down_in: _dense_requant_moved
    shows that step and the bar leaves their rows out (none here)."""
    cfg = _cfg(width)
    _, jp, jcal, cal, jqcfg, qcfg = _case(width, fmt)
    rng = np.random.default_rng(20)
    p = _port_params(jp)
    t = 16 if mode == "dense" else 40
    x = _x(rng, t, cfg.hidden_size)
    jxa, jgx = _quantized_x(rng, t, cfg, jcal)
    cw = _jax_cw(cfg, jp, x)
    if mode == "dense":
        want = jmoe._ffn_dense_packed(jp, jxa, jgx, cw, jcal["down_in"],
                                      jqcfg)
        got = moe._ffn_dense_packed(p, to_torch(jxa), to_torch(jgx),
                                    to_torch(cw), cal["down_in"], qcfg)
        moved = _dense_requant_moved(jp, p, jxa, jgx, jcal, cal,
                                     cfg.num_experts, t)
    else:
        k = cfg.num_experts_per_tok
        cap = int(np.ceil(t * k / cfg.num_experts * moe.CAPACITY_FACTOR))
        want = jmoe._ffn_dispatch_packed(jp, jxa, jgx, cw, cap, k,
                                         jcal["down_in"], jqcfg)
        got = moe._ffn_dispatch_packed(p, to_torch(jxa), to_torch(jgx),
                                       to_torch(cw), cap, k, cal["down_in"],
                                       qcfg)
        moved = np.zeros(0, int)
    assert got.shape == (t, cfg.hidden_size) and got.dtype == torch.bfloat16
    rows = np.setdiff1d(np.arange(t), moved)
    assert_summation_order_close(to_numpy(got)[rows],
                                 np.asarray(want, np.float32)[rows], "bf16")


def _jax_slots(cw, k, capacity):
    """The slot assignment of arcquant_tpu/models/moe.py:_ffn_dispatch, in
    its own jax ops: (slot [T*k], kept [T*k])."""
    t, e = cw.shape
    w_l, a_l = jax.lax.top_k(cw, k)
    e_flat = a_l.reshape(-1)
    se = jax.nn.one_hot(e_flat, e, dtype=jnp.int32)
    mypos = jnp.sum((jnp.cumsum(se, axis=0) - se) * se, axis=1)
    keep = (mypos < capacity) & (w_l.reshape(-1) > 0)
    return (np.asarray(jnp.where(keep, e_flat * capacity + mypos,
                                 e * capacity)), np.asarray(keep))


@pytest.mark.parametrize("capacity", [1, 3, 40])
def test_capacity_drop_matches_jax(capacity):
    """With a small capacity, experts overflow: the port assigns the same
    slots as the JAX package (token-major, then top-k order; the rest go
    to the sink), and at capacity 3 its dispatch FFN matches JAX's."""
    cfg = _cfg("tiny")
    _, jp, jcal, cal, jqcfg, qcfg = _case("tiny", "w4")
    rng = np.random.default_rng(30)
    t, k = 24, cfg.num_experts_per_tok
    x = _x(rng, t, cfg.hidden_size)
    cw = _jax_cw(cfg, jp, x)
    slot, w = moe._slots(to_torch(cw), k, capacity)
    jslot, keep = _jax_slots(cw, k, capacity)
    np.testing.assert_array_equal(to_numpy(slot).reshape(-1), jslot)
    np.testing.assert_array_equal(to_numpy(w).reshape(-1) > 0, keep)
    assert (not keep.all()) == (capacity < 40)
    if capacity != 3:
        return
    jxa, jgx = _quantized_x(rng, t, cfg, jcal)
    want = jmoe._ffn_dispatch_packed(jp, jxa, jgx, cw, capacity, k,
                                     jcal["down_in"], jqcfg)
    got = moe._ffn_dispatch_packed(_port_params(jp), to_torch(jxa),
                                   to_torch(jgx), to_torch(cw), capacity, k,
                                   cal["down_in"], qcfg)
    assert_summation_order_close(to_numpy(got), np.asarray(want, np.float32),
                                 "bf16")


@pytest.mark.parametrize("fmt", ["w8", "w4"])
def test_shared_expert_matches_jax(fmt):
    """The shared expert (packed sgate/sup, silu * up, the sdown_in
    quantize, packed sdown): within the GEMM tolerance of JAX's."""
    cfg = _cfg("tiny")
    _, jp, jcal, cal, jqcfg, qcfg = _case("tiny", fmt)
    rng = np.random.default_rng(40)
    t = 12
    x = _x(rng, t, cfg.hidden_size)
    jxa, jgx = _quantized_x(rng, t, cfg, jcal)
    want = jmoe._shared_expert(jp, jnp.asarray(x), jxa, jgx, jcal, jqcfg)
    got = moe._shared_expert(_port_params(jp), to_torch(jxa), to_torch(jgx),
                             cal, qcfg)
    assert_summation_order_close(to_numpy(got), np.asarray(want, np.float32),
                                 "bf16")


@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("mode", ["dense", "dispatch"])
def test_a16_moe_block_matches_jax(fmt, mode, monkeypatch):
    """moe_block with act_bits 16 (the hybrid prefill's W4A16 sites: exact
    bf16 activations padded to the packs' width, unit scale) against
    JAX's, routing included (the same top-k sets are asserted first).
    Dispatch mode by lowering both packages' DENSE_MODE_MAX_T."""
    if mode == "dispatch":
        monkeypatch.setattr(moe, "DENSE_MODE_MAX_T", 8)
        monkeypatch.setattr(jmoe, "DENSE_MODE_MAX_T", 8)
    cfg = _cfg("tiny")
    _, jp, jcal, cal, jqcfg, qcfg = _case("tiny", fmt)
    rng = np.random.default_rng(50)
    x = _x(rng, 20, cfg.hidden_size).reshape(2, 10, -1)
    cw = np.asarray(_jax_cw(cfg, jp, x.reshape(20, -1)))
    p = _port_params(jp)
    np.testing.assert_array_equal(
        to_numpy(moe.route(get_model_config(TINY), p["router"]["w"],
                           to_torch(x.reshape(20, -1)))) > 0, cw > 0)
    want = jmoe.moe_block(cfg, jp, jnp.asarray(x), jcal,
                          jqcfg.replace(act_bits=16))
    got = moe.moe_block(get_model_config(TINY), p, to_torch(x), cal,
                        qcfg.replace(act_bits=16))
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert_summation_order_close(to_numpy(got).reshape(20, -1),
                                 np.asarray(want, np.float32).reshape(20, -1),
                                 "bf16")


# -- the engine and the server ------------------------------------------------

PROMPTS = [list(range(1, 24)), [5, 17, 301, 42, 8, 9, 10]]
STEPS = 6
# both packages' dense-mode limit in the engine tests: the prefill of 2 x
# 23 padded tokens takes dispatch mode, decode (2 tokens) dense mode
ENGINE_DENSE_MAX_T = 16


@pytest.fixture(scope="module")
def jax_moe_run():
    """The JAX MoE engine on test-tiny-moe (f32 params, W4A4 kernels,
    ARC columns at every site): prefill and STEPS greedy decode steps."""
    cfg = jax_model_config(TINY)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    calib = jquantized.identity_calib(cfg, select_frac=0.5)
    ekw = dict(max_batch=2, max_seq_len=48, page_size=16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "DENSE_MODE_MAX_T", ENGINE_DENSE_MAX_T)
        eng = JEngine(cfg, params, calib, JQuantConfig(**QKW),
                      JEngineConfig(**ekw))
        toks, lens, _ = eng._pad_prompts(PROMPTS)
        logits, state = eng.prefill(eng.new_state(), jnp.asarray(toks),
                                    jnp.asarray(lens))
        out, fed = [np.asarray(logits)], []
        active = jnp.asarray(lens > 0)
        for _ in range(STEPS):
            cur = jnp.argmax(logits, -1).astype(jnp.int32)
            fed.append(np.asarray(cur))
            logits, state = eng.decode_step(state, cur, active)
            out.append(np.asarray(logits))
    return dict(params=jax.tree.map(np.asarray, params),
                qparams=jax.tree.map(np.asarray, eng.qparams), calib=calib,
                toks=toks, lens=lens, logits=out, fed=fed, ekw=ekw)


@pytest.mark.parametrize("source", ["raw", "packed"])
def test_moe_engine_matches_jax(jax_moe_run, source, monkeypatch):
    """The port's engine from the raw f32 params (it packs them) or from
    the JAX engine's packed qparams (the converter's MoE tree), against
    the JAX engine: prefill and 6 decode steps fed the same tokens, logits
    cosine >= 0.999 and equal greedy tokens. Every decode step runs the
    batched GEMM once a layer."""
    run = jax_moe_run
    monkeypatch.setattr(moe, "DENSE_MODE_MAX_T", ENGINE_DENSE_MAX_T)
    cfg = get_model_config(TINY)
    calib = convert.calib_from_numpy(run["calib"])
    if source == "raw":
        eng = InferenceEngine(cfg, convert.params_from_numpy(run["params"]),
                              calib, QuantConfig(**QKW),
                              EngineConfig(**run["ekw"]), device="cpu")
        jl0 = run["qparams"]["layers"][0]["moe"]
        np.testing.assert_array_equal(
            to_numpy(eng.qparams["layers"][0]["moe"]["down_pk"].codes),
            jl0["down_pk"].codes)
    else:
        eng = InferenceEngine(cfg, convert.qparams_from_numpy(run["qparams"]),
                              calib, QuantConfig(**QKW),
                              EngineConfig(**run["ekw"]), device="cpu",
                              quantize_params=False)
    calls = []
    real = gk.gemm_dequant_batched
    monkeypatch.setattr(gk, "gemm_dequant_batched",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    logits, state = eng.prefill(eng.new_state(), run["toks"], run["lens"])
    assert calls == []                          # dispatch mode
    active = torch.as_tensor(run["lens"] > 0)
    for i in range(STEPS + 1):
        got, want = to_numpy(logits), run["logits"][i]
        c = cosine(got, want)
        assert c >= 0.999, (i, c)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        if i == STEPS:
            break
        logits, state = eng.decode_step(state, torch.tensor(run["fed"][i]),
                                        active)
    assert calls == [(cfg.num_experts, 2, 512)] * (cfg.num_layers * STEPS)


def test_moe_dummy_engine_generates_in_both_formats():
    """InferenceEngine.dummy builds MoE layers in w8 and w4 (the same
    seed: the same weights), whose decode logits agree bit for bit (the
    w4 GEMMs give the w8 GEMMs' bits), and generate() runs both modes."""
    cfg = get_model_config(TINY)
    calib = quantized.identity_calib(cfg, 0.5)
    engines = {fmt: InferenceEngine.dummy(
        cfg, calib, QuantConfig(**{**QKW, "weight_fmt": fmt}),
        EngineConfig(max_batch=2, max_seq_len=300, page_size=16),
        device="cpu") for fmt in ("w8", "w4")}
    assert isinstance(engines["w4"].qparams["layers"][0]["moe"]["down_pk"],
                      packing.PackedWeight)
    toks, lens, _ = engines["w8"]._pad_prompts([[3, 1, 4], [1, 5]])
    steps = {}
    for fmt, eng in engines.items():
        logits, state = eng.prefill(eng.new_state(), toks, lens)
        out = [logits]
        for cur in ([7, 8], [9, 10]):
            logits, state = eng.decode_step(state, torch.tensor(cur),
                                            torch.ones(2, dtype=torch.bool))
            out.append(logits)
        steps[fmt] = out
    for a, b in zip(steps["w8"], steps["w4"]):
        assert torch.equal(a, b)
    out = engines["w4"].generate([list(range(1, 140)), [2]], 3)
    assert [len(o) for o in out] == [3, 3]
    assert all(0 <= t < cfg.vocab_size for o in out for t in o)


def test_init_layer_params_builds_moe_layers():
    cfg = get_model_config(TINY)
    gen = torch.Generator().manual_seed(0)
    p = llama.init_layer_params(cfg, gen)
    assert "gate" not in p and set(p["moe"]) == {
        "router", "gate", "up", "down", "sgate", "sup", "sdown",
        "shared_gate"}
    assert p["moe"]["down"]["w"].shape == (cfg.num_experts, cfg.hidden_size,
                                           cfg.moe_intermediate_size)
    assert p["q"]["b"].shape == (cfg.q_size,) if cfg.qkv_bias else True


def test_serve_moe_answers_two_requests():
    """python -m arcquant_tpu_torch.serve --model test-tiny-moe --cpu with
    serve.py's defaults (W4A16 chunked prefill, W4A4 decode): two HTTP
    completion requests, one longer than the prefill chunk."""
    args = serve.build_parser().parse_args(
        ["--model", TINY, "--cpu", "--max_batch", "2", "--max_seq_len", "64",
         "--prefill_chunk", "16", "--dynamic_pages", "--prefix_sharing"])
    loop = serve.build_loop(args)
    srv = make_server(loop, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    res = []

    def post(prompt):
        c = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                       timeout=300)
        c.request("POST", "/v1/completions",
                  json.dumps({"prompt": prompt, "max_tokens": 4}))
        r = c.getresponse()
        res.append((r.status, json.loads(r.read())))
        c.close()
    try:
        assert "moe" in loop.batcher.engine.qparams["layers"][0]
        ts = [threading.Thread(target=post, args=(p,))
              for p in ([1, 2, 3] * 9, [4, 5])]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)
        assert [s for s, _ in res] == [200, 200], res
        assert all(len(o["tokens"]) == 4 for _, o in res), res
    finally:
        srv.shutdown()
        srv.server_close()
        loop.shutdown()
