"""The CUDA kernels of arcquant_tpu_torch held against their plain
PyTorch versions on the card, at small shapes with ragged edges; the
decode megakernels also bitwise against the CUDA chain they fuse, the
w4 GEMM against the w8 GEMM on the same weight, the GEMM lab's exact
variants against the production GEMM, and the GEMMs and the large-M
route against f64.

Every test is marked ``gpu`` and skips when torch sees no CUDA device.
This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_gpu.py
(tests/conftest.py imports jax; ``--noconftest`` leaves it out.)
"""

import numpy as np
import pytest
import torch

from arcquant_tpu_torch.cache import paged
from arcquant_tpu_torch.config import get_model_config
from arcquant_tpu_torch.kernels import attention, gemm as gk
from arcquant_tpu_torch.kernels import gemm_lab as gl
from arcquant_tpu_torch.kernels import mlp_fused as mf
from arcquant_tpu_torch.kernels import paged_decode as pdk
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.quant import numerics as N
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import (gpu, outlier_x, require_cuda,
                                        to_numpy)

pytestmark = gpu


def _bf16(x, device="cuda"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(device)


def assert_one_e2m1_step(a, g, ga, gg):
    """The JAX package's TestRmsnormFused bound."""
    a, g = to_numpy(a), to_numpy(g)
    assert float((a != g).mean()) < 0.03
    assert (np.abs(a - g) <= np.maximum(np.abs(a), np.abs(g)) * 1.0001
            + 1e-6).all()
    np.testing.assert_allclose(to_numpy(ga), to_numpy(gg), rtol=1e-2)


@pytest.mark.parametrize("mode", ["plain", "rmsnorm", "silu_mul"])
@pytest.mark.parametrize("m,k", [(4, 3584), (257, 512)])
def test_actq(mode, m, k):
    """Bit-exact for plain and silu_mul; rmsnorm within one e2m1 step."""
    require_cuda()
    rng = np.random.default_rng(30)
    width = 2 * k if mode == "silu_mul" else k
    a = _bf16(outlier_x(rng, m, width, scale=4.0))
    w = _bf16(rng.standard_normal(k) * 0.1 + 1) if mode == "rmsnorm" else None
    args = dict(mode=mode, k=k, kq=packing.pad_kq(k, 64), eps=1e-6)
    xa, gx = qk._actq_cuda(a, w, **args)
    pa, pg = qk.actq_plain(a, w, **args)
    torch.cuda.synchronize()
    if mode == "rmsnorm":
        assert_one_e2m1_step(xa, pa, gx, pg)
    else:
        assert torch.equal(xa, pa) and torch.equal(gx, pg)


def assert_summation_order_close(y, ref, out_f32):
    y, ref = to_numpy(y).astype(np.float64), to_numpy(ref).astype(np.float64)
    scale = np.abs(ref).max(axis=-1, keepdims=True) + 1e-30
    tol = (1e-5 * scale + 1e-6 * np.abs(ref) if out_f32
           else 1e-4 * scale + 2.0 ** -7 * np.abs(ref))
    assert (np.abs(y - ref) <= tol).all(), float(np.abs(y - ref).max())


@pytest.mark.parametrize("m,n", [(4, 4608), (5, 200), (70, 1040),
                                 (130, 384), (4, 128)])
@pytest.mark.parametrize("bias", [False, True])
def test_gemm_w8(m, n, bias):
    """Ragged M and N (N % 16 != 0 takes the scalar edge loads), the
    split-K path at small M, bf16 and f32 outputs."""
    require_cuda()
    rng = np.random.default_rng(40 + m)
    k, select = 960, 64
    w = _bf16(outlier_x(rng, n, k) * 0.05)
    ridx = torch.from_numpy(rng.permutation(k)).cuda()
    b = _bf16(rng.standard_normal(n)) if bias else None
    pw = packing.pack_weight_arc(w, ridx, select, bias=b, w_scale="channel")
    xa, gx = qk.quantize_x_arc(_bf16(outlier_x(rng, m, k)), ridx, select)
    for dt in (torch.float32, torch.bfloat16):
        gs, gw = gx.reshape(-1, 1), pw.global_scale.reshape(1, -1)
        y = gk._gemm_w8_cuda(xa, pw.codes, pw.scales, gs, gw, pw.bias, dt)
        ref = gk.gemm_w8_plain(xa, pw.codes, pw.scales, gs, gw, pw.bias, dt)
        torch.cuda.synchronize()
        assert_summation_order_close(y, ref, dt == torch.float32)


@pytest.mark.parametrize("m", [4, 256])
def test_gemm_w8_bf16_activations_accumulate_in_f32(m):
    """W4A16 prefill operands (bf16 activations, unit scale) over a long
    K: the kernel's mean relative error against f64 stays within 2x the
    plain f32 version's (tensor-core sums carried across every k-step
    lose several times that)."""
    require_cuda()
    rng = np.random.default_rng(50 + m)
    k, n = 4096, 512
    w = _bf16(rng.standard_normal((n, k)) * k ** -0.5)
    pw = packing.pack_weight_arc(w, torch.arange(k).cuda(), 0,
                                 w_scale="channel")
    xa = _bf16(rng.standard_normal((m, k)))
    gs = torch.ones((m, 1), device="cuda")
    gw = pw.global_scale.reshape(1, -1)
    args = (xa, pw.codes, pw.scales, gs, gw, None, torch.float32)
    s = N.ue4m3_from_bytes(pw.scales).double() * 0.5
    wd = pw.codes.double() * s.repeat_interleave(N.NVFP4_GROUP, dim=0)
    f64 = (xa.double() @ wd) * gw.double()
    err = [float(((y.double() - f64).abs().mean() / f64.abs().mean()))
           for y in (gk._gemm_w8_cuda(*args), gk.gemm_w8_plain(*args))]
    assert err[0] <= 2.0 * err[1], err


@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,q_offset", [
    (2, 40, 40, 4, 2, 64, 0), (1, 130, 130, 14, 2, 128, 0),
    (2, 24, 100, 4, 2, 128, 76)])
def test_flash_attention(b, tq, tk, hq, hkv, dh, q_offset):
    require_cuda()
    rng = np.random.default_rng(tq)
    q = _bf16(rng.standard_normal((b, tq, hq, dh)) * 2)
    k = _bf16(rng.standard_normal((b, tk, hkv, dh)) * 2)
    v = _bf16(rng.standard_normal((b, tk, hkv, dh)))
    out = attention._flash_cuda(q, k, v, q_offset)
    ref = attention.flash_attention_plain(q, k, v, q_offset)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_numpy(out), to_numpy(ref), rtol=2.0 ** -7,
                               atol=2e-3)


@pytest.mark.parametrize("seq_lens", [[33, 0, 16, 7], [64, 1, 0, 50]])
def test_paged_decode(seq_lens):
    require_cuda()
    cfg = get_model_config("test-tiny").replace(
        num_heads=14, num_kv_heads=2, head_dim=128, num_layers=1)
    page, bsz, pps = 16, 4, 4
    rng = np.random.default_rng(5)
    cache = paged.init_cache(cfg, 1 + bsz * pps, page, "cuda")
    pt = (1 + torch.arange(bsz)[:, None] * pps
          + torch.arange(pps)[None]).to(torch.int32).cuda()
    t = pps * page
    kv = [_bf16(rng.standard_normal((bsz, t, 2, 128))) for _ in range(2)]
    pos = torch.arange(t)[None].expand(bsz, t).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    pos = torch.where(pos < sl[:, None], pos, -1)
    paged.append_kv(cache, 0, kv[0], kv[1], pt, pos)
    q = _bf16(rng.standard_normal((bsz, 14, 128)))
    o, m, l = pdk._paged_decode_cuda(q, cache.codes[0], cache.params[0], pt, sl)
    po, pm, pl = pdk.paged_decode_state_plain(q, cache.codes[0],
                                              cache.params[0], pt, sl)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_numpy(o), to_numpy(po), rtol=2.0 ** -7,
                               atol=1e-3)
    np.testing.assert_allclose(to_numpy(m), to_numpy(pm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_numpy(l), to_numpy(pl), rtol=1e-4)
    assert (to_numpy(o)[np.asarray(seq_lens) == 0] == 0).all()


@pytest.mark.parametrize("heads,page,tq,starts,seq_lens", [
    ((14, 2, 128), 128, 20, [280, 130, 0, 20], [300, 150, 0, 35]),
    ((14, 2, 128), 128, 37, [0, 100, 0, 3], [37, 137, 0, 30]),
    ((4, 2, 64), 16, 29, [16, 4, 0, 40], [45, 24, 0, 60])])
def test_paged_prefill(heads, page, tq, starts, seq_lens):
    """g = 7 with Dh = 128 and g = 2 with Dh = 64; ragged per-row starts,
    an idle row, rows padded past their length, Tq not a multiple of the
    kernel's query tile. Bar: 1 bf16 ulp + 2e-3 on every query at a
    position < seq; idle rows exactly 0."""
    require_cuda()
    hq, hkv, dh = heads
    cfg = get_model_config("test-tiny").replace(
        num_heads=hq, num_kv_heads=hkv, head_dim=dh, num_layers=1)
    bsz, pps = 4, -(-max(seq_lens) // page)
    rng = np.random.default_rng(tq)
    cache = paged.init_cache(cfg, 1 + bsz * pps, page, "cuda")
    # rows own scattered pages, in reverse order
    pt = (bsz * pps - torch.arange(bsz * pps).reshape(bsz, pps)).to(
        torch.int32).cuda()
    t = pps * page
    kv = [_bf16(rng.standard_normal((bsz, t, hkv, dh)) * 2)
          for _ in range(2)]
    pos = torch.arange(t)[None].expand(bsz, t).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    pos = torch.where(pos < sl[:, None], pos, -1)
    paged.append_kv(cache, 0, kv[0], kv[1], pt, pos)
    q = _bf16(rng.standard_normal((bsz, tq, hq, dh)) * 2)
    args = (q, cache.codes[0], cache.params[0], pt, st, sl)
    o = pdk._paged_prefill_cuda(*args)
    po = pdk.paged_prefill_plain(*args)
    torch.cuda.synchronize()
    live = to_numpy(st[:, None] + torch.arange(tq, device="cuda")[None]
                    < sl[:, None])
    np.testing.assert_allclose(to_numpy(o)[live], to_numpy(po)[live],
                               rtol=2.0 ** -7, atol=2e-3)
    assert np.isfinite(to_numpy(o)).all()
    assert (to_numpy(o)[np.asarray(seq_lens) == 0] == 0).all()


# -- decode megakernels (kernels/mlp_fused.py) --------------------------------

def _bits(t):
    """The raw bits of a tensor (bf16/f32), for bitwise comparison."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(_bits(a), _bits(b))


def _w8_pair(rng, d, f, bias, select_down=0):
    """Packed gateup [d -> 2f] and down [f -> d] weights (down_in with an
    ARC residual of select_down columns)."""
    w_gu = _bf16(outlier_x(rng, 2 * f, d) * d ** -0.5)
    w_dn = _bf16(outlier_x(rng, d, f) * f ** -0.5)
    b_gu = _bf16(rng.standard_normal(2 * f) * 0.1) if bias else None
    b_dn = _bf16(rng.standard_normal(d) * 0.1) if bias else None
    ridx2 = torch.from_numpy(rng.permutation(f)).cuda()
    pw_gu = packing.pack_weight_arc(w_gu, torch.arange(d).cuda(), 0,
                                    bias=b_gu, w_scale="channel")
    pw_dn = packing.pack_weight_arc(w_dn, ridx2, select_down, bias=b_dn,
                                    w_scale="channel")
    return pw_gu, pw_dn


def _gs(pw):
    return pw.global_scale.reshape(1, -1)


def _plain_gemm_close(y, xa, gs, pw):
    """y within the w8 GEMM's f32-sum-order bound of the plain version
    over the same quantized activation."""
    ref = gk.gemm_w8_plain(xa, pw.codes, pw.scales, gs, _gs(pw), pw.bias,
                           y.dtype)
    assert_summation_order_close(y, ref, y.dtype == torch.float32)


@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("mode", ["rmsnorm", "plain"])
@pytest.mark.parametrize("bias", [False, True])
def test_gemm_actq(m, mode, bias):
    """[rmsnorm +] quantize + GEMM in one launch: bit for bit the chain
    (actq, then gemm_w8 with its split-K); against the plain versions
    step by step (the GEMM over the chain's activation within the f32
    sum order; the quantize as test_actq holds it)."""
    require_cuda()
    rng = np.random.default_rng(60 + m)
    d, n = 1024, 1200               # ragged last tile; splits > 1
    w = _bf16(outlier_x(rng, n, d) * d ** -0.5)
    b = _bf16(rng.standard_normal(n) * 0.1) if bias else None
    pw = packing.pack_weight_arc(w, torch.arange(d).cuda(), 0, bias=b,
                                 w_scale="channel")
    x = _bf16(outlier_x(rng, m, d, scale=4.0))
    nw = _bf16(rng.standard_normal(d) * 0.1 + 1) if mode == "rmsnorm" else None
    args = (x, pw, d, torch.bfloat16, nw, 1e-6)
    got = mf._gemm_actq_cuda(*args)
    want = mf.gemm_actq_chain(*args)
    assert mf.GEMM_ACTQ.launches > 0
    torch.cuda.synchronize()
    assert_bitwise(got, want)
    xa, gx = qk._actq_cuda(x, nw, mode=mode, k=d, kq=pw.kq, eps=1e-6)
    _plain_gemm_close(got[0], xa, gx, pw)


@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("f", [1024, 8704])
def test_gu_actq(m, f):
    """gateup + silu*mul + quantize in one launch: bit for bit the chain
    (gemm_w8, then actq's silu_mul mode); f 8704 pads kq2 to 9216."""
    require_cuda()
    rng = np.random.default_rng(70 + m)
    d = 512
    pw_gu, pw_dn = _w8_pair(rng, d, f, bias=True, select_down=64)
    xa1, gs1 = qk.quantize_x_arc(_bf16(outlier_x(rng, m, d)),
                                 torch.arange(d).cuda(), 0, kq=pw_gu.kq)
    args = (xa1, gs1, pw_gu, f, pw_dn.kq, torch.bfloat16)
    got = mf._gu_actq_cuda(*args)
    want = mf.gu_actq_chain(*args)
    torch.cuda.synchronize()
    assert_bitwise(got, want)
    xa2, gu, gx2 = got
    _plain_gemm_close(gu, xa1, gs1, pw_gu)
    pa, pg = qk.actq_plain(gu, None, mode="silu_mul", k=f, kq=pw_dn.kq)
    assert torch.equal(xa2, pa) and torch.equal(gx2, pg)


@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("bias", [False, True])
def test_mlp_w8(m, norm, bias):
    """The whole MLP in one launch, norm and quantized modes: bit for bit
    the chain; each step against its plain version."""
    require_cuda()
    rng = np.random.default_rng(80 + m)
    d, f = 512, 8704                # kq2 padded: 512 zero columns
    pw_gu, pw_dn = _w8_pair(rng, d, f, bias)
    x = _bf16(outlier_x(rng, m, d, scale=4.0))
    if norm:
        nw = _bf16(rng.standard_normal(d) * 0.1 + 1)
        args = (x, None, pw_gu, pw_dn, f, torch.bfloat16, nw, 1e-6)
        xa1, gs1 = qk._actq_cuda(x, nw, mode="rmsnorm", k=d, kq=pw_gu.kq,
                                 eps=1e-6)
    else:
        xa1, gs1 = qk.quantize_x_arc(x, torch.arange(d).cuda(), 0,
                                     kq=pw_gu.kq)
        args = (xa1, gs1, pw_gu, pw_dn, f, torch.bfloat16, None, 0.0)
    got = mf._mlp_w8_cuda(*args)
    want = mf.mlp_w8_chain(*args)
    torch.cuda.synchronize()
    assert_bitwise(got, want)
    out, gu, gx2 = got
    _plain_gemm_close(gu, xa1, gs1, pw_gu)
    xa2, pg = qk.actq_plain(gu, None, mode="silu_mul", k=f, kq=pw_dn.kq)
    assert torch.equal(gx2, pg)
    _plain_gemm_close(out, xa2, gx2, pw_dn)


def test_fused_kernels_refuse_what_they_do_not_take():
    """More than 16 rows, f32 activations or outputs the chain would not
    give: raise, no fallback."""
    require_cuda()
    rng = np.random.default_rng(90)
    pw_gu, pw_dn = _w8_pair(rng, 256, 512, bias=False)
    x = _bf16(rng.standard_normal((17, 256)))
    with pytest.raises(ValueError, match="rows"):
        mf.mlp_w8_fused(x, None, pw_gu, pw_dn, 512, norm_w=x[0],
                        norm_eps=1e-6)
    with pytest.raises(ValueError, match="bf16"):
        mf.gemm_w8_actq_fused(x[:4].float(), pw_gu, 256)
    with pytest.raises(ValueError, match="bf16"):
        mf.mlp_w8_fused(x[:4], None, pw_gu, pw_dn, 512,
                        out_dtype=torch.float32, norm_w=x[0], norm_eps=1e-6)


# -- w4 GEMM and the large-M route (kernels/gemm.py) ---------------------------

def _pair(rng, n, k, select, bias):
    """The same weight packed in w8 and in w4."""
    w = _bf16(outlier_x(rng, n, k) * k ** -0.5)
    ridx = torch.from_numpy(rng.permutation(k)).cuda()
    b = _bf16(rng.standard_normal(n) * 0.1) if bias else None
    return [packing.pack_weight_arc(w, ridx, select, bias=b, fmt=f,
                                    w_scale="channel") for f in ("w8", "w4")]


@pytest.mark.parametrize("n", [640, 200])
@pytest.mark.parametrize("fold", [False, True])
def test_dequant_kernels_bitwise(n, fold):
    """dequant_w8 / dequant_w4 bit for bit their plain versions (N 200:
    the ragged last 16 columns), with and without the folded gw."""
    require_cuda()
    rng = np.random.default_rng(100 + n)
    p8, p4 = _pair(rng, n, 960, 64, False)
    gw = p8.global_scale.reshape(-1) if fold else None
    assert_bitwise([gk._dequant_w8_cuda(p8.codes, p8.scales, gw),
                    gk._dequant_w4_cuda(p4.codes, p4.scales, gw)],
                   [gk.dequant_w8_plain(p8.codes, p8.scales, gw),
                    gk.dequant_w4_plain(p4.codes, p4.scales, gw)])


@pytest.mark.parametrize("m,k", [(4, 512), (130, 4096)])
def test_pin_rowmajor_bitwise(m, k):
    require_cuda()
    x = _bf16(np.random.default_rng(m).standard_normal((m, k)) * 3)
    assert_bitwise([gk._pin_rowmajor_cuda(x)], [gk.pin_rowmajor_plain(x)])


@pytest.mark.parametrize("m,n", [(4, 4608), (5, 200), (70, 1040),
                                 (130, 384)])
@pytest.mark.parametrize("bias", [False, True])
def test_gemm_w4_bitwise_equals_w8(m, n, bias):
    """gemm_w4 on a w4 pack gives gemm_w8's bits on a w8 pack of the same
    weight (32-row tile with split-K, 128-row tile, ragged N), bf16 and
    f32 outputs; and holds the w8 GEMM's sum-order bound of the plain
    version."""
    require_cuda()
    rng = np.random.default_rng(110 + m)
    p8, p4 = _pair(rng, n, 960, 64, bias)
    xa, gx = qk.quantize_x_arc(_bf16(outlier_x(rng, m, 960)),
                               torch.arange(960).cuda(), 64, kq=p8.kq)
    for dt in (torch.float32, torch.bfloat16):
        gs, gw = gx.reshape(-1, 1), _gs(p8)
        y4 = gk._gemm_w4_cuda(xa, p4.codes, p4.scales, gs, gw, p4.bias, dt)
        y8 = gk._gemm_w8_cuda(xa, p8.codes, p8.scales, gs, gw, p8.bias, dt)
        ref = gk.gemm_w4_plain(xa, p4.codes, p4.scales, gs, gw, p4.bias, dt)
        torch.cuda.synchronize()
        assert_bitwise([y4], [y8])
        assert_summation_order_close(y4, ref, dt == torch.float32)


def _f64(xa, pw, gs):
    wd = packing.dequantize_weight(pw, torch.float64)
    return (xa.double() @ wd) * gs.double() * _gs(pw).double()


def _rel_err(y, f64):
    return float((y.double() - f64).abs().mean() / f64.abs().mean())


@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("m", [4, 600])
def test_gemm_and_route_accumulate_in_f32(fmt, m, monkeypatch):
    """bf16 activations (W4A16 operands, unit scale) over K 4096: the
    GEMM kernel of the format (route off) and the large-M route (dequant
    kernel, pin for w4, torch.mm to f32) each within 2x the plain f32
    version's mean relative error against f64."""
    require_cuda()
    rng = np.random.default_rng(120 + m)
    k, n = 4096, 4608
    pw = _pair(rng, n, k, 0, False)[fmt == "w4"]
    xa = _bf16(rng.standard_normal((m, k)))
    gs = torch.ones((m, 1), device="cuda")
    f64 = _f64(xa, pw, gs)
    plain = (gk.gemm_w8_plain if fmt == "w8" else gk.gemm_w4_plain)(
        xa, pw.codes, pw.scales, gs, _gs(pw), None, torch.float32)
    cuda = (gk._gemm_w8_cuda if fmt == "w8" else gk._gemm_w4_cuda)(
        xa, pw.codes, pw.scales, gs, _gs(pw), None, torch.float32)
    monkeypatch.setattr(gk, "XLA_M", 2)
    launches = gk.DEQUANT_W8.launches + gk.DEQUANT_W4.launches
    route = gk.gemm_dequant(xa, pw, 1.0, torch.float32)
    torch.cuda.synchronize()
    assert gk.DEQUANT_W8.launches + gk.DEQUANT_W4.launches == launches + 1
    e_plain = _rel_err(plain, f64)
    for y in (cuda, route):
        assert _rel_err(y, f64) <= 2.0 * e_plain, (_rel_err(y, f64), e_plain)


# -- the batched GEMM and stacked dequant (MoE experts) -----------------------

def _stack(rng, e, n, k, select):
    """E experts' [n, k] weights packed together in w8 and in w4, as
    moe.quantize_moe_params_packed stacks the down projections."""
    w = _bf16(outlier_x(rng, e * n, k) * k ** -0.5)
    ridx = torch.from_numpy(rng.permutation(k)).cuda()
    out = []
    for fmt in ("w8", "w4"):
        pw = packing.pack_weight_arc_rows(w, ridx, select, fmt=fmt)

        def stack(t):
            return t.reshape(t.shape[0], e, n).transpose(0, 1).contiguous()
        out.append(type(pw)(stack(pw.codes), stack(pw.scales),
                            pw.global_scale.reshape(e, n), None))
    return out


@pytest.mark.parametrize("e,m", [(4, 1), (4, 4), (4, 256), (60, 1),
                                 (60, 4), (60, 256)])
def test_gemm_batched_bitwise_equals_per_expert_gemm(e, m):
    """gemm_batched (one launch over the experts) gives each expert the
    bits of a gemm_w8 / gemm_w4 launch on that expert (the per-expert
    chain), in both formats and output types, per-row scales; and holds
    the sum-order bound of its plain version. Qwen1.5-MoE's down shape:
    K 1408 with 192 ARC columns (Kq 2048), N 2048 (E 4: a narrower N)."""
    require_cuda()
    rng = np.random.default_rng(200 + e + m)
    n = 2048 if e == 60 else 520
    p8, p4 = _stack(rng, e, n, 1408, 192)
    xa = _bf16(rng.standard_normal((e, m, p8.kq)) * 2)
    gs = torch.from_numpy(rng.random((e, m, 1), np.float32) + 0.5).cuda()
    for pk in (p8, p4):
        gw = pk.global_scale.reshape(e, 1, n)
        for dt in (torch.float32, torch.bfloat16):
            n0 = gk.GEMM_BATCHED.launches
            y = gk._gemm_batched_cuda(xa, pk.codes, pk.scales, gs, gw, dt)
            assert gk.GEMM_BATCHED.launches == n0 + 1
            chain = gk.gemm_batched_chain(xa, pk.codes, pk.scales, gs, gw, dt)
            ref = gk.gemm_batched_plain(xa, pk.codes, pk.scales, gs, gw, dt)
            torch.cuda.synchronize()
            assert y.shape == (e, m, n) and y.dtype == dt
            assert_bitwise([y], [chain])
            assert_summation_order_close(y.reshape(e * m, n),
                                         ref.reshape(e * m, n),
                                         dt == torch.float32)
    # the dispatcher with a scalar and a per-expert activation scale
    for gx in (0.5, torch.full((e,), 0.5, device="cuda")):
        y = gk.gemm_dequant_batched(xa, p8, gx)
        assert_bitwise([y], [gk.gemm_batched_chain(
            xa, p8.codes, p8.scales, torch.full((e, m, 1), 0.5,
                                                device="cuda"),
            p8.global_scale.reshape(e, 1, n), torch.bfloat16)])


@pytest.mark.parametrize("fold", [False, True])
def test_dequant_stacked_bitwise(fold):
    """A stack of 60 experts' packs decodes in one launch, bit for bit the
    plain decode of the stack (w4 in each expert's split-half order)."""
    require_cuda()
    rng = np.random.default_rng(300)
    e, n = 60, 200
    p8, p4 = _stack(rng, e, n, 1408, 192)
    for pk in (p8, p4):
        gw = pk.global_scale if fold else None
        kern = gk._dequant_w4_cuda if pk is p4 else gk._dequant_w8_cuda
        plain = gk.dequant_w4_plain if pk is p4 else gk.dequant_w8_plain
        launches = gk.DEQUANT_W8.launches + gk.DEQUANT_W4.launches
        got = kern(pk.codes, pk.scales, gw)
        assert gk.DEQUANT_W8.launches + gk.DEQUANT_W4.launches == launches + 1
        assert_bitwise([got], [plain(pk.codes, pk.scales, gw)])
        assert gk.dequant_weight(pk, fold).shape == (e, pk.kq, n)


# -- the GEMM lab (kernels/gemm_lab.py) ----------------------------------------

def _lab_case(rng, m, n, k, select):
    """One weight in w8 and w4, its quantized activations, and the lab
    operands (gs [M], gw [N])."""
    p8, p4 = _pair(rng, n, k, select, False)
    xa, gx = qk.quantize_x_arc(_bf16(outlier_x(rng, m, k)),
                               torch.arange(k).cuda(), select, kq=p8.kq)
    gw = p8.global_scale.reshape(-1).float().contiguous()
    return p8, p4, xa, gx, gw


def _lab_checks(y, ref, production, exact):
    """y vs its plain version within the sum-order bound (+1e-30 for the
    near-denormal nodec probe); an exact decode bitwise = production."""
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == production.shape
    assert bool(torch.isfinite(y).all())
    y, ref = to_numpy(y).astype(np.float64), to_numpy(ref).astype(np.float64)
    tol = (1e-4 * np.abs(ref).max(axis=-1, keepdims=True)
           + 2.0 ** -7 * np.abs(ref) + 1e-30)
    assert (np.abs(y - ref) <= tol).all(), float(np.abs(y - ref).max())
    if exact:
        np.testing.assert_array_equal(y, to_numpy(production))


@pytest.mark.parametrize("m,n,select", [(4, 4608, 0), (5, 208, 64),
                                        (16, 1040, 64), (40, 384, 0)])
def test_lab_modes_against_plain_and_production(m, n, select):
    """Every decode mode of lab_w8 and lab_w4 (128 x 128, 3 stages, the
    production split plan: 7 splits at M 4, N 4608): within the sum-order
    bound of its plain version; the exact modes bit for bit gemm_w8
    (gemm_w4 for w4, which gives the same bits)."""
    require_cuda()
    rng = np.random.default_rng(400 + m)
    p8, p4, xa, gx, gw = _lab_case(rng, m, n, 960, select)
    prod = gk._gemm_w8_cuda(xa, p8.codes, p8.scales, gx, gw.reshape(1, -1),
                            None, torch.bfloat16)
    gs = gx.reshape(-1)
    for mode in gl.W8_MODES:
        n0 = gl.LAB_W8.launches
        y = gl.lab_w8(xa, p8.codes, p8.scales, gs, gw, mode=mode)
        assert gl.LAB_W8.launches == n0 + 1
        _lab_checks(y, gl.lab_w8_plain(xa, p8.codes, p8.scales, gs, gw, mode),
                    prod, mode in gl.EXACT_MODES)
    for mode in gl.W4_MODES:
        y = gl.lab_w4(xa, p4.codes, p4.scales, gs, gw, mode=mode)
        _lab_checks(y, gl.lab_w4_plain(xa, p4.codes, p4.scales, gs, gw, mode),
                    prod, mode in gl.EXACT_MODES)


def test_lab_every_configuration():
    """Every instantiated tile and ring configuration launches and, in an
    exact mode at the production plan, gives gemm_w8's bits (M 4, N 1040:
    a ragged last tile for every BN; Kq 1024, 2 splits)."""
    require_cuda()
    rng = np.random.default_rng(410)
    p8, p4, xa, gx, gw = _lab_case(rng, 4, 1040, 960, 64)
    gs = gx.reshape(-1)
    prod = gk._gemm_w8_cuda(xa, p8.codes, p8.scales, gx, gw.reshape(1, -1),
                            None, torch.bfloat16)
    for bn, bks, stages, mode in gl.LAB_CONFIGS:
        if mode in gl.W8_MODES:
            y = gl.lab_w8(xa, p8.codes, p8.scales, gs, gw, mode=mode, bn=bn,
                          bks=bks, stages=stages)
            ref = gl.lab_w8_plain(xa, p8.codes, p8.scales, gs, gw, mode)
        else:
            y = gl.lab_w4(xa, p4.codes, p4.scales, gs, gw, mode=mode, bn=bn,
                          bks=bks, stages=stages)
            ref = gl.lab_w4_plain(xa, p4.codes, p4.scales, gs, gw, mode)
        _lab_checks(y, ref, prod, mode in gl.EXACT_MODES)
    ref = gl.lab_w8_plain(xa, p8.codes, p8.scales, gs, gw)
    for bn, bks, stages in gl.RING_CONFIGS:
        for blocks in (None, 7, 1000):
            y = gl.lab_w8_ring(xa, p8.codes, p8.scales, gs, gw, bn=bn,
                               bks=bks, stages=stages, blocks=blocks)
            _lab_checks(y, ref, prod, True)
    with pytest.raises(ValueError, match="not built"):
        gl.lab_w8(xa, p8.codes, p8.scales, gs, gw, bn=256, bks=256)


@pytest.mark.parametrize("n", [37888, 4608])
def test_lab_ring_n(n):
    """One block per n tile over the whole K: bit for bit gemm_w8 where
    the production plan has one split (gateup at M 4: 296 n tiles), the
    sum-order bound of the plain version where it splits (qkv: 7)."""
    require_cuda()
    rng = np.random.default_rng(420)
    p8, _, xa, gx, gw = _lab_case(rng, 4, n, 3584, 0)
    _, splits, _ = gk._split_plan(4, n, p8.kq)
    assert (splits == 1) == (n == 37888)
    gs = gx.reshape(-1)
    prod = gk._gemm_w8_cuda(xa, p8.codes, p8.scales, gx, gw.reshape(1, -1),
                            None, torch.bfloat16)
    for bn, bks, stages, mode in gl.LAB_CONFIGS:
        if mode == "base" and (bn, bks) == (128, 128):
            y = gl.lab_w8_ring_n(xa, p8.codes, p8.scales, gs, gw, bn=bn,
                                 bks=bks, stages=stages)
            _lab_checks(y, gl.lab_w8_plain(xa, p8.codes, p8.scales, gs, gw),
                        prod, splits == 1)


@pytest.mark.parametrize("splits", [1, 2, 5, 7, 16])
def test_lab_splits(splits):
    """lab_w8 and lab_w4 at a given split count (qkv at M 4: production
    plans 7): within the sum-order bound of the plain version, and bit
    for bit gemm_w8 where the count gives production's plan."""
    require_cuda()
    rng = np.random.default_rng(430 + splits)
    p8, p4, xa, gx, gw = _lab_case(rng, 4, 4608, 3584, 0)
    gs = gx.reshape(-1)
    prod = gk._gemm_w8_cuda(xa, p8.codes, p8.scales, gx, gw.reshape(1, -1),
                            None, torch.bfloat16)
    same = gl._plan(4, 4608, p8.kq, splits) == gl._plan(4, 4608, p8.kq, None)
    y = gl.lab_w8(xa, p8.codes, p8.scales, gs, gw, splits=splits)
    _lab_checks(y, gl.lab_w8_plain(xa, p8.codes, p8.scales, gs, gw), prod,
                same)
    y = gl.lab_w4(xa, p4.codes, p4.scales, gs, gw, splits=splits)
    _lab_checks(y, gl.lab_w4_plain(xa, p4.codes, p4.scales, gs, gw), prod,
                same)
