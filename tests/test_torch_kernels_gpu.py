"""The CUDA kernels of arcquant_tpu_torch held against their plain
PyTorch versions on the card, at small shapes with ragged edges; the
decode megakernels also bitwise against the CUDA chain they fuse, the
w4 GEMM against the w8 GEMM on the same weight, the GEMM lab's exact
variants against the production GEMM, and the GEMMs and the large-M
route against f64. Then the engine's decode step captured as a CUDA
graph (2 layers at full width) against the eager loop
(cuda_graphs=False): logits and tokens bitwise in every decode
configuration, sampled decode_scan, a second state, the launch counts,
no host synchronisation, and a capture that fails raising.

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
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.engine import engine as engine_mod
from arcquant_tpu_torch.engine.sampling import SamplingParams
from arcquant_tpu_torch.kernels import _build, attention, gemm as gk
from arcquant_tpu_torch.kernels import gemm_lab as gl
from arcquant_tpu_torch.kernels import mlp_fused as mf
from arcquant_tpu_torch.kernels import paged_decode as pdk
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.models import llama, quantized
from arcquant_tpu_torch.quant import numerics as N
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import (cosine, gpu, outlier_x,
                                        require_cuda, to_numpy)

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


def _actq_input(rng, m, k, mode, lda_pad=0):
    """[m, k] rows (gate and up for silu_mul), in a buffer whose row
    stride is lda_pad columns wider; the norm weight for rmsnorm."""
    width = 2 * k if mode == "silu_mul" else k
    a = _bf16(outlier_x(rng, m, width + lda_pad, scale=4.0))[:, :width]
    w = _bf16(rng.standard_normal(k) * 0.1 + 1) if mode == "rmsnorm" else None
    return a, w


# M 1 to 4096 (the decode rows, one past a 256-row multiple, a prefill),
# Qwen2.5-7B's hidden and intermediate widths (K 18944 runs past the
# kept passes into shared memory) and K 512; rows with a stride wider
# than their width at M 4 and 257
ACTQ_SHAPES = [(1, 3584), (4, 3584), (16, 3584), (257, 512), (257, 3584),
               (4096, 3584), (4, 18944), (16, 18944), (4096, 18944)]


@pytest.mark.parametrize("mode", ["plain", "rmsnorm", "silu_mul"])
@pytest.mark.parametrize("m,k", ACTQ_SHAPES)
def test_actq(mode, m, k):
    """Bit-exact for plain and silu_mul; rmsnorm within one e2m1 step of
    the plain version (and bitwise the kernel-order emulation), with kq
    past k (ARC padding) and, at M 4 and 257, a row stride past the
    row."""
    require_cuda()
    rng = np.random.default_rng(30 + m + k)
    a, w = _actq_input(rng, m, k, mode, lda_pad=64 if m in (4, 257) else 0)
    args = dict(mode=mode, k=k, kq=packing.pad_kq(k, 64), eps=1e-6)
    xa, gx = qk._actq_cuda(a, w, **args)
    pa, pg = qk.actq_plain(a, w, **args)
    torch.cuda.synchronize()
    if mode == "rmsnorm":
        assert_one_e2m1_step(xa, pa, gx, pg)
        pa, pg = qk.actq_kernel_order(a, w, **args)
    assert torch.equal(xa, pa) and torch.equal(gx, pg)


@pytest.mark.parametrize("mode", ["plain", "rmsnorm", "silu_mul"])
def test_actq_copies_rows_it_cannot_load(mode):
    """Rows that start off 16 bytes, with an odd row stride: the wrapper
    copies them for the kernel's 16-byte loads, with the same bits; the
    fused gemm_actq takes the same view bit for bit its chain."""
    require_cuda()
    rng = np.random.default_rng(90)
    m, k = 5, 3584
    width = 2 * k if mode == "silu_mul" else k
    buf = _bf16(outlier_x(rng, m, width + 1, scale=4.0))
    a = buf[:, 1:]
    assert a.data_ptr() % 16 and a.stride(0) % 8
    w = _bf16(rng.standard_normal(k) * 0.1 + 1) if mode == "rmsnorm" else None
    args = dict(mode=mode, k=k, kq=k + 64, eps=1e-6)
    got = qk._actq_cuda(a, w, **args)
    want = qk.actq_kernel_order(a, w, **args)
    torch.cuda.synchronize()
    assert_bitwise(got, want)
    if mode != "silu_mul":
        pw = packing.pack_weight_arc(
            _bf16(outlier_x(rng, 640, k) * k ** -0.5),
            torch.arange(k).cuda(), 0, w_scale="channel")
        fargs = (a, pw, k, torch.bfloat16, w, 1e-6)
        got = mf._gemm_actq_cuda(*fargs)
        want = mf.gemm_actq_chain(*fargs)
        torch.cuda.synchronize()
        assert_bitwise(got, want)


@pytest.mark.parametrize("m,k", [(1, 512), (4, 3584), (16, 3584),
                                 (300, 3584), (4, 18944), (2048, 4096)])
def test_actq_rmsnorm_bits_equal_kernel_order(m, k):
    """The card's rmsnorm output bit for bit the emulation of its sum
    order (quantize.actq_kernel_order, tests/test_torch_actq_order.py),
    run on the card: the order is a function of K alone, so no plan
    moves a bit. Each shape at the wrapper's plan and at one block a
    row."""
    require_cuda()
    rng = np.random.default_rng(50 + m)
    a, w = _actq_input(rng, m, k, "rmsnorm")
    args = dict(mode="rmsnorm", k=k, kq=k + 128, eps=1e-5)
    want = qk.actq_kernel_order(a, w, **args)
    got = qk._actq_cuda(a, w, **args)
    plan = qk.actq_plan
    try:
        qk.actq_plan = lambda m_, k_, mode_: m_
        one = qk._actq_cuda(a, w, **args)
    finally:
        qk.actq_plan = plan
    torch.cuda.synchronize()
    assert_bitwise(got, want)
    assert_bitwise(one, want)


def assert_summation_order_close(y, ref, out_f32):
    y, ref = to_numpy(y).astype(np.float64), to_numpy(ref).astype(np.float64)
    scale = np.abs(ref).max(axis=-1, keepdims=True) + 1e-30
    tol = (1e-5 * scale + 1e-6 * np.abs(ref) if out_f32
           else 1e-4 * scale + 2.0 ** -7 * np.abs(ref))
    assert (np.abs(y - ref) <= tol).all(), float(np.abs(y - ref).max())


# Qwen2.5-7B's down projection: K 18944 with its ARC residual (select
# 0.125), the widest Kq of the prefill's large-M GEMMs
K_DOWN, SEL_DOWN = 18944, 2368
KQ_DOWN = packing.pad_kq(K_DOWN, SEL_DOWN)    # 21504
# the large-M tile's cases: M 65 (one row past the small tile), 128, 1000
# (a ragged m tile) and 4096 at down's Kq, N 1040 (not a multiple of the
# 128-column tile)
LARGE_M = [(65, 1040), (128, 1040), (1000, 1040), (4096, 1040)]
# the small-M tile's cases (M <= 64): every m-tile height at Qwen2.5-7B's
# qkv (K 3584 with select 448: Kq 4096, N 4608), M 4 at down's Kq 21504
# and N 3584, and M 4 at Kq 960 (a multiple of 32 but not of the ring's
# 128-deep stage: a partial last stage) with N 200 (not a multiple of 16)
SMALL_M = ([(m, 4608, 3584, 448) for m in (1, 16, 17, 33, 64)]
           + [(4, 3584, K_DOWN, SEL_DOWN), (4, 200, 960, 0)])


def _pad_multiple(k, select):
    """pack_weight_arc's pad_multiple in the GEMM tests: 32 for a
    select-free K that is not a multiple of 128 (SMALL_M's ragged Kq 960),
    else the default."""
    return 32 if select == 0 and k % 128 else packing.K_PAD_MULTIPLE


@pytest.mark.parametrize("m,n,k,select",
                         [(m, n, 960, 64) for m, n in
                          [(4, 4608), (5, 200), (70, 1040), (130, 384),
                           (4, 128), (1000, 200)]]
                         + [(m, n, K_DOWN, SEL_DOWN) for m, n in LARGE_M]
                         + SMALL_M)
@pytest.mark.parametrize("bias", [False, True])
def test_gemm_w8(m, n, k, select, bias):
    """Ragged M and N (N % 16 != 0: the small tile's plain-load stages,
    the large tile's zero-padded columns), the split-K path at small M
    with every m-tile height and a partial last stage, the large-M tile
    at down's Kq, bf16 and f32 outputs."""
    require_cuda()
    rng = np.random.default_rng(40 + m)
    w = _bf16(outlier_x(rng, n, k) * 0.05)
    ridx = torch.from_numpy(rng.permutation(k)).cuda()
    b = _bf16(rng.standard_normal(n)) if bias else None
    pw = packing.pack_weight_arc(w, ridx, select, bias=b, w_scale="channel",
                                 pad_multiple=_pad_multiple(k, select))
    xa, gx = qk.quantize_x_arc(_bf16(outlier_x(rng, m, k)), ridx, select,
                               kq=pw.kq)
    for dt in (torch.float32, torch.bfloat16):
        gs, gw = gx.reshape(-1, 1), pw.global_scale.reshape(1, -1)
        y = gk._gemm_w8_cuda(xa, pw.codes, pw.scales, gs, gw, pw.bias, dt)
        ref = gk.gemm_w8_plain(xa, pw.codes, pw.scales, gs, gw, pw.bias, dt)
        torch.cuda.synchronize()
        assert_summation_order_close(y, ref, dt == torch.float32)


@pytest.mark.parametrize("m,k,n", [(4, 4096, 512), (256, 4096, 512)]
                         + [(m, KQ_DOWN, n) for m, n in LARGE_M]
                         + [(m, KQ_DOWN, 1040) for m in (16, 64)])
def test_gemm_w8_bf16_activations_accumulate_in_f32(m, k, n):
    """W4A16 prefill operands (bf16 activations, unit scale) over a long
    K (up to down's Kq, 21504): the kernel's mean relative error against f64
    stays within 2x the plain f32 version's (tensor-core sums carried
    across every k-step lose several times that)."""
    require_cuda()
    rng = np.random.default_rng(50 + m)
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


# tile edges (Tq, Tk of 1, 15, 129, 200 against 64-row q tiles and
# 64-key kv tiles), Dh 64 and 128, G 1 and 7, q_offset > 0 with Tq < Tk
@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,q_offset", [
    (2, 40, 40, 4, 2, 64, 0), (1, 130, 130, 14, 2, 128, 0),
    (2, 24, 100, 4, 2, 128, 76),
    (1, 1, 1, 7, 1, 128, 0), (2, 15, 15, 2, 2, 64, 0),
    (1, 129, 129, 7, 1, 128, 0), (2, 200, 200, 4, 4, 64, 0),
    (1, 200, 200, 14, 2, 128, 0), (1, 1, 200, 14, 2, 128, 199),
    (2, 15, 129, 7, 1, 64, 114), (1, 129, 200, 4, 4, 128, 71),
    (1, 15, 200, 7, 1, 128, 100)])
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


@pytest.mark.parametrize("t,hq,hkv,dh", [(200, 14, 2, 128), (129, 4, 4, 64)])
def test_flash_attention_fused_qkv_views(t, hq, hkv, dh):
    """q/k/v as slices of one [B, T, (Hq + 2 Hkv) Dh] tensor, as the
    engine passes the fused qkv output."""
    require_cuda()
    rng = np.random.default_rng(t)
    b = 2
    qkv = _bf16(rng.standard_normal((b, t, (hq + 2 * hkv) * dh)) * 2)
    q = qkv[..., :hq * dh].view(b, t, hq, dh)
    k = qkv[..., hq * dh:(hq + hkv) * dh].view(b, t, hkv, dh)
    v = qkv[..., (hq + hkv) * dh:].view(b, t, hkv, dh)
    out = attention._flash_cuda(q, k, v)
    ref = attention.flash_attention_plain(q.contiguous(), k.contiguous(),
                                          v.contiguous())
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_numpy(out), to_numpy(ref), rtol=2.0 ** -7,
                               atol=2e-3)


def test_flash_attention_refuses_misaligned():
    """cp.async needs 16-byte aligned q/k/v: a view 2 bytes off raises."""
    require_cuda()
    b, t, h, dh = 1, 16, 2, 64
    q = torch.zeros((b, t, h, dh), dtype=torch.bfloat16, device="cuda")
    buf = torch.zeros(b * t * h * dh + 1, dtype=torch.bfloat16,
                      device="cuda")
    off = buf[1:].view(b, t, h, dh)
    for args in ((off, q, q), (q, off, q), (q, q, off)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            attention._flash_cuda(*args)


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


# more than one split of the page loop (decode_split_plan), G 1 and 7, a
# seq-0 row, rows whose later splits lie wholly past seq_len, and every
# split empty
@pytest.mark.parametrize("hq,hkv,pps,seq_lens", [
    (14, 2, 16, [256, 0, 17, 100]), (4, 4, 16, [1, 255, 0, 130]),
    (14, 2, 80, [1280, 0, 1, 700]), (7, 1, 24, [384, 200, 0, 33]),
    (4, 4, 20, [0, 0, 0, 0])])
def test_paged_decode_splits(hq, hkv, pps, seq_lens):
    require_cuda()
    bsz, page, dh = 4, 16, 128
    splits, per = pdk.decode_split_plan(bsz, hkv, pps)
    assert splits > 1
    cfg = get_model_config("test-tiny").replace(
        num_heads=hq, num_kv_heads=hkv, head_dim=dh, num_layers=1)
    rng = np.random.default_rng(pps)
    cache = paged.init_cache(cfg, 1 + bsz * pps, page, "cuda")
    pt = (1 + torch.arange(bsz)[:, None] * pps
          + torch.arange(pps)[None]).to(torch.int32).cuda()
    t = pps * page
    kv = [_bf16(rng.standard_normal((bsz, t, hkv, dh))) for _ in range(2)]
    pos = torch.arange(t)[None].expand(bsz, t).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    pos = torch.where(pos < sl[:, None], pos, -1)
    paged.append_kv(cache, 0, kv[0], kv[1], pt, pos)
    q = _bf16(rng.standard_normal((bsz, hq, dh)) * 2)
    args = (q, cache.codes[0], cache.params[0], pt, sl)
    o, m, l = pdk._paged_decode_cuda(*args)
    po, pm, pl = pdk.paged_decode_state_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_numpy(o), to_numpy(po), rtol=2.0 ** -7,
                               atol=1e-3)
    np.testing.assert_allclose(to_numpy(m), to_numpy(pm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_numpy(l), to_numpy(pl), rtol=1e-4)
    idle = np.asarray(seq_lens) == 0
    assert (to_numpy(o)[idle] == 0).all() and (to_numpy(l)[idle] == 0).all()
    assert (to_numpy(m)[idle] == -1e30).all()


@pytest.mark.parametrize("heads,page,tq,starts,seq_lens", [
    ((14, 2, 128), 128, 20, [280, 130, 0, 20], [300, 150, 0, 35]),
    ((14, 2, 128), 128, 37, [0, 100, 0, 3], [37, 137, 0, 30]),
    ((4, 2, 64), 16, 29, [16, 4, 0, 40], [45, 24, 0, 60]),
    ((16, 16, 128), 128, 100, [0, 30, 0, 200], [100, 130, 0, 250]),
    ((28, 4, 128), 16, 512, [0, 30, 0, 500], [512, 542, 0, 1000])])
def test_paged_prefill(heads, page, tq, starts, seq_lens):
    """g = 7 with Dh = 128, g = 2 with Dh = 64 and g = 1 with Dh = 128
    (Qwen1.5-MoE's 16/16 heads); pages of 16 under a 64-key tile; a Tq
    512 chunk whose starts (30, 500) put the diagonal inside key tiles;
    ragged per-row starts, an idle row, rows padded past their length, Tq
    not a multiple of the kernel's query tile. Bar: 1 bf16 ulp + 2e-3 on
    every query at a position < seq; idle rows exactly 0."""
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


# -- the kernels at the tensor-parallel engine's shapes -----------------------
# Qwen2.5-7B at tp 2 (parallel/tp_engine.py), a rank's sites with identity
# ARC 0.125: (N, K, select); the column sites keep the global selection,
# the row sites re-balance it to (KE / 2) // 64 * 64.
TP2_SITES = {"qkv": (2304, 3584, 448), "o": (3584, 1792, 192),
             "gateup": (18944, 3584, 448), "down": (3584, 9472, 1152)}


@pytest.mark.parametrize("site", list(TP2_SITES))
@pytest.mark.parametrize("m", [4, 4096])
def test_gemm_w8_at_tp2_shards(site, m):
    """#2 at a tp-2 rank's four sites, decode (the small-M tile) and
    prefill (the large-M tile) rows, against its plain version."""
    require_cuda()
    n, k, select = TP2_SITES[site]
    rng = np.random.default_rng(m + n + k)
    w = _bf16(outlier_x(rng, n, k) * 0.05)
    ridx = torch.from_numpy(rng.permutation(k)).cuda()
    pw = packing.pack_weight_arc(w, ridx, select, w_scale="channel")
    xa, gx = qk.quantize_x_arc(_bf16(outlier_x(rng, m, k)), ridx, select,
                               kq=pw.kq)
    gs, gw = gx.reshape(-1, 1), pw.global_scale.reshape(1, -1)
    for dt in (torch.float32, torch.bfloat16):
        y = gk._gemm_w8_cuda(xa, pw.codes, pw.scales, gs, gw, None, dt)
        ref = gk.gemm_w8_plain(xa, pw.codes, pw.scales, gs, gw, None, dt)
        torch.cuda.synchronize()
        assert_summation_order_close(y, ref, dt == torch.float32)


@pytest.mark.parametrize("site", ["o", "gateup"])
def test_dequant_w8_at_tp2_shards(site):
    """#6 at the tp-2 sites whose prefill takes the large-M route (N >=
    Kq), bit for bit its plain version."""
    require_cuda()
    n, k, select = TP2_SITES[site]
    rng = np.random.default_rng(n)
    w = _bf16(outlier_x(rng, n, k) * k ** -0.5)
    pw = packing.pack_weight_arc(w, torch.from_numpy(rng.permutation(k))
                                 .cuda(), select, w_scale="channel")
    assert n >= pw.kq
    gw = pw.global_scale.reshape(-1)
    assert_bitwise([gk._dequant_w8_cuda(pw.codes, pw.scales, gw)],
                   [gk.dequant_w8_plain(pw.codes, pw.scales, gw)])


def _tp2_pool(rng, seq_lens, page=128):
    """A rank's pool at Qwen2.5-7B tp 2 (2 kv heads of 128) with rows of
    seq_lens tokens on pages of `page`."""
    cfg = get_model_config("test-tiny").replace(
        num_heads=14, num_kv_heads=2, head_dim=128, num_layers=1)
    bsz, pps = len(seq_lens), -(-max(seq_lens) // page)
    cache = paged.init_cache(cfg, 1 + bsz * pps, page, "cuda")
    pt = (1 + torch.arange(bsz)[:, None] * pps
          + torch.arange(pps)[None]).to(torch.int32).cuda()
    t = pps * page
    kv = [_bf16(rng.standard_normal((bsz, t, 2, 128))) for _ in range(2)]
    pos = torch.arange(t)[None].expand(bsz, t).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    paged.append_kv(cache, 0, kv[0], kv[1], pt,
                    torch.where(pos < sl[:, None], pos, -1))
    return cache, pt, sl


def test_paged_kernels_at_tp2_heads():
    """#10 and #11 at a tp-2 rank's 14 query and 2 kv heads on pages of
    128: decode at the [tp] smoke's lengths after 32 tokens (its split
    plan at 2 kv heads), and a 512-token prefill chunk at ragged starts,
    each against its plain version."""
    require_cuda()
    rng = np.random.default_rng(14)
    cache, pt, sl = _tp2_pool(rng, [1056, 809, 333, 96])
    assert pdk.decode_split_plan(4, 2, pt.shape[1])[0] > 1
    q = _bf16(rng.standard_normal((4, 14, 128)) * 2)
    args = (q, cache.codes[0], cache.params[0], pt, sl)
    o, m, l = pdk._paged_decode_cuda(*args)
    po, pm, pl = pdk.paged_decode_state_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_numpy(o), to_numpy(po), rtol=2.0 ** -7,
                               atol=1e-3)
    np.testing.assert_allclose(to_numpy(l), to_numpy(pl), rtol=1e-4)
    st = torch.tensor([512, 297, 0, 0], dtype=torch.int32, device="cuda")
    q = _bf16(rng.standard_normal((4, 512, 14, 128)) * 2)
    args = (q, cache.codes[0], cache.params[0], pt, st, sl)
    o = pdk._paged_prefill_cuda(*args)
    po = pdk.paged_prefill_plain(*args)
    torch.cuda.synchronize()
    live = to_numpy(st[:, None] + torch.arange(512, device="cuda")[None]
                    < sl[:, None])
    np.testing.assert_allclose(to_numpy(o)[live], to_numpy(po)[live],
                               rtol=2.0 ** -7, atol=2e-3)


# -- the kernels under data, pipeline and sequence parallelism ---------------

def test_actq_and_gemm_w8_at_a_dp_groups_rows():
    """#1 and #2 at M 4 on one dp group's rows (slots 4-7 of an 8-slot
    batch at dp 2, a view into the batch), at a tp-2 rank's qkv site
    (K 3584, select 448): actq in each mode bitwise its plain version
    (rmsnorm: its kernel-order emulation), and the GEMM on the group's
    quantized rows within the summation-order bound, each row's result
    the same as in the whole batch's."""
    require_cuda()
    n, k, select = TP2_SITES["qkv"]
    rng = np.random.default_rng(8)
    for mode in ("plain", "rmsnorm", "silu_mul"):
        a, w = _actq_input(rng, 8, k, mode)
        rows = a[4:]
        args = dict(mode=mode, k=k, kq=packing.pad_kq(k, select), eps=1e-6)
        xa, gx = qk._actq_cuda(rows, w, **args)
        pa, pg = (qk.actq_kernel_order if mode == "rmsnorm"
                  else qk.actq_plain)(rows, w, **args)
        whole, _ = qk._actq_cuda(a, w, **args)
        torch.cuda.synchronize()
        assert torch.equal(xa, pa) and torch.equal(gx, pg), mode
        assert torch.equal(xa, whole[4:]), mode
    w = _bf16(outlier_x(rng, n, k) * 0.05)
    ridx = torch.from_numpy(rng.permutation(k)).cuda()
    pw = packing.pack_weight_arc(w, ridx, select, w_scale="channel")
    x8 = _bf16(outlier_x(rng, 8, k))
    xa, gx = qk.quantize_x_arc(x8[4:], ridx, select, kq=pw.kq)
    gs, gw = gx.reshape(-1, 1), pw.global_scale.reshape(1, -1)
    for dt in (torch.float32, torch.bfloat16):
        y = gk._gemm_w8_cuda(xa, pw.codes, pw.scales, gs, gw, None, dt)
        ref = gk.gemm_w8_plain(xa, pw.codes, pw.scales, gs, gw, None, dt)
        torch.cuda.synchronize()
        assert_summation_order_close(y, ref, dt == torch.float32)


def test_paged_decode_state_on_partial_pools():
    """#10's state form on the pools of a sequence-parallel decode at
    Qwen2.5-7B's attention shapes (28/4 heads, head_dim 128, pages of
    128): the rows' tokens split by range over two shards, rows with no
    token on one shard. Each shard's (out, m, l) against its plain
    version (an empty row: out 0, m -1e30, l 0), and the two states
    merged (merge_decode_states, sp_paged_decode's rule) against the
    kernel over the whole pool."""
    require_cuda()
    cfg = get_model_config("test-tiny").replace(
        num_heads=28, num_kv_heads=4, head_dim=128, num_layers=1)
    rng = np.random.default_rng(19)
    lens, bound, page = [2048, 1500, 700, 64], 1024, 128
    b, tmax = len(lens), max(lens)
    k = _bf16(rng.standard_normal((b, tmax, 4, 128)) * 2)
    v = _bf16(rng.standard_normal((b, tmax, 4, 128)))
    q = _bf16(rng.standard_normal((b, 28, 128)) * 2)
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def pool(off, n, rows_lens):
        pps = n // page
        cache = paged.init_cache(cfg, 1 + b * pps, page, "cuda")
        pt = (1 + torch.arange(b)[:, None] * pps
              + torch.arange(pps)[None]).to(torch.int32).cuda()
        pos = torch.arange(n, device="cuda")[None].expand(b, n)
        paged.append_kv(cache, 0, k[:, off:off + n], v[:, off:off + n], pt,
                        torch.where(pos < rows_lens[:, None], pos, -1))
        return (q, cache.codes[0], cache.params[0], pt, rows_lens)

    states = []
    for lo in (0, bound):
        local = (sl - lo).clamp(0, bound).to(torch.int32)
        args = pool(lo, bound, local)
        o, m, l = pdk._paged_decode_cuda(*args)
        po, pm, pl = pdk.paged_decode_state_plain(*args)
        torch.cuda.synchronize()
        live = to_numpy(local) > 0
        assert live.all() != bool(lo)     # the second shard has empty rows
        np.testing.assert_allclose(to_numpy(o)[live], to_numpy(po)[live],
                                   rtol=2.0 ** -7, atol=1e-3)
        np.testing.assert_allclose(to_numpy(m), to_numpy(pm), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(to_numpy(l), to_numpy(pl), rtol=1e-4)
        assert (to_numpy(o)[~live] == 0).all()
        assert (to_numpy(m)[~live] == -1e30).all()
        assert (to_numpy(l)[~live] == 0).all()
        states.append((o, m, l))
    merged, _, _ = pdk.merge_decode_states(*zip(*states))
    whole = pdk._paged_decode_cuda(*pool(0, tmax, sl))[0]
    np.testing.assert_allclose(to_numpy(merged), to_numpy(whole),
                               rtol=2.0 ** -7, atol=2e-3)


def test_gemm_batched_at_the_pp_moe_stage():
    """#15 at a pipeline stage's MoE layer (Qwen1.5-MoE-A2.7B at full
    width, packed w8 experts, ARC 0.125, the stage's 4 decode rows): the
    dense-mode expert FFN with the batched kernel bitwise the same FFN
    with one gemm_w8 launch an expert (gemm_batched_chain), one launch a
    call."""
    require_cuda()
    cfg = get_model_config("qwen1.5-moe-a2.7b").replace(num_layers=1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    lp = llama.init_layer_params(cfg, gen, torch.bfloat16, "cuda")
    calib = quantized.identity_calib(cfg, 0.125, device="cuda")[0]
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel")
    from arcquant_tpu_torch.models import moe
    p = moe.quantize_moe_params_packed(lp["moe"], calib, qcfg)
    del lp
    x = torch.randn((4, cfg.hidden_size), generator=gen,
                    device="cuda").to(torch.bfloat16)
    cw = moe.route(cfg, p["router"]["w"], x)
    xa, gx = quantized._act_quantize(x, calib["mlp_in"], qcfg)
    n0 = gk.GEMM_BATCHED.launches
    y = moe._ffn_dense_packed(p, xa, gx, cw, calib["down_in"], qcfg)
    assert gk.GEMM_BATCHED.launches == n0 + 1
    real = gk._gemm_batched_cuda
    gk._gemm_batched_cuda = gk.gemm_batched_chain
    try:
        ref = moe._ffn_dense_packed(p, xa, gx, cw, calib["down_in"], qcfg)
    finally:
        gk._gemm_batched_cuda = real
    torch.cuda.synchronize()
    assert_bitwise([y], [ref])


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


@pytest.mark.parametrize("m", [4, 16])
def test_megakernels_plain_loads(m):
    """An N that is not a multiple of 16: the fused GEMMs load their
    stages with plain loads, which read the activations other blocks of
    the launch wrote (phase A's xa, phase C2's xa2) through L2. Still bit
    for bit the chain: gemm_actq (rmsnorm) at N 1000, and mlp_w8
    (quantized mode) whose down GEMM writes D 1000 columns."""
    require_cuda()
    rng = np.random.default_rng(95 + m)
    d, n = 1024, 1000
    w = _bf16(outlier_x(rng, n, d) * d ** -0.5)
    b = _bf16(rng.standard_normal(n) * 0.1)
    pw = packing.pack_weight_arc(w, torch.arange(d).cuda(), 0, bias=b,
                                 w_scale="channel")
    x = _bf16(outlier_x(rng, m, d, scale=4.0))
    nw = _bf16(rng.standard_normal(d) * 0.1 + 1)
    args = (x, pw, d, torch.bfloat16, nw, 1e-6)
    got = mf._gemm_actq_cuda(*args)
    want = mf.gemm_actq_chain(*args)
    torch.cuda.synchronize()
    assert_bitwise(got, want)
    d2, f = 1000, 1024
    pw_gu, pw_dn = _w8_pair(rng, d2, f, bias=True)
    x2 = np.zeros((m, 1008), np.float32)    # the quantizer takes 16-groups
    x2[:, :d2] = outlier_x(rng, m, d2)
    xa1, gs1 = qk.quantize_x_arc(_bf16(x2), torch.arange(1008).cuda(), 0,
                                 kq=pw_gu.kq)
    args = (xa1, gs1, pw_gu, pw_dn, f, torch.bfloat16, None, 0.0)
    got = mf._mlp_w8_cuda(*args)
    want = mf.mlp_w8_chain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (m, d2)
    assert_bitwise(got, want)


@pytest.mark.parametrize("m", [4, 8, 16])
def test_megakernels_phase_a_spread(m, monkeypatch):
    """Phase A over the grid at Qwen2.5-7B's hidden width (D 3584): the
    wrapper's plan, one block, one a row and the whole grid all give
    gemm_actq (rmsnorm and plain) and mlp_w8 (norm mode) bit for bit
    their chain."""
    require_cuda()
    rng = np.random.default_rng(110 + m)
    d, n, f = 3584, 1200, 1024
    w = _bf16(outlier_x(rng, n, d) * d ** -0.5)
    pw = packing.pack_weight_arc(w, torch.arange(d).cuda(), 0,
                                 w_scale="channel")
    pw_gu, pw_dn = _w8_pair(rng, d, f, bias=False)
    x = _bf16(outlier_x(rng, m, d, scale=4.0))
    nw = _bf16(rng.standard_normal(d) * 0.1 + 1)
    for blocks in (None, 1, m, 396):
        if blocks is not None:
            monkeypatch.setattr(mf, "phase_a_blocks",
                                lambda m_, d_, mode_, b=blocks: b)
        for norm_w in (nw, None):
            args = (x, pw, d, torch.bfloat16, norm_w, 1e-6)
            got = mf._gemm_actq_cuda(*args)
            want = mf.gemm_actq_chain(*args)
            torch.cuda.synchronize()
            assert_bitwise(got, want)
        args = (x, None, pw_gu, pw_dn, f, torch.bfloat16, nw, 1e-6)
        got = mf._mlp_w8_cuda(*args)
        want = mf.mlp_w8_chain(*args)
        torch.cuda.synchronize()
        assert_bitwise(got, want)


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

def _pair(rng, n, k, select, bias, pad_multiple=packing.K_PAD_MULTIPLE):
    """The same weight packed in w8 and in w4."""
    w = _bf16(outlier_x(rng, n, k) * k ** -0.5)
    ridx = torch.from_numpy(rng.permutation(k)).cuda()
    b = _bf16(rng.standard_normal(n) * 0.1) if bias else None
    return [packing.pack_weight_arc(w, ridx, select, bias=b, fmt=f,
                                    w_scale="channel",
                                    pad_multiple=pad_multiple)
            for f in ("w8", "w4")]


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


@pytest.mark.parametrize("m,n,k,select",
                         [(m, n, 960, 64) for m, n in
                          [(4, 4608), (5, 200), (70, 1040), (130, 384),
                           (1000, 200)]]
                         + [(m, n, K_DOWN, SEL_DOWN) for m, n in LARGE_M]
                         + SMALL_M)
@pytest.mark.parametrize("bias", [False, True])
def test_gemm_w4_bitwise_equals_w8(m, n, k, select, bias):
    """gemm_w4 on a w4 pack gives gemm_w8's bits on a w8 pack of the same
    weight (32-row tile with split-K, the large-M tile up to M 4096 at
    down's Kq, ragged N), bf16 and f32 outputs; and holds the w8 GEMM's
    sum-order bound of the plain version."""
    require_cuda()
    rng = np.random.default_rng(110 + m)
    p8, p4 = _pair(rng, n, k, select, bias, _pad_multiple(k, select))
    xa, gx = qk.quantize_x_arc(_bf16(outlier_x(rng, m, k)),
                               torch.arange(k).cuda(), select, kq=p8.kq)
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
@pytest.mark.parametrize("m,k,n", [(4, 4096, 4608), (600, 4096, 4608)]
                         + [(m, KQ_DOWN, 21520)
                            for m in (65, 128, 1000, 4096)])
def test_gemm_and_route_accumulate_in_f32(fmt, m, k, n, monkeypatch):
    """bf16 activations (W4A16 operands, unit scale) over K 4096 and
    down's Kq 21504 (N 21520 >= Kq, so the route engages, not a multiple of
    the 128-column tile): the GEMM kernel of the format (route off) and
    the large-M route (dequant kernel, pin for w4, torch.mm to f32) each
    within 2x the plain f32 version's mean relative error against f64."""
    require_cuda()
    rng = np.random.default_rng(120 + m)
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
                                 (60, 4), (60, 256), (4, 65), (4, 128),
                                 (4, 1000), (4, 4096),
                                 (60, 16), (60, 17), (60, 33), (60, 64),
                                 (4, 16), (4, 17), (4, 33), (4, 64)])
def test_gemm_batched_bitwise_equals_per_expert_gemm(e, m):
    """gemm_batched (one launch over the experts) gives each expert the
    bits of a gemm_w8 / gemm_w4 launch on that expert (the per-expert
    chain), in both formats and output types, per-row scales; and holds
    the sum-order bound of its plain version. Qwen1.5-MoE's down shape:
    K 1408 with 192 ARC columns (Kq 2048), N 2048 (E 4: N 520, neither a
    multiple of the 128-column tile nor of 16, so the small-M mainloop
    loads its stages with plain loads); M <= 64 run the small-M mainloop
    at its three tile heights (M 1-16, 17-32, 33-64), M 65-4096 the
    large-M tile, M 1000 with a ragged m tile. The activations are bf16,
    not quantized, so that a changed k order shows in the bits."""
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


# -- the decode step as a CUDA graph -------------------------------------------

_QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
            act_scale="row", w_scale="channel", quantize_lm_head=True)
# name: (model, select_frac, QuantConfig, fused_decode); every decode
# configuration the engine serves on the card, 2 layers at full width
GRAPH_CONFIGS = {
    "w8-arc": ("qwen2.5-7b", 0.125, _QKW, True),
    "select-free-fused": ("qwen2.5-7b", 0.0, _QKW, True),
    "select-free-chain": ("qwen2.5-7b", 0.0, _QKW, False),
    "w4-arc": ("qwen2.5-7b", 0.125, dict(_QKW, weight_fmt="w4"), True),
    "moe-dense": ("qwen1.5-moe-a2.7b", 0.125, _QKW, True),
    "bf16": ("qwen2.5-7b", 0.0, dict(quant_type="BF16"), True),
    "bf16-packed-head": ("qwen2.5-7b", 0.0, dict(quant_type="BF16"), True),
    # per-tensor activation scales: a scalar scale on the device through
    # the unfused chain (select-free, where row scales take the
    # megakernels)
    "w8-tensor": ("qwen2.5-7b", 0.0, dict(_QKW, act_scale="tensor"), True),
    "moe-tensor": ("qwen1.5-moe-a2.7b", 0.125,
                   dict(_QKW, act_scale="tensor"), True),
    # the fake-format engine (qdq stacks, no packed kernel) and BF16 on MoE
    "moe-fake": ("qwen1.5-moe-a2.7b", 0.125,
                 dict(quant_type="NVFP4", use_kernels=False, act_scale="row",
                      w_scale="channel"), True),
    "moe-bf16": ("qwen1.5-moe-a2.7b", 0.0, dict(quant_type="BF16"), True),
}
# configs whose head stays bf16
_BF16_HEAD = ("bf16", "moe-fake", "moe-bf16")
_GRAPH_LENS = (100, 77, 31, 0)     # slot 3 inactive


def _graph_pair(config):
    """(graph engine, loop engine) on the same weights: 2 layers at the
    model's width, dummy weights from seed 5, batch 4."""
    model, sel, qkw, fused = GRAPH_CONFIGS[config]
    cfg = get_model_config(model).replace(num_layers=2)
    calib = quantized.identity_calib(cfg, sel, device="cuda")
    qcfg = QuantConfig(**qkw)
    ecfg = EngineConfig(max_batch=4, max_seq_len=256)
    eng = InferenceEngine.dummy(cfg, calib, qcfg, ecfg, seed=5,
                                device="cuda", fused_decode=fused)
    qparams = eng.qparams
    if config == "bf16-packed-head":
        qparams = dict(qparams, lm_head_packed=engine_mod.pack_lm_head(
            qparams["embed"], QuantConfig(**_QKW)))
        eng = InferenceEngine(cfg, qparams, calib, qcfg, ecfg, device="cuda",
                              quantize_params=False)
    loop = InferenceEngine(cfg, qparams, calib, qcfg, ecfg, device="cuda",
                           quantize_params=False, fused_decode=fused,
                           cuda_graphs=False)
    return eng, loop


def _graph_prompts(cfg):
    rng = np.random.default_rng(6)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in _GRAPH_LENS]


def _prefill(eng, prompts):
    toks, lens, _ = eng._pad_prompts(prompts)
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    return logits, state, torch.as_tensor(lens > 0, device="cuda")


@pytest.mark.parametrize("config", list(GRAPH_CONFIGS))
def test_decode_graph_bitwise_equals_loop(config):
    """decode_step replaying the captured step gives the loop's logits
    bit for bit at every step (fed the loop's greedy tokens) and its
    seq_lens; decode_scan's tokens (an eos id hit mid-run, an inactive
    slot) equal the loop's; the step was captured, not run eagerly."""
    require_cuda()
    eng, loop = _graph_pair(config)
    assert ("lm_head_packed" in eng.qparams) != (config in _BF16_HEAD)
    prompts = _graph_prompts(eng.cfg)
    (lg, sg, active), (ll, sl, _) = (_prefill(e, prompts) for e in (eng, loop))
    assert _bits(lg).equal(_bits(ll))
    for _ in range(8):
        cur = ll.argmax(-1).to(torch.int32)
        lg, sg = eng.decode_step(sg, cur, active)
        ll, sl = loop.decode_step(sl, cur, active)
        assert torch.equal(_bits(lg), _bits(ll))
    assert torch.equal(sg[2], sl[2])
    assert len(eng.graph_captures) == 1 and not loop.graph_captures
    assert eng.graph_captures[0]["launches"] > 0 or config.startswith("bf16")
    if config in ("moe-fake", "moe-bf16"):
        # attention only: the linears are library products
        assert eng.graph_captures[0]["launches"] == 2

    def scan(e, eos_id):
        logits, state, active = _prefill(e, prompts)
        first = logits.argmax(-1).to(torch.int32)
        out, state = e.decode_scan(state, first, active, 6, eos_id=eos_id)
        return out, state[2].clone()
    eos = int(scan(loop, None)[0][0, 2])
    (gout, glens), (lout, llens) = scan(eng, eos), scan(loop, eos)
    assert torch.equal(gout, lout) and torch.equal(glens, llens)
    assert int(gout[0, 5]) == eos and int(glens[3]) == 0


def test_tensor_scale_decode_launches_no_megakernel_or_actq():
    """At act_scale "tensor" the select-free decode, which at row scales
    runs the megakernels, takes the unfused chain with the plain tensor
    quantize: over a decode_scan replayed from the graph, #1 and #12-#14
    launch 0 times and the GEMM and paged decode once a site a step; the
    scan makes no host synchronisation."""
    require_cuda()
    eng, _ = _graph_pair("w8-tensor")
    logits, state, active = _prefill(eng, _graph_prompts(eng.cfg))
    first = logits.argmax(-1).to(torch.int32)
    eng.decode_scan(state, first, active, 0)
    torch.cuda.synchronize()
    for k in _build.KERNELS:
        k.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.decode_scan(state, first, active, 5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _build.KERNELS}
    assert counts["actq"] == counts["mlp_w8"] == counts["gemm_actq"] == 0
    assert counts["gu_actq"] == 0
    # qkv, o, gateup, down a layer and the head, a step
    assert counts["gemm_w8"] == 5 * (4 * 2 + 1)
    assert counts["paged_decode"] == 5 * 2


def _perturbed(y, gen):
    """y (f32) times (1 + 2^-22 N(0, 1)): another f32 summation order."""
    return y * (1 + 2.0 ** -22 * torch.randn(y.shape, generator=gen,
                                             device=y.device))


@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("scale", ["tensor", "row"])
def test_moe_block_qdq_stacks_match_packed(fmt, scale):
    """moe_block at Qwen1.5-MoE-A2.7B width, 1 layer, ARC 0.125, 16
    tokens: on the qdq stacks (use_kernels=False: the fake activation qdq
    and the bf16 products) against the packed experts (actq, gemm_w8 or
    gemm_w4 and gemm_batched in dense mode; the decoded stacks in dispatch
    mode, DENSE_MODE_MAX_T 0, capacity 16), the same router on the same
    input in both. Bar: cosine >= the qdq block against itself with its
    f32 products times (1 + 2^-22 N(0, 1)), lowest of two draws, at most
    0.999 (the JAX package's tests/test_moe.py::test_packed_moe_matches_qdq
    on the card)."""
    require_cuda()
    from arcquant_tpu_torch.models import moe
    cfg = get_model_config("qwen1.5-moe-a2.7b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    raw = moe.init_moe_params(cfg, gen, device="cuda")
    calib = quantized.identity_calib(cfg.replace(num_layers=1), 0.125,
                                     device="cuda")[0]
    x = torch.randn((1, 16, cfg.hidden_size), generator=gen,
                    device="cuda").to(torch.bfloat16)
    q_fake = QuantConfig(use_kernels=False, w_scale="channel",
                         act_scale=scale)
    q_pk = QuantConfig(weight_fmt=fmt, w_scale="channel", act_scale=scale)
    stacks = moe.quantize_moe_params(raw, calib, q_fake)
    packed = moe.quantize_moe_params_packed(raw, calib, q_pk)
    real_mm, saved = gk.matmul_f32, moe.DENSE_MODE_MAX_T
    for dense in (True, False):
        moe.DENSE_MODE_MAX_T = saved if dense else 0
        try:
            cap = None if dense else 16
            y_p = moe.moe_block(cfg, packed, x, calib, q_pk, capacity=cap)
            y_q = moe.moe_block(cfg, stacks, x, calib, q_fake, capacity=cap)
            floors = []
            for seed in range(2):
                g = torch.Generator(device="cuda")
                g.manual_seed(seed)
                gk.matmul_f32 = (lambda a, b, g=g: _perturbed(real_mm(a, b),
                                                              g))
                floors.append(cosine(to_numpy(y_q), to_numpy(
                    moe.moe_block(cfg, stacks, x, calib, q_fake,
                                  capacity=cap))))
        finally:
            gk.matmul_f32, moe.DENSE_MODE_MAX_T = real_mm, saved
        c = cosine(to_numpy(y_p), to_numpy(y_q))
        assert torch.isfinite(y_p).all() and y_p.shape == x.shape
        assert c >= min([0.999] + floors), (dense, c, floors)


def test_sampled_decode_scan_graph_bitwise_equals_loop():
    """A sampled decode_scan (top-k and top-p, the generator registered
    with the graph): the loop's tokens for the same seed, over two
    calls; another seed gives others."""
    require_cuda()
    eng, loop = _graph_pair("select-free-fused")
    prompts = _graph_prompts(eng.cfg)
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.9)

    def scan(e, seed):
        logits, state, active = _prefill(e, prompts)
        first = logits.argmax(-1).to(torch.int32)
        return e.decode_scan(state, first, active, 6, sampling=sp,
                             seed=seed)[0]
    for seed in (1, 1, 2):
        assert torch.equal(scan(eng, seed), scan(loop, seed))
    assert not torch.equal(scan(eng, 1), scan(eng, 2))


def test_decode_graph_on_a_second_state():
    """A second state alive beside the first gets its own graph; both,
    and the first again after it, decode as the loop does."""
    require_cuda()
    eng, loop = _graph_pair("w8-arc")
    prompts = _graph_prompts(eng.cfg)
    runs = {}
    for name in ("a", "b", "a2"):
        for e in (eng, loop):
            logits, state, active = _prefill(e, prompts)
            first = logits.argmax(-1).to(torch.int32)
            runs[name, e is eng] = (state, first, active)
    for name in ("a", "b", "a2"):
        for graph in (True, False):
            state, first, active = runs[name, graph]
            e = eng if graph else loop
            out, _ = e.decode_scan(state, first, active, 4)
            runs[name, graph] = out
        assert torch.equal(runs[name, True], runs[name, False])
    assert len(eng.graph_captures) == 3


def test_decode_graph_launch_counts_equal_loop():
    """Kernel.launches and by_m over a decode_scan replayed from the
    graph equal the loop's over the same run."""
    require_cuda()
    eng, loop = _graph_pair("select-free-fused")
    prompts = _graph_prompts(eng.cfg)
    counts = []
    for e in (eng, loop):
        logits, state, active = _prefill(e, prompts)
        first = logits.argmax(-1).to(torch.int32)
        e.decode_scan(state, first, active, 0)         # the capture
        for k in _build.KERNELS:
            k.reset()
        e.decode_scan(state, first, active, 5)
        torch.cuda.synchronize()
        counts.append({k.name: (k.launches, dict(k.by_m))
                       for k in _build.KERNELS})
    assert counts[0] == counts[1]
    assert counts[0]["mlp_w8"][0] == 5 * 2 and counts[0]["gemm_actq"][0] == 20


def test_decode_scan_makes_no_host_sync():
    """decode_scan on device inputs, its graph captured, runs under
    torch.cuda.set_sync_debug_mode("error")."""
    require_cuda()
    eng, _ = _graph_pair("w8-arc")
    logits, state, active = _prefill(eng, _graph_prompts(eng.cfg))
    first = logits.argmax(-1).to(torch.int32)
    eng.decode_scan(state, first, active, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, state = eng.decode_scan(state, first, active, 5,
                                     eos_id=int(eng.cfg.vocab_size - 1))
        out2, state = eng.decode_scan(state, out[:, -1], active, 3,
                                      sampling=SamplingParams(0.9, 20),
                                      seed=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == (4, 5) and out2.shape == (4, 3)


def test_decode_graph_capture_failure_raises(monkeypatch):
    """A host read inside the step fails its capture: decode_step raises
    naming the line of the op, and does not fall back to the eager
    loop."""
    require_cuda()
    eng, _ = _graph_pair("w8-arc")
    logits, state, active = _prefill(eng, _graph_prompts(eng.cfg))
    real = llama.rope_cos_sin

    def reads_back(cfg, positions, inv_freq=None):
        int(positions.max())
        return real(cfg, positions, inv_freq)
    monkeypatch.setattr(llama, "rope_cos_sin", reads_back)
    with pytest.raises(RuntimeError, match=r"int\(positions.max\(\)\)"):
        eng.decode_step(state, logits.argmax(-1).to(torch.int32), active)
    assert not eng._graphs


# -- speculative decoding: the verify step and the round as CUDA graphs -------

SPEC_CONFIGS = ("w8-arc", "select-free-fused", "w4-arc", "moe-dense")


def _halves_prompts(cfg, n=96):
    """Prompts whose second half repeats the first (n-gram drafts match),
    one slot idle."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(3):
        half = rng.integers(0, cfg.vocab_size, n // 2).tolist()
        out.append(half + half)
    return out


@pytest.mark.parametrize("config", SPEC_CONFIGS)
def test_verify_graph_bitwise_equals_eager(config):
    """verify_step replaying its captured graph gives the eager
    verify_step's logits bit for bit at W 2, 4 and 8 (M up to 32), with
    ragged valid (a row of 1, an idle slot of 0), and seq_lens unchanged;
    one capture per W."""
    require_cuda()
    eng, loop = _graph_pair(config)
    prompts = _graph_prompts(eng.cfg)
    (_, sg, _), (_, sl, _) = (_prefill(e, prompts) for e in (eng, loop))
    lens0 = sl[2].clone()
    rng = np.random.default_rng(8)
    for w in (2, 4, 8):
        toks = torch.as_tensor(rng.integers(0, eng.cfg.vocab_size, (4, w)),
                               dtype=torch.int32, device="cuda")
        valid = torch.tensor([w, 1, w, 0], dtype=torch.int32, device="cuda")
        lg, sg = eng.verify_step(sg, toks, valid)
        ll, sl = loop.verify_step(sl, toks, valid)
        assert torch.equal(_bits(lg), _bits(ll)), w
        assert torch.isfinite(lg[:3]).all()
    assert torch.equal(sg[2], lens0) and torch.equal(sl[2], lens0)
    assert [c["what"] for c in eng.graph_captures] == ["verify step"] * 3


@pytest.mark.parametrize("config,sampled", [
    ("w8-arc", False), ("select-free-fused", False), ("w8-arc", True),
    ("w4-arc", False), ("moe-dense", False)])
def test_spec_round_graph_bitwise_equals_loop(config, sampled):
    """generate_ondevice replaying the captured round (draft, verify,
    acceptance, commit, retirement) against the eager round loop on the
    same weights: tokens and stats equal, greedy with an eos id and
    sampled with a seed; drafts are accepted on the repeating prompts.
    Both calls run on the engine's one spec state: the round is
    captured once."""
    require_cuda()
    from arcquant_tpu_torch.engine import NgramDrafter, SpeculativeEngine
    eng, loop = _graph_pair(config)
    prompts = _halves_prompts(eng.cfg)
    sp = SamplingParams(0.8, top_k=50, top_p=0.9) if sampled else None
    runs = []
    for e in (eng, loop):
        spec = SpeculativeEngine(e, NgramDrafter(), window=4)
        first = spec.generate_ondevice(prompts, 24, sampling=sp, seed=3)
        eos = None if sampled else first[0][10]
        out = spec.generate_ondevice(prompts, 24, eos_id=eos, sampling=sp,
                                     seed=3)
        runs.append((first, out, dict(spec.stats)))
    assert runs[0] == runs[1]
    assert [c["what"] for c in eng.graph_captures].count("spec round") == 1
    if not sampled:
        assert len(runs[0][1][0]) < 24          # the eos retired row 0


@pytest.mark.parametrize("w", [2, 4, 8])
def test_paged_prefill_at_verify_shapes_captured(w):
    """The paged prefill kernel at Tq = W over a decode-sized pool (batch
    4, contexts 300/77/31/0 tokens), captured in a CUDA graph after one
    eager launch and replayed: equal to the eager launch bit for bit and
    within 1 bf16 ulp + 2e-3 of paged_prefill_plain on live queries."""
    require_cuda()
    cfg = get_model_config("qwen2.5-7b").replace(num_layers=1)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    page, bsz, pps = 128, 4, 3
    rng = np.random.default_rng(w)
    cache = paged.init_cache(cfg, 1 + bsz * pps, page, "cuda")
    pt = (1 + torch.arange(bsz)[:, None] * pps
          + torch.arange(pps)[None]).to(torch.int32).cuda()
    t = pps * page
    st = torch.tensor([300, 77, 31, 0], dtype=torch.int32, device="cuda")
    sl = st + torch.tensor([w, w, 1, 0], dtype=torch.int32, device="cuda")
    pos = torch.arange(t, device="cuda")[None].expand(bsz, t)
    paged.append_kv(cache, 0, _bf16(rng.standard_normal((bsz, t, hkv, dh))),
                    _bf16(rng.standard_normal((bsz, t, hkv, dh))), pt,
                    torch.where(pos < sl[:, None], pos, -1))
    q = _bf16(rng.standard_normal((bsz, w, hq, dh)) * 2)
    args = (q, cache.codes[0], cache.params[0], pt, st, sl)
    eager = pdk._paged_prefill_cuda(*args)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        o = pdk._paged_prefill_cuda(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(o, eager)
    po = pdk.paged_prefill_plain(*args)
    live = to_numpy(st[:, None] + torch.arange(w, device="cuda")[None]
                    < sl[:, None])
    np.testing.assert_allclose(to_numpy(o)[live], to_numpy(po)[live],
                               rtol=2.0 ** -7, atol=2e-3)
    assert (to_numpy(o)[3] == 0).all()


# -- the accuracy path: the unfused packed forward and eval_ppl ---------------

PLAIN_ENTRY_POINTS = (
    (qk, "_actq_cuda", qk.actq_plain), (gk, "_gemm_w8_cuda", gk.gemm_w8_plain),
    (gk, "_gemm_w4_cuda", gk.gemm_w4_plain),
    (gk, "_dequant_w8_cuda", gk.dequant_w8_plain),
    (gk, "_dequant_w4_cuda", gk.dequant_w4_plain),
    (gk, "_pin_rowmajor_cuda", gk.pin_rowmajor_plain),
    (attention, "_flash_cuda", attention.flash_attention_plain))


def _cos(a, b):
    a, b = to_numpy(a).astype(np.float64), to_numpy(b).astype(np.float64)
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("act_scale", ["row", "tensor"])
def test_packed_forward_layer_kernels_vs_plain(fmt, act_scale, monkeypatch):
    """One test-tiny layer of quant_model_forward on packed weights (the
    accuracy path's use_kernels route; B 2 x T 256, so gate/up take the
    large-M route) with the CUDA kernels against the same forward with
    their plain versions patched in. With every kernel but #9 (flash
    attention, whose outputs sit an ulp from its plain version's on a
    share of elements, enough to flip e2m1 codes downstream): logits
    cosine >= 0.99999 and equal argmax everywhere; with #9 too: cosine
    >= 0.999 and equal argmax at >= 99% of positions. Every kernel of the
    route launches."""
    require_cuda()
    cfg = get_model_config("test-tiny").replace(num_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen, device="cuda")
    calib = quantized.identity_calib(cfg, 0.125, device="cuda")
    qcfg = QuantConfig(use_kernels=True, weight_fmt=fmt, act_scale=act_scale)
    qparams = quantized.quantize_model_params(cfg, params, calib, qcfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256))).cuda()

    def forward():
        return quantized.quant_model_forward(cfg, qparams, calib, qcfg, toks)
    kernels = ([gk.GEMM_W8, gk.DEQUANT_W8] if fmt == "w8"
               else [gk.GEMM_W4, gk.DEQUANT_W4, gk.PIN_ROWMAJOR])
    kernels += [attention.FLASH] + ([qk.ACTQ] if act_scale == "row" else [])
    for k in kernels:
        k.reset()
    got = forward()
    torch.cuda.synchronize()
    assert all(k.launches > 0 for k in kernels), [
        (k.name, k.launches) for k in kernels]
    monkeypatch.setattr(attention, "_flash_cuda",
                        attention.flash_attention_plain)
    isolated = forward()
    for mod, name, plain in PLAIN_ENTRY_POINTS:
        monkeypatch.setattr(mod, name, plain)
    want = forward()
    assert _cos(isolated, want) >= 0.99999, _cos(isolated, want)
    np.testing.assert_array_equal(to_numpy(isolated).argmax(-1),
                                  to_numpy(want).argmax(-1))
    assert _cos(got, want) >= 0.999, _cos(got, want)
    assert (to_numpy(got).argmax(-1) == to_numpy(want).argmax(-1)).mean() \
        >= 0.99


@pytest.mark.parametrize("setting,rtol", [
    (dict(quant_type="BF16"), 1e-3), (dict(use_kernels=False), 1e-2),
    (dict(use_kernels=True, act_scale="row"), 1e-2)])
def test_eval_ppl_on_the_card_matches_the_cpu(setting, rtol):
    """eval_ppl of test-tiny (2 layers, 4 windows of 64 tokens) on the card
    against the same params and stream on the CPU: BF16, fake NVFP4 and
    packed NVFP4 with the kernels."""
    require_cuda()
    from arcquant_tpu_torch.evals import eval_ppl, synthetic_stream
    cfg = get_model_config("test-tiny")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    stream = synthetic_stream(cfg.vocab_size, 4 * 64, 0)
    qcfg = QuantConfig(**setting)
    out = []
    for device in ("cpu", "cuda"):
        p = {k: (v.to(device) if torch.is_tensor(v) else v)
             for k, v in params.items() if k != "layers"}
        p["layers"] = [{name: ({k: t.to(device) for k, t in v.items()}
                               if isinstance(v, dict) else v.to(device))
                        for name, v in layer.items()}
                       for layer in params["layers"]]
        calib = quantized.identity_calib(cfg, 0.125, device=device)
        if qcfg.quant_type != "BF16":
            p = quantized.quantize_model_params(cfg, p, calib, qcfg)
        out.append(eval_ppl(cfg, p, stream, 64, qcfg, calib, batch=2))
    assert np.isfinite(out[1]) and out[1] > 1
    np.testing.assert_allclose(out[1], out[0], rtol=rtol)


# -- calibration's shapes and a calibrated engine ------------------------------

def test_flash_attention_at_the_calibration_shape():
    """#9 at calibration's chunk: 4 samples x 2048 tokens (8192), Qwen2.5-7B's
    28/4 heads of 128, causal."""
    require_cuda()
    rng = np.random.default_rng(2048)
    q = _bf16(rng.standard_normal((4, 2048, 28, 128)) * 2)
    k = _bf16(rng.standard_normal((4, 2048, 4, 128)) * 2)
    v = _bf16(rng.standard_normal((4, 2048, 4, 128)))
    out = attention._flash_cuda(q, k, v)
    ref = attention.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_numpy(out), to_numpy(ref), rtol=2.0 ** -7,
                               atol=2e-3)


_STEP_PLAIN = PLAIN_ENTRY_POINTS + (
    (pdk, "_paged_decode_cuda", pdk.paged_decode_state_plain),
    (pdk, "_paged_prefill_cuda", pdk.paged_prefill_plain),
    (mf, "_gemm_actq_cuda", mf.gemm_actq_chain),
    (mf, "_gu_actq_cuda", mf.gu_actq_chain),
    (mf, "_mlp_w8_cuda", mf.mlp_w8_chain))


def test_decode_step_with_a_calibration_against_plain(monkeypatch):
    """One decode step of a 2-layer Qwen2.5-7B engine on a calibration of
    random channel permutations whose select counts differ by layer and
    site (layer 0 select-free, so its step runs the megakernels; layer 1
    with ARC columns at every site, so the chain and gu_actq), captured
    as a CUDA graph, against the plain step from the same state (both
    prefilled by the plain versions): logits at least as close to the
    plain step as the plain step is to itself with its GEMM outputs
    perturbed by 2^-22 N(0, 1) (the noise floor of the engine checks),
    and the fused and unfused kernels each launched."""
    require_cuda()
    cfg = get_model_config("qwen2.5-7b").replace(num_layers=2)
    rng = np.random.default_rng(8)
    widths = {"attn_in": cfg.hidden_size, "o_in": cfg.q_size,
              "mlp_in": cfg.hidden_size, "down_in": cfg.intermediate_size}
    selects = ({"attn_in": 0, "o_in": 0, "mlp_in": 0, "down_in": 0},
               {"attn_in": 128, "o_in": 64, "mlp_in": 192, "down_in": 256})
    calib = [{s: quantized.SiteCalib(torch.from_numpy(rng.permutation(
        k).astype(np.int32)).cuda(), sel[s]) for s, k in widths.items()}
        for sel in selects]
    eng = InferenceEngine.dummy(cfg, calib, QuantConfig(**_QKW),
                                EngineConfig(max_batch=4, max_seq_len=256),
                                seed=5, device="cuda")
    prompts = _graph_prompts(cfg)
    with monkeypatch.context() as m:
        for mod, name, plain in _STEP_PLAIN:
            m.setattr(mod, name, plain)
        (logits, s_kernel, active), (_, s_plain, _), (_, s_noisy, _) = (
            _prefill(eng, prompts) for _ in range(3))
    cur = logits.argmax(-1).to(torch.int32)
    launches = {k: k.launches for k in (mf.GEMM_ACTQ, mf.MLP_W8, mf.GU_ACTQ)}
    got, _ = eng.decode_step(s_kernel, cur, active)
    torch.cuda.synchronize()
    assert len(eng.graph_captures) == 1
    assert all(k.launches > n for k, n in launches.items()), [
        (k.name, k.launches - n) for k, n in launches.items()]
    eng.cuda_graphs = False
    with monkeypatch.context() as m:
        for mod, name, plain in _STEP_PLAIN:
            m.setattr(mod, name, plain)
        want, _ = eng.decode_step(s_plain, cur, active)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def noisy(xa, codes, scales, gs, gw, bias, out_dtype):
            y = gk.gemm_w8_plain(xa, codes, scales, gs, gw, bias,
                                 torch.float32)
            return (y * (1 + 2.0 ** -22 * torch.randn(
                y.shape, generator=gen, device=y.device))).to(out_dtype)
        m.setattr(gk, "_gemm_w8_cuda", noisy)
        floor, _ = eng.decode_step(s_noisy, cur, active)
    live = active.cpu().numpy()
    got, want, floor = (to_numpy(x)[live] for x in (got, want, floor))
    assert np.isfinite(got).all()
    assert cosine(got, want) >= cosine(floor, want), (cosine(got, want),
                                                      cosine(floor, want))
