"""The small-M GEMM tile's arithmetic (csrc/gemm_small_m.cuh), emulated in
plain torch on the CPU, where the kernel cannot run:

  - its weight decode, its integer steps run literally on Python ints
    and exhaustively against the plain decode: the scale's bf16 built
    from its bits, for all 256 ue4m3 bytes; w8's bytewise +64, bf16 pair
    192 + c and one bf16x2 FMA, (192 + c) s - 192 s, for every mag2 code
    the packer emits and every scale byte; w4's byte-permute lookup of a
    code byte's two e2m1x values and one bf16x2 multiply by the scale,
    for every code byte and every scale byte;
  - its k order (32-deep partials promoted in order into the f32 total,
    a split's k-tiles in order, the splits summed in order from 0.0) at
    kernels/gemm.py:_split_plan's plan, held against the JAX package's
    gemm_dequant at test_torch_gemm.py's tolerances; and run per expert
    at the single GEMM's plan, as gemm_batched runs it, against the JAX
    package's gemm_dequant_batched;
  - the plan itself: at every M <= 64 and each of Qwen2.5-7B's decode
    sites its splits cover the k-tiles [0, Kq/32) once each, in order;
  - the decode megakernels' item walk (csrc/mlp_fused.cu:gemm_phase): at
    every grid the cooperative launch can take, the blocks' items cover
    each (n-tile, split) of a decode site's GEMM exactly once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.kernels import gemm as jgemm
from arcquant_tpu.quant import packing as JP
from arcquant_tpu_torch.config import get_model_config
from arcquant_tpu_torch.convert import packed_from_numpy
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.quant import numerics as N
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import outlier_x, to_numpy, to_torch

from test_torch_gemm import _case, assert_summation_order_close

BK = 32  # the k-tile one promotion covers


def byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's __byte_perm (default mode): byte n of the result is byte
    (sel >> 4 n) & 7 of the 8-byte value y:x."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def bf16_bits(h: int) -> float:
    return float(torch.tensor(h, dtype=torch.int32).to(torch.int16)
                 .view(torch.bfloat16).float())


def bf16_pair(v: int):
    """The (low, high) bf16 values of a 32-bit word."""
    return bf16_bits(v & 0xFFFF), bf16_bits(v >> 16)


def ue4m3_pair(byte: int, d: int) -> float:
    """gemm_small_m.cuh's ue4m3_pair<D>: the bf16 of a scale byte times
    2^-D from its bits; e == 0 as e = 1 less 2^(-6 - D) (an exact bf16
    subtraction)."""
    em = byte & 0x7F
    sub = (em & 0x78) == 0
    lo, hi = bf16_pair(((((em | (8 if sub else 0)) << 4) + ((120 - d) << 7))
                        * 0x10001) & 0xFFFFFFFF)
    assert lo == hi
    return lo - bf16_bits((121 - d) << 7) if sub else lo


def e2m1x_pairs(q0: int, q1: int, i: int):
    """gemm_small_m.cuh's w4 decode of byte i of code rows q0 and q1: the
    bf16 pairs (k rows 2t, 2t + 1) and (2t + 8, 2t + 9), before the
    scale."""
    p = byte_perm(q0, q1, i | ((4 + i) << 4) | ((4 + i) << 8) | (i << 12))
    sel = p & 0x7777
    lo = byte_perm(0xC0800000, 0xC0804000, sel)
    hi = byte_perm(0x3F3F003F, 0x40404040, sel)
    x0 = byte_perm(lo, hi, 0x5140) | ((p << 12) & 0x8000) | (p & 0x80000000)
    x1 = (byte_perm(lo, hi, 0x7362) | ((p << 4) & 0x8000)
          | ((p << 8) & 0x80000000))
    return x0 & 0xFFFFFFFF, x1 & 0xFFFFFFFF


def _bytes_add64(v: int) -> int:
    """The w8 decode's +64 on each byte of a 32-bit word, without carries
    between bytes."""
    return (((v & 0x7F7F7F7F) + 0x40404040) ^ (v & 0x80808080)) & 0xFFFFFFFF


def _bf16_round(x: float) -> float:
    """x (exact in f32) rounded to bf16, to nearest even."""
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16)
                 .float())


SCALE_BYTES = range(256)
S_REF = N.ue4m3_from_bytes(torch.arange(256, dtype=torch.uint8)).tolist()


@pytest.mark.parametrize("d", [0, 1])
def test_scale_pair_equals_plain_decode(d):
    """Every scale byte: the bit-built bf16 equals the plain decode (times
    2^-D) exactly."""
    for byte in SCALE_BYTES:
        assert ue4m3_pair(byte, d) == S_REF[byte] * 2.0 ** -d, byte


def test_bytewise_add64_has_no_carries():
    """Every byte value at every position of a word, beside neighbours
    that would carry into it or from it."""
    for b in range(256):
        bs = [b, 255 - b, (b * 7 + 3) & 255, (b * 13 + 5) & 255]
        for shift in range(4):
            q = [bs[(n + shift) % 4] for n in range(4)]
            out = _bytes_add64(sum(x << (8 * n) for n, x in enumerate(q)))
            assert [(out >> (8 * n)) & 255 for n in range(4)] == \
                [(x + 64) & 255 for x in q]


def test_w8_fma_decode_equals_plain_decode():
    """For every mag2 code the packer emits, at every byte position of
    the two k rows' words, and every scale byte: the bytes permuted into
    the bf16 pair 192 + c, then (192 + c) s - 192 s with s = ue4m3 / 2 as
    one bf16x2 FMA (an exact f32 sum rounded once to bf16), equals the
    plain decode bf16(c s) and is exact (c s). A zero is compared as +0:
    the FMA gives +0 where c s is -0 (c < 0 at a zero scale), a zero
    product's sign that the zero-started sums absorb."""
    codes = torch.unique(packing.codes_to_mag2_i8(
        torch.arange(16, dtype=torch.uint8))).tolist()
    assert max(abs(c) for c in codes) < 64
    for c in codes:
        for c2 in (codes[0], codes[-1]):   # the other k row of the pair
            for i in range(4):
                w0 = _bytes_add64((c & 0xFF) << (8 * i) | 0x5A5A5A5A
                                  & ~(0xFF << (8 * i)))
                w1 = _bytes_add64((c2 & 0xFF) << (8 * i) | 0xA5A5A5A5
                                  & ~(0xFF << (8 * i)))
                sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12)
                x = (byte_perm(w0, w1, sel) & 0x00FF00FF) | 0x43004300
                assert bf16_pair(x) == (192.0 + c, 192.0 + c2)
    for byte in SCALE_BYTES:
        m = ue4m3_pair(byte, 1)
        b = m * -192.0                 # the bf16x2 multiply, exact
        assert b == _bf16_round(b)
        for c in codes:
            fma = _bf16_round((192.0 + c) * m + b)
            plain = _bf16_round(c * (S_REF[byte] * 0.5))
            assert fma + 0.0 == plain + 0.0 == c * S_REF[byte] * 0.5, \
                (c, byte)


def test_w4_decode_equals_plain_decode():
    """Every code byte of the two code rows (k rows 2t, 2t + 1 and 2t + 8,
    2t + 9) at every byte position, beside a range of bytes in the other
    row, and every scale byte in one bf16x2 multiply: equals
    e2m1x_decode(nibble) x ue4m3 rounded to bf16 (the plain decode's f32
    value, exact in bf16); a signed zero code gives -0 where the plain
    decode gives +0, compared as +0."""
    nib_v = gk._e2m1x_values(torch.arange(16)).tolist()

    def want(byte):
        return nib_v[byte & 15], nib_v[byte >> 4]
    others = (0x00, 0x19, 0x91, 0xF7, 0x7F, 0x88)
    for byte in range(256):
        for other in others:
            for i in range(4):
                fill = 0x3C3C3C3C & ~(0xFF << (8 * i))
                for b0, b1 in ((byte, other), (other, byte)):
                    x0, x1 = e2m1x_pairs((b0 << (8 * i)) | fill,
                                         (b1 << (8 * i)) | fill, i)
                    got = [v + 0.0 for v in bf16_pair(x0) + bf16_pair(x1)]
                    assert got == [*want(b0), *want(b1)], (b0, b1, i)
    for sb in SCALE_BYTES:
        s = ue4m3_pair(sb, 0)
        for v in nib_v:
            prod = v * s
            assert _bf16_round(prod) == prod == v * S_REF[sb]


def mainloop_emulation(xa, codes, scales, gs, gw, bias, out_dtype):
    """The small-M tile's sums in plain torch (w8 codes): each 32-deep
    k-tile's product from zero, promoted into its split's f32 total in k
    order; the splits summed in split order from 0.0; gemm_w8's
    epilogue."""
    m, kq = xa.shape
    small, splits, per = gk._split_plan(m, codes.shape[1], kq)
    assert small
    s = N.ue4m3_from_bytes(scales) * 0.5
    w = codes.float() * s.repeat_interleave(N.NVFP4_GROUP, dim=0)
    x = xa.float()
    total = torch.zeros((m, codes.shape[1]))
    for split in range(splits):
        acc = torch.zeros_like(total)
        for kt in range(split * per, min((split + 1) * per, kq // BK)):
            acc = acc + x[:, kt * BK:(kt + 1) * BK] @ w[kt * BK:(kt + 1) * BK]
        total = total + acc
    return gk._epilogue(total, gs, gw, bias, out_dtype)


@pytest.mark.parametrize("m", [1, 4, 17])
@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_mainloop_k_order_matches_jax(m, out_dtype):
    """N 256, K 1984 + 64 ARC columns (Kq 2048: 64 k-tiles in 4 splits
    of 16), bias, per-row scales."""
    rng = np.random.default_rng(60 + m)
    jpw, jxa, jgx = _case(rng, m, 256, 1984, 64, True)
    assert gk._split_plan(m, 256, jpw.kq) == (True, 4, 16)
    jdt = jnp.float32 if out_dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if out_dtype == "f32" else torch.bfloat16
    ref = jgemm.gemm_dequant(jxa, jpw, jgx, out_dtype=jdt)
    pw = packed_from_numpy(jpw)
    gs = to_torch(jgx).reshape(-1, 1).float()
    y = mainloop_emulation(to_torch(jxa), pw.codes, pw.scales, gs,
                           pw.global_scale.reshape(1, -1).float(), pw.bias,
                           tdt)
    assert y.shape == (m, 256) and y.dtype == tdt
    assert_summation_order_close(to_numpy(y), np.asarray(ref, np.float32),
                                 out_dtype)


def _decode_sites():
    """(name, Kq, N) of Qwen2.5-7B's four decode GEMMs, ARC 0.125."""
    cfg = get_model_config("qwen2.5-7b")
    h, f = cfg.hidden_size, cfg.intermediate_size

    def kq(k):
        return packing.pad_kq(k, int(round(0.125 * k / 64)) * 64)
    return [("qkv", kq(h), cfg.q_size + 2 * cfg.kv_size),
            ("o", kq(cfg.q_size), h), ("gateup", kq(h), 2 * f),
            ("down", kq(f), h)]


@pytest.mark.parametrize("site,kq,n", _decode_sites())
def test_split_plan_covers_k_once_in_order(site, kq, n):
    k_tiles = kq // BK
    for m in range(1, 65):
        small, splits, per = gk._split_plan(m, n, kq)
        assert small and splits >= 1 and per >= 1
        covered = [kt for s in range(splits)
                   for kt in range(s * per, min((s + 1) * per, k_tiles))]
        assert covered == list(range(k_tiles)), (site, m, splits, per)
        # no split is empty
        assert (splits - 1) * per < k_tiles


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_batched_k_order_matches_jax(m, out_dtype):
    """A tiny MoE down projection (E 3 experts, K 1984 + 64 ARC columns:
    Kq 2048, N 256, per-channel weight scales, per-row activation scales,
    bf16 activations): each expert's slice emulated at the single GEMM's
    plan for (M, N, Kq), which gemm_batched takes, against the JAX
    package's gemm_dequant_batched (its fused kernel under vmap, in
    interpret mode on the CPU)."""
    rng = np.random.default_rng(90 + m)
    e, n, k, sel = 3, 256, 1984, 64
    packs = []
    for _ in range(e):
        w = np.asarray(jnp.asarray(outlier_x(rng, n, k) * 0.05, jnp.bfloat16))
        packs.append(JP.pack_weight_arc(
            jnp.asarray(w), jnp.asarray(rng.permutation(k).astype(np.int32)),
            sel, fmt="w8", w_scale="channel"))
    jpw = type(packs[0])(*(jnp.stack([getattr(p, f) for p in packs])
                           for f in ("codes", "scales", "global_scale")),
                         None)
    kq = jpw.codes.shape[1]
    assert kq == 2048 and gk._split_plan(m, n, kq) == (True, 4, 16)
    xa = np.asarray(jnp.asarray(rng.standard_normal((e, m, kq)) * 2,
                                jnp.bfloat16))
    gx = rng.random((e, m, 1), np.float32) + 0.5
    jdt = jnp.float32 if out_dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if out_dtype == "f32" else torch.bfloat16
    ref = np.asarray(jgemm.gemm_dequant_batched(
        jnp.asarray(xa), jpw, jnp.asarray(gx), out_dtype=jdt), np.float32)
    for i, p in enumerate(packs):
        pw = packed_from_numpy(p)
        y = mainloop_emulation(to_torch(xa[i]), pw.codes, pw.scales,
                               torch.from_numpy(gx[i]),
                               pw.global_scale.reshape(1, -1).float(), None,
                               tdt)
        assert y.shape == (m, n) and y.dtype == tdt
        assert_summation_order_close(to_numpy(y), ref[i], out_dtype)


def _megakernel_gemms():
    """(name, Kq, N) of the GEMMs the decode megakernels run at
    Qwen2.5-7B: the four decode sites (gemm_actq at qkv and o, gu_actq's
    and mlp_w8's gateup, mlp_w8's down) with ARC select_frac 0.125, and
    the select-free Kq of mlp_w8's gateup and down."""
    cfg = get_model_config("qwen2.5-7b")
    h, f = cfg.hidden_size, cfg.intermediate_size
    return _decode_sites() + [("gateup select-free", packing.pad_kq(h, 0),
                               2 * f),
                              ("down select-free", packing.pad_kq(f, 0), h)]


@pytest.mark.parametrize("site,kq,n", _megakernel_gemms())
def test_megakernel_items_cover_each_tile_once(site, kq, n):
    """gemm_phase's walk, emulated: block b of a grid of G takes items it
    = b, b + G, ... below n_tiles x splits, item it being n-tile it %
    n_tiles of split it / n_tiles over k-tiles [s per, min((s + 1) per,
    Kq / 32)). At every G from 1 to 396 (three 256-thread blocks on each
    of the H100's 132 SMs) and every M the megakernels take (4-16), each
    (n-tile, split) is one block's item exactly once, and the splits of
    an n-tile cover its k-tiles once each, in order."""
    n_tiles, k_tiles = -(-n // 128), kq // BK
    for m in range(4, 17):
        small, splits, per = gk._split_plan(m, n, kq)
        assert small
        items = n_tiles * splits
        want = sorted((nt, s) for nt in range(n_tiles)
                      for s in range(splits))
        for grid in range(1, 397):
            got = []
            for b in range(grid):
                got += [(it % n_tiles, it // n_tiles)
                        for it in range(b, items, grid)]
            assert sorted(got) == want, (site, m, grid)
        covered = [kt for s in range(splits)
                   for kt in range(s * per, min((s + 1) * per, k_tiles))]
        assert covered == list(range(k_tiles)), (site, m)
