"""The GEMM lab (kernels/gemm_lab.py) of arcquant_tpu_torch held against
the JAX package's lab (benchmarks/gemm_lab.py) on the same packed bytes.

The JAX lab's four Pallas functions run in interpret mode: the module is
loaded by path (benchmarks/ is not a package) and its ``pl`` attribute
is replaced by a namespace whose ``pallas_call`` passes interpret=True
(w8_variant and w4_variant take no interpret argument; the two stream
variants are called with interpret=True). Nothing in the JAX file
changes. The JAX side pads the activations to bm = 16 rows and takes w4
activations split into even and odd k halves; the port takes the
natural [M, Kq] operand.

The tolerance is test_torch_gemm.py's summation-order one (one bf16 ulp
plus 1e-4 of the row's magnitude), with an absolute floor of 1e-30 for
the nodec probe, whose weights are near-denormal. The exact decodes
(base, mul3d, bf16; w4 f32 and i16) are also held bitwise: to the JAX
variant and to the port's production plain GEMM.
"""

import functools
import importlib.util
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from arcquant_tpu.kernels import gemm as jgemm
from arcquant_tpu.kernels import quantize as jqk
from arcquant_tpu.quant import packing as JP
from arcquant_tpu_torch.convert import packed_from_numpy
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.kernels import gemm_lab as gl
from arcquant_tpu_torch.kernels import quantize
from arcquant_tpu_torch.quant import numerics as N
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import to_numpy, to_torch

from test_torch_gemm_small_m import (S_REF, e2m1x_pairs, mainloop_emulation,
                                     ue4m3_pair)

ROOT = Path(__file__).resolve().parents[1]
N_OUT, K, BM = 256, 512, 16
CASES = [(4, 0), (4, 64), (16, 0), (16, 64)]     # (m, ARC select)


@pytest.fixture(scope="module")
def jlab():
    """benchmarks/gemm_lab.py with its pallas_call in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "jax_gemm_lab", ROOT / "benchmarks" / "gemm_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                    if not k.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = shim
    return mod


@functools.lru_cache(maxsize=None)
def _case(m, select, fmt):
    """JAX operands (padded to BM rows) and the port's, of one weight."""
    rng = np.random.default_rng(100 * m + select)
    w = jnp.asarray(rng.standard_normal((N_OUT, K)) * 0.05, jnp.bfloat16)
    ridx = jnp.asarray(rng.permutation(K).astype(np.int32))
    x = jnp.asarray(rng.standard_normal((m, K)), jnp.bfloat16)
    pw = JP.pack_weight_arc(w, ridx, select, fmt=fmt, w_scale="channel")
    xa, gx = jqk.quantize_x_arc(x, ridx, select, kq=pw.kq, per_row=True)
    xa = xa.astype(jnp.bfloat16)
    j = dict(
        xa=jnp.pad(xa, ((0, BM - m), (0, 0))),
        xs=jnp.pad(jgemm.split_even_odd(xa), ((0, BM - m), (0, 0))),
        gs=jnp.pad(gx.reshape(-1, 1).astype(jnp.float32),
                   ((0, BM - m), (0, 0)), constant_values=1.0),
        gw=pw.global_scale.astype(jnp.float32).reshape(1, -1),
        codes=pw.codes, su8=jax.lax.bitcast_convert_type(pw.scales, jnp.uint8),
        prod=np.asarray(jgemm.gemm_dequant(xa, pw, gx), np.float32))
    tpw = packed_from_numpy(jax.tree.map(np.asarray, pw))
    t = (to_torch(xa), tpw.codes, tpw.scales, to_torch(gx).reshape(-1),
         tpw.global_scale)
    return j, t


def assert_close(y, ref, atol=0.0):
    """The GEMM summation-order bound for bf16 outputs (+ atol)."""
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=-1, keepdims=True) + 1e-30
    tol = 1e-4 * scale + 2.0 ** -7 * np.abs(ref) + atol
    assert (np.abs(y - ref) <= tol).all(), float(np.abs(y - ref).max())


def _check(y, jy, mode, m, production=None):
    jy = np.asarray(jy, np.float32)[:m]
    got = to_numpy(y)
    assert y.shape == (m, N_OUT) and y.dtype == torch.bfloat16
    assert np.isfinite(got).all()
    assert_close(got, jy, atol=1e-30 if mode == "nodec" else 0.0)
    if mode in gl.EXACT_MODES:
        np.testing.assert_array_equal(got, jy)
        if production is not None:
            assert torch.equal(y, production)


def _production(t):
    xa, codes, scales, gs, gw = t
    plain = gk.gemm_w4_plain if codes.dtype == torch.uint8 \
        else gk.gemm_w8_plain
    return plain(xa, codes, scales, gs.reshape(-1, 1), gw.reshape(1, -1),
                 None, torch.bfloat16)


@pytest.mark.parametrize("m,select", CASES)
@pytest.mark.parametrize("mode", gl.W8_MODES)
def test_lab_w8_matches_jax(jlab, m, select, mode):
    j, t = _case(m, select, "w8")
    jy = jlab.w8_variant(j["xa"], j["codes"], j["su8"], j["gs"], j["gw"],
                         bm=BM, bn=128, bk=256, mode=mode)
    _check(gl.lab_w8(*t, mode=mode), jy, mode, m, _production(t))
    if mode in gl.EXACT_MODES:     # the JAX variant gives production's bits
        np.testing.assert_array_equal(np.asarray(jy, np.float32)[:m],
                                      j["prod"])


@pytest.mark.parametrize("m,select", CASES)
@pytest.mark.parametrize("variant", ["ring", "ring_n"])
def test_lab_rings_match_jax(jlab, m, select, variant):
    """lab_w8_ring against w8_dma_variant (one program streaming [bk, N]
    stripes), lab_w8_ring_n against w8_dma_nblock (a program per bn
    block); both compute mode base."""
    j, t = _case(m, select, "w8")
    args = (j["xa"], j["codes"], j["su8"], j["gs"], j["gw"])
    if variant == "ring":
        jy = jlab.w8_dma_variant(*args, bm=BM, bk=256, nbuf=3,
                                 interpret=True)
        y = gl.lab_w8_ring(*t)
    else:
        jy = jlab.w8_dma_nblock(*args, bm=BM, bk=256, bn=128, nbuf=3,
                                interpret=True)
        y = gl.lab_w8_ring_n(*t)
    _check(y, jy, "base", m, _production(t))


@pytest.mark.parametrize("m,select", CASES)
@pytest.mark.parametrize("mode", gl.W4_MODES)
def test_lab_w4_matches_jax(jlab, m, select, mode):
    """w4_variant on split-half activations against lab_w4 on the
    natural ones; the exact decodes also equal the w8 GEMM of the same
    weight (gemm_w4_plain, bitwise equal to gemm_w8_plain)."""
    j, t = _case(m, select, "w4")
    jy = jlab.w4_variant(j["xs"], j["codes"], j["su8"], j["gs"], j["gw"],
                         bm=BM, bn=128, bk=256, mode=mode)
    _check(gl.lab_w4(*t, mode=mode), jy, mode, m, _production(t))


def test_nibble_and_byte_decodes():
    """The i16 map gives the f32 map's values (so i16 is exact), and nodec
    the bf16 of the byte's bits c << 22, on every nibble and byte."""
    nib = torch.arange(16, dtype=torch.uint8)
    i16 = gl._i16_values(nib).float()
    assert torch.equal(i16, gk._e2m1x_values(nib))
    np.testing.assert_array_equal(
        to_numpy(gl._i16_values(nib)),
        np.asarray(jax.lax.bitcast_convert_type(
            jnp.where((jnp.arange(16) & 7) == 1, 0,
                      (((jnp.arange(16) & 7) << 6)
                       | ((jnp.arange(16) & 8) << 12)) + 0x3F00)
            .astype(jnp.uint16), jnp.bfloat16), np.float32))
    byte = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    scales = torch.full((2, 16), 0x38, dtype=torch.uint8)    # ue4m3 1.0
    y = gl.lab_w4_plain(torch.eye(32, dtype=torch.bfloat16), byte, scales,
                        torch.ones(32), torch.ones(16), "nodec")
    want = jax.lax.bitcast_convert_type(
        jnp.arange(256, dtype=jnp.int32) << 22, jnp.float32).astype(
            jnp.bfloat16)
    want = np.repeat(np.asarray(want, np.float32).reshape(16, 16), 2, axis=0)
    np.testing.assert_array_equal(to_numpy(y), want)


def test_configs_match_the_cuda_source():
    """The Python lists name exactly the instantiated configurations of
    csrc/gemm_lab.cu (lab_w8 / lab_w4, the TMA ring's, the cluster
    kernel's tiles and its largest cluster), and each fits an H100
    block's shared memory; the sweeps' largest tile does not."""
    src = (ROOT / "arcquant_tpu_torch" / "csrc" / "gemm_lab.cu").read_text()
    names = {"BASE": "base", "MUL3D": "mul3d", "BF16": "bf16",
             "NOSCALE": "noscale", "W4_F32": "f32", "W4_I16": "i16",
             "W4_NODEC": "nodec"}

    def entries(macro, n_fields):
        body = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)",
                         src).group(1)
        return [tuple(int(v) if v.strip().isdigit() else names[v.strip()]
                      for v in e.split(","))
                for e in re.findall(r"X\(([^)]*)\)", body)
                if len(e.split(",")) == n_fields]
    assert sorted(entries("LAB_CONFIG_LIST", 4)) == sorted(gl.LAB_CONFIGS)
    assert sorted(entries("RING_CONFIG_LIST", 3)) == sorted(gl.RING_CONFIGS)
    max_c = int(re.search(r"constexpr int MAX_CLUSTER = (\d+);", src).group(1))
    assert max_c == gl.MAX_CLUSTER <= 16
    assert sorted(gl.RING_N_CONFIGS) == sorted(
        (*t, c) for t in entries("RING_N_CONFIG_LIST", 3)
        for c in range(1, max_c + 1))
    tiles = {t[:3] for t in gl.RING_N_CONFIGS}
    assert len(gl.LAB_CONFIGS) + len(gl.RING_CONFIGS) + len(tiles) <= 32
    # the fragment mainloop: padded code rows, no WMMA, no B or C tile
    lab_ns = src[src.index("namespace lab {"):src.index("namespace ring {")]
    assert "LDC = W4 ? BN + 32 : BN + 16" in lab_ns
    assert "wmma" not in lab_ns and "Bs" not in lab_ns
    assert lab_ns.count("sm::decode_step<") == 1
    assert gl.smem_bytes(128, 128, 3, "base") == 3 * (128 * 144 + 8 * 128
                                                      + 16 * 136 * 2)
    assert gl.smem_bytes(128, 128, 3, "mul3d") == \
        gl.smem_bytes(128, 128, 3, "base") + 8 * 128 * 4
    assert gl.smem_bytes(128, 128, 3, "f32") == 3 * (64 * 160 + 8 * 128
                                                     + 16 * 136 * 2)
    for bn, bks, stages, mode in gl.LAB_CONFIGS:
        assert gl.smem_bytes(bn, bks, stages, mode) <= gl.SMEM_MAX
    for bn, bks, stages in gl.RING_CONFIGS:
        assert bn % gl.RING_HALF == 0 and bks == 128
        assert gl.ring_smem_bytes(bn, stages) <= gl.SMEM_MAX
    assert gl.smem_bytes(256, 256, 3, "base") > gl.SMEM_MAX
    with pytest.raises(ValueError, match="mode"):
        gl.lab_w8_plain(*_case(4, 0, "w8")[1], mode="f32")


@pytest.mark.parametrize("bn,bks,stages,mode", gl.LAB_CONFIGS)
def test_code_rows_padded_off_bank_conflicts(bn, bks, stages, mode):
    """A fragment load (one 32-bit word a thread: lane t = l % 4 reads
    code row 2t (w8) or t (w4) of the step, at column 4 (l / 4) of its
    warp's 32) hits 32 distinct banks: the rows start 8 banks apart at
    every built BN; every row and stage stays 16-byte aligned for
    cp.async."""
    ld = gl.code_ld(bn, mode)
    assert ld % 16 == 0
    for warp in range(bn // 32):
        for r0 in (0, 1, 8, 9) if mode in gl.W8_MODES else (0, 4):
            step = 2 if mode in gl.W8_MODES else 1
            banks = {((r0 + step * t) * ld + warp * 32 + 4 * g) // 4 % 32
                     for t in range(4) for g in range(8)}
            assert len(banks) == 32, (bn, mode, warp, r0)


def _bf16_value(h):
    """bf16 bits (any unsigned array) -> their f32 values."""
    return (np.asarray(h, np.uint32) << 16).view(np.float32)


def _round_bf16(x):
    """f32 values -> bf16 bits, rounded to nearest even (no NaN here)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _halves(v):
    v = np.asarray(v, np.uint32)
    return (v & 0xFFFF).astype(np.uint16), (v >> 16).astype(np.uint16)


def _ue4m3_decode(b):
    """common.cuh's ue4m3_decode on the bits (e == 0: m 2^-9)."""
    b = np.asarray(b, np.uint32)
    e, m = (b >> 3) & 0xF, b & 7
    normal = (((e + 120) << 23) | (m << 20)).astype(np.uint32).view(
        np.float32)
    return np.where(e == 0, m.astype(np.float32) * np.float32(2.0 ** -9),
                    normal).astype(np.float32)


def _bits(w):
    return w.view(torch.int16).numpy().view(np.uint16)


def test_register_decodes_equal_plain_decode():
    """Every register decode of lab_w8 and lab_w4 (csrc/gemm_lab.cu
    frag_decode), its integer and bf16x2 steps emulated on the 32-bit
    words a thread holds, over all 256 code bytes x all 256 ue4m3 scale
    bytes, equals the plain version's decoded weight (w8_weight,
    w4_weight) bit for bit:
      noscale  byte c's low 7 bits into the bf16 128 + m, less 128 or 256
               (sign bit) in one bf16x2 subtraction; the word holds byte
               c twice and the other k row's byte twice (byte_perm's
               pair), which the masks drop;
      mul3d    that pair times the stage's scale tile entry, the bf16 pair
               of ue4m3 / 2 built from the bits (ue4m3_pair<1>), __hmul2;
      bf16     code and ue4m3_decode / 2 rounded to bf16, __hmul2;
      i16      w4_variant's map on the two 16-bit halves of a word (mag 1
               -> 0), times ue4m3_pair<0>;
      nodec    c << 6 in both halves;
      f32      production's byte-permute tables (e2m1x_pairs) times
               ue4m3_pair<0>. The one exception: a zero code with its
               sign bit set (nibble 9) decodes to -0 where the plain
               version gives +0, a zero product's sign that the
               zero-started partials absorb."""
    byte = np.arange(256, dtype=np.uint32)
    c = np.repeat(byte[:, None], 256, axis=1)        # [code byte, scale byte]
    sb = np.repeat(byte[None, :], 256, axis=0)
    other = (c + 91) % 256                           # the word's other k row
    codes8 = torch.from_numpy(byte.astype(np.uint8)).view(torch.int8)
    codes8 = codes8[:, None].expand(256, 256).contiguous()
    scales8 = torch.from_numpy(byte.astype(np.uint8))[None].expand(16, 256)
    plain8 = {m: _bits(gl.w8_weight(codes8, scales8.contiguous(), m))
              for m in gl.W8_MODES}
    s_w8 = np.array([_round_bf16(ue4m3_pair(b, 1)) for b in range(256)])
    s_w4 = np.array([_round_bf16(ue4m3_pair(b, 0)) for b in range(256)])

    def mul(a, b):
        return _round_bf16(_bf16_value(a) * _bf16_value(b))

    p = c | (c << 8) | (other << 16) | (other << 24)
    lo, hi = _halves((p & 0x007F007F) | 0x43004300)
    klo, khi = _halves((p & 0x00800080) | 0x43004300)
    code_lo = _round_bf16(_bf16_value(lo) - _bf16_value(klo))
    code_hi = _round_bf16(_bf16_value(hi) - _bf16_value(khi))
    got = {"noscale": (code_lo, code_hi),
           "mul3d": (mul(code_lo, s_w8[sb]), mul(code_hi, s_w8[sb]))}
    s_cvt = _round_bf16(_ue4m3_decode(sb) * np.float32(0.5))
    assert (_ue4m3_decode(byte) == np.float32(S_REF)).all()
    got["bf16"] = tuple(
        mul(_round_bf16(v.astype(np.uint8).view(np.int8).astype(np.float32)),
            s_cvt) for v in (c, other))
    for mode, (g_lo, g_hi) in got.items():
        np.testing.assert_array_equal(g_lo, plain8[mode], err_msg=mode)
        np.testing.assert_array_equal(g_hi, plain8[mode][other, sb],
                                      err_msg=mode)

    codes4 = torch.from_numpy(byte.astype(np.uint8))[:, None].expand(
        256, 256).contiguous()
    scales4 = torch.from_numpy(byte.astype(np.uint8))[None].expand(32, 256)
    plain4 = {m: _bits(gl.w4_weight(codes4, scales4.contiguous(), m))
              for m in gl.W4_MODES}
    w = (c & 0xF) | ((c & 0xF0) << 12)
    mag = w & 0x00070007
    h = ((mag << 6) | ((w & 0x00080008) << 12)) + 0x3F003F00
    h &= ~(np.where((mag & 0xFFFF) == 1, 0xFFFF, 0)
           | np.where((mag >> 16) == 1, 0xFFFF0000, 0)).astype(np.uint32)
    got = {"i16": tuple(mul(x, s_w4[sb]) for x in _halves(h)),
           "nodec": _halves((c << 6) * 0x10001)}
    pairs = np.array([_halves(e2m1x_pairs(b, (b + 91) % 256, 0)[0])
                      for b in range(256)])       # [byte, half]
    got["f32"] = tuple(mul(pairs[c, j], s_w4[sb]) for j in (0, 1))
    for mode, (g_lo, g_hi) in got.items():
        for g, want, nib in ((g_lo, plain4[mode][0::2], c & 0xF),
                             (g_hi, plain4[mode][1::2], c >> 4)):
            if mode == "f32":   # the signed zero code: -0 against +0
                signed_zero = nib == 9
                assert (g[signed_zero] == 0x8000).all()
                assert (want[signed_zero] == 0).all()
                g = np.where(signed_zero, 0, g)
            np.testing.assert_array_equal(g, want, err_msg=mode)


def test_ring_boxes_and_shared_memory():
    """The copy rings' TMA boxes: at most 256 elements a dimension, rows
    of a multiple of 16 bytes, each a multiple of 128 bytes (the next
    box's destination stays 128-byte aligned), padded as
    gemm_small_m.cuh pads the stage it fills (code rows BN + 16 bytes,
    activation rows BKS + 8 bf16), and together one stage; every ring
    and cluster configuration's shared memory fits a block."""
    small = (ROOT / "arcquant_tpu_torch" / "csrc"
             / "gemm_small_m.cuh").read_text()
    assert "LDC = kW4 ? BN + 32 : BN + 16" in small
    assert "LDA = BKS + 8" in small
    assert gl.RING_BOXES["codes"][0] == gl.RING_HALF + 16
    assert gl.RING_BOXES["xa"][0] == 128 + 8
    for inner, outer, size in gl.RING_BOXES.values():
        assert inner <= 256 and outer <= 256
        assert inner * size % 16 == 0
        assert inner * outer * size % 128 == 0
    assert gl.RING_STAGE == sum(i * o * b for i, o, b in
                                gl.RING_BOXES.values())
    for bn, _, stages in gl.RING_CONFIGS:
        assert gl.ring_smem_bytes(bn, stages) <= gl.SMEM_MAX
    for bn, _, stages, _ in gl.RING_N_CONFIGS:
        assert gl.ring_smem_bytes(bn, stages) <= gl.SMEM_MAX
        # the cluster's f32 partial tile [16 x 128] reuses slot 0
        assert gl.BM * gl.RING_HALF * 4 <= gl.RING_STAGE


SITES = {"qkv": (4608, 3584), "o": (3584, 3584), "gateup": (37888, 3584),
         "down": (3584, 18944)}


@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("m", [4, 16, 64])
@pytest.mark.parametrize("select_frac", [0, 0.125])
def test_cluster_plan_is_production_split(site, m, select_frac):
    """lab_w8_ring_n's default cluster: one CTA per production split,
    CTA r over exactly production split r's k-tiles, within the largest
    cluster the kernel takes."""
    n, k = SITES[site]
    kq = packing.pad_kq(k, int(round(select_frac * k / 64)) * 64)
    _, splits, per = gk._split_plan(m, n, kq)
    tiles = kq // gl.SUBK
    want = [(s * per, min((s + 1) * per, tiles)) for s in range(splits)]
    got = gl.cluster_ranges(m, n, kq)
    assert got == want
    assert (128, 128, 3, len(got)) in gl.RING_N_CONFIGS
    assert got[0][0] == 0 and got[-1][1] == tiles
    assert all(a < b for a, b in got)


def cluster_emulation(xa, codes, scales, gs, gw, cluster=None):
    """lab_w8_ring_n's sums in plain torch: CTA r's k-tiles (cluster_ranges)
    each a 32-deep product from zero promoted in k order into its f32
    partial; c = 1 stores the partial; c > 1 sums the partials in rank
    order from 0.0 (w8::sum_splits); store_out's epilogue."""
    m, kq = xa.shape
    s = N.ue4m3_from_bytes(scales) * 0.5
    w = codes.float() * s.repeat_interleave(N.NVFP4_GROUP, dim=0)
    x = xa.float()
    parts = []
    for kt0, kt1 in gl.cluster_ranges(m, codes.shape[1], kq, cluster):
        acc = torch.zeros((m, codes.shape[1]))
        for kt in range(kt0, kt1):
            acc = acc + x[:, kt * 32:(kt + 1) * 32] @ w[kt * 32:(kt + 1) * 32]
        parts.append(acc)
    if len(parts) == 1:
        total = parts[0]
    else:
        total = torch.zeros_like(parts[0])
        for p in parts:
            total = total + p
    return gk._epilogue(total, gs.reshape(-1, 1), gw.reshape(1, -1), None,
                        torch.bfloat16)


@pytest.mark.parametrize("m,n,k,select", [(4, 256, 512, 0), (4, 256, 2048, 0),
                                          (16, 208, 1536, 64),
                                          (3, 640, 4096, 128)])
def test_cluster_reduce_equals_split_k_emulation(m, n, k, select):
    """The cluster reduce, emulated, gives bit for bit the split-K
    emulation production is held to (test_torch_gemm_small_m.py), at one
    split (the direct store) and at several (the rank-order sum)."""
    rng = np.random.default_rng(7 * m + n + select)
    w = torch.tensor(rng.standard_normal((n, k)) * 0.05).to(torch.bfloat16)
    ridx = torch.tensor(rng.permutation(k))
    pw = packing.pack_weight_arc(w, ridx, select, fmt="w8",
                                 w_scale="channel")
    x = torch.tensor(rng.standard_normal((m, k))).to(torch.bfloat16)
    xa, gx = quantize.quantize_x_arc(x, ridx, select, kq=pw.kq)
    gw = pw.global_scale.float().reshape(1, -1).expand(1, n)
    got = cluster_emulation(xa, pw.codes, pw.scales, gx, gw)
    want = mainloop_emulation(xa, pw.codes, pw.scales, gx.reshape(-1, 1),
                              gw, None, torch.bfloat16)
    c = len(gl.cluster_ranges(m, n, pw.kq))
    assert c == gk._split_plan(m, n, pw.kq)[1]
    assert torch.equal(got.view(torch.int16), want.view(torch.int16)), c
    assert_close(to_numpy(got),
                 to_numpy(gl.lab_w8_plain(xa, pw.codes, pw.scales,
                                          gx.reshape(-1), gw.reshape(-1))))


@pytest.mark.parametrize("m,n,kq", [(4, 4608, 3584), (4, 37888, 3584),
                                    (16, 1040, 1024), (4, 3584, 21504)])
@pytest.mark.parametrize("splits", [None, 1, 2, 5, 16, 1000])
def test_lab_split_plan(m, n, kq, splits):
    """The kernels' k ranges: production's plan by default (so the exact
    modes keep gemm_w8's k order), else about `splits` ranges of whole
    32-deep tiles that cover K once, none empty."""
    got, per = gl._plan(m, n, kq, splits)
    tiles = kq // gl.SUBK
    if splits is None:
        assert (got, per) == gk._split_plan(m, n, kq)[1:]
    else:
        assert 1 <= got <= min(splits, tiles)
    assert (got - 1) * per < tiles <= got * per
