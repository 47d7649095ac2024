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
from arcquant_tpu_torch.testing import to_numpy, to_torch

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
    csrc/gemm_lab.cu, and each fits an H100 block's shared memory; the
    sweeps' largest tile does not."""
    src = (ROOT / "arcquant_tpu_torch" / "csrc" / "gemm_lab.cu").read_text()
    names = {"BASE": "base", "MUL3D": "mul3d", "BF16": "bf16",
             "NOSCALE": "noscale", "W4_F32": "f32", "W4_I16": "i16",
             "W4_NODEC": "nodec"}

    def entries(macro, n_fields):
        body = re.search(rf"#define {macro}\(X\)(.*?)\n\n", src, re.S).group(1)
        return [tuple(int(v) if v.strip().isdigit() else names[v.strip()]
                      for v in e.split(","))
                for e in re.findall(r"X\(([^)]*)\)", body)
                if len(e.split(",")) == n_fields]
    assert sorted(entries("LAB_CONFIG_LIST", 4)) == sorted(gl.LAB_CONFIGS)
    assert sorted(entries("RING_CONFIG_LIST", 3)) == sorted(gl.RING_CONFIGS)
    assert len(gl.LAB_CONFIGS) + len(gl.RING_CONFIGS) <= 32
    for bn, bks, stages, mode in gl.LAB_CONFIGS:
        assert gl.smem_bytes(bn, bks, stages, mode) <= gl.SMEM_MAX
    for bn, bks, stages in gl.RING_CONFIGS:
        assert gl.smem_bytes(bn, bks, stages, "base") <= gl.SMEM_MAX
    assert gl.smem_bytes(256, 256, 3, "base") > gl.SMEM_MAX
    with pytest.raises(ValueError, match="mode"):
        gl.lab_w8_plain(*_case(4, 0, "w8")[1], mode="f32")


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
