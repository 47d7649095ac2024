"""arcquant_tpu_torch numerics and w8 packing held bit-exact against the
JAX package (the golden definitions both implement), plus the kernel
build's refusal to fall back when nvcc is missing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.quant import numerics as JN
from arcquant_tpu.quant import packing as JP
from arcquant_tpu_torch.kernels import _build
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.quant import numerics as N
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import outlier_x, to_numpy, to_torch


def _edge_values():
    """e2m1 ties, their float neighbours, both signs, 0, -0, the max
    (no f32 denormals: XLA on the CPU flushes them, torch does not)."""
    b = np.array(N.E2M1_BOUNDARIES + N.E2M1_MAGNITUDES[1:]
                 + (6.5, 7.0, 100.0), np.float32)
    near = np.concatenate([b, np.nextafter(b, np.float32(0)),
                           np.nextafter(b, np.float32(np.inf))])
    return np.concatenate([near, -near, [0.0, -0.0]]).astype(np.float32)


def test_e2m1_encode_decode_edges():
    x = _edge_values()
    got = to_numpy(N.e2m1_encode(torch.from_numpy(x)))
    want = np.asarray(JN.e2m1_encode(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    codes = np.arange(16, dtype=np.uint8)
    got = to_numpy(N.e2m1_decode(torch.from_numpy(codes)))
    want = np.asarray(JN.e2m1_decode(jnp.asarray(codes)))
    np.testing.assert_array_equal(got, want)
    assert np.signbit(got[8])          # code 8 is -0.0, as in JAX


def test_e2m1_encode_scaled_ties_and_subnormal_scales():
    rng = np.random.default_rng(0)
    grid = np.asarray(JN.quantize_ue4m3(jnp.asarray(
        np.geomspace(2.0 ** -9, 448, 300).astype(np.float32))))
    scale = rng.choice(np.unique(grid), 4096).astype(np.float32)
    ties = rng.choice(np.array(N.E2M1_BOUNDARIES, np.float32), 4096)
    x = np.concatenate([ties * scale,
                        np.nextafter(ties * scale, np.float32(0)),
                        -(ties * scale),
                        rng.standard_normal(4096).astype(np.float32)
                        * scale * 3]).astype(np.float32)
    s = np.concatenate([scale] * 4)
    got = to_numpy(N.e2m1_encode_scaled(torch.from_numpy(x),
                                        torch.from_numpy(s)))
    want = np.asarray(JN.e2m1_encode_scaled(jnp.asarray(x), jnp.asarray(s)))
    np.testing.assert_array_equal(got, want)


def test_ue4m3_rne_matches_f8_cast():
    """Dense sweep plus every grid point and every midpoint (ties to
    even), subnormals and the 448 clamp: the bit-arithmetic port equals
    the JAX package's float8_e4m3fn cast."""
    grid = np.asarray(jnp.arange(1, 127, dtype=jnp.uint8).view(
        jnp.float8_e4m3fn).astype(jnp.float32))
    s = np.concatenate([
        np.geomspace(2.0 ** -11, 600.0, 100001, dtype=np.float32),
        grid, (grid[1:] + grid[:-1]) / 2,
        [0.0, 1e-12, 2.0 ** -9, 2.0 ** -6, 448.0, 449.0, 464.0, 1e4]
    ]).astype(np.float32)
    got = N.quantize_ue4m3(torch.from_numpy(s))
    want = np.asarray(JN.quantize_ue4m3(jnp.asarray(s)))
    np.testing.assert_array_equal(to_numpy(got), want)
    want_bytes = np.asarray(jnp.asarray(want).astype(
        jnp.float8_e4m3fn).view(jnp.uint8))
    np.testing.assert_array_equal(to_numpy(N.ue4m3_to_bytes(got)),
                                  want_bytes)
    b = np.arange(127, dtype=np.uint8)
    np.testing.assert_array_equal(
        to_numpy(N.ue4m3_from_bytes(torch.from_numpy(b))),
        np.asarray(jnp.asarray(b).view(jnp.float8_e4m3fn)
                   .astype(jnp.float32)))


@pytest.mark.parametrize("per_row", [False, True])
def test_nvfp4_global_scale(per_row):
    x = outlier_x(np.random.default_rng(1), 33, 512)
    x[3] = 0.0
    for arr in (x, np.asarray(jnp.asarray(x, jnp.bfloat16))):
        got = N.nvfp4_global_scale(to_torch(arr), per_row=per_row)
        want = JN.nvfp4_global_scale(jnp.asarray(arr), per_row=per_row)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    assert N.INV_NVFP4_GLOBAL_DIV == JN.INV_NVFP4_GLOBAL_DIV
    assert N.INV_E2M1_MAX == JN.INV_E2M1_MAX


@pytest.mark.parametrize("k,select", [(512, 0), (960, 64), (3584, 448),
                                      (18944, 2368)])
def test_pad_kq_and_k_block(k, select):
    assert packing.pad_kq(k, select) == JP.pad_kq(k, select)
    kq = packing.pad_kq(k, select)
    assert packing.best_k_block(kq) == JP.best_k_block(kq)


@pytest.mark.parametrize("w_scale,select,bias", [
    ("channel", 64, True), ("tensor", 64, False), ("channel", 0, False),
    ("channel", 128, False)])
def test_pack_weight_arc_w8_bytes(w_scale, select, bias):
    """pack_weight_arc: identical int8 codes, ue4m3 scale bytes (zero on
    the pad groups), global scales and bias, from the same bf16 weight
    and a random reorder index."""
    rng = np.random.default_rng(2)
    n, k = 96, 448
    w = np.asarray(jnp.asarray(outlier_x(rng, n, k) * 0.05, jnp.bfloat16))
    ridx = rng.permutation(k).astype(np.int32)
    b = (np.asarray(jnp.asarray(rng.standard_normal(n), jnp.bfloat16))
         if bias else None)
    jpw = JP.pack_weight_arc(jnp.asarray(w), jnp.asarray(ridx), select,
                             bias=None if b is None else jnp.asarray(b),
                             fmt="w8", w_scale=w_scale)
    tpw = packing.pack_weight_arc(to_torch(w), torch.from_numpy(ridx),
                                  select, bias=None if b is None
                                  else to_torch(b), w_scale=w_scale)
    assert tpw.kq == jpw.kq and tpw.n == jpw.n
    np.testing.assert_array_equal(to_numpy(tpw.codes), np.asarray(jpw.codes))
    np.testing.assert_array_equal(to_numpy(tpw.scales),
                                  np.asarray(jpw.scales))
    assert (to_numpy(tpw.scales)[(k + select) // 16:] == 0).all()
    np.testing.assert_array_equal(to_numpy(tpw.global_scale),
                                  np.asarray(jpw.global_scale))
    if bias:
        np.testing.assert_array_equal(to_numpy(tpw.bias),
                                      np.asarray(jpw.bias, np.float32))
    # the decoded weight matches the JAX golden decode
    full = to_numpy(packing.dequantize_weight(tpw)).T[:, :k + select]
    np.testing.assert_array_equal(
        full, np.asarray(JP.dequantize_weight(jpw, k, select)))


def test_pack_weight_arc_rejects_unknown_format():
    with pytest.raises(ValueError, match="w2"):
        packing.pack_weight_arc(torch.ones(16, 64), None, 0, fmt="w2")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: building raises, and a kernel call raises instead of
    returning the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOTS", ())
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library()
        before = qk.ACTQ.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            qk.ACTQ(0, 0, 0, 0, 0, 0, 16, 512, 0, 0.0)
        assert qk.ACTQ.launches == before
    finally:
        _build.library.cache_clear()


def test_wrapper_never_falls_back_off_cpu():
    """Only CPU tensors take the plain version; any other device goes to
    the CUDA launcher, which refuses non-CUDA tensors."""
    x = torch.empty((4, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        qk.quantize_x_arc(x, torch.arange(64), 0)
