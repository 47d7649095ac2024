"""Decode megakernels (kernels/mlp_fused.py) of arcquant_tpu_torch held
against the JAX package's kernels/mlp_fused.py, whose Pallas kernels run
in interpret mode here; the port's CPU tensors take its plain versions.

Same inputs (numpy, seeded) and the same packed bytes go to both. The
bars, step by step:
  - quantize outputs bit-exact: gx of the plain-mode quantize, and
    (xa2, gx2) against JAX's silu_mul_quantize_gu of the port's own gu;
  - GEMM outputs (y, gu, out) within the w8 GEMM's f32 summation-order
    tolerance (tests/test_torch_gemm.py) of JAX's, the down GEMM of JAX's
    gemm_dequant over the port's xa2;
  - the rmsnorm modes: each bit-exact against the port's rmsnorm
    quantize followed by its quantized route (the JAX package's contract
    for the fold), the GEMM held over that quantize, gx within 1% of
    JAX's; the rmsnorm quantize itself is held against JAX's (one e2m1
    step on boundary elements) by tests/test_torch_quantize.py.
The gates are held against JAX's over a grid of M, scales, ARC columns,
weight formats and the M limit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.kernels import gemm as jgemm
from arcquant_tpu.kernels import mlp_fused as jmf
from arcquant_tpu.kernels import quantize as jqk
from arcquant_tpu.quant import packing as JP
from arcquant_tpu_torch.convert import packed_from_numpy
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.kernels import mlp_fused as mf
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.testing import outlier_x, to_numpy, to_torch
from tests.test_torch_gemm import assert_summation_order_close

EPS = 1e-6


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _pack(rng, n, k, bias, select=0):
    """A JAX-packed w8 weight [n, k] (per-channel scales) and the port's
    tensors of the same bytes."""
    w = _bf16(outlier_x(rng, n, k) * k ** -0.5)
    b = _bf16(rng.standard_normal(n) * 0.1) if bias else None
    ridx = rng.permutation(k).astype(np.int32)
    jpw = JP.pack_weight_arc(jnp.asarray(w), jnp.asarray(ridx), select,
                             bias=None if b is None else jnp.asarray(b),
                             fmt="w8", w_scale="channel")
    return jpw, packed_from_numpy(jpw), ridx


def _x(rng, m, d):
    return _bf16(outlier_x(rng, m, d, scale=4.0))


def _norm_w(rng, d):
    return _bf16(rng.standard_normal(d) * 0.1 + 1)


def _close(got, want, out="bf16"):
    assert_summation_order_close(to_numpy(got), np.asarray(want, np.float32),
                                 out)


def _check_silu_quantize(xa2, gu, gx2, f, kq2):
    """(xa2, gx2) bit-exact against JAX's quantize of the port's gu."""
    jxa2, jgx2 = jqk.silu_mul_quantize_gu(
        jnp.asarray(_bf16(to_numpy(gu))), jnp.arange(f, dtype=jnp.int32), 0,
        kq=kq2, per_row=True)
    np.testing.assert_array_equal(to_numpy(xa2), np.asarray(jxa2, np.float32))
    np.testing.assert_array_equal(to_numpy(gx2), np.asarray(jgx2))


@pytest.mark.parametrize("m", [4, 9, 16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mode", ["plain", "norm"])
def test_gemm_w8_actq_fused_matches_jax(m, bias, mode):
    rng = np.random.default_rng(m + 10 * bias)
    d, n = 256, 512
    jpw, pw, _ = _pack(rng, n, d, bias)
    x = _x(rng, m, d)
    nw = _norm_w(rng, d) if mode == "norm" else None
    kw = {} if nw is None else dict(norm_eps=EPS)
    jy, jgx = jmf.gemm_w8_actq_fused(
        jnp.asarray(x), jpw, d,
        norm_w=None if nw is None else jnp.asarray(nw), **kw)
    y, gx = mf.gemm_w8_actq_fused(
        to_torch(x), pw, d, norm_w=None if nw is None else to_torch(nw), **kw)
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    if nw is None:
        np.testing.assert_array_equal(to_numpy(gx), np.asarray(jgx))
        _close(y, jy)
        return
    xa, pgx = qk.rmsnorm_quantize_x(to_torch(x), to_torch(nw), EPS,
                                    torch.arange(d), 0, kq=pw.kq)
    np.testing.assert_allclose(to_numpy(gx), np.asarray(jgx), rtol=1e-2)
    _close(y, jgemm.gemm_dequant(jnp.asarray(_bf16(to_numpy(xa))), jpw,
                                 jnp.asarray(to_numpy(gx))))
    # the fold: bit-exact against that quantize, then the GEMM
    assert torch.equal(gx, pgx)
    assert torch.equal(y, gk.gemm_dequant(xa, pw, pgx))


@pytest.mark.parametrize("m", [4, 9, 16])
@pytest.mark.parametrize("bias", [False, True])
def test_gateup_silu_quantize_matches_jax(m, bias):
    rng = np.random.default_rng(40 + m + 10 * bias)
    d, f = 256, 512
    jpw_gu, pw_gu, _ = _pack(rng, 2 * f, d, bias)
    jxa1, jgs1 = jqk.quantize_x_arc(jnp.asarray(_x(rng, m, d)),
                                    jnp.arange(d, dtype=jnp.int32), 0,
                                    kq=jpw_gu.kq, per_row=True)
    kq2 = 1024                          # an ARC-augmented down_in width
    jxa2, jgu, jgx2 = jmf.gateup_silu_quantize(jxa1, jgs1, jpw_gu, f, kq2)
    xa2, gu, gx2 = mf.gateup_silu_quantize(to_torch(jxa1), to_torch(jgs1),
                                           pw_gu, f, kq2)
    assert xa2.shape == (m, kq2) and gu.shape == (m, 2 * f)
    _close(gu, jgu)
    _check_silu_quantize(xa2, gu, gx2, f, kq2)
    assert not to_numpy(xa2)[:, f:].any()


@pytest.mark.parametrize("m,bias,f", [(4, False, 512), (9, True, 512),
                                      (16, False, 512), (4, False, 8704)])
@pytest.mark.parametrize("mode", ["quantized", "norm"])
def test_mlp_w8_fused_matches_jax(m, bias, f, mode):
    """f 8704 pads kq2 to 9216 (like Qwen2.5-7B's 18944 -> 19456): the 512
    zero columns add nothing."""
    rng = np.random.default_rng(70 + m + f + 10 * bias)
    d = 256
    jpw_gu, pw_gu, _ = _pack(rng, 2 * f, d, bias)
    jpw_dn, pw_dn, _ = _pack(rng, d, f, bias)
    x = _x(rng, m, d)
    if mode == "norm":
        nw = _norm_w(rng, d)
        xa1, gs1 = qk.rmsnorm_quantize_x(to_torch(x), to_torch(nw), EPS,
                                         torch.arange(d), 0, kq=pw_gu.kq)
        got = mf.mlp_w8_fused(to_torch(x), None, pw_gu, pw_dn, f,
                              norm_w=to_torch(nw), norm_eps=EPS)
        # the fold: bit-exact against the quantized mode fed that quantize
        for a, b in zip(got, mf.mlp_w8_fused(xa1, gs1, pw_gu, pw_dn, f)):
            assert torch.equal(a, b)
        jgot = jmf.mlp_w8_fused(jnp.asarray(x), None, jpw_gu, jpw_dn, f,
                                norm_w=jnp.asarray(nw), norm_eps=EPS)
        _, jgs1 = jqk.rmsnorm_quantize_x(jnp.asarray(x), jnp.asarray(nw),
                                         EPS, jnp.arange(d), 0,
                                         kq=jpw_gu.kq, per_row=True)
        np.testing.assert_allclose(to_numpy(gs1), np.asarray(jgs1),
                                   rtol=1e-2)
        assert jgot[0].shape == (m, d)
        jgu = jgemm.gemm_dequant(jnp.asarray(_bf16(to_numpy(xa1))), jpw_gu,
                                 jnp.asarray(to_numpy(gs1)))
    else:
        jxa1, jgs1 = jqk.quantize_x_arc(jnp.asarray(x),
                                        jnp.arange(d, dtype=jnp.int32), 0,
                                        kq=jpw_gu.kq, per_row=True)
        got = mf.mlp_w8_fused(to_torch(jxa1), to_torch(jgs1), pw_gu, pw_dn, f)
        jgot = jmf.mlp_w8_fused(jxa1, jgs1, jpw_gu, jpw_dn, f)
        jgu = jgot[1]
    out, gu, gx2 = got
    assert out.shape == (m, d) and pw_dn.kq == (9216 if f == 8704 else f)
    _close(gu, jgu)
    xa2 = qk.silu_mul_quantize_gu(gu, torch.arange(f), 0, kq=pw_dn.kq)[0]
    _check_silu_quantize(xa2, gu, gx2, f, pw_dn.kq)
    _close(out, jgemm.gemm_dequant(jnp.asarray(_bf16(to_numpy(xa2))), jpw_dn,
                                   jnp.asarray(to_numpy(gx2))))


def _gates(pw_gu, pw_dn, jpw_gu, jpw_dn, m, d, f, per_row, sel):
    """Each gate of both packages on the same case: [(port, jax), ...]."""
    return [
        (mf.gemm_actq_ok(pw_gu, m, d, per_row, sel),
         jmf.gemm_actq_ok(jpw_gu, m, d, per_row, sel)),
        (mf.gu_actq_ok(pw_gu, m, f, pw_dn.kq, per_row),
         jmf.gu_actq_ok(jpw_gu, m, f, jpw_dn.kq, per_row)),
        (mf.mlp_fused_ok(pw_gu, pw_dn, m, f, per_row, sel),
         jmf.mlp_fused_ok(jpw_gu, jpw_dn, m, f, per_row, sel)),
    ]


@pytest.mark.parametrize("limit", [16, 0])
def test_gates_agree_with_jax(limit, monkeypatch):
    """M 2, 4, 16, 32 x per-row or tensor scales x 0 or 64 ARC columns at
    down_in x w8 or w4 gateup, with the M limit at 16 and at 0 (off)."""
    rng = np.random.default_rng(5)
    d, f = 256, 512
    jpw_gu, pw_gu, _ = _pack(rng, 2 * f, d, False)
    jw4 = JP.pack_weight_arc(jnp.asarray(_bf16(outlier_x(rng, 2 * f, d))),
                             jnp.arange(d), 0, fmt="w4")
    w4 = packed_from_numpy(jw4)
    monkeypatch.setattr(mf, "MLP_FUSED_M", limit)
    monkeypatch.setenv(jmf._MLP_FUSED_M_ENV, str(limit))
    jmf.mlp_fused_dispatch_m.cache_clear()
    seen = set()
    try:
        for sel in (0, 64):
            jpw_dn, pw_dn, _ = _pack(rng, d, f, False, select=sel)
            for m in (2, 4, 16, 32):
                for per_row in (True, False):
                    for fmt in ("w8", "w4"):
                        gu = (pw_gu, jpw_gu) if fmt == "w8" else (w4, jw4)
                        for port, jax_ok in _gates(gu[0], pw_dn, gu[1],
                                                   jpw_dn, m, d, f, per_row,
                                                   sel):
                            assert port == jax_ok, (m, per_row, sel, fmt)
                            seen.add(port)
    finally:
        monkeypatch.delenv(jmf._MLP_FUSED_M_ENV)
        jmf.mlp_fused_dispatch_m.cache_clear()
    assert seen == ({True, False} if limit else {False})
