"""Activation quantize (kernels/quantize.py) of arcquant_tpu_torch held
against the JAX package, which runs its Pallas actq kernel in interpret
mode here. Plain and silu_mul are bit-exact; rmsnorm carries the JAX
package's own TestRmsnormFused bound (the variance sum and rsqrt differ
by ulps between implementations, so boundary elements may move by one
e2m1 step). The CUDA kernel is held against its plain version on the
card by tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.kernels import quantize as jqk
from arcquant_tpu.models import llama as jllama
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import outlier_x, to_numpy, to_torch


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _ridx(rng, k):
    return rng.permutation(k).astype(np.int32)


def assert_one_e2m1_step(a, g, ga, gg):
    """TestRmsnormFused's bound: < 3% of elements differ, each by at most
    one grid step (<= max(|a|, |g|)), and gx within 1%."""
    a, g = np.asarray(a, np.float32), np.asarray(g, np.float32)
    assert float((a != g).mean()) < 0.03
    assert (np.abs(a - g) <= np.maximum(np.abs(a), np.abs(g)) * 1.0001
            + 1e-6).all()
    np.testing.assert_allclose(ga, gg, rtol=1e-2)


@pytest.mark.parametrize("m", [2, 4, 33, 520])
@pytest.mark.parametrize("select", [0, 64])
def test_quantize_x_arc_bit_exact(m, select):
    rng = np.random.default_rng(m + select)
    k = 512
    x = _bf16(outlier_x(rng, m, k))
    ridx = _ridx(rng, k)
    xa, gx = qk.quantize_x_arc(to_torch(x), torch.from_numpy(ridx), select)
    jxa, jgx = jqk.quantize_x_arc(jnp.asarray(x), jnp.asarray(ridx), select,
                                  per_row=True)
    assert xa.shape == (m, packing.pad_kq(k, select)) == jxa.shape
    np.testing.assert_array_equal(to_numpy(xa), np.asarray(jxa, np.float32))
    np.testing.assert_array_equal(to_numpy(gx), np.asarray(jgx))


@pytest.mark.parametrize("m,select", [(4, 0), (33, 0), (8, 64), (300, 64)])
def test_rmsnorm_quantize_x(m, select):
    rng = np.random.default_rng(10 + m)
    k = 512
    x = _bf16(outlier_x(rng, m, k))
    w = _bf16(rng.standard_normal(k) * 0.1 + 1)
    ridx = _ridx(rng, k)
    xa, gx = qk.rmsnorm_quantize_x(to_torch(x), to_torch(w), 1e-6,
                                   torch.from_numpy(ridx), select)
    jxa, jgx = jqk.rmsnorm_quantize_x(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                      jnp.asarray(ridx), select,
                                      per_row=True)
    assert xa.shape == jxa.shape
    assert_one_e2m1_step(to_numpy(xa), np.asarray(jxa, np.float32),
                         to_numpy(gx), np.asarray(jgx))


def test_rms_norm_chain_matches():
    """The rounding chain itself (f32 normalise, round, bf16 * w): equal
    up to one bf16 ulp from the rsqrt and sum order."""
    from arcquant_tpu_torch.models import llama
    rng = np.random.default_rng(3)
    x = _bf16(rng.standard_normal((16, 256)) * 3)
    w = _bf16(rng.standard_normal(256) * 0.1 + 1)
    got = to_numpy(llama.rms_norm(to_torch(x), to_torch(w), 1e-5))
    want = np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
                      np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("select", [0, 64])
def test_silu_mul_quantize_gu_bit_exact(m, select):
    """The JAX package takes its defused route (XLA silu*mul, then the
    plain quantize) at m = 8 and its silu_mul kernel mode at m = 40; the
    port takes its silu_mul mode at both."""
    rng = np.random.default_rng(20 + m + select)
    f = 512
    gu = _bf16(outlier_x(rng, m, 2 * f, scale=4.0))
    ridx = _ridx(rng, f)
    xa, gx = qk.silu_mul_quantize_gu(to_torch(gu), torch.from_numpy(ridx),
                                     select)
    jxa, jgx = jqk.silu_mul_quantize_gu(jnp.asarray(gu), jnp.asarray(ridx),
                                        select, per_row=True)
    np.testing.assert_array_equal(to_numpy(xa), np.asarray(jxa, np.float32))
    np.testing.assert_array_equal(to_numpy(gx), np.asarray(jgx))


def test_zero_rows_and_tensor_scale():
    xa, gx = qk.quantize_x_arc(torch.zeros((4, 256), dtype=torch.bfloat16),
                               torch.arange(256), 64)
    assert float(xa.abs().max()) == 0.0
    assert bool((gx == 1e-12).all())
    with pytest.raises(NotImplementedError, match="tensor"):
        qk.quantize_x_arc(torch.zeros((4, 256)), torch.arange(256), 0,
                          per_row=False)
