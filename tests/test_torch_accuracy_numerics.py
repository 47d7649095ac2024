"""The accuracy path's numerics of arcquant_tpu_torch held bitwise
against the JAX package: every format's group qdq (NVFP4, MXFP4, MXFP6,
INT4), the scale and element codecs behind them, the asym KV quantizers,
the tensor-level qdq, quant/arc.py's fake-quant ARC ops, and the
per-tensor activation quantize of kernels/quantize.py (act_scale
"tensor"). Inputs are numpy-seeded: Gaussians with outlier channels at
scales from 2^-20 to 2^20, K that are not multiples of the group, and
rows built on each format's rounding midpoints (and their float
neighbours). The JAX functions run eagerly, as the accuracy path's
callers outside jit do. arc_linear_fake's f32 product is held within
rtol 1e-5 (another summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.kernels import quantize as jqk
from arcquant_tpu.quant import arc as jarc
from arcquant_tpu.quant import numerics as JN
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.quant import arc, numerics as N
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import outlier_x, to_numpy, to_torch

FORMATS = ("NVFP4", "MXFP4", "MXFP6", "INT4")
GROUP = {"NVFP4": 16, "MXFP4": 32, "MXFP6": 32, "INT4": 128}
QDQ = {"NVFP4": "nvfp4_qdq", "MXFP4": "mxfp4_qdq", "MXFP6": "mxfp6_qdq",
       "INT4": "int4_group_qdq"}


def assert_bitwise(got: torch.Tensor, want) -> None:
    """Equal values, the sign of zero included (bf16 compared as f32)."""
    got, want = to_numpy(got), np.asarray(want)
    if want.dtype.name == "bfloat16":
        want = want.astype(np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def _jnp(x):
    return jnp.asarray(x)


def _scaled_rows(rng, m, k):
    """Gaussian rows with outlier channels, each row at a random scale
    2^[-20, 20] (the MX exponents past +-12, where the reference's f32
    exp2 is not a power of two, included)."""
    return (outlier_x(rng, m, k) * np.exp2(rng.integers(-20, 21, (m, 1)))
            ).astype(np.float32)


def _midpoint_rows(rng, fmt, m, k):
    """Rows whose groups sit on the format's rounding midpoints: each
    group holds its scale-setting absmax element and elements at
    midpoint * scale (and one f32 step either side), random signs."""
    group = GROUP[fmt]
    if fmt in ("NVFP4", "MXFP4"):
        mids, top = np.array(N.E2M1_BOUNDARIES), 6.0
    elif fmt == "MXFP6":
        mids, top = np.array(N._E3M2_MIDS), 28.0
    else:
        mids, top = np.arange(7) + 0.5, 7.0
    ng = -(-k // group)
    if fmt == "NVFP4":      # a ue4m3 grid point a group
        s = to_numpy(N.quantize_ue4m3(torch.from_numpy(
            np.exp2(rng.uniform(-9, 8, (m, ng, 1))).astype(np.float32))))
    else:                   # a power of two a group
        s = np.exp2(rng.integers(-14, 15, (m, ng, 1))).astype(np.float32)
    v = (rng.choice(mids, (m, ng, group)) * s).astype(np.float32)
    step = rng.integers(-1, 2, v.shape)
    v = np.where(step < 0, np.nextafter(v, np.float32(0)),
                 np.where(step > 0, np.nextafter(v, np.float32(np.inf)), v))
    top_at = rng.integers(0, group, (m, ng))
    np.put_along_axis(v, top_at[..., None], top * s, axis=-1)
    v = v * rng.choice([-1.0, 1.0], v.shape)
    return v.reshape(m, ng * group)[:, :k].astype(np.float32)


def _inputs(rng, fmt, m, k, kind):
    return (_midpoint_rows(rng, fmt, m, k) if kind == "midpoints"
            else _scaled_rows(rng, m, k))


def test_ue8m0_every_exponent_and_powers_of_two():
    """All 255 exponents (the reference's 2^e for |e| >= 13 is XLA's f32
    exp, not a power of two) and scales within 64 f32 steps of every
    power of two from 2^-29 to 2^126, where the reference's f32 log2
    rounds ceil to either side."""
    e = np.arange(-127, 128).astype(np.float32)
    np.testing.assert_array_equal(
        np.array(N._XLA_EXP2, np.float32), np.asarray(jnp.exp2(_jnp(e))))
    pw = np.exp2(np.arange(-29, 127)).astype(np.float32)
    s = [pw]
    up = dn = pw
    for _ in range(64):
        up = np.nextafter(up, np.float32(np.inf))
        dn = np.nextafter(dn, np.float32(0))
        s += [up, dn]
    rng = np.random.default_rng(0)
    s = np.concatenate(s + [np.geomspace(1e-9, 1e36, 20000),
                            rng.random(20000) * 100, [0.0, 1e-12]]
                       ).astype(np.float32)
    assert_bitwise(N.quantize_ue8m0(torch.from_numpy(s)),
                   JN.quantize_ue8m0(_jnp(s)))


def test_e3m2_and_int4_codecs():
    mids = np.array(N._E3M2_MIDS + N._E3M2, np.float32)
    x = np.concatenate([mids, np.nextafter(mids, np.float32(0)),
                        np.nextafter(mids, np.float32(np.inf)),
                        np.linspace(-40, 40, 40001), [0.0, -0.0, 1e9]])
    x = np.concatenate([x, -x]).astype(np.float32)
    assert_bitwise(N.quantize_e3m2(torch.from_numpy(x)),
                   JN.quantize_e3m2(_jnp(x)))
    np.testing.assert_array_equal(
        np.array(N._e3m2_values(), np.float32),
        np.asarray(JN._e3m2_values()))
    h = np.concatenate([np.arange(-12, 12) + 0.5, np.linspace(-9, 9, 1001)]
                       ).astype(np.float32)
    got = N.int4_encode(torch.from_numpy(h))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(to_numpy(got), np.asarray(
        JN.int4_encode(_jnp(h))))


@pytest.mark.parametrize("k,group", [(48, 16), (100, 32), (300, 128)])
def test_group_reshape_pads_the_last_dim(k, group):
    x = np.random.default_rng(k).standard_normal((2, 3, k)).astype(np.float32)
    g, pad = N._group_reshape(torch.from_numpy(x), group)
    jg, jpad = JN._group_reshape(_jnp(x), group)
    assert pad == jpad
    assert_bitwise(g, jg)
    assert_bitwise(N._group_unshape(g, x.shape, pad),
                   JN._group_unshape(jg, x.shape, jpad))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("k", [256, 200])
@pytest.mark.parametrize("kind", ["gaussian", "midpoints"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_group_qdq(fmt, k, kind, dtype):
    """Each format's qdq (and group_qdq, its dispatch) with K a multiple
    of the group and not, in f32 and bf16."""
    rng = np.random.default_rng(k + len(fmt))
    x = _inputs(rng, fmt, 8, k, kind)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    got = getattr(N, QDQ[fmt])(to_torch(x))
    assert_bitwise(got, getattr(JN, QDQ[fmt])(_jnp(x)))
    assert_bitwise(N.group_qdq(to_torch(x), fmt),
                   JN.group_qdq(_jnp(x), fmt))


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_tensor_qdq(fmt):
    rng = np.random.default_rng(7)
    x = _scaled_rows(rng, 8, 200)
    assert_bitwise(N.quantize_tensor_qdq(torch.from_numpy(x), fmt),
                   JN.quantize_tensor_qdq(_jnp(x), fmt))
    with pytest.raises(ValueError):
        N.quantize_tensor_qdq(torch.from_numpy(x), "FP8")


@pytest.mark.parametrize("nbits,group", [(4, 64), (4, 128), (8, 64),
                                         (2, 32)])
def test_asym_int_group_qdq_and_encode(nbits, group):
    """KV fake quant at the head layouts it sees ([B, T, H, Dh]), with
    constant groups (the 1e-5 clamp) and round-half-even ties."""
    rng = np.random.default_rng(nbits * group)
    x = (rng.standard_normal((2, 5, 2, 128)) * 3).astype(np.float32)
    x[0, 0] = 1.25                      # constant groups
    x[1, 1, 0, :8] = np.arange(8) * 0.5 - 2   # ties on a 0.5 grid
    assert_bitwise(N.asym_int_group_qdq(torch.from_numpy(x), nbits, group),
                   JN.asym_int_group_qdq(_jnp(x), nbits, group))
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    assert_bitwise(N.asym_int_group_qdq(to_torch(xb), nbits, group),
                   JN.asym_int_group_qdq(_jnp(xb), nbits, group))
    codes, scale, zero = N.asym_int4_encode(torch.from_numpy(x), group)
    jc, js, jz = JN.asym_int4_encode(_jnp(x), group)
    assert codes.dtype == torch.uint8
    for got, want in ((codes, jc), (scale, js), (zero, jz)):
        assert_bitwise(got, want)


def _ridx(rng, k):
    return rng.permutation(k).astype(np.int32)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("select", [0, 64])
@pytest.mark.parametrize("kind", ["gaussian", "midpoints"])
def test_arc_quantize_x_qdq(fmt, per_row, select, kind):
    rng = np.random.default_rng(select + 3 * per_row)
    k = 256
    x = _inputs(rng, fmt, 12, k, kind)
    ridx = _ridx(rng, k)
    xa, gx = arc.arc_quantize_x_qdq(torch.from_numpy(x),
                                    torch.from_numpy(ridx), select, fmt,
                                    per_row=per_row)
    jxa, jgx = jarc.arc_quantize_x_qdq(_jnp(x), _jnp(ridx), select, fmt,
                                       per_row=per_row)
    assert xa.shape == (12, k + select)
    assert_bitwise(xa, jxa)
    assert_bitwise(gx, jgx)


def test_arc_quantize_x_qdq_gs_reduce():
    """A sharded caller's scale agreement (here: twice the scale)."""
    rng = np.random.default_rng(5)
    x = _scaled_rows(rng, 12, 256)
    ridx = _ridx(rng, 256)
    xa, gx = arc.arc_quantize_x_qdq(torch.from_numpy(x),
                                    torch.from_numpy(ridx), 64,
                                    gs_reduce=lambda g: g * 2)
    jxa, jgx = jarc.arc_quantize_x_qdq(_jnp(x), _jnp(ridx), 64,
                                       gs_reduce=lambda g: g * 2)
    assert_bitwise(xa, jxa)
    assert_bitwise(gx, jgx)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("select", [0, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_arc_quantize_w_qdq(fmt, per_channel, select, dtype):
    rng = np.random.default_rng(select + per_channel)
    k = 256
    w = _scaled_rows(rng, 40, k) * 0.05
    if dtype == "bf16":
        w = np.asarray(jnp.asarray(w, jnp.bfloat16))
    ridx = _ridx(rng, k)
    wa, gs = arc.arc_quantize_w_qdq(to_torch(w), torch.from_numpy(ridx),
                                    select, fmt, per_channel=per_channel)
    jwa, jgs = jarc.arc_quantize_w_qdq(_jnp(w), _jnp(ridx), select, fmt,
                                       per_channel=per_channel)
    assert wa.dtype == to_torch(w).dtype and wa.shape == (40, k + select)
    assert_bitwise(wa, jwa)
    assert_bitwise(gs, jgs)


def test_top_channels_and_average_bits():
    ridx = np.random.default_rng(0).permutation(256).astype(np.int32)
    for sel in (0, 64, 192):
        got = arc.top_channels(torch.from_numpy(ridx), sel)
        np.testing.assert_array_equal(
            to_numpy(got), np.asarray(jarc.top_channels(_jnp(ridx), sel)))
    for k, sel in ((3584, 448), (4096, 0), (18944, 2368)):
        assert arc.average_bits(k, sel) == jarc.average_bits(k, sel)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("per_row,per_channel", [(False, False),
                                                 (True, True)])
@pytest.mark.parametrize("bias", [False, True])
def test_arc_linear_fake(fmt, per_row, per_channel, bias):
    rng = np.random.default_rng(11)
    k, n = 256, 40
    x = outlier_x(rng, 12, k).reshape(2, 6, k)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32) if bias else None
    ridx = _ridx(rng, k)
    y = arc.arc_linear_fake(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(ridx), 64, fmt,
                            None if b is None else torch.from_numpy(b),
                            per_row=per_row, per_channel=per_channel)
    jy = jarc.arc_linear_fake(_jnp(x), _jnp(w), _jnp(ridx), 64, fmt,
                              None if b is None else _jnp(b),
                              per_row=per_row, per_channel=per_channel)
    assert y.shape == (2, 6, n)
    np.testing.assert_allclose(to_numpy(y), np.asarray(jy), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jy).max()))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


@pytest.mark.parametrize("m,k,select", [(2, 512, 0), (33, 256, 128)])
def test_quantize_per_tensor_scale(m, k, select):
    """act_scale "tensor" (per_row=False) in quantize_x_arc,
    rmsnorm_quantize_x and silu_mul_quantize_gu: one scalar scale, the
    JAX package's plain route."""
    rng = np.random.default_rng(m + k)
    x = _bf16(outlier_x(rng, m, k))
    ridx = _ridx(rng, k)
    xa, gx = qk.quantize_x_arc(to_torch(x), torch.from_numpy(ridx), select,
                               per_row=False)
    jxa, jgx = jqk.quantize_x_arc(_jnp(x), _jnp(ridx), select,
                                  per_row=False)
    assert xa.shape == (m, packing.pad_kq(k, select)) and gx.dim() == 0
    assert_bitwise(xa, jxa)
    assert_bitwise(gx, jgx)
    w = _bf16(rng.standard_normal(k) * 0.1 + 1)
    xa, gx = qk.rmsnorm_quantize_x(to_torch(x), to_torch(w), 1e-6,
                                   torch.from_numpy(ridx), select,
                                   per_row=False)
    jxa, jgx = jqk.rmsnorm_quantize_x(_jnp(x), _jnp(w), 1e-6, _jnp(ridx),
                                      select, per_row=False)
    # the rms_norm products round alike here: the same chain in both
    assert_bitwise(xa, jxa)
    assert_bitwise(gx, jgx)
    gu = _bf16(np.concatenate([outlier_x(rng, m, k, 4.0),
                               rng.standard_normal((m, k))], axis=1))
    xa, gx = qk.silu_mul_quantize_gu(to_torch(gu), torch.from_numpy(ridx),
                                     select, per_row=False)
    jxa, jgx = jqk.silu_mul_quantize_gu(_jnp(gu), _jnp(ridx), select,
                                        per_row=False)
    assert_bitwise(xa, jxa)
    assert_bitwise(gx, jgx)
