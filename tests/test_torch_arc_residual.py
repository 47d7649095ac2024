"""#18 arc_residual (kernels/quantize.py) on the CPU.

- ``arc_residual_plain`` against the JAX package's ``_arc_residual_into``
  bit for bit, in both modes: "plain" takes the selected columns of x
  (JAX's ``quantize_x_arc``), "silu_mul" recomputes silu(g) * u of them
  from the unsliced gate-up output, rounded to bf16 (JAX's column
  recompute in ``silu_mul_quantize_gu``). The inputs
  (testing.arc_residual_case) plant the residual's err on e2m1
  boundaries and ties, ue4m3 subnormal scales, all-zero groups with
  -0.0, bf16 neighbours of the boundaries and random rows.
- XLA on the CPU flushes subnormal f32 results to zero; the port, like
  torch on the card, keeps them: silu(g) for g near -88 (a subnormal
  sigmoid) is the one place where the two residuals part, and only
  there.
- The wrapper on CPU tensors is the plain version, and
  ``quantize_x_arc`` and ``silu_mul_quantize_gu`` equal the chain they
  ran before #18 (the row quantize, then the take and
  ``_arc_residual_into``), with an int32 and an int64 index.
- The launch wrapper's checks, each raise exercised, and the arguments
  it hands the kernel (the index tail read in place, no copy) with the
  launch stubbed; the kernel itself runs on the card
  (tests/test_torch_kernels_gpu.py -k arc_residual).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.kernels import quantize as jqk
from arcquant_tpu_torch.kernels import _build
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import (ARC_SENTINEL, arc_residual_case,
                                        outlier_x, to_numpy, to_torch)


def _bits(a) -> np.ndarray:
    """bf16 values (as f32, exact) -> their bf16 bit patterns."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy()


def _jax_residual(src, xa, gx, ridx, ke, k, mode):
    """JAX's residual: the take (quantize_x_arc) or the column recompute
    (silu_mul_quantize_gu), then _arc_residual_into."""
    idx = jnp.asarray(ridx)[-ke:].astype(jnp.int32)
    s = jnp.asarray(src, jnp.bfloat16)
    if mode == "plain":
        cols = jnp.take(s, idx, axis=1)
    else:
        g = jnp.take(s, idx, axis=1).astype(jnp.float32)
        u = jnp.take(s, idx + k, axis=1).astype(jnp.float32)
        cols = (jax.nn.silu(g) * u).astype(jnp.bfloat16)
    out = jqk._arc_residual_into(cols, jnp.asarray(xa, jnp.bfloat16),
                                 jnp.asarray(gx), idx, k)
    return np.asarray(out.astype(jnp.float32))


def _port_residual(src, xa, gx, ridx, ke, k, mode, idx_dtype=torch.int32):
    xa_t = to_torch(xa).to(torch.bfloat16)
    out = qk.arc_residual_plain(to_torch(src).to(torch.bfloat16), xa_t,
                                torch.from_numpy(gx),
                                torch.from_numpy(ridx).to(idx_dtype), ke, k,
                                mode)
    assert out is xa_t
    return to_numpy(out)


@pytest.mark.parametrize("mode", ["plain", "silu_mul"])
@pytest.mark.parametrize("m", [1, 4, 33])
@pytest.mark.parametrize("k,ke", [(256, 64), (512, 128)])
def test_arc_residual_plain_matches_jax(k, ke, m, mode):
    rng = np.random.default_rng(k + ke + 7 * m + (mode == "plain"))
    src, xa, gx, ridx = arc_residual_case(rng, m, k, ke, mode)
    got = _port_residual(src, xa, gx, ridx, ke, k, mode)
    want = _jax_residual(src, xa, gx, ridx, ke, k, mode)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the residual columns written, the rest of xa as it was
    np.testing.assert_array_equal(_bits(got[:, :k]), _bits(xa[:, :k]))
    assert (got[:, k + ke:] == ARC_SENTINEL).all()
    assert not np.array_equal(_bits(got[:, k:k + ke]),
                              _bits(xa[:, k:k + ke]))


def test_arc_residual_case_plants_what_it_says():
    """arc_residual_case's planted rows: each group's scale is its s
    (its max is 6 s), the boundary groups hold exact ties, and -0.0 is
    in."""
    rng = np.random.default_rng(3)
    m, k, ke = 6, 256, 160
    src, xa, gx, ridx = arc_residual_case(rng, m, k, ke)
    cols = ridx[k - ke:]
    err = src[:, cols] / gx - xa[:, cols]
    planted = err[np.arange(m) % 3 != 2].reshape(-1, 16)
    amax = np.abs(planted).max(axis=1)
    ties = np.isin(np.abs(planted) / (amax[:, None] / 6 + 1e-30),
                   [0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0])
    assert ties.sum() > 20
    assert (amax[amax > 0] < 2.0 ** -6 * 6).any()       # subnormal scales
    assert np.signbit(err[(err == 0)]).any() and (amax == 0).any()
    # the quantized residual of an all-zero group: +0 (JAX's and the
    # port's where(g < 0) on -0.0)
    got = _port_residual(src, xa, gx, ridx, ke, k, "plain")
    zero = np.repeat((np.abs(err).reshape(m, -1, 16).max(-1) == 0), 16,
                     axis=1)
    assert not np.signbit(got[:, k:k + ke][zero]).any()


def test_silu_subnormals_are_the_one_departure_from_jax():
    """Gate values whose f32 sigmoid (or product) is subnormal: XLA on
    the CPU flushes them to zero, the port keeps them (as torch on the
    card does, and as #18 must: the kernel equals the torch chain). The
    residuals agree bit for bit on every column where no silu
    intermediate is subnormal, and part only on columns where one is."""
    rng = np.random.default_rng(5)
    m, k, ke = 4, 256, 256
    src, xa, gx, ridx = arc_residual_case(rng, m, k, ke, "silu_mul")
    cols = ridx[k - ke:]
    g = np.linspace(-95, -80, m * ke).reshape(m, ke).astype(np.float32)
    src[:, cols] = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    src[:, cols + k] = 1.0
    xa[:, cols] = 0.0
    gx[:] = 1.0
    got = _port_residual(src, xa, gx, ridx, ke, k, "silu_mul")
    want = _jax_residual(src, xa, gx, ridx, ke, k, "silu_mul")
    gb = torch.from_numpy(src[:, cols])
    sig = torch.sigmoid(gb)
    sub = ((sig != 0) & (sig.abs() < 2.0 ** -126)) | (
        ((gb * sig) != 0) & ((gb * sig).abs() < 2.0 ** -126))
    got, want = got[:, k:k + ke], want[:, k:k + ke]
    differ = _bits(got) != _bits(want)
    assert differ.any() and sub.any()
    # a differing residual element lies in a group with a subnormal
    groups = sub.numpy().reshape(m, -1, 16).any(-1).repeat(16, axis=1)
    assert not (differ & ~groups).any()
    np.testing.assert_array_equal(_bits(got[~groups]),
                                  _bits(want[~groups]))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("m", [1, 4, 33])
def test_wrappers_equal_the_chain_before(m, idx_dtype):
    """arc_residual on CPU tensors is arc_residual_plain; quantize_x_arc
    and silu_mul_quantize_gu give the bits of the chain they ran before
    #18: the row quantize (actq_plain), then _top, the take (or
    _silu_mul of the taken columns) and _arc_residual_into."""
    rng = np.random.default_rng(40 + m)
    k, ke = 512, 128
    kq = packing.pad_kq(k, ke)
    ridx = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(
        idx_dtype)
    x = to_torch(outlier_x(rng, m, k)).to(torch.bfloat16)
    gu = to_torch(outlier_x(rng, m, 2 * k, scale=4.0)).to(torch.bfloat16)
    for src, mode, fn in ((x, "plain", qk.quantize_x_arc),
                          (gu, "silu_mul", qk.silu_mul_quantize_gu)):
        xa0, gx0 = qk.actq_plain(src, None, mode=mode, k=k, kq=kq)
        idx = ridx[-ke:].long()
        cols = (src[:, idx] if mode == "plain"
                else qk._silu_mul(src[:, idx], src[:, idx + k]))
        want = qk._arc_residual_into(cols, xa0.clone(), gx0, idx, k)
        xa, gx = fn(src, ridx, ke)
        assert torch.equal(gx, gx0)
        assert torch.equal(xa.view(torch.int16), want.view(torch.int16))
        got = qk.arc_residual(src, xa0.clone(), gx0, ridx, ke, k, mode)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


class _Launch:
    """A stand-in for the kernel's launch: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, m=None):
        self.calls.append((args, m))


@pytest.fixture
def stubbed(monkeypatch):
    """_arc_residual_cuda with the device check and the launch stubbed,
    so its layout checks run on CPU tensors."""
    launch = _Launch()
    monkeypatch.setattr(_build, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(qk, "ARC_RESIDUAL", launch)
    return launch


def _args(m=4, k=256, ke=64, mode="plain", idx_dtype=torch.int32):
    src = torch.zeros((m, 2 * k if mode == "silu_mul" else k),
                      dtype=torch.bfloat16)
    xa = torch.zeros((m, packing.pad_kq(k, ke)), dtype=torch.bfloat16)
    gx = torch.ones((m, 1), dtype=torch.float32)
    ridx = torch.randperm(k, generator=torch.Generator().manual_seed(0)).to(
        idx_dtype)
    return [src, xa, gx, ridx, ke, k, mode]


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("mode", ["plain", "silu_mul"])
def test_launch_reads_the_index_tail_in_place(stubbed, mode, idx_dtype):
    a = _args(mode=mode, idx_dtype=idx_dtype)
    src, xa, gx, ridx, ke, k, _ = a
    assert qk._arc_residual_cuda(*a) is xa
    (args, m), = stubbed.calls
    assert m == 4
    assert args == (src.data_ptr(), src.stride(0), xa.data_ptr(),
                    xa.stride(0), gx.data_ptr(), 1,
                    ridx.data_ptr() + (k - ke) * ridx.element_size(),
                    int(idx_dtype == torch.int64), 4, k, ke,
                    {"plain": 0, "silu_mul": 2}[mode])
    # a strided src row (a view into a wider buffer) is taken as it is
    wide = torch.zeros((4, src.shape[1] + 64), dtype=torch.bfloat16)
    a[0] = wide[:, :src.shape[1]]
    qk._arc_residual_cuda(*a)
    assert stubbed.calls[-1][0][1] == src.shape[1] + 64


def _bad(case):
    a = _args(mode="silu_mul" if case == "silu_narrow" else "plain")
    if case == "mode":
        a[6] = "rmsnorm"
    elif case == "src_dtype":
        a[0] = a[0].float()
    elif case == "xa_dtype":
        a[1] = a[1].float()
    elif case == "gx_dtype":
        a[2] = a[2].double()
    elif case == "gx_shape":
        a[2] = a[2].reshape(-1)
    elif case == "ke_16":
        a[4] = 72
    elif case == "ke_negative":
        a[4] = -16
    elif case == "past_kq":
        a[1] = a[1][:, :a[5] + a[4] - 16]
    elif case == "rows":
        a[1] = a[1][:3]
    elif case == "silu_narrow":
        a[0] = a[0][:, :a[5] * 2 - 16]
    elif case == "src_columns":
        a[0] = a[0].t().contiguous().t()
    elif case == "xa_columns":
        a[1] = a[1].t().contiguous().t()
    elif case == "index_strided":
        a[3] = torch.cat([a[3], a[3]])[::2]
    elif case == "index_dtype":
        a[3] = a[3].to(torch.int16)
    elif case == "index_short":
        a[3] = a[3][:a[4] - 16]
    return a


@pytest.mark.parametrize("case", [
    "mode", "src_dtype", "xa_dtype", "gx_dtype", "gx_shape", "ke_16",
    "ke_negative", "past_kq", "rows", "silu_narrow", "src_columns",
    "xa_columns", "index_strided", "index_dtype", "index_short"])
def test_launch_raises_on_what_the_kernel_does_not_take(stubbed, case):
    with pytest.raises(ValueError, match="arc_residual"):
        qk._arc_residual_cuda(*_bad(case))
    assert stubbed.calls == []


def test_launch_raises_off_the_card_and_never_falls_back(monkeypatch):
    """Without the stub a CPU tensor (the index on the host) raises in the
    launch wrapper: it never runs the plain version."""
    monkeypatch.setattr(qk, "arc_residual_plain", None)
    with pytest.raises(ValueError, match="arc_residual: expected CUDA"):
        qk._arc_residual_cuda(*_args())


def test_plain_version_raises_on_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        qk.arc_residual_plain(*_args()[:6], "rmsnorm")
