"""The actq kernel's arithmetic order and its plans (csrc/actq_core.cuh,
kernels/quantize.py:actq_plan, kernels/mlp_fused.py:phase_a_blocks),
emulated in plain torch on the CPU, where the kernel cannot run:

  - the rmsnorm sum of squares in the order the kernel states (a
    function of K alone): quantize.rms_sumsq_kernel_order against a
    literal scalar loop of f32 adds, and the quantize built on it
    (quantize.actq_kernel_order) against the JAX package's Pallas actq
    kernel in interpret mode, at TestRmsnormFused's bound (under 3% of
    elements differ, each by one e2m1 step), at K 512 and 3584 on
    outlier rows; tests/test_torch_kernels_gpu.py holds the card's bits
    to the same emulation;
  - the plan: at every M of 1..16 and at 4096, at each of Qwen2.5-7B's
    widths and modes, the blocks' ranges of actq_walk cover each (row,
    16-group) exactly once, each row's scale and zero padding written
    by one block; the same for the megakernels' phase A at every grid
    their cooperative launch can take;
  - the plan is a pure function of the shapes.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest

from arcquant_tpu.kernels import quantize as jqk
from arcquant_tpu_torch.config import get_model_config
from arcquant_tpu_torch.kernels import mlp_fused as mf
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import outlier_x, to_numpy, to_torch

# Resident 256-thread blocks of the megakernels' cooperative launch on an
# H100: three on each of 132 SMs.
MAX_GRID = 396


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def sumsq_scalar_loop(row: np.ndarray) -> np.float32:
    """The header's order, one f32 add at a time."""
    f32 = np.float32
    nt, chunks = qk.ACTQ_THREADS, len(row) // 8
    lanes = []
    for t in range(nt):
        s = f32(0.0)
        for c in range(t, chunks, nt):
            for j in range(8):
                x = f32(row[8 * c + j])
                s = f32(s + f32(x * x))
        lanes.append(s)

    def butterfly(v):
        for o in (16, 8, 4, 2, 1):
            v = [f32(v[i] + v[i ^ o]) for i in range(32)]
        return v[0]
    warps = [butterfly(lanes[32 * w:32 * w + 32]) for w in range(nt // 32)]
    return butterfly(warps + [f32(0.0)] * (32 - len(warps)))


@pytest.mark.parametrize("k", [512, 3584, 4608])
def test_sumsq_emulation_is_the_stated_order(k):
    """K 4608 has a third pass (the chunks the kernel spills)."""
    rng = np.random.default_rng(k)
    x = _bf16(outlier_x(rng, 3, k, scale=8.0))
    got = to_numpy(qk.rms_sumsq_kernel_order(to_torch(x)))
    want = np.array([sumsq_scalar_loop(r) for r in x.astype(np.float32)])
    np.testing.assert_array_equal(got, want)


def assert_one_e2m1_step(a, g, ga, gg):
    """TestRmsnormFused's bound (tests/test_actq.py)."""
    a, g = np.asarray(a, np.float32), np.asarray(g, np.float32)
    assert float((a != g).mean()) < 0.03
    assert (np.abs(a - g) <= np.maximum(np.abs(a), np.abs(g)) * 1.0001
            + 1e-6).all()
    np.testing.assert_allclose(ga, gg, rtol=1e-2)


@pytest.mark.parametrize("m,k", [(8, 512), (5, 3584)])
def test_kernel_order_rmsnorm_matches_jax(m, k):
    rng = np.random.default_rng(40 + m)
    x = _bf16(outlier_x(rng, m, k, scale=6.0))
    w = _bf16(rng.standard_normal(k) * 0.1 + 1)
    kq = packing.pad_kq(k, 64)
    xa, gx = qk.actq_kernel_order(to_torch(x), to_torch(w), mode="rmsnorm",
                                  k=k, kq=kq, eps=1e-6)
    jxa, jgx = jqk._actq_pallas(jnp.asarray(x), jnp.asarray(w),
                                mode="rmsnorm", k=k, kq=kq, eps=1e-6)
    assert xa.shape == jxa.shape == (m, kq)
    assert not to_numpy(xa[:, k:]).any()
    assert_one_e2m1_step(to_numpy(xa), np.asarray(jxa, np.float32),
                         to_numpy(gx), np.asarray(jgx))


def walk(m: int, k: int, nb: int):
    """actq_walk, emulated: the (row, g0, g1) ranges of each block b of
    nb over the flattened (row, 16-group) space."""
    groups = k // 16
    total = m * groups
    out = []
    for b in range(nb):
        f0, f1 = total * b // nb, total * (b + 1) // nb
        r = f0 // groups
        while f0 < f1 and r * groups < f1:
            out.append((b, r, max(f0 - r * groups, 0),
                        min(f1 - r * groups, groups)))
            r += 1
    return out


def assert_covers_once(m: int, k: int, nb: int):
    """Each row's groups are tiled once by the ranges; the row's scale
    (g0 == 0) and zero padding (g1 == G) come from one block each."""
    groups = k // 16
    ranges = walk(m, k, nb)
    by_row = {}
    for _, r, g0, g1 in ranges:
        assert 0 <= g0 < g1 <= groups
        by_row.setdefault(r, []).append((g0, g1))
    assert sorted(by_row) == list(range(m))
    for r, spans in by_row.items():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == groups
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), r
    # a block meets one row, or more only where its range crosses a row
    assert len(ranges) <= nb + m


def _widths():
    """(K, mode) of the actq sites of Qwen2.5-7B: the hidden size in the
    plain and rmsnorm modes (attn_in, o_in with q_size = hidden, gateup
    in), the intermediate size in silu_mul and plain (down_in)."""
    cfg = get_model_config("qwen2.5-7b")
    h, f = cfg.hidden_size, cfg.intermediate_size
    assert cfg.q_size == h
    return [(h, "plain"), (h, "rmsnorm"), (f, "silu_mul"), (f, "plain")]


@pytest.mark.parametrize("k,mode", _widths())
def test_plan_covers_each_group_once(k, mode):
    for m in list(range(1, 17)) + [4096]:
        nb = qk.actq_plan(m, k, mode)
        assert m <= nb
        assert_covers_once(m, k, nb)
    # decode spreads a row over many blocks, a prefill takes one a row
    assert qk.actq_plan(4, k, mode) >= 4 * 28
    assert qk.actq_plan(4096, k, mode) == 4096


@pytest.mark.parametrize("mode", ["rmsnorm", "plain"])
def test_megakernel_phase_a_covers_each_group_once(mode):
    """rows_phase: the first min(phase_a_blocks, grid) blocks walk, at
    every grid from 1 to MAX_GRID and every M the megakernels take."""
    d = get_model_config("qwen2.5-7b").hidden_size
    for m in range(1, mf._MAX_ROWS + 1):
        want = mf.phase_a_blocks(m, d, mode)
        for grid in range(1, MAX_GRID + 1):
            assert_covers_once(m, d, min(want, grid))


def test_plans_are_functions_of_the_shapes():
    """The plans take the shapes and nothing else, and give the same
    answer whatever ran before (no state, no device query)."""
    assert list(inspect.signature(qk.actq_plan).parameters) == [
        "m", "k", "mode"]
    assert list(inspect.signature(mf.phase_a_blocks).parameters) == [
        "m", "d", "mode"]
    shapes = [(m, k, mode) for m in (1, 4, 16, 257, 4096)
              for k in (512, 3584, 18944)
              for mode in ("plain", "rmsnorm", "silu_mul")]
    first = [qk.actq_plan(*s) for s in shapes]
    assert all(isinstance(n, int) for n in first)
    assert [qk.actq_plan(*s) for s in reversed(shapes)] == first[::-1]
    assert [mf.phase_a_blocks(*s) for s in shapes] == first
    with pytest.raises(ValueError):
        qk.actq_plan(4, 3584, "tensor")
