"""arcquant_tpu_torch/evals/visualize.py held against the JAX package's
evals/visualize.py on the same numpy inputs: the Hadamard transform
(whole and blockwise) within 1e-6, measure_mse (K 512, where the
Hadamard scheme runs, and K 384, where it does not; select 0, 64 and
128) and mse_evolution within 1e-6 relative with the same keys; then
the JAX tests' properties on the port alone (the involution, ARC below
plain NVFP4 on outliers, a monotone evolution) and both plots rendered
to non-empty PNGs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.evals import visualize as jvis
from arcquant_tpu_torch.evals import visualize as vis
from arcquant_tpu_torch.testing import outlier_x, to_numpy


def _inputs(seed, m, k):
    """Outlier activations and the identity channel order, as numpy."""
    x = outlier_x(np.random.default_rng(seed), m, k)
    return x, np.arange(k, dtype=np.int32)


@pytest.mark.parametrize("block", [None, 64])
def test_hadamard_matches_jax(block):
    x = np.random.default_rng(0).standard_normal((8, 256)).astype(np.float32)
    got = to_numpy(vis.hadamard_transform(torch.from_numpy(x), block))
    want = np.asarray(jvis.hadamard_transform(jnp.asarray(x), block))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [512, 384])
@pytest.mark.parametrize("select", [0, 64, 128])
def test_measure_mse_matches_jax(k, select):
    x, ridx = _inputs(k + select, 32, k)
    got = vis.measure_mse(torch.from_numpy(x), torch.from_numpy(ridx), select)
    want = jvis.measure_mse(jnp.asarray(x), jnp.asarray(ridx), select)
    assert set(got) == set(want)
    assert ("hadamard" in got) == (k == 512)
    for scheme, v in want.items():
        np.testing.assert_allclose(got[scheme], v, rtol=1e-6, err_msg=scheme)


def test_mse_evolution_matches_jax():
    x, ridx = _inputs(3, 32, 512)
    ks = [0, 64, 128, 256]
    got = vis.mse_evolution(torch.from_numpy(x), torch.from_numpy(ridx), ks)
    want = jvis.mse_evolution(jnp.asarray(x), jnp.asarray(ridx), ks)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("block", [None, 64])
def test_hadamard_involution(block):
    x = torch.randn((8, 256), generator=torch.Generator().manual_seed(0))
    back = vis.hadamard_transform(vis.hadamard_transform(x, block), block)
    torch.testing.assert_close(back, x, rtol=1e-5, atol=1e-5)


def test_arc_below_plain_nvfp4_on_outliers_and_monotone():
    x, ridx = _inputs(2, 64, 512)
    x, ridx = torch.from_numpy(x), torch.from_numpy(ridx)
    m = vis.measure_mse(x, ridx, 128)
    assert m["arc"] < m["nvfp4"], m
    ev = vis.mse_evolution(x, ridx, [0, 64, 256])
    assert ev[2] < ev[1] < ev[0], ev


def test_plots_render(tmp_path):
    x, ridx = _inputs(4, 16, 128)
    x, ridx = torch.from_numpy(x), torch.from_numpy(ridx)
    p1, p2 = tmp_path / "mse.png", tmp_path / "chan.png"
    vis.plot_layer_mse([vis.measure_mse(x, ridx, 64) for _ in range(2)],
                       str(p1))
    vis.plot_channel_error(x, str(p2))
    for p in (p1, p2):
        assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert p.stat().st_size > 1000
