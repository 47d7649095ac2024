"""The paged decode's split plan and merge, held against the JAX package.

The CUDA kernel (csrc/paged_decode.cu) splits a row's page loop into
runs of ``decode_split_plan``'s pages_per_split and merges the runs'
softmax states. Here the plain version runs over each page run and
``merge_decode_states`` merges them; the result is held against the JAX
Pallas decode kernel (interpret mode) over the whole pool, with the
tolerances of tests/test_torch_paged.py: out one bf16 ulp (rtol 2^-7,
atol 1e-3), m 1e-5, l rtol 1e-4 (f32 sums in another order). Page 16,
GQA group 7; seq_lens with a 0 row, and splits wholly past a row's
seq_len or past every row's.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.cache import paged as jpaged
from arcquant_tpu.config import get_model_config
from arcquant_tpu.kernels.paged_decode import (
    paged_decode_state as jax_paged_decode_state)
from arcquant_tpu_torch.cache import paged
from arcquant_tpu_torch.kernels import paged_decode as pdk
from arcquant_tpu_torch.testing import to_numpy, to_torch

CFG = get_model_config("test-tiny").replace(num_heads=14, num_kv_heads=2,
                                            head_dim=128, num_layers=1)
PAGE, B, PPS = 16, 4, 6


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _case(seq_lens, seed):
    """Both pools filled with the same K/V, the page table, q, and the
    JAX decode state over the whole pool."""
    rng = np.random.default_rng(seed)
    t = PPS * PAGE
    shape = (B, t, CFG.num_kv_heads, CFG.head_dim)
    k = _bf16(rng.standard_normal(shape))
    v = _bf16(rng.standard_normal(shape))
    q = _bf16(rng.standard_normal((B, CFG.num_heads, CFG.head_dim)) * 2)
    pt = (1 + np.arange(B)[:, None] * PPS
          + np.arange(PPS)[None, :]).astype(np.int32)
    sl = np.asarray(seq_lens, np.int32)
    pos = np.broadcast_to(np.arange(t)[None], (B, t))
    pos = np.where(pos < sl[:, None], pos, -1)
    npages = 1 + B * PPS
    jc = jpaged.init_cache(CFG, npages, PAGE)
    jc = jpaged.append_kv(jc, 0, jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pt), jnp.asarray(pos))
    tc = paged.init_cache(CFG, npages, PAGE)
    paged.append_kv(tc, 0, to_torch(k), to_torch(v), torch.from_numpy(pt),
                    torch.from_numpy(pos.copy()))
    want = jax_paged_decode_state(jnp.asarray(q), jc, 0, jnp.asarray(pt),
                                  jnp.asarray(sl))
    return tc, pt, sl, q, [np.asarray(x, np.float32) for x in want]


_CASES = {}


def _cached(seq_lens, seed):
    key = (tuple(seq_lens), seed)
    if key not in _CASES:
        _CASES[key] = _case(seq_lens, seed)
    return _CASES[key]


def _split_states(tc, pt, sl, q, per):
    """The plain decode state of each run of `per` pages (f32 q, so the
    runs' outputs stay f32), as the kernel's splits see them: the run's
    slice of the page table and the row's tokens counted from its first
    page."""
    outs, ms, ls = [], [], []
    qf = to_torch(q).float()
    for p0 in range(0, PPS, per):
        run_sl = torch.clamp(torch.from_numpy(sl) - p0 * PAGE, min=0)
        o, m, l = pdk.paged_decode_state_plain(
            qf, tc.codes[0], tc.params[0],
            torch.from_numpy(pt[:, p0:p0 + per].copy()), run_sl)
        outs.append(o)
        ms.append(m)
        ls.append(l)
    return outs, ms, ls


@pytest.mark.parametrize("per", [1, 2, 4, 6])
@pytest.mark.parametrize("seq_lens,seed", [
    ([96, 0, 17, 40], 1),      # full pool, a 0 row, ragged last pages
    ([1, 50, 0, 33], 2)])      # the runs past 64 tokens empty in every row
def test_split_merge_matches_jax(per, seq_lens, seed):
    tc, pt, sl, q, (jo, jm, jl) = _cached(seq_lens, seed)
    outs, ms, ls = _split_states(tc, pt, sl, q, per)
    out, m, l = pdk.merge_decode_states(outs, ms, ls)
    assert out.dtype == m.dtype == l.dtype == torch.float32
    o = to_numpy(out.to(torch.bfloat16))
    np.testing.assert_allclose(o, jo, rtol=2.0 ** -7, atol=1e-3)
    np.testing.assert_allclose(to_numpy(m), jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_numpy(l), jl, rtol=1e-4)
    idle = sl == 0
    assert (o[idle] == 0).all() and (to_numpy(l)[idle] == 0).all()
    assert (to_numpy(m)[idle] == -1e30).all()
    empty = [s for s in range(len(ls)) if not bool((ls[s] > 0).any())]
    if per == 2 and seed == 2:
        assert empty == [2]      # tokens 64..95: past every row's seq_len


def test_merge_of_one_state_is_that_state():
    tc, pt, sl, q, _ = _cached([96, 0, 17, 40], 1)
    outs, ms, ls = _split_states(tc, pt, sl, q, PPS)
    out, m, l = pdk.merge_decode_states(outs, ms, ls)
    torch.testing.assert_close(out, outs[0], rtol=2e-7, atol=1e-7)
    assert torch.equal(m, ms[0]) and torch.equal(l, ls[0])


@pytest.mark.parametrize("b,hkv", [(1, 1), (4, 4), (4, 2), (64, 8),
                                   (300, 8)])
@pytest.mark.parametrize("pps", [0, 1, 2, 9, 64, 1000])
def test_decode_split_plan(b, hkv, pps):
    splits, per = pdk.decode_split_plan(b, hkv, pps)
    assert 1 <= splits <= max(pps, 1) and per >= 1
    owner = [p // per for p in range(pps)]     # split s takes [s*per, (s+1)*per)
    assert sorted(set(owner)) == list(range(splits if pps else 0))
    assert splits * per >= pps and (splits - 1) * per < max(pps, 1)
    if pps > 1 and b * hkv < pdk.SPLIT_BLOCKS:
        assert splits > 1


def test_decode_split_plan_reads_shapes_only():
    """The plan takes the batch, the kv heads and the page table's width,
    nothing the device holds (seq_lens): the decode step reads nothing
    back. At the smoke shape (B 4, Hkv 4, 9 pages) it is 144 one-page
    blocks."""
    assert list(inspect.signature(pdk.decode_split_plan).parameters) == [
        "b", "hkv", "pps"]
    assert pdk.decode_split_plan(4, 4, 9) == (9, 1)
    assert pdk.decode_split_plan(4, 4, 64) == (16, 4)
