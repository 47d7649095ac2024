"""Paged int4 flash-prefill of arcquant_tpu_torch held against the JAX
package: ``paged_prefill`` (CPU tensors: ``paged_prefill_plain``) against
the JAX ``paged_prefill`` (its Pallas ``_prefill_kernel`` in interpret
mode), after the same K/V are appended into each package's own pool.

Cases: the four (q_starts, seq_lens) of the JAX package's
tests/test_cache.py::test_paged_prefill_parity (first chunk with ragged
lengths, a later chunk, ragged per-row starts as under prefix sharing,
an idle row) on test-tiny (GQA group 2, Dh 64, page 16), and Qwen2.5-7B's
GQA group 7 with Dh 128, all at Tq 20. Tolerance: f32 q within 1e-5
abs/rel on every row with seq > 0, padded query rows included (both
kernels give them the same semantics: keys < seq); idle rows exactly 0;
bf16 q within one bf16 ulp of the value plus 1e-5 of the row's largest
magnitude (the two differ in f32 summation order only, which near zero
outweighs the value's own ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.cache import paged as jpaged
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.kernels.paged_decode import paged_prefill as jax_prefill
from arcquant_tpu_torch.cache import paged
from arcquant_tpu_torch.config import get_model_config
from arcquant_tpu_torch.kernels import paged_decode as pdk
from arcquant_tpu_torch.testing import to_numpy, to_torch

PAGE, TQ, TK, NPAGES = 16, 20, 48, 8
PT = np.asarray([[1, 2, 3, 0], [4, 5, 6, 0], [7, 0, 0, 0]], np.int32)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _bf16_ulp(x):
    """One bf16 ulp of |x| (2^(e - 7) for |x| in [2^e, 2^(e+1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _run(name, cfg_kw, starts, seq_lens, q_dtype, seed=7):
    """(port out, JAX out) of one prefill chunk over both pools."""
    jcfg = jax_model_config(name).replace(**cfg_kw)
    cfg = get_model_config(name).replace(**cfg_kw)
    b = len(starts)
    h, d = cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, TK, h, d)).astype(np.float32)
    v = rng.standard_normal((b, TK, h, d)).astype(np.float32)
    q = rng.standard_normal((b, TQ, cfg.num_heads, d)).astype(np.float32)
    if q_dtype == "bf16":
        k, v, q = _bf16(k), _bf16(v), _bf16(q)
    sl = np.asarray(seq_lens, np.int32)
    st = np.asarray(starts, np.int32)
    pt = PT[:b]
    pos = np.broadcast_to(np.arange(TK)[None], (b, TK))
    pos = np.where(pos < sl[:, None], pos, -1).astype(np.int32)

    jc = jpaged.init_cache(jcfg, NPAGES, PAGE)
    jc = jpaged.append_kv(jc, 0, jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pt), jnp.asarray(pos))
    want = jax_prefill(jnp.asarray(q), jc, 0, jnp.asarray(pt),
                       jnp.asarray(st), jnp.asarray(sl))

    tc = paged.init_cache(cfg, NPAGES, PAGE, "cpu")
    paged.append_kv(tc, 0, to_torch(k), to_torch(v), torch.from_numpy(pt),
                    torch.from_numpy(pos))
    got = pdk.paged_prefill(to_torch(q), tc, 0, torch.from_numpy(pt),
                            torch.from_numpy(st), torch.from_numpy(sl))
    assert got.shape == tuple(q.shape) and got.dtype == to_torch(q).dtype
    return to_numpy(got).astype(np.float64), np.asarray(want, np.float64), sl


CASES = [
    ("test-tiny", {}, [0, 0], [12, 20]),          # first chunk, ragged
    ("test-tiny", {}, [16, 16], [36, 29]),        # later chunk
    ("test-tiny", {}, [16, 4], [36, 24]),         # ragged per-row starts
    ("test-tiny", {}, [0, 0], [20, 0]),           # idle row
    ("test-tiny", dict(num_heads=14, num_kv_heads=2, head_dim=128),
     [16, 4, 0], [36, 24, 0]),                    # g = 7, Dh = 128
]


@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,cfg_kw,starts,seq_lens", CASES)
def test_paged_prefill_matches_jax(name, cfg_kw, starts, seq_lens, q_dtype):
    got, want, sl = _run(name, cfg_kw, starts, seq_lens, q_dtype)
    live = sl > 0
    assert (got[~live] == 0).all()
    if q_dtype == "f32":
        np.testing.assert_allclose(got[live], want[live], rtol=1e-5,
                                   atol=1e-5)
    else:
        bound = (_bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
                 + 1e-5 * np.abs(want).max(axis=-1, keepdims=True))
        assert (np.abs(got - want)[live] <= bound[live]).all(), float(
            np.abs(got - want)[live].max())


def test_paged_prefill_reads_only_mapped_pages():
    """Unmapped page-table entries are the sink 0: filling the sink page
    with garbage changes nothing."""
    name, cfg_kw, starts, seq_lens = CASES[2]
    cfg = get_model_config(name)
    rng = np.random.default_rng(3)
    k = to_torch(rng.standard_normal((2, TK, 2, 64)).astype(np.float32))
    v = to_torch(rng.standard_normal((2, TK, 2, 64)).astype(np.float32))
    q = to_torch(rng.standard_normal((2, TQ, 4, 64)).astype(np.float32))
    sl = torch.tensor(seq_lens, dtype=torch.int32)
    st = torch.tensor(starts, dtype=torch.int32)
    pt = torch.from_numpy(PT[:2])
    pos = torch.arange(TK)[None].expand(2, TK)
    pos = torch.where(pos < sl[:, None].long(), pos, -1)
    tc = paged.init_cache(cfg, NPAGES, PAGE, "cpu")
    paged.append_kv(tc, 0, k, v, pt, pos)
    a = pdk.paged_prefill(q, tc, 0, pt, st, sl)
    tc.codes[0][0] = 0xAB
    tc.params[0][0] = 1e6
    b = pdk.paged_prefill(q, tc, 0, pt, st, sl)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
