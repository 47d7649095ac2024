"""Sequence parallelism of arcquant_tpu_torch (parallel/ring.py): ring
attention and the sequence-parallel paged decode, held against the JAX
package's and against dense attention and the single-shard paged decode.

Two gloo ranks on the CPU (parallel.launch, the worker sp_run of
arcquant_tpu_torch/testing.py, which imports no JAX) run, in one spawn:
ring_attention causal and not, sp_flash_prefill, a longer context at
narrow widths, and sp_paged_decode over two pools split by token range
with a row empty on one shard. The JAX references (ring attention over
tests/conftest.py's 8-device CPU mesh, the paged decode in interpret
mode) run here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from arcquant_tpu.cache import paged as jpaged
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.kernels.paged_decode import paged_decode as jpaged_decode
from arcquant_tpu.parallel.ring import sp_flash_prefill as jsp_flash_prefill
from arcquant_tpu_torch.cache import paged
from arcquant_tpu_torch.config import get_model_config
from arcquant_tpu_torch.kernels.paged_decode import paged_decode
from arcquant_tpu_torch.parallel import launch
from arcquant_tpu_torch.testing import tp_tasks

SP = 2
CAUSAL = (True, False)
# the paged decode case of JAX's test_sp_paged_decode_parity: shard 0 owns
# tokens < 32, row 1 (23 tokens) has none on shard 1
SEQ_LENS, BOUND, TMAX, PAGE = [40, 23], 32, 48, 16


def _dense_ref(q, k, v, causal=True):
    b, t, hq, d = q.shape
    g = hq // k.shape[2]
    kk = np.repeat(np.asarray(k, np.float64), g, axis=2)
    vv = np.repeat(np.asarray(v, np.float64), g, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", np.asarray(q, np.float64),
                  kk) / math.sqrt(d)
    if causal:
        s = np.where(np.tril(np.ones((t, t), bool))[None, None], s, -np.inf)
    s -= s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


def _qkv(shape_q, shape_kv, scale=1.0):
    rng = np.random.default_rng(0)
    q = rng.standard_normal(shape_q).astype(np.float32) * scale
    k = rng.standard_normal(shape_kv).astype(np.float32) * scale
    v = rng.standard_normal(shape_kv).astype(np.float32)
    return q, k, v


def _pools():
    """The single-shard pool of JAX's test and each shard's pool of its
    own token range (local positions), from the same K/V: the JAX
    reference output and [(codes, params, page table, local lens)]."""
    cfg = jax_model_config("test-tiny")
    h, d, hq = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    rng = np.random.default_rng(10)
    k = rng.standard_normal((2, TMAX, h, d)).astype(np.float32)
    v = rng.standard_normal((2, TMAX, h, d)).astype(np.float32)
    q = rng.standard_normal((2, hq, d)).astype(np.float32)
    seq = np.asarray(SEQ_LENS, np.int32)
    ref_pt = jnp.asarray([[1, 2, 3], [4, 5, 0]], jnp.int32)
    pos = np.arange(TMAX)[None].repeat(2, 0)
    pos = np.where(pos < seq[:, None], pos, -1)
    cache = jpaged.append_kv(jpaged.init_cache(cfg, num_pages=8,
                                               page_size=PAGE), 0,
                             jnp.asarray(k), jnp.asarray(v), ref_pt,
                             jnp.asarray(pos))
    want = np.asarray(jpaged_decode(jnp.asarray(q), cache, 0, ref_pt,
                                    jnp.asarray(seq)))
    tcfg = get_model_config("test-tiny")
    pools = []
    for koff, lens in ((0, np.minimum(seq, BOUND)),
                       (BOUND, np.maximum(seq - BOUND, 0))):
        c = paged.init_cache(tcfg, 8, PAGE)
        pt = torch.tensor([[1, 2, 0], [3, 4, 0]], dtype=torch.int32)
        t = TMAX - koff
        p = np.arange(t)[None].repeat(2, 0)
        p = np.where(p < lens[:, None], p, -1)
        paged.append_kv(c, 0, torch.from_numpy(k[:, koff:]),
                        torch.from_numpy(v[:, koff:]), pt,
                        torch.from_numpy(p))
        pools.append((c.codes[0].numpy(), c.params[0].numpy(), pt.numpy(),
                      lens.astype(np.int32)))
    return q, k, v, seq, want, pools


@pytest.fixture(scope="module")
def runs():
    """The JAX references, then one spawn of two shards running both the
    test's cases (the JAX-sized one and the longer narrow one)."""
    q, k, v = _qkv((2, 512, 4, 64), (2, 512, 2, 64))
    mesh = Mesh(np.array(jax.devices()[:8]), ("sp",))
    jref = {c: np.asarray(jsp_flash_prefill(mesh, jnp.asarray(q),
                                            jnp.asarray(k), jnp.asarray(v),
                                            causal=c)) for c in CAUSAL}
    lq, lk, lv = _qkv((1, 4096, 2, 16), (1, 4096, 1, 16), 0.5)
    dq, dk, dv, seq, want, pools = _pools()
    tasks = [("sp_run", (q, k, v, CAUSAL, dq, pools)),
             ("sp_run", (lq, lk, lv, (True,), dq, pools))]
    ranks = launch(tp_tasks, SP, "gloo", cpu=True, args=(tasks,))
    return dict(q=q, k=k, v=v, jref=jref, long=(lq, lk, lv), dq=dq, dk=dk,
                dv=dv, seq=seq, want=want, pools=pools, ranks=ranks)


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_matches_dense_and_jax(runs, causal):
    """ring_attention over 2 shards, the shards' outputs in order, against
    f64 dense attention and JAX's ring attention over 8 shards (JAX's
    test_ring_matches_dense, rtol/atol 2e-5); sp_flash_prefill returns the
    whole output on every rank."""
    got = np.concatenate([r[0][("ring", causal)] for r in runs["ranks"]], 1)
    for ref in (_dense_ref(runs["q"], runs["k"], runs["v"], causal),
                runs["jref"][causal]):
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    if causal:
        for r in runs["ranks"]:
            np.testing.assert_allclose(r[0]["flash_prefill"], got, rtol=0,
                                       atol=0)


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_exchanges_counted(runs, causal):
    """ring_attention over n shards makes n - 1 exchanges (Comm.exchange),
    each a send and a recv of the K and of the V block, and no other
    collective; the payload is the blocks this rank sends."""
    for r in runs["ranks"]:
        n = len(runs["ranks"])
        rec = r[0][("ring_comm", causal)]
        assert {k: v for k, v in rec["comm"].items() if v} == {
            "send": 2 * (n - 1), "recv": 2 * (n - 1)}
        k_blk = runs["k"][:, :runs["k"].shape[1] // n]
        assert rec["comm_bytes"] == 2 * (n - 1) * k_blk.size * 4


def test_ring_longer_context(runs):
    """4096 tokens over 2 shards at narrow widths (2/1 heads of 16), in
    place of JAX's 32k-token case: rows on both shards against an exact
    single-row f64 attention (rtol/atol 3e-5)."""
    q, k, v = runs["long"]
    out = np.concatenate([r[1][("ring", True)] for r in runs["ranks"]], 1)
    assert out.shape == q.shape and np.isfinite(out).all()
    kn, vn = k[0, :, 0].astype(np.float64), v[0, :, 0].astype(np.float64)
    for pos in (0, 1000, 2047, 2048, 3000, 4095):
        for h in range(q.shape[2]):
            s = kn[:pos + 1] @ q[0, pos, h].astype(np.float64) / math.sqrt(
                q.shape[-1])
            p = np.exp(s - s.max())
            ref = (p / p.sum()) @ vn[:pos + 1]
            np.testing.assert_allclose(out[0, pos, h], ref, rtol=3e-5,
                                       atol=3e-5)


def test_sp_paged_decode_matches_single_shard(runs):
    """sp_paged_decode over two pools split by token range, row 1 empty on
    shard 1, against the single-shard paged_decode (the port's and JAX's,
    JAX's test_sp_paged_decode_parity, rtol/atol 2e-3); equal on both
    ranks; the empty row's state (out 0, m -1e30, l 0) weighs nothing; one
    all_reduce(MAX) and two all_reduce(SUM)."""
    cfg = get_model_config("test-tiny")
    cache = paged.init_cache(cfg, 8, PAGE)
    pt = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    pos = np.arange(TMAX)[None].repeat(2, 0)
    pos = np.where(pos < runs["seq"][:, None], pos, -1)
    paged.append_kv(cache, 0, torch.from_numpy(runs["dk"]),
                    torch.from_numpy(runs["dv"]), pt, torch.from_numpy(pos))
    port = paged_decode(torch.from_numpy(runs["dq"]), cache, 0, pt,
                        torch.from_numpy(runs["seq"])).numpy()
    r0, r1 = (r[0] for r in runs["ranks"])
    for ref in (port, runs["want"]):
        np.testing.assert_allclose(r0["sp_decode"], ref, rtol=2e-3,
                                   atol=2e-3)
    np.testing.assert_array_equal(r0["sp_decode"], r1["sp_decode"])
    out, m, l = r1["state"]
    assert (out[1] == 0).all() and (m[1] == -1e30).all() and (l[1] == 0).all()
    for r in (r0, r1):
        assert r["sp_collectives"] == {"all_reduce:max": 1,
                                       "all_reduce:sum": 2}
