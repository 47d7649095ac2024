"""The arithmetic order of the tensor-core paged prefill
(``csrc/paged_prefill.cu``), emulated in plain torch on the CPU and held
to the JAX paged prefill (its Pallas ``_prefill_kernel`` in interpret
mode, as tests/test_torch_paged_prefill.py runs it) and to the port's
``paged_prefill_plain``.

The emulation follows the kernel step for step: query tiles of 64 // G
tokens times the G heads of a kv head (rows r = i * G + j), keys
[0, min(seq, last qpos of the tile + 1)) in 64-key tiles and none for a
tile that starts at or past seq; S = bf16 q times the K codes with f32
sums, then s = S * sm_scale * scale_k + qsum * min_k with qsum =
sum(q * sm_scale) in f32; online softmax per 64-key tile; O += (p *
scale_v) . codes_v with p * scale_v split into bf16 hi + lo, and
sum(p * min_v) beside it; out = (O + sum) / max(l, 1e-30) in bf16.

Bar (the kernel's on the card, chip_smoke.py's paged_prefill_check): one
bf16 ulp (rtol 2^-7) + 2e-3 on every query at a position < seq; rows
with seq 0 exactly 0. Cases: G 7 at Dh 128 and G 2 at Dh 64, pages of 16
under a 64-key tile (four pages a tile), G 1 at Dh 128 (Qwen1.5-MoE's
16/16 heads), queries crossing a key tile's diagonal, Tq not a multiple
of the query tile, an idle row.
"""

import math

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

PAGE, TK = 16, 80
ROWS, KEYS = 64, 64   # the kernel's score rows a block and keys a tile


def _bf(t):
    return t.to(torch.bfloat16).float()


def emulate_mma_prefill(q, codes, params, pt, starts, seqs):
    """The kernel's arithmetic in plain torch (f32), one query tile and
    one 64-key tile at a time. q: [B, Tq, Hq, Dh] bf16; codes/params one
    layer's pool. Returns [B, Tq, Hq, Dh] bf16; rows of a tile that starts
    at or past seq are 0."""
    b_, tq, hq, dh = q.shape
    _, _, hkv, page, _ = codes.shape
    g = hq // hkv
    bq = ROWS // g
    sm = 1.0 / math.sqrt(dh)
    out = torch.zeros((b_, tq, hq, dh), dtype=torch.float32)
    for b in range(b_):
        seq, start = int(seqs[b]), int(starts[b])
        for h in range(hkv):
            for t0 in range(0, tq, bq):
                toks = torch.arange(t0, min(t0 + bq, tq))
                qpos0 = start + t0
                limit = 0 if qpos0 >= seq else min(seq, qpos0 + bq)
                if limit == 0:
                    continue
                # rows token-major: [tokens, G heads, Dh]
                qt = q[b, toks, h * g:(h + 1) * g].float().reshape(-1, dh)
                qp = (qpos0 + torch.arange(len(toks))).repeat_interleave(g)
                qsum = (qt * sm).sum(-1, keepdim=True)
                m = torch.full((qt.shape[0], 1), -1e30)
                l = torch.zeros_like(m)
                vsum = torch.zeros_like(m)
                o = torch.zeros_like(qt)
                for k0 in range(0, limit, KEYS):
                    kpos = torch.arange(k0, k0 + KEYS)
                    ok = kpos < limit
                    kp = torch.where(ok, kpos, 0)
                    pid = pt[b, kp // page].long()
                    c = codes[pid, :, h, kp % page]           # [64, 2, Dh/2]
                    vals = torch.cat([c & 0xF, c >> 4], -1).float()
                    vals = torch.where(ok[:, None, None], vals, 0.0)
                    prm = torch.where(ok[:, None],
                                      params[pid, h, kp % page], 0.0)
                    s = ((qt @ vals[:, 0].T) * sm) * prm[:, 0] \
                        + qsum * prm[:, 1]
                    mask = (kpos[None] <= qp[:, None]) & (kpos[None] < seq)
                    s = torch.where(mask, s, torch.full_like(s, -1e30))
                    mn = torch.maximum(m, s.amax(-1, keepdim=True))
                    alpha = torch.exp(m - mn)
                    p = torch.exp(s - mn)
                    ps = p * prm[:, 2]
                    hi = _bf(ps)
                    lo = _bf(ps - hi)
                    o = o * alpha + hi @ vals[:, 1] + lo @ vals[:, 1]
                    l = l * alpha + p.sum(-1, keepdim=True)
                    vsum = vsum * alpha + (p * prm[:, 3]).sum(-1, keepdim=True)
                    m = mn
                res = (o + vsum) / torch.clamp(l, min=1e-30)
                out[b, toks, h * g:(h + 1) * g] = res.reshape(len(toks), g, dh)
    return out.to(torch.bfloat16)


# (model, config overrides, Tq, q_starts, seq_lens)
CASES = [
    # G 7, Dh 128: Tq 20 is not a multiple of bq 9; a later chunk whose
    # diagonal crosses the 64-key tile; an idle row
    ("test-tiny", dict(num_heads=14, num_kv_heads=2, head_dim=128), 20,
     [40, 0, 0], [60, 17, 0]),
    # G 2, Dh 64, bq 32: ragged starts as under prefix sharing
    ("test-tiny", {}, 40, [16, 4, 0], [56, 44, 0]),
    # G 1, Dh 128 (the MoE's 16/16 heads), bq 64: 70 keys span two tiles
    ("test-tiny", dict(num_heads=2, num_kv_heads=2, head_dim=128), 24,
     [50, 0], [70, 24]),
]


def _pools(name, cfg_kw, tq, starts, seq_lens, seed):
    """The same bf16 K/V appended into the JAX and the port's pools, and
    bf16 q: (JAX out, port cache, q, page table, starts, seqs)."""
    jcfg = jax_model_config(name).replace(**cfg_kw)
    cfg = get_model_config(name).replace(**cfg_kw)
    b = len(starts)
    h, d = cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(seed)

    def bf16(x):
        return np.asarray(jnp.asarray(x, jnp.bfloat16))
    k = bf16(rng.standard_normal((b, TK, h, d)) * 2)
    v = bf16(rng.standard_normal((b, TK, h, d)))
    q = bf16(rng.standard_normal((b, tq, cfg.num_heads, d)) * 2)
    pps = TK // PAGE
    # rows own scattered pages, in reverse order; page 0 is the sink
    pt = (b * pps - np.arange(b * pps).reshape(b, pps)).astype(np.int32)
    sl = np.asarray(seq_lens, np.int32)
    st = np.asarray(starts, np.int32)
    pos = np.broadcast_to(np.arange(TK)[None], (b, TK))
    pos = np.where(pos < sl[:, None], pos, -1).astype(np.int32)
    jc = jpaged.init_cache(jcfg, 1 + b * pps, PAGE)
    jc = jpaged.append_kv(jc, 0, jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pt), jnp.asarray(pos))
    want = jax_prefill(jnp.asarray(q), jc, 0, jnp.asarray(pt),
                       jnp.asarray(st), jnp.asarray(sl))
    tc = paged.init_cache(cfg, 1 + b * pps, PAGE, "cpu")
    paged.append_kv(tc, 0, to_torch(k), to_torch(v), torch.from_numpy(pt),
                    torch.from_numpy(pos))
    return (np.asarray(want, np.float64), tc, to_torch(q),
            torch.from_numpy(pt), torch.from_numpy(st), torch.from_numpy(sl))


@pytest.mark.parametrize("name,cfg_kw,tq,starts,seq_lens", CASES)
def test_mma_order_matches_jax_and_plain(name, cfg_kw, tq, starts, seq_lens):
    want, tc, q, pt, st, sl = _pools(name, cfg_kw, tq, starts, seq_lens,
                                     seed=tq)
    args = (q, tc.codes[0], tc.params[0], pt, st, sl)
    got = emulate_mma_prefill(*args)
    plain = pdk.paged_prefill_plain(*args)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    got = to_numpy(got).astype(np.float64)
    live = to_numpy(st[:, None] + torch.arange(tq)[None] < sl[:, None])
    for ref in (want, to_numpy(plain).astype(np.float64)):
        np.testing.assert_allclose(got[live], ref[live], rtol=2.0 ** -7,
                                   atol=2e-3)
    assert (got[to_numpy(sl) == 0] == 0).all()
    assert np.isfinite(got).all()


def test_mma_order_zeros_tiles_past_seq():
    """A query tile that starts at or past seq walks no keys and gives
    exact zeros (the plain version gives its padded rows keys < seq)."""
    _, tc, q, pt, st, sl = _pools(*CASES[1], seed=5)
    got = emulate_mma_prefill(q, tc.codes[0], tc.params[0], pt, st, sl)
    g = q.shape[2] // tc.codes[0].shape[2]
    bq = ROWS // g
    for b in range(q.shape[0]):
        for t0 in range(0, q.shape[1], bq):
            if int(st[b]) + t0 >= int(sl[b]):
                assert (got[b, t0:t0 + bq] == 0).all()
