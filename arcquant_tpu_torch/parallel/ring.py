"""Sequence parallelism on ``torch.distributed``: ring attention and the
sequence-parallel paged decode (counterpart of
``arcquant_tpu/parallel/ring.py``).

Ring attention: the sequence dim of Q, K and V is split over the sp
ranks, shard i holding tokens [i * T/n, (i + 1) * T/n). The K/V blocks
rotate around the ring (rank i sends its block to i + 1 and receives
i - 1's: one ``batch_isend_irecv`` a step, ``Comm.exchange``) while
every rank accumulates the online-softmax state (m, l, acc) of its own
queries, so the full T x T attention is exact with T/n-sized blocks and
n - 1 exchanges.
Causal masking is by global position: a block from after the local
queries contributes weight exactly 0. JAX writes it in plain jnp; its
counterpart here is plain torch ops in f32.

Sequence-parallel paged decode: the paged int4 pool shards by page
ownership, shard i's pool holding the pages of its token range of each
row; each shard runs the paged decode kernel (#10, ``paged_decode_state``)
over its own pages, emitting (out, m, l), and the exact output is the
(m, l)-weighted merge: one all_reduce(MAX) of m and two all_reduce(SUM),
of the weights and of the weighted outputs. A shard with no tokens of a
row (m = -1e30, l = 0) weighs exactly 0.
"""

from __future__ import annotations

import math

import torch

from ..kernels.paged_decode import paged_decode_state
from .mesh import SPContext

_NEG_INF = -1e30


def _block_attn(q, k, v, q_pos0: int, k_pos0: int, sm_scale: float,
                causal: bool):
    """Unnormalized f32 block attention with the global-position causal
    mask. q [B, Tq, Hq, D], k/v [B, Tk, Hkv, D] (Hq % Hkv == 0). Returns
    (acc [B, Tq, Hq, D], m [B, Tq, Hq] row max, l [B, Tq, Hq] sum of
    exp); a fully masked row has m -1e30, l 0, acc 0."""
    b, tq, hq, d = q.shape
    g = hq // k.shape[2]
    kk = k.float().repeat_interleave(g, dim=2)
    vv = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * sm_scale
    if causal:
        qpos = q_pos0 + torch.arange(tq, device=q.device)
        kpos = k_pos0 + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)                                    # [B, H, Tq]
    p = torch.exp(s - m[..., None])
    p = torch.where((m == _NEG_INF)[..., None], torch.zeros_like(p), p)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    return acc, m.transpose(1, 2), l.transpose(1, 2)


@torch.no_grad()
def ring_attention(q, k, v, ctx: SPContext, causal: bool = True,
                   out_dtype=None) -> torch.Tensor:
    """Exact attention over sequence-sharded q/k/v: each rank passes its
    shard's [B, T/n, ...] slice (rank i: tokens [i * T/n, (i + 1) * T/n))
    and gets its [B, T/n, Hq, D] output."""
    n, i = ctx.sp, ctx.shard
    b, t_l, hq, d = q.shape
    sm_scale = 1.0 / math.sqrt(d)
    m = torch.full((b, t_l, hq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, t_l, hq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, t_l, hq, d), dtype=torch.float32, device=q.device)
    k_blk, v_blk, src = k, v, i
    for step in range(n):
        a_b, m_b, l_b = _block_attn(q, k_blk, v_blk, i * t_l, src * t_l,
                                    sm_scale, causal)
        m_new = torch.maximum(m, m_b)
        # a fully masked side weighs exactly 0
        alpha = torch.where(m == _NEG_INF, torch.zeros_like(m),
                            torch.exp(m - m_new))
        beta = torch.where(m_b == _NEG_INF, torch.zeros_like(m_b),
                           torch.exp(m_b - m_new))
        acc = acc * alpha[..., None] + a_b * beta[..., None]
        l = l * alpha + l_b * beta
        m = m_new
        if step < n - 1:
            k_blk, v_blk = ctx.comms().exchange((k_blk, v_blk), ctx.next,
                                                ctx.prev)
            src = (src - 1) % n
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(out_dtype or q.dtype)


def _merge_states(out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  ctx: SPContext, dtype) -> torch.Tensor:
    """The exact merge of the shards' decode states: out [B, Hq, D]
    normalized over the shard's keys, m and l [B, Hq]. One
    all_reduce(MAX), two all_reduce(SUM)."""
    comm = ctx.comms()
    m_g = comm.all_reduce(m.float().clone(), "max")
    # an empty shard carries (m=-1e30, l=0): its weight is exactly 0
    w = l.float() * torch.where(m == _NEG_INF, torch.zeros_like(m_g),
                                torch.exp(m.float() - m_g))
    denom = comm.all_reduce(w.clone(), "sum")
    num = comm.all_reduce((out.float() * w[..., None]).contiguous(), "sum")
    return (num / torch.clamp(denom, min=1e-30)[..., None]).to(dtype)


def sp_paged_decode(q, cache, layer: int, pt_local, local_lens,
                    ctx: SPContext) -> torch.Tensor:
    """Sequence-parallel paged int4 flash-decode: this shard's pool holds
    the pages of its token range of each row, pt_local / local_lens
    describe only those (local pages, local token counts). The shard
    runs paged_decode_state (#10 on the card, its plain version on the
    CPU) over its own pages and the states merge exactly (_merge_states).
    q [B, Hq, Dh], the same on every shard; returns the same, equal on
    every shard."""
    out, m, l = paged_decode_state(q, cache, layer, pt_local, local_lens)
    return _merge_states(out, m, l, ctx, q.dtype)


def sp_flash_prefill(ctx: SPContext, q, k, v, causal: bool = True):
    """ring_attention on whole [B, T, H, D] arrays (T % sp == 0, the same
    on every rank): each rank takes its T/sp slice, and the output's
    slices are gathered back (one all_gather), [B, T, Hq, D] on every
    rank."""
    n, i = ctx.sp, ctx.shard
    t_l = q.shape[1] // n
    sl = slice(i * t_l, (i + 1) * t_l)
    out = ring_attention(q[:, sl], k[:, sl], v[:, sl], ctx, causal)
    # gather along the sequence: rank-major on dim 0, then back to dim 1
    parts = ctx.comms().all_gather(out.transpose(0, 1).contiguous())
    return parts.transpose(0, 1).contiguous()
