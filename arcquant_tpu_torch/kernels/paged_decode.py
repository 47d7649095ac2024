"""Paged int4 flash-decode and flash-prefill (counterpart of
``arcquant_tpu/kernels/paged_decode.py``).

For CUDA tensors the decode entries launch ``csrc/paged_decode.cu``
(replacing the TPU kernel ``_decode_kernel``; its page loop split across
blocks by ``decode_split_plan``, the splits merged in the same call, the
rule of ``merge_decode_states``) and ``paged_prefill``
launches ``csrc/paged_prefill.cu`` (replacing ``_prefill_kernel``); for
CPU tensors they run ``paged_decode_state_plain`` and
``paged_prefill_plain``.
"""

from __future__ import annotations

import math

import torch

from ..cache.paged import PagedKVCache
from . import _build

_NEG_INF = -1e30

PAGED_DECODE = _build.Kernel("paged_decode", "arc_paged_decode", [
    _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.P, _build.P, _build.P, _build.P, _build.P, _build.I32,
    _build.I32, _build.I32, _build.I32, _build.I32, _build.I32,
    _build.I32, _build.I32, _build.F32])

# Blocks the decode kernel aims at: two waves of an H100's 132 SMs.
SPLIT_BLOCKS = 264

PAGED_PREFILL = _build.Kernel("paged_prefill", "arc_paged_prefill", [
    _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I32, _build.I32, _build.I32, _build.I32, _build.I32, _build.I32,
    _build.I32, _build.F32])


def paged_decode_state_plain(q: torch.Tensor, codes: torch.Tensor,
                             params: torch.Tensor,
                             page_table: torch.Tensor,
                             seq_lens: torch.Tensor):
    """Plain version over one layer's pool: gathers every page of the
    page table, dequantizes in score space like the kernel
    (s = (q.codes)*scale_k + (sum q)*min_k, pv = (p*scale_v).codes +
    sum(p*min_v)) and masks tokens at or past seq_len. Returns (out
    [B, Hq, Dh] in q.dtype, m [B, Hq] f32, l [B, Hq] f32); a row with
    seq_len 0 gives out 0, m -1e30, l 0."""
    b, hq, dh = q.shape
    _, _, hkv, page, _ = codes.shape
    g = hq // hkv
    pps = page_table.shape[1]
    pt = page_table.long()
    c = codes[pt]                                  # [B, pps, 2, H, pg, D/2]
    vals = torch.cat([c & 0xF, c >> 4], dim=-1).float()
    vals = vals.permute(0, 2, 3, 1, 4, 5).reshape(b, 2, hkv, pps * page, dh)
    prm = params[pt].permute(0, 2, 1, 3, 4).reshape(b, hkv, pps * page, 4)
    qf = q.float().reshape(b, hkv, g, dh) * (1.0 / math.sqrt(dh))
    qsum = qf.sum(dim=-1, keepdim=True)            # [B, H, g, 1]
    sk, mk, vs, vm = (prm[..., i][:, :, None] for i in range(4))
    s = torch.einsum("bhgd,bhtd->bhgt", qf, vals[:, 0]) * sk + qsum * mk
    tok = torch.arange(pps * page, device=q.device)
    mask = (tok[None, :] < seq_lens.long()[:, None])[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    pv = (torch.einsum("bhgt,bhtd->bhgd", p * vs, vals[:, 1])
          + (p * vm).sum(dim=-1, keepdim=True))
    out = pv / torch.clamp(l, min=1e-30)
    return (out.reshape(b, hq, dh).to(q.dtype), m.reshape(b, hq),
            l.reshape(b, hq))


def decode_split_plan(b: int, hkv: int, pps: int):
    """(splits, pages_per_split) of the decode kernel's page loop, from
    host-known shapes only (never seq_lens, so the decode step reads
    nothing back from the device): about SPLIT_BLOCKS blocks over the
    b * hkv (row, kv head) pairs, at most one split a page of the page
    table's pps, and no split wholly past pps. Split s takes pages
    [s * pages_per_split, (s + 1) * pages_per_split)."""
    if pps <= 1:
        return 1, 1
    want = min(pps, max(1, -(-SPLIT_BLOCKS // max(1, b * hkv))))
    per = -(-pps // want)
    return -(-pps // per), per


def merge_decode_states(outs, ms, ls):
    """Merge decode states over disjoint key runs, in f32: outs [S, B,
    Hq, Dh] normalized outputs, ms and ls [S, B, Hq] (sequences of S
    tensors are stacked). m = max m_s, w_s = l_s * exp(m_s - m) (exactly
    0 for an empty run, l_s = 0), l = sum w_s, out = sum w_s out_s /
    max(l, 1e-30), the rule of arcquant_tpu/parallel/ring.py. Returns
    (out [B, Hq, Dh] f32, m, l); all runs empty gives out 0, m -1e30,
    l 0."""
    outs, ms, ls = (torch.stack(list(x)).float() for x in (outs, ms, ls))
    m = ms.amax(dim=0)
    w = ls * torch.exp(ms - m)
    l = w.sum(dim=0)
    out = (outs * w[..., None]).sum(dim=0) / torch.clamp(l, min=1e-30)[
        ..., None]
    return out, m, l


def _paged_decode_cuda(q, codes, params, page_table, seq_lens):
    """Launch csrc/paged_decode.cu over one layer's pool: the split
    kernel over decode_split_plan's page runs, then (more than one split)
    the merge kernel, both from the one C call."""
    _build.require_cuda("paged_decode", q, codes, params, page_table,
                        seq_lens)
    b, hq, dh = q.shape
    _, _, hkv, page, _ = codes.shape
    g = hq // hkv
    if (q.dtype != torch.bfloat16 or hq % hkv or g > 8
            or dh not in (32, 64, 128) or page * dh // 2 % 16
            or not codes.is_contiguous() or not params.is_contiguous()
            or codes.data_ptr() % 16 or params.data_ptr() % 16):
        raise ValueError(f"paged_decode: unsupported q {tuple(q.shape)} "
                         f"{q.dtype} over pool {tuple(codes.shape)}")
    q = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    pps = pt.shape[1]
    splits, per = decode_split_plan(b, hkv, pps)
    out = torch.empty_like(q)
    m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    acc_p = m_p = l_p = None
    if splits > 1:
        acc_p = torch.empty((b, hq, splits, dh), dtype=torch.float32,
                            device=q.device)
        m_p = torch.empty((b, hq, splits), dtype=torch.float32,
                          device=q.device)
        l_p = torch.empty_like(m_p)
    PAGED_DECODE(_build.ptr(q), _build.ptr(codes), _build.ptr(params),
                 _build.ptr(pt), _build.ptr(sl), _build.ptr(out),
                 _build.ptr(m), _build.ptr(l), _build.ptr(acc_p),
                 _build.ptr(m_p), _build.ptr(l_p), b, hkv, g, dh, page,
                 pps, splits, per, 1.0 / math.sqrt(dh))
    return out, m, l


def paged_decode_state(q: torch.Tensor, cache: PagedKVCache, layer: int,
                       page_table: torch.Tensor, seq_lens: torch.Tensor):
    """One decode step of attention over the paged int4 cache, with the
    online-softmax state. q: [B, Hq, Dh] post-RoPE queries; the current
    token's K/V must already be appended; seq_lens [B] counts it.
    Returns (out [B, Hq, Dh], m [B, Hq] f32, l [B, Hq] f32)."""
    impl = (paged_decode_state_plain if q.device.type == "cpu"
            else _paged_decode_cuda)
    return impl(q, cache.codes[layer], cache.params[layer], page_table,
                seq_lens)


def paged_decode(q: torch.Tensor, cache: PagedKVCache, layer: int,
                 page_table: torch.Tensor,
                 seq_lens: torch.Tensor) -> torch.Tensor:
    """paged_decode_state without the softmax state: out [B, Hq, Dh]."""
    return paged_decode_state(q, cache, layer, page_table, seq_lens)[0]


def paged_prefill_plain(q: torch.Tensor, codes: torch.Tensor,
                        params: torch.Tensor, page_table: torch.Tensor,
                        q_starts: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    """Plain version over one layer's pool: gathers every page of the page
    table, dequantizes in score space like the kernel and masks key kpos
    for the query at qpos unless kpos <= qpos and kpos < seq_len; f32
    softmax and PV. Rows are token-major per kv head (r = i * g + j), as
    in the kernels. Returns [B, Tq, Hq, Dh] in q.dtype; a row with
    seq_len 0 gives exact zeros."""
    b, tq, hq, dh = q.shape
    _, _, hkv, page, _ = codes.shape
    g = hq // hkv
    pps = page_table.shape[1]
    pt = page_table.long()
    c = codes[pt]                                  # [B, pps, 2, H, pg, D/2]
    vals = torch.cat([c & 0xF, c >> 4], dim=-1).float()
    vals = vals.permute(0, 2, 3, 1, 4, 5).reshape(b, 2, hkv, pps * page, dh)
    prm = params[pt].permute(0, 2, 1, 3, 4).reshape(b, hkv, pps * page, 4)
    qf = (q.float().reshape(b, tq, hkv, g, dh).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, tq * g, dh) * (1.0 / math.sqrt(dh)))
    qsum = qf.sum(dim=-1, keepdim=True)            # [B, H, R, 1]
    sk, mk, vs, vm = (prm[..., i][:, :, None] for i in range(4))
    s = torch.einsum("bhrd,bhtd->bhrt", qf, vals[:, 0]) * sk + qsum * mk
    qpos = (q_starts.long()[:, None]
            + torch.arange(tq, device=q.device)[None]).repeat_interleave(
                g, dim=1)                          # [B, R]
    kpos = torch.arange(pps * page, device=q.device)
    mask = ((kpos[None, None] <= qpos[:, :, None])
            & (kpos[None, None] < seq_lens.long()[:, None, None]))[:, None]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    pv = (torch.einsum("bhrt,bhtd->bhrd", p * vs, vals[:, 1])
          + (p * vm).sum(dim=-1, keepdim=True))
    out = pv / torch.clamp(l, min=1e-30)
    return (out.reshape(b, hkv, tq, g, dh).permute(0, 2, 1, 3, 4)
            .reshape(b, tq, hq, dh).to(q.dtype))


def _paged_prefill_cuda(q, codes, params, page_table, q_starts, seq_lens):
    """Launch csrc/paged_prefill.cu over one layer's pool."""
    _build.require_cuda("paged_prefill", q, codes, params, page_table,
                        q_starts, seq_lens)
    b, tq, hq, dh = q.shape
    _, _, hkv, page, _ = codes.shape
    g = hq // hkv
    if (q.dtype != torch.bfloat16 or hq % hkv or g > 64 or dh not in (64, 128)
            or not codes.is_contiguous() or not params.is_contiguous()
            or codes.data_ptr() % 16 or params.data_ptr() % 16):
        raise ValueError(f"paged_prefill: unsupported q {tuple(q.shape)} "
                         f"{q.dtype} over pool {tuple(codes.shape)}")
    q = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    st = q_starts.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    PAGED_PREFILL(_build.ptr(q), _build.ptr(codes), _build.ptr(params),
                  _build.ptr(pt), _build.ptr(st), _build.ptr(sl),
                  _build.ptr(out), b, tq, hkv, g, dh, page, pt.shape[1],
                  1.0 / math.sqrt(dh))
    return out


def paged_prefill(q: torch.Tensor, cache: PagedKVCache, layer: int,
                  page_table: torch.Tensor, q_starts: torch.Tensor,
                  seq_lens: torch.Tensor) -> torch.Tensor:
    """Causal attention of a prefill chunk straight over the int4 pool;
    the chunk's own K/V must already be appended.

    q: [B, Tq, Hq, Dh] post-RoPE queries (rows right-padded); page_table
    [B, pps] i32; q_starts [B] i32, the absolute position of q[:, 0] per
    row; seq_lens [B] i32, tokens in cache including this chunk's.
    Returns [B, Tq, Hq, Dh] in q.dtype. Queries at positions >= seq_len
    are padding, which the caller discards: the plain version gives them
    the JAX kernel's keys < seq_len, the CUDA kernel the same within a
    query tile that starts before seq_len and zeros past it."""
    impl = (paged_prefill_plain if q.device.type == "cpu"
            else _paged_prefill_cuda)
    return impl(q, cache.codes[layer], cache.params[layer], page_table,
                q_starts, seq_lens)
