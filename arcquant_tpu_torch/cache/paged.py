"""Paged int4 KV cache (counterpart of ``arcquant_tpu/cache/paged.py``).

Numerics are the JAX package's: per-token-per-head asymmetric int4 over
the head dim, scale = max(max - min, 1e-5) / 15, q = round((x - min) /
scale) with ties to even, dequant q * scale + min, and split-half
nibble packing (byte d holds dim d in the low nibble and d + Dh/2 in the
high nibble).

The layout is GPU-natural, with the token dim before the packed head dim
so a token's codes are one contiguous row:
  codes  : uint8 [P, 2, Hkv, page, Dh/2]   (axis 1: 0 = K, 1 = V)
  params : f32   [P, Hkv, page, 4]         (scale_k, min_k, scale_v, min_v)
one pair of tensors per layer. Page 0 is the sink: positions < 0 are
written there and never read (no page table of a live row maps it).

The pool is preallocated once; ``append_kv`` writes into it in place
(advanced-index assignment, i.e. ``index_put_``), which takes the place
of the JAX package's buffer donation.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..config import KV_PAGE_SIZE, ModelConfig


class PagedKVCache(NamedTuple):
    """Per-layer page pools (lists of tensors, updated in place)."""
    codes: List[torch.Tensor]    # L x uint8 [P, 2, Hkv, page, Dh/2]
    params: List[torch.Tensor]   # L x f32   [P, Hkv, page, 4]

    @property
    def page_size(self) -> int:
        return self.codes[0].shape[3]


def init_cache(cfg: ModelConfig, num_pages: int,
               page_size: int = KV_PAGE_SIZE,
               device="cpu") -> PagedKVCache:
    """Allocate the zeroed page pool on `device`."""
    h, d = cfg.num_kv_heads, cfg.head_dim
    if d % 2:
        raise ValueError(f"head_dim {d} must be even")
    codes = [torch.zeros((num_pages, 2, h, page_size, d // 2),
                         dtype=torch.uint8, device=device)
             for _ in range(cfg.num_layers)]
    params = [torch.zeros((num_pages, h, page_size, 4),
                          dtype=torch.float32, device=device)
              for _ in range(cfg.num_layers)]
    return PagedKVCache(codes, params)


def quantize_kv(x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asym int4 over the last (head) dim. x: [..., Dh]. Returns (codes
    uint8 [..., Dh/2] split-half packed, scale f32 [...], min f32 [...])."""
    d = x.shape[-1]
    xf = x.float()
    xmax = xf.amax(dim=-1)
    xmin = xf.amin(dim=-1)
    # divided by a tensor: on a CUDA tensor a Python scalar divisor makes
    # PyTorch multiply by its f32 reciprocal, which gives another f32 than
    # the quotient on most rows; the JAX package and the kernels divide
    scale = torch.clamp(xmax - xmin, min=1e-5) / xmax.new_full((), 15.0)
    q = torch.clamp(torch.round((xf - xmin[..., None]) / scale[..., None]),
                    0.0, 15.0).to(torch.uint8)
    return q[..., :d // 2] | (q[..., d // 2:] << 4), scale, xmin


def unpack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Split-half unpack: uint8 [..., Dh/2] -> uint8 [..., Dh]."""
    return torch.cat([codes & 0xF, codes >> 4], dim=-1)


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  minv: torch.Tensor) -> torch.Tensor:
    return (unpack_codes(codes).float() * scale[..., None]
            + minv[..., None])


def append_kv(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
              v_new: torch.Tensor, page_table: torch.Tensor,
              positions: torch.Tensor) -> PagedKVCache:
    """Quantize new K/V tokens and write them into the pool in place.

    k_new/v_new: [B, T, Hkv, Dh] post-RoPE K and V; page_table:
    [B, pages_per_seq] i32; positions: [B, T] absolute positions
    (entries < 0 go to the sink page 0)."""
    ps = cache.page_size
    valid = positions >= 0
    safe = positions.clamp(min=0).long()
    pidx = torch.gather(page_table.long(), 1, safe // ps)
    pidx = torch.where(valid, pidx, torch.zeros_like(pidx))
    offs = safe % ps
    kc, ks, km = quantize_kv(k_new)            # [B,T,H,D/2], [B,T,H]
    vc, vs, vm = quantize_kv(v_new)
    codes, params = cache.codes[layer], cache.params[layer]
    codes[pidx, 0, :, offs] = kc
    codes[pidx, 1, :, offs] = vc
    params[pidx, :, offs] = torch.stack([ks, km, vs, vm], dim=-1)
    return cache


def gather_kv(cache: PagedKVCache, layer: int, page_table: torch.Tensor,
              max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantize the first max_len tokens of each row back to dense
    [B, max_len, Hkv, Dh] f32 K and V (tests only)."""
    ps = cache.page_size
    npp = -(-max_len // ps)
    pids = page_table[:, :npp].long()
    c = cache.codes[layer][pids]              # [B, npp, 2, H, ps, D/2]
    p = cache.params[layer][pids]             # [B, npp, H, ps, 4]

    def one(kv):
        x = dequantize_kv(c[:, :, kv], p[..., 2 * kv], p[..., 2 * kv + 1])
        b, _, h, _, d = x.shape               # [B, npp, H, ps, D]
        x = x.permute(0, 1, 3, 2, 4).reshape(b, npp * ps, h, d)
        return x[:, :max_len]

    return one(0), one(1)
