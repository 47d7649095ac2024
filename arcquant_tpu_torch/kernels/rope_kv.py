"""RoPE on q and k and the int4 K/V quantize-append into the paged pool,
fused into one kernel a layer (#17 rope_kv).

The JAX package runs ``arcquant_tpu/models/llama.py`` apply_rope and
``arcquant_tpu/cache/paged.py`` append_kv (with its quantize_kv) inside
one jitted step, where XLA fuses them; there is no pallas_call. For
CUDA tensors ``rope_append_kv`` launches ``csrc/rope_kv.cu``, the port's
counterpart of that fusion; for CPU tensors it runs
``rope_append_kv_plain``, the two functions one after the other. Both
write the pool in place and return (q_rot, k_rot), bit for bit alike on
the pool's pages >= 1: the kernel skips a position < 0, which the plain
version writes into the sink page 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..cache import paged
from ..cache.paged import PagedKVCache
from ..models import llama
from . import _build

ROPE_KV = _build.Kernel("rope_kv", "arc_rope_kv", [
    *[_build.P] * 11, *[_build.I32] * 7, *[_build.I64] * 6])

MAX_HEAD_DIM = 256


def rope_append_kv_plain(q, k, v, cos, sin, cache: PagedKVCache,
                         layer: int, page_table, positions):
    """Plain version: llama.apply_rope, then paged.append_kv of the
    rotated K and of V. Returns (q_rot, k_rot)."""
    q_rot, k_rot = llama.apply_rope(q, k, cos, sin)
    paged.append_kv(cache, layer, k_rot, v, page_table, positions)
    return q_rot, k_rot


def _row_strides(name, x, b, t, h, dh):
    """(batch, token) strides of x, a bf16 [B, T, H, Dh] view whose heads
    are contiguous at Dh and whose rows start 16-byte aligned, the layout
    of the qkv GEMM output's column views."""
    if (tuple(x.shape) != (b, t, h, dh) or x.dtype != torch.bfloat16
            or x.stride(3) != 1 or (h > 1 and x.stride(2) != dh)
            or x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16):
        raise ValueError(f"rope_kv: {name} {tuple(x.shape)} {x.dtype} "
                         f"strides {x.stride()}: expected bf16 [{b}, {t}, "
                         f"{h}, {dh}] with contiguous heads and 16-byte "
                         "aligned rows")
    return x.stride(0), x.stride(1)


def _rope_kv_cuda(q, k, v, cos, sin, cache: PagedKVCache, layer: int,
                  page_table, positions):
    """Launch csrc/rope_kv.cu on one layer's pool; q, k, v are read in
    place (strided views of the qkv output). A position past the page
    table is a device-side assert."""
    codes, params = cache.codes[layer], cache.params[layer]
    _build.require_cuda("rope_kv", q, k, v, cos, sin, codes, params,
                        page_table, positions)
    b, t, hq, dh = q.shape
    hkv = k.shape[2]
    page = codes.shape[3]
    if (dh % 16 or dh > MAX_HEAD_DIM or hq % hkv
            or tuple(codes.shape[1:]) != (2, hkv, page, dh // 2)
            or tuple(params.shape[1:]) != (hkv, page, 4)
            or not codes.is_contiguous() or not params.is_contiguous()
            or codes.data_ptr() % 16 or params.data_ptr() % 16
            or positions.dtype != torch.int64
            or tuple(positions.shape) != (b, t)):
        raise ValueError(f"rope_kv: unsupported q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, pool {tuple(codes.shape)}, "
                         f"positions {tuple(positions.shape)} "
                         f"{positions.dtype}")
    strides = [s for name, x, h in (("q", q, hq), ("k", k, hkv),
                                    ("v", v, hkv))
               for s in _row_strides(name, x, b, t, h, dh)]
    if (cos.dtype != torch.float32 or sin.dtype != torch.float32
            or tuple(cos.shape) != (b, t, dh) or sin.shape != cos.shape):
        raise ValueError(f"rope_kv: cos/sin {tuple(cos.shape)} {cos.dtype}"
                         f" for q {tuple(q.shape)}: expected f32 [B, T, Dh]")
    cos, sin = cos.contiguous(), sin.contiguous()
    pt = page_table
    if pt.dtype != torch.int32 or not pt.is_contiguous():
        pt = pt.to(torch.int32).contiguous()
    pos = positions.contiguous()
    q_out = torch.empty((b, t, hq, dh), dtype=q.dtype, device=q.device)
    k_out = torch.empty((b, t, hkv, dh), dtype=q.dtype, device=q.device)
    ROPE_KV(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(cos),
            _build.ptr(sin), _build.ptr(q_out), _build.ptr(k_out),
            _build.ptr(codes), _build.ptr(params), _build.ptr(pt),
            _build.ptr(pos), b, t, hq, hkv, dh, page, pt.shape[1], *strides)
    return q_out, k_out


def rope_append_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor,
                   cache: PagedKVCache, layer: int,
                   page_table: torch.Tensor, positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE on q [B, T, Hq, Dh] and k [B, T, Hkv, Dh] (cos, sin f32 [B,
    T, Dh]), then K (rotated and rounded) and V [B, T, Hkv, Dh] quantized
    to int4 and written into the pool's layer `layer` at `positions` [B,
    T] through `page_table` [B, pps]; entries < 0 are not written (the
    plain version routes them to the sink page 0), an entry past the
    page table is an error in both. Returns (q_rot, k_rot) in q's dtype
    (bf16 on the card)."""
    impl = (rope_append_kv_plain if q.device.type == "cpu"
            else _rope_kv_cuda)
    return impl(q, k, v, cos, sin, cache, layer, page_table, positions)
