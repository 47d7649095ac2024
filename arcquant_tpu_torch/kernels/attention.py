"""Causal GQA flash attention (counterpart of
``arcquant_tpu/kernels/attention.py``).

For CUDA tensors ``flash_attention`` launches ``csrc/flash_attn.cu``
(replacing the TPU kernel ``_flash_kernel``); for CPU tensors it runs
``flash_attention_plain``. Layout [B, T, H, Dh] as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG_INF = -1e30

FLASH = _build.Kernel("flash_attn", "arc_flash_attention", [
    _build.P, _build.P, _build.P, _build.P,
    _build.I32, _build.I32, _build.I32, _build.I32, _build.I32, _build.I32,
    _build.P, _build.I32, _build.F32])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, q_offset: int = 0) -> torch.Tensor:
    """Plain version: f32 scores with q pre-scaled by 1/sqrt(Dh), the
    kernel's causal mask (query i sees keys j <= i + q_offset), softmax,
    f32 PV, cast to q.dtype."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float() * (1.0 / math.sqrt(dh))
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    q_ids = torch.arange(tq, device=q.device)[:, None] + q_offset
    k_ids = torch.arange(tk, device=q.device)[None, :]
    s = torch.where(q_ids >= k_ids, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _flash_cuda(q, k, v, q_offset: int = 0) -> torch.Tensor:
    """Launch csrc/flash_attn.cu. The head and dim axes must be
    contiguous; batch and token strides are free multiples of 8 (q/k/v
    may be views of the fused qkv output) and each base pointer is
    16-byte aligned, as the kernel's cp.async copies need."""
    _build.require_cuda("flash_attention", q, k, v)
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    for t in (q, k, v):
        if (t.dtype != torch.bfloat16 or t.stride(3) != 1
                or t.stride(2) != dh or t.stride(1) % 8 or t.stride(0) % 8):
            raise ValueError("flash_attention kernel takes bf16 [B,T,H,Dh] "
                             f"with contiguous heads, got {t.dtype} "
                             f"strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs 16-byte aligned "
                             "q/k/v (cp.async), got a tensor at "
                             f"{t.data_ptr():#x}")
    if dh not in (64, 128) or hq % hkv or q_offset < 0:
        raise ValueError(f"flash_attention: Dh={dh} Hq={hq} Hkv={hkv} "
                         f"q_offset={q_offset}")
    o = torch.empty((b, tq, hq, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 8)(q.stride(0), q.stride(1), k.stride(0),
                                   k.stride(1), v.stride(0), v.stride(1),
                                   o.stride(0), o.stride(1))
    FLASH(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
          b, tq, tk, hq, hkv, dh, ctypes.addressof(strides), q_offset,
          1.0 / math.sqrt(dh))
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal flash attention with implicit GQA.

    q: [B, Tq, Hq, Dh]; k/v: [B, Tk, Hkv, Dh], Hq % Hkv == 0; q_offset
    is the absolute position of q[:, 0] in the kv sequence. Returns
    [B, Tq, Hq, Dh]."""
    impl = flash_attention_plain if q.device.type == "cpu" else _flash_cuda
    return impl(q, k, v, q_offset)
