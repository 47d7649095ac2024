"""w8 dequant GEMM (counterpart of ``arcquant_tpu/kernels/gemm.py``).

``gemm_dequant`` computes y = (xa @ dec(W)) * gx[m] * gw[n] + bias with
f32 accumulation, then casts. For CUDA tensors it launches
``csrc/gemm_w8.cu`` (replacing the TPU kernels ``_gemm_w8_kernel`` and
``_gemm_w8_dma_kernel``) at every M; for CPU tensors it runs
``gemm_w8_plain``.

The JAX package sends prefill GEMMs with M >= 512 and n >= kq to a
dequant pass plus XLA's matmul instead. The numerics are the same: the
decoded weight and xa are exact in bf16, so only the f32 summation
order differs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant import numerics as N
from ..quant.packing import PackedWeightI8
from . import _build

GEMM_W8 = _build.Kernel("gemm_w8", "arc_gemm_w8", [
    _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.P, _build.P, _build.I32, _build.P,
    _build.I32, _build.I32, _build.I32, _build.I32, _build.I32,
    _build.I32])

_BK = 32
_SMALL_M = 64          # M at or below this takes the 32-row tile
_TARGET_BLOCKS = 264   # about two blocks per SM of an H100
_MIN_SPLIT_TILES = 16  # k-tiles (of 32) per split at least


def gemm_w8_plain(xa: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor, gs: torch.Tensor,
                  gw: torch.Tensor, bias: Optional[torch.Tensor],
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the w8 GEMM. gs: [M, 1] f32, gw: [1, N] f32."""
    s = N.ue4m3_from_bytes(scales) * 0.5
    w = (codes.float() * s.repeat_interleave(N.NVFP4_GROUP, dim=0))
    acc = xa.to(torch.bfloat16).float() @ w
    y = acc * gs * gw
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def _split_plan(m: int, n: int, kq: int):
    """(small_m, splits, k-tiles per split) for the CUDA kernel."""
    small = m <= _SMALL_M
    bm = 32 if small else 128
    blocks = -(-n // 128) * -(-m // bm)
    k_tiles = kq // _BK
    splits = 1
    if small:
        splits = max(1, min(-(-_TARGET_BLOCKS // blocks),
                            k_tiles // _MIN_SPLIT_TILES))
    per = -(-k_tiles // splits)
    return small, -(-k_tiles // per), per


def _gemm_w8_cuda(xa, codes, scales, gs, gw, bias, out_dtype):
    """Launch csrc/gemm_w8.cu. gs: [M, 1] f32; gw: [1, N] f32."""
    _build.require_cuda("gemm_w8", xa, codes, scales, gs, gw, bias)
    m, kq = xa.shape
    n = codes.shape[1]
    if (xa.dtype != torch.bfloat16 or codes.dtype != torch.int8
            or scales.dtype != torch.uint8 or codes.shape[0] != kq
            or scales.shape != (kq // 16, n) or kq % _BK
            or out_dtype not in (torch.bfloat16, torch.float32)
            or (bias is not None and bias.dtype != torch.bfloat16)):
        raise ValueError(
            f"gemm_w8: unsupported operands xa {tuple(xa.shape)} "
            f"{xa.dtype}, codes {tuple(codes.shape)} {codes.dtype}, "
            f"out {out_dtype}")
    xa = xa.contiguous()
    codes, scales = codes.contiguous(), scales.contiguous()
    gs = gs.reshape(-1).float().contiguous()
    gw = gw.reshape(-1).float().contiguous()
    bias = bias.contiguous() if bias is not None else None
    out = torch.empty((m, n), dtype=out_dtype, device=xa.device)
    small, splits, per = _split_plan(m, n, kq)
    ws = (torch.empty((splits, m, n), dtype=torch.float32,
                      device=xa.device) if splits > 1 else None)
    GEMM_W8(_build.ptr(xa), _build.ptr(codes), _build.ptr(scales),
            _build.ptr(gs), _build.ptr(gw), _build.ptr(bias), _build.ptr(out),
            int(out_dtype == torch.float32), _build.ptr(ws),
            m, n, kq, int(small), splits, per)
    return out


def gemm_dequant(xa: torch.Tensor, pw: PackedWeightI8, gx,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y[M, N] = (xa @ dec(pw)) * (gx * pw.global_scale) + pw.bias.

    xa: [M, Kq] bf16 in scaled units (Kq == pw.kq); gx: the activation
    global scale, a float, a scalar tensor or [M, 1]."""
    if not isinstance(pw, PackedWeightI8):
        raise NotImplementedError(
            "only the w8 weight format is ported (ROADMAP queue 1 item "
            "11, w4 end to end)")
    m, n = xa.shape[0], pw.n
    if isinstance(gx, (int, float)):     # a fill, no host-to-device copy
        gs = torch.full((m, 1), float(gx), dtype=torch.float32,
                        device=xa.device)
    else:
        gs = torch.as_tensor(gx, dtype=torch.float32, device=xa.device)
        gs = gs.reshape(-1, 1).expand(m, 1)
    gw = pw.global_scale.float().reshape(1, -1).expand(1, n)
    impl = gemm_w8_plain if xa.device.type == "cpu" else _gemm_w8_cuda
    return impl(xa, pw.codes, pw.scales, gs, gw, pw.bias, out_dtype)
