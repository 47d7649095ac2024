"""Packed weight storage (counterpart of
``arcquant_tpu/quant/packing.py``), in the JAX package's two formats,
the same bytes:

  w8 (PackedWeightI8), 8.5 bits a weight:
    codes  : int8 [Kq, N]  — 2 x e2m1 value ("mag2", {0, ±1, .., ±12}),
                             K-major so the GEMM reads [bk, bn] tiles
  w4 (PackedWeight), 4.5 bits a weight:
    codes  : uint8 [Kq/2, N] — byte g of column n holds the e2m1x codes
                             of k = 2g (low nibble) and k = 2g+1 (high)
  both:
    scales : uint8 [Kq/16, N] — ue4m3 bytes of the per-16 group scale
    global : f32 scalar or [N] (per output channel)

e2m1x is e2m1 with the magnitude codes 0 and 1 swapped (sign kept), so
that a nonzero code decodes as the f32 bits ((mag << 22) | sign << 31)
+ 0x3F000000 and only mag == 1 (zero) needs a select.

Kq = K + KE padded (see ``pad_kq``): rows [K, K+KE) duplicate the ARC
outlier columns, the rest are pad groups whose scale byte is 0 so they
contribute exactly nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import numerics as N

# Kq is padded so every k-block of the GEMM grid is full.
K_PAD_MULTIPLE = 512

# 2 x e2m1 magnitude per 3-bit magnitude code
_MAG2_TABLE = (0, 1, 2, 3, 4, 6, 8, 12)


class PackedWeight(NamedTuple):
    """A quantized, packed linear weight in the w4 format. A stack of
    experts' weights carries a leading axis E on codes, scales and the
    global scale ([E, Kq/2, N], [E, Kq/16, N], [E, N]); kq and n are then
    one expert's."""
    codes: torch.Tensor          # uint8 e2m1x nibble pairs [Kq/2, N]
    scales: torch.Tensor         # uint8 ue4m3 bytes [Kq/16, N]
    global_scale: torch.Tensor   # f32 scalar or [N]
    bias: Optional[torch.Tensor]  # [N] or None

    @property
    def kq(self) -> int:
        return self.codes.shape[-2] * 2

    @property
    def n(self) -> int:
        return self.codes.shape[-1]


class PackedWeightI8(NamedTuple):
    """A quantized, packed linear weight in the w8 format (stacked as
    PackedWeight is: codes [E, Kq, N])."""
    codes: torch.Tensor          # int8 [Kq, N]
    scales: torch.Tensor         # uint8 ue4m3 bytes [Kq/16, N]
    global_scale: torch.Tensor   # f32 scalar or [N]
    bias: Optional[torch.Tensor]  # [N] or None

    @property
    def kq(self) -> int:
        return self.codes.shape[-2]

    @property
    def n(self) -> int:
        return self.codes.shape[-1]


def codes_to_mag2_i8(codes: torch.Tensor) -> torch.Tensor:
    """e2m1 codes (uint8 0..15) -> signed mag2 int8 in {0, ±1, .., ±12}."""
    mag = N._const(_MAG2_TABLE, torch.int8, codes.device)[(codes & 7).long()]
    return torch.where((codes & 8) != 0, -mag, mag)


def e2m1_to_e2m1x(codes: torch.Tensor) -> torch.Tensor:
    """e2m1 codes -> the w4 storage order e2m1x: magnitude codes 0 and 1
    swapped, sign kept. An involution, so also e2m1x -> e2m1."""
    return torch.where((codes & 7) < 2, codes ^ 1, codes)


e2m1x_to_e2m1 = e2m1_to_e2m1x


def pack_nibbles(codes: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack pairs of 4-bit codes (uint8 0..15) along `axis` into bytes:
    out = codes[even] | codes[odd] << 4."""
    c = codes.movedim(axis, -1)
    out = (c[..., 0::2] | (c[..., 1::2] << 4)).to(torch.uint8)
    return out.movedim(-1, axis)


def unpack_nibbles(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of pack_nibbles: low and high nibbles interleaved along
    `axis`."""
    p = packed.movedim(axis, -1)
    out = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(
        *p.shape[:-1], 2 * p.shape[-1])
    return out.movedim(-1, axis)


def quantize_nvfp4_groups(x: torch.Tensor):
    """Quantize the last axis in 16-element groups.

    x: [..., K] with K % 16 == 0, already divided by the global scale.
    Returns (e2m1 codes uint8 [..., K], ue4m3 scale values f32
    [..., K/16])."""
    shape = x.shape
    g = x.float().reshape(*shape[:-1], shape[-1] // N.NVFP4_GROUP,
                          N.NVFP4_GROUP)
    scale = N.quantize_ue4m3(g.abs().amax(dim=-1, keepdim=True)
                             * N.INV_E2M1_MAX)
    codes = N.e2m1_encode_scaled(g, scale)
    return codes.reshape(shape), scale.reshape(*shape[:-1],
                                               shape[-1] // 16)


def best_k_block(kq: int, cap: int = 2048, align: int = 128) -> int:
    """Largest divisor of kq that is a multiple of `align` and <= cap."""
    best = 0
    d = align
    while d <= cap:
        if kq % d == 0:
            best = d
        d += align
    return best


def pad_kq(k: int, select_num: int,
           pad_multiple: int = K_PAD_MULTIPLE) -> int:
    """Augmented + padded contraction length, the JAX package's rule:
    pad K + KE to a multiple of 512, then keep padding (512 at a time,
    up to +6%) until a k-block divisor >= 1024 exists."""
    kq = k + select_num
    kq = kq + (-kq) % pad_multiple
    limit = int(kq * 1.06)
    cand = kq
    while cand <= limit:
        if best_k_block(cand) >= 1024:
            return cand
        cand += pad_multiple
    return kq


def pack_weight_arc(w: torch.Tensor, reorder_index: Optional[torch.Tensor],
                    select_num: int,
                    bias: Optional[torch.Tensor] = None,
                    pad_multiple: int = K_PAD_MULTIPLE,
                    fmt: str = "w8",
                    global_scale: Optional[torch.Tensor] = None,
                    w_scale: str = "tensor"):
    """Quantize and pack an [N, K] weight with ARC column duplication:
    the last `select_num` entries of reorder_index are re-quantized
    duplicates appended after the K plain columns.

    fmt "w8" gives a PackedWeightI8, "w4" a PackedWeight. global_scale
    overrides the tensor scale; w_scale="channel" gives one global scale
    per output channel ([N])."""
    if fmt not in ("w4", "w8"):
        raise ValueError(f"unknown weight format {fmt!r}")
    n, k = w.shape
    if global_scale is not None:
        gs = torch.as_tensor(global_scale, dtype=torch.float32,
                             device=w.device)
    elif w_scale == "channel":
        gs = N.nvfp4_global_scale(w, per_row=True)[:, 0]
    else:
        gs = N.nvfp4_global_scale(w)
    ws = w.float() / (gs[:, None] if gs.ndim else gs)
    if select_num:
        idx = reorder_index[-select_num:].long().to(w.device)
        ws = torch.cat([ws, ws[:, idx]], dim=1)
    kq = pad_kq(k, select_num, pad_multiple)
    pad = kq - ws.shape[1]
    if pad:
        ws = torch.nn.functional.pad(ws, (0, pad))
    codes, scales = quantize_nvfp4_groups(ws)
    if pad:
        # padded groups get a zero scale: they contribute exactly 0
        scales[:, (k + select_num) // 16:] = 0.0
    scale_bytes = N.ue4m3_to_bytes(scales).T.contiguous()
    if fmt == "w8":
        return PackedWeightI8(codes=codes_to_mag2_i8(codes).T.contiguous(),
                              scales=scale_bytes, global_scale=gs, bias=bias)
    return PackedWeight(
        codes=pack_nibbles(e2m1_to_e2m1x(codes)).T.contiguous(),
        scales=scale_bytes, global_scale=gs, bias=bias)


def pack_weight_arc_rows(w: torch.Tensor, reorder_index: torch.Tensor,
                         select_num: int, fmt: str = "w8",
                         global_scale: Optional[torch.Tensor] = None,
                         step: int = 16384):
    """pack_weight_arc of an [N, K] weight (no bias) in chunks of `step`
    output rows, concatenated along N, so the f32 transients of a wide
    weight (an LM head, a stack of experts' rows) stay small. The bytes
    are one call's: each chunk takes per-channel global scales of its own
    rows, or the given global_scale."""
    chunks = [pack_weight_arc(w[i:i + step], reorder_index, select_num,
                              fmt=fmt, w_scale="channel",
                              global_scale=global_scale)
              for i in range(0, w.shape[0], step)]
    gs = (torch.cat([c.global_scale.reshape(-1) for c in chunks])
          if global_scale is None else chunks[0].global_scale)
    return type(chunks[0])(
        codes=torch.cat([c.codes for c in chunks], dim=1),
        scales=torch.cat([c.scales for c in chunks], dim=1),
        global_scale=gs, bias=None)


def dequantize_weight(pw, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decode a packed weight (either format) to [Kq, N] in natural k
    order and scaled units (global scale not folded in): the golden
    decode. Every decoded value is exact in bf16: an e2m1 value (<= 2
    significant bits) times a ue4m3 scale (4 significant bits)."""
    s = N.ue4m3_from_bytes(pw.scales)
    if isinstance(pw, PackedWeightI8):
        vals = pw.codes.float() * 0.5
    else:
        vals = N.e2m1_decode(e2m1x_to_e2m1(unpack_nibbles(pw.codes, 0)))
    return (vals * s.repeat_interleave(N.NVFP4_GROUP, dim=0)).to(dtype)
