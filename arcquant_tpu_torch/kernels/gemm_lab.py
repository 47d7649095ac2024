"""The GEMM lab (counterpart of ``benchmarks/gemm_lab.py``'s Pallas
variants): the dequant GEMM y = bf16((xa @ dec(W)) * gs[m] * gw[n]) with
f32 accumulation, with its tile, pipeline depth and decode varied.

  lab_w8         ``w8_variant``: decode modes base (production: i8 -> f32
                 times the per-row expanded ue4m3 / 2, -> bf16), mul3d
                 (the same product against a decoded [BKS/16, BN] scale
                 tile indexed per group), bf16 (code and scale cast to
                 bf16, the product in bf16), noscale (bf16(code): a probe
                 of the ALU floor);
  lab_w8_ring    ``w8_dma_variant``: a persistent grid whose blocks each
                 drive one copy ring over a run of (split, m-tile, n-tile)
                 work items in the weight's byte order (mode base);
  lab_w8_ring_n  ``w8_dma_nblock``: one block per n tile over the whole K
                 (mode base, one split);
  lab_w4         ``w4_variant``: nibble decodes f32 (production), i16
                 (straight to bf16 bits, bf16 scale products) and nodec
                 (the byte's bits c << 22 as f32 for both k rows: a probe
                 of the stream floor).

CUDA tensors launch ``csrc/gemm_lab.cu`` (a ring of cp.async stages of
BKS k rows, BN columns a block, the production 32-deep promotion and
epilogue); CPU tensors run the plain versions, which decode as the JAX
kernel bodies do and take an f32 matmul. xa is in natural k order for
both formats (the TPU's split-half w4 operand is not carried over) and
is not padded to 16 rows: the kernels mask the rows past M.

With production's split plan (``gemm._split_plan``, the default) the
exact modes (base, mul3d, bf16; w4 f32 and i16) give gemm_w8's bits, and
so does lab_w8_ring; lab_w8_ring_n does where the plan has one split.
Nothing on a serving path calls this module.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant import numerics as N
from . import _build
from . import gemm as gk

P, I32 = _build.P, _build.I32
LAB_W8 = _build.Kernel("lab_w8", "arc_lab_w8",
                       [P, P, P, P, P, P, P] + [I32] * 9)
LAB_W8_RING = _build.Kernel("lab_w8_ring", "arc_lab_w8_ring",
                            [P, P, P, P, P, P, P] + [I32] * 9)
LAB_W8_RING_N = _build.Kernel("lab_w8_ring_n", "arc_lab_w8_ring_n",
                              [P, P, P, P, P, P] + [I32] * 6)
LAB_W4 = _build.Kernel("lab_w4", "arc_lab_w4",
                       [P, P, P, P, P, P, P] + [I32] * 9)
KERNELS = (LAB_W8, LAB_W8_RING, LAB_W8_RING_N, LAB_W4)

W8_MODES = ("base", "mul3d", "bf16", "noscale")
W4_MODES = ("f32", "i16", "nodec")
EXACT_MODES = ("base", "mul3d", "bf16", "f32", "i16")
_MODE_ID = {m: i for i, m in enumerate(W8_MODES + W4_MODES)}

# (bn, bks, stages, mode) instantiated in csrc/gemm_lab.cu
# (LAB_CONFIG_LIST; lab_w8_ring_n runs the base entries) and the ring's
# (bn, bks, stages) (RING_CONFIG_LIST)
LAB_CONFIGS = (
    *((bn, bks, 3, "base") for bn in (64, 128, 256)
      for bks in (32, 64, 128, 256) if (bn, bks) != (256, 256)),
    (128, 128, 2, "base"), (128, 128, 4, "base"), (128, 128, 6, "base"),
    (128, 128, 3, "mul3d"), (128, 128, 3, "bf16"), (128, 128, 3, "noscale"),
    (64, 256, 3, "f32"), (128, 128, 3, "f32"), (128, 256, 3, "f32"),
    (256, 128, 3, "f32"), (128, 128, 3, "i16"), (128, 128, 3, "nodec"))
RING_CONFIGS = ((128, 128, 2), (128, 128, 3), (128, 128, 4), (128, 128, 6))

SMEM_MAX = 232448   # shared memory a block can use on an H100
SUBK = 32           # the production k-tile
BM = 16             # activation rows a block


def smem_bytes(bn: int, bks: int, stages: int, mode: str) -> int:
    """Dynamic shared memory of a configuration (csrc/gemm_lab.cu Cfg)."""
    def al(x):
        return -(-x // 128) * 128
    code_rows = bks // 2 if mode in W4_MODES else bks
    stage = (al(code_rows * bn) + al(bks // 16 * bn)
             + al(BM * (bks + 8) * 2))
    s3 = al(bks // 16 * bn * 4) if mode == "mul3d" else 0
    return (stages * stage + al(SUBK * (bn + 8) * 2) + al(bn // 32 * 256 * 4)
            + s3)


# -- plain versions ------------------------------------------------------------

def _epilogue(acc, gs, gw):
    """acc * gs * gw in f32, the JAX kernels' order, then bf16."""
    return (acc * gs.reshape(-1, 1).float() * gw.reshape(1, -1).float()).to(
        torch.bfloat16)


def lab_w8_plain(xa, codes, scales, gs, gw, mode: str = "base"):
    """Plain version of lab_w8 (and of the rings, mode base): the weight
    decoded by `mode` as w8_variant's body does, an f32 matmul, the
    epilogue. xa: [M, Kq] bf16; codes [Kq, N] int8; scales [Kq/16, N]
    uint8; gs [M] or [M, 1]; gw [N] or [1, N]."""
    if mode not in W8_MODES:
        raise ValueError(f"lab_w8: unknown mode {mode!r}")
    c = codes.float()
    s = N.ue4m3_from_bytes(scales) * 0.5
    if mode == "noscale":
        w = c.to(torch.bfloat16)
    elif mode == "bf16":
        w = c.to(torch.bfloat16) * s.to(torch.bfloat16).repeat_interleave(
            N.NVFP4_GROUP, dim=0)
    else:   # base and mul3d: one f32 product, rounded to bf16
        w = (c * s.repeat_interleave(N.NVFP4_GROUP, dim=0)).to(torch.bfloat16)
    return _epilogue(xa.to(torch.bfloat16).float() @ w.float(), gs, gw)


def _i16_values(nib: torch.Tensor) -> torch.Tensor:
    """e2m1x nibbles -> bf16 by w4_variant's 16-bit map: the magnitude
    into bits 6-8, the sign into bit 15, plus 0x3F00; mag 1 -> +0."""
    nib = nib.int()
    mag = nib & 7
    bits = ((mag << 6) | ((nib & 8) << 12)) + 0x3F00
    bits = torch.where(mag == 1, 0, bits)
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)   # as int16
    return bits.to(torch.int16).view(torch.bfloat16)


def lab_w4_plain(xa, codes, scales, gs, gw, mode: str = "f32"):
    """Plain version of lab_w4: the nibbles decoded by `mode` as
    w4_variant's body does, laid out in natural k order (row 2g from
    byte g's low nibble, 2g + 1 from its high one), an f32 matmul, the
    epilogue. codes [Kq/2, N] uint8; the rest as lab_w8_plain."""
    if mode not in W4_MODES:
        raise ValueError(f"lab_w4: unknown mode {mode!r}")
    s = N.ue4m3_from_bytes(scales).repeat_interleave(N.NVFP4_GROUP // 2,
                                                     dim=0)
    if mode == "f32":
        even = (gk._e2m1x_values(codes & 0xF) * s).to(torch.bfloat16)
        odd = (gk._e2m1x_values(codes >> 4) * s).to(torch.bfloat16)
    elif mode == "i16":
        sb = s.to(torch.bfloat16)
        even, odd = _i16_values(codes & 0xF) * sb, _i16_values(codes >> 4) * sb
    else:   # nodec
        even = odd = (codes.int() << 22).view(torch.float32).to(
            torch.bfloat16)
    w = torch.stack([even, odd], dim=1).reshape(-1, codes.shape[1])
    return _epilogue(xa.to(torch.bfloat16).float() @ w.float(), gs, gw)


# -- CUDA launchers ------------------------------------------------------------

def _operands(name, w4, xa, codes, scales, gs, gw):
    _build.require_cuda(name, xa, codes, scales, gs, gw)
    m, kq = xa.shape
    n = codes.shape[1]
    if (xa.dtype != torch.bfloat16
            or codes.dtype != (torch.uint8 if w4 else torch.int8)
            or scales.dtype != torch.uint8
            or codes.shape[0] != (kq // 2 if w4 else kq)
            or scales.shape != (kq // 16, n) or kq % SUBK or n % 16
            or gs.numel() != m or gw.numel() != n):
        raise ValueError(
            f"{name}: unsupported operands xa {tuple(xa.shape)} {xa.dtype}, "
            f"codes {tuple(codes.shape)} {codes.dtype}, scales "
            f"{tuple(scales.shape)}")
    return (xa.contiguous(), codes.contiguous(), scales.contiguous(),
            gs.reshape(-1).float().contiguous(),
            gw.reshape(-1).float().contiguous(), m, n, kq)


def _plan(m, n, kq, splits: Optional[int]):
    """(splits, 32-tiles a split): production's plan unless `splits` is
    given."""
    if splits is None:
        _, splits, per = gk._split_plan(m, n, kq)
        return splits, per
    per = -(-(kq // SUBK) // splits)
    return -(-(kq // SUBK) // per), per


def _check(name, bn, bks, stages, mode, configs):
    if (bn, bks, stages, mode) not in configs:
        raise ValueError(f"{name}: configuration bn={bn} bks={bks} "
                         f"stages={stages} mode={mode} is not built "
                         "(csrc/gemm_lab.cu LAB_CONFIG_LIST)")


def _launch(kernel, w4, xa, codes, scales, gs, gw, mode, bn, bks, stages,
            splits):
    _check(kernel.name, bn, bks, stages, mode, LAB_CONFIGS)
    xa, codes, scales, gs, gw, m, n, kq = _operands(kernel.name, w4, xa,
                                                     codes, scales, gs, gw)
    splits, per = _plan(m, n, kq, splits)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xa.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=xa.device)
          if splits > 1 else None)
    kernel(_build.ptr(xa), _build.ptr(codes), _build.ptr(scales),
           _build.ptr(gs), _build.ptr(gw), _build.ptr(out), _build.ptr(ws),
           m, n, kq, bn, bks, stages, _MODE_ID[mode], splits, per)
    return out


def lab_w8(xa, codes, scales, gs, gw, mode: str = "base", bn: int = 128,
           bks: int = 128, stages: int = 3, splits: Optional[int] = None):
    """w8_variant: y [M, N] bf16 by decode `mode`, with BN columns a
    block, BKS k rows a stage, `stages` stages and `splits` k splits
    (production's plan by default)."""
    if gk._cpu(xa):
        return lab_w8_plain(xa, codes, scales, gs, gw, mode)
    if mode not in W8_MODES:
        raise ValueError(f"lab_w8: unknown mode {mode!r}")
    return _launch(LAB_W8, False, xa, codes, scales, gs, gw, mode, bn, bks,
                   stages, splits)


def lab_w4(xa, codes, scales, gs, gw, mode: str = "f32", bn: int = 128,
           bks: int = 128, stages: int = 3, splits: Optional[int] = None):
    """w4_variant on natural-order xa: as lab_w8, codes [Kq/2, N] uint8."""
    if gk._cpu(xa):
        return lab_w4_plain(xa, codes, scales, gs, gw, mode)
    if mode not in W4_MODES:
        raise ValueError(f"lab_w4: unknown mode {mode!r}")
    return _launch(LAB_W4, True, xa, codes, scales, gs, gw, mode, bn, bks,
                   stages, splits)


def lab_w8_ring_n(xa, codes, scales, gs, gw, bn: int = 128, bks: int = 128,
                  stages: int = 3):
    """w8_dma_nblock: one block per BN-wide n tile over the whole K
    through a `stages`-deep ring (mode base, one split)."""
    if gk._cpu(xa):
        return lab_w8_plain(xa, codes, scales, gs, gw, "base")
    _check("lab_w8_ring_n", bn, bks, stages, "base", LAB_CONFIGS)
    xa, codes, scales, gs, gw, m, n, kq = _operands(
        "lab_w8_ring_n", False, xa, codes, scales, gs, gw)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xa.device)
    LAB_W8_RING_N(_build.ptr(xa), _build.ptr(codes), _build.ptr(scales),
                  _build.ptr(gs), _build.ptr(gw), _build.ptr(out), m, n, kq,
                  bn, bks, stages)
    return out


def ring_blocks(per_sm: int = 1) -> int:
    """The persistent grid: per_sm blocks on each SM of the current card."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return per_sm * props.multi_processor_count


def lab_w8_ring(xa, codes, scales, gs, gw, bn: int = 128, bks: int = 128,
                stages: int = 3, blocks: Optional[int] = None):
    """w8_dma_variant on a persistent grid of `blocks` blocks (one an SM
    by default), production's split plan, mode base."""
    if gk._cpu(xa):
        return lab_w8_plain(xa, codes, scales, gs, gw, "base")
    if (bn, bks, stages) not in RING_CONFIGS:
        raise ValueError(f"lab_w8_ring: configuration bn={bn} bks={bks} "
                         f"stages={stages} is not built (RING_CONFIG_LIST)")
    xa, codes, scales, gs, gw, m, n, kq = _operands(
        "lab_w8_ring", False, xa, codes, scales, gs, gw)
    splits, per = _plan(m, n, kq, None)
    items = splits * -(-m // BM) * -(-n // bn)
    blocks = min(items, blocks or ring_blocks())
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xa.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=xa.device)
          if splits > 1 else None)
    LAB_W8_RING(_build.ptr(xa), _build.ptr(codes), _build.ptr(scales),
                _build.ptr(gs), _build.ptr(gw), _build.ptr(out), _build.ptr(ws),
                m, n, kq, bn, bks, stages, splits, per, blocks)
    return out
