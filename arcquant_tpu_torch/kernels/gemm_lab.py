"""The GEMM lab (counterpart of ``benchmarks/gemm_lab.py``'s Pallas
variants): the dequant GEMM y = bf16((xa @ dec(W)) * gs[m] * gw[n]) with
f32 accumulation, with its tile, pipeline depth and decode varied.

  lab_w8         ``w8_variant``: decode modes base (production: bf16(c
                 * ue4m3 / 2), as the bf16 192 + c and one bf16x2 FMA),
                 mul3d (the same product against a [BKS/16, BN] scale
                 tile decoded once a stage and indexed per group), bf16
                 (code and scale cast to bf16 on the conversion unit,
                 the product in bf16), noscale (bf16(code) on the ALU: a
                 probe of the ALU floor);
  lab_w8_ring    ``w8_dma_variant``: a persistent grid whose blocks each
                 drive one warp-specialised TMA ring (a producer warp,
                 full / empty mbarriers, 4 or 8 consumer warps decoding
                 into mma.sync fragments) over a run of (split, m-tile,
                 n-tile) work items in the weight's byte order (mode
                 base, production's split plan);
  lab_w8_ring_n  ``w8_dma_nblock``: one thread-block cluster per n tile,
                 its CTAs splitting K and summing their partials in
                 distributed shared memory (mode base);
  lab_w4         ``w4_variant``: nibble decodes f32 (production's
                 byte-permute tables), i16 (the 16-bit map straight to
                 bf16 bits, bf16 scale products) and nodec
                 (the byte's bits c << 22 as f32 for both k rows: a probe
                 of the stream floor).

CUDA tensors launch ``csrc/gemm_lab.cu``: lab_w8 and lab_w4 production's
small-M mainloop (``gemm_small_m.cuh``) at another tile and decode: a
ring of cp.async stages of BKS k rows (code rows padded as production
pads them), BN columns a block of BN / 32 warps, each thread decoding
its columns' code words in registers straight into ``mma.sync`` B
fragments by the mode (base and f32 with production's own
``decode_step``), the production 32-deep promotion and epilogue from
registers; the two rings production's 128-deep stage and mainloop fed
by TMA. CPU tensors run the plain versions, which decode as the JAX
kernel bodies do and take an f32 matmul. xa is in natural k order for
both formats (the TPU's split-half w4 operand is not carried over) and
is not padded to 16 rows: the kernels mask the rows past M.

With production's split plan (``gemm._split_plan`` of the format, the
default: the plan table's split or the heuristic's) the exact modes
(base, mul3d, bf16; w4 f32 and i16) give the bits of gemm_w8 (gemm_w4
for lab_w4, which equals gemm_w8 at the same plan), and so do
lab_w8_ring and lab_w8_ring_n (at a cluster size of production's split
count, its default). Nothing on a serving path calls this module.
"""

from __future__ import annotations

import ctypes
import functools
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
                              [P, P, P, P, P, P] + [I32] * 8)
LAB_W4 = _build.Kernel("lab_w4", "arc_lab_w4",
                       [P, P, P, P, P, P, P] + [I32] * 9)
KERNELS = (LAB_W8, LAB_W8_RING, LAB_W8_RING_N, LAB_W4)

W8_MODES = ("base", "mul3d", "bf16", "noscale")
W4_MODES = ("f32", "i16", "nodec")
EXACT_MODES = ("base", "mul3d", "bf16", "f32", "i16")
_MODE_ID = {m: i for i, m in enumerate(W8_MODES + W4_MODES)}

# (bn, bks, stages, mode) instantiated in csrc/gemm_lab.cu
# (LAB_CONFIG_LIST)
LAB_CONFIGS = (
    *((bn, bks, 3, "base") for bn in (64, 128, 256)
      for bks in (32, 64, 128, 256) if (bn, bks) != (256, 256)),
    (128, 128, 2, "base"), (128, 128, 4, "base"), (128, 128, 6, "base"),
    (128, 128, 3, "mul3d"), (128, 128, 3, "bf16"), (128, 128, 3, "noscale"),
    (64, 256, 3, "f32"), (128, 128, 3, "f32"), (128, 256, 3, "f32"),
    (256, 128, 3, "f32"), (128, 128, 3, "i16"), (128, 128, 3, "nodec"))
# lab_w8_ring's (bn, bks, stages) (RING_CONFIG_LIST): bn / 32 consumer
# warps, 128-deep stages (production's), `stages` ring slots
RING_CONFIGS = ((128, 128, 2), (128, 128, 4), (128, 128, 6), (128, 128, 8),
                (256, 128, 2), (256, 128, 4))
# lab_w8_ring_n's (bn, bks, stages, cluster): RING_N_CONFIG_LIST's tiles
# at every cluster size up to MAX_CLUSTER (a launch attribute, not an
# instantiation; 8 is the portable limit)
MAX_CLUSTER = 16
RING_N_CONFIGS = tuple((128, 128, stages, c) for stages in (2, 3, 4)
                       for c in range(1, MAX_CLUSTER + 1))

SMEM_MAX = 232448   # shared memory a block can use on an H100
SUBK = 32           # the production k-tile
BM = 16             # activation rows a block


def _al(x: int) -> int:
    return -(-x // 128) * 128


def code_ld(bn: int, mode: str) -> int:
    """Bytes of a stage's code row (csrc/gemm_lab.cu Cfg::LDC): BN
    padded as gemm_small_m.cuh pads it, so that the four code rows a
    fragment load reads start 8 banks apart."""
    return bn + 32 if mode in W4_MODES else bn + 16


def smem_bytes(bn: int, bks: int, stages: int, mode: str) -> int:
    """Dynamic shared memory of a lab_w8 / lab_w4 configuration
    (csrc/gemm_lab.cu Cfg): `stages` stages of padded code rows, scale
    rows and activation rows, and mul3d's decoded scale tile (a bf16
    pair a scale)."""
    code_rows = bks // 2 if mode in W4_MODES else bks
    stage = (_al(code_rows * code_ld(bn, mode)) + _al(bks // 16 * bn)
             + _al(BM * (bks + 8) * 2))
    s3 = _al(bks // 16 * bn * 4) if mode == "mul3d" else 0
    return stages * stage + s3


# The copy rings' stage: gemm_small_m.cuh's 128-column w8 stage
# (Cfg<1, false>), filled by three TMA boxes, {inner, outer} elements and
# the element's bytes: codes 128 k rows of 144 (128 + 16 pad) bytes,
# scales 8 rows of 128, activations 16 rows of 136 (128 + 8 pad) bf16.
RING_HALF = 128
RING_BOXES = {"codes": (RING_HALF + 16, 128, 1), "scales": (RING_HALF, 8, 1),
              "xa": (128 + 8, BM, 2)}
RING_STAGE = sum(_al(i * o * b) for i, o, b in RING_BOXES.values())


def ring_smem_bytes(bn: int, stages: int) -> int:
    """Dynamic shared memory of a copy-ring configuration (csrc/
    gemm_lab.cu ring::Ring): the alignment pad, `stages` slots of bn /
    128 stages, a full and an empty mbarrier a slot."""
    return 128 + stages * (bn // RING_HALF) * RING_STAGE + 16 * stages


# -- plain versions ------------------------------------------------------------

def _epilogue(acc, gs, gw):
    """acc * gs * gw in f32, the JAX kernels' order, then bf16."""
    return (acc * gs.reshape(-1, 1).float() * gw.reshape(1, -1).float()).to(
        torch.bfloat16)


def w8_weight(codes, scales, mode: str = "base") -> torch.Tensor:
    """The bf16 weight [Kq, N] that lab_w8's `mode` decodes, as
    w8_variant's body decodes it. codes [Kq, N] int8; scales [Kq/16, N]
    uint8."""
    if mode not in W8_MODES:
        raise ValueError(f"lab_w8: unknown mode {mode!r}")
    c = codes.float()
    s = N.ue4m3_from_bytes(scales) * 0.5
    if mode == "noscale":
        return c.to(torch.bfloat16)
    if mode == "bf16":
        return c.to(torch.bfloat16) * s.to(
            torch.bfloat16).repeat_interleave(N.NVFP4_GROUP, dim=0)
    # base and mul3d: one f32 product, rounded to bf16
    return (c * s.repeat_interleave(N.NVFP4_GROUP, dim=0)).to(torch.bfloat16)


def lab_w8_plain(xa, codes, scales, gs, gw, mode: str = "base"):
    """Plain version of lab_w8 (and of the rings, mode base): the weight
    decoded by `mode` (w8_weight), an f32 matmul, the epilogue. xa: [M,
    Kq] bf16; codes [Kq, N] int8; scales [Kq/16, N] uint8; gs [M] or [M,
    1]; gw [N] or [1, N]."""
    w = w8_weight(codes, scales, mode)
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


def w4_weight(codes, scales, mode: str = "f32") -> torch.Tensor:
    """The bf16 weight [Kq, N] that lab_w4's `mode` decodes: the nibbles
    decoded as w4_variant's body does, laid out in natural k order (row
    2g from byte g's low nibble, 2g + 1 from its high one). codes [Kq/2,
    N] uint8; scales [Kq/16, N] uint8."""
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
    return torch.stack([even, odd], dim=1).reshape(-1, codes.shape[1])


def lab_w4_plain(xa, codes, scales, gs, gw, mode: str = "f32"):
    """Plain version of lab_w4: the weight decoded by `mode` (w4_weight),
    an f32 matmul, the epilogue. codes [Kq/2, N] uint8; the rest as
    lab_w8_plain."""
    w = w4_weight(codes, scales, mode)
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


def _plan(m, n, kq, splits: Optional[int] = None, fmt: str = "w8"):
    """(splits, 32-tiles a split): production's plan of the format unless
    `splits` is given."""
    if splits is None:
        _, splits, per = gk._split_plan(m, n, kq, fmt)
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
    splits, per = _plan(m, n, kq, splits, "w4" if w4 else "w8")
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


def cluster_ranges(m: int, n: int, kq: int, cluster: Optional[int] = None):
    """The k-tile range [kt0, kt1) of each CTA rank of a lab_w8_ring_n
    cluster, as the kernel takes it from _plan's (c, per): c CTAs, rank r
    over [r per, min((r + 1) per, Kq / 32))."""
    c, per = _plan(m, n, kq, cluster)
    return [(r * per, min((r + 1) * per, kq // SUBK)) for r in range(c)]


@functools.lru_cache(maxsize=None)
def cluster_fit(bn: int, bks: int, stages: int, cluster: int) -> int:
    """How many lab_w8_ring_n clusters of this configuration and size the
    current card holds at once (cudaOccupancyMaxActiveClusters; 0: it
    cannot schedule one)."""
    active = ctypes.c_int(0)
    fn = _build.library().arc_lab_cluster_fit
    fn.argtypes = [I32, I32, I32, I32, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    rc = fn(bn, bks, stages, cluster, ctypes.byref(active))
    if rc != 0:
        raise RuntimeError(f"arc_lab_cluster_fit failed: cudaError {rc}")
    return active.value


def _tma_operands(name, xa, codes, scales, gs, gw):
    """The rings' operands: the lab's checks, then 16-byte aligned bases
    (TMA's; a misaligned one is copied)."""
    xa, codes, scales, gs, gw, m, n, kq = _operands(name, False, xa, codes,
                                                     scales, gs, gw)
    return (gk._aligned(xa), gk._aligned(codes), gk._aligned(scales), gs, gw,
            m, n, kq)


def lab_w8_ring_n(xa, codes, scales, gs, gw, bn: int = 128, bks: int = 128,
                  stages: int = 2, cluster: Optional[int] = None):
    """w8_dma_nblock: one cluster of c CTAs per 128-wide n tile, CTA r
    streaming its k range through its own TMA ring, the cluster summing
    the partials in distributed shared memory in rank order (mode base).
    c is production's split count by default (its bits), else about
    `cluster` (_plan). Raises for a configuration that is not
    built and for a cluster size the card cannot schedule."""
    if gk._cpu(xa):
        return lab_w8_plain(xa, codes, scales, gs, gw, "base")
    xa, codes, scales, gs, gw, m, n, kq = _tma_operands(
        "lab_w8_ring_n", xa, codes, scales, gs, gw)
    c, per = _plan(m, n, kq, cluster)
    if (bn, bks, stages, c) not in RING_N_CONFIGS:
        raise ValueError(f"lab_w8_ring_n: configuration bn={bn} bks={bks} "
                         f"stages={stages} cluster={c} is not built "
                         "(csrc/gemm_lab.cu RING_N_CONFIG_LIST, MAX_CLUSTER)")
    if cluster_fit(bn, bks, stages, c) < 1:
        raise ValueError(f"lab_w8_ring_n: the card cannot schedule a cluster "
                         f"of {c} CTAs of bn={bn} bks={bks} stages={stages} "
                         "(cudaOccupancyMaxActiveClusters 0)")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xa.device)
    LAB_W8_RING_N(_build.ptr(xa), _build.ptr(codes), _build.ptr(scales),
                  _build.ptr(gs), _build.ptr(gw), _build.ptr(out), m, n, kq,
                  bn, bks, stages, c, per)
    return out


def ring_blocks(per_sm: int = 1) -> int:
    """The persistent grid: per_sm blocks on each SM of the current card."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return per_sm * props.multi_processor_count


def ring_per_sm(bn: int, stages: int) -> int:
    """How many blocks of a lab_w8_ring configuration an H100 SM holds
    (228 KB of shared memory, 1 KB of it reserved a block)."""
    return (228 * 1024) // (ring_smem_bytes(bn, stages) + 1024)


RING_PER_SM = 3   # lab_w8_ring's default grid: three blocks an SM


def lab_w8_ring(xa, codes, scales, gs, gw, bn: int = 128, bks: int = 128,
                stages: int = 2, blocks: Optional[int] = None):
    """w8_dma_variant on a persistent grid of `blocks` blocks
    (RING_PER_SM an SM by default), each a producer warp and bn / 32
    consumer warps over a `stages`-slot TMA ring; production's split
    plan, mode base."""
    if gk._cpu(xa):
        return lab_w8_plain(xa, codes, scales, gs, gw, "base")
    if (bn, bks, stages) not in RING_CONFIGS:
        raise ValueError(f"lab_w8_ring: configuration bn={bn} bks={bks} "
                         f"stages={stages} is not built (RING_CONFIG_LIST)")
    xa, codes, scales, gs, gw, m, n, kq = _tma_operands(
        "lab_w8_ring", xa, codes, scales, gs, gw)
    splits, per = _plan(m, n, kq, None)
    items = splits * -(-m // BM) * -(-n // bn)
    blocks = min(items, blocks or ring_blocks(RING_PER_SM))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xa.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=xa.device)
          if splits > 1 else None)
    LAB_W8_RING(_build.ptr(xa), _build.ptr(codes), _build.ptr(scales),
                _build.ptr(gs), _build.ptr(gw), _build.ptr(out), _build.ptr(ws),
                m, n, kq, bn, bks, stages, splits, per, blocks)
    return out
