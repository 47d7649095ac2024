"""Dequant GEMM in both weight formats (counterpart of
``arcquant_tpu/kernels/gemm.py``).

``gemm_dequant`` computes y = (xa @ dec(W)) * gx[m] * gw[n] + bias with
f32 accumulation, then casts. It dispatches as the JAX package does:

  - M >= XLA_M and N >= Kq (prefill qkv and gateup): the large-M route.
    The weight is decoded once to bf16 (``dequant_w8`` / ``dequant_w4``,
    replacing the TPU kernels ``_dequant_w8_kernel`` and
    ``_dequant_w4_kernel``), for w4 the activations are split into
    even-k then odd-k columns (``pin_rowmajor``, replacing
    ``_copy_kernel``), then ``torch.mm`` with f32 output contracts them
    (the product the JAX package leaves to XLA) in k slices added into
    an f32 total, and the epilogue runs in f32 in JAX's order;
  - otherwise the fused GEMM: ``gemm_w8`` (replacing ``_gemm_w8_kernel``
    and its stream twin ``_gemm_w8_dma_kernel``) on a PackedWeightI8,
    ``gemm_w4`` (replacing ``_gemm_w4_kernel`` and
    ``_gemm_w4_dma_kernel``) on a PackedWeight.

``gemm_dequant_batched`` is the same fused GEMM over a stack of experts'
weights ([E, Kq(/2), N], the MoE down projection): one launch of
``gemm_batched`` (replacing the JAX package's ``gemm_dequant_batched``, a
vmap of ``_gemm_call``), whose every expert's slice gives the bits of a
``gemm_w8`` or ``gemm_w4`` launch on that expert. ``dequant_weight``
decodes a stacked pack in one launch too.

At M <= 64 the fused GEMM's small-M tile splits k across blocks by
``_split_plan``: the measured plan table's split for (format, M bucket,
Kq, N) where one is trusted (kernels/autotune.py, the JAX package's
autotune table), else ``heuristic_splits``. Every launcher of the
small-M mainloop takes that answer.

CUDA tensors launch the kernels in ``csrc/`` (``gemm_w8.cu``,
``gemm_w4.cu``, ``gemm_batched.cu``, ``dequant.cu``); CPU tensors run
the plain versions (``*_plain``), whose matmul is f32. The decoded
weights and xa are exact in bf16, so the routes and formats differ only
by the f32 summation order: the w4 GEMM reads xa in natural k order and
decodes each code byte into its two k rows, so it gives the w8 GEMM's
bits on the same weight.
"""

from __future__ import annotations

import numbers
from typing import Optional, Union

import torch

from ..quant import numerics as N
from ..quant.packing import PackedWeight, PackedWeightI8
from . import _build, autotune

P, I32 = _build.P, _build.I32
_GEMM_ARGS = [P, P, P, P, P, P, P, I32, P, I32, I32, I32, I32, I32, I32]
GEMM_W8 = _build.Kernel("gemm_w8", "arc_gemm_w8", _GEMM_ARGS)
GEMM_W4 = _build.Kernel("gemm_w4", "arc_gemm_w4", _GEMM_ARGS)
GEMM_BATCHED = _build.Kernel("gemm_batched", "arc_gemm_batched",
                             [I32, P, P, P, P, P, P, I32, P, I32, I32, I32,
                              I32, I32, I32, I32])
DEQUANT_W8 = _build.Kernel("dequant_w8", "arc_dequant_w8",
                           [P, P, P, P, I32, I32, I32])
DEQUANT_W4 = _build.Kernel("dequant_w4", "arc_dequant_w4",
                           [P, P, P, P, I32, I32, I32])
PIN_ROWMAJOR = _build.Kernel("pin_rowmajor", "arc_pin_rowmajor",
                             [P, P, I32, I32])

# Large-M route threshold (the JAX package's ARC_GEMM_XLA_M default):
# M >= XLA_M with N >= Kq takes dequant + torch.mm; 0 turns it off.
XLA_M = 512
# k per torch.mm on the route: the f32 total takes each slice's product
MM_CHUNK_K = 512

_BK = 32
_SMALL_M = 64          # M at or below this takes the small-M tile
_TARGET_BLOCKS = 264   # about two blocks per SM of an H100
_MIN_SPLIT_TILES = 16  # k-tiles (of 32) per split at least

Packed = Union[PackedWeight, PackedWeightI8]


# -- plain versions ------------------------------------------------------------

def _e2m1x_values(nib: torch.Tensor) -> torch.Tensor:
    """e2m1x nibbles -> f32 values by the kernels' bit map: mag bits into
    the exponent and mantissa, the sign bit in place, mag 1 -> +0."""
    nib = nib.int()
    mag = nib & 7
    bits = ((mag << 22) | ((nib & 8) << 28)) + 0x3F000000
    return torch.where(mag == 1, 0.0, bits.view(torch.float32))


def _w4_planes(codes: torch.Tensor, scales: torch.Tensor):
    """(even-k, odd-k) decoded f32 planes [..., Kq/2, N] of a w4 pack."""
    s = N.ue4m3_from_bytes(scales).repeat_interleave(N.NVFP4_GROUP // 2,
                                                     dim=-2)
    return _e2m1x_values(codes & 0xF) * s, _e2m1x_values(codes >> 4) * s


def _epilogue(acc, gs, gw, bias, out_dtype):
    """acc * gs * gw (+ bias) in f32, JAX's order, then the cast; in
    place on the f32 accumulator acc."""
    acc.mul_(gs).mul_(gw)
    if bias is not None:
        acc.add_(bias.float())
    return acc.to(out_dtype)


def gemm_w8_plain(xa: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor, gs: torch.Tensor,
                  gw: torch.Tensor, bias: Optional[torch.Tensor],
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the w8 GEMM. gs: [M, 1] f32, gw: [1, N] f32."""
    s = N.ue4m3_from_bytes(scales) * 0.5
    w = (codes.float() * s.repeat_interleave(N.NVFP4_GROUP, dim=0))
    acc = xa.to(torch.bfloat16).float() @ w
    return _epilogue(acc, gs, gw, bias, out_dtype)


def gemm_w4_plain(xa: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor, gs: torch.Tensor,
                  gw: torch.Tensor, bias: Optional[torch.Tensor],
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the w4 GEMM: the weight decoded in natural k
    order (row 2g from byte g's low nibble, 2g+1 from its high one), so
    it equals gemm_w8_plain on the same weight bit for bit."""
    even, odd = _w4_planes(codes, scales)
    w = torch.stack([even, odd], dim=1).reshape(-1, codes.shape[1])
    acc = xa.to(torch.bfloat16).float() @ w
    return _epilogue(acc, gs, gw, bias, out_dtype)


def _fold(w: torch.Tensor, gw: Optional[torch.Tensor]) -> torch.Tensor:
    """The f32 decoded weight (times gw, broadcast, when given) rounded
    to bf16."""
    return (w if gw is None else w * gw.float()).to(torch.bfloat16)


def dequant_w8_plain(codes: torch.Tensor, scales: torch.Tensor,
                     gw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of dequant_w8: bf16 [Kq, N] = code * ue4m3 / 2
    (times gw [N] in f32 before the round, when given). A stack (codes
    [E, Kq, N], gw [E, N]) decodes each expert alike: [E, Kq, N]."""
    s = N.ue4m3_from_bytes(scales) * 0.5
    w = codes.float() * s.repeat_interleave(N.NVFP4_GROUP, dim=-2)
    return _fold(w, None if gw is None else gw.unsqueeze(-2))


def dequant_w4_plain(codes: torch.Tensor, scales: torch.Tensor,
                     gw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of dequant_w4: bf16 [2, Kq/2, N], plane 0 the even
    ks and plane 1 the odd ks (JAX's split-half layout); [E, 2, Kq/2, N]
    for a stack."""
    return _fold(torch.stack(_w4_planes(codes, scales), dim=-3),
                 None if gw is None else gw[..., None, None, :])


def _each_expert(w8, w4, xa, codes, scales, gs, gw, out_dtype):
    """The single GEMM w4 (uint8 codes) or w8 on each expert, stacked.
    xa: [E, M, Kq]; codes: [E, Kq(/2), N]; gs: [E, M, 1]; gw: [E, 1, N]
    (either may be a broadcast view)."""
    one = w4 if codes.dtype == torch.uint8 else w8
    e, m, _ = xa.shape
    gs = gs.float().expand(e, m, 1)
    gw = gw.float().expand(e, 1, codes.shape[-1])
    return torch.stack([one(xa[i], codes[i], scales[i], gs[i], gw[i], None,
                            out_dtype) for i in range(e)])


def gemm_batched_plain(xa, codes, scales, gs, gw, out_dtype):
    """Plain version of the batched GEMM: gemm_w8_plain or gemm_w4_plain
    on each expert (arguments as _each_expert's)."""
    return _each_expert(gemm_w8_plain, gemm_w4_plain, xa, codes, scales, gs,
                        gw, out_dtype)


def split_even_odd(xa: torch.Tensor) -> torch.Tensor:
    """[M, Kq] -> [M, Kq]: the even-k columns, then the odd-k ones."""
    return torch.cat([xa[:, 0::2], xa[:, 1::2]], dim=1)


def pin_rowmajor_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of pin_rowmajor: split_even_odd(x) as contiguous
    bf16 (the w4 route's activation operand)."""
    return split_even_odd(x).to(torch.bfloat16).contiguous()


# -- CUDA launchers ------------------------------------------------------------

def _plan_at(k_tiles: int, splits: int):
    """(splits, k-tiles per split) for `splits` requested over k_tiles:
    per = ceil(k_tiles / splits), and as many splits as that leaves none
    empty (a plan it returns maps to itself)."""
    per = -(-k_tiles // splits)
    return -(-k_tiles // per), per


def heuristic_splits(m: int, n: int, kq: int) -> int:
    """The small-M tile's split count where the plan table has no entry:
    enough splits for about _TARGET_BLOCKS blocks, each split at least
    _MIN_SPLIT_TILES k-tiles."""
    blocks = -(-n // 128) * -(-m // 32)
    k_tiles = kq // _BK
    splits = max(1, min(-(-_TARGET_BLOCKS // blocks),
                        k_tiles // _MIN_SPLIT_TILES))
    return _plan_at(k_tiles, splits)[0]


def split_candidates(m: int, n: int, kq: int) -> list:
    """The split counts kernels/autotune.py times at a small-M shape: the
    heuristic's first, then each plan of 1 up to the most splits that keep
    _MIN_SPLIT_TILES k-tiles a split, no plan twice."""
    k_tiles = kq // _BK
    out = [heuristic_splits(m, n, kq)]
    for s in range(1, max(1, k_tiles // _MIN_SPLIT_TILES) + 1):
        s = _plan_at(k_tiles, s)[0]
        if s not in out:
            out.append(s)
    return out


def _split_plan(m: int, n: int, kq: int, fmt: str = "w8"):
    """(small_m, splits, k-tiles per split) for the CUDA GEMM of format
    `fmt`. At M <= _SMALL_M the split count is the plan table's
    (autotune.lookup_split: measured on this card kind for (fmt, M
    bucket, Kq, N), trusted only beyond its noise gate), else
    heuristic_splits'; the large-M tile takes one split. The k split
    fixes the bits of a small-M output (each split's 32-deep k-tiles
    summed in order, the splits in order): the megakernels
    (mlp_fused.py), gemm_batched and the lab take this plan, so they stay
    bitwise the chain under any table."""
    k_tiles = kq // _BK
    if m > _SMALL_M:
        return False, 1, k_tiles
    splits = (autotune.lookup_split(fmt, m, kq, n)
              or heuristic_splits(m, n, kq))
    return (True, *_plan_at(k_tiles, splits))


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t, or a copy of it at a 16-byte aligned address (TMA's)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _pad_n(n: int, codes, scales, gw, bias):
    """The large-M kernel's TMA maps need rows of a multiple of 16 bytes:
    (n16, codes, scales, gw, bias) with N padded by zero columns to n16
    (the operands as they are when N % 16 == 0). The zero columns give
    zero outputs, sliced off by the caller."""
    pad = -n % 16
    if not pad:
        return n, codes, scales, gw, bias

    def p(t):
        return None if t is None else torch.nn.functional.pad(t, (0, pad))
    return n + pad, p(codes), p(scales), p(gw), p(bias)


def _gemm_cuda(w4, xa, codes, scales, gs, gw, bias, out_dtype,
               splits: Optional[int] = None):
    """Launch the fused GEMM of the format (w4: codes uint8 [Kq/2, N];
    else int8 [Kq, N]). gs: [M, 1] f32; gw: [1, N] f32. `splits` forces
    the small-M tile's split count (autotune's candidates); by default
    _split_plan's."""
    kernel = GEMM_W4 if w4 else GEMM_W8
    _build.require_cuda(kernel.name, xa, codes, scales, gs, gw, bias)
    m, kq = xa.shape
    n = codes.shape[1]
    if (xa.dtype != torch.bfloat16
            or codes.dtype != (torch.uint8 if w4 else torch.int8)
            or scales.dtype != torch.uint8
            or codes.shape[0] != (kq // 2 if w4 else kq)
            or scales.shape != (kq // 16, n) or kq % _BK
            or out_dtype not in (torch.bfloat16, torch.float32)
            or (bias is not None and bias.dtype != torch.bfloat16)):
        raise ValueError(
            f"{kernel.name}: unsupported operands xa {tuple(xa.shape)} "
            f"{xa.dtype}, codes {tuple(codes.shape)} {codes.dtype}, "
            f"out {out_dtype}")
    xa = xa.contiguous()
    codes, scales = codes.contiguous(), scales.contiguous()
    gs = gs.reshape(-1).float().contiguous()
    gw = gw.reshape(-1).float().contiguous()
    bias = bias.contiguous() if bias is not None else None
    if splits is None:
        small, splits, per = _split_plan(m, n, kq, "w4" if w4 else "w8")
    elif m <= _SMALL_M and 1 <= splits <= kq // _BK:
        small, (splits, per) = True, _plan_at(kq // _BK, splits)
    else:
        raise ValueError(f"{kernel.name}: no plan of {splits} splits at "
                         f"M {m}, Kq {kq}")
    n_run = n
    if not small:
        n_run, codes, scales, gw, bias = _pad_n(n, codes, scales, gw, bias)
        xa, codes, scales = _aligned(xa), _aligned(codes), _aligned(scales)
    out = torch.empty((m, n_run), dtype=out_dtype, device=xa.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32,
                      device=xa.device) if splits > 1 else None)
    kernel(_build.ptr(xa), _build.ptr(codes), _build.ptr(scales),
           _build.ptr(gs), _build.ptr(gw), _build.ptr(bias), _build.ptr(out),
           int(out_dtype == torch.float32), _build.ptr(ws),
           m, n_run, kq, int(small), splits, per)
    return out if n_run == n else out[:, :n].contiguous()


def _gemm_w8_cuda(xa, codes, scales, gs, gw, bias, out_dtype, splits=None):
    """Launch csrc/gemm_w8.cu."""
    return _gemm_cuda(False, xa, codes, scales, gs, gw, bias, out_dtype,
                      splits)


def _gemm_w4_cuda(xa, codes, scales, gs, gw, bias, out_dtype, splits=None):
    """Launch csrc/gemm_w4.cu."""
    return _gemm_cuda(True, xa, codes, scales, gs, gw, bias, out_dtype,
                      splits)


def _gemm_batched_cuda(xa, codes, scales, gs, gw, out_dtype):
    """Launch csrc/gemm_batched.cu over all experts at once. xa: [E, M,
    Kq] bf16; codes: [E, Kq, N] int8 or [E, Kq/2, N] uint8; scales:
    [E, Kq/16, N]; gs: [E, M, 1] f32; gw: [E, 1, N] f32. Each expert takes
    the split plan of a single GEMM of its shape and format."""
    _build.require_cuda("gemm_batched", xa, codes, scales, gs, gw)
    w4 = codes.dtype == torch.uint8
    e, m, kq = xa.shape
    n = codes.shape[-1]
    if (xa.dtype != torch.bfloat16 or codes.dim() != 3
            or codes.dtype not in (torch.uint8, torch.int8)
            or scales.dtype != torch.uint8
            or codes.shape != (e, kq // 2 if w4 else kq, n)
            or scales.shape != (e, kq // 16, n) or kq % _BK
            or out_dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(
            f"gemm_batched: unsupported operands xa {tuple(xa.shape)} "
            f"{xa.dtype}, codes {tuple(codes.shape)} {codes.dtype}, "
            f"out {out_dtype}")
    xa = xa.contiguous()
    codes, scales = codes.contiguous(), scales.contiguous()
    gs = gs.float().expand(e, m, 1).contiguous()
    gw = gw.float().expand(e, 1, n).contiguous()
    small, splits, per = _split_plan(m, n, kq, "w4" if w4 else "w8")
    n_run = n
    if not small:
        n_run, codes, scales, gw, _ = _pad_n(n, codes, scales, gw, None)
        xa, codes, scales = _aligned(xa), _aligned(codes), _aligned(scales)
    out = torch.empty((e, m, n_run), dtype=out_dtype, device=xa.device)
    ws = (torch.empty((e, splits, m, n), dtype=torch.float32,
                      device=xa.device) if splits > 1 else None)
    GEMM_BATCHED(int(w4), _build.ptr(xa), _build.ptr(codes),
                 _build.ptr(scales), _build.ptr(gs), _build.ptr(gw),
                 _build.ptr(out), int(out_dtype == torch.float32),
                 _build.ptr(ws), e, m, n_run, kq, int(small), splits, per)
    return out if n_run == n else out[..., :n].contiguous()


def gemm_batched_chain(xa, codes, scales, gs, gw, out_dtype):
    """The batched GEMM as one gemm_w8 / gemm_w4 launch per expert: what
    gemm_batched must equal bit for bit. The A/B reference of the batched
    kernel, not a route of the port (arguments as _each_expert's)."""
    return _each_expert(_gemm_w8_cuda, _gemm_w4_cuda, xa, codes, scales, gs,
                        gw, out_dtype)


def _dequant_cuda(w4, codes, scales, gw):
    """Launch csrc/dequant.cu's decode of the format: bf16 [Kq, N] (w8)
    or [2, Kq/2, N] (w4); for a stack (codes [E, rows, N], gw [E, N]) one
    launch over all experts: [E, Kq, N] or [E, 2, Kq/2, N]."""
    kernel = DEQUANT_W4 if w4 else DEQUANT_W8
    _build.require_cuda(kernel.name, codes, scales, gw)
    lead = codes.shape[:-2]
    e = codes.shape[0] if lead else 1
    rows, n = codes.shape[-2:]
    group_rows = 8 if w4 else 16
    if (codes.dtype != (torch.uint8 if w4 else torch.int8)
            or scales.dtype != torch.uint8 or len(lead) > 1
            or rows % group_rows
            or scales.shape != (*lead, rows // group_rows, n)
            or (gw is not None and gw.numel() != e * n)):
        raise ValueError(
            f"{kernel.name}: unsupported codes {tuple(codes.shape)} "
            f"{codes.dtype}, scales {tuple(scales.shape)} {scales.dtype}")
    codes, scales = codes.contiguous(), scales.contiguous()
    gw = gw.reshape(-1).float().contiguous() if gw is not None else None
    out = torch.empty((*lead, 2, rows, n) if w4 else (*lead, rows, n),
                      dtype=torch.bfloat16, device=codes.device)
    kernel(_build.ptr(codes), _build.ptr(scales), _build.ptr(gw),
           _build.ptr(out), e, rows, n)
    return out


def _dequant_w8_cuda(codes, scales, gw=None):
    return _dequant_cuda(False, codes, scales, gw)


def _dequant_w4_cuda(codes, scales, gw=None):
    return _dequant_cuda(True, codes, scales, gw)


def _pin_rowmajor_cuda(x):
    """Launch csrc/dequant.cu arc_pin_rowmajor: bf16 [M, Kq] ->
    split_even_odd as a new contiguous bf16 [M, Kq]."""
    _build.require_cuda("pin_rowmajor", x)
    m, k = x.shape
    if x.dtype != torch.bfloat16 or k % 8:
        raise ValueError(f"pin_rowmajor: unsupported x {tuple(x.shape)} "
                         f"{x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    PIN_ROWMAJOR(_build.ptr(x), _build.ptr(out), m, k)
    return out


def _mm_f32_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 [M, K] @ bf16 [K, N] (or a batch of them, [E, M, K] @ [E, K,
    N]) accumulated like f32, as XLA's dot with
    preferred_element_type=f32 on the TPU. torch.mm's f32 output alone is
    not enough on an H100: the tensor cores carry their partial sums
    truncated, 8.3x the f32 error against f64 on bf16 activations (A16)
    over K 4096. So each MM_CHUNK_K slice of k is one product whose
    result cuBLAS adds into the f32 total (addmm or baddbmm, in place), as
    the fused GEMM promotes each 32-deep k-tile: 1.2x the f32 error at
    512, 2.0x at 1024 (chip_smoke.py; PERF.md)."""
    mm, addmm = ((torch.bmm, torch.baddbmm) if x.dim() == 3
                 else (torch.mm, torch.addmm))
    k = x.shape[-1]
    acc = mm(x[..., :MM_CHUNK_K], w[..., :MM_CHUNK_K, :],
             out_dtype=torch.float32)
    for c in range(MM_CHUNK_K, k, MM_CHUNK_K):
        addmm(acc, x[..., c:c + MM_CHUNK_K], w[..., c:c + MM_CHUNK_K, :],
              out_dtype=torch.float32, out=acc)
    return acc


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w of bf16 operands (2-D, or batched 3-D) with an f32 result
    accumulated like f32: an f32 matmul on the CPU, _mm_f32_cuda on the
    card. The products the JAX package leaves to XLA."""
    return x.float() @ w.float() if _cpu(x) else _mm_f32_cuda(x, w)


# -- dispatch -------------------------------------------------------------------

def _cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def pin_rowmajor(x: torch.Tensor) -> torch.Tensor:
    """split_even_odd(x) as a new contiguous bf16 [M, Kq]: the w4
    activation operand of a split-half decoded weight."""
    return (pin_rowmajor_plain if _cpu(x) else _pin_rowmajor_cuda)(x)


def dequant_weight(pw: Packed, fold_global: bool = False) -> torch.Tensor:
    """One-pass packed -> bf16 decode: [Kq, N] in scaled units, or with
    the weight global scale folded in; a stack of experts ([E, Kq(/2),
    N] codes) decodes in one launch to [E, Kq, N]. As in the JAX package,
    w4 rows come back in the split-half k order (even ks, then odd ks, per
    expert): contract them only with split_even_odd activations."""
    lead = pw.codes.shape[:-2]
    gw = None
    if fold_global:
        e = lead[0] if lead else 1
        gw = pw.global_scale.float().reshape(e, -1).expand(e, pw.n)
        gw = gw.reshape(*lead, pw.n)
    if isinstance(pw, PackedWeightI8):
        impl = dequant_w8_plain if _cpu(pw.codes) else _dequant_w8_cuda
        return impl(pw.codes, pw.scales, gw)
    impl = dequant_w4_plain if _cpu(pw.codes) else _dequant_w4_cuda
    return impl(pw.codes, pw.scales, gw).reshape(*lead, pw.kq, pw.n)


def _gemm_route(xa, pw: Packed, gs, gw, out_dtype):
    """The large-M route: the decoded weight, the activation operand (for
    w4 split even/odd by pin_rowmajor; for w8 xa as it is, already
    row-major), their f32 product, the epilogue."""
    w = dequant_weight(pw)
    if isinstance(pw, PackedWeight):
        x = pin_rowmajor(xa)
    else:
        x = xa.to(torch.bfloat16)
    acc = matmul_f32(x, w)
    del w, x                          # the decoded weight is a transient
    return _epilogue(acc, gs, gw, pw.bias, out_dtype)


def gemm_dequant(xa: torch.Tensor, pw: Packed, gx,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y[M, N] = (xa @ dec(pw)) * (gx * pw.global_scale) + pw.bias.

    xa: [M, Kq] bf16 in scaled units and natural k order (Kq == pw.kq);
    pw: a PackedWeightI8 (w8) or PackedWeight (w4); gx: the activation
    global scale, a float, a scalar tensor or [M, 1]."""
    if not isinstance(pw, (PackedWeight, PackedWeightI8)):
        raise TypeError(f"gemm_dequant: not a packed weight: {type(pw)}")
    m, n = xa.shape[0], pw.n
    if isinstance(gx, numbers.Real):     # a fill, no host-to-device copy
        gs = torch.full((m, 1), float(gx), dtype=torch.float32,
                        device=xa.device)
    else:
        gs = torch.as_tensor(gx, dtype=torch.float32, device=xa.device)
        gs = gs.reshape(-1, 1).expand(m, 1)
    gw = pw.global_scale.float().reshape(1, -1).expand(1, n)
    if XLA_M and m >= XLA_M and n >= pw.kq:
        return _gemm_route(xa, pw, gs, gw, out_dtype)
    if isinstance(pw, PackedWeight):
        impl = gemm_w4_plain if _cpu(xa) else _gemm_w4_cuda
    else:
        impl = gemm_w8_plain if _cpu(xa) else _gemm_w8_cuda
    return impl(xa, pw.codes, pw.scales, gs, gw, pw.bias, out_dtype)


def gemm_dequant_batched(xa: torch.Tensor, pw: Packed, gx,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """y[E, M, N] = (xa[e] @ dec(pw[e])) * gx[e] * pw.global_scale[e].

    xa: [E, M, Kq] bf16 in scaled units and natural k order; pw: a stack
    of experts' packs (codes [E, Kq(/2), N], scales [E, Kq/16, N], global
    scale [E, N] or [E]); gx: a float, a scalar tensor, [E] or [E, M, 1].
    Always the fused GEMM (one gemm_batched launch), with no large-M
    route: its callers are decode-shaped, as in the JAX package."""
    if not isinstance(pw, (PackedWeight, PackedWeightI8)) or (
            pw.codes.dim() != 3):
        raise TypeError("gemm_dequant_batched: not a stacked packed weight")
    e, m, _ = xa.shape
    n = pw.n
    if isinstance(gx, numbers.Real):     # a fill, as gemm_dequant's
        gs = torch.full((e, m, 1), float(gx), dtype=torch.float32,
                        device=xa.device)
    else:
        gs = torch.as_tensor(gx, dtype=torch.float32, device=xa.device)
        gs = (gs.reshape(-1, 1, 1) if gs.dim() <= 1
              else gs.reshape(e, m, 1)).expand(e, m, 1)
    gw = pw.global_scale.float().reshape(e, 1, -1).expand(e, 1, n)
    impl = gemm_batched_plain if _cpu(xa) else _gemm_batched_cuda
    return impl(xa, pw.codes, pw.scales, gs, gw, out_dtype)
