"""Activation quantization for the w8 GEMM (counterpart of
``arcquant_tpu/kernels/quantize.py``).

One kernel (``csrc/actq.cu``, replacing the TPU kernel ``_actq_kernel``)
does the per-row NVFP4 quantize in three pre-op modes; ``actq_plain`` is
its plain PyTorch version. ``actq_plan`` sets its block count from the
shapes alone (a row is split over many blocks at decode), and
``actq_kernel_order`` is the plain version with the kernel's rmsnorm sum
order (``rms_norm_kernel_order``), which gives the kernel's bits in every
mode. The ARC residual, qdq(x/gx - q(x)) of the KE selected columns
written into xa[:, k:k+KE] after the row quantize, is a second kernel
(``csrc/arc_residual.cu``, #18, ``arc_residual``): the port's
counterpart of XLA's fusion of the JAX package's ``_arc_residual_into``
with the column take (and, at down_in, the silu(g)*u recompute of the
selected columns); ``arc_residual_plain`` is its plain version.

Routing follows the JAX package: the rmsnorm mode only when the site
has no ARC residual (with ARC: rms_norm, then the plain mode, then the
residual). Per-tensor activation scales (per_row=False, the accuracy
path's act_scale "tensor") take no kernel, as in the JAX package: one
global scale, the group qdq and the residual in plain torch ops
(``_quantize_x_tensor``). ``silu_mul_quantize_gu`` takes the silu_mul mode at every M.
The JAX package rounds silu(g)*u to bf16 in XLA at M <= 16 instead
(ARC_SILU_GU_DEFUSE_M); on the CPU the two routes give the same bits,
and on the card the kernel's expf is the one the decode megakernels
(kernels/mlp_fused.py) run, so the chain they must equal bit for bit is
this one.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..models.llama import rms_norm
from ..quant import numerics as N
from ..quant import packing
from . import _build

_MODES = {"plain": 0, "rmsnorm": 1, "silu_mul": 2}

# The least M at which the JAX package runs its actq kernel (the
# _actq_pallas_min_m default); below it JAX quantizes through XLA. The
# port's kernel runs at every M, but the fused decode routes keep JAX's
# floor (actq_ok), so they engage on exactly JAX's shapes.
ACTQ_MIN_M = 4

ACTQ = _build.Kernel("actq", "arc_actq", [
    _build.P, _build.I64, _build.P, _build.P, _build.P,
    _build.I32, _build.I32, _build.I32, _build.I32, _build.F32, _build.I32])
# An empty kernel of the same source, for the benchmarks only: the
# launch floor timed beside actq (launch_floor).
LAUNCH_FLOOR = _build.Kernel("launch_floor", "arc_launch_floor",
                             [_build.I32])
# #18: the ARC residual of the selected columns (csrc/arc_residual.cu).
ARC_RESIDUAL = _build.Kernel("arc_residual", "arc_residual", [
    _build.P, _build.I64, _build.P, _build.I64, _build.P, _build.I64,
    _build.P, _build.I32, _build.I32, _build.I32, _build.I32, _build.I32])

# The kernel's block (csrc/actq_core.cuh kActqThreads): its rmsnorm sum
# order is stated for this many threads.
ACTQ_THREADS = 256
# actq_plan: the blocks a launch aims at when rows are few (one an SM of
# an H100), and the fewest 16-groups a block quantizes when a row is
# split (each block reads its row whole for the row's reductions).
ACTQ_TARGET_BLOCKS = 132
ACTQ_MIN_GROUPS = 8


def actq_plan(m: int, k: int, mode: str) -> int:
    """Blocks of one actq launch over [m, k] in `mode`, from the shapes
    alone. Block b quantizes the range [m G b / n, m G (b + 1) / n) of the
    flattened (row, 16-group) space (G = k / 16, n the blocks), so each
    row is cut into `slices` ranges: enough that m x slices reaches
    ACTQ_TARGET_BLOCKS when rows are few (a decode step puts many SMs on
    a row), one when there are ACTQ_TARGET_BLOCKS rows or more (a
    prefill fills the card with rows), and never below ACTQ_MIN_GROUPS
    groups a range. Every mode takes this rule: at M 4 the slice count
    barely moves plain and rmsnorm, and silu_mul, each of whose blocks
    runs the row's silu for its |max|, is fastest from 16 slices to 33
    (benchmarks/bench_decode.py --sweep)."""
    if mode not in _MODES:
        raise ValueError(f"actq: unknown mode {mode!r}")
    groups = k // 16
    slices = max(1, min(-(-ACTQ_TARGET_BLOCKS // max(m, 1)),
                        groups // ACTQ_MIN_GROUPS))
    return m * slices


def launch_floor(blocks: int) -> None:
    """Launch the empty kernel (benchmarks only): `blocks` blocks of
    ACTQ_THREADS threads on the current stream."""
    LAUNCH_FLOOR(blocks)


def _silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in f32, rounded to gate's dtype (the engine's
    rounding point before the down_in quantize)."""
    g = gate.float()
    return (g * torch.sigmoid(g) * up.float()).to(gate.dtype)


def rms_sumsq_kernel_order(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares of each row of x [M, K] (K % 8 == 0) in the
    actq kernel's order (csrc/actq_core.cuh's header), with explicit f32
    adds: thread t of ACTQ_THREADS adds the squares of its 8-element
    chunks t, t + 256, ... in order, each warp's 32 totals are summed by
    a butterfly (xor 16, 8, 4, 2, 1), then the 8 warp totals (24 lanes of
    0.0) by the same butterfly. Returns f32 [M]."""
    m, k = x.shape
    nt, chunks = ACTQ_THREADS, k // 8
    passes = max(1, -(-chunks // nt))
    sq = torch.zeros((m, passes * nt * 8), dtype=torch.float32,
                     device=x.device)
    xf = x.float()
    sq[:, :k] = xf * xf                      # exact: squares of bf16
    sq = sq.reshape(m, passes, nt, 8)
    s = torch.zeros((m, nt), dtype=torch.float32, device=x.device)
    for p in range(passes):
        for j in range(8):
            s = s + sq[:, p, :, j]
    lane = torch.arange(32, device=x.device)

    def butterfly(v):                        # [..., 32] -> [...]
        for o in (16, 8, 4, 2, 1):
            v = v + v[..., lane ^ o]
        return v[..., 0]
    warps = butterfly(s.reshape(m, nt // 32, 32))
    return butterfly(torch.nn.functional.pad(warps, (0, 32 - nt // 32)))


def rms_norm_kernel_order(x: torch.Tensor, w: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """llama.rms_norm's rounding chain with the actq kernel's sum order:
    inv = 1 / sqrt(ss / K + eps) in f32 (each step one IEEE operation on
    tensors, so no library rewrites a divide as a multiply), x * inv
    rounded to bf16, times w in bf16."""
    k = x.shape[1]
    ss = rms_sumsq_kernel_order(x)[:, None]
    full = functools.partial(torch.full_like, ss)
    inv = torch.div(full(1.0), torch.sqrt(torch.div(ss, full(k))
                                          + full(eps)))
    return (x.float() * inv).to(x.dtype) * w


def actq_plain(a: torch.Tensor, w: Optional[torch.Tensor] = None, *,
               mode: str, k: int, kq: int, eps: float = 0.0,
               norm=rms_norm):
    """Plain version of the actq kernel. a: [M, k] (or [M, 2k] for
    silu_mul: gate then up). Returns (xa bf16 [M, kq] zero-padded from
    k, gx f32 [M, 1]). `norm` is the rmsnorm mode's normalisation."""
    if mode == "silu_mul":
        xf = _silu_mul(a[:, :k], a[:, k:2 * k])
    elif mode == "rmsnorm":
        xf = norm(a[:, :k], w, eps)
    else:
        xf = a
    xf = xf.float()
    gx = N.nvfp4_global_scale(xf, per_row=True)
    xa = torch.zeros((a.shape[0], kq), dtype=torch.bfloat16,
                     device=a.device)
    xa[:, :k] = N.nvfp4_qdq_scaled(xf / gx).to(torch.bfloat16)
    return xa, gx


# The plain version with the kernel's rmsnorm sum order: the kernel's
# bits in every mode (the A/B reference of the rmsnorm mode on the card).
actq_kernel_order = functools.partial(actq_plain, norm=rms_norm_kernel_order)


def _aligned(t: torch.Tensor) -> bool:
    """Rows the kernel reads with 16-byte loads: a 16-byte aligned start
    and a row stride of whole 16-byte chunks."""
    return t.data_ptr() % 16 == 0 and (t.shape[0] <= 1
                                       or t.stride(0) % 8 == 0)


def _aligned_weight(w: torch.Tensor) -> torch.Tensor:
    """The norm weight as a contiguous vector on 16 bytes."""
    wc = w.reshape(-1).contiguous()
    return wc if wc.data_ptr() % 16 == 0 else wc.clone()


def _actq_cuda(a: torch.Tensor, w: Optional[torch.Tensor] = None, *,
               mode: str, k: int, kq: int, eps: float = 0.0):
    """Launch csrc/actq.cu on actq_plan's blocks. Takes bf16 rows with a
    unit column stride; rows that do not start on 16 bytes are copied
    first."""
    _build.require_cuda("actq", a, w)
    if a.dtype != torch.bfloat16 or (w is not None
                                     and w.dtype != torch.bfloat16):
        raise ValueError(f"actq kernel takes bf16, got {a.dtype}")
    if a.stride(1) != 1 or k % 16 or kq % 8 or kq < k:
        raise ValueError(f"actq: unsupported layout k={k} kq={kq} "
                         f"strides={a.stride()}")
    need = 2 * k if mode == "silu_mul" else k
    if a.shape[1] < need or (mode == "rmsnorm" and w is None):
        raise ValueError(f"actq {mode}: input {tuple(a.shape)} for k={k}")
    m = a.shape[0]
    if not _aligned(a):
        a = a[:, :need].contiguous()
    wc = None
    if w is not None:
        if w.numel() < k:
            raise ValueError(f"actq rmsnorm: weight of {w.numel()} for "
                             f"k={k}")
        wc = _aligned_weight(w)
    xa = torch.empty((m, kq), dtype=torch.bfloat16, device=a.device)
    gx = torch.empty((m, 1), dtype=torch.float32, device=a.device)
    ACTQ(_build.ptr(a), a.stride(0), _build.ptr(wc), _build.ptr(xa),
         _build.ptr(gx), m, k, kq, _MODES[mode], float(eps),
         actq_plan(m, k, mode), m=m)
    return xa, gx


def _actq(a, w=None, *, mode: str, k: int, kq: int, eps: float = 0.0):
    impl = actq_plain if a.device.type == "cpu" else _actq_cuda
    return impl(a, w, mode=mode, k=k, kq=kq, eps=eps)


def actq_ok(m: int, k: int, kq: int) -> bool:
    """Whether the JAX package would quantize an [m, k] activation into
    width kq with its actq kernel (its _actq_pallas_ok at per-row
    scales): the fused routes' precondition."""
    return m >= ACTQ_MIN_M and k % 128 == 0 and kq % 128 == 0


def _arc_residual_into(x_cols: torch.Tensor, xa: torch.Tensor,
                       gx: torch.Tensor, idx: torch.Tensor, k: int):
    """Write the ARC residual qdq(x/gx - q(x)) of the selected columns
    into xa[:, k:k+KE] in place. q(x) is read back from xa: its values
    are exact in bf16."""
    qx_cols = xa[:, idx].float()
    err = x_cols.float() / gx - qx_cols
    xa[:, k:k + idx.numel()] = N.nvfp4_qdq_scaled(err).to(xa.dtype)
    return xa


def _quantize_x_tensor(x: torch.Tensor, reorder_index: torch.Tensor,
                       select_num: int, kq: int):
    """act_scale "tensor": one global scale over the whole activation,
    in plain torch ops (the JAX package runs this route in XLA, with no
    Pallas kernel): the group qdq of x / gx, the ARC residual of the
    top columns, zeros up to kq. Returns (xa bf16 [M, kq], gx f32
    scalar)."""
    m, k = x.shape
    gx = N.nvfp4_global_scale(x)
    qx = N.nvfp4_qdq_scaled(x.float() / gx)
    parts = [qx]
    if select_num:
        idx = _top(reorder_index, select_num, x.device)
        parts.append(N.nvfp4_qdq_scaled(x[:, idx].float() / gx
                                        - qx[:, idx]))
    if kq > k + select_num:
        parts.append(torch.zeros((m, kq - k - select_num),
                                 dtype=torch.float32, device=x.device))
    return torch.cat(parts, dim=1).to(torch.bfloat16), gx


def _top(reorder_index: torch.Tensor, select_num: int,
         device) -> torch.Tensor:
    return reorder_index[-select_num:].long().to(device)


def arc_residual_plain(src: torch.Tensor, xa: torch.Tensor,
                       gx: torch.Tensor, reorder_index: torch.Tensor,
                       select_num: int, k: int, mode: str = "plain"):
    """Plain version of #18 arc_residual: the last select_num columns of
    reorder_index (_top), their values in src (plain) or silu(g) * u of
    them rounded like _silu_mul (silu_mul: src the unsliced [M, 2k]
    gate-up output), then _arc_residual_into. Returns xa, written in
    place."""
    idx = _top(reorder_index, select_num, src.device)
    if mode == "plain":
        cols = src[:, idx]
    elif mode == "silu_mul":
        cols = _silu_mul(src[:, idx], src[:, idx + k])
    else:
        raise ValueError(f"arc_residual: unknown mode {mode!r}")
    return _arc_residual_into(cols, xa, gx, idx, k)


def _arc_residual_cuda(src: torch.Tensor, xa: torch.Tensor,
                       gx: torch.Tensor, reorder_index: torch.Tensor,
                       select_num: int, k: int, mode: str = "plain"):
    """Launch csrc/arc_residual.cu. The index tail is read in place (no
    cast, no copy: the call can be captured in a graph); an index outside
    [0, k) is a device-side assert."""
    _build.require_cuda("arc_residual", src, xa, gx, reorder_index)
    if mode not in ("plain", "silu_mul"):
        raise ValueError(f"arc_residual: unknown mode {mode!r}")
    if src.dtype != torch.bfloat16 or xa.dtype != torch.bfloat16:
        raise ValueError(f"arc_residual takes bf16 src and xa, got "
                         f"{src.dtype} and {xa.dtype}")
    m = src.shape[0]
    if gx.dtype != torch.float32 or tuple(gx.shape) != (m, 1):
        raise ValueError(f"arc_residual: gx {tuple(gx.shape)} {gx.dtype}, "
                         f"expected f32 [{m}, 1]")
    if select_num % 16 or select_num < 0 or k + select_num > xa.shape[1]:
        raise ValueError(f"arc_residual: KE={select_num} at k={k} into kq="
                         f"{xa.shape[1]}: needs KE % 16 == 0 and k + KE <= "
                         "kq")
    need = 2 * k if mode == "silu_mul" else k
    if (src.dim() != 2 or xa.dim() != 2 or xa.shape[0] != m
            or src.shape[1] < need or src.stride(1) != 1
            or xa.stride(1) != 1 or reorder_index.dim() != 1
            or reorder_index.stride(0) != 1
            or reorder_index.dtype not in (torch.int32, torch.int64)
            or select_num > reorder_index.numel()):
        raise ValueError(f"arc_residual {mode}: unsupported layout src "
                         f"{tuple(src.shape)} strides {src.stride()}, xa "
                         f"{tuple(xa.shape)} strides {xa.stride()}, index "
                         f"{tuple(reorder_index.shape)} "
                         f"{reorder_index.dtype} for k={k}")
    idx = reorder_index[reorder_index.numel() - select_num:]
    ARC_RESIDUAL(_build.ptr(src), src.stride(0), _build.ptr(xa),
                 xa.stride(0), _build.ptr(gx), gx.stride(0), _build.ptr(idx),
                 int(idx.dtype == torch.int64), m, k, select_num,
                 _MODES[mode], m=m)
    return xa


def arc_residual(src: torch.Tensor, xa: torch.Tensor, gx: torch.Tensor,
                 reorder_index: torch.Tensor, select_num: int, k: int,
                 mode: str = "plain"):
    """Write the ARC residual of the last select_num columns of
    reorder_index into xa[:, k:k+select_num] in place, after the row
    quantize that wrote xa[:, :k] and gx f32 [M, 1]: src is the [M, k]
    activation (mode "plain") or the unsliced [M, 2k] gate-up output
    (mode "silu_mul"). #18 on CUDA tensors, arc_residual_plain on CPU
    ones. Returns xa."""
    impl = (arc_residual_plain if src.device.type == "cpu"
            else _arc_residual_cuda)
    return impl(src, xa, gx, reorder_index, select_num, k, mode)


def quantize_x_arc(x: torch.Tensor, reorder_index: torch.Tensor,
                   select_num: int, kq: Optional[int] = None,
                   per_row: bool = True):
    """Quantize a [M, K] activation for the w8 GEMM. Returns (xa bf16
    [M, kq] in scaled units, gx f32 [M, 1]); with per_row=False (the
    accuracy path's act_scale "tensor") gx is one f32 scalar over the
    tensor and no kernel runs (_quantize_x_tensor)."""
    m, k = x.shape
    if kq is None:
        kq = packing.pad_kq(k, select_num)
    if not per_row:
        return _quantize_x_tensor(x, reorder_index, select_num, kq)
    xa, gx = _actq(x, None, mode="plain", k=k, kq=kq)
    if select_num:
        arc_residual(x, xa, gx, reorder_index, select_num, k)
    return xa, gx


def rmsnorm_quantize_x(x: torch.Tensor, norm_w: torch.Tensor, eps: float,
                       reorder_index: torch.Tensor, select_num: int,
                       kq: Optional[int] = None, per_row: bool = True):
    """RMSNorm then quantize. The fused rmsnorm mode runs only for sites
    without an ARC residual at per-row scales; otherwise rms_norm, then
    quantize_x_arc."""
    m, k = x.shape
    if kq is None:
        kq = packing.pad_kq(k, select_num)
    if select_num == 0 and per_row:
        return _actq(x, norm_w, mode="rmsnorm", k=k, kq=kq, eps=eps)
    return quantize_x_arc(rms_norm(x, norm_w, eps), reorder_index,
                          select_num, kq, per_row)


def silu_mul_quantize_gu(gu: torch.Tensor, reorder_index: torch.Tensor,
                         select_num: int, kq: Optional[int] = None,
                         per_row: bool = True):
    """silu(gu[:, :F]) * gu[:, F:] then quantize, over the unsliced
    [M, 2F] gate-up output. The product rounds to gu.dtype before the
    quantize on every route; at per-tensor scales (per_row=False) the
    rounded product goes to quantize_x_arc's plain route."""
    k = gu.shape[1] // 2
    if kq is None:
        kq = packing.pad_kq(k, select_num)
    if not per_row:
        return quantize_x_arc(_silu_mul(gu[:, :k], gu[:, k:]),
                              reorder_index, select_num, kq, per_row)
    xa, gx = _actq(gu, None, mode="silu_mul", k=k, kq=kq)
    if select_num:
        arc_residual(gu, xa, gx, reorder_index, select_num, k, "silu_mul")
    return xa, gx
