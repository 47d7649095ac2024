"""Decode megakernels (counterpart of ``arcquant_tpu/kernels/mlp_fused.py``).

Three fused functions of the decode step. Each is one launch of
``csrc/mlp_fused.cu`` on CUDA tensors and its plain PyTorch version on
CPU tensors:

  gemm_w8_actq_fused    [rmsnorm +] quantize + one w8 GEMM: the attn_in
                        (qkv, norm mode) and o_in (plain) sites; replaces
                        the TPU kernel _gemm_actq_kernel.
  gateup_silu_quantize  gateup GEMM + silu(g)*u + quantize, returning
                        (xa2, gu, gx2): the MLP when down_in has an ARC
                        residual, which the caller injects before the down
                        GEMM; replaces _gu_actq_kernel.
  mlp_w8_fused          [rmsnorm +] quantize + gateup + silu(g)*u +
                        quantize + down: the whole MLP when down_in is
                        select-free; replaces _mlp_w8_kernel.

Numerics: equal bit for bit to the unfused chain of the same M (actq ->
gemm_w8 at gemm.py:_split_plan's k split -> actq silu_mul -> gemm_w8),
which is the JAX package's contract for these kernels. The CUDA kernels
run the chain's own device code (csrc/actq_core.cuh, and the small-M
GEMM mainloop of csrc/gemm_small_m.cuh); the plain versions compose the
chain's plain versions.

Gates (gemm_actq_ok, gu_actq_ok, mlp_fused_ok) keep the JAX package's
conditions: M at least quantize.ACTQ_MIN_M (no fused route where JAX
would quantize through XLA), M at most MLP_FUSED_M, per-row scales,
PackedWeightI8 weights, f % 128 == 0 with kq2 >= f, and a select-free
input site for #14 and #12. They drop JAX's k-block condition: the JAX
megakernels stream at the k block gemm_dequant would pick
(``_engine_bk``: its autotune table, else its heuristic, limited to
``_OK_BKS``, so that they stay bitwise the chain). The port's
counterpart is the k split: each fused GEMM takes gemm.py:_split_plan's
answer for its shape in w8 (``_plan``), which is the plan table's
measured split (kernels/autotune.py) or the heuristic's, the same one
the chain's gemm_w8 launch takes. Any split the plan gives is legal for
the fused kernels (their persistent grid walks (n-tile, split) items,
their workspace is sized by ``_ws``), so no ``_OK_BKS`` gate carries
over.

MLP_FUSED_M takes the place of JAX's ARC_MLP_FUSED_M environment
variable (0 turns the routes off); the engine's own switch is
``InferenceEngine(..., fused_decode=False)``.
"""

from __future__ import annotations

import numbers
from typing import Optional

import torch

from ..quant.packing import PackedWeightI8
from . import _build
from . import gemm as gk
from . import quantize as qk

# Largest M routed through the megakernels (0 = off). The CUDA kernels'
# tile holds 16 rows, so a larger M raises there.
MLP_FUSED_M = 16
_MAX_ROWS = 16

P, I32, I64, F32 = _build.P, _build.I32, _build.I64, _build.F32
GEMM_ACTQ = _build.Kernel("gemm_actq", "arc_gemm_actq", [
    P, I64, P, I32, F32, P, P, P, P, P, I32, P, P, P,
    I32, I32, I32, I32, I32, I32, I32])
GU_ACTQ = _build.Kernel("gu_actq", "arc_gu_actq", [
    P, P, P, P, P, P, P, P, P, P, P, I32, I32, I32, I32, I32, I32])
MLP_W8 = _build.Kernel("mlp_w8", "arc_mlp_w8", [
    P, I64, P, F32, I32, I32, P, P, P, P, P, P, P, P, P, P, P, P, P,
    P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32, I32])


def _m_ok(m: int) -> bool:
    return MLP_FUSED_M > 0 and qk.ACTQ_MIN_M <= m <= MLP_FUSED_M


def _w8(pw) -> bool:
    return isinstance(pw, PackedWeightI8) and pw.codes.ndim == 2


def gemm_actq_ok(pw, m: int, d: int, per_row: bool,
                 select_num: int) -> bool:
    """Gate of gemm_w8_actq_fused at a site of m rows and width d."""
    return (_m_ok(m) and bool(per_row) and select_num == 0 and _w8(pw)
            and d % 128 == 0 and pw.kq >= d)


def gu_actq_ok(pw_gu, m: int, f: int, kq2: int, per_row: bool) -> bool:
    """Gate of gateup_silu_quantize (down_in may carry an ARC residual:
    the caller injects it)."""
    return (_m_ok(m) and bool(per_row) and _w8(pw_gu)
            and pw_gu.n == 2 * f and f % 128 == 0 and kq2 >= f)


def mlp_fused_ok(pw_gu, pw_dn, m: int, f: int, per_row: bool,
                 select_num_down: int) -> bool:
    """Gate of mlp_w8_fused: a select-free down_in."""
    return (_m_ok(m) and bool(per_row) and select_num_down == 0
            and _w8(pw_gu) and _w8(pw_dn) and pw_gu.n == 2 * f
            and f % 128 == 0 and pw_dn.kq >= f)


def _gw(pw: PackedWeightI8) -> torch.Tensor:
    """The weight's global scale as [1, N] f32 (a scalar broadcast)."""
    return pw.global_scale.float().reshape(1, -1).expand(1, pw.n)


def _rows_f32(gs, m: int, device) -> torch.Tensor:
    """A per-row (or scalar) activation scale as [M, 1] f32; a Python
    number becomes a fill on `device`, never a host-to-device copy (which
    a CUDA graph capture refuses)."""
    if isinstance(gs, numbers.Real):
        return torch.full((m, 1), float(gs), dtype=torch.float32,
                          device=device)
    gs = torch.as_tensor(gs, dtype=torch.float32, device=device)
    return gs.reshape(-1, 1).expand(m, 1)


# -- plain versions: the chain's plain versions, composed -------------------
# `actq` and `gemm` are the chain's two steps; the *_chain functions below
# pass the dispatching ones instead.

def gemm_actq_plain(x2: torch.Tensor, pw: PackedWeightI8, d: int,
                    out_dtype: torch.dtype, norm_w: Optional[torch.Tensor],
                    eps: float, actq=qk.actq_plain, gemm=gk.gemm_w8_plain):
    """Plain version of gemm_actq: (y [M, N], gx [M, 1])."""
    mode = "plain" if norm_w is None else "rmsnorm"
    xa, gx = actq(x2[:, :d], norm_w, mode=mode, k=d, kq=pw.kq, eps=eps)
    return gemm(xa, pw.codes, pw.scales, gx, _gw(pw), pw.bias,
                out_dtype), gx


def gu_actq_plain(xa1: torch.Tensor, gs1: torch.Tensor,
                  pw_gu: PackedWeightI8, f: int, kq2: int,
                  out_dtype: torch.dtype, actq=qk.actq_plain,
                  gemm=gk.gemm_w8_plain):
    """Plain version of gu_actq: (xa2 [M, kq2], gu [M, 2F], gx2 [M, 1]).
    gs1: [M, 1] f32."""
    gu = gemm(xa1, pw_gu.codes, pw_gu.scales, gs1, _gw(pw_gu), pw_gu.bias,
              out_dtype)
    xa2, gx2 = actq(gu, None, mode="silu_mul", k=f, kq=kq2)
    return xa2, gu, gx2


def mlp_w8_plain(xa1: torch.Tensor, gs1: Optional[torch.Tensor],
                 pw_gu: PackedWeightI8, pw_dn: PackedWeightI8, f: int,
                 out_dtype: torch.dtype, norm_w: Optional[torch.Tensor],
                 eps: float, actq=qk.actq_plain, gemm=gk.gemm_w8_plain):
    """Plain version of mlp_w8: (out [M, N2], gu, gx2). Norm mode (norm_w
    set): xa1 is the raw residual stream [M, d]; else xa1 [M, kq1] and
    gs1 [M, 1] f32."""
    if norm_w is not None:
        xa1, gs1 = actq(xa1, norm_w, mode="rmsnorm", k=xa1.shape[1],
                        kq=pw_gu.kq, eps=eps)
    xa2, gu, gx2 = gu_actq_plain(xa1, gs1, pw_gu, f, pw_dn.kq, out_dtype,
                                 actq, gemm)
    out = gemm(xa2, pw_dn.codes, pw_dn.scales, gx2, _gw(pw_dn), pw_dn.bias,
               out_dtype)
    return out, gu, gx2


# -- the unfused chain of the same functions ----------------------------------
# What the engine runs with fused_decode=False: actq then the GEMM, each
# its kernel on a CUDA tensor (its plain version on a CPU one), looked up
# when called. The kernels' A/B reference on the card.

def _chain_gemm(xa, *args):
    impl = gk.gemm_w8_plain if xa.device.type == "cpu" else gk._gemm_w8_cuda
    return impl(xa, *args)


def gemm_actq_chain(*args):
    return gemm_actq_plain(*args, actq=qk._actq, gemm=_chain_gemm)


def gu_actq_chain(*args):
    return gu_actq_plain(*args, actq=qk._actq, gemm=_chain_gemm)


def mlp_w8_chain(*args):
    return mlp_w8_plain(*args, actq=qk._actq, gemm=_chain_gemm)


# -- CUDA launches ------------------------------------------------------------

def _check_w8(name: str, pw) -> None:
    if (pw.codes.dtype != torch.int8 or pw.scales.dtype != torch.uint8
            or pw.kq % gk._BK or pw.scales.shape != (pw.kq // 16, pw.n)
            or (pw.bias is not None and pw.bias.dtype != torch.bfloat16)):
        raise ValueError(f"{name}: unsupported packed weight codes "
                         f"{tuple(pw.codes.shape)} {pw.codes.dtype}")


def _check_rows(name: str, x: torch.Tensor) -> None:
    if not 1 <= x.shape[0] <= _MAX_ROWS:
        raise ValueError(f"{name}: {x.shape[0]} rows, the kernel takes "
                         f"1..{_MAX_ROWS}")
    if x.dtype != torch.bfloat16 or x.stride(1) != 1:
        raise ValueError(f"{name}: takes bf16 rows with a unit column "
                         f"stride, got {x.dtype} {tuple(x.stride())}")


def phase_a_blocks(m: int, d: int, mode: str) -> int:
    """Blocks of a megakernel's grid that run its phase A ([rmsnorm +]
    quantize of [m, d]): the actq kernel's own plan (quantize.actq_plan),
    so phase A spreads a row over as many blocks as the chain's launch
    does. The kernel takes the first min(this, grid) blocks."""
    return qk.actq_plan(m, d, mode)


def _phase_a_rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """x as phase A reads it (16-byte loads): copied when its rows do not
    start on 16 bytes."""
    return x if qk._aligned(x) else x[:, :d].contiguous()


def _plan(m: int, pw: PackedWeightI8):
    """The chain's k split of this GEMM (the plan table's or the
    heuristic's): (splits, k-tiles per split)."""
    _, splits, per = gk._split_plan(m, pw.n, pw.kq, "w8")
    return splits, per


def _ws(m: int, device, *gemms) -> Optional[torch.Tensor]:
    """f32 split-K workspace for the largest [splits, M, N] of `gemms`
    ((splits, n) pairs), or None when no GEMM splits."""
    need = max((s * m * n for s, n in gemms if s > 1), default=0)
    return (torch.empty((need,), dtype=torch.float32, device=device)
            if need else None)


def _gemm_actq_cuda(x2, pw, d, out_dtype, norm_w, eps):
    """Launch arc_gemm_actq."""
    _build.require_cuda("gemm_actq", x2, norm_w, pw.codes, pw.scales,
                        pw.global_scale, pw.bias)
    _check_rows("gemm_actq", x2)
    _check_w8("gemm_actq", pw)
    m, kq, n = x2.shape[0], pw.kq, pw.n
    if (x2.shape[1] < d or d % 16 or kq < d
            or out_dtype not in (torch.bfloat16, torch.float32)
            or (norm_w is not None and (norm_w.dtype != torch.bfloat16
                                        or norm_w.numel() != d))):
        raise ValueError(f"gemm_actq: unsupported x {tuple(x2.shape)} d={d} "
                         f"kq={kq} out {out_dtype}")
    dev = x2.device
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    gx = torch.empty((m, 1), dtype=torch.float32, device=dev)
    xa = torch.empty((m, kq), dtype=torch.bfloat16, device=dev)
    splits, per = _plan(m, pw)
    ws = _ws(m, dev, (splits, n))
    x2 = _phase_a_rows(x2, d)
    wc = qk._aligned_weight(norm_w) if norm_w is not None else None
    mode = "plain" if norm_w is None else "rmsnorm"
    gw = _gw(pw).reshape(-1).contiguous()
    GEMM_ACTQ(_build.ptr(x2), x2.stride(0), _build.ptr(wc),
              int(norm_w is not None), float(eps), _build.ptr(pw.codes),
              _build.ptr(pw.scales), _build.ptr(gw), _build.ptr(pw.bias),
              _build.ptr(y), int(out_dtype == torch.float32), _build.ptr(gx),
              _build.ptr(xa), _build.ptr(ws), m, n, d, kq, splits, per,
              phase_a_blocks(m, d, mode))
    return y, gx


def _gu_actq_cuda(xa1, gs1, pw_gu, f, kq2, out_dtype):
    """Launch arc_gu_actq."""
    _build.require_cuda("gu_actq", xa1, gs1, pw_gu.codes, pw_gu.scales,
                        pw_gu.global_scale, pw_gu.bias)
    _check_rows("gu_actq", xa1)
    _check_w8("gu_actq", pw_gu)
    m = xa1.shape[0]
    if (xa1.shape[1] != pw_gu.kq or pw_gu.n != 2 * f or f % 16
            or kq2 < f or kq2 % 16 or out_dtype != torch.bfloat16):
        raise ValueError(f"gu_actq: unsupported xa1 {tuple(xa1.shape)} "
                         f"f={f} kq2={kq2} gu {out_dtype} (takes bf16)")
    dev = xa1.device
    xa1 = xa1.contiguous()
    gs = gs1.reshape(-1).float().contiguous()
    gu = torch.empty((m, 2 * f), dtype=torch.bfloat16, device=dev)
    xa2 = torch.empty((m, kq2), dtype=torch.bfloat16, device=dev)
    gx2 = torch.empty((m, 1), dtype=torch.float32, device=dev)
    amax = torch.empty((_MAX_ROWS,), dtype=torch.int32, device=dev)
    splits, per = _plan(m, pw_gu)
    ws = _ws(m, dev, (splits, pw_gu.n))
    gw = _gw(pw_gu).reshape(-1).contiguous()
    GU_ACTQ(_build.ptr(xa1), _build.ptr(gs), _build.ptr(pw_gu.codes),
            _build.ptr(pw_gu.scales), _build.ptr(gw), _build.ptr(pw_gu.bias),
            _build.ptr(gu), _build.ptr(xa2), _build.ptr(gx2),
            _build.ptr(amax), _build.ptr(ws), m, f, pw_gu.kq, kq2, splits,
            per)
    return xa2, gu, gx2


def _mlp_w8_cuda(xa1, gs1, pw_gu, pw_dn, f, out_dtype, norm_w, eps):
    """Launch arc_mlp_w8 (norm mode when norm_w is set)."""
    _build.require_cuda("mlp_w8", xa1, gs1, norm_w, pw_gu.codes,
                        pw_dn.codes, pw_gu.global_scale, pw_dn.global_scale)
    _check_rows("mlp_w8", xa1)
    _check_w8("mlp_w8", pw_gu)
    _check_w8("mlp_w8", pw_dn)
    m, kq1, kq2, n2 = xa1.shape[0], pw_gu.kq, pw_dn.kq, pw_dn.n
    norm = norm_w is not None
    d = xa1.shape[1] if norm else 0
    if (pw_gu.n != 2 * f or f % 16 or kq2 < f or kq2 % 16
            or out_dtype != torch.bfloat16
            or (norm and (d % 16 or kq1 < d or norm_w.numel() != d
                          or norm_w.dtype != torch.bfloat16))
            or (not norm and xa1.shape[1] != kq1)):
        raise ValueError(f"mlp_w8: unsupported x {tuple(xa1.shape)} f={f} "
                         f"kq1={kq1} kq2={kq2} out {out_dtype} (takes bf16)")
    dev = xa1.device
    out = torch.empty((m, n2), dtype=out_dtype, device=dev)
    gu = torch.empty((m, 2 * f), dtype=torch.bfloat16, device=dev)
    gx2 = torch.empty((m, 1), dtype=torch.float32, device=dev)
    xa2 = torch.empty((m, kq2), dtype=torch.bfloat16, device=dev)
    amax = torch.empty((_MAX_ROWS,), dtype=torch.int32, device=dev)
    if norm:
        x, wc = _phase_a_rows(xa1, d), qk._aligned_weight(norm_w)
        xa_in, gs_in = None, None
        xa1_ws = torch.empty((m, kq1), dtype=torch.bfloat16, device=dev)
        gx1_ws = torch.empty((m,), dtype=torch.float32, device=dev)
    else:
        x, wc, xa1_ws, gx1_ws = None, None, None, None
        xa_in, gs_in = xa1.contiguous(), gs1.reshape(-1).float().contiguous()
    s1, per1 = _plan(m, pw_gu)
    s2, per2 = _plan(m, pw_dn)
    ws = _ws(m, dev, (s1, pw_gu.n), (s2, n2))
    gw1 = _gw(pw_gu).reshape(-1).contiguous()
    gw2 = _gw(pw_dn).reshape(-1).contiguous()
    p = _build.ptr
    a_blocks = phase_a_blocks(m, d, "rmsnorm") if norm else 0
    MLP_W8(p(x), x.stride(0) if norm else 0, p(wc), float(eps), d, a_blocks,
           p(xa_in), p(gs_in), p(pw_gu.codes), p(pw_gu.scales), p(gw1),
           p(pw_gu.bias), p(pw_dn.codes), p(pw_dn.scales), p(gw2),
           p(pw_dn.bias), p(out), p(gu), p(gx2), p(xa1_ws), p(gx1_ws),
           p(xa2), p(amax), p(ws), m, f, kq1, kq2, n2, s1, per1, s2, per2)
    return out, gu, gx2


# -- public entry points (the JAX package's signatures) -----------------------

def gemm_w8_actq_fused(x2: torch.Tensor, pw: PackedWeightI8, d: int,
                       out_dtype: torch.dtype = torch.bfloat16,
                       norm_w: Optional[torch.Tensor] = None,
                       norm_eps: Optional[float] = None):
    """(y [M, N], gx [M, 1]) = GEMM(pw, actq([rmsnorm](x2))) in one
    launch. x2: [M, D] raw activations; norm_w set = fold the rmsnorm
    (the attn_in site), None = plain quantize (the o_in site)."""
    impl = gemm_actq_plain if x2.device.type == "cpu" else _gemm_actq_cuda
    return impl(x2, pw, d, out_dtype, norm_w,
                float(norm_eps) if norm_w is not None else 0.0)


def gateup_silu_quantize(xa1: torch.Tensor, gs1, pw_gu: PackedWeightI8,
                         f: int, kq2: int,
                         out_dtype: torch.dtype = torch.bfloat16):
    """(xa2 [M, kq2], gu [M, 2F], gx2 [M, 1]) = actq(silu-mul(gateup(xa1)))
    in one launch; the caller runs the down GEMM (and, for an
    ARC-augmented down_in, injects the residual into xa2 from gu first)."""
    gs = _rows_f32(gs1, xa1.shape[0], xa1.device)
    impl = gu_actq_plain if xa1.device.type == "cpu" else _gu_actq_cuda
    return impl(xa1, gs, pw_gu, f, kq2, out_dtype)


def mlp_w8_fused(xa1: torch.Tensor, gs1, pw_gu: PackedWeightI8,
                 pw_dn: PackedWeightI8, f: int,
                 out_dtype: torch.dtype = torch.bfloat16,
                 norm_w: Optional[torch.Tensor] = None,
                 norm_eps: Optional[float] = None):
    """out[M, D] = down(actq(silu-mul(gateup(xa1)))) in one launch.
    Returns (out, gu, gx2). Quantized mode: xa1 [M, kq1] bf16 and gs1 the
    per-row scales; norm mode (norm_w set): xa1 is the raw residual stream
    [M, D], rmsnorm + quantize run inside (gs1 ignored)."""
    norm = norm_w is not None
    gs = None if norm else _rows_f32(gs1, xa1.shape[0], xa1.device)
    impl = mlp_w8_plain if xa1.device.type == "cpu" else _mlp_w8_cuda
    return impl(xa1, gs, pw_gu, pw_dn, f, out_dtype, norm_w,
                float(norm_eps) if norm else 0.0)
