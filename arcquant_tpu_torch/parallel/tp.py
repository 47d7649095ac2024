"""Tensor-parallel quantized forward on ``torch.distributed`` (counterpart
of ``arcquant_tpu/parallel/tp.py``).

Megatron-style sharding of the quantized decoder layer over the tp ranks,
with the ARC-augmented layout made shard-local so no channel crosses a
shard boundary:

  column-parallel  q/k/v/gate/up : weight N-dim sharded; activations
    replicated; each rank runs the packed GEMM on its shard (attention
    heads land shard-local; tp must divide num_kv_heads).
  row-parallel     o/down        : weight K-dim sharded; each shard owns
    its slice of the plain channels and the ARC residual duplicates of
    the outlier channels in that slice, so quantize + residual stays
    local; the partial GEMM outputs combine with one all_reduce(SUM).

ARC under TP: the global top-KE selection is re-balanced to
(KE / tp) // 64 * 64 channels a shard, each shard compensating its own
most important channels; ``tp_exact_arc`` keeps the global set and its
16-grouping instead (``shard_linear_row``). The row-parallel sites'
activation global scale is the true global max, an all_reduce(MAX). A
decode step so makes 2 SUM and 2 MAX all_reduces a layer and nothing
else (exact ARC adds one SUM a row site with a residual).

JAX's shard_map hands a rank a [tp, ...] stack; a rank here holds only
its own shard, so the sharders take the rank and return its shard. The
column sites quantize with ``quantize_x_arc`` (the actq kernel on the
card); the row sites' quantize is plain torch ops, as it is plain jnp in
JAX, with the one true division x / gx, so its bf16 outputs and gx equal
JAX's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig, QuantConfig
from ..engine.engine import _to_device
from ..kernels import gemm as gk
from ..kernels import quantize as qk
from ..models import llama
from ..models.quantized import SiteCalib
from ..quant import numerics as N
from ..quant import packing
from .mesh import TPContext

Params = Dict[str, Any]


def _all_reduce(t: torch.Tensor, op: str, ctx: TPContext) -> torch.Tensor:
    """all_reduce(op) of t over the TP group, in place (none at tp 1)."""
    return ctx.tp_comm().all_reduce(t, op)


# ---------------------------------------------------------------------------
# Host-side sharding (one-time, at load): each rank packs its own shard
# ---------------------------------------------------------------------------

def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _local_perm(reorder_index, lo: int, hi: int) -> np.ndarray:
    """Restrict a global ascending-importance permutation to channels
    [lo, hi), re-based to local indices (stays ascending)."""
    ridx = _np(reorder_index)
    mask = (ridx >= lo) & (ridx < hi)
    return (ridx[mask] - lo).astype(np.int32)


def shard_linear_col(w, bias, calib: SiteCalib, tp: int, fmt: str,
                     rank: int):
    """Column-parallel: shard `rank` of the out_features; calib stays
    global. Every shard quantizes on the full tensor's global scale
    (bit-identical to the unsharded pack)."""
    n = w.shape[0]
    assert n % tp == 0, (n, tp)
    ns = n // tp
    sl = slice(rank * ns, (rank + 1) * ns)
    return packing.pack_weight_arc(
        w[sl], calib.reorder_index, calib.select_num,
        bias=None if bias is None else bias[sl], fmt=fmt,
        global_scale=N.nvfp4_global_scale(w))


def shard_linear_row(w, bias, calib: SiteCalib, tp: int, fmt: str,
                     rank: int, w_scale: str = "tensor",
                     exact: bool = False):
    """Row-parallel: shard `rank` of the in_features, with the global
    scale (tensor scalar or per-channel [N]) of the FULL weight, so the
    quantization grid is the unsharded pack's.

    exact=False: each shard selects its own top (KE / tp) // 64 * 64
    local channels. exact=True (QuantConfig.tp_exact_arc): the GLOBAL
    top-KE set and its 16-grouping; the residual block is split
    group-aligned across shards, shard i duplicating residual chunk i's
    channels from the full weight wherever they live, and the activation
    residual is rebuilt at run time by scatter + all_reduce(SUM)
    (_quantize_x_rowshard_exact). Needs (KE / tp) % 16 == 0.

    Returns (packed shard, the shard's residual index array, its residual
    POSITION array (exact mode, else None), the per-shard select count,
    the bias as given). The index and position rows are padded to the
    longest shard's (index 0, position KE: dropped)."""
    n, k = w.shape
    assert k % tp == 0 and (k // tp) % 16 == 0, (k, tp)
    ks = k // tp
    lo, hi = rank * ks, (rank + 1) * ks
    ridx = _np(calib.reorder_index)
    gs = (N.nvfp4_global_scale(w, per_row=True)[:, 0]
          if w_scale == "channel" else N.nvfp4_global_scale(w))
    dev = w.device

    if exact and calib.select_num and tp > 1:
        ke = calib.select_num
        assert (ke // tp) % 16 == 0, (
            f"exact-ARC TP needs (select_num/tp) % 16 == 0, got "
            f"select_num={ke} tp={tp}")
        kc = ke // tp
        top = ridx[-ke:]                    # global residual order
        chunk = torch.as_tensor(top[rank * kc:(rank + 1) * kc].astype(
            np.int64), device=dev)
        pw = packing.pack_weight_arc(w[:, lo:hi], None, kc, fmt=fmt,
                                     global_scale=gs,
                                     aug_cols=w[:, chunk])
        owns = [np.nonzero((top >= i * ks) & (top < (i + 1) * ks))[0]
                for i in range(tp)]
        mo = max(len(o) for o in owns)
        own = owns[rank]
        idx = np.zeros((mo,), np.int32)
        pos = np.full((mo,), ke, np.int32)  # ke = drop sentinel
        idx[:len(own)] = top[own] - lo      # local channel ids
        pos[:len(own)] = own                # positions in [0, KE)
        return (pw, torch.as_tensor(idx, device=dev),
                torch.as_tensor(pos, device=dev), kc, bias)

    sel = (calib.select_num // tp) // 64 * 64 if tp > 1 else \
        calib.select_num
    perm = _local_perm(ridx, lo, hi)
    pw = packing.pack_weight_arc(w[:, lo:hi], torch.as_tensor(perm), sel,
                                 fmt=fmt, global_scale=gs)
    idx = perm[-sel:] if sel else np.zeros((0,), np.int32)
    return pw, torch.as_tensor(idx, device=dev), None, sel, bias


def shard_layer_params_tp(cfg: ModelConfig, layer_p: Params,
                          layer_calib: Dict[str, SiteCalib],
                          qcfg: QuantConfig, tp: int, rank: int) -> Params:
    """Quantize one decoder layer and keep shard `rank` of it: packed
    q/k/v/gate/up/o/down shards, the row sites' index (and position)
    arrays, the norms replicated, and the row sites' static select counts
    under "_o_sel", "_down_sel", "_o_ke", "_down_ke"."""
    fmt = qcfg.weight_fmt
    out: Params = {"attn_norm": layer_p["attn_norm"],
                   "mlp_norm": layer_p["mlp_norm"]}
    for projs, site in ((("q", "k", "v"), "attn_in"),
                        (("gate", "up"), "mlp_in")):
        for proj in projs:
            out[proj] = shard_linear_col(
                layer_p[proj]["w"], layer_p[proj].get("b"),
                layer_calib[site], tp, fmt, rank)
    exact = qcfg.tp_exact_arc
    for name, site in (("o", "o_in"), ("down", "down_in")):
        pw, idx, pos, sel, _ = shard_linear_row(
            layer_p[name]["w"], None, layer_calib[site], tp, fmt, rank,
            qcfg.w_scale, exact=exact)
        out[name] = pw
        out[f"{name}_idx"] = idx
        if pos is not None:
            out[f"{name}_pos"] = pos
        out[f"_{name}_sel"] = sel
        out[f"_{name}_ke"] = layer_calib[site].select_num
    return out


def shard_model_params_tp(cfg: ModelConfig, params: Params, calib,
                          qcfg: QuantConfig, mesh: TPContext) -> Params:
    """This rank's shard of the whole model on its device: embeddings,
    norms and lm_head replicated, every layer sharded; the row sites'
    static select counts under "_row_sels" (one dict a layer)."""
    out: Params = {k: params[k].to(mesh.device)
                   for k in ("embed", "final_norm", "lm_head")
                   if k in params}
    layers, sels = [], []
    for li, lp in enumerate(params["layers"]):
        slp = shard_layer_params_tp(cfg, lp, calib[li], qcfg, mesh.tp,
                                    mesh.rank)
        sels.append({"o": slp.pop("_o_sel"), "down": slp.pop("_down_sel"),
                     "_o_ke": slp.pop("_o_ke"),
                     "_down_ke": slp.pop("_down_ke")})
        layers.append(_to_device(slp, mesh.device))
    out["layers"] = layers
    out["_row_sels"] = sels
    return out


# ---------------------------------------------------------------------------
# Device-side forward (each rank on its shard)
# ---------------------------------------------------------------------------

def _quantize_x_global(x2, calib: SiteCalib, kq: int, per_row: bool = False):
    """Replicated activation quantize (column-parallel sites):
    quantize_x_arc, the actq kernel on the card at per-row scales."""
    return qk.quantize_x_arc(x2, calib.reorder_index, calib.select_num, kq,
                             per_row=per_row)


def _row_gmax(x_local, per_row: bool, ctx: TPContext):
    """Activation absmax over the FULL (tp-sharded) K dim: a scalar, or
    per row [M, 1] with per_row, through all_reduce(MAX)."""
    if per_row:
        local = x_local.abs().amax(dim=-1, keepdim=True).float()
    else:
        local = x_local.abs().amax().float()
    return _all_reduce(local.contiguous(), "max", ctx)


def _global_scaled(x_local, per_row: bool, ctx: TPContext):
    """(x_local / gx in f32, gx): the global scale of the full K."""
    gx = torch.clamp(_row_gmax(x_local, per_row, ctx)
                     * N.INV_NVFP4_GLOBAL_DIV, min=1e-12)
    return x_local.float() / gx, gx


def _pad_cat(parts, m: int, kq: int, device):
    width = sum(p.shape[1] for p in parts)
    if kq > width:
        parts = parts + [torch.zeros((m, kq - width), dtype=torch.float32,
                                     device=device)]
    return torch.cat(parts, dim=1).to(torch.bfloat16)


def _quantize_x_rowshard(x_local, idx_local, sel: int, kq: int,
                         ctx: TPContext, per_row: bool = False):
    """Row-parallel activation quantize of this shard's slice x_local
    [M, Ks] on the global scale: (xa bf16 [M, kq], gx)."""
    m = x_local.shape[0]
    xs, gx = _global_scaled(x_local, per_row, ctx)
    qx = N.nvfp4_qdq_scaled(xs)
    parts = [qx]
    if sel:
        idx = idx_local.long()
        parts.append(N.nvfp4_qdq_scaled(xs[:, idx] - qx[:, idx]))
    return _pad_cat(parts, m, kq, x_local.device), gx


def _quantize_x_rowshard_exact(x_local, own_idx, own_pos, sel_chunk: int,
                               ke: int, kq: int, ctx: TPContext,
                               per_row: bool = False):
    """Exact-ARC row-parallel activation quantize: the GLOBAL residual
    block (quantize_x_arc's last KE columns: the same channels, order and
    16-grouping) rebuilt by scatter + all_reduce(SUM) of the [M, KE]
    block, then this rank's group-aligned chunk. Bit-identical to the
    unsharded quantize.

    own_idx / own_pos: the local channel ids this shard owns of the
    global top-KE and their positions in [0, KE) (padding: position KE,
    dropped)."""
    m = x_local.shape[0]
    xs, gx = _global_scaled(x_local, per_row, ctx)
    qx = N.nvfp4_qdq_scaled(xs)
    idx = own_idx.long()
    blk = torch.zeros((m, ke + 1), dtype=torch.float32,
                      device=x_local.device)
    blk[:, own_pos.long()] = xs[:, idx] - qx[:, idx]
    blk = _all_reduce(blk[:, :ke].contiguous(), "sum", ctx)
    lo = ctx.rank * sel_chunk
    resq = N.nvfp4_qdq_scaled(blk[:, lo:lo + sel_chunk])
    return _pad_cat([qx, resq], m, kq, x_local.device), gx


def quantize_x_row_site(x_local, p: Params, name: str, sels: Dict[str, Any],
                        kq: int, ctx: TPContext, per_row: bool = False):
    """A row-parallel site's activation quantize: exact ARC (the global
    set, scatter + all_reduce) when the shard carries position arrays,
    else the per-shard re-balanced quantize."""
    if f"{name}_pos" in p:
        return _quantize_x_rowshard_exact(
            x_local, p[f"{name}_idx"], p[f"{name}_pos"], sels[name],
            sels[f"_{name}_ke"], kq, ctx, per_row=per_row)
    return _quantize_x_rowshard(x_local, p[f"{name}_idx"], sels[name], kq,
                                ctx, per_row=per_row)


def _row_linear(pw, xa, gx, ctx: TPContext, out_dtype):
    """A row-parallel GEMM: this shard's f32 partial, summed over the
    ranks, then rounded to out_dtype."""
    part = gk.gemm_dequant(xa, pw, gx, out_dtype=torch.float32)
    return _all_reduce(part.contiguous(), "sum", ctx).to(out_dtype)


def tp_quant_layer_forward(cfg: ModelConfig, p: Params, x, cos, sin,
                           layer_calib: Dict[str, SiteCalib],
                           row_sels: Dict[str, int], qcfg: QuantConfig,
                           ctx: TPContext):
    """One decoder layer on this rank's shard (no cache, f32 dense
    causal attention). x: replicated [B, T, D]."""
    b, t, d = x.shape
    tp = ctx.tp
    hq_l = cfg.num_heads // tp
    hkv_l = cfg.num_kv_heads // tp
    dt = x.dtype

    h = llama.rms_norm(x, p["attn_norm"], cfg.rms_eps)
    x2 = h.reshape(b * t, d)
    xa, gx = _quantize_x_global(x2, layer_calib["attn_in"], p["q"].kq)
    q = gk.gemm_dequant(xa, p["q"], gx, out_dtype=dt).reshape(
        b, t, hq_l, cfg.head_dim)
    k = gk.gemm_dequant(xa, p["k"], gx, out_dtype=dt).reshape(
        b, t, hkv_l, cfg.head_dim)
    v = gk.gemm_dequant(xa, p["v"], gx, out_dtype=dt).reshape(
        b, t, hkv_l, cfg.head_dim)
    q, k = llama.apply_rope(q, k, cos, sin)
    kk = llama.repeat_kv(k, hq_l // hkv_l)
    vv = llama.repeat_kv(v, hq_l // hkv_l)
    attn = llama.dense_attention(q, kk, vv, causal=True)
    attn2 = attn.reshape(b * t, hq_l * cfg.head_dim)   # local K shard

    oa, go = quantize_x_row_site(attn2, p, "o", row_sels, p["o"].kq, ctx)
    x = x + _row_linear(p["o"], oa, go, ctx, dt).reshape(b, t, d)

    h = llama.rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    x2 = h.reshape(b * t, d)
    xa, gx = _quantize_x_global(x2, layer_calib["mlp_in"], p["gate"].kq)
    gate = gk.gemm_dequant(xa, p["gate"], gx, out_dtype=dt)
    up = gk.gemm_dequant(xa, p["up"], gx, out_dtype=dt)
    inter = qk._silu_mul(gate, up)
    ia, gi = quantize_x_row_site(inter, p, "down", row_sels, p["down"].kq,
                                 ctx)
    return x + _row_linear(p["down"], ia, gi, ctx, dt).reshape(b, t, d)


@torch.no_grad()
def tp_quant_model_forward(cfg: ModelConfig, qparams: Params, calib,
                           qcfg: QuantConfig, mesh: TPContext,
                           tokens) -> torch.Tensor:
    """The sharded quantized forward without a cache: tokens [B, T] ->
    f32 logits [B, T, V] on every rank (the batch replicated)."""
    tokens = torch.as_tensor(tokens, device=mesh.device).long()
    x = qparams["embed"][tokens]
    cos, sin = llama.rope_cos_sin(cfg, llama.positions_for(tokens))
    for li, lp in enumerate(qparams["layers"]):
        x = tp_quant_layer_forward(cfg, lp, x, cos, sin, calib[li],
                                   qparams["_row_sels"][li], qcfg, mesh)
    return llama.head_logits(qparams, llama.rms_norm(
        x, qparams["final_norm"], cfg.rms_eps))
