"""Expert parallelism for MoE layers on ``torch.distributed`` (counterpart
of ``arcquant_tpu/parallel/ep.py``).

The stacked expert weights [E, ...] shard on the leading expert axis,
E/ep experts a rank over the tp group of a ``make_mesh(dp, ep)`` mesh
(the TP engine's own tp group when MoE runs under tensor parallelism);
tokens are replicated across the ep ranks (and split across the dp
groups when the mesh has them). Each rank:

  1. runs the (tiny, replicated) router on the full token block,
  2. slices the combine matrix to its own experts,
  3. runs its experts' FFN (dense or capacity-dispatch mode of
     models/moe.py, quantized qdq stacks or bf16), the dispatch capacity
     the global per-expert one and a slot's rank counting only the
     nonzero-weight assignments to its expert, so the ranks keep and
     drop the single device's tokens (JAX's ep_moe_block also counts the
     zero-weight assignments a rank's sliced combine matrix fills a
     token's top-k with, and drops tokens its single device keeps),
  4. sums the [T, D] partial outputs over the ep ranks with one
     all_reduce(SUM) in f32.

The Qwen-MoE shared expert is computed on every rank (it is dense and its
tokens are replicated, so it is identical everywhere) and added after the
sum, so it counts exactly once. A rank's partial stays f32 until the sum
is rounded to bf16 once, and the shared expert is then added as
moe.moe_block adds it, so the block is the single device's up to the f32
summation order of a token's expert contributions (JAX rounds each
partial to bf16 before its psum and adds the shared expert in f32). At
per-tensor activation scales the down_in re-quantize scale is the max
over every rank's experts, one all_reduce(MAX) (models/moe.py's
gs_reduce), so the quantization grids are the single device's; per-row
scales are rank-local and never reduced. A MoE block so makes one
all_reduce, two at per-tensor scales.

Routing runs on the full expert set before the combine matrix is sliced,
so it is the single device's bit for bit.

JAX's shard_map hands a rank its [E/ep, ...] slice of a global array;
a rank here holds only its slice (``shard_moe_params``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..config import ModelConfig, QuantConfig
from ..models import moe
from .mesh import TPContext

Params = Dict[str, Any]

# Stacked expert tensors carry E on axis 0; everything else replicates.
_EXPERT_STACKED = ("gate", "up", "down")


def moe_param_specs(p: Params) -> Params:
    """The placement of one layer's MoE params: "ep" for the expert
    stacks' tensors (sliced on E), None (replicated) for the router and
    the shared expert."""
    return {name: ({k: "ep" if name in _EXPERT_STACKED else None
                    for k in sub} if isinstance(sub, dict) else None)
            for name, sub in p.items()}


def shard_moe_params(p: Params, ctx: TPContext) -> Params:
    """This rank's slice of a layer's MoE params: experts
    [rank * E/ep, (rank + 1) * E/ep) of each stack (raw bf16 or qdq),
    the rest as it is."""
    specs = moe_param_specs(p)
    out: Params = {}
    for name, sub in p.items():
        if not isinstance(sub, dict):
            out[name] = sub
            continue
        out[name] = {}
        for k, t in sub.items():
            if specs[name][k] == "ep":
                e = t.shape[0]
                if e % ctx.tp:
                    raise ValueError(f"ep={ctx.tp} must divide the "
                                     f"{e} experts")
                el = e // ctx.tp
                t = t[ctx.rank * el:(ctx.rank + 1) * el].contiguous()
            out[name][k] = t
    return out


def ep_moe_block(cfg: ModelConfig, p_local: Params, x: torch.Tensor,
                 ctx: TPContext, layer_calib=None,
                 qcfg: Optional[QuantConfig] = None,
                 capacity: Optional[int] = None) -> torch.Tensor:
    """The MoE block on this rank's experts: p_local holds E/ep experts
    (shard_moe_params), x [B, T, D] is the (normed) token block every ep
    rank holds. Returns the combined output, equal on every ep rank:
    moe.moe_block's, with the combine matrix sliced to the rank's
    experts and the routed sum all_reduced."""
    b, t, d = x.shape
    dtype = x.dtype
    comm = ctx.tp_comm()
    stack = p_local["gate"]
    e_loc = stack["w" if "w" in stack else "w_aug"].shape[0]
    x2 = x.reshape(b * t, d)

    # routing on the full expert set (the router is replicated): global
    # softmax and top-k, then this rank's columns
    cw = moe.route(cfg, p_local["router"]["w"], x2)          # [T, E]
    e = cw.shape[1]
    cw_loc = cw[:, ctx.rank * e_loc:(ctx.rank + 1) * e_loc]  # [T, E/ep]

    if qcfg is not None and qcfg.quant_type != "BF16":
        xa, gx = moe._qdq_x(x2, layer_calib["mlp_in"], qcfg)
        calib_down = layer_calib["down_in"]
    else:
        xa, gx, calib_down, qcfg = x2, 1.0, None, None

    # the dispatch capacity is the global per-expert one (load is per
    # expert, not per rank)
    k_loc = min(cfg.num_experts_per_tok, e_loc)
    if capacity is None:
        capacity = max(1, int(math.ceil(
            b * t * cfg.num_experts_per_tok / e * moe.CAPACITY_FACTOR)))

    def gs_reduce(s):   # the down_in tensor scale over every rank's experts
        return comm.all_reduce(s.float().contiguous(), "max")

    f32 = torch.float32
    if b * t <= moe.DENSE_MODE_MAX_T:
        y = moe._ffn_dense(p_local, xa, gx, cw_loc, calib_down, qcfg,
                           gs_reduce=gs_reduce, out_dtype=f32)
    else:
        y = moe._ffn_dispatch(p_local, xa, gx, cw_loc, capacity, k_loc,
                              calib_down, qcfg, gs_reduce=gs_reduce,
                              out_dtype=f32)
    y = comm.all_reduce(y.contiguous(), "sum").to(torch.bfloat16)  # [T, D]

    if "sgate" in p_local:
        sy = moe._shared_expert(p_local, xa, gx, layer_calib, qcfg)
        gate = torch.sigmoid(
            x2.float() @ p_local["shared_gate"]["w"].float().t())
        y = y + (sy.float() * gate).to(y.dtype)
    return y.reshape(b, t, d).to(dtype)


def make_ep_moe_forward(cfg: ModelConfig, ctx: TPContext, layer_calib=None,
                        qcfg: Optional[QuantConfig] = None,
                        capacity: Optional[int] = None):
    """A dp x ep MoE block: fwd(p_local, x) takes the whole batch x
    [B, T, D] on every rank, runs this dp group's B/dp rows through
    ep_moe_block over the group's ep ranks, and returns the whole output
    (the dp groups' rows gathered, one all_gather, when dp > 1).
    p_local comes from shard_moe_params."""

    def fwd(p_local: Params, x: torch.Tensor) -> torch.Tensor:
        if ctx.dp > 1:
            bl = x.shape[0] // ctx.dp
            x = x[ctx.dp_rank * bl:(ctx.dp_rank + 1) * bl]
        y = ep_moe_block(cfg, p_local, x, ctx, layer_calib, qcfg, capacity)
        return ctx.dp_comm().all_gather(y) if ctx.dp > 1 else y

    return fwd
