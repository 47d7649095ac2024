"""Mixture-of-experts FFN over packed experts (counterpart of the packed
serving path of ``arcquant_tpu/models/moe.py``: Qwen-MoE and Mixtral).

The experts' weights are packed at rest (w8 or w4, ARC columns, per-
channel weight scales): ``gateup_pk``, one pack whose N axis holds every
expert's [gate_e; up_e] rows (N = E * 2F), and ``down_pk``, a stack of
the experts' down packs ([E, Kq, D] codes). The activations are quantized
once before routing (routing copies rows, so the quantize commutes with
it) and the silu(gate) * up intermediate once more at the layer's
``down_in`` site, shared by the experts. The router and the Qwen-MoE
shared-expert gate stay f32 on the raw activations.

Two modes, picked from the token count T as in the JAX package:
  - dense (T <= DENSE_MODE_MAX_T: decode, short prefills): every expert
    on every token. One fused GEMM over ``gateup_pk``, silu * up, one
    quantize of the [E * T, F] intermediate, one batched fused GEMM
    (``gemm_dequant_batched``, one launch for all experts) for down, then
    the combine with the router weights in f32.
  - dispatch (longer prefills): GShard capacity dispatch. Each expert
    stack is decoded once to bf16, tokens are copied into per-expert
    slots (token-major, then top-k order; beyond ``capacity`` an
    assignment drops), the expert products run as batched f32-accumulated
    matmuls and the combine sums each token's kept slots.
The JAX package dispatches and combines with one-hot einsums; here they
are index gathers and scatters (the one-hot product is about 1.7 TFLOP a
layer at 4 x 1024 tokens). A dispatched row is a copy, so it has the
einsum's bits; the combine adds at most k f32 terms, in another order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..config import ModelConfig, QuantConfig
from ..kernels import gemm as gk
from ..kernels import quantize as qk
from ..quant import packing
from . import quantized

Params = Dict[str, object]

# Below this many tokens the all-experts dense mode runs; above it,
# capacity dispatch.
DENSE_MODE_MAX_T = 256
CAPACITY_FACTOR = 1.25


def init_moe_params(cfg: ModelConfig, gen: torch.Generator,
                    dtype=torch.bfloat16, device="cpu") -> Params:
    """Random ("dummy") expert weights drawn from `gen`: the router [E, D],
    the stacks gate/up [E, F, D] and down [E, D, F], N(0, 1/K) each, and
    with a shared expert its sgate/sup [Fs, D], sdown [D, Fs] and gate
    [1, D]."""
    e, d, f = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size

    def randn(shape, k_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return {"w": (w * (1.0 / math.sqrt(k_in))).to(dtype)}

    p = {"router": randn((e, d), d), "gate": randn((e, f, d), d),
         "up": randn((e, f, d), d), "down": randn((e, d, f), f)}
    if cfg.shared_expert_size:
        fs = cfg.shared_expert_size
        p.update(sgate=randn((fs, d), d), sup=randn((fs, d), d),
                 sdown=randn((d, fs), fs), shared_gate=randn((1, d), d))
    return p


def route(cfg: ModelConfig, router_w: torch.Tensor,
          x2: torch.Tensor) -> torch.Tensor:
    """Top-k router: x2 [T, D] -> combine weights [T, E] f32, zero off the
    top k (and optionally renormalised). Softmax over all experts first,
    f32 throughout; the k-th largest probability is the threshold."""
    logits = x2.float() @ router_w.float().t()
    probs = torch.softmax(logits, dim=-1)
    thresh = torch.topk(probs, cfg.num_experts_per_tok,
                        dim=-1).values[:, -1:]
    cw = torch.where(probs >= thresh, probs, torch.zeros_like(probs))
    if cfg.norm_topk_prob:
        cw = cw / cw.sum(dim=-1, keepdim=True)
    return cw


def _ffn_dense_packed(p: Params, xa: torch.Tensor, gx, cw: torch.Tensor,
                      calib_down, qcfg: QuantConfig) -> torch.Tensor:
    """Dense mode: every expert on every token. xa [T, Kq], cw [T, E]."""
    t, e = cw.shape
    gu = gk.gemm_dequant(xa, p["gateup_pk"], gx)            # [T, E*2F]
    f = gu.shape[1] // (2 * e)
    gu = gu.reshape(t, e, 2, f)
    inter = qk._silu_mul(gu[:, :, 0], gu[:, :, 1])           # [T, E, F]
    ia, gi = quantized._act_quantize(
        inter.transpose(0, 1).reshape(e * t, f), calib_down, qcfg)
    if isinstance(gi, torch.Tensor):
        gi = gi.reshape(e, t, 1)
    y = gk.gemm_dequant_batched(ia.reshape(e, t, -1), p["down_pk"], gi,
                                out_dtype=torch.float32)    # [E, T, D]
    # the combine: f32 terms, zero off each token's experts
    return (y * cw.t()[:, :, None]).sum(dim=0).to(torch.bfloat16)


def _slots(cw: torch.Tensor, k: int, capacity: int):
    """The JAX package's slot assignment: k assignments a token, taken
    token-major, then in top-k order (descending weight, ties to the
    lower expert, as lax.top_k). Each ranks by the earlier assignments to
    its expert and is kept below `capacity` with a nonzero weight.
    Returns [T, k] slots (e * capacity + rank, or the sink e * capacity
    where dropped) and weights (0 where dropped)."""
    t, e = cw.shape
    k = min(e, k)
    w_l, a_l = torch.sort(cw, dim=-1, descending=True, stable=True)
    e_flat = a_l[:, :k].reshape(-1)
    w_flat = w_l[:, :k].reshape(-1).float()
    onehot = torch.nn.functional.one_hot(e_flat, e)
    rank = (onehot.cumsum(0) - onehot).gather(1, e_flat[:, None])[:, 0]
    keep = (rank < capacity) & (w_flat > 0)
    slot = torch.where(keep, e_flat * capacity + rank,
                       torch.full_like(rank, e * capacity))
    return slot.reshape(t, k), torch.where(keep, w_flat, 0.0).reshape(t, k)


def _ffn_dispatch_packed(p: Params, xa: torch.Tensor, gx, cw: torch.Tensor,
                         capacity: int, k: int, calib_down,
                         qcfg: QuantConfig) -> torch.Tensor:
    """Dispatch mode over packed experts: each expert stack decoded once to
    bf16 (a per-layer transient), tokens copied into expert slots, the
    expert products as batched matmuls accumulated like f32, and each
    token's kept slots summed with its router weights."""
    gpk, dpk = p["gateup_pk"], p["down_pk"]
    t, e = cw.shape
    kq, f = gpk.kq, gpk.n // (2 * e)
    w4 = isinstance(gpk, packing.PackedWeight)
    slot, w = _slots(cw, k, capacity)
    tok = torch.arange(t, device=cw.device)[:, None].expand_as(slot)

    # w4 decodes in the split-half k order: split the activations alike
    # (dispatch moves rows only), here and after the down_in quantize
    xa2 = gk.pin_rowmajor(xa) if w4 else xa.to(torch.bfloat16)
    # one row past the slots: the sink, where dropped assignments go
    xin = xa2.new_zeros((e * capacity + 1, kq))
    xin[slot] = xa2[tok]
    xin = xin[:-1].reshape(e, capacity, kq)
    if isinstance(gx, torch.Tensor) and gx.dim() == 2:     # per-row scales
        gxd = gx.new_zeros((e * capacity + 1, 1), dtype=torch.float32)
        gxd[slot] = gx[tok].float()
        gxd = gxd[:-1].reshape(e, capacity, 1)
    else:
        gxd = gx

    # gate and up of expert e are the 2F columns [gate_e; up_e]
    wgu = gk.dequant_weight(gpk).reshape(kq, e, 2 * f).permute(1, 0, 2)
    acc = gk.matmul_f32(xin, wgu)                            # [E, C, 2F]
    del wgu
    gu = (acc * gpk.global_scale.float().reshape(e, 1, 2 * f)
          * gxd).to(torch.bfloat16)
    del acc
    inter = qk._silu_mul(gu[:, :, :f], gu[:, :, f:])         # [E, C, F]
    del gu
    ia, gi = quantized._act_quantize(inter.reshape(e * capacity, f),
                                     calib_down, qcfg)
    if w4:
        ia = gk.pin_rowmajor(ia)
    if isinstance(gi, torch.Tensor):
        gi = gi.reshape(e, capacity, 1)
    wd = gk.dequant_weight(dpk)                              # [E, Kq_f, D]
    acc = gk.matmul_f32(ia.reshape(e, capacity, -1), wd)     # [E, C, D]
    del wd
    y = (acc * dpk.global_scale.float().reshape(e, 1, -1)
         * gi).to(torch.bfloat16).reshape(e * capacity, -1)
    del acc
    # the combine: each token's k slots (the zero sink where dropped),
    # weighted and summed in f32, in a fixed order
    y = torch.cat([y, y.new_zeros((1, y.shape[1]))])
    return (y[slot].float() * w[:, :, None]).sum(dim=1).to(torch.bfloat16)


def moe_ffn(cfg: ModelConfig, p: Params, xa: torch.Tensor, gx,
            cw: torch.Tensor, capacity: Optional[int] = None,
            calib_down=None, qcfg: Optional[QuantConfig] = None
            ) -> torch.Tensor:
    """The routed-expert FFN on quantized activations xa [T, Kq] with
    combine weights cw [T, E]; the mode is picked from T."""
    t = xa.shape[0]
    k = cfg.num_experts_per_tok
    if capacity is None:
        capacity = max(1, int(math.ceil(
            t * k / cw.shape[1] * CAPACITY_FACTOR)))
    if t <= DENSE_MODE_MAX_T:
        return _ffn_dense_packed(p, xa, gx, cw, calib_down, qcfg)
    return _ffn_dispatch_packed(p, xa, gx, cw, capacity, k, calib_down, qcfg)


def _shared_expert(p: Params, xa: torch.Tensor, gx, layer_calib,
                   qcfg: QuantConfig) -> torch.Tensor:
    """The Qwen-MoE always-on expert: a packed FFN on the block's
    quantized activations, its down input quantized at sdown_in."""
    gate = gk.gemm_dequant(xa, p["sgate"], gx)
    up = gk.gemm_dequant(xa, p["sup"], gx)
    ia, gi = quantized._act_quantize(qk._silu_mul(gate, up),
                                     layer_calib["sdown_in"], qcfg)
    return gk.gemm_dequant(ia, p["sdown"], gi)


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor, layer_calib,
              qcfg: QuantConfig, capacity: Optional[int] = None
              ) -> torch.Tensor:
    """The MoE layer's FFN on x [B, T, D] (already normalised): routing
    on the raw activations, the routed experts on the mlp_in quantize,
    plus the shared expert times its sigmoid gate when there is one."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    cw = route(cfg, p["router"]["w"], x2)
    xa, gx = quantized._act_quantize(x2, layer_calib["mlp_in"], qcfg)
    y = moe_ffn(cfg, p, xa, gx, cw, capacity, layer_calib["down_in"], qcfg)
    if "sgate" in p:
        sy = _shared_expert(p, xa, gx, layer_calib, qcfg)
        gate = torch.sigmoid(x2.float() @ p["shared_gate"]["w"].float().t())
        y = y + (sy.float() * gate).to(y.dtype)
    return y.reshape(b, t, d).to(x.dtype)


def quantize_moe_params_packed(p: Params, layer_calib,
                               qcfg: QuantConfig) -> Params:
    """Pack the expert stacks (always per-channel weight scales):
      gateup_pk  one pack, N order per expert [gate_e; up_e] (N = E*2F);
      down_pk    a stack, codes [E, Kq_f, D], global scale [E, D];
    the shared expert's projections as plain packs. Per-channel scales
    are per output row, so packing the experts' rows together gives the
    bytes of the JAX package's per-expert loop. The router and the shared
    gate stay as they are."""
    fmt = qcfg.weight_fmt
    c_in, c_dn = layer_calib["mlp_in"], layer_calib["down_in"]
    e, f, d = p["gate"]["w"].shape
    gu = torch.cat([p["gate"]["w"], p["up"]["w"]], dim=1)
    out = {"router": p["router"],
           "gateup_pk": packing.pack_weight_arc_rows(
               gu.reshape(e * 2 * f, d), c_in.reorder_index,
               c_in.select_num, fmt=fmt)}
    del gu
    dn = packing.pack_weight_arc_rows(
        p["down"]["w"].reshape(e * d, f), c_dn.reorder_index,
        c_dn.select_num, fmt=fmt)

    def stack(t):   # [rows, E*D] -> [E, rows, D]
        return t.reshape(t.shape[0], e, d).transpose(0, 1).contiguous()
    out["down_pk"] = type(dn)(codes=stack(dn.codes), scales=stack(dn.scales),
                              global_scale=dn.global_scale.reshape(e, d),
                              bias=None)
    if "sgate" in p:
        for name, site in (("sgate", c_in), ("sup", c_in),
                           ("sdown", layer_calib["sdown_in"])):
            out[name] = quantized._quantize_linear_packed(p[name], site, fmt,
                                                          "channel")
        out["shared_gate"] = p["shared_gate"]
    return out
