"""Mixture-of-experts FFN (counterpart of ``arcquant_tpu/models/moe.py``:
Qwen-MoE and Mixtral).

The experts come in three forms, as in the JAX package:
  - bf16 stacks ({"w"}: gate/up [E, F, D], down [E, D, F]), the raw
    weights: the bf16 reference forward, BF16 and calibration;
  - qdq stacks (``quantize_moe_params``: {"w_aug", "gs"} a stack, the
    fake-quantized weight with its ARC columns in scaled units, gs [E, N]
    per channel or [E, 1] per tensor): the accuracy path in every format,
    and the engine's fake formats and use_kernels=False;
  - packed stacks (``quantize_moe_params_packed``: w8 or w4, ARC columns,
    per-channel weight scales): ``gateup_pk``, one pack whose N axis
    holds every expert's [gate_e; up_e] rows (N = E * 2F), and
    ``down_pk``, a stack of the experts' down packs ([E, Kq, D] codes):
    the engine's NVFP4 path.
The activations are quantized once before routing (routing copies rows,
so the quantize commutes with it) and the silu(gate) * up intermediate
once more at the layer's ``down_in`` site, shared by the experts. The
router and the Qwen-MoE shared-expert gate stay f32 on the raw
activations.

Two modes, picked from the token count T as in the JAX package:
  - dense (T <= DENSE_MODE_MAX_T: decode, short prefills): every expert
    on every token, then the combine with the router weights in f32.
    Packed: one fused GEMM over ``gateup_pk``, one quantize of the
    [E * T, F] intermediate, one batched fused GEMM
    (``gemm_dequant_batched``) for down. Stacks: batched products of the
    tokens with each expert's weights.
  - dispatch (longer prefills): GShard capacity dispatch. Tokens are
    copied into per-expert slots (token-major, then top-k order; beyond
    ``capacity`` an assignment drops), the expert products run as batched
    f32-accumulated matmuls (a packed stack decoded once to bf16 first)
    and the combine sums each token's kept slots.
The JAX package dispatches and combines with one-hot einsums; here they
are index gathers and scatters (the one-hot product is about 1.7 TFLOP a
layer at 4 x 1024 tokens). A dispatched row is a copy, so it has the
einsum's bits; the combine adds at most k f32 terms, in another order.
The stacks' products are those the JAX package leaves to XLA
(``jnp.einsum``): f32 accumulation of bf16 operands (``gemm.matmul_f32``).

``taps`` (a dict; calibration) receives the down_in activations of the
routed experts, routing-masked [T, E, F] in dense mode and the [E, C, F]
capacity slots in dispatch mode, and the bf16 shared expert's sdown_in.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..config import ModelConfig, QuantConfig
from ..kernels import gemm as gk
from ..kernels import quantize as qk
from ..quant import arc, numerics as N
from ..quant import packing
from . import quantized

Params = Dict[str, object]

# Below this many tokens the all-experts dense mode runs; above it,
# capacity dispatch.
DENSE_MODE_MAX_T = 256
CAPACITY_FACTOR = 1.25
# quantize_moe_params fake-quantizes this many experts of a stack at once
# (bounds the f32 transients at full width).
_QDQ_EXPERTS = 8


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


# -- the stacks: bf16 or qdq ---------------------------------------------------

def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, M, K] (or [M, K] for every expert) against the stack w [E, N,
    K]: [E, M, N] f32, accumulated like f32."""
    if x.dim() == 2:
        x = x.unsqueeze(0).expand(w.shape[0], -1, -1)
    return gk.matmul_f32(x, w.transpose(1, 2))


def _stacked_linear(qp: Params, x: torch.Tensor, gx) -> torch.Tensor:
    """Each expert's weight along x's last dim: x [E, M, K], or [M, K] (the
    same rows for every expert) -> [E, M, N]. A qdq stack ({"w_aug",
    "gs"}) takes x in scaled units with its global scale gx (a scalar,
    [M, 1] for a 2-D x, or [E, M, 1]): the bf16 product accumulated in f32,
    times gs, times gx, rounded to bf16. A bf16 stack ({"w"}) gives the
    f32-accumulated product in x's dtype."""
    if "w_aug" not in qp:
        return _expert_mm(x, qp["w"]).to(x.dtype)
    y = _expert_mm(x.to(torch.bfloat16), qp["w_aug"]) * qp["gs"][:, None, :]
    if isinstance(gx, torch.Tensor) and gx.dim() == 2:     # per row [M, 1]
        gx = gx[None]
    return (y * gx).to(torch.bfloat16)


def _a16_pad(x: torch.Tensor, select_num: int):
    """W4A16 activation of a qdq stack: exact bf16, zero ARC residual
    columns up to K + KE (the unpadded w_aug width), unit scale."""
    return torch.nn.functional.pad(x.to(torch.bfloat16),
                                   (0, select_num)), 1.0


def _qdq_x(x2: torch.Tensor, calib, qcfg: QuantConfig, gs_reduce=None):
    """The qdq stacks' quantize of a [M, K] activation: the fake ARC qdq
    at qcfg's format and scale (whatever use_kernels says), or at act_bits
    16 the exact bf16 pad. Returns (xa, gx). gs_reduce maps a per-tensor
    global scale to the one sharded callers agree on."""
    if qcfg.act_bits == 16:
        return _a16_pad(x2, calib.select_num)
    per_row = qcfg.act_scale == "row"
    return arc.arc_quantize_x_qdq(x2, calib.reorder_index, calib.select_num,
                                  qcfg.quant_type, per_row=per_row,
                                  gs_reduce=None if per_row else gs_reduce)


def _quantize_inter(inter: torch.Tensor, calib,
                    qcfg: Optional[QuantConfig], gs_reduce=None):
    """Re-quantize the silu(g) * up intermediate [..., F] at down_in for
    the qdq stacks: (ia, gi), gi [..., 1] per row. BF16 (qcfg None) passes
    it through with a unit scale. gs_reduce: the cross-shard reduction of
    a TENSOR scale (expert-parallel shards see only their experts'
    intermediates); per-row scales are shard-local and never reduced."""
    if qcfg is None or qcfg.quant_type == "BF16":
        return inter, 1.0
    lead = inter.shape[:-1]
    ia, gi = _qdq_x(inter.reshape(-1, inter.shape[-1]), calib, qcfg,
                    gs_reduce)
    if isinstance(gi, torch.Tensor) and gi.dim() == 2:
        gi = gi.reshape(*lead, 1)
    return ia.reshape(*lead, ia.shape[-1]), gi


def _ffn_dense(p: Params, xa: torch.Tensor, gx, cw: torch.Tensor,
               calib_down=None, qcfg: Optional[QuantConfig] = None,
               taps=None, gs_reduce=None,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense mode over the stacks: every expert on every token xa [T, K],
    combined with cw [T, E], the f32 sum rounded to out_dtype (gs_reduce:
    _quantize_inter's)."""
    gate = _stacked_linear(p["gate"], xa, gx)                # [E, T, F]
    up = _stacked_linear(p["up"], xa, gx)
    inter = qk._silu_mul(gate, up).to(torch.bfloat16)
    if taps is not None:
        # calibration: only routed (token, expert) rows count at down_in
        taps["down_in"] = (inter.transpose(0, 1)
                           * (cw > 0)[:, :, None].to(inter.dtype))
    ia, gi = _quantize_inter(inter, calib_down, qcfg, gs_reduce)
    y = _stacked_linear(p["down"], ia, gi)                   # [E, T, D]
    return (y.float() * cw.t()[:, :, None]).sum(dim=0).to(out_dtype)


def _slots(cw: torch.Tensor, k: int, capacity: int):
    """The JAX package's slot assignment: k assignments a token, taken
    token-major, then in top-k order (descending weight, ties to the
    lower expert, as lax.top_k). Each ranks by the earlier assignments
    with a nonzero weight to its expert and is kept below `capacity`
    with a nonzero weight. Returns [T, k] slots (e * capacity + rank, or
    the sink e * capacity where dropped) and weights (0 where dropped).

    A zero-weight assignment takes no rank: on one device every top-k
    weight is nonzero, so this is the JAX package's rule, but an
    expert-parallel rank's combine matrix holds only its own experts, and
    a token routed to fewer than k of them fills its k with zero-weight
    ones; JAX's ep_moe_block counts those against the capacity and so
    drops tokens the single device keeps (ROADMAP queue 3)."""
    t, e = cw.shape
    k = min(e, k)
    w_l, a_l = torch.sort(cw, dim=-1, descending=True, stable=True)
    e_flat = a_l[:, :k].reshape(-1)
    w_flat = w_l[:, :k].reshape(-1).float()
    onehot = (torch.nn.functional.one_hot(e_flat, e)
              * (w_flat > 0)[:, None])
    rank = (onehot.cumsum(0) - onehot).gather(1, e_flat[:, None])[:, 0]
    keep = (rank < capacity) & (w_flat > 0)
    slot = torch.where(keep, e_flat * capacity + rank,
                       torch.full_like(rank, e * capacity))
    return slot.reshape(t, k), torch.where(keep, w_flat, 0.0).reshape(t, k)


def _dispatch_rows(rows: torch.Tensor, slot: torch.Tensor, e: int,
                   capacity: int) -> torch.Tensor:
    """Copy token rows [T, K] into the slots [T, k] of e experts:
    [E, C, K], zero where no assignment landed (dropped ones go to a sink
    row past the slots)."""
    tok = torch.arange(slot.shape[0], device=slot.device)[:, None]
    out = rows.new_zeros((e * capacity + 1, rows.shape[1]))
    out[slot] = rows[tok.expand_as(slot)]
    return out[:-1].reshape(e, capacity, -1)


def _combine(y: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Each token's k slots of y [E * C, D] (the zero sink where dropped),
    weighted by w [T, k] and summed in f32, in a fixed order: [T, D] in
    out_dtype."""
    y = torch.cat([y, y.new_zeros((1, y.shape[1]))])
    return (y[slot].float() * w[:, :, None]).sum(dim=1).to(out_dtype)


def _ffn_dispatch(p: Params, xa: torch.Tensor, gx, cw: torch.Tensor,
                  capacity: int, k: int, calib_down=None,
                  qcfg: Optional[QuantConfig] = None,
                  taps=None, gs_reduce=None,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dispatch mode over the stacks: xa [T, K] (rounded to bf16, as the
    JAX package's one-hot dispatch product) and its per-row scales copied
    into expert slots, the stacked products at [E, C, *], the combine in
    out_dtype (gs_reduce: _quantize_inter's)."""
    e = cw.shape[1]
    slot, w = _slots(cw, k, capacity)
    xin = _dispatch_rows(xa.to(torch.bfloat16), slot, e, capacity)
    gxd = gx
    if isinstance(gx, torch.Tensor) and gx.dim() == 2:      # per-row scales
        gxd = _dispatch_rows(gx.float(), slot, e, capacity)
    gate = _stacked_linear(p["gate"], xin, gxd)              # [E, C, F]
    up = _stacked_linear(p["up"], xin, gxd)
    inter = qk._silu_mul(gate, up).to(torch.bfloat16)
    if taps is not None:
        # unrouted capacity slots are zero rows: neutral for the stats
        taps["down_in"] = inter
    ia, gi = _quantize_inter(inter, calib_down, qcfg, gs_reduce)
    y = _stacked_linear(p["down"], ia, gi)                   # [E, C, D]
    return _combine(y.reshape(e * capacity, -1), slot, w, out_dtype)


# -- packed experts ------------------------------------------------------------

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
    if isinstance(gi, torch.Tensor) and gi.dim() == 2:
        gi = gi.reshape(e, t, 1)
    y = gk.gemm_dequant_batched(ia.reshape(e, t, -1), p["down_pk"], gi,
                                out_dtype=torch.float32)    # [E, T, D]
    # the combine: f32 terms, zero off each token's experts
    return (y * cw.t()[:, :, None]).sum(dim=0).to(torch.bfloat16)


def _ffn_dispatch_packed(p: Params, xa: torch.Tensor, gx, cw: torch.Tensor,
                         capacity: int, k: int, calib_down,
                         qcfg: QuantConfig) -> torch.Tensor:
    """Dispatch mode over packed experts: each expert stack decoded once to
    bf16 (a per-layer transient), tokens copied into expert slots, the
    expert products as batched matmuls accumulated like f32, and each
    token's kept slots summed with its router weights."""
    gpk, dpk = p["gateup_pk"], p["down_pk"]
    e = cw.shape[1]
    kq, f = gpk.kq, gpk.n // (2 * e)
    w4 = isinstance(gpk, packing.PackedWeight)
    slot, w = _slots(cw, k, capacity)

    # w4 decodes in the split-half k order: split the activations alike
    # (dispatch moves rows only), here and after the down_in quantize
    xa2 = gk.pin_rowmajor(xa) if w4 else xa.to(torch.bfloat16)
    xin = _dispatch_rows(xa2, slot, e, capacity)
    gxd = gx
    if isinstance(gx, torch.Tensor) and gx.dim() == 2:     # per-row scales
        gxd = _dispatch_rows(gx.float(), slot, e, capacity)

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
    if isinstance(gi, torch.Tensor) and gi.dim() == 2:
        gi = gi.reshape(e, capacity, 1)
    wd = gk.dequant_weight(dpk)                              # [E, Kq_f, D]
    acc = gk.matmul_f32(ia.reshape(e, capacity, -1), wd)     # [E, C, D]
    del wd
    y = (acc * dpk.global_scale.float().reshape(e, 1, -1)
         * gi).to(torch.bfloat16).reshape(e * capacity, -1)
    del acc
    return _combine(y, slot, w)


# -- the block -----------------------------------------------------------------

def moe_ffn(cfg: ModelConfig, p: Params, xa: torch.Tensor, gx,
            cw: torch.Tensor, capacity: Optional[int] = None,
            calib_down=None, qcfg: Optional[QuantConfig] = None,
            taps=None) -> torch.Tensor:
    """The routed-expert FFN on the activations xa [T, K(q)] (quantized
    ones in scaled units) with combine weights cw [T, E]; the mode is
    picked from T, the route from the experts' form (packed or stacks)."""
    t = xa.shape[0]
    k = cfg.num_experts_per_tok
    if capacity is None:
        capacity = max(1, int(math.ceil(
            t * k / cw.shape[1] * CAPACITY_FACTOR)))
    if "gateup_pk" in p:
        if t <= DENSE_MODE_MAX_T:
            return _ffn_dense_packed(p, xa, gx, cw, calib_down, qcfg)
        return _ffn_dispatch_packed(p, xa, gx, cw, capacity, k, calib_down,
                                    qcfg)
    if t <= DENSE_MODE_MAX_T:
        return _ffn_dense(p, xa, gx, cw, calib_down, qcfg, taps)
    return _ffn_dispatch(p, xa, gx, cw, capacity, k, calib_down, qcfg, taps)


def _shared_expert(p: Params, xa: torch.Tensor, gx, layer_calib,
                   qcfg: Optional[QuantConfig], taps=None) -> torch.Tensor:
    """The Qwen-MoE always-on expert on the block's activations. bf16
    (qcfg None; xa is then the raw x): f32-accumulated products, silu *
    up in f32 rounded to x's dtype (tapped as sdown_in). Quantized: its
    linears on xa (packed, or fake from quantize_moe_params), its down
    input quantized at sdown_in by the route of its down weight."""
    if qcfg is None:
        gate = gk.matmul_f32(xa, p["sgate"]["w"].t())
        up = gk.matmul_f32(xa, p["sup"]["w"].t())
        inter = qk._silu_mul(gate, up).to(xa.dtype)
        if taps is not None:
            taps["sdown_in"] = inter
        return gk.matmul_f32(inter, p["sdown"]["w"].t()).to(xa.dtype)
    gate = quantized._q_linear(p["sgate"], xa, gx, torch.bfloat16)
    up = quantized._q_linear(p["sup"], xa, gx, torch.bfloat16)
    inter = qk._silu_mul(gate, up)
    sc = layer_calib["sdown_in"]
    if isinstance(p["sdown"], dict):
        ia, gi = _quantize_inter(inter, sc, qcfg)
    else:
        ia, gi = quantized._act_quantize(inter, sc, qcfg)
    return quantized._q_linear(p["sdown"], ia, gi, torch.bfloat16)


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
              layer_calib=None, qcfg: Optional[QuantConfig] = None,
              capacity: Optional[int] = None, taps=None) -> torch.Tensor:
    """The MoE layer's FFN on x [B, T, D] (already normalised): routing
    on the raw activations; the routed experts on the mlp_in quantize
    (packed experts: the site's quantize, quantized._act_quantize; qdq
    stacks: the fake qdq, or the A16 pad to K + KE) or, for BF16 or no
    qcfg, on x itself; plus the shared expert times its sigmoid gate when
    there is one."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    cw = route(cfg, p["router"]["w"], x2)
    if qcfg is None or qcfg.quant_type == "BF16":
        xa, gx, calib_down, qcfg = x2, 1.0, None, None
    else:
        quantize = (quantized._act_quantize if "gateup_pk" in p
                    else _qdq_x)
        xa, gx = quantize(x2, layer_calib["mlp_in"], qcfg)
        calib_down = layer_calib["down_in"]
    y = moe_ffn(cfg, p, xa, gx, cw, capacity, calib_down, qcfg, taps)
    if "sgate" in p:
        sy = _shared_expert(p, xa, gx, layer_calib, qcfg, taps)
        gate = torch.sigmoid(x2.float() @ p["shared_gate"]["w"].float().t())
        y = y + (sy.float() * gate).to(y.dtype)
    return y.reshape(b, t, d).to(x.dtype)


# -- quantization (load time) --------------------------------------------------

def _quantize_stack(w: torch.Tensor, calib, quant_type: str,
                    per_channel: bool) -> Params:
    """The JAX package's arc_quantize_w_qdq of each expert of a stack w
    [E, N, K], a few experts at a time: {"w_aug": bf16 [E, N, K + KE],
    "gs": f32 [E, N] per channel, else [E, 1] (one scale an expert; 1 for
    the formats without a global scale)}."""
    idx = arc.top_channels(calib.reorder_index, calib.select_num).to(
        w.device)
    was, gss = [], []
    for i in range(0, w.shape[0], _QDQ_EXPERTS):
        wc = w[i:i + _QDQ_EXPERTS]
        if quant_type != "NVFP4":
            gs = torch.ones((wc.shape[0], 1, 1), dtype=torch.float32,
                            device=w.device)
        elif per_channel:
            gs = N.nvfp4_global_scale(wc, per_row=True)             # [c, N, 1]
        else:
            gs = torch.clamp(wc.abs().amax(dim=(1, 2), keepdim=True).float()
                             * N.INV_NVFP4_GLOBAL_DIV, min=1e-12)   # [c, 1, 1]
        ws = wc.float() / gs
        parts = [N.group_qdq(ws, quant_type)]
        if calib.select_num:
            parts.append(N.group_qdq(ws[..., idx], quant_type))
        was.append(torch.cat(parts, dim=-1).to(w.dtype).to(torch.bfloat16))
        gss.append(gs.reshape(wc.shape[0], -1))
        del ws, parts
    return {"w_aug": torch.cat(was), "gs": torch.cat(gss)}


def quantize_moe_params(p: Params, layer_calib,
                        qcfg: QuantConfig) -> Params:
    """The qdq stacks: each expert of gate/up (at mlp_in) and down (at
    down_in) fake-quantized with its ARC columns (_quantize_stack), the
    shared expert's linears as fake linears; the router and the shared
    gate as they are. BF16 returns the tree as it is (the bf16 stacks)."""
    if qcfg.quant_type == "BF16":
        return dict(p)
    per_ch = qcfg.w_scale == "channel"
    out: Params = {"router": p["router"]}
    for name, site in (("gate", "mlp_in"), ("up", "mlp_in"),
                       ("down", "down_in")):
        out[name] = _quantize_stack(p[name]["w"], layer_calib[site],
                                    qcfg.quant_type, per_ch)
    if "sgate" in p:
        for name, site in (("sgate", "mlp_in"), ("sup", "mlp_in"),
                           ("sdown", "sdown_in")):
            out[name] = quantized._quantize_linear_fake(
                p[name], layer_calib[site], qcfg.quant_type, per_ch)
        out["shared_gate"] = p["shared_gate"]
    return out


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
