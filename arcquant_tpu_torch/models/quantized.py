"""Quantized W4A4 NVFP4 + ARC linears (counterpart of
``arcquant_tpu/models/quantized.py``, the packed serving path only):
calibration artifacts, load-time weight packing with q/k/v and gate/up
fused (and the packed experts of an MoE layer), the activation quantize
per site and the packed linear."""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from ..config import ModelConfig, QuantConfig
from ..kernels import gemm as gk
from ..kernels import quantize as qk
from ..quant import packing

Params = Dict[str, object]


class SiteCalib(NamedTuple):
    """Calibration artifact of one activation-quantization site."""
    reorder_index: torch.Tensor  # [K] int, ascending importance
    select_num: int              # KE, a multiple of 64


# The activation-quantization sites of a decoder layer: attention input
# (q/k/v), attention output (o), MLP input (gate/up), MLP intermediate
# (down).
QUANT_SITES = ("attn_in", "o_in", "mlp_in", "down_in")


def quant_sites(cfg: ModelConfig) -> tuple:
    """The config's sites: an MoE model with a shared expert adds the
    shared expert's down input, sdown_in."""
    if cfg.num_experts and cfg.shared_expert_size:
        return QUANT_SITES + ("sdown_in",)
    return QUANT_SITES


def identity_calib(cfg: ModelConfig, select_frac: float = 0.0,
                   device="cpu") -> List[Dict[str, SiteCalib]]:
    """Identity channel order and a fixed outlier fraction per site,
    KE = round(select_frac * K / 64) * 64 (Python's round, as in JAX).
    On an MoE config down_in is the experts' intermediate (one calib
    shared by the experts) and sdown_in the shared expert's."""
    def site(k):
        ke = int(round(select_frac * k / 64)) * 64
        return SiteCalib(torch.arange(k, dtype=torch.int32, device=device),
                         ke)
    per_layer = {"attn_in": site(cfg.hidden_size),
                 "o_in": site(cfg.q_size),
                 "mlp_in": site(cfg.hidden_size),
                 "down_in": site(cfg.moe_intermediate_size if cfg.num_experts
                                 else cfg.intermediate_size)}
    if "sdown_in" in quant_sites(cfg):
        per_layer["sdown_in"] = site(cfg.shared_expert_size)
    return [dict(per_layer) for _ in range(cfg.num_layers)]


def check_qcfg(qcfg: QuantConfig) -> None:
    """Raise NotImplementedError for quantization settings outside the
    ported serving path (NVFP4 W4A4 or W4A16 activations, hybrid
    prefill_act_bits in {0, 4, 16}, w8 or w4 packed weights, per-row
    activation scales)."""
    if qcfg.quant_type != "NVFP4" or not qcfg.use_kernels:
        raise NotImplementedError(
            f"quant_type={qcfg.quant_type!r} use_kernels="
            f"{qcfg.use_kernels}: only the NVFP4 packed-kernel path is "
            "ported (ROADMAP queue 1 items 2-3)")
    if qcfg.weight_fmt not in ("w4", "w8"):
        raise ValueError(f"unknown weight_fmt {qcfg.weight_fmt!r}")
    if qcfg.act_bits not in (4, 16) or qcfg.prefill_act_bits not in (0, 4,
                                                                     16):
        raise NotImplementedError(
            f"act_bits={qcfg.act_bits} prefill_act_bits="
            f"{qcfg.prefill_act_bits}: only 4 and 16 are ported")
    if qcfg.act_scale != "row":
        raise NotImplementedError(
            "act_scale='tensor' is not ported (ROADMAP queue 1 item 2)")
    if not qcfg.quantize_lm_head:
        raise NotImplementedError(
            "quantize_lm_head=False: the bf16 head is not ported, the "
            "serving path uses the W4A16 packed head (ROADMAP queue 1 "
            "item 6)")


def _pack(p: Params, calib: SiteCalib, w_scale: str, fmt: str):
    return packing.pack_weight_arc(p["w"], calib.reorder_index,
                                   calib.select_num, bias=p.get("b"),
                                   fmt=fmt, w_scale=w_scale)


def quantize_layer_params_fused(layer_p: Params,
                                layer_calib: Dict[str, SiteCalib],
                                qcfg: QuantConfig) -> Params:
    """Pack one layer for the engine: q/k/v concatenate into one packed
    GEMM ("qkv"), gate/up into "gateup"; multi-projection packs use
    per-channel weight scales. An MoE layer packs qkv and o, and its
    experts into "moe" (moe.quantize_moe_params_packed)."""
    def cat(names):
        w = torch.cat([layer_p[n]["w"] for n in names], dim=0)
        bs = [layer_p[n].get("b") for n in names]
        out = {"w": w}
        if all(b is not None for b in bs):
            out["b"] = torch.cat(bs)
        return out

    out = {"attn_norm": layer_p["attn_norm"],
           "mlp_norm": layer_p["mlp_norm"]}
    specs = {"qkv": (("q", "k", "v"), "attn_in"),
             "gateup": (("gate", "up"), "mlp_in"),
             "o": (("o",), "o_in"),
             "down": (("down",), "down_in")}
    if "moe" in layer_p:
        from . import moe
        out["moe"] = moe.quantize_moe_params_packed(layer_p["moe"],
                                                    layer_calib, qcfg)
        specs = {k: v for k, v in specs.items() if k in ("qkv", "o")}
    for name, (projs, site) in specs.items():
        p = cat(projs) if len(projs) > 1 else layer_p[projs[0]]
        w_scale = "channel" if len(projs) > 1 else qcfg.w_scale
        out[name] = _pack(p, layer_calib[site], w_scale, qcfg.weight_fmt)
    return out


def _act_quantize(x2d: torch.Tensor, calib: SiteCalib, qcfg: QuantConfig):
    """Quantize a [M, K] activation for its site: (xa, gx [M, 1]).

    act_bits 16 (W4A16) keeps the activation exact: bf16, zero-padded to
    the packed weight's width (so the ARC residual columns carry zeros),
    with a unit scale; no actq launch."""
    if qcfg.act_bits == 16:
        k = x2d.shape[1]
        width = packing.pad_kq(k, calib.select_num)
        return (torch.nn.functional.pad(x2d.to(torch.bfloat16),
                                        (0, width - k)), 1.0)
    return qk.quantize_x_arc(x2d, calib.reorder_index, calib.select_num,
                             per_row=qcfg.act_scale == "row")


def _q_linear(qp, xa: torch.Tensor, gx: torch.Tensor,
              out_dtype) -> torch.Tensor:
    """A packed linear (PackedWeightI8 or PackedWeight) on an
    already-quantized activation."""
    return gk.gemm_dequant(xa, qp, gx, out_dtype=out_dtype)
