"""Quantized W4A4 NVFP4 + ARC decoder layers (counterpart of
``arcquant_tpu/models/quantized.py``): calibration artifacts, the
activation quantize per site and the quantized linear, and two ways to
quantize the weights:

- the serving engine's (``quantize_layer_params_fused``): q/k/v and
  gate/up fused into packed GEMMs (and the packed experts of an MoE
  layer); with the fake formats or use_kernels=False the same fused
  linears fake-quantized (an MoE layer's experts as qdq stacks); with
  quant_type "BF16" unquantized bf16 linears (the engine's baseline);
- the accuracy path's (``quantize_model_params``): the seven linears of
  a layer apart (an MoE layer's four attention linears and its experts'
  qdq stacks), packed (NVFP4 with use_kernels), fake-quantized
  ({"w_aug", "gs", "b"?}: the qdq weight with its ARC columns, in every
  format) or left bf16, run by the no-cache forward
  ``quant_model_forward`` (and its dense-KV-cache layer) that
  perplexity and the task evals measure.

The fake-quant forward runs plain torch ops; with use_kernels it runs
the same CUDA kernels as the engine (actq, the GEMMs, flash attention).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from ..config import QUANT_TYPES, ModelConfig, QuantConfig
from ..kernels import gemm as gk
from ..kernels import quantize as qk
from ..quant import arc, numerics as N
from ..quant import packing
from . import llama

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
    """Raise for quantization settings the JAX engine does not run
    either: an unknown quant_type, weight_fmt or act_scale, act_bits
    outside {4, 16} and prefill_act_bits outside {0, 4, 16}. Everything
    else runs, as in the JAX engine: BF16 (unquantized linears, which
    ignores the other fields; on an MoE config the bf16 expert stacks),
    NVFP4 with packed kernels (w8 or w4, per-row or per-tensor
    activation scales, the packed or the bf16 head) and the fake-quant
    route (every format, or use_kernels=False: qdq weights, plain torch
    quantizes and products; an MoE layer's experts as qdq stacks), on
    every model config."""
    if qcfg.quant_type not in QUANT_TYPES:
        raise ValueError(f"unknown quant_type {qcfg.quant_type!r}")
    if qcfg.quant_type == "BF16":
        return
    if qcfg.weight_fmt not in ("w4", "w8"):
        raise ValueError(f"unknown weight_fmt {qcfg.weight_fmt!r}")
    if qcfg.act_scale not in ("row", "tensor"):
        raise ValueError(f"unknown act_scale {qcfg.act_scale!r}")
    if qcfg.act_bits not in (4, 16) or qcfg.prefill_act_bits not in (0, 4,
                                                                     16):
        raise NotImplementedError(
            f"act_bits={qcfg.act_bits} prefill_act_bits="
            f"{qcfg.prefill_act_bits}: the engine runs 4 and 16, as the "
            "JAX engine does")


def _quantize_linear_packed(p: Params, calib: SiteCalib, fmt: str = "w8",
                            w_scale: str = "tensor"):
    return packing.pack_weight_arc(p["w"], calib.reorder_index,
                                   calib.select_num, bias=p.get("b"),
                                   fmt=fmt, w_scale=w_scale)


def _packed_route(qcfg: QuantConfig) -> bool:
    """NVFP4 with use_kernels: packed weights and the CUDA kernels."""
    return qcfg.use_kernels and qcfg.quant_type == "NVFP4"


def quantize_layer_params_fused(layer_p: Params,
                                layer_calib: Dict[str, SiteCalib],
                                qcfg: QuantConfig) -> Params:
    """Quantize one layer for the engine: q/k/v concatenate into one
    linear ("qkv"), gate/up into "gateup"; multi-projection linears take
    per-channel weight scales. Packed for NVFP4 with use_kernels,
    fake-quantized ({"w_aug", "gs", "b"?}) otherwise, and for BF16 the
    concatenated bf16 {"w", "b"?} linears. An MoE layer keeps qkv and o
    and holds its experts in "moe": packed
    (moe.quantize_moe_params_packed) on the packed route, else the qdq
    stacks (moe.quantize_moe_params; at BF16 the bf16 stacks)."""
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
        quantize = (moe.quantize_moe_params_packed if _packed_route(qcfg)
                    else moe.quantize_moe_params)
        out["moe"] = quantize(layer_p["moe"], layer_calib, qcfg)
        specs = {k: v for k, v in specs.items() if k in ("qkv", "o")}
    for name, (projs, site) in specs.items():
        p = cat(projs) if len(projs) > 1 else layer_p[projs[0]]
        w_scale = "channel" if len(projs) > 1 else qcfg.w_scale
        if qcfg.quant_type == "BF16":
            out[name] = p
        elif _packed_route(qcfg):
            out[name] = _quantize_linear_packed(p, layer_calib[site],
                                                qcfg.weight_fmt, w_scale)
        else:
            out[name] = _quantize_linear_fake(
                p, layer_calib[site], qcfg.quant_type,
                per_channel=w_scale == "channel")
    return out


_SITE_OF_PROJ = {"q": "attn_in", "k": "attn_in", "v": "attn_in",
                 "o": "o_in", "gate": "mlp_in", "up": "mlp_in",
                 "down": "down_in"}

def _quantize_linear_fake(p: Params, calib: SiteCalib, quant_type: str,
                          per_channel: bool = False) -> Params:
    """{"w_aug": bf16 [N, K + KE] qdq weight with its ARC columns, in
    scaled units, "gs": its global scale ([1, N] per channel, else a
    scalar), "b"?: the bias as it is}."""
    wa, gs = arc.arc_quantize_w_qdq(p["w"], calib.reorder_index,
                                    calib.select_num, quant_type,
                                    per_channel=per_channel)
    out = {"w_aug": wa.to(torch.bfloat16),
           "gs": gs.reshape(1, -1) if gs.dim() else gs}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_layer_params(layer_p: Params, layer_calib: Dict[str, SiteCalib],
                          qcfg: QuantConfig) -> Params:
    """Quantize one layer's linears apart (the accuracy path): packed for
    NVFP4 with use_kernels, fake-quantized otherwise, left as they are
    for BF16; the norms stay bf16. An MoE layer's experts become the qdq
    stacks at every setting (moe.quantize_moe_params), as in the JAX
    package, beside its four attention linears."""
    out = {"attn_norm": layer_p["attn_norm"], "mlp_norm": layer_p["mlp_norm"]}
    projs = tuple(_SITE_OF_PROJ)
    if "moe" in layer_p:
        from . import moe
        out["moe"] = moe.quantize_moe_params(layer_p["moe"], layer_calib,
                                             qcfg)
        projs = ("q", "k", "v", "o")
    for proj in projs:
        calib = layer_calib[_SITE_OF_PROJ[proj]]
        if qcfg.quant_type == "BF16":
            out[proj] = layer_p[proj]
        elif _packed_route(qcfg):
            out[proj] = _quantize_linear_packed(
                layer_p[proj], calib, qcfg.weight_fmt, qcfg.w_scale)
        else:
            out[proj] = _quantize_linear_fake(
                layer_p[proj], calib, qcfg.quant_type,
                per_channel=qcfg.w_scale == "channel")
    return out


def quantize_model_params(cfg: ModelConfig, params: Params, calib: list,
                          qcfg: QuantConfig, consume: bool = False) -> Params:
    """Quantize every decoder layer (quantize_layer_params); the
    embedding, final norm and head stay bf16.

    consume: set each slot of params["layers"] to None once its layer is
    quantized, so that a caller holding no other reference frees each raw
    layer as it goes and the raw and the quantized model never coexist
    (an MoE model's qdq stacks are as large as its raw ones)."""
    layers = params["layers"]
    qparams = {k: v for k, v in params.items() if k != "layers"}
    qparams["layers"] = []
    for i in range(len(layers)):
        qparams["layers"].append(quantize_layer_params(layers[i], calib[i],
                                                       qcfg))
        if consume:
            layers[i] = None
    return qparams


def _act_quantize(x2d: torch.Tensor, calib: SiteCalib, qcfg: QuantConfig):
    """Quantize a [M, K] activation for its site: (xa, gx).

    BF16 returns the activation as it is, with a unit scale. act_bits 16
    (W4A16) keeps the activation exact: bf16, zero-padded to the weight's
    width (the packed kq with use_kernels, else K + KE), so the ARC
    residual columns carry zeros, with a unit scale; no actq launch.
    NVFP4 with use_kernels runs quantize_x_arc (the actq kernel at
    per-row scales, gx [M, 1]; plain ops at act_scale "tensor", gx a
    scalar); every other case is the fake qdq, arc_quantize_x_qdq."""
    if qcfg.quant_type == "BF16":
        return x2d, 1.0
    per_row = qcfg.act_scale == "row"
    if qcfg.act_bits == 16:
        k = x2d.shape[1]
        width = (packing.pad_kq(k, calib.select_num) if qcfg.use_kernels
                 else k + calib.select_num)
        return (torch.nn.functional.pad(x2d.to(torch.bfloat16),
                                        (0, width - k)), 1.0)
    if _packed_route(qcfg):
        return qk.quantize_x_arc(x2d, calib.reorder_index, calib.select_num,
                                 per_row=per_row)
    return arc.arc_quantize_x_qdq(x2d, calib.reorder_index, calib.select_num,
                                  qcfg.quant_type, per_row=per_row)


def _q_linear(qp, xa: torch.Tensor, gx, out_dtype) -> torch.Tensor:
    """A quantized linear on an already-quantized activation: a packed
    one (PackedWeightI8 or PackedWeight) through gemm_dequant; a fake one
    ({"w_aug", "gs", "b"?}) as the product of xa in bf16 and w_aug
    accumulated like f32, times (gx * gs), plus the bias in f32; an
    unquantized {"w", "b"?} (BF16) on the activation cast to out_dtype."""
    if isinstance(qp, (packing.PackedWeight, packing.PackedWeightI8)):
        return gk.gemm_dequant(xa, qp, gx, out_dtype=out_dtype)
    if "w_aug" in qp:
        y = gk.matmul_f32(xa.to(torch.bfloat16), qp["w_aug"].t())
        y = y * (gx * qp["gs"])
        if "b" in qp:
            y = y + qp["b"].float()
        return y.to(out_dtype)
    return llama.linear(qp, xa.to(out_dtype))


def quant_attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor,
                          layer_calib: Dict[str, SiteCalib],
                          qcfg: QuantConfig, kv_cache=None,
                          cache_len: int = 0):
    """Quantized self-attention of the unfused layer: one quantize of x
    for q, k and v; with kv_quant, K fake-quantized (asym int groups)
    before RoPE and V after the cache; the dense cache (k_cache,
    v_cache) [B, Tmax, Hkv, Dh] as in llama.attention_block; the
    attention output re-quantized for o. Without a cache and with
    use_kernels, attention is flash_attention (the CUDA kernel on the
    card), else plain f32 attention. Returns (out, the new cache)."""
    b, t, d = x.shape
    dtype = x.dtype
    xa, gx = _act_quantize(x.reshape(b * t, d), layer_calib["attn_in"], qcfg)
    q = _q_linear(p["q"], xa, gx, dtype).reshape(b, t, cfg.num_heads,
                                                 cfg.head_dim)
    k = _q_linear(p["k"], xa, gx, dtype).reshape(b, t, cfg.num_kv_heads,
                                                 cfg.head_dim)
    v = _q_linear(p["v"], xa, gx, dtype).reshape(b, t, cfg.num_kv_heads,
                                                 cfg.head_dim)
    if qcfg.kv_quant:
        k = N.asym_int_group_qdq(k, qcfg.kv_bits, qcfg.kv_group_size)
    q, k = llama.apply_rope(q, k, cos, sin)
    if kv_cache is not None:
        new_cache, mask = llama.cache_update(kv_cache, k, v, int(cache_len))
        k_all, v_all = (c.to(dtype) for c in new_cache)
    else:
        new_cache, mask = None, None
        k_all, v_all = k, v
    if qcfg.kv_quant:
        v_all = N.asym_int_group_qdq(v_all, qcfg.kv_bits,
                                     qcfg.kv_group_size)
    if kv_cache is None and qcfg.use_kernels:
        from ..kernels.attention import flash_attention
        attn = flash_attention(q.contiguous(), k_all.contiguous(),
                               v_all.contiguous())
    else:
        attn = llama.dense_attention(
            q, llama.repeat_kv(k_all, cfg.num_kv_groups),
            llama.repeat_kv(v_all, cfg.num_kv_groups),
            causal=kv_cache is None, mask=mask)
    oa, go = _act_quantize(attn.reshape(b * t, cfg.q_size),
                           layer_calib["o_in"], qcfg)
    return _q_linear(p["o"], oa, go, dtype).reshape(b, t, d), new_cache


def quant_mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    layer_calib: Dict[str, SiteCalib],
                    qcfg: QuantConfig) -> torch.Tensor:
    """Quantized MLP: one quantize of x for gate and up, their outputs
    in x's dtype, silu(gate) * up in f32 rounded to x's dtype, then
    re-quantized for down."""
    b, t, d = x.shape
    xa, gx = _act_quantize(x.reshape(b * t, d), layer_calib["mlp_in"], qcfg)
    gate = _q_linear(p["gate"], xa, gx, x.dtype)
    up = _q_linear(p["up"], xa, gx, x.dtype)
    ia, gi = _act_quantize(qk._silu_mul(gate, up), layer_calib["down_in"],
                           qcfg)
    return _q_linear(p["down"], ia, gi, x.dtype).reshape(b, t, d)


def quant_layer_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        cos: torch.Tensor, sin: torch.Tensor,
                        layer_calib: Dict[str, SiteCalib],
                        qcfg: QuantConfig, kv_cache=None,
                        cache_len: int = 0):
    """One quantized decoder layer of quantize_layer_params' tree: (x +
    attention + MLP, the new cache); an MoE layer's MLP is
    moe.moe_block on its qdq stacks."""
    h = llama.rms_norm(x, p["attn_norm"], cfg.rms_eps)
    attn, new_cache = quant_attention_block(
        cfg, p, h, cos, sin, layer_calib, qcfg, kv_cache, cache_len)
    x = x + attn
    h = llama.rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    if "moe" in p:
        from . import moe
        return x + moe.moe_block(cfg, p["moe"], h, layer_calib,
                                 qcfg), new_cache
    return x + quant_mlp_block(cfg, p, h, layer_calib, qcfg), new_cache


def quant_model_forward(cfg: ModelConfig, qparams: Params, calib: list,
                        qcfg: QuantConfig, tokens: torch.Tensor,
                        positions: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The whole quantized forward without a cache: tokens [B, T] -> f32
    logits [B, T, V] (the bf16 head)."""
    if positions is None:
        positions = llama.positions_for(tokens)
    x = qparams["embed"][tokens.long()]
    cos, sin = llama.rope_cos_sin(cfg, positions)
    for i, p in enumerate(qparams["layers"]):
        x, _ = quant_layer_forward(cfg, p, x, cos, sin, calib[i], qcfg)
    return llama.head_logits(qparams, llama.rms_norm(
        x, qparams["final_norm"], cfg.rms_eps))
