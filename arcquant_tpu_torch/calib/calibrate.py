"""Calibration pipeline (counterpart of ``arcquant_tpu/calib/calibrate.py``):
activation statistics -> channel reorder indices -> ARC outlier-channel
counts.

Each decoder layer forwards the calibration set with its
activation-quantization sites tapped (``site_activations``; an MoE layer
taps its experts' down input and the shared expert's, five sites), and the
per-site statistics are reduced chunk by chunk, so the raw activations
of only one chunk exist at a time. The sample axis is streamed: a layer
runs the samples in chunks of ``_CHUNK_TOKENS // T`` (8192 tokens), and
the only cross-layer state is the [S, T, D] residual stream (1.9 GB in
bf16 at 128 x 2048 tokens of a 7B model). The layers may come one at a
time from a callable (a 7B bf16 model next to that stream still fits the
card, but the callable keeps one layer on it). Attention is
``kernels.attention.flash_attention``: the CUDA kernel #9 on the card,
its plain version on the CPU.

Metrics (the JAX package's, reference utilize.py:89-116):
  max     per-channel infinity norm over tokens, running max over chunks
  hessian diag(2/S * X^T X): the raw sum of squares, 2/S applied once
  score   per-sample L2 of the NVFP4 quantization error, running max

The reorder index is the ascending (stable) argsort of the stat, so the
outlier channels land at the end. The select count of a site is
min(ceil(K * frac / 64) * 64, K), where frac is the mean over the first
``select_batch`` samples of the share of a row's entries above 0.125 x
the row's signed max.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..config import ModelConfig, OUTLIER_THRESHOLD, SELECT_NUM_MULTIPLE
from ..engine.engine import resolve_device
from ..kernels import attention
from ..models import llama, moe
from ..models.quantized import SiteCalib, quant_sites
from ..quant import numerics as N

METRICS = ("max", "hessian", "score")

# Stream samples through each layer in chunks of about this many tokens
# (max(1, _CHUNK_TOKENS // seqlen) samples): bounds the f32 site
# transients (down_in is [chunk * T, intermediate]).
_CHUNK_TOKENS = 8192


def site_activations(cfg: ModelConfig, p, x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor):
    """Forward one decoder layer (x [B, T, D]), also returning the
    activation at each quantization site: (x out, {site: [B, T, K]}). The
    ops are llama.layer_forward's with attention as flash_attention
    (dense [B, H, T, T] scores do not fit at 128 x 2048); silu(gate) * up
    in f32, cast to x's dtype. An MoE layer runs moe.moe_block on its raw
    bf16 experts with taps: down_in is the routing-masked [T, E, F]
    intermediate (dense mode) or the [E, C, F] capacity slots (dispatch
    mode; the tokens of the call set the mode and the capacity), sdown_in
    the shared expert's; each is flattened to one row [1, N, F], so
    score's L2 runs over the chunk rather than a sample, as in the JAX
    package."""
    sites = {}
    b, t, _ = x.shape
    h = llama.rms_norm(x, p["attn_norm"], cfg.rms_eps)
    sites["attn_in"] = h
    q = llama.linear(p["q"], h).reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = llama.linear(p["k"], h).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = llama.linear(p["v"], h).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    q, k = llama.apply_rope(q, k, cos, sin)
    attn = attention.flash_attention(q, k, v).reshape(b, t, cfg.q_size)
    sites["o_in"] = attn
    x = x + llama.linear(p["o"], attn)
    h = llama.rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    sites["mlp_in"] = h
    if "moe" in p:
        taps: Dict[str, torch.Tensor] = {}
        y = moe.moe_block(cfg, p["moe"], h, taps=taps)
        for name, v in taps.items():
            sites[name] = v.reshape(1, -1, v.shape[-1])
        return x + y, sites
    gate = llama.linear(p["gate"], h)
    up = llama.linear(p["up"], h)
    inter = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
    sites["down_in"] = inter
    return x + llama.linear(p["down"], inter), sites


def _site_stat(acts: torch.Tensor, metric: str) -> torch.Tensor:
    """Per-channel statistic [K] f32 of one chunk's activations [C, T,
    K]: the infinity norm (max), the raw sum of squares (hessian; 2/S is
    applied once a layer), or the per-sample L2 of x - nvfp4_qdq(x), max
    over the chunk (score)."""
    c, t, k = acts.shape
    a = acts.reshape(-1, k).float()
    if metric == "hessian":
        return (a * a).sum(dim=0)
    if metric == "score":
        err = acts.float() - N.nvfp4_qdq(a).reshape(c, t, k)
        return torch.sqrt((err * err).sum(dim=1)).amax(dim=0)
    return a.abs().amax(dim=0)


def _site_outlier_count(acts: torch.Tensor) -> torch.Tensor:
    """Per-sample [C] f32 share of a row's entries above 0.125 x the
    row's signed max, averaged over the sample's rows. All-zero rows are
    left out of the mean (an MoE tap's unrouted slots)."""
    a = acts.float()
    thresh = a.amax(dim=-1, keepdim=True) * OUTLIER_THRESHOLD
    live = (a.abs().amax(dim=-1) > 0).float()
    frac_row = (a > thresh).float().mean(dim=-1)
    return ((frac_row * live).sum(dim=1)
            / torch.clamp(live.sum(dim=1), min=1.0))


def _accumulate(old, new, metric: str):
    if old is None:
        return new
    return old + new if metric == "hessian" else torch.maximum(old, new)


def _layer_to(p, device):
    return {k: (_layer_to(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in p.items()}


def compute_calibration(cfg: ModelConfig, params, tokens, metric: str = "max",
                        select_batch: int | None = None, device="cuda"):
    """Run the calibration pipeline on `device` (the card unless "cpu").

    params: "embed" and "layers", a list of layer dicts or a callable
      layers(li) that makes layer li (called once a layer, in order);
      each layer moves to `device` for its pass and is freed after it.
    tokens: [S, T] calibration token ids (numpy or a tensor).
    metric: max, hessian or score.
    select_batch: how many of the samples feed the select counts (the
      reference's 32 of 128); all by default.
    Returns (calib: per layer {site: SiteCalib}, stats: per layer {site:
    [K] f32}, avg_bits: 4.5 bits a channel, ARC columns included)."""
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r} not in {METRICS}")
    device = resolve_device(device)
    sites_cfg = quant_sites(cfg)
    tokens = (tokens.to(device, torch.long) if torch.is_tensor(tokens)
              else torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                   device=device))
    s, t = tokens.shape
    nsel = min(select_batch or s, s)
    chunk = max(1, min(s, _CHUNK_TOKENS // max(t, 1)))

    embed = params["embed"]
    xs = [embed[tokens[i:i + chunk].to(embed.device)].to(device)
          for i in range(0, s, chunk)]
    ropes = {}
    for xc in xs:
        c = xc.shape[0]
        if c not in ropes:
            pos = torch.arange(t, device=device)[None, :].expand(c, t)
            ropes[c] = llama.rope_cos_sin(cfg, pos)

    layers = params["layers"]
    streamed = callable(layers)
    per_layer_stats: List[Dict[str, torch.Tensor]] = []
    per_layer_fracs: List[Dict[str, float]] = []
    for li in range(cfg.num_layers):
        p = _layer_to(layers(li) if streamed else layers[li], device)
        acc: Dict[str, torch.Tensor] = {site: None for site in sites_cfg}
        fr: Dict[str, list] = {site: [] for site in sites_cfg}
        for j, xc in enumerate(xs):
            cos, sin = ropes[xc.shape[0]]
            xs[j], sites = site_activations(cfg, p, xc, cos, sin)
            for site in sites_cfg:
                acc[site] = _accumulate(acc[site],
                                        _site_stat(sites[site], metric),
                                        metric)
                fr[site].append(_site_outlier_count(sites[site]))
            del sites
        del p
        if metric == "hessian":
            acc = {site: v * (2.0 / s) for site, v in acc.items()}
        per_layer_stats.append(acc)
        per_layer_fracs.append(
            {site: float(torch.cat(fr[site]).cpu().numpy()[:nsel].mean())
             for site in sites_cfg})

    calib = []
    total_elems, total_bits = 0, 0.0
    for stats, fracs in zip(per_layer_stats, per_layer_fracs):
        layer_calib = {}
        for site in sites_cfg:
            stat = stats[site]
            k = stat.shape[0]
            # stable, as jnp.argsort: equal stats keep channel order
            order = torch.argsort(stat, stable=True).to(torch.int32)
            sel = min(math.ceil(k * fracs[site] / SELECT_NUM_MULTIPLE)
                      * SELECT_NUM_MULTIPLE, k)
            layer_calib[site] = SiteCalib(order, sel)
            total_elems += k
            total_bits += 4.5 * (k + sel)
        calib.append(layer_calib)
    return calib, per_layer_stats, total_bits / max(total_elems, 1)
