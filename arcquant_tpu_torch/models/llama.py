"""Llama / Qwen2 (and Qwen-MoE / Mixtral) decoder building blocks
(counterpart of ``arcquant_tpu/models/llama.py``): RMSNorm, RoPE, the
bf16 linear and the dummy-weight initialiser the serving engine needs."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from ..kernels import gemm as gk

Params = Dict[str, object]


def _init_linear(gen: torch.Generator, n_out: int, n_in: int, bias: bool,
                 dtype, device) -> Params:
    w = torch.randn((n_out, n_in), generator=gen, dtype=torch.float32,
                    device=device)
    p = {"w": (w * (1.0 / math.sqrt(n_in))).to(dtype)}
    if bias:
        p["b"] = torch.zeros((n_out,), dtype=dtype, device=device)
    return p


def init_layer_params(cfg: ModelConfig, gen: torch.Generator,
                      dtype=torch.bfloat16, device="cpu") -> Params:
    """Random ("dummy") weights of one decoder layer, N(0, 1/K) linears
    and unit norms, drawn from `gen` (a torch.Generator on `device`). An
    MoE config's layer holds the attention linears and "moe" (the
    experts, models/moe.py) in place of the dense MLP."""
    h, qb = cfg.hidden_size, cfg.qkv_bias

    def lin(n_out, n_in, bias=False):
        return _init_linear(gen, n_out, n_in, bias, dtype, device)

    p = {
        "attn_norm": torch.ones((h,), dtype=dtype, device=device),
        "mlp_norm": torch.ones((h,), dtype=dtype, device=device),
        "q": lin(cfg.q_size, h, qb),
        "k": lin(cfg.kv_size, h, qb),
        "v": lin(cfg.kv_size, h, qb),
        "o": lin(h, cfg.q_size),
    }
    if cfg.num_experts:
        from . import moe
        p["moe"] = moe.init_moe_params(cfg, gen, dtype, device)
        return p
    p.update(gate=lin(cfg.intermediate_size, h),
             up=lin(cfg.intermediate_size, h),
             down=lin(h, cfg.intermediate_size))
    return p


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in f32, round to x.dtype, then multiply by w (in x's
    dtype), the JAX package's rounding chain."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ p["w"].T (+ p["b"]) of an unquantized linear: the product
    accumulated like f32 (gemm.matmul_f32, the product JAX leaves to
    XLA with preferred_element_type=f32), the bias added in f32, the
    result cast back to x's dtype."""
    y = gk.matmul_f32(x, p["w"].t())
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def rope_inv_freq(cfg: ModelConfig) -> torch.Tensor:
    """Rotary inverse frequencies [Dh/2], f32, computed on the host
    (with the Llama-3.1 scaling when configured)."""
    d = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta
                 ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    if cfg.rope_scaling_factor is not None:
        low = cfg.rope_original_max_pos / cfg.rope_low_freq_factor
        high = cfg.rope_original_max_pos / cfg.rope_high_freq_factor
        wavelen = 2 * math.pi / inv
        smooth = torch.clamp(
            (cfg.rope_original_max_pos / wavelen - cfg.rope_low_freq_factor)
            / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor),
            0.0, 1.0)
        scaled = inv / cfg.rope_scaling_factor
        mid = (1 - smooth) * scaled + smooth * inv
        inv = torch.where(wavelen > low, scaled,
                          torch.where(wavelen < high, inv, mid))
    return inv


def rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor,
                 inv_freq: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., Dh] for integer positions (on their device)."""
    if inv_freq is None:
        inv_freq = rope_inv_freq(cfg)
    inv = inv_freq.to(positions.device)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k: [B, T, H, Dh]; cos/sin: [B, T, Dh] or [T, Dh]. Rotate-half
    convention, computed in f32 and cast back."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    qf, kf = q.float(), k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
