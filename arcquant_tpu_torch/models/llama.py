"""Llama / Qwen2 (and Qwen-MoE / Mixtral) decoder (counterpart of
``arcquant_tpu/models/llama.py``): RMSNorm, RoPE, the bf16 linear, the
dummy-weight initialisers, and the bf16 reference forward (plain
attention, optional dense KV cache) that the accuracy path measures
against."""

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


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random ("dummy") weights of the whole model from `gen` (a
    torch.Generator on `device`): embed N(0, 0.02^2), unit final norm,
    the layers (init_layer_params), and an untied lm_head."""
    def normal(shape, std):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * std).to(dtype)

    params: Params = {
        "embed": normal((cfg.vocab_size, cfg.hidden_size), 0.02),
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype,
                                 device=device),
        "layers": [init_layer_params(cfg, gen, dtype, device)
                   for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, cfg.hidden_size), 0.02)
    return params


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in f32, round to x.dtype, then multiply by w (in x's
    dtype), the JAX package's rounding chain."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ p["w"].T (+ p["b"]) of an unquantized linear: the
    product accumulated like f32 (gemm.matmul_f32, the product JAX leaves
    to XLA with preferred_element_type=f32), the bias added in f32, the
    result cast back to x's dtype."""
    y = gk.matmul_f32(x.reshape(-1, x.shape[-1]), p["w"].t()).reshape(
        *x.shape[:-1], -1)
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


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, T, Hkv, Dh] -> [B, T, Hkv * n_rep, Dh] (GQA head expansion)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention in f32. q: [B, Tq, H, Dh]; k/v: [B, Tk, H, Dh];
    causal aligns q with the end of k; mask (broadcast to [B, H, Tq,
    Tk]) keeps the True scores."""
    tq, dh = q.shape[1], q.shape[3]
    tk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * (1.0 / math.sqrt(dh))
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=q.device)[None, :]
        logits = torch.where(qi >= ki, logits, neg_inf)
    if mask is not None:
        logits = torch.where(mask, logits, neg_inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def cache_update(kv_cache, k: torch.Tensor, v: torch.Tensor,
                 cache_len: int):
    """A dense cache (k_cache, v_cache) [B, Tmax, Hkv, Dh] with k and v
    written at token cache_len (new tensors; the inputs stay as they
    were), and the mask [1, 1, T, Tmax] of the T new queries: causal
    over the cache filled up to cache_len + T."""
    kc, vc = (c.clone() for c in kv_cache)
    t = k.shape[1]
    kc[:, cache_len:cache_len + t] = k.to(kc.dtype)
    vc[:, cache_len:cache_len + t] = v.to(vc.dtype)
    pos = torch.arange(kc.shape[1], device=k.device)
    qi = torch.arange(t, device=k.device)[:, None] + cache_len
    mask = (qi >= pos[None, :]) & (pos < cache_len + t)[None, :]
    return (kc, vc), mask[None, None]


def attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor,
                    kv_cache=None, cache_len: int = 0):
    """Self-attention, with an optional dense KV cache (k_cache,
    v_cache) [B, Tmax, Hkv, Dh] holding cache_len tokens. Returns (out
    [B, T, D], the new cache or None)."""
    b, t, _ = x.shape
    q = linear(p["q"], x).reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = linear(p["k"], x).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = linear(p["v"], x).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)
    if kv_cache is not None:
        new_cache, mask = cache_update(kv_cache, k, v, int(cache_len))
        kk, vv = (c.to(q.dtype) for c in new_cache)
        out = dense_attention(q, repeat_kv(kk, cfg.num_kv_groups),
                              repeat_kv(vv, cfg.num_kv_groups),
                              causal=False, mask=mask)
    else:
        new_cache = None
        out = dense_attention(q, repeat_kv(k, cfg.num_kv_groups),
                              repeat_kv(v, cfg.num_kv_groups), causal=True)
    return linear(p["o"], out.reshape(b, t, cfg.q_size)), new_cache


def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)): silu in f32 rounded to x's dtype, then
    the product in x's dtype."""
    gate = torch.nn.functional.silu(linear(p["gate"], x).float()).to(x.dtype)
    return linear(p["down"], gate * linear(p["up"], x))


def layer_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor, kv_cache=None,
                  cache_len: int = 0):
    """One bf16 decoder layer: (x + attention + MLP, the new cache); an
    MoE layer's MLP is moe.moe_block on its bf16 expert stacks."""
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    attn, new_cache = attention_block(cfg, p, h, cos, sin, kv_cache,
                                      cache_len)
    x = x + attn
    h = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    if "moe" in p:
        from . import moe
        return x + moe.moe_block(cfg, p["moe"], h), new_cache
    return x + mlp_block(cfg, p, h), new_cache


def head_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The bf16 head's f32 logits [..., V] of hidden states x [..., D]
    (lm_head, or the tied embedding), accumulated like f32."""
    head = params.get("lm_head", params["embed"])
    y = gk.matmul_f32(x.reshape(-1, x.shape[-1]), head.t())
    return y.reshape(*x.shape[:-1], head.shape[0])


def positions_for(tokens: torch.Tensor) -> torch.Tensor:
    """0..T-1 for each row of tokens [B, T]."""
    b, t = tokens.shape
    return torch.arange(t, device=tokens.device)[None, :].expand(b, t)


def model_forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole bf16 forward without a cache: tokens [B, T] -> f32
    logits [B, T, V]."""
    if positions is None:
        positions = positions_for(tokens)
    x = params["embed"][tokens.long()]
    cos, sin = rope_cos_sin(cfg, positions)
    for p in params["layers"]:
        x, _ = layer_forward(cfg, p, x, cos, sin)
    return head_logits(params, rms_norm(x, params["final_norm"],
                                        cfg.rms_eps))
