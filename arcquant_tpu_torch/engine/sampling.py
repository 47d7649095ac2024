"""On-device stochastic sampling: temperature, top-k and top-p
(counterpart of ``arcquant_tpu/engine/sampling.py``).

Everything runs on the logits' device and is batch-vectorized:
`temperature` and `top_p` may be per-row tensors (per-request sampling
under continuous batching; rows with temperature 0 take the greedy
token), `top_k` is an int. Sampling is Gumbel-max, argmax(warped logits
+ Gumbel noise), with the noise drawn from an explicit
``torch.Generator``, never the global RNG. The streams are not the JAX
package's (``jax.random`` and torch's generators give other bits from
the same seed); the distribution is the same.

Warp order matches HF transformers: temperature -> top-k -> top-p
(nucleus mass computed on the temperature-warped distribution).
"""

from __future__ import annotations

import numbers
from dataclasses import dataclass
from typing import Sequence

import torch

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class SamplingParams:
    """Sampling config. temperature 0 = greedy; top_k 0 = off; top_p 1 =
    off."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def _per_row(v, b: int, device) -> torch.Tensor:
    """A Python (or numpy) number or a [B] tensor -> a [B] f32 tensor on
    `device`; a number is a fill there, never a host-to-device copy
    (which a CUDA graph capture refuses)."""
    if isinstance(v, numbers.Real):
        return torch.full((b,), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(v, dtype=torch.float32, device=device).expand(b)


def warp_logits(logits: torch.Tensor, temperature=1.0, top_k: int = 0,
                top_p=1.0) -> torch.Tensor:
    """Apply the temperature -> top-k -> top-p warps to [B, V] logits,
    returning warped f32 logits (masked entries are -inf). Sampling from
    softmax(warp_logits(x)) is the engine's sampled distribution."""
    b, v = logits.shape
    x = logits.float() / torch.clamp(
        _per_row(temperature, b, logits.device), min=1e-6)[:, None]
    if top_k and top_k < v:
        kth = torch.topk(x, top_k, dim=-1).values[:, -1:]
        x = torch.where(x < kth, float("-inf"), x)
    if not (isinstance(top_p, (int, float)) and top_p >= 1.0):
        tp = _per_row(top_p, b, logits.device)
        probs = torch.softmax(x, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        # keep the smallest prefix of the sorted probs reaching top_p
        # mass; the top-1 token is kept unconditionally (HF
        # min_tokens_to_keep=1: top_p <= 0 must not mask everything)
        prev = torch.cumsum(sp, dim=-1) - sp
        keep = prev < tp[:, None]
        keep[:, 0] = True
        cutoff = torch.where(keep, sp, float("inf")).amin(dim=-1,
                                                          keepdim=True)
        x = torch.where(probs < cutoff, float("-inf"), x)
    return x


def gumbel_noise(shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), drawn
    from `generator` (on `device`)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def mix_seed(seed: int, step: int) -> int:
    """A generator seed from (seed, step) through splitmix64, so every bit
    of both reaches the low 32 bits (the CPU generator reads only
    those)."""
    return _splitmix64(((seed & 0xFFFFFFFF) << 32)
                       | (step & 0xFFFFFFFF)) >> 1


def row_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of a seeded request at `step` (tokens generated so
    far), seeded with mix_seed(seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(seed, step))
    return g


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature=1.0, top_k: int = 0, top_p=1.0) -> torch.Tensor:
    """Sample one token per row from [B, V] logits.

    temperature / top_p: python floats or [B] tensors (per-request).
    Rows with temperature <= 0 get the argmax. Returns [B] i32."""
    b, v = logits.shape
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if (isinstance(temperature, (int, float)) and temperature <= 0.0
            and top_k == 0):
        return greedy
    x = warp_logits(logits, temperature, top_k, top_p)
    sampled = (x + gumbel_noise((b, v), generator, x.device)).argmax(dim=-1)
    t = _per_row(temperature, b, logits.device)
    return torch.where(t <= 0.0, greedy, sampled.to(torch.int32))


def sample_with_keys(logits: torch.Tensor,
                     generators: Sequence[torch.Generator],
                     temperature=1.0, top_k: int = 0,
                     top_p=1.0) -> torch.Tensor:
    """Like sample(), with one generator per row (generators[i] draws row
    i's noise). Per-request seeded sampling under continuous batching
    gives a row the generator of (request seed, tokens generated), so a
    request's sampled stream is reproducible whatever else shares the
    batch."""
    b, v = logits.shape
    greedy = logits.argmax(dim=-1).to(torch.int32)
    x = warp_logits(logits, temperature, top_k, top_p)
    noise = torch.stack([gumbel_noise((v,), g, x.device)
                         for g in generators])
    sampled = (x + noise).argmax(dim=-1).to(torch.int32)
    t = _per_row(temperature, b, logits.device)
    return torch.where(t <= 0.0, greedy, sampled)


def sample_p(logits: torch.Tensor, generator: torch.Generator,
             p: SamplingParams) -> torch.Tensor:
    return sample(logits, generator, p.temperature, p.top_k, p.top_p)
