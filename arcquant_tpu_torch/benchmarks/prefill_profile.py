"""Prefill component budget at Qwen2.5-7B, B 4 x T 1024 (counterpart of
``benchmarks/prefill_profile.py``).

  python -m arcquant_tpu_torch.benchmarks.prefill_profile

Times each per-layer component of the one-shot prefill in isolation
(common.Timer: CUDA events, L2 flushed, median [lo-hi]) so the prefill
can be attributed: the activation quantize sites, the four GEMMs three
ways, flash attention, norms, and rope with the KV append (#17, on q, k
and v as the column views of one qkv output, as the engine calls it).

The GEMMs: the dispatch the engine runs (gemm.gemm_dequant at
gemm.XLA_M = 512: the large-M route, dequant + torch.mm, where N >= Kq,
else the fused GEMM's large-M tile), the fused GEMM alone (XLA_M = 0)
and the BF16 engine's product of the bf16 weight (llama.linear: f32
accumulation, the JAX script's bf16 dot). The tool sets gemm.XLA_M
itself and restores it after each call. The JAX script's
ARC_SILU_GU_DEFUSE_M route (silu * up rounded to bf16, then the plain
quantize) is composed here. Eager torch hoists nothing out of a timed
call, so no barrier is needed.

Two ways: "quant", the select-free NVFP4 engine's prefill, and "bf16",
the BF16 engine's; a row's multiplicity in a way is the number of calls
that one layer of that engine's prefill makes to the row's function
(common.engine_calls counts them); alternatives have 0. The per-layer
sums are multiplied by cfg.num_layers (the JAX script prints x14, a
leftover of a 14-layer cut). Beyond the JAX script's rows:
rope_append_kv, once a layer in both ways, and silu * up alone once a layer
in the BF16 engine, which calls it.
"""

from __future__ import annotations

from typing import List

import torch

from ..cache import paged
from ..config import get_model_config
from ..engine.engine import split_qkv
from ..kernels import attention, gemm as gk, quantize as qk
from ..kernels import rope_kv as rk
from ..models import llama
from ..quant import packing
from .common import Row, engine_calls
from .decode_profile import site_shapes

WAYS = ("quant", "bf16")


def _at_xla_m(m: int, fn):
    """fn() with gemm.XLA_M set to m, restored after."""
    saved = gk.XLA_M
    gk.XLA_M = m
    try:
        return fn()
    finally:
        gk.XLA_M = saved


def plan(cfg, batch: int = 4, seq: int = 1024, device="cuda",
         page_size: int = 128) -> List[Row]:
    """The prefill's per-layer rows at cfg's widths, `batch` x `seq`
    tokens: name, callable, multiplicity in each of WAYS and the
    engine_calls key of its function. Inputs from a seeded generator on
    `device`."""
    gen = torch.Generator(device=device).manual_seed(0)
    b, t, m = batch, seq, batch * seq
    d, qs, f = cfg.hidden_size, cfg.q_size, cfg.intermediate_size
    eps = cfg.rms_eps

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def ridx(k):
        return torch.arange(k, dtype=torch.int32, device=device)

    def quant(n):
        return {"quant": n, "bf16": 0}

    none = {"quant": 0, "bf16": 0}
    rows = []
    x, xo = randn(m, d), randn(m, qs)
    wn = torch.ones((d,), dtype=torch.bfloat16, device=device)
    rows.append(Row(f"rmsnormq d={d} (attn/mlp_in)",
                    lambda: qk.rmsnorm_quantize_x(x, wn, eps, ridx(d), 0),
                    quant(2), "rmsnorm_quantize_x"))
    rows.append(Row(f"quantize_x d={qs} (o_in)",
                    lambda: qk.quantize_x_arc(xo, ridx(qs), 0), quant(1),
                    f"quantize_x_arc:{qs}"))
    xi = randn(m, f)
    rows.append(Row(f"quantize_x d={f}",
                    lambda: qk.quantize_x_arc(xi, ridx(f), 0), none,
                    f"quantize_x_arc:{f}"))
    gu = randn(m, 2 * f)
    rows.append(Row("silu-gu fused (down_in)",
                    lambda: qk.silu_mul_quantize_gu(gu, ridx(f), 0),
                    quant(1), "silu_mul_quantize_gu"))
    rows.append(Row("silu-gu defused (down_in)",
                    lambda: qk.quantize_x_arc(
                        qk._silu_mul(gu[:, :f], gu[:, f:]), ridx(f), 0),
                    none, None))
    rows.append(Row("silu*mul alone",
                    lambda: qk._silu_mul(gu[:, :f], gu[:, f:]),
                    {"quant": 0, "bf16": 1}, "silu_mul"))

    for name, (n, k) in site_shapes(cfg).items():
        w = (torch.randn((n, k), generator=gen, device=device) * 0.02).to(
            torch.bfloat16)
        pw = packing.pack_weight_arc(w, ridx(k), 0, fmt="w8",
                                     w_scale="channel")
        xa, gx = qk.quantize_x_arc(randn(m, k), ridx(k), 0, kq=pw.kq)
        xb = randn(m, k)
        rows.append(Row(f"{name} dispatch (XLA_M 512) N={n} K={k}",
                        lambda xa=xa, pw=pw, gx=gx: _at_xla_m(
                            512, lambda: gk.gemm_dequant(xa, pw, gx)),
                        quant(1), f"gemm_dequant:{name}"))
        rows.append(Row(f"{name} fused GEMM (XLA_M 0)",
                        lambda xa=xa, pw=pw, gx=gx: _at_xla_m(
                            0, lambda: gk.gemm_dequant(xa, pw, gx)),
                        none, None))
        rows.append(Row(f"{name} bf16 linear",
                        lambda w=w, xb=xb: llama.linear({"w": w}, xb),
                        {"quant": 0, "bf16": 1}, f"linear:{name}"))

    q4 = randn(b, t, cfg.num_heads, cfg.head_dim)
    k4 = randn(b, t, cfg.num_kv_heads, cfg.head_dim)
    v4 = randn(b, t, cfg.num_kv_heads, cfg.head_dim)
    both1 = {"quant": 1, "bf16": 1}
    rows.append(Row("flash attention",
                    lambda: attention.flash_attention(q4, k4, v4), both1,
                    "flash_attention"))
    x3 = x.reshape(b, t, d)
    rows.append(Row("rms_norm", lambda: llama.rms_norm(x3, wn, eps),
                    {"quant": 0, "bf16": 2}, "rms_norm"))
    pos = torch.arange(t, device=device)[None].expand(b, t)
    cos, sin = llama.rope_cos_sin(cfg, pos)
    pps = -(-t // page_size)
    cache = paged.init_cache(cfg.replace(num_layers=1), b * pps + 1,
                             page_size, device)
    pt = (1 + torch.arange(b, device=device)[:, None] * pps
          + torch.arange(pps, device=device)[None, :]).to(torch.int32)
    qv, kv_, vv = split_qkv(randn(b * t, cfg.q_size + 2 * cfg.kv_size),
                            b, t, cfg.q_size, cfg.kv_size, cfg.head_dim)
    rows.append(Row("rope + append_kv (#17)",
                    lambda: rk.rope_append_kv(qv, kv_, vv, cos, sin, cache,
                                              0, pt, pos),
                    both1, "rope_append_kv"))
    return rows


def layer_calls(eng, fn) -> dict:
    """Run fn() (a prefill of eng) and return the calls eng's layer stack
    made, counted as engine_calls keys them, per layer (the embedding,
    final norm and head lie outside the budget)."""
    real, box = eng._layer_stack, {}

    def stack(*a, **kw):
        with engine_calls(eng) as counts:
            y = real(*a, **kw)
        box["counts"] = counts
        return y
    eng._layer_stack = stack
    try:
        fn()
    finally:
        del eng._layer_stack
    return {k: n / eng.cfg.num_layers for k, n in box["counts"].items()}


def run(cfg, batch: int, seq: int, timer, rows=None) -> dict:
    """Time every row of plan(cfg, batch, seq) (or of `rows`, built by
    it) on the card with `timer` and print the budget: {"rows", "times",
    "per_layer": {way: (median, lo, hi) ms}, "totals": the same x
    cfg.num_layers}."""
    from .common import budget
    rows = rows or plan(cfg, batch, seq, "cuda")
    times = {r.name: timer(r.fn) for r in rows}
    per_layer = budget(rows, times, WAYS, unit="ms")
    L = cfg.num_layers
    totals = {w: tuple(v * L for v in per_layer[w]) for w in WAYS}
    for w in WAYS:
        (med, lo, hi), tot = per_layer[w], totals[w]
        print(f"per-layer ({w}): {med:.3f} ms [{lo:.3f}-{hi:.3f}] -> x{L} = "
              f"{tot[0]:.1f} ms [{tot[1]:.1f}-{tot[2]:.1f}]")
    return {"rows": rows, "times": times, "per_layer": per_layer,
            "totals": totals}


def main():
    from .common import Timer, card, require_cuda
    require_cuda("prefill_profile")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_model_config("qwen2.5-7b")
    print(f"# qwen2.5-7b prefill, B 4 x T 1024, {cfg.num_layers} layers, "
          f"device time, on {card()}")
    with torch.no_grad():
        run(cfg, 4, 1024, Timer())


if __name__ == "__main__":
    main()
