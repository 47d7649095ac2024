"""Decode-step component budget at Qwen2.5-7B bs 4 (counterpart of
``benchmarks/decode_profile.py``).

  python -m arcquant_tpu_torch.benchmarks.decode_profile

Times each component of the select-free decode step in isolation, so
the 28-layer step can be attributed: packed GEMMs, activation quantize
sites, rmsnorm, rope with the KV append (#17), paged attention, LM head,
sampling.
Each row is timed with common.Timer (CUDA events, L2 flushed; median
[lo-hi] of its runs) in place of the JAX script's two-length scan;
rope_append_kv writes in place into a pool, reading q, k and v as the
column views of one qkv row, as the engine does. A row whose hi - lo
exceeds half its median is marked noisy; every row is printed and
summed.

The port's select-free step at M 4..16 runs the decode megakernels
(quantize + GEMM at attn_in with its rmsnorm and at o_in, the whole MLP
with its rmsnorm) where the JAX script times the chain of quantize and
GEMM, so the plan has two ways: "chain" (InferenceEngine(...,
fused_decode=False)) and "fused" (the default), and the total is printed
both ways. Each row's multiplicity in a way is the number of calls that
one step of that engine makes to the row's function (common.engine_calls
counts them): the four GEMMs, the three quantize sites and the three
megakernels once a layer (attn_in and mlp_in twice), rope_append_kv and
paged_decode once a layer, the head and the sampling once a step. The
JAX script's rmsnorm x56 is x1 here: the port's step fuses each layer's
two norms into the rmsnorm quantize (or the megakernel), and calls the
norm itself only for the final one.

The isolated rows run L2-cold and each alone, so they overshoot the
step. So the script (``run(..., eng=)``) also takes the in-graph pass: a
28-layer select-free dummy engine's decode graph, prefilled with SEQ_LEN
tokens a row, attributed kernel by kernel over 8 replays to the rows'
keys (``in_graph``, ``trace_summary.map_graph``), and each row's
in-graph ms a step printed beside its isolated time x calls.
"""

from __future__ import annotations

import argparse
from typing import List

import torch

from ..cache import paged
from ..config import QuantConfig, get_model_config
from ..engine.engine import InferenceEngine, pack_lm_head, split_qkv
from ..kernels import gemm as gk, mlp_fused as mf
from ..kernels import paged_decode as pdk, quantize as qk
from ..kernels import rope_kv as rk
from ..models import llama
from ..quant import packing
from .common import Row

WAYS = ("chain", "fused")
SEQ_LEN = 777        # the attended context of each row
MAX_SEQ = 2048       # a row's page range


def site_shapes(cfg) -> dict:
    """The four linears of a layer: site -> (N, K)."""
    d, qs, kvs, f = (cfg.hidden_size, cfg.q_size, cfg.kv_size,
                     cfg.intermediate_size)
    return {"qkv": (qs + 2 * kvs, d), "o": (d, qs), "gateup": (2 * f, d),
            "down": (d, f)}


def packed_sites(cfg, gen, device) -> dict:
    """Each site's w8 weight, N(0, 0.02^2), packed with channel scales and
    no ARC columns, as the select-free engine packs it."""
    out = {}
    for name, (n, k) in site_shapes(cfg).items():
        w = (torch.randn((n, k), generator=gen, device=device) * 0.02).to(
            torch.bfloat16)
        out[name] = packing.pack_weight_arc(
            w, torch.arange(k, dtype=torch.int32, device=device), 0,
            fmt="w8", w_scale="channel")
        del w
    return out


def plan(cfg, batch: int = 4, device="cuda", seq_len: int = SEQ_LEN,
         max_seq: int = MAX_SEQ, page_size: int = 128) -> List[Row]:
    """The decode step's rows at cfg's widths and `batch` rows: name,
    callable, multiplicity in each of WAYS, and the engine_calls key of
    the function it attributes. Inputs from a seeded generator on
    `device`."""
    gen = torch.Generator(device=device).manual_seed(0)
    L, b = cfg.num_layers, batch
    d, qs, f = cfg.hidden_size, cfg.q_size, cfg.intermediate_size
    eps = cfg.rms_eps

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def ridx(k):
        return torch.arange(k, dtype=torch.int32, device=device)

    def chain(n):
        return {"chain": n, "fused": 0}

    def both(n):
        return {"chain": n, "fused": n}

    rows = []
    pws = packed_sites(cfg, gen, device)
    for name, pw in pws.items():
        k = site_shapes(cfg)[name][1]
        xa, gx = qk.quantize_x_arc(randn(b, k), ridx(k), 0, kq=pw.kq)
        rows.append(Row(f"gemm {name}", lambda xa=xa, pw=pw, gx=gx:
                        gk.gemm_dequant(xa, pw, gx), chain(L),
                        f"gemm_dequant:{name}"))
    x, xo = randn(b, d), randn(b, qs)
    wn = torch.ones((d,), dtype=torch.bfloat16, device=device)
    rows.append(Row("quant attn_in/mlp_in (rmsnorm)",
                    lambda: qk.rmsnorm_quantize_x(x, wn, eps, ridx(d), 0),
                    chain(2 * L), "rmsnorm_quantize_x"))
    rows.append(Row("quant o_in", lambda: qk.quantize_x_arc(xo, ridx(qs), 0),
                    chain(L), f"quantize_x_arc:{qs}"))
    gu = randn(b, 2 * f)
    rows.append(Row("quant down_in (silu-gu)",
                    lambda: qk.silu_mul_quantize_gu(gu, ridx(f), 0),
                    chain(L), "silu_mul_quantize_gu"))
    rows.append(Row("fused qkv (rmsnorm, quantize, GEMM)",
                    lambda: mf.gemm_w8_actq_fused(x, pws["qkv"], d, norm_w=wn,
                                                  norm_eps=eps),
                    {"chain": 0, "fused": L}, "gemm_w8_actq_fused:qkv"))
    rows.append(Row("fused o (quantize, GEMM)",
                    lambda: mf.gemm_w8_actq_fused(xo, pws["o"], qs),
                    {"chain": 0, "fused": L}, "gemm_w8_actq_fused:o"))
    rows.append(Row("fused mlp (rmsnorm ... down)",
                    lambda: mf.mlp_w8_fused(x, None, pws["gateup"],
                                            pws["down"], f, norm_w=wn,
                                            norm_eps=eps),
                    {"chain": 0, "fused": L}, "mlp_w8_fused"))
    rows.append(Row("rmsnorm (final)",
                    lambda: llama.rms_norm(x[:, None], wn, eps), both(1),
                    "rms_norm"))

    pos = torch.full((b, 1), seq_len, dtype=torch.long, device=device)
    cos, sin = llama.rope_cos_sin(cfg, pos)
    q4, k4, v4 = split_qkv(randn(b, cfg.q_size + 2 * cfg.kv_size), b, 1,
                           cfg.q_size, cfg.kv_size, cfg.head_dim)
    pps = max_seq // page_size
    cache = paged.init_cache(cfg.replace(num_layers=1), b * pps + 1,
                             page_size, device)
    cache.codes[0].copy_(torch.randint(0, 256, cache.codes[0].shape,
                                       generator=gen, device=device,
                                       dtype=torch.uint8))
    cache.params[0].copy_(torch.rand(cache.params[0].shape, generator=gen,
                                     device=device) * 0.1)
    pt = (1 + torch.arange(b, device=device)[:, None] * pps
          + torch.arange(pps, device=device)[None, :]).to(torch.int32)
    seq_lens = torch.full((b,), seq_len, dtype=torch.int32, device=device)
    rows.append(Row("rope + append_kv (#17)",
                    lambda: rk.rope_append_kv(q4, k4, v4, cos, sin, cache, 0,
                                              pt, pos),
                    both(L), "rope_append_kv"))
    qd = randn(b, cfg.num_heads, cfg.head_dim)
    rows.append(Row("paged_decode",
                    lambda: pdk.paged_decode(qd, cache, 0, pt, seq_lens),
                    both(L), "paged_decode"))

    emb = (torch.randn((cfg.vocab_size, d), generator=gen, device=device)
           * 0.02).to(torch.bfloat16)
    head = pack_lm_head(emb, QuantConfig(w_scale="channel"))
    del emb
    xh = torch.nn.functional.pad(x, (0, head.kq - d))
    rows.append(Row("lm_head W4A16",
                    lambda: gk.gemm_dequant(xh, head, 1.0,
                                            out_dtype=torch.float32),
                    both(1), "gemm_dequant:lm_head"))
    logits = torch.randn((b, cfg.vocab_size), generator=gen, device=device)
    rows.append(Row("argmax sample",
                    lambda: InferenceEngine._sample(logits, None, None),
                    both(1), "sample"))
    return rows


def in_graph(eng, steps: int = 8, seq_len: int = SEQ_LEN) -> dict:
    """The engine's decode graph attributed to the rows' keys: a state
    prefilled with seq_len random tokens a row, its captured decode step
    (every row active) mapped over `steps` replays
    (trace_summary.map_graph). Adds the way the engine runs ("fused" or
    "chain")."""
    from . import trace_summary
    b = eng.ecfg.max_batch
    toks = torch.randint(0, eng.cfg.vocab_size, (b, seq_len),
                         generator=torch.Generator().manual_seed(0))
    _, state = eng.prefill(eng.new_state(), toks,
                           torch.full((b,), seq_len, dtype=torch.int32))
    g = eng._decode_graph(state, None)
    g.io.tokens.fill_(1)
    g.io.active.fill_(True)
    m = trace_summary.map_graph(eng, g, state, steps)
    m["way"] = "fused" if eng.fused_decode else "chain"
    return m


def beside(rows, times, m: dict) -> dict:
    """Print each row's isolated median x calls beside its in-graph ms a
    step (map m, in m["way"]) and its us a call; then the graph's rows no
    plan row attributes, the unlabelled bucket and the step. Returns
    {row name: (isolated ms a step, in-graph ms a step)}."""
    way, out = m["way"], {}
    print(f"{'component (' + way + ')':44s} {'isolated ms':>12s} "
          f"{'in graph ms':>12s} {'calls':>6s} {'us/call':>9s}")
    for r in rows:
        k = r.mults.get(way, 0)
        g = m["rows"].get(r.key, dict(ms_step=0.0, calls=0, ms_call=0.0))
        iso = times[r.name].median * k
        out[r.name] = (iso, g["ms_step"])
        print(f"{r.name:44s} {iso:12.4f} {g['ms_step']:12.4f} "
              f"{g['calls']:6d} {g['ms_call'] * 1e3:9.2f}")
    keys = {r.key for r in rows}
    for key, g in sorted(m["rows"].items()):
        if key not in keys:
            print(f"{'(no row) ' + key:44s} {'':12s} {g['ms_step']:12.4f} "
                  f"{g['calls']:6d} {g['ms_call'] * 1e3:9.2f}")
    print(f"{'unlabelled (glue)':44s} {'':12s} "
          f"{m['unlabelled']['ms_step']:12.4f}")
    print(f"isolated total {sum(v[0] for v in out.values()):.3f} ms; in the "
          f"graph {m['total_ms_step']:.3f} ms of device time a step, busy "
          f"{m['busy_ms_step']:.3f}, span {m['span_ms_step']:.3f} "
          f"(profiled), {m['step_ms']:.3f} ms a step unprofiled")
    return out


def run(cfg, batch: int, timer, rows=None, eng=None, graph=None) -> dict:
    """Time every row of plan(cfg, batch) (or of `rows`, built by it) on
    the card with `timer` (a common.Timer) and print the budget: {"rows":
    rows, "times": {name: Timing}, "totals": {way: (median, lo, hi) ms}}.
    With an engine `eng` (or its in_graph map `graph`), also each row's
    ms a step inside the engine's decode graph beside its isolated time
    x calls (beside()), under "graph"."""
    from .common import budget
    rows = rows or plan(cfg, batch, "cuda")
    times = {r.name: timer(r.fn) for r in rows}
    totals = budget(rows, times, WAYS)
    for w in WAYS:
        med, lo, hi = totals[w]
        print(f"component total, {w}: {med:.3f} ms [sum of lo {lo:.3f} - "
              f"sum of hi {hi:.3f}] (against the measured decode step; the "
              f"difference is glue: embed, residual adds, casts, launch "
              f"gaps)")
    out = {"rows": rows, "times": times, "totals": totals}
    if graph is None and eng is not None:
        graph = in_graph(eng)
    if graph is not None:
        beside(rows, times, graph)
        out["graph"] = graph
    return out


def main(argv=None):
    from ..engine import EngineConfig
    from ..models import quantized
    from .common import Timer, card, require_cuda
    argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.decode_profile"
    ).parse_args(argv)
    require_cuda("decode_profile")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_model_config("qwen2.5-7b")
    print(f"# qwen2.5-7b decode step, bs 4, {cfg.num_layers} layers, device "
          f"time, on {card()}")
    eng = InferenceEngine.dummy(
        cfg, quantized.identity_calib(cfg, 0.0, device="cuda"),
        QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
                    act_scale="row", w_scale="channel", quantize_lm_head=True),
        EngineConfig(max_batch=4, max_seq_len=SEQ_LEN + 64))
    with torch.no_grad():
        run(cfg, 4, Timer(), eng=eng)


if __name__ == "__main__":
    main()
