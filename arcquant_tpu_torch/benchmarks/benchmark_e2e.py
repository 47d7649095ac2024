"""End-to-end serving benchmark (counterpart of
``benchmarks/benchmark_e2e.py``): prefill, decode and end-to-end latency
and throughput of the engine on a named model config with dummy weights.

  python -m arcquant_tpu_torch.benchmarks.benchmark_e2e --model qwen2.5-7b \\
      --batch_size 4 --prefill_seq_len 1024 --decode_steps 128
  python -m arcquant_tpu_torch.benchmarks.benchmark_e2e --quant BF16
  python -m arcquant_tpu_torch.benchmarks.benchmark_e2e --model test-tiny \\
      --layers 1 --cpu            # the CPU, for testing only

The JAX script's flags, defaults, QuantConfig and protocol: warm-up
runs, then each repeat builds a fresh pool (``new_state``) outside the
clock, prefills the batch and decodes ``decode_steps`` greedy steps with
each step's token fed back (``decode_scan``: on the card, replays of
the decode step's CUDA graph, which is captured for each pool outside
the clock, as the JAX script's jit compiles in its warm-up). Each phase is timed on
the host clock between ``torch.cuda.synchronize()`` calls: wall time,
the port's counterpart of the JAX script's host fetch (no round trip is
subtracted). Times are mean +- 1.96 sigma over the repeats, as there;
the median decode ms/step, the min-max spreads and the device (name and
power limit) are added. Peak memory is the allocator's peak over the
timed repeats (``utils/mem.py``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .common import card


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.benchmark_e2e")
    ap.add_argument("--model", default="qwen2.5-7b")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--prefill_seq_len", type=int, default=1024)
    ap.add_argument("--decode_steps", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--weight_fmt", default="w8", choices=["w4", "w8"])
    ap.add_argument("--act_bits", type=int, default=4, choices=[4, 16],
                    help="16 = W4A16 (weight-only; skips the "
                    "activation-quantize sites)")
    ap.add_argument("--prefill_act_bits", type=int, default=0,
                    choices=[0, 4, 16],
                    help="hybrid serving mode: activation precision for "
                    "the PREFILL phase only (0 = same as act_bits)")
    ap.add_argument("--quant", default="NVFP4", choices=["NVFP4", "BF16"],
                    help="BF16 runs the unquantized engine (baseline)")
    ap.add_argument("--quant_head", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="quantize the LM head (W4A16; default on; "
                    "--no-quant_head for the bf16 head)")
    ap.add_argument("--select_frac", type=float, default=0.0,
                    help="ARC outlier fraction (calibration-free runs)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override layer count (0 = model default)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (testing)")
    return ap


def _stats(samples_s):
    """(mean, 1.96 sigma) in ms, the JAX script's statistics."""
    xs = np.asarray(samples_s) * 1e3
    return float(xs.mean()), float(1.96 * xs.std())


def run(args) -> dict:
    """Build the engine args describes, run the protocol, return the
    JAX script's --json keys plus decode_ms_per_step_median, spread and
    device."""
    from ..config import QuantConfig, get_model_config
    from ..engine import EngineConfig, InferenceEngine
    from ..models import quantized
    from ..utils import mem

    device = "cpu" if args.cpu else "cuda"
    cfg = get_model_config(args.model)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    qcfg = QuantConfig(quant_type=args.quant, use_kernels=True,
                       weight_fmt=args.weight_fmt, act_scale="row",
                       w_scale="channel", act_bits=args.act_bits,
                       prefill_act_bits=args.prefill_act_bits,
                       quantize_lm_head=args.quant_head)
    calib = quantized.identity_calib(cfg, select_frac=args.select_frac)
    ecfg = EngineConfig(max_batch=args.batch_size,
                        max_seq_len=args.prefill_seq_len + args.decode_steps
                        + 8)
    print(f"building dummy {args.model} ({cfg.num_layers} layers, "
          f"{args.quant}/{args.weight_fmt}) on {device}...", file=sys.stderr)
    eng = InferenceEngine.dummy(cfg, calib, qcfg, ecfg, device=device)

    b, t = args.batch_size, args.prefill_seq_len
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, t))
    lens = np.full((b,), t, np.int32)
    dec_toks = torch.ones((b,), dtype=torch.int32)
    active = torch.ones((b,), dtype=torch.bool)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def decode(state):
        return eng.decode_scan(state, dec_toks, active, args.decode_steps)

    def new_state():
        """A fresh pool, with its decode graph captured (0 steps)."""
        state = eng.new_state()
        eng.decode_scan(state, dec_toks, active, 0)
        return state

    for _ in range(args.warmup):
        _, state = eng.prefill(new_state(), toks, lens)
        decode(state)
    sync()
    mem.reset_peak()
    prefill_ts, decode_ts, e2e_ts = [], [], []
    for _ in range(args.repeats):
        state0 = new_state()           # set-up, unclocked
        sync()
        t0 = time.perf_counter()
        logits, state = eng.prefill(state0, toks, lens)
        sync()
        t1 = time.perf_counter()
        out, state = decode(state)
        sync()
        t2 = time.perf_counter()
        prefill_ts.append(t1 - t0)
        decode_ts.append(t2 - t1)
        e2e_ts.append(t2 - t0)
    del state0, state

    n = args.decode_steps
    pre_m, pre_c = _stats(prefill_ts)
    dec_m, dec_c = _stats(decode_ts)
    e2e_m, e2e_c = _stats(e2e_ts)
    mem_gb = mem.device_mem_gb()
    if device == "cuda":
        name, limit = (card().split(", ") + [None])[:2]
    else:
        name, limit = "cpu", None
    return {
        "model": args.model, "batch": b, "prefill": t,
        "decode_steps": n,
        "prefill_ms": round(pre_m, 2),
        "decode_ms_total": round(dec_m, 2),
        "decode_ms_per_step": round(dec_m / n, 3),
        "decode_tokens_per_s": round(b * n / (dec_m / 1e3), 1),
        "e2e_ms": round(e2e_m, 2),
        "peak_mem_gb": round(mem_gb, 2) if mem_gb else None,
        "decode_ms_per_step_median": round(
            statistics.median(decode_ts) * 1e3 / n, 3),
        "spread": {
            "prefill_ms": [round(min(prefill_ts) * 1e3, 2),
                           round(max(prefill_ts) * 1e3, 2)],
            "decode_ms_per_step": [round(min(decode_ts) * 1e3 / n, 3),
                                   round(max(decode_ts) * 1e3 / n, 3)]},
        "device": {"name": name, "power_limit": limit},
        "quant": args.quant, "weight_fmt": args.weight_fmt,
        "quant_head": "lm_head_packed" in eng.qparams,
        "layers": cfg.num_layers,
        "_ci": (pre_c, dec_c, e2e_c),
        "_tokens_valid": bool(((out >= 0) & (out < cfg.vocab_size)).all()),
        "_logits_finite": bool(torch.isfinite(logits).all()),
    }


def lines(r: dict):
    """The JAX script's output lines of a run() result."""
    pre_c, dec_c, e2e_c = r["_ci"]
    out = [f"Prefill time: {r['prefill_ms']:.2f} ms ± {pre_c:.2f}",
           f"Decode time ({r['decode_steps']} steps): "
           f"{r['decode_ms_total']:.2f} ms ± {dec_c:.2f} "
           f"({r['decode_ms_per_step']:.2f} ms/step, "
           f"{r['decode_tokens_per_s']:.0f} tok/s)",
           f"E2E time: {r['e2e_ms']:.2f} ms ± {e2e_c:.2f}"]
    if r["peak_mem_gb"]:
        out.append(f"Peak memory: {r['peak_mem_gb']:.2f} GB (allocator peak)")
    return out


def public(r: dict) -> dict:
    """run()'s result without its private keys: the --json object."""
    return {k: v for k, v in r.items() if not k.startswith("_")}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("benchmark_e2e runs on the GPU and torch sees no "
                           "CUDA device; pass --cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    r = run(args)
    if args.json:
        print(json.dumps(public(r)))
    else:
        print("\n".join(lines(r)))


if __name__ == "__main__":
    main()
