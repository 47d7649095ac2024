"""Continuous-batching serving benchmark (counterpart of
``benchmarks/bench_serving.py``): drives the ContinuousBatcher with a
stream of requests, offline (all submitted up front) or Poisson
arrivals, and prints output tokens/s, TTFT and request-latency
percentiles as one JSON line.

  python -m arcquant_tpu_torch.benchmarks.bench_serving --model qwen2.5-7b \\
      --max_batch 8 --requests 32 --prompt_len 256 --max_new 64 \\
      [--arrival_rate 4] [--spec_window 4] [--dynamic_pages]
  python -m arcquant_tpu_torch.benchmarks.bench_serving --model test-tiny \\
      --layers 1 --requests 4 --prompt_len 16 --max_new 4 --cpu

The JAX script's flags, defaults, QuantConfig (NVFP4, row activation
scales, channel weight scales, select_frac 0, the packed kernels and
the packed W4A16 head, as it sets them on a TPU), warm-up (max_batch + 1
requests of 4 tokens: the prefill and both decode paths), arrivals from
--seed and percentiles. --cpu runs the same engine on the CPU, where
every kernel wrapper runs its plain version. Times are the host clock
(the batcher's request stamps). The JSON adds the device: the card's
name and power limit, as benchmark_e2e prints them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def pct(xs, p):
    """The p-th percentile of xs, the JAX script's nearest-rank rule."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100 * len(xs)))]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.bench_serving")
    ap.add_argument("--model", default="qwen2.5-7b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt_len", type=int, default=256,
                    help="fixed prompt length (one prefill shape)")
    ap.add_argument("--max_new", type=int, default=64)
    ap.add_argument("--arrival_rate", type=float, default=0.0,
                    help="requests/s Poisson arrivals; 0 = offline "
                    "(all submitted up front)")
    ap.add_argument("--spec_window", type=int, default=0)
    ap.add_argument("--decode_burst", type=int, default=0)
    ap.add_argument("--dynamic_pages", action="store_true")
    ap.add_argument("--weight_fmt", default="w8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (testing)")
    return ap


def _drive(eng, args, reqs, arrivals):
    """Submit reqs at their arrival times (s from the start) and step a
    fresh batcher until every request is done: (wall s, batcher)."""
    from ..engine import ContinuousBatcher

    bt = ContinuousBatcher(eng, spec_window=args.spec_window,
                           decode_burst=args.decode_burst)
    t0 = time.perf_counter()
    i = 0
    while i < len(reqs) or bt.queue or any(s is not None for s in bt.slots):
        now = time.perf_counter() - t0
        while i < len(reqs) and arrivals[i] <= now:
            bt.submit(reqs[i])
            i += 1
        if bt.queue or any(s is not None for s in bt.slots):
            bt.step()
        else:
            time.sleep(0.001)
    return time.perf_counter() - t0, bt


def run(args) -> dict:
    """Build the engine args describes, warm it up, serve the requests:
    the JAX script's JSON keys plus device, and under private keys the
    requests (_requests) and the engine (_engine)."""
    from ..config import QuantConfig, get_model_config
    from ..engine import EngineConfig, InferenceEngine, Request
    from ..models import quantized
    from .common import card

    device = "cpu" if args.cpu else "cuda"
    cfg = get_model_config(args.model)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt=args.weight_fmt, act_scale="row",
                       w_scale="channel", quantize_lm_head=True)
    calib = quantized.identity_calib(cfg, select_frac=0.0)
    max_seq = args.prompt_len + args.max_new + max(args.spec_window, 1) + 8
    ecfg = EngineConfig(max_batch=args.max_batch, max_seq_len=max_seq,
                        dynamic_pages=args.dynamic_pages)
    print(f"building dummy {args.model} ({cfg.num_layers} layers) on "
          f"{device}...", file=sys.stderr)
    eng = InferenceEngine.dummy(cfg, calib, qcfg, ecfg, device=device)
    rng = np.random.RandomState(args.seed)

    def prompts(n, new):
        return [Request(prompt=rng.randint(1, cfg.vocab_size,
                                           size=args.prompt_len).tolist(),
                        max_new_tokens=new) for _ in range(n)]

    warm = prompts(args.max_batch + 1, 4)
    _drive(eng, args, warm, [0.0] * len(warm))

    reqs = prompts(args.requests, args.max_new)
    if args.arrival_rate > 0:
        gaps = rng.exponential(1.0 / args.arrival_rate, size=len(reqs))
        arrivals = np.cumsum(gaps).tolist()
    else:
        arrivals = [0.0] * len(reqs)
    wall, bt = _drive(eng, args, reqs, arrivals)

    out_tokens = sum(len(r.output) for r in reqs)
    ttfts = [r.t_first - r.t_submit for r in reqs if r.t_first is not None]
    lats = [r.t_done - r.t_submit for r in reqs if r.t_done is not None]
    if device == "cuda":
        name, limit = (card().split(", ") + [None])[:2]
    else:
        name, limit = "cpu", None
    result = {
        "model": args.model, "layers": cfg.num_layers,
        "max_batch": args.max_batch, "requests": args.requests,
        "prompt_len": args.prompt_len, "max_new": args.max_new,
        "arrival_rate": args.arrival_rate,
        "spec_window": args.spec_window,
        "decode_burst": args.decode_burst,
        "wall_s": round(wall, 2),
        "output_tokens_per_s": round(out_tokens / wall, 1),
        "ttft_p50_s": round(pct(ttfts, 50), 3),
        "ttft_p95_s": round(pct(ttfts, 95), 3),
        "latency_p50_s": round(pct(lats, 50), 3),
        "latency_p95_s": round(pct(lats, 95), 3),
    }
    if args.spec_window:
        result["spec"] = dict(bt.spec_stats)
    result["device"] = {"name": name, "power_limit": limit}
    result["_requests"], result["_engine"] = reqs, eng
    return result


def public(r: dict) -> dict:
    """run()'s result without its private keys: the JSON line."""
    return {k: v for k, v in r.items() if not k.startswith("_")}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.cpu:
        from .common import require_cuda
        require_cuda("bench_serving")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(public(run(args))))


if __name__ == "__main__":
    main()
