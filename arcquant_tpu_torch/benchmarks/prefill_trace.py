"""Trace ONE engine prefill (Qwen2.5-7B, 14 layers, bs 4 x 1024) and
print its per-op device-time table (counterpart of
``benchmarks/prefill_trace.py``): the full accounting of the e2e prefill
measurement that the component profile (prefill_profile.py) cannot see
(KV appends, rope, layout copies, casts).

  python -m arcquant_tpu_torch.benchmarks.prefill_trace [--quant BF16] \\
      [--layers 14] [--out DIR] [--top 40]

The JAX script's model, route (NVFP4 W4A4, w8, row activation and
channel weight scales, packed head, select-free) and flags. The prefill
runs once outside the trace (the kernels' build, lazy set-up), once
timed with CUDA events unprofiled, then once under torch.profiler with
a range around each call that ``common.engine_calls`` counts. It prints
trace_summary's table of the device activities, then the same run's
activities attributed to those calls (prefill is eager, so each
launch's correlation id names its range: ``trace_summary.eager_map``),
and the device total beside the unprofiled prefill time. ``--out``
keeps the chrome trace there.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import trace_summary
from .common import card, require_cuda


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.prefill_trace")
    ap.add_argument("--quant", default="NVFP4", choices=["NVFP4", "BF16"])
    ap.add_argument("--layers", type=int, default=14)
    ap.add_argument("--out", default=None,
                    help="directory to keep the chrome trace in")
    ap.add_argument("--top", type=int, default=40)
    return ap


def build_engine(args, device="cuda"):
    """The JAX script's engine: qwen2.5-7b cut to args.layers, dummy
    weights, select-free, max_batch 4, max_seq_len 1024 + 136."""
    from ..config import QuantConfig, get_model_config
    from ..engine import EngineConfig, InferenceEngine
    from ..models import quantized

    cfg = get_model_config("qwen2.5-7b").replace(num_layers=args.layers)
    qcfg = QuantConfig(quant_type=args.quant, use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    calib = quantized.identity_calib(cfg, select_frac=0.0, device=device)
    ecfg = EngineConfig(max_batch=4, max_seq_len=1024 + 136)
    return InferenceEngine.dummy(cfg, calib, qcfg, ecfg, device=device)


@torch.no_grad()
def run(eng, batch: int = 4, seq: int = 1024, top: int = 40,
        out=None) -> dict:
    """Trace one prefill of eng at batch x seq random tokens (seed 0) and
    print the table and the attribution. Returns {"prefill_ms" (CUDA
    events, unprofiled), "device_ms" (the traced prefill's summed device
    durations), "busy_ms", "table" (summarize's rows), "map"
    (eager_map's, whose calls equal engine_calls')}."""
    toks = np.random.RandomState(0).randint(0, eng.cfg.vocab_size,
                                            (batch, seq))
    lens = np.full((batch,), seq, np.int32)
    eng.prefill(eng.new_state(), toks, lens)        # outside the trace
    state = eng.new_state()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    eng.prefill(state, toks, lens)
    end.record()
    end.synchronize()
    prefill_ms = start.elapsed_time(end)
    state = eng.new_state()
    torch.cuda.synchronize()
    events, counts = trace_summary.profile_calls(
        eng, lambda: eng.prefill(state, toks, lens), out=out)
    rows, _ = trace_summary.summarize(events)
    m = trace_summary.eager_map(events)
    trace_summary.check_calls(m, counts)
    device_ms = sum(r[1] for r in rows) / 1e3
    print(f"# one prefill, {eng.cfg.name} {eng.cfg.num_layers} layers, "
          f"{batch} x {seq}, {eng.qcfg.quant_type}, on {card()}")
    print(f"{len(rows)} op names, {device_ms:.2f} ms of device time")
    print("\n".join(trace_summary.table(rows, top)))
    trace_summary.print_map(m, "the same prefill by the calls that "
                            "launched it")
    print(f"device total {device_ms:.3f} ms (busy {m['busy_ms_step']:.3f}, "
          f"span {m['span_ms_step']:.3f}, profiled) against the unprofiled "
          f"prefill {prefill_ms:.3f} ms (CUDA events)")
    return dict(prefill_ms=prefill_ms, device_ms=device_ms,
                busy_ms=m["busy_ms_step"], table=rows, map=m)


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_cuda("prefill_trace")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"building dummy qwen2.5-7b ({args.layers} layers)...",
          file=sys.stderr, flush=True)
    run(build_engine(args), top=args.top, out=args.out)


if __name__ == "__main__":
    main()
