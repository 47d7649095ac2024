"""Speculative-decode benchmark: the verify round's cost against the
window W (counterpart of ``benchmarks/bench_spec.py``).

Decode is weight-bandwidth bound, so a W-token verify step should cost
little more than a 1-token decode step: the packed weights are read once
either way. This measures both on the dummy engine (no drafter: the
target's cost a round) and reports the implied speedup

    speedup(alpha) = (1 + alpha * (W - 1)) * decode_ms / verify_ms(W)

with 1 + alpha * (W - 1) the expected tokens a round (alpha = the draft
acceptance rate: greedy spec commits a prefix of the drafts + 1).

  python -m arcquant_tpu_torch.benchmarks.bench_spec --model qwen2.5-7b \\
      --batch_size 4 --prefill_seq_len 1024 --windows 2,4,8 [--json]

The JAX script's flags and --json keys; its two-length scan is replaced
by CUDA events around one replay of the captured step
(benchmarks/common.py's Timer: L2 flushed, the stream held while the
host enqueues): the decode step's graph (every row active) and each
window's verify graph over the same prefilled pool. The verify appends
at the same positions every round; the decode step advances seq_lens by
one a replay (the Timer's 2 + repeats calls), a few keys on a
1024-token context. --select_frac (0, the JAX script's, by default)
picks the ARC configuration. --ondevice also times generate_ondevice
against greedy decode_scan end to end (host clock, synchronized) on a
looping workload. Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .common import Timer, card, require_cuda

ALPHAS = (0.5, 0.8, 1.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.bench_spec")
    ap.add_argument("--model", default="qwen2.5-7b")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--prefill_seq_len", type=int, default=1024)
    ap.add_argument("--windows", default="2,4,8")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--weight_fmt", default="w8", choices=["w4", "w8"])
    ap.add_argument("--select_frac", type=float, default=0.0,
                    help="ARC outlier fraction (calibration-free runs)")
    ap.add_argument("--repeats", type=int, default=7,
                    help="timed replays of each step (the Timer's)")
    ap.add_argument("--ondevice", action="store_true",
                    help="also time generate_ondevice (W 4) against "
                    "decode_scan on a looping workload")
    ap.add_argument("--gen_tokens", type=int, default=128,
                    help="tokens a row for the --ondevice run")
    ap.add_argument("--json", action="store_true")
    return ap


def build_engine(args, device="cuda"):
    """The dummy engine args describe (pages for the prefill, the widest
    window and the --ondevice run)."""
    from ..config import QuantConfig, get_model_config
    from ..engine import EngineConfig, InferenceEngine
    from ..models import quantized

    cfg = get_model_config(args.model)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt=args.weight_fmt, act_scale="row",
                       w_scale="channel", quantize_lm_head=True)
    calib = quantized.identity_calib(cfg, select_frac=args.select_frac,
                                     device=device)
    wmax = max(int(w) for w in args.windows.split(","))
    ecfg = EngineConfig(max_batch=args.batch_size, max_seq_len=max(
        args.prefill_seq_len + wmax + 64, args.gen_tokens + 64))
    print(f"building dummy {args.model} ({cfg.num_layers} layers, "
          f"select_frac {args.select_frac}) on {device}...", file=sys.stderr)
    return InferenceEngine.dummy(cfg, calib, qcfg, ecfg, device=device)


def run(args, eng=None, timer=None) -> dict:
    """Time the decode step and each window's verify round on `eng` (built
    from args if None) with `timer` (a Timer of args.repeats runs if
    None: the card's device time). Returns the JAX script's --json
    keys plus the device."""
    if timer is None:
        require_cuda("bench_spec")
        timer = Timer(args.repeats)
    if eng is None:
        eng = build_engine(args)
    b, t = args.batch_size, args.prefill_seq_len
    cfg = eng.cfg
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, t))
    lens = np.full((b,), t, np.int32)
    _, state = eng.prefill(eng.new_state(), toks, lens)

    dec = eng._decode_graph(state, None)
    dec.io.tokens.fill_(1)
    dec.io.active.fill_(True)
    dec_ms = timer(lambda: dec.replay(state)).median
    name, limit = ((card().split(", ") + [None])[:2]
                   if eng.device.type == "cuda" else ("cpu", None))
    on = f"{name}, {limit}"
    print(f"decode 1-token step: {dec_ms:.3f} ms on {on}", file=sys.stderr)
    results = {"model": args.model, "layers": cfg.num_layers, "batch": b,
               "prefill": t, "select_frac": args.select_frac,
               "decode_ms_per_step": round(dec_ms, 4), "windows": {},
               "device": {"name": name, "power_limit": limit}}
    for w in (int(x) for x in args.windows.split(",")):
        ver = eng._verify_graph(state, w)
        ver.io.tokens.fill_(1)
        ver.io.valid.fill_(w)
        v_ms = timer(lambda: ver.replay(state)).median
        sp = {f"alpha={a}": round((1 + a * (w - 1)) * dec_ms / v_ms, 3)
              for a in ALPHAS}
        results["windows"][w] = {"verify_ms": round(v_ms, 4),
                                 "vs_decode": round(v_ms / dec_ms, 3),
                                 "speedup": sp}
        print(f"W={w}: verify {v_ms:.3f} ms ({v_ms / dec_ms:.2f}x the decode "
              f"step), speedup {sp} on {on}", file=sys.stderr)
    eng.drop_graphs()
    del state
    if args.ondevice:
        results["ondevice"] = _ondevice(args, eng, on)
    return results


def _ondevice(args, eng, on) -> dict:
    """generate_ondevice (n-gram drafts, W 4) against prefill + greedy
    decode_scan on looping prompts, best of --repeats wall times each
    after a warm-up (the captures: each side runs on one state, emptied
    in place, so no timed run captures a graph)."""
    from ..engine import NgramDrafter, SpeculativeEngine

    b, n_tok = args.batch_size, args.gen_tokens
    prompts = [[7 + i, 9, 7 + i, 9] * 2 for i in range(b)]
    spec = SpeculativeEngine(eng, NgramDrafter(), window=4)

    def sync():
        if eng.device.type == "cuda":
            torch.cuda.synchronize()

    def t_spec():
        sync()
        t0 = time.perf_counter()
        spec.generate_ondevice(prompts, n_tok)
        sync()
        return time.perf_counter() - t0

    toks, lens, _ = eng._pad_prompts(prompts)
    state = eng.new_state()

    def t_scan():
        sync()
        t0 = time.perf_counter()
        lg, st = eng.prefill(eng.reset_state(state), toks, lens)
        first = lg.argmax(-1).to(torch.int32)
        eng.decode_scan(st, first, torch.as_tensor(lens > 0), n_tok - 1)
        sync()
        return time.perf_counter() - t0

    for f in (t_spec, t_scan):
        f()
    n_cap = len(eng.graph_captures)
    od = min(t_spec() for _ in range(args.repeats))
    sc = min(t_scan() for _ in range(args.repeats))
    out = {"captures_timed": len(eng.graph_captures) - n_cap,
           "spec_tokens_per_s": round(b * n_tok / od, 1),
           "scan_tokens_per_s": round(b * n_tok / sc, 1),
           "speedup": round(sc / od, 3), "rounds": spec.stats["rounds"],
           "accepted": spec.stats["accepted"],
           "proposed": spec.stats["proposed"]}
    print(f"ondevice spec: {out['spec_tokens_per_s']} tok/s against "
          f"decode_scan {out['scan_tokens_per_s']} tok/s "
          f"({out['speedup']}x), {out['rounds']} rounds for {n_tok} a row "
          f"on {on}", file=sys.stderr)
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_cuda("bench_spec")
    torch.backends.cuda.matmul.allow_tf32 = False
    r = run(args)
    print(json.dumps(r) if args.json else json.dumps(r, indent=1))


if __name__ == "__main__":
    main()
