"""Calibration entry point of the PyTorch port (counterpart of the
repository's ``calibrate.py``, same flags and defaults, plus --cpu):
per-site activation statistics, channel reorder indices and ARC
outlier-channel counts, saved as the .npz that ``--calib`` of serve,
evaluate and generate reads (in either package).

  python -m arcquant_tpu_torch.calibrate --model qwen2.5-7b \\
      --dataset synthetic --samples 128 --seqlen 2048 --output ./saved
  python -m arcquant_tpu_torch.calibrate --model test-tiny --samples 4 \\
      --seqlen 64 --cpu

A registry name gets dummy weights from a torch.Generator seeded with
--seed, in llama.init_params' draw order; above 16 x 4096 (layers x
hidden), and for an MoE config, the layers are made one at a time as the
pass reaches them. A directory is a HuggingFace checkpoint
(models/hf.py), its tokenizer read only for a text dataset. Writes {name}_calib_{dataset}_{metric}.npz in
--output and prints ``average bits:`` and ``saved:``. Runs on the card
unless --cpu.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# Dummy models above this many layers x hidden are materialized one layer
# at a time (the JAX script's threshold).
_STREAM_ABOVE = 16 * 4096


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m arcquant_tpu_torch.calibrate")
    ap.add_argument("--model", required=True,
                    help="HF model dir or built-in config name")
    ap.add_argument("--dataset", default="synthetic",
                    choices=["wikitext2", "ptb", "c4", "pile", "humaneval",
                             "synthetic"])
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--act_sort_metric", default="max",
                    choices=["max", "hessian", "score"])
    ap.add_argument("--select_batch", type=int, default=32,
                    help="samples used for the outlier-count search "
                    "(reference reorder_indices.py:83)")
    ap.add_argument("--output", default="./saved")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (testing)")
    return ap


def dummy_params(cfg, seed: int, device, dtype=None):
    """llama.init_params' weights from a generator seeded with `seed` on
    `device`, drawn in its order (embed, then each layer). Above
    _STREAM_ABOVE, and for every MoE config (its expert stacks make a
    layer many times a dense one of its width: 1.1 GB at
    Qwen1.5-MoE-A2.7B), "layers" is a callable that draws layer li when
    the pass reaches it (in order, once each) and there is no lm_head,
    which calibration does not read."""
    import torch

    from .models import llama

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if (cfg.num_layers * cfg.hidden_size <= _STREAM_ABOVE
            and not cfg.num_experts):
        return llama.init_params(cfg, gen, dtype, device)
    embed = (torch.randn((cfg.vocab_size, cfg.hidden_size), generator=gen,
                         dtype=torch.float32, device=device) * 0.02).to(dtype)
    drawn = []

    def layers(li):
        if li != len(drawn):
            raise ValueError(f"streamed layer {li} requested after "
                             f"{len(drawn)} layers: they are drawn in order")
        drawn.append(li)
        return llama.init_layer_params(cfg, gen, dtype, device)

    return {"embed": embed,
            "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype,
                                     device=device),
            "layers": layers}


def main(argv=None) -> dict:
    """Calibrate and save; returns {"calib", "stats", "avg_bits", "path",
    "seconds"} (seconds: the calibration pass, after the weights and
    samples are made)."""
    args = build_parser().parse_args(argv)

    import torch

    from .calib import compute_calibration, save_calibration
    from .config import get_model_config
    from .engine.engine import resolve_device
    from .evals import get_calib_samples

    device = resolve_device("cpu" if args.cpu else "cuda")
    tok_fn = None
    if os.path.isdir(args.model):
        from .models import hf
        cfg, params = hf.load_hf_params(args.model, device=device)
        if args.dataset != "synthetic":
            tok_fn = hf.load_tokenizer(args.model).encode
        name = os.path.basename(args.model.rstrip("/"))
    else:
        cfg = get_model_config(args.model)
        params = dummy_params(cfg, args.seed, device)
        name = args.model

    tokens = get_calib_samples(args.dataset, tok_fn, nsamples=args.samples,
                               seqlen=args.seqlen, vocab_size=cfg.vocab_size,
                               seed=args.seed)
    print(f"calibrating {name}: {args.samples}x{args.seqlen} tokens "
          f"({args.dataset}), metric={args.act_sort_metric}, on {device}",
          file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    calib, stats, avg_bits = compute_calibration(
        cfg, params, tokens, metric=args.act_sort_metric,
        select_batch=args.select_batch, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    print(f"calibrated {cfg.num_layers} layers in {seconds:.2f} s",
          file=sys.stderr)

    os.makedirs(args.output, exist_ok=True)
    out = os.path.join(
        args.output, f"{name}_calib_{args.dataset}_{args.act_sort_metric}.npz")
    save_calibration(out, calib, meta={
        "model": name, "dataset": args.dataset,
        "metric": args.act_sort_metric, "samples": args.samples,
        "seqlen": args.seqlen, "average_bits": avg_bits})
    print(f"average bits: {avg_bits:.3f}")
    print(f"saved: {out}")
    return dict(calib=calib, stats=stats, avg_bits=avg_bits, path=out,
                seconds=seconds)


if __name__ == "__main__":
    main()
