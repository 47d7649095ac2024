"""Text-generation demo of the PyTorch port (counterpart of the
repository's ``generate.py``, same flags and defaults, plus --cpu):
prompts of token ids through the continuous batcher over the W4A4 NVFP4
+ ARC engine (paged int4 KV cache, packed-kernel GEMMs).

  python -m arcquant_tpu_torch.generate --model qwen2.5-7b \\
      --tokens 5,17,301 --tokens 9,8,7,6 --max_new 32
  python -m arcquant_tpu_torch.generate --model test-tiny \\
      --tokens 5,17,301 --max_new 8 --cpu

A registry name runs dummy random weights made from --seed (the engine
of ``InferenceEngine.dummy``); a directory is a HuggingFace checkpoint
(models/hf.py), whose tokenizer (transformers, local files) encodes
--prompt texts, decodes the outputs and gives the eos id. Prints
``[request id] [tokens]`` for each prompt, the text with a tokenizer.
Runs on the card unless --cpu.

  python -m arcquant_tpu_torch.generate --model /path/to/qwen2.5-7b \
      --calib saved/q.npz --prompt "The capital of France is"
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m arcquant_tpu_torch.generate")
    ap.add_argument("--model", required=True,
                    help="HF checkpoint dir, or a registry name (dummy "
                    "weights)")
    ap.add_argument("--prompt", action="append", default=[],
                    help="text prompt (repeatable; needs an HF model dir)")
    ap.add_argument("--tokens", action="append", default=[],
                    help="comma-separated token ids (repeatable)")
    ap.add_argument("--max_new", type=int, default=64)
    ap.add_argument("--calib", default=None)
    ap.add_argument("--select_frac", type=float, default=0.125)
    ap.add_argument("--weight_fmt", default="w8", choices=["w4", "w8"])
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--max_seq_len", type=int, default=2048)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism: not ported")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (testing)")
    return ap


def qcfg_of(args):
    """The demo's quantization: NVFP4 W4A4 + ARC on packed weights,
    per-row activation and per-channel weight scales."""
    from .config import QuantConfig
    return QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt=args.weight_fmt, act_scale="row",
                       w_scale="channel")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from .calib import load_calibration
    from .config import get_model_config
    from .engine import (ContinuousBatcher, EngineConfig, InferenceEngine,
                         Request)
    from .engine.engine import resolve_device
    from .models import quantized

    if args.tp > 1:
        raise NotImplementedError(
            "--tp needs tensor parallelism (parallel/), not ported (ROADMAP "
            "queue 1 item 8)")
    if args.prompt and not os.path.isdir(args.model):
        raise ValueError("--prompt needs an HF model dir (its tokenizer); "
                         "pass --tokens with a registry name")
    device = resolve_device("cpu" if args.cpu else "cuda")
    tokenizer, params = None, None
    if os.path.isdir(args.model):
        from .models import hf
        cfg, params = hf.load_hf_params(args.model, device=device)
        if args.prompt:
            tokenizer = hf.load_tokenizer(args.model)
    else:
        cfg = get_model_config(args.model)
    prompts = [tokenizer.encode(p) for p in args.prompt]
    prompts += [[int(x) for x in t.split(",")] for t in args.tokens]
    if not prompts:
        prompts = [[1, 2, 3]]
    calib = (load_calibration(args.calib, device) if args.calib
             else quantized.identity_calib(cfg, args.select_frac, device))
    ecfg = EngineConfig(max_batch=args.max_batch,
                        max_seq_len=args.max_seq_len)
    if params is None:
        eng = InferenceEngine.dummy(cfg, calib, qcfg_of(args), ecfg,
                                    seed=args.seed, device=device)
    else:
        eng = InferenceEngine(cfg, params, calib, qcfg_of(args), ecfg,
                              device=device)
        del params
    eos = tokenizer.eos_token_id if tokenizer is not None else None
    bat = ContinuousBatcher(eng)
    reqs = [Request(prompt=p, max_new_tokens=args.max_new, eos_id=eos)
            for p in prompts]
    for r in reqs:
        bat.submit(r)
    bat.run()
    for r in reqs:
        out = r.output if tokenizer is None else tokenizer.decode(r.output)
        print(f"[{r.request_id}] {out}")


if __name__ == "__main__":
    main()
