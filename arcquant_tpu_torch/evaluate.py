"""Accuracy evaluation entry point of the PyTorch port (counterpart of
the repository's ``evaluate.py``, same flags and defaults, plus --cpu):
quantize a model (NVFP4, MXFP4, MXFP6 or INT4, with ARC residual
columns), then measure perplexity and the task suites against BF16.

  python -m arcquant_tpu_torch.evaluate --model qwen2.5-7b --eval_ppl \\
      --dataset synthetic
  python -m arcquant_tpu_torch.evaluate --model test-tiny --eval_ppl \\
      --dataset synthetic --seqlen 64 --ntokens 512 --tasks synthetic:16 \\
      --cpu

A registry name runs dummy random weights made from --seed; a directory
is a HuggingFace checkpoint (models/hf.py), its tokenizer read only for a
text dataset or text tasks. Without
--use_kernels the quantized linears are fake-quantized (qdq weights,
plain torch products); with it (NVFP4 only) they are packed and run the
CUDA kernels. Prints ``Result,{dataset},{ppl}``,
``LmEval,{task},{metrics}`` and ``Task,{task},{acc},shots={n}`` lines and
appends them to ./results/log_{model}_{time}.log. Runs on the card unless
--cpu.

--lm_eval runs lm-eval-harness tasks by name through
evals/lm_eval_adapter.py; it needs the `lm_eval` package and an HF model
directory (its tokenizer).
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m arcquant_tpu_torch.evaluate")
    ap.add_argument("--model", required=True,
                    help="HF checkpoint dir, or a registry name (dummy "
                    "weights)")
    ap.add_argument("--calib", default=None,
                    help="calibration .npz from calibrate.py "
                    "(default: identity calibration, select 12.5%%)")
    ap.add_argument("--quant_type", default="NVFP4",
                    choices=["NVFP4", "MXFP4", "MXFP6", "INT4", "BF16"])
    ap.add_argument("--weight_fmt", default="w8", choices=["w4", "w8"])
    ap.add_argument("--act_bits", type=int, default=4, choices=[4, 16],
                    help="16 = W4A16 weight-only quantization "
                    "(activations exact bf16)")
    ap.add_argument("--act_scale", default="tensor",
                    choices=["tensor", "row"])
    ap.add_argument("--use_kernels", action="store_true",
                    help="packed NVFP4 weights and the CUDA kernels")
    ap.add_argument("--kv_cache", action="store_true",
                    help="int4 asym group KV fake quant")
    ap.add_argument("--kv_group_size", type=int, default=64)
    ap.add_argument("--eval_ppl", action="store_true")
    ap.add_argument("--dataset", default="synthetic",
                    choices=["wikitext2", "ptb", "c4", "synthetic"])
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--ntokens", type=int, default=2048 * 16)
    ap.add_argument("--tasks", default="",
                    help="comma-separated loglikelihood tasks "
                    "(see arcquant_tpu_torch/evals/tasks.py)")
    ap.add_argument("--num_fewshot", type=int, default=0,
                    help="n-shot context assembly for --tasks")
    ap.add_argument("--select_frac", type=float, default=0.125,
                    help="ARC fraction when no --calib given")
    ap.add_argument("--lm_eval", default="",
                    help="comma-separated lm-eval-harness tasks (needs the "
                    "lm_eval package and an HF model dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (testing)")
    return ap


def _clock(device) -> float:
    """Host seconds, after the device's queued work."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _lazy_encode(model_dir: str):
    """text -> token ids through the directory's tokenizer, loaded at the
    first call (a synthetic run never needs transformers)."""
    tok = []

    def encode(text):
        if not tok:
            from .models import hf
            tok.append(hf.load_tokenizer(model_dir))
        return tok[0].encode(text)
    return encode


def main(argv=None) -> dict:
    """Run the evaluation; returns {"ppl", "tasks", "lm_eval",
    "quantize_s", "ppl_s", "windows"} (ppl and the seconds None when not
    measured)."""
    args = build_parser().parse_args(argv)

    import torch

    from .calib import load_calibration
    from .config import QuantConfig, get_model_config
    from .engine.engine import resolve_device
    from .evals import eval_ppl, get_token_stream
    from .models import llama, quantized

    if args.lm_eval:
        try:
            import lm_eval
        except ImportError:
            sys.exit("--lm_eval needs the lm_eval package (not in this "
                     "environment); use --tasks for the built-in suite")
        if not os.path.isdir(args.model):
            sys.exit("--lm_eval needs an HF model directory (its "
                     "tokenizer)")
    device = resolve_device("cpu" if args.cpu else "cuda")
    tok_fn = None
    if os.path.isdir(args.model):
        from .models import hf
        cfg = hf.load_hf_config(args.model)
        tok_fn = _lazy_encode(args.model)
        name = os.path.basename(args.model.rstrip("/"))
    else:
        cfg = get_model_config(args.model)
        name = args.model
    if tok_fn is not None:
        cfg, params = hf.load_hf_params(args.model, cfg, device=device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = llama.init_params(cfg, gen, torch.bfloat16, device)
    calib = (load_calibration(args.calib, device) if args.calib
             else quantized.identity_calib(cfg, args.select_frac, device))
    qcfg = QuantConfig(
        quant_type=args.quant_type, use_kernels=args.use_kernels,
        weight_fmt=args.weight_fmt, act_scale=args.act_scale,
        act_bits=args.act_bits, kv_quant=args.kv_cache,
        kv_group_size=args.kv_group_size)

    os.makedirs("./results", exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    logging.basicConfig(filename=f"./results/log_{name}_{stamp}.log",
                        level=logging.INFO, format="%(message)s")
    logging.info("args: %s", vars(args))

    out = dict(ppl=None, tasks={}, lm_eval={}, quantize_s=None, ppl_s=None,
               windows=0)
    if args.quant_type == "BF16":
        qparams, eval_qcfg, eval_calib = params, None, None
    else:
        print("quantizing...", file=sys.stderr)
        t0 = _clock(device)
        qparams = quantized.quantize_model_params(cfg, params, calib, qcfg,
                                                  consume=True)
        out["quantize_s"] = _clock(device) - t0
        print(f"quantized {cfg.num_layers} layers in "
              f"{out['quantize_s']:.2f} s", file=sys.stderr)
        eval_qcfg, eval_calib = qcfg, calib
    del params

    if args.eval_ppl:
        stream = get_token_stream(args.dataset, "test", tok_fn,
                                  vocab_size=cfg.vocab_size,
                                  n_tokens=args.ntokens, seed=args.seed)
        t0 = _clock(device)
        ppl = eval_ppl(cfg, qparams, stream, seqlen=args.seqlen,
                       qcfg=eval_qcfg, calib=eval_calib)
        out.update(ppl=ppl, ppl_s=_clock(device) - t0,
                   windows=len(stream) // args.seqlen)
        print(f"perplexity over {out['windows']} windows of {args.seqlen} "
              f"tokens in {out['ppl_s']:.2f} s", file=sys.stderr)
        print(f"Result,{args.dataset},{ppl}")
        logging.info("Result,%s,%s", args.dataset, ppl)

    if args.lm_eval:
        from .evals.lm_eval_adapter import make_lm
        lm = make_lm(cfg, qparams, eval_calib, eval_qcfg,
                     hf.load_tokenizer(args.model), max_len=args.seqlen)
        res = lm_eval.simple_evaluate(model=lm,
                                      tasks=args.lm_eval.split(","))
        for task, metrics in res["results"].items():
            print(f"LmEval,{task},{metrics}")
            logging.info("LmEval,%s,%s", task, metrics)
        out["lm_eval"] = res["results"]

    if args.tasks:
        from .evals.tasks import evaluate_tasks
        results = evaluate_tasks(
            cfg, qparams, args.tasks.split(","), tok_fn, qcfg=eval_qcfg,
            calib=eval_calib, seed=args.seed, num_fewshot=args.num_fewshot)
        for task, acc in results.items():
            print(f"Task,{task},{acc:.4f},shots={args.num_fewshot}")
            logging.info("Task,%s,%.4f,shots=%d", task, acc,
                         args.num_fewshot)
        out["tasks"] = results
    return out


if __name__ == "__main__":
    main()
