"""HTTP serving entry point of the PyTorch port (counterpart of the
repository's ``serve.py``, same flags and defaults).

Serve a W4A4-quantized model over HTTP (continuous batching, paged int4
KV, chunked and prefix-shared prefill, W4A16 prefill with W4A4 decode,
per-request sampling, speculative decode with --spec_window), on the
card unless --cpu is given:

  python -m arcquant_tpu_torch.serve --model qwen2.5-7b --port 8000
  python -m arcquant_tpu_torch.serve --model test-tiny --cpu

  curl -s localhost:8000/v1/completions -d \\
      '{"prompt": [1,2,3], "max_tokens": 32, "temperature": 0.7}'

A registry name (e.g. qwen2.5-7b, test-tiny) serves dummy random
weights made from a seed; a directory is a HuggingFace checkpoint
(models/hf.py), served with its tokenizer (text prompts) where
transformers can read it, else with token-id prompts only:

  python -m arcquant_tpu_torch.serve --model /path/to/qwen2.5-7b \
      --calib saved/q.npz --port 8000
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m arcquant_tpu_torch.serve")
    ap.add_argument("--model", required=True,
                    help="HF checkpoint dir, or a registry name (dummy "
                    "weights)")
    ap.add_argument("--calib", default=None,
                    help="calibration .npz (else identity calib)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_seq_len", type=int, default=2048)
    ap.add_argument("--prefill_chunk", type=int, default=512)
    ap.add_argument("--weight_fmt", default="w8", choices=["w4", "w8"])
    ap.add_argument("--prefill_act_bits", type=int, default=16,
                    choices=[0, 4, 16],
                    help="prefill activation precision: 16 = W4A16 "
                    "prefill with W4A4 decode (the default), 0 = the "
                    "decode precision throughout")
    ap.add_argument("--select_frac", type=float, default=0.125)
    ap.add_argument("--dynamic_pages", action="store_true")
    ap.add_argument("--num_pages", type=int, default=0)
    ap.add_argument("--prefix_sharing", action="store_true")
    ap.add_argument("--spec_window", type=int, default=0,
                    help=">=2 enables speculative decode (prompt-lookup "
                    "drafts, W-token verify rounds)")
    ap.add_argument("--decode_burst", type=int, default=0,
                    help=">=2 decodes N tokens per step when the queue "
                    "is empty and all requests are greedy")
    ap.add_argument("--top_k", type=int, default=0,
                    help="top-k for sampled requests")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the dummy weights")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (testing)")
    return ap


def build_loop(args):
    """The engine, batcher and ServingLoop that ``args`` describe."""
    from .calib import load_calibration
    from .config import QuantConfig, get_model_config
    from .engine import ContinuousBatcher, EngineConfig, InferenceEngine
    from .engine.server import ServingLoop
    from .models import quantized

    device = "cpu" if args.cpu else "cuda"
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt=args.weight_fmt, act_scale="row",
                       w_scale="channel",
                       prefill_act_bits=args.prefill_act_bits,
                       quantize_lm_head=True)
    ecfg = EngineConfig(
        max_batch=args.max_batch, max_seq_len=args.max_seq_len,
        num_pages=args.num_pages, dynamic_pages=args.dynamic_pages,
        prefill_chunk=args.prefill_chunk,
        prefix_sharing=args.prefix_sharing)
    params = None
    if os.path.isdir(args.model):
        from .models import hf
        cfg, params = hf.load_hf_params(args.model, device=device)
    else:
        cfg = get_model_config(args.model)
    calib = (load_calibration(args.calib, device) if args.calib
             else quantized.identity_calib(cfg, args.select_frac))
    print(f"serving {'DUMMY weights for ' if params is None else ''}"
          f"{args.model} ({cfg.num_layers} layers) on {device}",
          file=sys.stderr)
    if params is None:
        eng = InferenceEngine.dummy(cfg, calib, qcfg, ecfg, seed=args.seed,
                                    device=device)
    else:
        eng = InferenceEngine(cfg, params, calib, qcfg, ecfg, device=device)
        del params
    batcher = ContinuousBatcher(eng, top_k=args.top_k,
                                spec_window=args.spec_window,
                                decode_burst=args.decode_burst)
    return ServingLoop(batcher)


def build_tokenizer(args):
    """The checkpoint directory's tokenizer, or None: for a registry name,
    or where transformers or the tokenizer files are missing (then the
    server takes token-id prompts only, as the JAX entry point does)."""
    if not os.path.isdir(args.model):
        return None
    from .models import hf
    try:
        return hf.load_tokenizer(args.model)
    except (ImportError, OSError, ValueError) as e:
        print(f"no tokenizer ({e}); token-id prompts only", file=sys.stderr)
        return None


def main(argv=None) -> None:
    from .engine.server import make_server

    args = build_parser().parse_args(argv)
    loop = build_loop(args)
    srv = make_server(loop, args.host, args.port, build_tokenizer(args))
    mode = ("spec W=%d" % args.spec_window if args.spec_window
            else "burst N=%d" % args.decode_burst if args.decode_burst
            else "plain decode")
    print(f"serving {args.model} on http://{args.host}:"
          f"{srv.server_address[1]} (batch {args.max_batch}, seq "
          f"{args.max_seq_len}, {mode})", file=sys.stderr, flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        loop.shutdown()


if __name__ == "__main__":
    main()
