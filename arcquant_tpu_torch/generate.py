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

--tp N serves the same requests with tensor parallelism
(parallel/tp_engine.py): N ranks (processes, parallel/mesh.py's launcher)
each build the TPInferenceEngine on its shard and run an identical
ContinuousBatcher; rank 0 prints. --dist_backend nccl puts rank r on
cuda:r (one card a rank), gloo every rank on cuda:0 (or the CPU with
--cpu). --check_ranks records every step on every rank, gathers the
records on every rank (spawned or under torchrun) and fails unless the
ranks' logits are bitwise equal at every step and their tokens equal.
--quant_head serves the lm head as a packed W4A16 GEMM (as serve does);
by default it stays bf16, as in the repository's demo.

  python -m arcquant_tpu_torch.generate --model qwen2.5-7b --tp 2 \
      --dist_backend gloo --tokens 5,17,301 --max_new 32
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
                    help="tensor-parallel ranks, one process and one shard "
                    "each")
    ap.add_argument("--dist_backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="--tp's collectives: nccl (rank r on cuda:r) or "
                    "gloo (every rank on cuda:0, or the CPU with --cpu)")
    ap.add_argument("--check_ranks", action="store_true",
                    help="with --tp: record every step on every rank and "
                    "fail unless their logits are bitwise equal")
    ap.add_argument("--quant_head", action="store_true",
                    help="the lm head as a packed W4A16 GEMM (default: "
                    "bf16)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (testing)")
    return ap


def qcfg_of(args):
    """The demo's quantization: NVFP4 W4A4 + ARC on packed weights,
    per-row activation and per-channel weight scales; the head packed
    with --quant_head."""
    from .config import QuantConfig
    return QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt=args.weight_fmt, act_scale="row",
                       w_scale="channel", quantize_lm_head=args.quant_head)


def _setup(args, device):
    """(cfg, raw params or None, tokenizer or None, prompts, calib)."""
    from .calib import load_calibration
    from .config import get_model_config
    from .models import quantized

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
    return cfg, params, tokenizer, prompts, calib


def _serve(eng, prompts, tokenizer, max_new: int, show: bool) -> list:
    """The prompts through a ContinuousBatcher over eng: their outputs,
    printed when `show`."""
    from .engine import ContinuousBatcher, Request
    eos = tokenizer.eos_token_id if tokenizer is not None else None
    bat = ContinuousBatcher(eng)
    reqs = [Request(prompt=p, max_new_tokens=max_new, eos_id=eos)
            for p in prompts]
    for r in reqs:
        bat.submit(r)
    bat.run()
    for r in reqs:
        out = r.output if tokenizer is None else tokenizer.decode(r.output)
        if show:
            print(f"[{r.request_id}] {out}", flush=True)
    return [r.output for r in reqs]


def _tp_rank(mesh, args) -> dict:
    """One rank of --tp: its TPInferenceEngine and batcher; rank 0
    prints. Returns the outputs, and the rank's kernel launches, peak
    device memory and (--check_ranks) step records."""
    import torch

    from .engine import EngineConfig
    from .kernels import _build
    from .kernels import quantize as qk
    from .parallel import TPInferenceEngine

    cfg, params, tokenizer, prompts, calib = _setup(args, mesh.device)
    ecfg = EngineConfig(max_batch=args.max_batch,
                        max_seq_len=args.max_seq_len)
    if params is None:
        eng = TPInferenceEngine.dummy(cfg, calib, qcfg_of(args), ecfg, mesh,
                                      seed=args.seed)
    else:
        eng = TPInferenceEngine(cfg, params, calib, qcfg_of(args), ecfg,
                                mesh)
        del params
    if args.check_ranks:
        eng.record_steps()
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    for k in _build.KERNELS:
        k.reset()
    outputs = _serve(eng, prompts, tokenizer, args.max_new,
                     show=mesh.rank == 0)
    if args.check_ranks:
        _check_ranks(mesh, eng.steps, outputs)
    return dict(
        outputs=outputs, steps=eng.steps,
        launches={k.name: k.launches for k in _build.KERNELS},
        actq_by_m=dict(qk.ACTQ.by_m),
        peak_bytes=(torch.cuda.max_memory_allocated(mesh.device) if cuda
                    else None))


def _check_ranks(mesh, steps, outputs) -> None:
    """Raise unless every rank's step digests and outputs equal this
    rank's (gathered over the TP group)."""
    import torch.distributed as dist

    mine = ([s["digest"] for s in steps], outputs)
    ranks = [None] * mesh.tp
    dist.all_gather_object(ranks, mine, group=mesh.group)
    for r, theirs in enumerate(ranks):
        if theirs != mine:
            raise RuntimeError(f"rank {r}'s logits or tokens differ from "
                               f"rank {mesh.rank}'s")


def main(argv=None):
    """Print each prompt's output. With --tp > 1 returns the ranks'
    results (_tp_rank's dicts, in rank order)."""
    args = build_parser().parse_args(argv)

    from .engine import EngineConfig, InferenceEngine
    from .engine.engine import resolve_device

    if args.prompt and not os.path.isdir(args.model):
        raise ValueError("--prompt needs an HF model dir (its tokenizer); "
                         "pass --tokens with a registry name")
    if args.tp > 1:
        return _main_tp(args)
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg, params, tokenizer, prompts, calib = _setup(args, device)
    ecfg = EngineConfig(max_batch=args.max_batch,
                        max_seq_len=args.max_seq_len)
    if params is None:
        eng = InferenceEngine.dummy(cfg, calib, qcfg_of(args), ecfg,
                                    seed=args.seed, device=device)
    else:
        eng = InferenceEngine(cfg, params, calib, qcfg_of(args), ecfg,
                              device=device)
        del params
    _serve(eng, prompts, tokenizer, args.max_new, show=True)


def _main_tp(args) -> list:
    from .config import get_model_config
    from .parallel import launch
    from .parallel.tp_engine import check_tp

    if not os.path.isdir(args.model):
        # a config the TP engine refuses raises here, before any rank
        check_tp(get_model_config(args.model), qcfg_of(args), args.tp)
    results = launch(_tp_rank, args.tp, args.dist_backend, cpu=args.cpu,
                     args=(args,))
    if args.check_ranks:         # each rank checked them all (_check_ranks)
        print(f"ranks agree: {len(results[0]['steps'])} steps' logits "
              f"bitwise equal on {args.tp} ranks", flush=True)
    return results


if __name__ == "__main__":
    main()
