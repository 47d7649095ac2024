"""Spec-verify cost anatomy (counterpart of ``benchmarks/verify_lab.py``):
the verify step at each window W beside each of its components at the
matching M = batch x W, and the verify graph's own device time
attributed to the same components.

  python -m arcquant_tpu_torch.benchmarks.verify_lab [--layers 28] \\
      [--windows 2,4,8]

The JAX script's defaults: Qwen2.5-7B, 28 layers, batch 4 after a
1024-token prefill, windows 2, 4 and 8, select-free NVFP4 W4A4 with w8
weights and the packed head. For each W it prints:

- the verify step's time: one replay of its CUDA graph
  (``InferenceEngine._verify_graph``), timed by common.Timer (L2
  flushed), in place of the JAX script's two-length scan;
- the isolated rows of plan(): the engine's ``_attn_common`` (rmsnorm,
  quantize and the qkv GEMM, or its megakernel at M <= 16), ``_o_proj``,
  ``_mlp``, ``rope_kv.rope_append_kv`` (#17, on the column views of one
  qkv output), ``paged_decode.paged_prefill``
  over the prefilled pool, the head over every row and the final norm,
  each timed alone at M = B x W, times its calls a verify step; each
  row's multiplicity is pinned to the calls of one eager verify step
  (common.engine_calls at level "layers");
- the verify graph's replays attributed to the same calls
  (trace_summary.map_graph over `steps` replays) beside the isolated
  rows.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from . import trace_summary
from .common import Row, budget, card, require_cuda
from .decode_profile import beside

WAYS = ("verify",)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.verify_lab")
    ap.add_argument("--model", default="qwen2.5-7b")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--prefill_seq_len", type=int, default=1024)
    ap.add_argument("--windows", default="2,4,8")
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--steps", type=int, default=8,
                    help="profiled replays of each verify graph")
    return ap


def build_engine(args, device="cuda"):
    """The JAX script's engine (select-free; pages for the prefill and
    the widest window)."""
    from ..config import QuantConfig, get_model_config
    from ..engine import EngineConfig, InferenceEngine
    from ..models import quantized

    cfg = get_model_config(args.model)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
                       act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    calib = quantized.identity_calib(cfg, select_frac=0.0, device=device)
    wmax = max(int(w) for w in args.windows.split(","))
    ecfg = EngineConfig(max_batch=args.batch_size,
                        max_seq_len=args.prefill_seq_len + wmax + 8)
    return InferenceEngine.dummy(cfg, calib, qcfg, ecfg, device=device)


def prefilled(eng, seq: int):
    """A new state of eng prefilled with seq random tokens (seed 0) in
    every row."""
    b = eng.ecfg.max_batch
    toks = np.random.RandomState(0).randint(0, eng.cfg.vocab_size, (b, seq))
    _, state = eng.prefill(eng.new_state(), toks, np.full((b,), seq,
                                                          np.int32))
    return state


def plan(eng, w: int, state) -> List[Row]:
    """The verify step's rows at window w on eng's widths: layer 0's
    weights and calibration, inputs from a seeded generator, the
    attention over `state`'s prefilled pool (layer 0), appends at each
    row's next w positions. Multiplicities: each layer's components x
    num_layers, the head and the final norm x 1."""
    from ..engine import engine as E
    from ..kernels import paged_decode as pdk
    from ..kernels import rope_kv as rk
    from ..models import llama

    cfg, qcfg, dev = eng.cfg, eng.qcfg, eng.device
    gen = torch.Generator(device=dev).manual_seed(0)
    b, L, d, fused = eng.ecfg.max_batch, cfg.num_layers, cfg.hidden_size, \
        eng.fused_decode
    p, lc = eng.qparams["layers"][0], eng.calib[0]
    cache, pt, seq_lens = state

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def per_layer(n=L):
        return {"verify": n}

    x2 = randn(b * w, d)
    x3 = x2.reshape(b, w, d)
    q = randn(b, w, cfg.num_heads, cfg.head_dim)
    positions = seq_lens.long()[:, None] + torch.arange(w, device=dev)[None]
    cos, sin = llama.rope_cos_sin(cfg, positions, eng.inv_freq)
    qv, kv_, vv = E.split_qkv(randn(b * w, cfg.q_size + 2 * cfg.kv_size),
                              b, w, cfg.q_size, cfg.kv_size, cfg.head_dim)
    return [
        Row("attn in (rmsnorm, quantize, qkv)", lambda: E._attn_common(
            cfg, p, x2, lc, qcfg, b, w, norm_w=p["attn_norm"], fused=fused),
            per_layer(), "attn_common"),
        Row("o (quantize, GEMM)", lambda: E._o_proj(
            cfg, p, q, lc, qcfg, b, w, fused=fused), per_layer(), "o_proj"),
        Row("mlp (rmsnorm ... down)", lambda: E._mlp(
            cfg, p, x3, lc, qcfg, norm_w=p["mlp_norm"], fused=fused),
            per_layer(), "mlp"),
        Row("rope + append_kv (#17)", lambda: rk.rope_append_kv(
            qv, kv_, vv, cos, sin, cache, 0, pt, positions), per_layer(),
            "rope_append_kv"),
        Row("paged_prefill", lambda: pdk.paged_prefill(
            q, cache, 0, pt, seq_lens, seq_lens + w), per_layer(),
            "paged_prefill"),
        Row("head all_logits", lambda: eng._head_logits(x2), per_layer(1),
            "head"),
        Row("rmsnorm (final)", lambda: llama.rms_norm(
            x3, eng.qparams["final_norm"], cfg.rms_eps), per_layer(1),
            "rms_norm")]


@torch.no_grad()
def run(eng, windows, timer, steps: int = 8, seq: int = 1024) -> dict:
    """For each W of `windows` on eng (a prefill of `seq` tokens a row
    first): the verify graph's replay time (timer), the isolated rows
    and the graph's map. Returns {W: {"verify_ms", "rows", "times",
    "totals", "map"}}."""
    state = prefilled(eng, seq)
    on = card()
    out = {}
    for w in windows:
        g = eng._verify_graph(state, w)
        g.io.tokens.fill_(1)
        g.io.valid.fill_(w)
        ver = timer(lambda: g.replay(state))
        rows = plan(eng, w, state)
        print(f"\n== W={w} (M={eng.ecfg.max_batch * w}): verify step "
              f"{ver} (one graph replay, L2 flushed), on {on} ==")
        times = {r.name: timer(r.fn) for r in rows}
        totals = budget(rows, times, WAYS)
        m = trace_summary.map_graph(eng, g, state, steps, level="layers")
        m["way"] = "verify"
        tot = totals["verify"][0]
        print(f"component total {tot:.3f} ms against the verify step "
              f"{ver.median:.3f} ms (glue {ver.median - tot:+.3f})")
        trace_summary.print_map(m, f"the verify graph at W={w}")
        beside(rows, times, m)
        out[w] = dict(verify_ms=ver.median, rows=rows, times=times,
                      totals=totals, map=m)
    eng.drop_graphs()
    return out


def main(argv=None):
    from .common import Timer
    args = build_parser().parse_args(argv)
    require_cuda("verify_lab")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"building dummy {args.model} ({args.layers} layers)...",
          file=sys.stderr, flush=True)
    eng = build_engine(args)
    run(eng, [int(w) for w in args.windows.split(",")], Timer(),
        args.steps, args.prefill_seq_len)


if __name__ == "__main__":
    main()
