"""Drive arcquant_tpu_torch's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA build;
  2. the build of the CUDA kernels (csrc/*.cu, nvcc, sm_90a) and its time;
  3. each kernel against its plain PyTorch version at the Qwen2.5-7B
     shapes of the serving path, with the tolerance, the max error, the
     median CUDA-event time of kernel and plain version (actq at all
     24 of its shapes, M 4, 8, 16 and 4096, also with its bound, its
     plan's block count
     and the launch floor: an empty kernel of that grid, timed alike;
     its rmsnorm mode also bitwise against the emulation of its sum
     order, quantize.actq_kernel_order), and at each
     kernel's representative shape its bound (the larger of its FLOPs
     over 989 TFLOP/s and its bytes over 3.35 TB/s, an H100 SXM's dense
     bf16 and HBM3 peaks) and the time of one PyTorch call computing the
     same function (timed here only, never used by the port); the three
     decode megakernels at M 4, 8 and 16 also against the port's CUDA
     chain of the same function (bitwise); the w4 GEMM bitwise against
     the w8 GEMM on the same weight; flash attention also against f64
     (its mean relative error within 2x the plain f32 version's); paged
     decode at the serving shape and at four rows of 8192 tokens, each
     with its split plan and SDPA beside it; then the large-M route (dequant +
     torch.mm) against the fused GEMMs at every prefill site at M 512,
     1024 and 4096, and its error against f64; then the MoE model's
     kernels (qwen1.5-moe-a2.7b): the batched GEMM over 60 experts' down
     projections in w8 and w4 at M 4, 8 and 256, bitwise against the
     per-expert loop of the single GEMM, the 60-expert stack decoded in
     one launch, and the attention kernels at its G = 1; and the GEMM
     lab's four kernels (csrc/gemm_lab.cu) in every decode mode at the
     gateup and qkv sites at M 4, the exact ones bitwise against gemm_w8,
     and at qkv whether a bitwise A/B can see the k order (gemm_w8's f32
     sums and lab_w8's outputs at 1 split and at production's 7, on
     quantized and on bf16 activations); gemm_w8's and gemm_w4's large-M
     tile (M 4096) at the four prefill sites beside its bound and
     torch.matmul over the decoded bf16 weight (kept in the kernels line
     as each row's large_m), and their small-M tile (csrc/gemm_small_m.cuh)
     at the four decode sites at M 4, 8, 16 and 32 (a speculative
     verify's B * W at W 2, 4 and 8) and at gateup at M 64, alike (each
     row's small_m); the paged prefill at Tq = W 2, 4 and 8, with the
     share of its outputs apart from its plain version's and from the
     paged decode kernel of the same queries (VERIFY_ULP_SHARE). Kernel
     times are device times
     (benchmarks/common.py's Timer holds the stream while the host
     enqueues the call);
  4. the engine at Qwen2.5-7B full width, all 28 layers, dummy weights,
     ARC select_frac 0.125, packed W4A16 head: 4 requests (prompts of
     1024, 777, 301 and 64 tokens) served by ``generate`` for 32 greedy
     tokens each, with each kernel's launch count over that run, then
     prefill ms, decode ms/step (each step counting one paged_decode
     call a layer), decode tok/s and peak device memory
     while building the engine and while serving (every path's launch
     counts also split actq's by M, summed over the twelve paths at the
     end); then [graph]: the engine's decode step captured as a CUDA
     graph against the eager loop (cuda_graphs=False, the same weights):
     every step's logits bitwise fed the same tokens, decode_scan's
     tokens, decode ms/step of decode_scan in turns (loop, graph, graph,
     loop), the capture's time and graph pool, and the device idle share
     over 8 steps of each from torch.profiler;
  5. the HTTP server (engine/server.py over the continuous batcher) on
     the same 28 packed layers with serve.py's defaults (W4A16 prefill,
     W4A4 decode, prefill_chunk 512, dynamic pages, prefix sharing):
     twelve concurrent requests of 32 tokens in two waves, with the
     launch counts, TTFT, output tokens/s, prefill tokens skipped by
     sharing and peak device memory;
  6. the w4 path: the phase-4 engine with weight_fmt w4 (the same seed,
     so the same weights), the same 4 requests through ``generate``,
     with the launch counts, prefill ms, decode ms/step, tok/s, weight
     bytes and peak memory; then, with the large-M route off
     (gemm.XLA_M = 0), the w4 and w8 engines fed the same tokens, whose
     logits must be bitwise equal at every step, and with it on, the
     cosine of their prefill logits and both prefill times in turns;
  7. the select-free path (select_frac 0, the north-star configuration's
     sites): the same 4 requests through ``generate`` on 28 packed layers
     from seed 0, whose decode runs the megakernels (quantize + GEMM at
     attn_in and o_in, the whole MLP), with the launch counts, prefill
     ms, decode ms/step, tok/s and peak memory; then the same weights in
     an engine with fused_decode=False fed the same tokens, whose logits
     must be bitwise equal at every step; then [graph] on it, as in 4;
  8. [bench_e2e]: arcquant_tpu_torch/benchmarks/benchmark_e2e.py's run()
     at Qwen2.5-7B, 28 layers, bs 4, prefill 1024, 32 decode steps, in
     the north-star configuration (NVFP4 select-free w8) and with --quant
     BF16, with the script's lines, its JSON and the launch counts;
  9. [spec]: speculative decoding at Qwen2.5-7B, 28 layers (spec_run):
     benchmarks/bench_spec.py's verify ms at W 2, 4 and 8 against the
     decode step, select-free and ARC; generate_ondevice (W 4, n-gram
     drafts, 64 greedy tokens, ARC) replaying its captured round, bitwise
     against the eager round loop, against plain decode_scan (the first
     divergent step), with its rounds, acceptance, ms per committed token
     and launch counts (the eleventh path), and the verify logits against
     decode's on decode's own tokens against a floor of ulp-flipped
     attention draws; then serve --spec_window 4 with four HTTP
     requests and /health's spec stats;
 10. [eval]: the accuracy path, python -m arcquant_tpu_torch.evaluate's
     main() at Qwen2.5-7B, 28 layers, the synthetic stream at seqlen 2048
     over 2 windows, in a temporary directory (eval_run): BF16, NVFP4
     fake (act_scale tensor, then row) and NVFP4 packed w8 (the twelfth
     path: #1, #2, #6 at gate/up and #9 at T 2048), each with its PPL,
     seconds to quantize, ms a window, peak memory and launch counts; the
     packed PPL against the fake row route's, the two at 1 layer by
     logits cosine, three draws (the fake route with the packed
     epilogue order; the packed route with f32 dense attention, and
     with #9's plain version), and #9 at B 1, T 2048 against its plain
     version;
 11. [generate]: python -m arcquant_tpu_torch.generate at Qwen2.5-7B as a
     subprocess (three --tokens prompts, 8 new tokens), its printed
     tokens against InferenceEngine.generate on the same dummy engine;
     then [calibrate] (calibrate_run: python -m
     arcquant_tpu_torch.calibrate at 128 x 2048 tokens over 28 layers,
     #9 at its B 4 x T 2048 chunk, a 2-layer cut in every metric and
     against #9's plain version), [calib_serve] (calib_serve_run: that
     artifact in the 28-layer engine beside identity 0.125, [graph], the
     cut engines against the plain versions, ARC's MSE on planted
     outliers) and [ckpt] (ckpt_run: a 2-layer HF directory through
     generate and evaluate, a quantized checkpoint saved and loaded);
 12. [lab]: the GEMM lab's script (benchmarks/gemm_lab.py) at the four
     decode sites at M 4: production against bf16 torch.matmul and the
     bound, every built lab variant in w8 and w4 (tiles, depths, k
     splits, the rings) timed and held to production (bitwise where it
     keeps production's k order), the fastest per site, then production,
     the fastest and the default tile re-timed in turns over five rounds;
 13. the MoE model, qwen1.5-moe-a2.7b at full width, all 24 layers, in
     w8 and then w4 (moe_run): generate() on the same 4 requests with the
     launch counts (gemm_batched once a layer a decode step), prefill ms,
     decode ms/step, weight GiB and peak memory, the decode logits with
     the batched GEMM bitwise against the per-expert loop, and (w8)
     dispatch against dense mode; then serve.py's build_loop on it with
     four HTTP requests (moe_serve_run);
 14. [moe_qdq] (moe_qdq_run): Qwen1.5-MoE-A2.7B at full width, moe_block
     on the qdq stacks (use_kernels=False) against the packed experts at
     1 layer (w8, w4; tensor and row scales; dense and dispatch mode;
     packed dispatch against dense) against a floor of 2^-22 noise on the
     stacks' products; then 24 layers in BF16 and in the NVFP4 fake format,
     each built layer by layer, through generate() (no #1, no packed GEMM)
     with prefill ms, decode ms/step, peak memory and [graph];
     [moe_eval] (eval_run on the MoE model): evaluate.main on
     qwen1.5-moe-a2.7b, 24 layers, 2 windows of 2048 (dispatch mode):
     BF16, NVFP4 fake (tensor, row), NVFP4 packed w8 (the experts qdq
     stacks), with [eval]'s gates and draws; [moe_calibrate]
     (calibrate_run on the MoE model: 128 x 2048 tokens, 24 layers
     streamed, only #9; the 2-layer cut's plain run fed the #9 run's
     top-k sets) and [moe_calib_serve] (calib_serve_run on the MoE model:
     its artifact in the packed MoE engine beside identity 0.125,
     [graph], the 1- and 2-layer cuts against the plain versions, ARC's
     MSE on planted outliers); [engine_tensor] (engine_tensor_run): the
     28-layer Qwen2.5-7B w8 ARC engine at act_scale "tensor" (no #1, no
     megakernel), [graph], timed in turns beside row scales, the 1-layer
     cut against the plain versions, and the 1-layer logits of each
     route and scale against BF16's;
 15. [tp] (tp_run): tensor parallelism at Qwen2.5-7B full width, two
     ranks (parallel/mesh.py's launcher) both on this card, the
     collectives over gloo through the host: python -m
     arcquant_tpu_torch.generate --tp 2 --dist_backend gloo --check_ranks
     --quant_head (28 layers, ARC 0.125, the packed W4A16 head, the four
     prompts of 4, 32 greedy tokens) with each rank's prefill ms, decode
     ms/step, all_reduces a decode step and their ms, peak memory and
     launch counts (the path generate_tp; the ranks time-share the card,
     so the times are no TP speed figure), every step's logits bitwise
     equal across the ranks; then at 1 layer the select-free TP engine
     against the single-device engine, the ARC TP engine (weights of two
     seeds) against itself on the plain versions, with every kernel of
     its step held to its plain version call by call at the rank's
     shapes, and exact ARC's sharded quantize at the o and down sites
     bitwise quantize_x_arc; [lm_eval] (lm_eval_run):
     evals/lm_eval_adapter.py's LM at Qwen2.5-7B width cut to 2 layers,
     packed w8, through a stub lm_eval: loglikelihood against tasks.py's
     scorer, loglikelihood_rolling against its windows, generate_until's
     stop, the launch counts, then every kernel call of the three against
     its plain version and the scores against the plain versions' within
     twice the farthest of three draws carrying the kernels' departures;
 16. [pp] (pp_run): pipeline parallelism, two stages on this card over
     gloo: PPInferenceEngine.generate at Qwen2.5-7B, 28 layers (14 and
     their pool a stage), ARC 0.125, the packed head, the four prompts
     of 4, 32 greedy tokens, every step's logits bitwise the
     single-device eager engine's fed the same tokens (step digests) and
     verify_step at W 4 bitwise, each stage's prefill ms, decode ms/step,
     relay bytes and ms a step and peak memory (the path generate_pp,
     the stages' launches summed); then Qwen1.5-MoE-A2.7B cut to 2
     layers, packed experts, bitwise likewise (moe_pp); [dp] (dp_run):
     dp 2 x tp 2, four ranks, Qwen2.5-7B width cut to 2 layers, max_batch
     8, dynamic pages (a pool a dp group), chunked prefill 512: twelve
     requests through ContinuousBatcher, every request finished, both
     groups admitting and one requeue, no slot holding another group's
     page, a decode step's 2 SUM + 2 MAX a layer and one all_gather, and
     every call's logits against the dp 1 TP engine fed the same (cosine
     >= 0.999 or its noise floor, equal greedy tokens) (dp_tp, rank 0's);
     [ep] (ep_run): expert parallelism under TP at Qwen1.5-MoE-A2.7B full
     width, tp 2: generate --tp 2 --check_ranks at 24 layers (ranks
     bitwise at every step, decode ms/step, peak memory; ep_tp), then 1-
     and 2-layer cuts at row and tensor scales against the single-device
     engine on qdq stacks, with the MoE block's collectives; [sp]
     (sp_run): paged decode's state form at Qwen2.5-7B's attention shapes
     over two shards' pools split by token range (each shard's out, m
     and l against the plain version, the merged sp_paged_decode against
     paged_decode over the whole pool; sp_decode), then ring attention at
     T 4096 against plain f32 causal attention. The ranks time-share the
     card: their times are no speed figure of the mode;
 17. the Qwen2.5-7B engine cut to 1 and to 2 layers, its prefill and 4
     decode steps against the same forward with the plain versions
     patched in, the 1-layer w4 and BF16 engines likewise, then at 1
     layer chunked and suffix prefill and a speculative verify, and the
     MoE engine at 1 layer (see
     engine_check, serving_engine_check and moe_engine_check for the
     bars).
Every decode runs the captured step (InferenceEngine's default) except
the eager references: the [graph] loops, [spec]'s round loop and floor
draws, in 17 the plain versions, the verify's spied and isolating runs
and the MoE check's spied forwards, and the sharded engines of 15 and
16, which decode eagerly (gloo's collectives cannot be captured). Kernel launch
counts stay launches on the card: a replay counts the launches its graph
holds.
The second-to-last line is the kernels' JSON summary, the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before the
last line; without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import json
import statistics
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from arcquant_tpu_torch.benchmarks import common
from arcquant_tpu_torch.benchmarks.common import (Timer, bound_ms, nbytes,
                                                 sum_order_bound)

MODEL = "qwen2.5-7b"
SELECT_FRAC = 0.125
PROMPT_LENS = (1024, 777, 301, 64)
NEW_TOKENS = 32
REPS = 7
# The share of the paged prefill kernel's outputs at Tq = W an ulp or
# more apart from its plain version ("plain") and from the paged decode
# kernel of the same queries ("decode"), by W, measured in phase 3: the
# noise floors of the verify checks (phases 9 and 14) flip that share
# of their attention outputs.
VERIFY_ULP_SHARE: dict = {}
# Set in a [tp] rank other than 0, whose log() prints nothing.
_QUIET = False

KERNEL_INFO = {
    "actq": ("arcquant_tpu_torch/csrc/actq.cu",
             "arcquant_tpu/kernels/quantize.py:147"),
    "gemm_w8": ("arcquant_tpu_torch/csrc/gemm_w8.cu",
                "arcquant_tpu/kernels/gemm.py:163"),
    "flash_attn": ("arcquant_tpu_torch/csrc/flash_attn.cu",
                   "arcquant_tpu/kernels/attention.py:35"),
    "paged_decode": ("arcquant_tpu_torch/csrc/paged_decode.cu",
                     "arcquant_tpu/kernels/paged_decode.py:48"),
    "paged_prefill": ("arcquant_tpu_torch/csrc/paged_prefill.cu",
                      "arcquant_tpu/kernels/paged_decode.py:197"),
    "mlp_w8": ("arcquant_tpu_torch/csrc/mlp_fused.cu",
               "arcquant_tpu/kernels/mlp_fused.py:164"),
    "gu_actq": ("arcquant_tpu_torch/csrc/mlp_fused.cu",
                "arcquant_tpu/kernels/mlp_fused.py:211"),
    "gemm_actq": ("arcquant_tpu_torch/csrc/mlp_fused.cu",
                  "arcquant_tpu/kernels/mlp_fused.py:424"),
    "gemm_w4": ("arcquant_tpu_torch/csrc/gemm_w4.cu",
                "arcquant_tpu/kernels/gemm.py:114"),
    "dequant_w8": ("arcquant_tpu_torch/csrc/dequant.cu",
                   "arcquant_tpu/kernels/gemm.py:569"),
    "dequant_w4": ("arcquant_tpu_torch/csrc/dequant.cu",
                   "arcquant_tpu/kernels/gemm.py:577"),
    "pin_rowmajor": ("arcquant_tpu_torch/csrc/dequant.cu",
                     "arcquant_tpu/kernels/gemm.py:650"),
    "gemm_batched": ("arcquant_tpu_torch/csrc/gemm_batched.cu",
                     "arcquant_tpu/kernels/gemm.py:944"),
    "lab_w8": ("arcquant_tpu_torch/csrc/gemm_lab.cu",
               "benchmarks/gemm_lab.py:48"),
    "lab_w8_ring": ("arcquant_tpu_torch/csrc/gemm_lab.cu",
                    "benchmarks/gemm_lab.py:231"),
    "lab_w8_ring_n": ("arcquant_tpu_torch/csrc/gemm_lab.cu",
                      "benchmarks/gemm_lab.py:300"),
    "lab_w4": ("arcquant_tpu_torch/csrc/gemm_lab.cu",
               "benchmarks/gemm_lab.py:429"),
}
LAB_KERNELS = ("lab_w8", "lab_w8_ring", "lab_w8_ring_n", "lab_w4")
# The kernels each main path must launch, and those it must not: with ARC
# every site has a residual, so only gu_actq of the megakernels engages;
# the prefill's qkv and gateup (M >= gemm.XLA_M, N >= Kq) take the
# large-M route, whose w8 pass is dequant_w8; the w4 kernels stay idle on
# the w8 paths, and the w8 ones (megakernels included) on the w4 path.
W4_ONLY = ("gemm_w4", "dequant_w4", "pin_rowmajor")
GENERATE_KERNELS = ("actq", "gemm_w8", "dequant_w8", "flash_attn",
                    "paged_decode", "gu_actq")
SERVE_KERNELS = ("actq", "gemm_w8", "dequant_w8", "paged_prefill",
                 "paged_decode", "gu_actq")
ARC_IDLE_KERNELS = ("gemm_actq", "mlp_w8") + W4_ONLY
FREE_KERNELS = ("actq", "gemm_w8", "dequant_w8", "flash_attn",
                "paged_decode", "gemm_actq", "mlp_w8")
FREE_IDLE_KERNELS = ("gu_actq",) + W4_ONLY
W4_KERNELS = ("actq", "gemm_w4", "dequant_w4", "pin_rowmajor", "flash_attn",
              "paged_decode")
W4_IDLE_KERNELS = ("gemm_w8", "dequant_w8", "gemm_actq", "gu_actq", "mlp_w8")
ROUTE_MS = (512, 1024, 4096)   # the route against the fused GEMMs
# The MoE phase: the dense-model kernels that the MoE layers replace
# (the MLP megakernels) stay idle, and with ARC so does gemm_actq; the
# one-shot 4 x 1024 prefill decodes the expert stacks (dispatch mode) and
# takes the route at qkv and the shared expert's gate/up, every decode
# step runs gemm_batched once a layer (dense mode).
MOE_MODEL = "qwen1.5-moe-a2.7b"
MOE_COMMON = ("actq", "gemm_batched", "flash_attn", "paged_decode")
MOE_KERNELS = {"w8": MOE_COMMON + ("gemm_w8", "dequant_w8"),
               "w4": MOE_COMMON + ("gemm_w4", "dequant_w4", "pin_rowmajor")}
MOE_IDLE_KERNELS = {
    fmt: ("gemm_actq", "gu_actq", "mlp_w8", "paged_prefill") + other
    for fmt, other in (("w8", W4_ONLY), ("w4", ("gemm_w8", "dequant_w8")))}
MOE_SERVE_KERNELS = MOE_COMMON[:2] + ("gemm_w8", "paged_prefill",
                                      "paged_decode")
# The spec path (generate_ondevice on the ARC engine, W 4, batch 4): a
# one-shot prefill, then verify rounds at M 16, whose attention is the
# paged prefill kernel and whose MLP takes gu_actq; no decode step.
SPEC_TOKENS = 64
SPEC_KERNELS = ("actq", "gemm_w8", "dequant_w8", "flash_attn",
                "paged_prefill", "gu_actq")
SPEC_IDLE_KERNELS = ("paged_decode", "gemm_actq", "mlp_w8") + W4_ONLY
# benchmark_e2e: NVFP4 select-free runs FREE_KERNELS; BF16 only the
# attention kernels of the engine's path (its linears are library
# products accumulated like f32)
BF16_KERNELS = ("flash_attn", "paged_decode")

# Serving phase traffic: the first wave, then three requests sharing a
# 1024-token (8-page) prefix with distinct 100-token suffixes, one
# sampled streamed request and a short prompt.
SERVE_WAVE1 = (1900, 1500, 1024, 777, 512, 301, 64)
SHARED_PREFIX, SUFFIX, SAMPLED_LEN, SHORT_LEN = 1024, 100, 200, 16


def log(msg: str) -> None:
    if not _QUIET:
        print(msg, flush=True)


def one_step_bound(a: torch.Tensor, g: torch.Tensor) -> bool:
    """The JAX package's TestRmsnormFused bound: < 3% of elements differ
    and each by at most one e2m1 grid step (<= max(|a|, |g|))."""
    a, g = a.float(), g.float()
    diff = (a - g).abs()
    return (float((a != g).float().mean()) < 0.03 and bool(
        (diff <= torch.maximum(a.abs(), g.abs()) * 1.0001 + 1e-6).all()))


def close_bound(y: torch.Tensor, ref: torch.Tensor) -> bool:
    """Attention outputs: one bf16 ulp plus 2e-3 absolute (f32 softmax
    and PV summed in another order, rounded to bf16)."""
    y, ref = y.double(), ref.double()
    return bool(((y - ref).abs() <= 2.0 ** -7 * ref.abs() + 2e-3).all())


def bf16_randn(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


def gemm_w8_f64(xa, codes, scales, gs, gw, bias, out_dtype):
    """The w8 GEMM in f64 (the accuracy reference)."""
    from arcquant_tpu_torch.quant import numerics as N
    s = N.ue4m3_from_bytes(scales).double() * 0.5
    w = codes.double() * s.repeat_interleave(N.NVFP4_GROUP, dim=0)
    y = (xa.double() @ w) * gs.double() * gw.double()
    return y if bias is None else y + bias.double()


def flash_f64(q, k, v, q_offset):
    """Causal GQA attention in f64 (the accuracy reference of flash
    attention), one batch row at a time."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qi = torch.arange(tq, device=q.device)[:, None] + q_offset
    visible = qi >= torch.arange(tk, device=q.device)[None]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for i in range(b):
        qq, kk, vv = (x[i].double().repeat_interleave(hq // x.shape[2], dim=1)
                      .transpose(0, 1) for x in (q, k, v))
        s = (qq @ kk.transpose(1, 2)) / dh ** 0.5
        s = s.masked_fill(~visible, float("-inf"))
        out[i] = (torch.softmax(s, dim=-1) @ vv).transpose(0, 1)
    return out


def kernel_checks(cfg, timer, failures):
    """Phase 3. Returns {kernel: dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by, library_ms, shape)} where the times and the bound are those
    of the representative shape of the kernel on the serving path."""
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.kernels import quantize as qk
    from arcquant_tpu_torch.quant import packing

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    summary = {}

    def record(kernel, case, err, ok, ms, plain_ms, tol, rep, work=None,
               library=None, library_what=None):
        """work: (flops, bytes) of the call; library: a callable timed as
        the PyTorch yardstick (representative shape only)."""
        log(f"  {kernel:13s} {case:52s} max_abs_err={err:.6g} "
            f"({tol}) {'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms")
        s = summary.setdefault(kernel, dict(max_abs_err=0.0))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if rep:
            b_ms, b_by = bound_ms(*work)
            lib_ms = timer(library) if library is not None else None
            s.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms, shape=case)
            log(f"  {'':13s} bound {b_ms:.4f} ms ({b_by}; {work[0]:.4g} "
                f"FLOP, {work[1]:.4g} B)  library "
                + (f"{lib_ms:.4f} ms ({library_what})" if lib_ms is not None
                   else "none (no PyTorch call computes it)"))
        if not ok:
            failures.append(f"{kernel} {case}: max_abs_err {err}")

    h, f = cfg.hidden_size, cfg.intermediate_size
    # actq: all three modes at K = hidden and K = intermediate, each shape
    # with its time, plain time, bound and plan, beside the launch floor
    # (an empty kernel of the plan's grid, timed alike); rmsnorm also
    # bitwise against the emulation of the kernel's sum order; M 4 decode,
    # M 8 and 16 a speculative verify's B * W (batch 4, W 2 and 4), 4096
    # prefill
    for m in (4, 8, 16, 4096):
        for k in (h, f):
            kq = packing.pad_kq(k, int(round(SELECT_FRAC * k / 64)) * 64)
            for mode in ("plain", "rmsnorm", "silu_mul"):
                a = bf16_randn(gen, (m, 2 * k if mode == "silu_mul" else k),
                               2.0)
                w = (bf16_randn(gen, (k,), 0.1) + 1).to(torch.bfloat16) \
                    if mode == "rmsnorm" else None
                args = dict(mode=mode, k=k, kq=kq, eps=cfg.rms_eps)
                xa, gx = qk._actq_cuda(a, w, **args)
                pa, pg = qk.actq_plain(a, w, **args)
                torch.cuda.synchronize()
                err = float((xa.float() - pa.float()).abs().max())
                case = f"{mode} M={m} K={k} kq={kq}"
                if mode != "rmsnorm":
                    ok, tol = torch.equal(xa, pa) and torch.equal(gx, pg), \
                        "bit-exact"
                else:
                    ea, eg = qk.actq_kernel_order(a, w, **args)
                    same = bitwise([xa, gx], [ea, eg])
                    case += f" bitwise-vs-kernel-order={same}"
                    ok = same and one_step_bound(xa, pa) and bool(
                        torch.allclose(gx, pg, rtol=1e-2))
                    tol = ("<=1 e2m1 step on <3% of elements; bitwise vs "
                           "actq_kernel_order")
                    del ea, eg
                work = (0, nbytes(a, w, xa, gx))
                t_k = timer(lambda: qk._actq_cuda(a, w, **args))
                t_p = timer(lambda: qk.actq_plain(a, w, **args))
                rep = m == 4 and k == h and mode == "plain"
                record("actq", case, err, ok, t_k, t_p, tol, rep=rep,
                       work=work)
                blocks = qk.actq_plan(m, k, mode)
                t_f = timer(lambda: qk.launch_floor(blocks))
                b_ms, b_by = bound_ms(*work)
                stats = summary["actq"]
                stats.setdefault("shapes", {})[
                    f"{mode} M={m} K={k} kq={kq}"] = dict(
                        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                        blocks=blocks, launch_floor_ms=t_f)
                if rep:
                    stats["launch_floor_ms"] = t_f
                log(f"  {'':13s} {blocks} blocks, launch floor {t_f:.4f} "
                    f"ms, bound {b_ms:.3g} ms ({b_by}, {work[1]:.4g} B), "
                    f"{work[1] / t_k / 1e6:.1f} GB/s")
                del a, w, xa, gx, pa, pg

    # w8 and w4 GEMMs at the five weights of the path, the w4 pack of the
    # same weight held bitwise against the w8 GEMM
    sites = [("qkv", cfg.q_size + 2 * cfg.kv_size, h, True),
             ("o", h, cfg.q_size, False),
             ("gateup", 2 * f, h, False),
             ("down", h, f, False),
             ("head", cfg.vocab_size, h, False)]
    for name, n, k, bias in sites:
        sel = 0 if name == "head" else int(round(SELECT_FRAC * k / 64)) * 64
        w = bf16_randn(gen, (n, k), k ** -0.5)
        b = bf16_randn(gen, (n,), 0.1) if bias else None
        ridx = torch.randperm(k, generator=gen, device="cuda")
        pw, pw4 = (packing.pack_weight_arc(w, ridx, sel, bias=b, fmt=fmt,
                                           w_scale="channel")
                   for fmt in ("w8", "w4"))
        del w
        # the qkv site also at A16 (serve.py's prefill: bf16 activations,
        # unit scale), with both versions' error against f64
        # M 8, 16 and 32: a speculative verify's B * W (batch 4, W 2, 4
        # and 8)
        cases = [(m, "A4") for m in ((4, 8, 16) if name == "head"
                                     else (4, 8, 16, 4096))]
        cases += [(4096, "A16")] if name == "qkv" else []
        cases += [(64, "A4")] if name == "gateup" else []
        cases += [(32, "A4")] if name != "head" else []
        for m, act in cases:
            x = bf16_randn(gen, (m, k))
            if name == "head" or act == "A16":
                xa = torch.nn.functional.pad(x, (0, pw.kq - k))
                gs = torch.ones((m, 1), device="cuda")
            else:
                xa, gs = qk.quantize_x_arc(x, ridx, sel)
            dt = torch.float32 if name == "head" else torch.bfloat16
            gw = pw.global_scale.reshape(1, -1)
            args = (xa, pw.codes, pw.scales, gs, gw, pw.bias, dt)
            y = gk._gemm_w8_cuda(*args)
            ref = gk.gemm_w8_plain(*args)
            torch.cuda.synchronize()
            if name == "qkv" and m == 4096:
                f64 = gemm_w8_f64(*args)
                e_k, e_p = (float((z.double() - f64).abs().mean()
                                  / f64.abs().mean())
                            for z in (gk._gemm_w8_cuda(*args[:-1],
                                                       torch.float32),
                                      gk.gemm_w8_plain(*args[:-1],
                                                       torch.float32)))
                acc_ok = e_k <= 2.0 * e_p
                log(f"  {'':13s} qkv M=4096 {act}: f32-out mean relative "
                    f"error vs f64: kernel {e_k:.4g}, plain {e_p:.4g} "
                    f"(bar: kernel <= 2x plain, f32 accumulation) "
                    f"{'ok' if acc_ok else 'FAIL'}")
                if not acc_ok:
                    failures.append(f"gemm_w8 qkv M=4096 {act}: error vs "
                                    f"f64 {e_k} > 2x the plain's {e_p}")
                del f64
            f32 = dt == torch.float32
            rep = name == "gateup" and m == 4
            large = m == 4096 and act == "A4"
            small = m <= gk._SMALL_M and name != "head"
            lib = None
            if rep or large or small:   # the decoded weight, exact, untimed
                wd = gk.dequant_weight(pw)
                lib = lambda: torch.matmul(xa, wd)   # noqa: E731
            t_k = timer(lambda: gk._gemm_w8_cuda(*args))
            t_p = timer(lambda: gk.gemm_w8_plain(*args))
            for fmt, fn, pk in (("w8", gk._gemm_w8_cuda, pw),
                                ("w4", gk._gemm_w4_cuda, pw4)):
                if not (large or small):
                    break
                # the large-M tile (prefill) and the small-M tile (decode):
                # its time, the library call's and the bound, kept beside
                # the kernel's row
                a_ = (xa, pk.codes, pk.scales, gs, gw, pk.bias, dt)
                t_f = t_k if fmt == "w8" else timer(lambda: fn(*a_))
                t_l = timer(lib)
                b_ms, _ = bound_ms(2.0 * m * pw.kq * n,
                                   nbytes(xa, pk.codes, pk.scales, gs, gw,
                                          pk.bias, y))
                tile, key = (("large_m", name) if large
                             else ("small_m", f"{name} M={m}"))
                summary.setdefault(f"gemm_{fmt}", dict(max_abs_err=0.0)) \
                    .setdefault(tile, {})[key] = dict(
                        ms=t_f, library_ms=t_l, bound_ms=b_ms,
                        shape=f"M={m} Kq={pw.kq} N={n}")
                log(f"  gemm_{fmt:9s} {'large' if large else 'small'}-M "
                    f"tile {name} M={m} Kq={pw.kq} "
                    f"N={n}: kernel {t_f:.4f} ms, torch.matmul over the "
                    f"decoded bf16 weight {t_l:.4f} ms, bound {b_ms:.4f} ms "
                    f"({2.0 * m * pw.kq * n / t_f / 1e9:.1f} TFLOP/s)")
            record("gemm_w8", f"{name} M={m} Kq={pw.kq} N={n}"
                   + (" A16" if act == "A16" else ""),
                   float((y.float() - ref.float()).abs().max()),
                   sum_order_bound(y, ref, f32), t_k, t_p,
                   "f32 sum order" + ("" if f32 else " + 1 bf16 ulp"),
                   rep=rep, work=(2.0 * m * pw.kq * n,
                                  nbytes(xa, pw.codes, pw.scales, gs, gw,
                                          pw.bias, y)),
                   library=lib if rep else None,
                   library_what="torch.matmul over the decoded bf16 weight")
            args4 = (xa, pw4.codes, pw4.scales, gs, gw, pw4.bias, dt)
            y4 = gk._gemm_w4_cuda(*args4)
            ref4 = gk.gemm_w4_plain(*args4)
            torch.cuda.synchronize()
            same = bitwise([y4], [y])
            record("gemm_w4", f"{name} M={m} Kq={pw.kq} N={n}"
                   + (" A16" if act == "A16" else "")
                   + f" bitwise-vs-gemm_w8={same}",
                   float((y4.float() - ref4.float()).abs().max()),
                   same and sum_order_bound(y4, ref4, f32),
                   timer(lambda: gk._gemm_w4_cuda(*args4)),
                   timer(lambda: gk.gemm_w4_plain(*args4)),
                   "bitwise vs gemm_w8 on the same weight; f32 sum order"
                   + ("" if f32 else " + 1 bf16 ulp") + " vs plain",
                   rep=rep, work=(2.0 * m * pw.kq * n,
                                  nbytes(xa, pw4.codes, pw4.scales, gs, gw,
                                          pw4.bias, y4)),
                   library=lib if rep else None,
                   library_what="torch.matmul over the decoded bf16 weight")
            if rep or large or small:
                del wd
        del pw, pw4
    attention_checks(cfg, gen, timer, record)
    verify_attention_checks(cfg, gen, timer, record, summary)
    fused_checks(cfg, gen, timer, record, summary)
    route_checks(cfg, gen, timer, record, failures)
    lab_kernel_checks(cfg, gen, timer, record, failures)
    moe_kernel_checks(get_model_config(MOE_MODEL), gen, timer, record,
                      summary)
    return summary


def attention_checks(cfg, gen, timer, record, rep=True):
    """Phase 3, the attention kernels at cfg's heads: flash attention (the
    one-shot prefill, and a ragged suffix case), paged decode over a
    filled pool, paged prefill at the serving shape. rep: these are the
    kernels' representative shapes (Qwen2.5-7B's G = 7); the MoE model's
    G = 1 rows are checked and logged beside them."""
    from arcquant_tpu_torch.cache import paged
    from arcquant_tpu_torch.kernels import attention
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # flash attention: the prefill shape, and a ragged suffix case
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for b, tq, tk, off in ((4, 1024, 1024, 0), (4, 1000, 1024, 24)):
        q = bf16_randn(gen, (b, tq, hq, dh), 2.0)
        k_ = bf16_randn(gen, (b, tk, hkv, dh), 2.0)
        v = bf16_randn(gen, (b, tk, hkv, dh))
        o = attention._flash_cuda(q, k_, v, off)
        ref = attention.flash_attention_plain(q, k_, v, off)
        f64 = flash_f64(q, k_, v, off)
        torch.cuda.synchronize()
        e_k, e_p = (float((z.double() - f64).abs().mean() / f64.abs().mean())
                    for z in (o, ref))
        del f64
        acc_ok = e_k <= 2.0 * e_p
        log(f"  {'':13s} B={b} Tq={tq} H={hq}/{hkv}: mean relative error vs "
            f"f64: kernel {e_k:.4g}, plain {e_p:.4g} (bar: kernel <= 2x "
            f"plain) {'ok' if acc_ok else 'FAIL'}")
        rep_ = rep and off == 0
        lib = None
        if rep_:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k_, v))
            lib = lambda: sdpa(qt, kt, vt, is_causal=True,   # noqa: E731
                               enable_gqa=True)
        record("flash_attn", f"B={b} Tq={tq} Tk={tk} q_offset={off} "
               f"H={hq}/{hkv}",
               float((o.float() - ref.float()).abs().max()),
               close_bound(o, ref) and acc_ok,
               timer(lambda: attention._flash_cuda(q, k_, v, off)),
               timer(lambda: attention.flash_attention_plain(q, k_, v, off)),
               "1 bf16 ulp + 2e-3; vs f64 <= 2x plain", rep=rep_,
               work=(4.0 * b * hq * dh * tq * (tq + 1) / 2,
                     nbytes(q, k_, v, o)),
               library=lib,
               library_what="SDPA is_causal over [B, H, T, Dh] copies")
    # paged int4 decode over a filled pool: the smoke shape, then four
    # rows of 8192 tokens; each with its split plan and SDPA beside it
    page, bsz = 128, 4
    one = cfg.replace(num_layers=1)
    for lens in ((1056, 809, 333, 0), (8192,) * bsz):
        long = lens[0] == 8192
        pps = -(-(max(lens) + 8) // page)
        splits, per = pdk.decode_split_plan(bsz, hkv, pps)
        cache = paged.init_cache(one, 1 + bsz * pps, page, "cuda")
        pt = (1 + torch.arange(bsz)[:, None] * pps
              + torch.arange(pps)[None]).to(torch.int32).cuda()
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        t = pps * page
        pos = torch.arange(t, device="cuda")[None].expand(bsz, t)
        pos = torch.where(pos < sl[:, None], pos, -1)
        paged.append_kv(cache, 0, bf16_randn(gen, (bsz, t, hkv, dh), 2.0),
                        bf16_randn(gen, (bsz, t, hkv, dh)), pt, pos)
        q = bf16_randn(gen, (bsz, hq, dh), 2.0)
        args = (q, cache.codes[0], cache.params[0], pt, sl)
        o, m_, l_ = pdk._paged_decode_cuda(*args)
        po, pm, pl = pdk.paged_decode_state_plain(*args)
        torch.cuda.synchronize()
        ok = (close_bound(o, po) and bool(torch.allclose(m_, pm, rtol=1e-5,
                                                         atol=1e-5))
              and bool(torch.allclose(l_, pl, rtol=1e-4))
              and bool((o[sl == 0] == 0).all()))
        log(f"  {'':13s} outputs differing from plain (one bf16 ulp): "
            f"{float((o != po)[sl > 0].float().mean()):.4%}")
        kd, vd = (x.to(torch.bfloat16).transpose(1, 2).contiguous()
                  for x in paged.gather_kv(cache, 0, pt, t))
        qd = q[:, :, None]
        kpos = torch.arange(t, device="cuda")
        mask = (kpos[None] < sl[:, None])[:, None, None]
        ntok = int(sum(lens))
        lib = lambda: sdpa(qd, kd, vd, attn_mask=mask,   # noqa: E731
                           enable_gqa=True)
        record("paged_decode",
               f"B=4 seq={','.join(map(str, lens))} page=128 H={hq}/{hkv} "
               f"splits={splits}x{per} pages",
               float((o.float() - po.float()).abs().max()), ok,
               timer(lambda: pdk._paged_decode_cuda(*args)),
               timer(lambda: pdk.paged_decode_state_plain(*args)),
               "1 bf16 ulp + 2e-3; m, l f32 sum order", rep=rep and not long,
               work=(4.0 * ntok * hq * dh,
                     ntok * hkv * (dh + 16) + nbytes(q, o, m_, l_)),
               library=lib,
               library_what="SDPA over the pool dequantized to bf16, "
                            "call only")
        if long:
            log(f"  {'':13s} SDPA over the dequantized pool "
                f"{timer(lib):.4f} ms")
        del cache, kd, vd, po, pm, pl
    paged_prefill_check(cfg, gen, timer, record, rep)


def verify_attention_checks(cfg, gen, timer, record, summary):
    """Phase 3, the attention of a speculative verify: paged_prefill at Tq
    = W 2, 4 and 8 over the decode shape's pool (batch 4, contexts of
    1056, 809, 333 and 64 tokens, pages of 128) against its plain
    version, beside paged_decode at Tq 1 over the same contexts; each
    with its bound and SDPA over the pool dequantized to bf16. Kept in
    the kernels line as paged_prefill's "verify"."""
    from arcquant_tpu_torch.cache import paged
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ctx, page, bsz = (1056, 809, 333, 64), 128, 4
    pps = -(-(max(ctx) + 8) // page)
    cache = paged.init_cache(cfg.replace(num_layers=1), 1 + bsz * pps, page,
                             "cuda")
    pt = (1 + torch.arange(bsz)[:, None] * pps
          + torch.arange(pps)[None]).to(torch.int32).cuda()
    t = pps * page
    pos = torch.arange(t, device="cuda")[None].expand(bsz, t)
    full = torch.tensor(ctx, dtype=torch.int32, device="cuda") + 8
    paged.append_kv(cache, 0, bf16_randn(gen, (bsz, t, hkv, dh), 2.0),
                    bf16_randn(gen, (bsz, t, hkv, dh)), pt,
                    torch.where(pos < full[:, None], pos, -1))
    kd, vd = (x.to(torch.bfloat16).transpose(1, 2).contiguous()
              for x in paged.gather_kv(cache, 0, pt, t))
    kpos = torch.arange(t, device="cuda")
    st = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    rows = summary.setdefault("paged_prefill", dict(max_abs_err=0.0))
    out = rows.setdefault("verify", {})
    for w in (1, 2, 4, 8):
        sl = st + w
        q = bf16_randn(gen, (bsz, w, hq, dh), 2.0)
        keys = float(sum(c + w for c in ctx))
        pairs = float(sum(sum(c + 1 + i for i in range(w)) for c in ctx))
        work = (4.0 * pairs * hq * dh, keys * hkv * (dh + 16) + nbytes(q) * 2)
        b_ms, b_by = bound_ms(*work)
        qpos = st[:, None] + torch.arange(w, device="cuda")[None]
        mask = ((kpos[None, None] <= qpos[:, :, None])
                & (kpos[None, None] < sl[:, None, None]))[:, None]
        qd = q.transpose(1, 2).contiguous()
        lib_ms = timer(lambda: sdpa(qd, kd, vd, attn_mask=mask,
                                    enable_gqa=True))
        if w == 1:      # paged decode: the query at each row's end
            args = (q[:, 0], cache.codes[0], cache.params[0], pt, sl)
            ms = timer(lambda: pdk._paged_decode_cuda(*args))
            out["decode Tq=1"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                                      library_ms=lib_ms)
            log(f"  {'':13s} paged_decode B=4 ctx=1057,810,334,65 (the "
                f"verify's decode step): kernel {ms:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by}), SDPA over the dequantized pool "
                f"{lib_ms:.4f} ms")
            continue
        args = (q, cache.codes[0], cache.params[0], pt, st, sl)
        o = pdk._paged_prefill_cuda(*args)
        po = pdk.paged_prefill_plain(*args)
        # decode's attention of the same queries: query j alone over the
        # first ctx + j + 1 keys
        dec = torch.stack([pdk._paged_decode_cuda(
            q[:, j].contiguous(), cache.codes[0], cache.params[0], pt,
            st + j + 1)[0] for j in range(w)], dim=1)
        torch.cuda.synchronize()
        differ = dict(plain=float((o != po).float().mean()),
                      decode=float((o != dec).float().mean()))
        VERIFY_ULP_SHARE[w] = differ
        log(f"  {'':13s} outputs differing from plain: "
            f"{differ['plain']:.4%}; from the paged decode kernel of the "
            f"same queries: {differ['decode']:.4%} (max abs "
            f"{float((o.float() - dec.float()).abs().max()):.4g})")
        ms = timer(lambda: pdk._paged_prefill_cuda(*args))
        record("paged_prefill", f"verify B=4 Tq={w} q_starts="
               f"{','.join(map(str, ctx))} page=128 H={hq}/{hkv}",
               float((o.float() - po.float()).abs().max()),
               close_bound(o, po) and bool(torch.isfinite(o).all()), ms,
               timer(lambda: pdk.paged_prefill_plain(*args)),
               "1 bf16 ulp + 2e-3", rep=False)
        out[f"Tq={w}"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms, differing=differ)
        log(f"  {'':13s} bound {b_ms:.5f} ms ({b_by}), SDPA over the "
            f"dequantized pool {lib_ms:.4f} ms")
    del cache, kd, vd


def route_checks(cfg, gen, timer, record, failures):
    """Phase 3, the large-M route's kernels and the route itself, at the
    four prefill sites (ARC select_frac 0.125 packing; one weight packed
    in w8 and in w4):
      dequant_w8, dequant_w4  each site's weight, bitwise vs plain (and
                              with the global scale folded, at qkv);
      pin_rowmajor            M 4 and 4096 at each site's Kq, bitwise vs
                              plain; its library time is the strided
                              copy x.view(m, kq/2, 2).transpose(1, 2);
      the route               gemm._gemm_route against the fused GEMM of
                              the format at M 512, 1024 and 4096: both
                              times, torch.mm's alone, the route within
                              the f32 sum order of the plain fused GEMM;
                              at qkv M 4096 with A16 operands, its mean
                              error vs f64 within 2x the plain version's.
    The w8 route takes xa as it is (already row-major): the identity
    copy the TPU route makes there is timed and logged, not run."""
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.kernels import quantize as qk
    from arcquant_tpu_torch.quant import packing

    h, f = cfg.hidden_size, cfg.intermediate_size
    sites = [("qkv", cfg.q_size + 2 * cfg.kv_size, h, True),
             ("o", h, cfg.q_size, False),
             ("gateup", 2 * f, h, False),
             ("down", h, f, False)]
    bf = torch.bfloat16
    for name, n, k, bias in sites:
        sel = int(round(SELECT_FRAC * k / 64)) * 64
        w = bf16_randn(gen, (n, k), k ** -0.5)
        b = bf16_randn(gen, (n,), 0.1) if bias else None
        ridx = torch.randperm(k, generator=gen, device="cuda")
        pws = {fmt: packing.pack_weight_arc(w, ridx, sel, bias=b, fmt=fmt,
                                            w_scale="channel")
               for fmt in ("w8", "w4")}
        del w
        kq = pws["w8"].kq
        folds = (None, pws["w8"].global_scale.reshape(-1)) if name == "qkv" \
            else (None,)
        for fmt, pw in pws.items():
            kern = gk._dequant_w8_cuda if fmt == "w8" else gk._dequant_w4_cuda
            plain = gk.dequant_w8_plain if fmt == "w8" \
                else gk.dequant_w4_plain
            for gwf in folds:
                out = kern(pw.codes, pw.scales, gwf)
                ref = plain(pw.codes, pw.scales, gwf)
                torch.cuda.synchronize()
                same = bitwise([out], [ref])
                record(f"dequant_{fmt}", f"{name} Kq={kq} N={n}"
                       + (" fold_global" if gwf is not None else ""),
                       float((out.float() - ref.float()).abs().max()), same,
                       timer(lambda: kern(pw.codes, pw.scales, gwf)),
                       timer(lambda: plain(pw.codes, pw.scales, gwf)),
                       "bitwise", rep=name == "gateup" and gwf is None,
                       work=(0, nbytes(pw.codes, pw.scales, gwf, out)))
                del out, ref
        for m in (4, 4096):
            x = bf16_randn(gen, (m, kq))
            out = gk._pin_rowmajor_cuda(x)
            ref = gk.pin_rowmajor_plain(x)
            torch.cuda.synchronize()
            rep = name == "gateup" and m == 4096
            record("pin_rowmajor", f"{name} M={m} Kq={kq}",
                   float((out.float() - ref.float()).abs().max()),
                   bitwise([out], [ref]),
                   timer(lambda: gk._pin_rowmajor_cuda(x)),
                   timer(lambda: gk.pin_rowmajor_plain(x)), "bitwise",
                   rep=rep, work=(0, nbytes(x, out)),
                   library=(lambda: x.view(m, kq // 2, 2).transpose(1, 2)
                            .contiguous()),
                   library_what="x.view(m, kq//2, 2).transpose(1, 2)"
                   ".contiguous()")
            if rep:
                log(f"  {'':13s} the w8 route's skipped pin: an identity "
                    f"copy of xa [{m}, {kq}] (x.clone()) "
                    f"{timer(lambda: x.clone()):.4f} ms")
        for m in ROUTE_MS:
            xa, gx = qk.quantize_x_arc(bf16_randn(gen, (m, k)), ridx, sel)
            gs = gx.reshape(-1, 1)
            for fmt, pw in pws.items():
                gw = pw.global_scale.reshape(1, -1)
                args = (xa, pw.codes, pw.scales, gs, gw, pw.bias, bf)
                fused = gk._gemm_w8_cuda if fmt == "w8" else gk._gemm_w4_cuda
                plain = gk.gemm_w8_plain if fmt == "w8" \
                    else gk.gemm_w4_plain
                y = gk._gemm_route(xa, pw, gs, gw, bf)
                ref = plain(*args)
                torch.cuda.synchronize()
                ok = sum_order_bound(y, ref, False)
                t_route = timer(lambda: gk._gemm_route(xa, pw, gs, gw, bf))
                t_fused = timer(lambda: fused(*args))
                wd = gk.dequant_weight(pw)
                xo = gk.pin_rowmajor_plain(xa) if fmt == "w4" else xa
                t_mm = timer(lambda: gk._mm_f32_cuda(xo, wd))
                t_one = timer(lambda: torch.mm(xo, wd,
                                               out_dtype=torch.float32))
                del wd, xo
                log(f"  route {fmt} {name:6s} M={m:<5d} Kq={kq} N={n}: "
                    f"route {t_route:.4f} ms (its f32 product in "
                    f"{gk.MM_CHUNK_K}-deep slices {t_mm:.4f}; one torch.mm "
                    f"{t_one:.4f}) vs gemm_{fmt} {t_fused:.4f} ms; "
                    f"max_abs_err vs plain "
                    f"{float((y.float() - ref.float()).abs().max()):.6g} "
                    f"(f32 sum order + 1 bf16 ulp) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"route {fmt} {name} M={m} vs plain")
                del y, ref
        if name == "qkv":   # A16 operands: the route's f32 accumulation
            m = 4096
            xa = torch.nn.functional.pad(bf16_randn(gen, (m, k)),
                                         (0, kq - k))
            gs = torch.ones((m, 1), device="cuda")
            for fmt, pw in pws.items():
                gw = pw.global_scale.reshape(1, -1)
                wd = packing.dequantize_weight(pw, torch.float64)
                f64 = (xa.double() @ wd) * gw.double() + pw.bias.double()
                del wd
                plain = gk.gemm_w8_plain if fmt == "w8" \
                    else gk.gemm_w4_plain
                e_r, e_p = (float((z.double() - f64).abs().mean()
                                  / f64.abs().mean()) for z in (
                    gk._gemm_route(xa, pw, gs, gw, torch.float32),
                    plain(xa, pw.codes, pw.scales, gs, gw, pw.bias,
                          torch.float32)))
                ok = e_r <= 2.0 * e_p
                # the product's slice depth against the error (logged)
                wb, alt = gk.dequant_weight(pw), {}
                xo = gk.pin_rowmajor_plain(xa) if fmt == "w4" else xa
                saved = gk.MM_CHUNK_K
                for depth in (1024, kq):
                    gk.MM_CHUNK_K = depth
                    z = gk._epilogue(gk._mm_f32_cuda(xo, wb), gs, gw,
                                     pw.bias, torch.float32)
                    alt[depth] = float((z.double() - f64).abs().mean()
                                       / f64.abs().mean())
                gk.MM_CHUNK_K = saved
                del wb, xo, z
                log(f"  route {fmt} qkv M=4096 A16: f32-out mean relative "
                    f"error vs f64: route {e_r:.4g}, plain {e_p:.4g} (bar: "
                    f"route <= 2x plain) {'ok' if ok else 'FAIL'}; with "
                    f"1024-deep slices {alt[1024]:.4g}, one torch.mm "
                    f"{alt[kq]:.4g}")
                if not ok:
                    failures.append(f"route {fmt} qkv A16: error vs f64 "
                                    f"{e_r} > 2x the plain's {e_p}")
                del f64
        del pws
        torch.cuda.empty_cache()


def lab_kernel_checks(cfg, gen, timer, record, failures):
    """Phase 3, the GEMM lab's kernels (#16) with their default tile (128
    columns, 128-deep stages, 3 stages) at Qwen2.5-7B's gateup (M 4, Kq
    3584 select-free: production plans one split) and qkv (M 4: 7 splits),
    one weight packed in w8 and w4:
      lab_w8         base, mul3d, bf16, noscale;
      lab_w8_ring    a block an SM, production's plan;
      lab_w8_ring_n  one split over the whole K;
      lab_w4         f32, i16, nodec;
    each against its plain version within the f32 sum order plus one bf16
    ulp; the exact modes (and the ring) bitwise equal to gemm_w8, which
    gemm_w4 equals too, ring_n only where production has one split (bars:
    fail if not); bf16 and i16 also their error against f64 beside
    production's; the probes (noscale, nodec) checked for shape and
    finiteness only. Kernel ms, plain ms, bound and torch.matmul over the
    decoded bf16 weight at gateup (the representative rows: base, f32)."""
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.kernels import gemm_lab as gl
    from arcquant_tpu_torch.kernels import quantize as qk
    from arcquant_tpu_torch.quant import packing

    h, f, m, bf = cfg.hidden_size, cfg.intermediate_size, 4, torch.bfloat16
    for name, n in (("gateup", 2 * f), ("qkv", cfg.q_size + 2 * cfg.kv_size)):
        w = bf16_randn(gen, (n, h), h ** -0.5)
        ridx = torch.arange(h, device="cuda")
        p8, p4 = (packing.pack_weight_arc(w, ridx, 0, fmt=fmt,
                                          w_scale="channel")
                  for fmt in ("w8", "w4"))
        del w
        xa, gx = qk.quantize_x_arc(bf16_randn(gen, (m, h), 2.0), ridx, 0)
        gs, gw = gx.reshape(-1), p8.global_scale.reshape(-1).float()
        prod = gk._gemm_w8_cuda(xa, p8.codes, p8.scales, gx, gw[None], None,
                                bf)
        prod4 = gk._gemm_w4_cuda(xa, p4.codes, p4.scales, gx, gw[None], None,
                                 bf)
        f64 = gemm_w8_f64(xa, p8.codes, p8.scales, gx, gw[None], None, None)
        _, splits, _ = gk._split_plan(m, n, p8.kq)
        rep = name == "gateup"
        wd = gk.dequant_weight(p8) if rep else None   # natural k order
        a8 = (xa, p8.codes, p8.scales, gs, gw)
        a4 = (xa, p4.codes, p4.scales, gs, gw)
        rows = [("lab_w8", mode, lambda mode=mode: gl.lab_w8(*a8, mode=mode),
                 lambda mode=mode: gl.lab_w8_plain(*a8, mode), p8)
                for mode in gl.W8_MODES]
        rows += [("lab_w8_ring", "base", lambda: gl.lab_w8_ring(*a8),
                  lambda: gl.lab_w8_plain(*a8), p8),
                 ("lab_w8_ring_n", "base", lambda: gl.lab_w8_ring_n(*a8),
                  lambda: gl.lab_w8_plain(*a8), p8)]
        rows += [("lab_w4", mode, lambda mode=mode: gl.lab_w4(*a4, mode=mode),
                  lambda mode=mode: gl.lab_w4_plain(*a4, mode), p4)
                 for mode in gl.W4_MODES]
        torch.cuda.synchronize()
        if not bitwise([prod4], [prod]):
            failures.append(f"lab {name}: gemm_w4 differs from gemm_w8")
        for kernel, mode, run, plain, pk in rows:
            y, ref = run(), plain()
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            same = bitwise([y], [prod])
            must = mode in gl.EXACT_MODES and not (
                kernel == "lab_w8_ring_n" and splits > 1)
            if mode in ("noscale", "nodec"):
                ok = y.shape == prod.shape and bool(torch.isfinite(y).all())
                tol = "probe: shape and finite only"
            else:
                ok = sum_order_bound(y, ref, False) and (same or not must)
                tol = ("bitwise vs gemm_w8; " if must else "") + \
                    "f32 sum order + 1 bf16 ulp vs plain"
            if mode in ("bf16", "i16"):
                e_y, e_p = (float((z.double() - f64).abs().mean()
                                  / f64.abs().mean()) for z in (y, prod))
                log(f"  {'':13s} {name} {mode}: mean relative error vs f64 "
                    f"{e_y:.6g} (gemm_w8 {e_p:.6g})")
            is_rep = rep and mode in ("base", "f32")
            record(kernel, f"{name} {mode} M={m} Kq={pk.kq} N={n} "
                   f"splits={1 if kernel == 'lab_w8_ring_n' else splits} "
                   f"bitwise-vs-gemm_w8={same}", err, ok, timer(run),
                   timer(plain), tol, rep=is_rep,
                   work=(2.0 * m * pk.kq * n,
                         nbytes(xa, pk.codes, pk.scales, gs, gw, y)),
                   library=(lambda: torch.matmul(xa, wd)) if is_rep else None,
                   library_what="torch.matmul over the decoded bf16 weight")
            del y, ref
        if splits > 1:
            split_order_check(gen, xa, p8, splits, failures)
        del p8, p4, wd, f64
        torch.cuda.empty_cache()


def split_order_check(gen, xa, pw, splits, failures):
    """Can a bitwise A/B see the k order? gemm_w8's f32 sums (gs = gw = 1,
    f32 out) at production's `splits` against one split (the plan patched
    over), and lab_w8's bf16 outputs at 1 and at `splits`, on the
    quantized xa (e2m1 values) and on bf16 activations (A16). Logs how
    many outputs differ and how many f32 sums equal the f64 sum; fails
    only if the two orders differ by more than the f32 sum-order bound."""
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.kernels import gemm_lab as gl

    m, n = xa.shape[0], pw.codes.shape[1]
    ones_m = torch.ones((m, 1), device="cuda")
    ones_n = torch.ones((1, n), device="cuda")
    plan = gk._split_plan
    xbf = bf16_randn(gen, xa.shape, 2.0)
    for what, x in (("quantized xa", xa), ("bf16 xa (A16)", xbf)):
        def acc():
            return gk._gemm_w8_cuda(x, pw.codes, pw.scales, ones_m, ones_n,
                                    None, torch.float32)
        at_plan = acc()
        gk._split_plan = lambda m_, n_, kq: (plan(m_, n_, kq)[0], 1,
                                             kq // gk._BK)
        try:
            at_one = acc()
        finally:
            gk._split_plan = plan
        exact = gemm_w8_f64(x, pw.codes, pw.scales, ones_m, ones_n, None,
                            None)
        lab = [gl.lab_w8(x, pw.codes, pw.scales, ones_m, ones_n, splits=s)
               for s in (1, splits)]
        torch.cuda.synchronize()
        n_f32 = int((at_plan != at_one).sum())
        n_exact = [int((z.double() == exact).sum()) for z in (at_one, at_plan)]
        n_bf16 = int((lab[0].view(torch.int16) != lab[1].view(torch.int16))
                     .sum())
        log(f"  {'':13s} k order, qkv M={m}, {what}: gemm_w8 f32 sums at 1 "
            f"and {splits} splits differ at {n_f32} of {m * n}; equal to the "
            f"f64 sum at {n_exact[0]} / {n_exact[1]}; lab_w8 bf16 outputs "
            f"at 1 and {splits} splits differ at {n_bf16}")
        if not sum_order_bound(at_plan, at_one, True):
            failures.append(f"gemm_w8 {what}: {splits} splits vs 1 beyond "
                            "the f32 sum-order bound")


def _paged_prefill_f64(q, codes, params, pt, st, sl):
    """paged_prefill in f64 with the K/V dequantized (codes * scale + min)
    before the products: the accuracy reference at live queries."""
    b, tq, hq, dh = q.shape
    _, _, hkv, page, _ = codes.shape
    g, pps = hq // hkv, pt.shape[1]
    c = codes[pt.long()]                       # [B, pps, 2, H, page, D/2]
    vals = torch.cat([c & 0xF, c >> 4], dim=-1).double()
    vals = vals.permute(0, 2, 3, 1, 4, 5).reshape(b, 2, hkv, pps * page, dh)
    prm = params[pt.long()].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, pps * page, 4).double()
    k = vals[:, 0] * prm[..., 0:1] + prm[..., 1:2]
    v = vals[:, 1] * prm[..., 2:3] + prm[..., 3:4]
    qf = (q.double().reshape(b, tq, hkv, g, dh).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, tq * g, dh)) / dh ** 0.5
    qpos = (st.long()[:, None] + torch.arange(tq, device=q.device)[None]
            ).repeat_interleave(g, dim=1)
    kpos = torch.arange(pps * page, device=q.device)
    mask = ((kpos[None, None] <= qpos[:, :, None])
            & (kpos[None, None] < sl.long()[:, None, None]))[:, None]
    s = torch.einsum("bhrd,bhtd->bhrt", qf, k).masked_fill(~mask, -1e300)
    out = torch.einsum("bhrt,bhtd->bhrd", torch.softmax(s, -1) * mask, v)
    return (out.reshape(b, hkv, tq, g, dh).permute(0, 2, 1, 3, 4)
            .reshape(b, tq, hq, dh))


def paged_prefill_check(cfg, gen, timer, record, rep=True):
    """paged_prefill at the serving shape: B 8 rows of a 512-token chunk
    over a 2048-token page table of 128-token pages, ragged per-row
    origins (first chunks, later chunks, prefix-shared suffixes) and one
    idle row. Compared on every query at a position < seq_len (the
    engine discards the rest), idle rows exactly 0."""
    from arcquant_tpu_torch.cache import paged
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bsz, tq, page, pps = 8, 512, 128, 16
    starts = [0, 512, 1024, 1536, 0, 1024, 0, 0]
    seqs = [512, 1024, 1536, 1900, 301, 1124, 64, 0]
    one = cfg.replace(num_layers=1)
    cache = paged.init_cache(one, 1 + bsz * pps, page, "cuda")
    # rows own interleaved pages, so neighbouring pages are other rows'
    pt = (1 + torch.arange(pps)[None, :] * bsz
          + torch.arange(bsz)[:, None]).to(torch.int32).cuda()
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    sl = torch.tensor(seqs, dtype=torch.int32, device="cuda")
    t = pps * page
    pos = torch.arange(t, device="cuda")[None].expand(bsz, t)
    pos = torch.where(pos < sl[:, None], pos, -1)
    paged.append_kv(cache, 0, bf16_randn(gen, (bsz, t, hkv, dh), 2.0),
                    bf16_randn(gen, (bsz, t, hkv, dh)), pt, pos)
    q = bf16_randn(gen, (bsz, tq, hq, dh), 2.0)
    args = (q, cache.codes[0], cache.params[0], pt, st, sl)
    o = pdk._paged_prefill_cuda(*args)
    po = pdk.paged_prefill_plain(*args)
    torch.cuda.synchronize()
    qpos = st[:, None] + torch.arange(tq, device="cuda")[None]   # [B, Tq]
    live = qpos < sl[:, None]
    # accuracy: the kernel within 1% of the plain version's mean error
    # against f64 (both round the same f32 math to bf16 in other orders)
    ref = _paged_prefill_f64(*args)[live]
    err_k = float((o[live].double() - ref).abs().mean())
    err_p = float((po[live].double() - ref).abs().mean())
    del ref
    differ = float((o[live] != po[live]).float().mean())
    log(f"  {'':13s} live outputs differing from plain: {differ:.4%}; "
        f"mean abs error vs f64: kernel {err_k:.6g}, plain {err_p:.6g}")
    ok = (close_bound(o[live], po[live]) and bool((o[sl == 0] == 0).all())
          and bool(torch.isfinite(o).all()) and err_k <= 1.01 * err_p)
    # work these inputs need: every live query attends to qpos + 1 keys;
    # a row reads the pool of its seq keys (none when idle)
    pairs = float(((qpos + 1) * live).sum())
    keys = sum(s for s, o_ in zip(seqs, starts) if o_ < s)
    kd, vd = (x.to(torch.bfloat16).transpose(1, 2).contiguous()
              for x in paged.gather_kv(cache, 0, pt, t))
    qd = q.transpose(1, 2).contiguous()
    kpos = torch.arange(t, device="cuda")
    mask = ((kpos[None, None] <= qpos[:, :, None])
            & (kpos[None, None] < sl[:, None, None]))[:, None]
    record("paged_prefill",
           "B=8 Tq=512 q_starts=0,512,1024,1536,0,1024,0,0 "
           f"seq=512,1024,1536,1900,301,1124,64,0 page=128 H={hq}/{hkv}",
           float((o[live].float() - po[live].float()).abs().max()), ok,
           timer(lambda: pdk._paged_prefill_cuda(*args)),
           timer(lambda: pdk.paged_prefill_plain(*args)),
           "1 bf16 ulp + 2e-3 on live queries, idle row 0, mean error "
           "vs f64 within 1.01x the plain version's", rep=rep,
           work=(4.0 * pairs * hq * dh,
                 keys * hkv * (dh + 16) + nbytes(q, o)),
           library=lambda: sdpa(qd, kd, vd, attn_mask=mask,
                                enable_gqa=True),
           library_what="SDPA over the pool dequantized to bf16, call only")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def bitwise(got, want) -> bool:
    return all(a.shape == b.shape and a.dtype == b.dtype
               and torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def _stack_experts(t: torch.Tensor, e: int) -> torch.Tensor:
    """[rows, E * N] of E experts' packs side by side -> [E, rows, N]."""
    return t.reshape(t.shape[0], e, -1).transpose(0, 1).contiguous()


def moe_kernel_checks(cfg, gen, timer, record, summary):
    """Phase 3, the MoE model's kernels (qwen1.5-moe-a2.7b: 60 experts,
    down projections K 1408 -> N 2048):
      gemm_batched   w8 and w4, at decode (M 4 and 8; Kq 1536 select-free
                     and 2048 with ARC select_frac 0.125), at M 17 and
                     64 (ARC: the small-M mainloop's 32- and 64-row
                     tiles) and at a dense-mode prefill (M 256, ARC), f32
                     out as on the path: bitwise against the per-expert
                     loop of gemm_w8 / gemm_w4 (gemm.gemm_batched_chain,
                     whose time is kept as chain_ms), within the f32 sum
                     order of its plain version, its bound, and torch.bmm
                     over the decoded bf16 stack as the library
                     yardstick;
      dequant_w8/w4  the 60-expert down stack decoded in one launch (the
                     dispatch-mode prefill's decode), bitwise vs plain;
      attention      flash, paged decode and paged prefill at the MoE
                     model's G = 1 (16 heads of 128, 16 KV heads)."""
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.quant import packing

    e, d, f = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
    for frac in (0.0, SELECT_FRAC):
        sel = int(round(frac * f / 64)) * 64
        w = bf16_randn(gen, (e * d, f), f ** -0.5)   # the experts' down rows
        ridx = torch.randperm(f, generator=gen, device="cuda")
        packs = {}
        for fmt in ("w8", "w4"):
            pw = packing.pack_weight_arc_rows(w, ridx, sel, fmt=fmt)
            packs[fmt] = type(pw)(_stack_experts(pw.codes, e),
                                  _stack_experts(pw.scales, e),
                                  pw.global_scale.reshape(e, d), None)
        del w
        kq = packs["w8"].kq
        if sel:
            for fmt, pk in packs.items():
                kern = gk._dequant_w8_cuda if fmt == "w8" \
                    else gk._dequant_w4_cuda
                plain = gk.dequant_w8_plain if fmt == "w8" \
                    else gk.dequant_w4_plain
                for gwf in (None, pk.global_scale):
                    out = kern(pk.codes, pk.scales, gwf)
                    ref = plain(pk.codes, pk.scales, gwf)
                    torch.cuda.synchronize()
                    record(f"dequant_{fmt}", f"stacked E={e} Kq={kq} N={d}"
                           + (" fold_global" if gwf is not None else ""),
                           float((out.float() - ref.float()).abs().max()),
                           bitwise([out], [ref]),
                           timer(lambda: kern(pk.codes, pk.scales, gwf)),
                           timer(lambda: plain(pk.codes, pk.scales, gwf)),
                           "bitwise", rep=False)
                    del out, ref
        wd = gk.dequant_weight(packs["w8"])     # natural k order, bf16
        for m in (4, 8) + ((17, 64, 256) if sel else ()):
            xa = bf16_randn(gen, (e, m, kq), 2.0)
            gs = torch.rand((e, m, 1), generator=gen, device="cuda") + 0.5
            for fmt, pk in packs.items():
                gw = pk.global_scale.reshape(e, 1, d)
                args = (xa, pk.codes, pk.scales, gs, gw, torch.float32)
                y = gk._gemm_batched_cuda(*args)
                loop = gk.gemm_batched_chain(*args)
                ref = gk.gemm_batched_plain(*args)
                torch.cuda.synchronize()
                same = bitwise([y], [loop])
                ok = same and sum_order_bound(y.reshape(e * m, d),
                                              ref.reshape(e * m, d), True)
                rep = fmt == "w8" and m == 4 and sel > 0
                ms = timer(lambda: gk._gemm_batched_cuda(*args))
                loop_ms = timer(lambda: gk.gemm_batched_chain(*args))
                work = (2.0 * e * m * kq * d,
                        nbytes(xa, pk.codes, pk.scales, gs, gw, y))
                record("gemm_batched", f"{fmt} E={e} M={m} Kq={kq} N={d} "
                       f"bitwise-vs-loop={same}",
                       float((y - ref).abs().max()), ok, ms,
                       timer(lambda: gk.gemm_batched_plain(*args)),
                       f"bitwise vs the per-expert gemm_{fmt} loop; f32 "
                       "sum order vs plain", rep=rep, work=work,
                       library=lambda: torch.bmm(xa, wd),
                       library_what="torch.bmm over the decoded bf16 "
                       "stack")
                b_ms, _ = bound_ms(*work)
                log(f"  {'':13s} the per-expert loop ({e} gemm_{fmt} "
                    f"launches) {loop_ms:.4f} ms; bound {b_ms:.4f} ms")
                if rep:
                    summary["gemm_batched"]["chain_ms"] = loop_ms
                elif fmt == "w4" and m == 4 and sel:
                    summary["gemm_batched"].update(
                        w4_ms=ms, w4_bound_ms=b_ms, w4_chain_ms=loop_ms)
                del y, loop, ref
        del packs, wd
        torch.cuda.empty_cache()
    attention_checks(cfg, gen, timer, record, rep=False)


def fused_checks(cfg, gen, timer, record, summary):
    """Phase 3, the decode megakernels at M 4, 8 and 16: the qkv (bias,
    rmsnorm) and o (plain) sites of gemm_actq and the whole MLP (mlp_w8,
    rmsnorm mode) with select-free packing, gu_actq with ARC select_frac
    0.125 packing (kq1 4096, kq2 21504). Bars: every output bitwise equal
    to the port's CUDA chain of the same function (kernels/mlp_fused.py
    *_chain: actq, then gemm_w8 at its split-K), and each step against
    its plain version over the same input: a GEMM output within the f32
    sum order plus one bf16 ulp of gemm_w8_plain over the chain's
    quantized activation, a silu_mul quantize within actq's bound of
    actq_plain. max_abs_err is the largest such step error. The chain's
    time is logged and kept beside the kernel's; no single PyTorch call
    computes these functions (library: none)."""
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.kernels import mlp_fused as mf
    from arcquant_tpu_torch.kernels import quantize as qk
    from arcquant_tpu_torch.quant import packing

    h, f, eps = cfg.hidden_size, cfg.intermediate_size, cfg.rms_eps
    bf = torch.bfloat16

    def pack(n, k, sel, bias):
        w = bf16_randn(gen, (n, k), k ** -0.5)
        b = bf16_randn(gen, (n,), 0.1) if bias else None
        ridx = torch.arange(k, device="cuda")
        return packing.pack_weight_arc(w, ridx, sel, bias=b,
                                       w_scale="channel")

    def gemm_step(y, xa, gs, pw):
        """(error, ok) of a GEMM output against gemm_w8_plain over xa."""
        ref = gk.gemm_w8_plain(xa, pw.codes, pw.scales, gs, mf._gw(pw),
                               pw.bias, y.dtype)
        return (float((y.float() - ref.float()).abs().max()),
                sum_order_bound(y, ref, y.dtype == torch.float32))

    def silu_step(xa2, gx2, gu, f_, kq2):
        pa, pg = qk.actq_plain(gu, None, mode="silu_mul", k=f_, kq=kq2)
        return (float((xa2.float() - pa.float()).abs().max()),
                one_step_bound(xa2, pa)
                and bool(torch.allclose(gx2, pg, rtol=1e-2)))

    def row(kernel, case, args, plain, chain, cuda, steps, work, rep):
        got = cuda(*args)
        want = chain(*args)
        torch.cuda.synchronize()
        same = bitwise(got, want)
        errs = steps(got)
        err = max(e for e, _ in errs)
        ok = same and all(o for _, o in errs)
        chain_ms = timer(lambda: chain(*args))
        record(kernel, f"{case} bitwise-vs-chain={same}", err, ok,
               timer(lambda: cuda(*args)), timer(lambda: plain(*args)),
               "bitwise vs the CUDA chain; each step vs its plain version",
               rep=rep, work=work(got))
        log(f"  {'':13s} CUDA chain (actq -> gemm_w8 ...) {chain_ms:.4f} ms")
        if rep:
            summary[kernel]["chain_ms"] = chain_ms

    nq = cfg.q_size + 2 * cfg.kv_size
    sites = [("qkv", pack(nq, h, 0, True), h, True),
             ("o", pack(h, cfg.q_size, 0, False), cfg.q_size, False)]
    for name, pw, d, norm in sites:
        nw = (bf16_randn(gen, (d,), 0.1) + 1).to(bf) if norm else None
        mode = "rmsnorm" if norm else "plain"
        for m in (4, 8, 16):
            x = bf16_randn(gen, (m, d), 2.0)
            args = (x, pw, d, bf, nw, eps)

            def steps(got, x=x, nw=nw, mode=mode, pw=pw, d=d):
                xa, gx = qk._actq_cuda(x, nw, mode=mode, k=d, kq=pw.kq,
                                       eps=eps)
                return [gemm_step(got[0], xa, gx, pw)]

            def work(got, m=m, pw=pw, x=x, nw=nw):
                return (2.0 * m * pw.kq * pw.n,
                        nbytes(x, nw, pw.codes, pw.scales, pw.global_scale,
                                pw.bias, *got))
            row("gemm_actq", f"{name} {mode} M={m} D={d} Kq={pw.kq} "
                f"N={pw.n}", args, mf.gemm_actq_plain, mf.gemm_actq_chain,
                mf._gemm_actq_cuda, steps, work,
                rep=name == "qkv" and m == 4)
        del pw

    # the whole MLP, select-free (kq2 = pad_kq(18944, 0) = 19456)
    pw_gu, pw_dn = pack(2 * f, h, 0, False), pack(h, f, 0, False)
    nw = (bf16_randn(gen, (h,), 0.1) + 1).to(bf)
    for m in (4, 8, 16):
        x = bf16_randn(gen, (m, h), 2.0)
        args = (x, None, pw_gu, pw_dn, f, bf, nw, eps)

        def steps(got, x=x):
            out, gu, gx2 = got
            xa1, gx1 = qk._actq_cuda(x, nw, mode="rmsnorm", k=h,
                                     kq=pw_gu.kq, eps=eps)
            xa2, _ = qk._actq_cuda(gu, None, mode="silu_mul", k=f,
                                   kq=pw_dn.kq)
            return [gemm_step(gu, xa1, gx1, pw_gu),
                    silu_step(xa2, gx2, gu, f, pw_dn.kq),
                    gemm_step(out, xa2, gx2, pw_dn)]

        def work(got, m=m, x=x):
            return (2.0 * m * (pw_gu.kq * pw_gu.n + pw_dn.kq * pw_dn.n),
                    nbytes(x, nw, *pw_gu[:3], *pw_dn[:3], *got))
        row("mlp_w8", f"rmsnorm M={m} D={h} F={f} Kq1={pw_gu.kq} "
            f"Kq2={pw_dn.kq}", args, mf.mlp_w8_plain, mf.mlp_w8_chain,
            mf._mlp_w8_cuda, steps, work, rep=m == 4)
    del pw_gu, pw_dn

    # gateup + silu*mul + quantize with ARC: the down_in width is 21504
    sel1 = int(round(SELECT_FRAC * h / 64)) * 64
    sel2 = int(round(SELECT_FRAC * f / 64)) * 64
    pw_gu = pack(2 * f, h, sel1, False)
    kq2 = packing.pad_kq(f, sel2)
    for m in (4, 8, 16):
        xa1, gs1 = qk.quantize_x_arc(bf16_randn(gen, (m, h), 2.0),
                                     torch.arange(h, device="cuda"), sel1)
        args = (xa1, gs1, pw_gu, f, kq2, bf)

        def steps(got, xa1=xa1, gs1=gs1):
            xa2, gu, gx2 = got
            return [gemm_step(gu, xa1, gs1, pw_gu),
                    silu_step(xa2, gx2, gu, f, kq2)]

        def work(got, m=m, xa1=xa1, gs1=gs1):
            return (2.0 * m * pw_gu.kq * pw_gu.n,
                    nbytes(xa1, gs1, *pw_gu[:3], *got))
        row("gu_actq", f"M={m} Kq1={pw_gu.kq} N={pw_gu.n} Kq2={kq2}", args,
            mf.gu_actq_plain, mf.gu_actq_chain, mf._gu_actq_cuda, steps,
            work, rep=m == 4)
    del pw_gu


def prompts_for(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]


def engine_run(cfg, card, failures):
    """Phase 4: the 28-layer engine through generate(). Returns the
    kernels' launch counts over that run."""
    from arcquant_tpu_torch.config import QuantConfig
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.kernels import attention, gemm as gk
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    from arcquant_tpu_torch.kernels import quantize as qk
    from arcquant_tpu_torch.models import quantized

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    calib = quantized.identity_calib(cfg, SELECT_FRAC, device="cuda")
    log(f"  ARC residual columns per site: "
        f"{ {s: c.select_num for s, c in calib[0].items()} }")
    eng = InferenceEngine.dummy(cfg, calib, qcfg, ecfg, seed=0,
                                device="cuda")
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated()
    log(f"  dummy engine built ({cfg.num_layers} layers packed on the card) "
        f"in {time.perf_counter() - t0:.1f} s, peak device memory "
        f"{build_peak / 2 ** 30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    prompts = prompts_for(cfg)

    kernels = all_kernels()
    reset_counts(kernels)
    out = eng.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    log(f"  launches in generate(): {launches}")
    for name in GENERATE_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} not launched by generate()")
    for name in ARC_IDLE_KERNELS:
        if launches[name] != 0:
            failures.append(f"kernel {name} launched by the ARC generate()")
    if [len(o) for o in out] != [NEW_TOKENS] * len(PROMPT_LENS):
        failures.append(f"generate lengths {[len(o) for o in out]}")
    flat = [t for o in out for t in o]
    if not all(0 <= t < cfg.vocab_size for t in flat):
        failures.append("generated token out of range")
    log(f"  first tokens per request: {[o[:6] for o in out]}")

    # timed: prefill, then NEW_TOKENS decode steps (warm: generate ran)
    toks, lens, _ = eng._pad_prompts(prompts)
    state = eng.new_state()
    torch.cuda.synchronize()
    n8 = gk.GEMM_W8.launches
    t0 = time.perf_counter()
    logits, state = eng.prefill(state, toks, lens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    log(f"  gemm_w8 launches in the timed prefill (M {toks.size} rows: "
        f"the large-M tile at down and o of each layer, the route at qkv "
        f"and gateup; the head at M {len(PROMPT_LENS)}): "
        f"{gk.GEMM_W8.launches - n8}")
    finite = bool(torch.isfinite(logits).all())
    cur = logits.argmax(-1).to(torch.int32)
    active = torch.ones(len(PROMPT_LENS), dtype=torch.bool)
    step_counts = []    # paged_decode calls a step: one a layer
    capture(eng, state)
    t0 = time.perf_counter()
    for _ in range(NEW_TOKENS):
        before = pdk.PAGED_DECODE.launches
        logits, state = eng.decode_step(state, cur, active)
        step_counts.append(pdk.PAGED_DECODE.launches - before)
        cur = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    log(f"  paged_decode counts a decode step: {sorted(set(step_counts))} "
        f"(want {cfg.num_layers}, one a layer)")
    if set(step_counts) != {cfg.num_layers}:
        failures.append(f"paged_decode counted {step_counts} over the "
                        f"decode steps, not {cfg.num_layers} a step")
    finite = finite and bool(torch.isfinite(logits).all())
    if not finite:
        failures.append("non-finite logits")
    if not bool(((cur >= 0) & (cur < cfg.vocab_size)).all()):
        failures.append("decoded token out of range")
    peak = torch.cuda.max_memory_allocated()
    metrics = dict(
        prefill_ms=round(prefill_ms, 3),
        prefill_tokens=int(sum(PROMPT_LENS)), padded_batch=[4, 1024],
        decode_ms_per_step=round(dec_s * 1e3 / NEW_TOKENS, 3),
        decode_tok_s=round(len(PROMPT_LENS) * NEW_TOKENS / dec_s, 2),
        serve_peak_memory_gib=round(peak / 2 ** 30, 3),
        build_peak_memory_gib=round(build_peak / 2 ** 30, 3),
        logits_finite=finite, card=card)
    log(f"  engine {MODEL} {cfg.num_layers} layers bs=4: "
        f"{json.dumps(metrics)}")
    del state, logits
    log(f"[graph] ARC (select_frac {SELECT_FRAC}), {MODEL} full width, "
        f"{cfg.num_layers} layers: the captured decode step against the "
        f"eager loop, on {card}")
    graph_check(eng, "ARC", card, failures)
    qparams = eng.qparams
    del eng
    torch.cuda.empty_cache()
    return launches, qparams, calib


def _device_busy_ms(prof) -> tuple:
    """(ms, count): the union of the device's activity intervals (kernels,
    copies, fills) in a torch.profiler profile, and how many there were."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(spans)


def graph_check(eng, label, card, failures):
    """The [graph] phase on a 28-layer engine: its decode step captured
    as a CUDA graph (eng, cuda_graphs=True) against the eager loop (the
    same weights, cuda_graphs=False). Each engine decodes one state of
    its own (one capture). Bitwise: fed the loop's greedy tokens for
    NEW_TOKENS steps, every step's logits (decode_step); then decode_scan
    of NEW_TOKENS steps after the same prefill, timed in turns (loop,
    graph, graph, loop), whose tokens must agree in all four runs. Then
    the capture's time and graph pool, and the device idle share over 8
    decode_scan steps of each from torch.profiler (1 - the union of the
    device's activity over the host's wall time of the profiled steps).
    Returns the phase's metrics."""
    from arcquant_tpu_torch.engine import InferenceEngine

    loop = InferenceEngine(eng.cfg, eng.qparams, eng.calib, eng.qcfg,
                           eng.ecfg, device=eng.device, quantize_params=False,
                           fused_decode=eng.fused_decode, cuda_graphs=False)
    engines = {"graph": eng, "loop": loop}
    # a graph cached from an earlier phase is right for any state at its
    # addresses, which the phase's new state may take: drop them, so that
    # the phase captures its own
    eng.drop_graphs()
    states = {k: e.new_state() for k, e in engines.items()}
    toks, lens, _ = eng._pad_prompts(prompts_for(eng.cfg))
    active = torch.ones(len(PROMPT_LENS), dtype=torch.bool,
                        device=eng.device)
    n_cap = len(eng.graph_captures)

    def prefill(name):
        logits, states[name] = engines[name].prefill(states[name], toks,
                                                     lens)
        return logits

    steps, feed = {}, None
    for name in ("loop", "graph"):
        logits = prefill(name)
        out, fed = [logits.clone()], []
        for i in range(NEW_TOKENS):
            cur = (logits.argmax(-1).to(torch.int32) if feed is None
                   else feed[i])
            fed.append(cur)
            logits, states[name] = engines[name].decode_step(
                states[name], cur, active)
            out.append(logits.clone())
        steps[name], feed = out, fed
    same = [bool(torch.equal(_bits(a), _bits(b)))
            for a, b in zip(steps["loop"], steps["graph"])]
    caps = eng.graph_captures[n_cap:]
    runs = {"loop": [], "graph": []}
    for name in ("loop", "graph", "graph", "loop"):
        first = prefill(name).argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, states[name] = engines[name].decode_scan(
            states[name], first, active, NEW_TOKENS)
        torch.cuda.synchronize()
        runs[name].append((out, (time.perf_counter() - t0) * 1e3
                           / NEW_TOKENS))
    outs = [o for r in runs.values() for o, _ in r]
    tok_same = all(torch.equal(outs[0], o) for o in outs[1:])
    idle = {}
    for name in ("loop", "graph"):
        first = prefill(name).argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            engines[name].decode_scan(states[name], first, active, 8)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, n = _device_busy_ms(prof)
        idle[name] = dict(wall_ms_per_step=round(wall / 8, 3),
                          device_busy_ms_per_step=round(busy / 8, 3),
                          device_idle_share=round(1 - busy / wall, 4),
                          device_activities_per_step=n / 8)
    ok = all(same) and tok_same and len(caps) == 1
    log(f"  {label}: graph vs loop, fed the same tokens: logits bitwise "
        f"equal at {sum(same)} of {len(same)} steps (prefill + {NEW_TOKENS} "
        f"decode); decode_scan tokens equal in all four runs: {tok_same}; "
        f"captures in the phase: {len(caps)} (bar: all, all, 1) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[graph] {label}: bitwise at {same}, scan tokens "
                        f"equal {tok_same}, captures {len(caps)}")
    ms = {k: [round(t, 3) for _, t in v] for k, v in runs.items()}
    metrics = dict(
        decode_ms_per_step_in_turns=ms,
        decode_ms_per_step=dict(
            loop=round(statistics.mean(ms["loop"]), 3),
            graph=round(statistics.mean(ms["graph"]), 3)),
        speedup=round(statistics.mean(ms["loop"])
                      / statistics.mean(ms["graph"]), 3),
        capture_ms=[round(c["capture_ms"], 1) for c in caps],
        graph_pool_mib=[round(c["pool_bytes"] / 2 ** 20, 1) for c in caps],
        kernel_launches_per_step=[c["launches"] for c in caps],
        profiled_8_steps=idle, card=card)
    log(f"  [graph] {label} {eng.cfg.name} {eng.cfg.num_layers} layers "
        f"bs=4: {json.dumps(metrics)}")
    del loop, engines, states, steps, runs, outs
    torch.cuda.empty_cache()
    return metrics


def capture(eng, state) -> None:
    """Capture eng's decode step for state (a decode_scan of 0 steps:
    the capture's warm-up step leaves every slot inactive) before a
    timed decode, so the time is the replays'."""
    b = eng.ecfg.max_batch
    eng.decode_scan(state, torch.zeros(b, dtype=torch.int32),
                    torch.zeros(b, dtype=torch.bool), 0)
    torch.cuda.synchronize()


def reset_counts(kernels) -> None:
    """Set every kernel's launch counts to 0 (before a path's run)."""
    for k in kernels:
        k.reset()


def launch_counts(kernels) -> dict:
    """Each kernel's launches since reset_counts, by name, and actq's
    split by M (rows a launch) under "actq_by_m"."""
    from arcquant_tpu_torch.kernels import quantize as qk
    counts = {k.name: k.launches for k in kernels}
    counts["actq_by_m"] = dict(sorted(qk.ACTQ.by_m.items()))
    return counts


def all_kernels():
    """The kernels' launch counters."""
    from arcquant_tpu_torch.kernels import attention, gemm as gk
    from arcquant_tpu_torch.kernels import gemm_lab as gl
    from arcquant_tpu_torch.kernels import mlp_fused as mf
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    from arcquant_tpu_torch.kernels import quantize as qk
    return [qk.ACTQ, gk.GEMM_W8, attention.FLASH, pdk.PAGED_DECODE,
            pdk.PAGED_PREFILL, mf.MLP_W8, mf.GU_ACTQ, mf.GEMM_ACTQ,
            gk.GEMM_W4, gk.DEQUANT_W8, gk.DEQUANT_W4, gk.PIN_ROWMAJOR,
            gk.GEMM_BATCHED, *gl.KERNELS]


def _packs(tree):
    """Every packed weight in a parameter tree (an MoE layer's included)."""
    from arcquant_tpu_torch.quant import packing
    if isinstance(tree, (packing.PackedWeight, packing.PackedWeightI8)):
        return [tree]
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _packs(v)]
    if isinstance(tree, list):
        return [p for v in tree for p in _packs(v)]
    return []


def _weight_gib(qparams) -> float:
    """Device bytes of an engine's packed layers and head, in GiB."""
    return sum(nbytes(*p) for p in _packs(qparams)) / 2 ** 30


def w4_run(cfg, card, qparams8, calib, failures):
    """Phase 6: the w4 path on 28 packed layers. Returns the kernels'
    launch counts over generate().

    The engine is phase 4's (ARC select_frac 0.125, seed 0, so the same
    random weights) with weight_fmt w4: decode runs actq then gemm_w4 at
    every site and the head (the megakernels are w8 only); prefill runs
    gemm_w4 at o and down and the large-M route (dequant_w4, pin_rowmajor,
    torch.mm) at qkv and gateup. Then the A/B against the phase-4 w8
    weights (qparams8) in an engine of the same settings: with the route
    off (gemm.XLA_M = 0) both prefill and decode 32 steps fed the same
    tokens, two runs each in turns, and the logits must be bitwise equal
    at every step of every run (gemm_w4 gives gemm_w8's bits, and gu_actq
    the w8 chain's), with the decode ms/step of each; with the route on,
    the prefill logits' cosine is logged (the w4 route contracts k in
    the split even/odd order). Prefill times of both formats with the
    route on and off, two each, in turns."""
    from arcquant_tpu_torch.config import QuantConfig
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.kernels import gemm as gk

    qcfg8 = QuantConfig(quant_type="NVFP4", use_kernels=True,
                        weight_fmt="w8", act_scale="row", w_scale="channel",
                        quantize_lm_head=True)
    qcfg4 = qcfg8.replace(weight_fmt="w4")
    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()     # the w8 weights of the A/B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngine.dummy(cfg, calib, qcfg4, ecfg, seed=0,
                                device="cuda")
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() - held
    log(f"  w4 engine built in {time.perf_counter() - t0:.1f} s, peak "
        f"device memory {build_peak / 2 ** 30:.3f} GiB beyond the "
        f"{held / 2 ** 30:.3f} GiB held for the A/B")
    torch.cuda.reset_peak_memory_stats()
    prompts = prompts_for(cfg)
    kernels = all_kernels()
    reset_counts(kernels)
    out = eng.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    log(f"  launches in generate(): {launches}")
    for name in W4_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} not launched by the w4 "
                            "generate()")
    for name in W4_IDLE_KERNELS:
        if launches[name] != 0:
            failures.append(f"kernel {name} launched by the w4 generate()")
    if [len(o) for o in out] != [NEW_TOKENS] * len(PROMPT_LENS):
        failures.append(f"w4 generate lengths {[len(o) for o in out]}")
    if not all(0 <= t < cfg.vocab_size for o in out for t in o):
        failures.append("w4 generated token out of range")
    log(f"  first tokens per request: {[o[:6] for o in out]}")

    toks, lens, _ = eng._pad_prompts(prompts)
    active = torch.ones(len(PROMPT_LENS), dtype=torch.bool)
    state = eng.new_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = eng.prefill(state, toks, lens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    capture(eng, state)
    t0 = time.perf_counter()
    for _ in range(NEW_TOKENS):
        logits, state = eng.decode_step(
            state, logits.argmax(-1).to(torch.int32), active)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    peak = torch.cuda.max_memory_allocated() - held
    del state, logits

    eng8 = InferenceEngine(cfg, qparams8, calib, qcfg8, ecfg,
                           device="cuda", quantize_params=False)
    engines = {"w8": eng8, "w4": eng}
    saved, runs, feed = gk.XLA_M, {}, None
    try:
        # in turns, so that the host's drift favours no format or route
        for fmt, route in (("w8", True), ("w4", True), ("w8", False),
                           ("w4", False), ("w4", False), ("w8", False),
                           ("w4", True), ("w8", True)):
            gk.XLA_M = saved if route else 0
            e = engines[fmt]
            state = e.new_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = e.prefill(state, toks, lens)
            torch.cuda.synchronize()
            run = dict(ms=(time.perf_counter() - t0) * 1e3,
                       steps=[logits.clone()])
            if not route:         # the bitwise A/B: decode, fed the same
                fed = []
                capture(e, state)
                t0 = time.perf_counter()
                for i in range(NEW_TOKENS):
                    cur = (logits.argmax(-1).to(torch.int32) if feed is None
                           else feed[i])
                    fed.append(cur)
                    logits, state = e.decode_step(state, cur, active)
                    run["steps"].append(logits.clone())
                torch.cuda.synchronize()
                run["decode_ms"] = (time.perf_counter() - t0) * 1e3 / NEW_TOKENS
                feed = fed
            runs.setdefault((fmt, route), []).append(run)
            del state, logits
    finally:
        gk.XLA_M = saved
    ref = runs[("w8", False)][0]["steps"]
    others = [r["steps"] for r in runs[("w8", False)][1:]
              + runs[("w4", False)]]
    same = [all(bool(torch.equal(_bits(x), _bits(o[i]))) for o in others)
            for i, x in enumerate(ref)]
    log(f"  w4 vs w8, route off, same tokens fed (two runs each, in turns): "
        f"logits bitwise equal in every run at {sum(same)} of {len(same)} "
        f"steps (prefill + {NEW_TOKENS} decode; bar: all) "
        f"{'ok' if all(same) else 'FAIL'}")
    if not all(same):
        failures.append(f"w4 vs w8 engine with the route off: bitwise at "
                        f"{same}")
    cos = _cosine(runs[("w4", True)][0]["steps"][0],
                  runs[("w8", True)][0]["steps"][0])
    tok_same = bool(torch.equal(runs[("w4", True)][0]["steps"][0].argmax(-1),
                                runs[("w8", True)][0]["steps"][0].argmax(-1)))
    log(f"  w4 vs w8, route on: prefill logits cosine {cos:.6f}, greedy "
        f"tokens {'equal' if tok_same else 'differ'} (logged; the w4 route "
        "sums k in the split even/odd order)")
    dec = {fmt: [round(r["decode_ms"], 3) for r in runs[(fmt, False)]]
           for fmt in ("w8", "w4")}
    pre = {f"{fmt}_route_{'on' if r else 'off'}": [round(x["ms"], 3)
                                                  for x in v]
           for (fmt, r), v in runs.items()}
    metrics = dict(
        prefill_ms=round(prefill_ms, 3),
        decode_ms_per_step=round(dec_s * 1e3 / NEW_TOKENS, 3),
        decode_tok_s=round(len(PROMPT_LENS) * NEW_TOKENS / dec_s, 2),
        prefill_ms_by_format_and_route=pre,
        decode_ms_per_step_route_off_in_turns=dec,
        weight_gib=round(_weight_gib(eng.qparams), 3),
        w8_weight_gib=round(_weight_gib(qparams8), 3),
        serve_peak_memory_gib=round(peak / 2 ** 30, 3),
        build_peak_memory_gib=round(build_peak / 2 ** 30, 3),
        logits_finite=finite, card=card)
    log(f"  w4 engine {MODEL} {cfg.num_layers} layers bs=4: "
        f"{json.dumps(metrics)}")
    if not finite:
        failures.append("w4: non-finite logits")
    del eng, eng8, engines, runs, ref, others
    torch.cuda.empty_cache()
    return launches


def free_run(cfg, card, failures):
    """Phase 7: the select-free path on 28 packed layers. Returns the
    kernels' launch counts over generate().

    Then the A/B: the same weights in an engine with fused_decode=False,
    prefilled with the same prompts and fed the fused engine's greedy
    tokens, two runs of each in turns (fused, unfused, unfused, fused),
    timed; every step's logits must be bitwise equal across all four
    (eager PyTorch runs the same ops on the same inputs apart from the
    fused launches, so this bar does not meet the dummy model's noise
    floor)."""
    from arcquant_tpu_torch.config import QuantConfig
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import quantized

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    calib = quantized.identity_calib(cfg, 0.0, device="cuda")
    eng = InferenceEngine.dummy(cfg, calib, qcfg, ecfg, seed=0,
                                device="cuda")
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated()
    log(f"  select-free engine built in {time.perf_counter() - t0:.1f} s, "
        f"peak device memory {build_peak / 2 ** 30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    prompts = prompts_for(cfg)
    kernels = all_kernels()
    reset_counts(kernels)
    out = eng.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    log(f"  launches in generate(): {launches}")
    for name in FREE_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} not launched by the select-free "
                            "generate()")
    for name in FREE_IDLE_KERNELS:
        if launches[name] != 0:
            failures.append(f"kernel {name} launched by the select-free "
                            "generate()")
    if [len(o) for o in out] != [NEW_TOKENS] * len(PROMPT_LENS):
        failures.append("select-free generate lengths "
                        f"{[len(o) for o in out]}")
    if not all(0 <= t < cfg.vocab_size for o in out for t in o):
        failures.append("select-free generated token out of range")
    log(f"  first tokens per request: {[o[:6] for o in out]}")
    peak = torch.cuda.max_memory_allocated()

    chain = InferenceEngine(cfg, eng.qparams, calib, qcfg, ecfg,
                            device="cuda", quantize_params=False,
                            fused_decode=False)
    toks, lens, _ = eng._pad_prompts(prompts)
    active = torch.ones(len(PROMPT_LENS), dtype=torch.bool)
    runs = {"fused": [], "chain": []}
    feed = None
    # in turns, so that the host's drift does not favour either
    for name in ("fused", "chain", "chain", "fused"):
        e = eng if name == "fused" else chain
        state = e.new_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = e.prefill(state, toks, lens)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        steps, fed = [logits.clone()], []
        capture(e, state)
        t0 = time.perf_counter()
        for i in range(NEW_TOKENS):
            cur = (logits.argmax(-1).to(torch.int32) if feed is None
                   else feed[i])
            fed.append(cur)
            logits, state = e.decode_step(state, cur, active)
            steps.append(logits.clone())
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        feed = fed
        runs[name].append(dict(steps=steps, prefill_ms=prefill_ms,
                               decode_ms=dec_s * 1e3 / NEW_TOKENS))
    fused = runs["fused"][0]["steps"]
    others = [r["steps"] for r in runs["fused"][1:] + runs["chain"]]
    same = [all(bool(torch.equal(_bits(a), _bits(o[i]))) for o in others)
            for i, a in enumerate(fused)]
    tokens = [all(bool(torch.equal(a.argmax(-1), o[i].argmax(-1)))
                  for o in others) for i, a in enumerate(fused)]
    finite = all(bool(torch.isfinite(a).all()) for a in fused)
    log(f"  fused vs fused_decode=False (two runs each, in turns), same "
        f"tokens fed: logits bitwise equal in every run at {sum(same)} of "
        f"{len(same)} steps (prefill + {NEW_TOKENS} decode), greedy tokens "
        f"equal at {sum(tokens)} (bar: all) "
        f"{'ok' if all(same) and all(tokens) else 'FAIL'}")
    if not (all(same) and all(tokens) and finite):
        failures.append(f"select-free fused vs unfused decode: bitwise at "
                        f"{same}, tokens at {tokens}, finite {finite}")

    def mean(name, key):
        return round(statistics.mean(r[key] for r in runs[name]), 3)
    dec = {k: [round(r["decode_ms"], 3) for r in runs[k]] for k in runs}
    metrics = dict(
        prefill_ms=mean("fused", "prefill_ms"),
        decode_ms_per_step=mean("fused", "decode_ms"),
        decode_tok_s=round(len(PROMPT_LENS) * 1e3
                           / mean("fused", "decode_ms"), 2),
        unfused_prefill_ms=mean("chain", "prefill_ms"),
        unfused_decode_ms_per_step=mean("chain", "decode_ms"),
        unfused_decode_tok_s=round(len(PROMPT_LENS) * 1e3
                                   / mean("chain", "decode_ms"), 2),
        decode_ms_per_step_by_run=dec,
        serve_peak_memory_gib=round(peak / 2 ** 30, 3),
        build_peak_memory_gib=round(build_peak / 2 ** 30, 3),
        logits_finite=finite, card=card)
    log(f"  select-free engine {MODEL} {cfg.num_layers} layers bs=4: "
        f"{json.dumps(metrics)}")
    del chain, runs, fused, others
    log(f"[graph] select-free, {MODEL} full width, {cfg.num_layers} layers: "
        f"the captured decode step against the eager loop, on {card}")
    graph_check(eng, "select-free", card, failures)
    del eng
    torch.cuda.empty_cache()
    return launches


# The [eval] phase: the accuracy path (python -m arcquant_tpu_torch.evaluate)
# on Qwen2.5-7B at full width and depth, 2 windows of 2048 synthetic tokens;
# four routes, of which only the packed one launches kernels (#1 actq, #2
# gemm_w8, #6 dequant_w8 at gate/up, #9 flash attention at T 2048).
EVAL_SEQLEN = 2048
EVAL_WINDOWS = 2
EVAL_KERNELS = ("actq", "gemm_w8", "dequant_w8", "flash_attn")
EVAL_ROUTES = (
    ("BF16", ["--quant_type", "BF16"]),
    ("NVFP4 fake, act_scale tensor (evaluate's defaults)", []),
    ("NVFP4 fake, act_scale row", ["--act_scale", "row"]),
    ("NVFP4 packed w8, act_scale row (--use_kernels)",
     ["--use_kernels", "--act_scale", "row"]))
# generate: prompt lengths whose longest is a power of two from 16, so the
# batcher's prefill bucket and generate()'s padding give the same rows
GEN_PROMPT_LENS = (32, 20, 7)
GEN_NEW_TOKENS = 8


def _ppl_rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


@contextlib.contextmanager
def _scratch_dir():
    """Run inside a new temporary directory, then back in the caller's;
    logging handlers added meanwhile (evaluate's log file) are closed."""
    import logging
    import os
    import tempfile
    root = logging.getLogger()
    before, cwd = len(root.handlers), os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            yield
        finally:
            os.chdir(cwd)
            for h in root.handlers[before:]:
                root.removeHandler(h)
                h.close()


def _one_layer_packed_vs_fake(cfg, what, failures):
    """The accuracy path's packed route (use_kernels, act_scale row)
    against its fake row route on cfg cut to 1 layer (llama.init_params'
    weights from seed 0, one window of the synthetic stream at
    EVAL_SEQLEN), by logits cosine. They differ by more than summation
    order (as the JAX package's two routes do): the epilogue's order ((y
    gx) gw against y (gx gs)) and the attention (#9 against f32 dense
    attention) round some bf16 outputs an ulp apart, and the next
    quantize turns that into e2m1 flips. The bar is the floor: draws of
    the fake forward with its GEMM and attention outputs an ulp off on
    the shares at which the packed forward's differ from the fake
    formulas on the same inputs, measured in the same forward (the
    lowest of three draws' cosines less their spread). An MoE layer's
    experts are qdq stacks on both routes. Returns a context manager
    that applies those flips (the fake route's floor draws)."""
    from arcquant_tpu_torch.config import QuantConfig
    from arcquant_tpu_torch.evals import synthetic_stream
    from arcquant_tpu_torch.kernels import attention, gemm as gk
    from arcquant_tpu_torch.models import llama, quantized

    gc.collect()
    torch.cuda.empty_cache()
    cfg1 = cfg.replace(num_layers=1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg1, gen, device="cuda")
    calib = quantized.identity_calib(cfg1, SELECT_FRAC, device="cuda")
    toks = torch.from_numpy(synthetic_stream(
        cfg.vocab_size, EVAL_SEQLEN, 0)).cuda()[None].long()
    qcfgs = [QuantConfig(use_kernels=u, act_scale="row")
             for u in (False, True)]
    trees = [quantized.quantize_model_params(cfg1, params, calib, q)
             for q in qcfgs]
    del params

    def forward(i):
        with torch.inference_mode():
            return quantized.quant_model_forward(
                cfg1, trees[i], calib, qcfgs[i], toks).float()

    flash, real_dense = attention.flash_attention, llama.dense_attention
    real_q_linear = quantized._q_linear
    shares = {"gemm": [], "attn": []}

    def flash_beside_dense(q, k, v):
        out = flash(q, k, v)
        ref = real_dense(q, llama.repeat_kv(k, cfg.num_kv_groups),
                         llama.repeat_kv(v, cfg.num_kv_groups), causal=True)
        shares["attn"].append(float((out != ref).float().mean()))
        return out

    def q_linear_beside_fake(qp, xa, gx, out_dtype):
        y = real_q_linear(qp, xa, gx, out_dtype)
        if isinstance(qp, dict):        # an MoE shared expert's fake linear
            return y
        ref = gk.matmul_f32(xa.to(torch.bfloat16), gk.dequant_weight(qp))
        ref = ref * (gx * qp.global_scale.float().reshape(1, -1))
        if qp.bias is not None:
            ref = ref + qp.bias.float()
        shares["gemm"].append(float((y != ref.to(out_dtype)).float().mean()))
        return y

    fake = forward(0)
    try:
        attention.flash_attention = flash_beside_dense
        quantized._q_linear = q_linear_beside_fake
        packed = forward(1)
    finally:
        attention.flash_attention = flash
        quantized._q_linear = real_q_linear
    share = {k: statistics.mean(v) for k, v in shares.items()}

    def flipped_dense(*a, **kw):
        return _ulp_flips(real_dense(*a, **kw), gen, share["attn"])

    def flipped_q_linear(qp, xa, gx, out_dtype):
        return _ulp_flips(real_q_linear(qp, xa, gx, out_dtype), gen,
                          share["gemm"])

    @contextlib.contextmanager
    def flips():
        llama.dense_attention = flipped_dense
        quantized._q_linear = flipped_q_linear
        try:
            yield
        finally:
            llama.dense_attention = real_dense
            quantized._q_linear = real_q_linear

    gen.manual_seed(1)
    with flips():
        draws = [_cosine(fake, forward(0)) for _ in range(3)]
    floor = min(draws) - (max(draws) - min(draws))
    ok = _cosine(packed, fake) >= floor
    bar = (f"cosine >= {floor:.7f}, the lowest of the flip draws "
           f"{[round(c, 7) for c in sorted(draws)]} less their spread")
    same = float((packed.argmax(-1) == fake.argmax(-1)).float().mean())
    log(f"  {what} 1 layer, one window: packed vs fake row logits cosine "
        f"{_cosine(packed, fake):.7f}, argmax equal at {same:.4%} of "
        f"positions; the packed GEMMs' outputs an ulp or more from the fake "
        f"formula on {share['gemm']:.4%}, #9's from dense attention on "
        f"{share['attn']:.4%} (bar: {bar}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{what} 1-layer packed vs fake: "
                        f"{_cosine(packed, fake)}, {bar}")
    del trees, fake, packed, draws
    return flips


def eval_run(card, failures, model=MODEL, kernels=EVAL_KERNELS,
             tag="[eval]"):
    """[eval] (and [moe_eval]): ``evaluate.main`` (the entry point of
    ``python -m arcquant_tpu_torch.evaluate``) on `model` at full width
    and depth, dummy weights from seed 0, the synthetic stream at seqlen
    2048 over 2 windows (B 1: an MoE layer's 2048 tokens take dispatch
    mode), run in a temporary directory (its log lands there), in four
    routes: BF16, NVFP4 fake with evaluate's defaults (act_scale tensor,
    select 0.125), NVFP4 fake at act_scale row, NVFP4 packed
    (--use_kernels --act_scale row, w8; an MoE model's experts stay qdq
    stacks, as in the JAX package). Each route's PPL, seconds to quantize
    (layer by layer, each raw layer freed), ms a window, peak device
    memory and launch counts; the fake routes and BF16 launch no kernel,
    the packed one each of `kernels` and no other. Gates: every PPL finite
    and > 1; at 1 layer (one window, act_scale row) the packed forward
    against the fake one by logits cosine, and at full depth the packed
    PPL within 1% of the fake row route's, each against the floor where
    that is lower: draws of the fake route with its GEMM and attention
    outputs an ulp off on the shares at which the packed route's differ
    from the fake formulas on the same inputs (the two routes differ in
    epilogue order and attention, not in summation order alone): at 1
    layer the lowest of three draws' cosines less their spread, at full
    depth the farthest of two draws' PPLs; #9 at B 1, T 2048 against
    flash_attention_plain (close_bound). Returns the packed route's launch
    counts."""
    from arcquant_tpu_torch import evaluate
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.kernels import attention, gemm as gk
    from arcquant_tpu_torch.models import llama, quantized

    t_phase = time.perf_counter()
    cfg = get_model_config(model)
    every = all_kernels()
    argv = ["--model", model, "--eval_ppl", "--dataset", "synthetic",
            "--seqlen", str(EVAL_SEQLEN), "--ntokens",
            str(EVAL_SEQLEN * EVAL_WINDOWS)]
    ppl, launches = {}, None
    with _scratch_dir():
        for i, (label, flags) in enumerate(EVAL_ROUTES):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(every)
            t0 = time.perf_counter()
            r = evaluate.main(argv + flags)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts(every)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ppl[i] = r["ppl"]
            per_window = {k: counts[k] / r["windows"] for k in kernels}
            log(f"  route {i + 1}, {label}: PPL {r['ppl']!r}; "
                f"quantize {r['quantize_s']!r} s; "
                f"{1e3 * r['ppl_s'] / r['windows']:.1f} ms a window "
                f"({r['windows']} windows); {wall:.1f} s in all; peak "
                f"device memory {peak:.3f} GiB; launches a window "
                f"{per_window}")
            if not (np.isfinite(r["ppl"]) and r["ppl"] > 1):
                failures.append(f"{tag} route {i + 1}: PPL {r['ppl']}")
            _check_path(counts, kernels if i == 3 else (), None,
                        f"{tag} route {i + 1}", failures)
            if i == 3:
                launches = counts
                log(f"  launches in the packed route: {counts}")
            del r

    flips = _one_layer_packed_vs_fake(cfg, tag, failures)
    real_dense, real_q_linear = llama.dense_attention, quantized._q_linear
    depth = f"{cfg.num_layers} layers"

    # full depth: the packed PPL against the fake row route's; the floor,
    # two draws of the fake route flipped alike
    floors = []
    with _scratch_dir(), flips():
        for _ in range(2):
            gc.collect()
            torch.cuda.empty_cache()
            floors.append(evaluate.main(argv + EVAL_ROUTES[2][1])["ppl"])
    rel = _ppl_rel(ppl[3], ppl[2])
    floor = max(_ppl_rel(d, ppl[2]) for d in floors)
    bar = max(0.01, floor)
    ok = rel <= bar
    log(f"  {depth}: packed PPL {ppl[3]!r} against fake row {ppl[2]!r}: "
        f"{rel:.4%} apart; the fake row route's floor draws {floors} are "
        f"up to {floor:.4%} from it (bar: 1%, or the floor where higher, "
        f"{bar:.4%}) {'ok' if ok else 'FAIL'}; BF16 {ppl[0]!r}, fake "
        f"tensor {ppl[1]!r}")
    if not ok:
        failures.append(f"{tag} packed PPL {ppl[3]} vs fake row "
                        f"{ppl[2]}: {rel:.4%} > {bar:.4%}")

    # the fake row route with the packed route's epilogue order, (y gx)
    # gw in place of y (gx gs): how much of the packed-vs-fake gap the
    # order alone makes
    def packed_order_q_linear(qp, xa, gx, out_dtype):
        if not (isinstance(qp, dict) and "w_aug" in qp):
            return real_q_linear(qp, xa, gx, out_dtype)
        y = gk.matmul_f32(xa.to(torch.bfloat16), qp["w_aug"].t())
        y = (y * gx) * qp["gs"]
        if "b" in qp:
            y = y + qp["b"].float()
        return y.to(out_dtype)

    gc.collect()
    torch.cuda.empty_cache()
    quantized._q_linear = packed_order_q_linear
    try:
        with _scratch_dir():
            ordered = evaluate.main(argv + EVAL_ROUTES[2][1])["ppl"]
    finally:
        quantized._q_linear = real_q_linear
    log(f"  {depth}, the fake row route with the packed epilogue order (y "
        f"gx) gw: PPL {ordered!r}, {_ppl_rel(ordered, ppl[2]):.4%} from fake "
        f"row, {_ppl_rel(ordered, ppl[3]):.4%} from packed")

    # the packed route with the fake route's attention (f32 dense, scaled
    # after the scores), then with #9's plain version (q scaled first, the
    # JAX flash kernel's formula): which attention makes the gap
    def dense_flash(q, k, v, q_offset=0):
        return real_dense(q, llama.repeat_kv(k, cfg.num_kv_groups),
                          llama.repeat_kv(v, cfg.num_kv_groups), causal=True)

    packed_with = {}
    for what, mod, name, fn in (
            ("f32 dense attention", attention, "flash_attention",
             dense_flash),
            ("#9's plain version", attention, "_flash_cuda",
             attention.flash_attention_plain)):
        gc.collect()
        torch.cuda.empty_cache()
        real = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            with _scratch_dir():
                packed_with[what] = evaluate.main(argv + EVAL_ROUTES[3][1])[
                    "ppl"]
        finally:
            setattr(mod, name, real)
        log(f"  {depth}, the packed route with {what} in place of #9: PPL "
            f"{packed_with[what]!r}, {_ppl_rel(packed_with[what], ppl[2]):.4%}"
            f" from fake row, {_ppl_rel(packed_with[what], ppl[3]):.4%} from "
            f"packed")

    # #9 at the evaluate shape: B 1, T 2048, causal
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, EVAL_SEQLEN, h, cfg.head_dim)).astype(np.float32)).to(
            torch.bfloat16).cuda()
        for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    y = attention._flash_cuda(q, k, v)
    ref = attention.flash_attention_plain(q, k, v)
    ok = close_bound(y, ref)
    timer = Timer(REPS)
    ms = timer(lambda: attention._flash_cuda(q, k, v)).median
    plain_ms = timer(lambda: attention.flash_attention_plain(q, k, v)).median
    err = float((y.float() - ref.float()).abs().max())
    log(f"  #9 flash attention at B 1, T {EVAL_SEQLEN} (causal, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads): max abs err {err:.3g} "
        f"against flash_attention_plain (bar: 1 bf16 ulp + 2e-3) "
        f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not ok:
        failures.append(f"{tag} flash attention at T {EVAL_SEQLEN} against "
                        f"plain")
    log(f"  {tag} took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def generate_run(card, failures):
    """[generate]: ``python -m arcquant_tpu_torch.generate --model
    qwen2.5-7b`` with three --tokens prompts (GEN_PROMPT_LENS) and
    --max_new 8 as a subprocess; it must exit 0 and print, for each
    prompt, the tokens that InferenceEngine.generate gives on the same
    dummy engine (generate's seed, calibration and qcfg) here."""
    import subprocess

    from arcquant_tpu_torch import generate
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import quantized

    t_phase = time.perf_counter()
    cfg = get_model_config(MODEL)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in GEN_PROMPT_LENS]
    cmd = [sys.executable, "-m", "arcquant_tpu_torch.generate", "--model",
           MODEL, "--max_new", str(GEN_NEW_TOKENS)]
    for p in prompts:
        cmd += ["--tokens", ",".join(map(str, p))]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    printed = [json.loads(ln.split("] ", 1)[1])
               for ln in out.stdout.splitlines() if ln.startswith("[")]
    log(f"  python -m arcquant_tpu_torch.generate (3 prompts of "
        f"{GEN_PROMPT_LENS} tokens, 8 new): exit {out.returncode} in "
        f"{wall:.1f} s; printed {printed}")
    if out.returncode != 0:
        failures.append(f"[generate] exit {out.returncode}: "
                        f"{out.stderr[-2000:]}")
        return
    args = generate.build_parser().parse_args(["--model", MODEL])
    eng = InferenceEngine.dummy(
        cfg, quantized.identity_calib(cfg, args.select_frac, device="cuda"),
        generate.qcfg_of(args), EngineConfig(max_batch=args.max_batch,
                                             max_seq_len=args.max_seq_len),
        seed=args.seed, device="cuda")
    want = eng.generate(prompts, GEN_NEW_TOKENS)
    ok = printed == want
    log(f"  InferenceEngine.generate on the same engine: {want} "
        f"{'equal' if ok else 'DIFFERENT'}")
    if not ok:
        failures.append(f"[generate] printed {printed} != engine {want}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  [generate] took {time.perf_counter() - t_phase:.1f} s on {card}")


CALIB_SAMPLES, CALIB_SEQLEN, CALIB_SELECT_BATCH = 128, 2048, 32
CALIB_CUT = 2
# the [calibrate] A/B of #9 against its plain version: the select counts
# must be equal, every stat within this of the plain run's (relative: 8
# bf16 ulps; on an H100 the max stats move by up to 1.5%, #9's outputs
# an ulp from the plain version's and their echo in the next sites), and
# no two channels whose plain stats are more than twice this apart
# swapped
CALIB_ORDER_RTOL = 2.0 ** -5
# [calib_serve]: planted outlier channels (embedding columns 0::7 x 8) on
# a 2-layer cut, 4 x 512 tokens
ARC_CLAIM_TOKENS = (4, 512)


def _valid_calib(cfg, calib, stats, what, failures):
    """Every site's reorder index a permutation sorting its stat
    ascending, its select count a multiple of 64 in [0, K]."""
    for li, layer in enumerate(calib):
        for site, sc in layer.items():
            k = sc.reorder_index.shape[0]
            idx = sc.reorder_index.long()
            st = stats[li][site][idx] if stats is not None else None
            ok = (bool(torch.equal(torch.sort(idx).values,
                                   torch.arange(k, device=idx.device)))
                  and sc.select_num % 64 == 0 and 0 <= sc.select_num <= k
                  and (st is None or (bool(torch.isfinite(st).all())
                                      and bool((st[1:] >= st[:-1]).all()))))
            if not ok:
                failures.append(f"{what}: layer {li} {site} select "
                                f"{sc.select_num}, not a valid ascending "
                                "permutation")


def _selects(layer) -> dict:
    return {s: c.select_num for s, c in layer.items()}


def _order_agrees(kc, ps) -> tuple:
    """(channels out of place, mean window): #9's reorder index kc against
    the plain run's stat ps. A channel's rank in kc must lie in its
    window: after every channel whose plain stat is more than 2 x
    CALIB_ORDER_RTOL below its own and before every one more than that
    above (when no stat moves by more than CALIB_ORDER_RTOL between the
    runs, such pairs cannot swap)."""
    k = ps.shape[0]
    rank = torch.empty(k, dtype=torch.long, device=ps.device)
    rank[kc.long()] = torch.arange(k, device=ps.device)
    s = torch.sort(ps.double()).values
    band = 2 * CALIB_ORDER_RTOL * ps.double().abs()
    lo = torch.searchsorted(s, ps.double() - band)
    hi = torch.searchsorted(s, ps.double() + band, right=True) - 1
    out = int(((rank < lo) | (rank > hi)).sum())
    return out, float((hi - lo + 1).double().mean())


def calibrate_run(card, workdir, failures, model=MODEL, tag="[calibrate]"):
    """[calibrate] (and [moe_calibrate]): ``python -m
    arcquant_tpu_torch.calibrate --model <model> --dataset synthetic
    --act_sort_metric max`` (calibrate.main) at the reference protocol,
    128 samples x 2048 tokens, select_batch 32, dummy weights from seed 0
    streamed a layer at a time, writing its .npz into workdir: the
    seconds, the peak device memory, #9's launches (one a layer a chunk of
    4 samples, no other kernel), the average bits, the select counts of
    the first and last layers, and the artifact's validity (every site of
    quant_sites: five a layer on an MoE model). Then #9 at that shape (B
    4, T 2048) against its plain version, timed beside its bound and
    SDPA. Then on a 2-layer cut (the same weights' first layers): hessian
    and score, and max with #9 swapped for flash_attention_plain, whose
    select counts must equal #9's and whose reorder index must equal #9's
    wherever the plain run's adjacent sorted stats are more than
    CALIB_ORDER_RTOL apart. On an MoE model the plain run's router is fed
    the #9 run's top-k sets, as the engine checks feed the same tokens:
    #9's ulps move some router logits across the k-th largest, and one
    token routed elsewhere changes an expert's inputs, and so a channel's
    max, by far more than the ulps do; the tokens whose set the plain
    router would change are counted. Returns (calib, launch counts, #9's
    row)."""
    from arcquant_tpu_torch import calibrate
    from arcquant_tpu_torch.calib import (compute_calibration,
                                          load_calibration,
                                          load_calibration_meta)
    from arcquant_tpu_torch.calib import calibrate as cal
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.evals import get_calib_samples
    from arcquant_tpu_torch.kernels import attention
    from arcquant_tpu_torch.models import moe, quantized

    t_phase = time.perf_counter()
    cfg = get_model_config(model)
    kernels = all_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    r = calibrate.main([
        "--model", model, "--dataset", "synthetic", "--act_sort_metric",
        "max", "--samples", str(CALIB_SAMPLES), "--seqlen",
        str(CALIB_SEQLEN), "--select_batch", str(CALIB_SELECT_BATCH),
        "--output", workdir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    chunks = -(-CALIB_SAMPLES // max(1, cal._CHUNK_TOKENS // CALIB_SEQLEN))
    want9 = cfg.num_layers * chunks
    calib = load_calibration(r["path"], device="cuda")
    meta = load_calibration_meta(r["path"])
    log(f"  python -m arcquant_tpu_torch.calibrate --model {model} "
        f"--dataset synthetic --act_sort_metric max --samples "
        f"{CALIB_SAMPLES} --seqlen {CALIB_SEQLEN} --select_batch "
        f"{CALIB_SELECT_BATCH}: calibration pass {r['seconds']:.2f} s "
        f"({wall:.2f} s with the dummy weights and samples), peak device "
        f"memory {peak:.3f} GiB; #9 launches {counts['flash_attn']} (want "
        f"{want9}: {cfg.num_layers} layers x {chunks} chunks of "
        f"{CALIB_SAMPLES // chunks} samples); average bits "
        f"{r['avg_bits']:.4f}; select counts layer 0 "
        f"{_selects(calib[0])}, layer {cfg.num_layers - 1} "
        f"{_selects(calib[-1])}; {r['path']}")
    log(f"  select counts by layer: "
        f"{[list(_selects(l).values()) for l in calib]}")
    if counts["flash_attn"] != want9:
        failures.append(f"{tag} #9 launched {counts['flash_attn']} "
                        f"times, not {want9}")
    _check_path(counts, ("flash_attn",), None, tag, failures)
    want_meta = {"model": model, "dataset": "synthetic", "metric": "max",
                 "samples": CALIB_SAMPLES, "seqlen": CALIB_SEQLEN,
                 "average_bits": r["avg_bits"]}
    sites = set(quantized.quant_sites(cfg))
    if (meta != want_meta or len(calib) != cfg.num_layers
            or any(set(layer) != sites for layer in calib)
            or not 4.5 <= r["avg_bits"] < 9.0):
        failures.append(f"{tag} artifact: meta {meta}, {len(calib)} "
                        f"layers, sites {set(calib[0])}, {r['avg_bits']} "
                        f"bits")
    _valid_calib(cfg, calib, r["stats"],
                 f"{tag} {cfg.num_layers} layers, max", failures)
    del r

    # #9 at the calibration shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    b, t = max(1, cal._CHUNK_TOKENS // CALIB_SEQLEN), CALIB_SEQLEN
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = bf16_randn(gen, (b, t, hq, dh), 2.0)
    k_ = bf16_randn(gen, (b, t, hkv, dh), 2.0)
    v = bf16_randn(gen, (b, t, hkv, dh))
    o = attention._flash_cuda(q, k_, v)
    ref = attention.flash_attention_plain(q, k_, v)
    ok = close_bound(o, ref)
    timer = Timer(REPS)
    ms = timer(lambda: attention._flash_cuda(q, k_, v)).median
    plain_ms = timer(lambda: attention.flash_attention_plain(q, k_, v)).median
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k_, v))
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)).median
    bound, by = bound_ms(4.0 * b * hq * dh * t * (t + 1) / 2,
                         nbytes(q, k_, v, o))
    err = float((o.float() - ref.float()).abs().max())
    row9 = dict(shape=f"B={b} T={t} H={hq}/{hkv} causal", ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, max_abs_err=err, launches=counts["flash_attn"])
    log(f"  #9 flash attention at B {b}, T {t} ({hq}/{hkv} heads, causal): "
        f"max abs err {err:.3g} against flash_attention_plain (bar: 1 bf16 "
        f"ulp + 2e-3) {'ok' if ok else 'FAIL'}; {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bound:.4f} ms "
        f"({by})")
    if not ok:
        failures.append(f"{tag} #9 at B {b}, T {t} against plain")
    del q, k_, v, o, ref, qt, kt, vt

    # the 2-layer cut: hessian and score; max with #9 and with plain
    cfg2 = cfg.replace(num_layers=CALIB_CUT)
    tokens = get_calib_samples("synthetic", None, CALIB_SAMPLES,
                               CALIB_SEQLEN, cfg.vocab_size, 0)

    def run(metric):
        params = calibrate.dummy_params(cfg2, 0, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = compute_calibration(cfg2, params, tokens, metric,
                                  CALIB_SELECT_BATCH, device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for metric in ("hessian", "score"):
        (c2, st2, bits2), sec = run(metric)
        log(f"  {CALIB_CUT}-layer cut, {metric}: {sec:.2f} s, average bits "
            f"{bits2:.4f}, select counts {[_selects(l) for l in c2]}")
        _valid_calib(cfg2, c2, st2, f"{tag} {CALIB_CUT} layers, {metric}",
                     failures)
    # the #9 run's top-k sets in call order, replayed in the plain run
    real_route, sets, moved = moe.route, [], [0]

    def record(cfg_, w, x2):
        cw = real_route(cfg_, w, x2)
        sets.append(cw > 0)
        return cw

    def replay(cfg_, w, x2):
        cw, chosen = real_route(cfg_, w, x2), sets.pop(0)
        moved[0] += int(((cw > 0) != chosen).any(-1).sum())
        probs = torch.softmax(x2.float() @ w.float().t(), dim=-1)
        cw = torch.where(chosen, probs, torch.zeros_like(probs))
        if cfg_.norm_topk_prob:
            cw = cw / cw.sum(dim=-1, keepdim=True)
        return cw

    flash = attention._flash_cuda
    try:
        moe.route = record
        (kc, ks, kbits), ksec = run("max")
        moe.route = replay
        attention._flash_cuda = attention.flash_attention_plain
        (pc, ps, pbits), psec = run("max")
    finally:
        attention._flash_cuda, moe.route = flash, real_route
    if cfg.num_experts:
        log(f"  {CALIB_CUT}-layer cut, max: tokens whose top-k set the "
            f"plain run's router would choose otherwise (it is fed the #9 "
            f"run's): {moved[0]}, over {CALIB_CUT} layers x "
            f"{CALIB_SAMPLES * CALIB_SEQLEN} tokens")
    report, ok = [], kbits == pbits
    for li in range(CALIB_CUT):
        for site in kc[li]:
            out, window = _order_agrees(kc[li][site].reorder_index,
                                        ps[li][site])
            rel = float(((ks[li][site] - ps[li][site]).abs()
                         / ps[li][site].abs().clamp_min(1e-30)).max())
            same_sel = kc[li][site].select_num == pc[li][site].select_num
            ok = ok and same_sel and out == 0 and rel <= CALIB_ORDER_RTOL
            report.append(f"L{li} {site}: select {kc[li][site].select_num}"
                          f"/{pc[li][site].select_num}, stats max rel "
                          f"{rel:.2e}, {out} channels out of their window "
                          f"(mean {window:.1f} of "
                          f"{ps[li][site].shape[0]} ranks)")
    log(f"  {CALIB_CUT}-layer cut, max with #9 ({ksec:.2f} s) against "
        f"flash_attention_plain ({psec:.2f} s): {'; '.join(report)} (bar: "
        f"equal select counts and bits, stats within "
        f"{CALIB_ORDER_RTOL:.4g} relative, every channel ranked after all "
        f"stats more than {2 * CALIB_ORDER_RTOL:.4g} below its own and "
        f"before all more than that above) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{tag} #9 vs plain on the cut: {report}")
    log(f"  {tag} took {time.perf_counter() - t_phase:.1f} s on {card}")
    return calib, counts, row9


def init_params_engine(cfg, calib, qcfg, ecfg, seed=0, **kw):
    """An InferenceEngine on llama.init_params' weights from `seed` on the
    card (the weights python -m arcquant_tpu_torch.calibrate calibrates),
    each layer packed as it is drawn, so the bf16 model never exists at
    once."""
    from arcquant_tpu_torch.engine import InferenceEngine
    from arcquant_tpu_torch.models import llama, quantized

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device="cuda") * 0.02).to(torch.bfloat16)
    qparams = {"embed": normal((cfg.vocab_size, cfg.hidden_size)),
               "final_norm": torch.ones((cfg.hidden_size,),
                                        dtype=torch.bfloat16, device="cuda")}
    qparams["layers"] = [quantized.quantize_layer_params_fused(
        llama.init_layer_params(cfg, gen, device="cuda"), calib[i], qcfg)
        for i in range(cfg.num_layers)]
    if not cfg.tie_embeddings:
        qparams["lm_head"] = normal((cfg.vocab_size, cfg.hidden_size))
    return InferenceEngine(cfg, qparams, calib, qcfg, ecfg, device="cuda",
                           quantize_params=False, **kw)


def _serve_timing(eng, prompts):
    """(prefill ms, decode ms/step, finite): a one-shot prefill of
    `prompts`, then NEW_TOKENS greedy decode steps replaying the captured
    step (captured before the clock starts)."""
    toks, lens, _ = eng._pad_prompts(prompts)
    state = eng.new_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = eng.prefill(state, toks, lens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(logits).all())
    cur = logits.argmax(-1).to(torch.int32)
    active = torch.ones(len(prompts), dtype=torch.bool)
    capture(eng, state)
    t0 = time.perf_counter()
    for _ in range(NEW_TOKENS):
        logits, state = eng.decode_step(state, cur, active)
        cur = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    dec = (time.perf_counter() - t0) * 1e3 / NEW_TOKENS
    finite = finite and bool(torch.isfinite(logits).all())
    return prefill_ms, dec, finite


def calib_serve_run(card, calib, failures, model=MODEL,
                    busy=GENERATE_KERNELS, idle=ARC_IDLE_KERNELS,
                    tag="[calib_serve]"):
    """[calib_serve] (and [moe_calib_serve]): the calibrate_run artifact
    served by InferenceEngine on `model` at full width and depth, on the
    weights it was calibrated on (w8, per-row activation and per-channel
    weight scales, packed head): bs 4, prompts of 1024 tokens, a one-shot
    prefill and NEW_TOKENS decode steps on the graph, with the launch
    counts (the path: each of `busy` launched, each of `idle` not),
    prefill ms and decode ms/step beside the same engine on
    identity_calib(0.125) (the same weights, in turns: calibrated,
    identity, calibrated, identity); then [graph] on the calibrated
    engine (graph bitwise the eager loop); the engine cut to 1 and 2
    layers with the artifact's first layers against the plain versions
    (engine_vs_plain with moe_engine_check's floor of GEMM and paged
    decode noise, at most 0.999: the kernels at the Kq the artifact
    gives); and ARC's own claim: on a 2-layer cut with planted outlier
    channels (embedding columns 0::7 x 8), calibrated there (#9), the
    packed forward's logits MSE against the bf16 forward below select
    0's. Returns the path's launch counts."""
    from arcquant_tpu_torch.calib import compute_calibration
    from arcquant_tpu_torch.config import QuantConfig, get_model_config
    from arcquant_tpu_torch.engine import EngineConfig
    from arcquant_tpu_torch.evals import synthetic_stream
    from arcquant_tpu_torch.models import llama, quantized

    t_phase = time.perf_counter()
    cfg = get_model_config(model)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    prompts = [np.random.default_rng(3 + i).integers(
        0, cfg.vocab_size, 1024).tolist() for i in range(4)]
    ecfg = EngineConfig(max_batch=4, max_seq_len=1024 + NEW_TOKENS + 8)
    ident = quantized.identity_calib(cfg, SELECT_FRAC, device="cuda")
    kernels = all_kernels()
    engines, times = {}, {"calibrated": [], "identity 0.125": []}
    for name, c in (("calibrated", calib), ("identity 0.125", ident)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        engines[name] = init_params_engine(cfg, c, qcfg, ecfg)
        torch.cuda.synchronize()
        kq = {k: v.kq for k, v in engines[name].qparams["layers"][0].items()
              if hasattr(v, "kq")}
        log(f"  {name}: engine built in {time.perf_counter() - t0:.1f} s, "
            f"{_weight_gib(engines[name].qparams):.3f} GiB packed, Kq by "
            f"linear in layer 0 {kq}")
    reset_counts(kernels)
    out = engines["calibrated"].generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    log(f"  launches in the calibrated engine's generate() (4 x 1024, "
        f"{NEW_TOKENS} tokens): {launches}; first tokens "
        f"{[o[:6] for o in out]}")
    _check_path(launches, busy, idle, f"{tag} the calibrated engine",
                failures)
    if [len(o) for o in out] != [NEW_TOKENS] * 4:
        failures.append(f"{tag} generate lengths {out}")
    for rnd in range(2):
        for name, eng in engines.items():
            eng.drop_graphs()
            pre, dec, fin = _serve_timing(eng, prompts)
            times[name].append((round(pre, 3), round(dec, 3)))
            if not fin:
                failures.append(f"{tag} {name}: non-finite logits")
    log(f"  prefill ms and decode ms/step (bs 4, 1024-token prompts, "
        f"{NEW_TOKENS} steps on the graph), in turns, on {card}: {times}")
    graph = graph_check(engines["calibrated"], f"{tag} calibrated ARC", card,
                        failures)
    log(f"  {tag} {json.dumps(dict(times=times, graph=graph))}")
    del engines, out
    gc.collect()
    torch.cuda.empty_cache()

    ecfg1 = EngineConfig(max_batch=len(PROMPT_LENS),
                         max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    for layers in (1, 2):
        cfg_l = cfg.replace(num_layers=layers)
        eng = init_params_engine(cfg_l, calib[:layers], qcfg, ecfg1)
        sel = [list(_selects(layer).values()) for layer in calib[:layers]]
        engine_vs_plain(eng, f"calibrated {layers}-layer w8 (selects {sel})",
                        failures, paged_floor=True)
        del eng

    # ARC's claim on planted outliers
    cfg2 = cfg.replace(num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg2, gen, device="cuda")
    params["embed"][:, 0::7] *= 8.0
    b, t = ARC_CLAIM_TOKENS
    toks = torch.from_numpy(synthetic_stream(cfg.vocab_size, b * t, 7)
                            .reshape(b, t)).cuda()
    with torch.inference_mode():
        ref = llama.model_forward(cfg2, params, toks.long())
    c_real, _, bits = compute_calibration(cfg2, params, toks, device="cuda")
    aqcfg = QuantConfig(use_kernels=True, act_scale="row")

    def mse(c):
        qp = quantized.quantize_model_params(cfg2, params, c, aqcfg)
        with torch.inference_mode():
            y = quantized.quant_model_forward(cfg2, qp, c, aqcfg, toks)
        return float(((y.double() - ref.double()) ** 2).mean())
    mse0 = mse(quantized.identity_calib(cfg2, 0.0, device="cuda"))
    mse_arc = mse(c_real)
    ok = np.isfinite(mse0) and np.isfinite(mse_arc) and mse_arc < mse0
    log(f"  ARC on planted outliers ({cfg2.num_layers} layers, {b} x {t} "
        f"tokens, embedding columns 0::7 x 8, packed w8 at row scales): "
        f"logits MSE against bf16 {mse_arc:.6g} with the calibration "
        f"(selects {[_selects(l) for l in c_real]}, {bits:.3f} bits) "
        f"against {mse0:.6g} with select 0 (bar: below) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{tag} ARC MSE {mse_arc} vs select 0 {mse0}")
    del params, ref
    log(f"  {tag} took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


CKPT_LAYERS = 2
_HF_NAMES = {"attn_norm": "input_layernorm",
             "mlp_norm": "post_attention_layernorm",
             "q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}


def _hf_tensors(params) -> dict:
    """A dense llama.init_params tree under its HuggingFace names."""
    t = {"model.embed_tokens.weight": params["embed"],
         "model.norm.weight": params["final_norm"]}
    for i, lp in enumerate(params["layers"]):
        for k, v in lp.items():
            pre = f"model.layers.{i}.{_HF_NAMES[k]}"
            if torch.is_tensor(v):
                t[pre + ".weight"] = v
            else:
                t[pre + ".weight"] = v["w"]
                if "b" in v:
                    t[pre + ".bias"] = v["b"]
    if "lm_head" in params:
        t["lm_head.weight"] = params["lm_head"]
    return t


def _tree_leaves(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, f"{name}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{name}.{i}")
    else:
        yield name, tree


def _same_tree(a, b) -> list:
    """The leaves of two trees (NamedTuples included) that differ in name,
    type, dtype, shape or bytes."""
    la, lb = dict(_tree_leaves(a)), dict(_tree_leaves(b))
    bad = sorted(set(la) ^ set(lb))
    for k in set(la) & set(lb):
        x, y = la[k], lb[k]
        if torch.is_tensor(x) and torch.is_tensor(y):
            if not (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.reshape(-1).view(torch.uint8),
                                    y.reshape(-1).view(torch.uint8))):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad


def ckpt_run(card, workdir, failures):
    """[ckpt]: a random 2-layer checkpoint at Qwen2.5-7B widths (qkv bias,
    untied head, bf16; dummy weights from seed 21, non-zero biases)
    written as a HuggingFace directory (two safetensors shards and
    config.json) by the port's own writer, then loaded (models/hf.py)
    bitwise the tensors written; python -m arcquant_tpu_torch.generate
    --model <dir> with three --tokens prompts (generate.main, its printed
    tokens against InferenceEngine.generate on the loaded weights) and
    evaluate --model <dir> --eval_ppl --dataset synthetic (--use_kernels
    --act_scale row, 2 windows of 2048) on it; then the engine's packed w8
    tree through save_quantized / load_quantized: bitwise, and the same
    greedy tokens from an InferenceEngine on the loaded tree; the seconds
    to quantize (the engine built from the bf16 weights) against the
    seconds to load (load_quantized and the engine built on it). Returns
    the path's launch counts (generate, evaluate, the two engines)."""
    import io
    import os

    from arcquant_tpu_torch import evaluate, generate
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import hf, llama, quantized
    from arcquant_tpu_torch.utils import load_quantized, save_quantized
    from arcquant_tpu_torch.utils.safetensors_io import write_safetensors

    t_phase = time.perf_counter()
    cfg = get_model_config(MODEL).replace(num_layers=CKPT_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    params = llama.init_params(cfg, gen, device="cuda")
    for lp in params["layers"]:
        for p in ("q", "k", "v"):
            lp[p]["b"] = bf16_randn(gen, lp[p]["b"].shape, 0.1)
    tensors = _hf_tensors(params)
    d = os.path.join(workdir, f"{MODEL}-{CKPT_LAYERS}-layers")
    os.makedirs(d)
    names = list(tensors)
    t0 = time.perf_counter()
    for i, part in enumerate((names[:len(names) // 2],
                              names[len(names) // 2:])):
        write_safetensors(os.path.join(
            d, f"model-{i + 1:05d}-of-00002.safetensors"),
            {k: tensors[k] for k in part})
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(
            model_type="qwen2", vocab_size=cfg.vocab_size,
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_heads,
            num_key_value_heads=cfg.num_kv_heads, rope_theta=cfg.rope_theta,
            rms_norm_eps=cfg.rms_eps,
            max_position_embeddings=cfg.max_position_embeddings,
            tie_word_embeddings=False), f)
    write_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))
    t0 = time.perf_counter()
    lcfg, loaded = hf.load_hf_params(d, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bad = _same_tree(params, loaded)
    same_cfg = all(getattr(lcfg, f) == getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "rope_theta", "rms_eps", "qkv_bias",
        "tie_embeddings"))
    ok = not bad and same_cfg
    log(f"  HF directory ({CKPT_LAYERS} layers at {MODEL} widths, qkv bias, "
        f"untied head, 2 shards, {size / 2 ** 30:.3f} GiB) written in "
        f"{write_s:.2f} s by utils/safetensors_io.py, loaded in {load_s:.2f} "
        f"s: {len(dict(_tree_leaves(params)))} tensors, differing {bad}, "
        f"config equal {same_cfg} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[ckpt] load_hf_params: differing {bad}, config "
                        f"equal {same_cfg}")
    del params, tensors

    kernels = all_kernels()
    reset_counts(kernels)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in GEN_PROMPT_LENS]
    argv = ["--model", d, "--max_new", str(GEN_NEW_TOKENS)]
    for p in prompts:
        argv += ["--tokens", ",".join(map(str, p))]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        generate.main(argv)
    gen_s = time.perf_counter() - t0
    printed = [json.loads(ln.split("] ", 1)[1])
               for ln in buf.getvalue().splitlines() if ln.startswith("[")]
    args = generate.build_parser().parse_args(["--model", d])
    qcfg = generate.qcfg_of(args)
    ecfg = EngineConfig(max_batch=args.max_batch,
                        max_seq_len=args.max_seq_len)
    calib = quantized.identity_calib(lcfg, args.select_frac, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = InferenceEngine(lcfg, loaded, calib, qcfg, ecfg, device="cuda")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    del loaded
    want = eng.generate(prompts, GEN_NEW_TOKENS)
    ok = printed == want
    log(f"  generate --model <dir> ({len(prompts)} prompts of "
        f"{GEN_PROMPT_LENS} tokens, {GEN_NEW_TOKENS} new) in {gen_s:.2f} s: "
        f"{printed}; InferenceEngine.generate on the loaded weights {want} "
        f"{'equal' if ok else 'DIFFERENT'}")
    if not ok:
        failures.append(f"[ckpt] generate printed {printed} != {want}")
    with _scratch_dir():
        t0 = time.perf_counter()
        r = evaluate.main(["--model", d, "--eval_ppl", "--dataset",
                           "synthetic", "--seqlen", str(EVAL_SEQLEN),
                           "--ntokens", str(EVAL_SEQLEN * EVAL_WINDOWS),
                           "--use_kernels", "--act_scale", "row"])
        eval_s = time.perf_counter() - t0
    ok = np.isfinite(r["ppl"]) and r["ppl"] > 1
    log(f"  evaluate --model <dir> --eval_ppl --dataset synthetic "
        f"--use_kernels --act_scale row: PPL {r['ppl']!r} over "
        f"{r['windows']} windows of {EVAL_SEQLEN} in {eval_s:.2f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[ckpt] evaluate PPL {r['ppl']}")

    path = os.path.join(workdir, "quantized.safetensors")
    t0 = time.perf_counter()
    save_quantized(path, eng.qparams)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_quantized(path, device="cuda")
    eng2 = InferenceEngine(lcfg, back, calib, qcfg, ecfg, device="cuda",
                           quantize_params=False)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    bad = _same_tree(eng.qparams, back)
    got = eng2.generate(prompts, GEN_NEW_TOKENS)
    launches = launch_counts(kernels)
    ok = not bad and got == want
    log(f"  save_quantized / load_quantized of the engine's packed w8 tree "
        f"({os.path.getsize(path) / 2 ** 30:.3f} GiB): saved in {save_s:.2f}"
        f" s; differing leaves {bad}; the loaded engine's tokens "
        f"{'equal' if got == want else 'DIFFERENT'} "
        f"{'ok' if ok else 'FAIL'}. Seconds to quantize {quantize_s:.2f} "
        f"(the engine from bf16 weights on the card) against seconds to "
        f"load {restore_s:.2f} (load_quantized + the engine), on {card}")
    if not ok:
        failures.append(f"[ckpt] quantized checkpoint: differing {bad}, "
                        f"tokens {got} vs {want}")
    log(f"  launches in the [ckpt] path: {launches}")
    for name in ("actq", "gemm_w8", "flash_attn", "paged_decode"):
        if launches[name] <= 0:
            failures.append(f"[ckpt] kernel {name} not launched")
    del eng, eng2, back
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  [ckpt] took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def lab_run(card, failures):
    """The [lab] phase: the GEMM lab's script (benchmarks/gemm_lab.py) at
    Qwen2.5-7B's four decode sites at M 4, one process: exp_shapes
    (production w8 and w4 against bf16 torch.matmul and the bound), then
    every built lab variant of each format (tiles, depths, k splits, the
    rings) timed and checked against production, the fastest, and
    production, the fastest and the default tile re-timed in turns
    (best_by_site; bars: a variant that keeps production's k order gives
    its bits, the others, lab_w8_ring_n where production splits K and the
    other split counts, stay within the sum-order bound). Returns the
    launch counts over the phase."""
    from arcquant_tpu_torch.benchmarks import gemm_lab as bl

    lab = bl.Lab(log=log)
    kernels = all_kernels()
    reset_counts(kernels)
    bl.exp_shapes(lab)
    rows = bl.best_by_site(lab)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    log(f"  launches in the lab: {launches}")
    for name in LAB_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} not launched by the lab")
    for r in rows:
        bad = [w for w, (_, exact, must, close) in r["variants"].items()
               if not (exact if must else close)]
        if bad:
            failures.append(f"lab {r['site']} {r['fmt']}: not bitwise "
                            f"equal to production (or beyond the sum-order "
                            f"bound where the k order differs): {bad}")

    def ms(t):
        return dict(median=t.median, spread=[t.lo, t.hi])
    summary = [dict(site=r["site"], fmt=r["fmt"], best=r["best"],
                    exact=r["variants"][r["best"]][1],
                    **{f"{w}_ms": ms(t) for w, t in r["ab"].items()},
                    best_over_production=r["ab"]["best"].median
                    / r["ab"]["production"].median,
                    unheld_production_ms=r["unheld"]["production"].median,
                    unheld_best_ms=r["unheld"]["best"].median,
                    bound_ms=r["bound_ms"])
               for r in rows]
    log(f"  lab summary: {json.dumps(dict(sites=summary, card=card))}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def bench_e2e_run(card, failures):
    """The [bench_e2e] phase: benchmarks/benchmark_e2e.py's run() at
    Qwen2.5-7B, 28 layers, bs 4, prefill 1024, decode 32, warmup 1,
    repeats 3, first the north-star configuration (NVFP4 W4A4 select-free,
    w8, packed head), then --quant BF16; each with the script's lines, its
    JSON and the launch counts (BF16 launches the attention kernels and
    none of the quantize, GEMM, dequant or lab kernels). Returns
    {quant: launches}."""
    from arcquant_tpu_torch.benchmarks import benchmark_e2e as be

    paths = {}
    for quant, want, idle in (
            ("NVFP4", FREE_KERNELS, FREE_IDLE_KERNELS + LAB_KERNELS),
            ("BF16", BF16_KERNELS,
             tuple(k for k in KERNEL_INFO if k not in BF16_KERNELS))):
        args = be.build_parser().parse_args(
            ["--model", MODEL, "--batch_size", "4", "--prefill_seq_len",
             "1024", "--decode_steps", str(NEW_TOKENS), "--warmup", "1",
             "--repeats", "3", "--quant", quant])
        kernels = all_kernels()
        reset_counts(kernels)
        t0 = time.perf_counter()
        r = be.run(args)
        torch.cuda.synchronize()
        launches = launch_counts(kernels)
        log(f"  benchmark_e2e --quant {quant} ({r['layers']} layers) in "
            f"{time.perf_counter() - t0:.1f} s:")
        for line in be.lines(r):
            log(f"    {line}")
        log(f"  {json.dumps(be.public(r))}")
        log(f"  launches in benchmark_e2e --quant {quant}: {launches}")
        for name in want:
            if launches[name] <= 0:
                failures.append(f"kernel {name} not launched by "
                                f"benchmark_e2e --quant {quant}")
        for name in idle:
            if launches[name] != 0:
                failures.append(f"kernel {name} launched by benchmark_e2e "
                                f"--quant {quant}")
        if not (r["_tokens_valid"] and r["_logits_finite"]):
            failures.append(f"benchmark_e2e --quant {quant}: tokens valid "
                            f"{r['_tokens_valid']}, logits finite "
                            f"{r['_logits_finite']}")
        paths[quant] = launches
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def _halves(cfg, n, seed):
    """Prompts of n tokens whose second half repeats their first (n-gram
    drafts then match)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(len(PROMPT_LENS)):
        half = rng.integers(0, cfg.vocab_size, n // 2).tolist()
        out.append(half + half)
    return out


def spec_run(card, failures):
    """The [spec] phase at Qwen2.5-7B full width, 28 layers, dummy weights
    from seed 0, w8, pages of 128, batch 4:
      1. benchmarks/bench_spec.py's run() after a 1024-token prefill, W 2,
         4 and 8, select-free then ARC 0.125: decode ms/step, verify ms
         (device time of one graph replay each) and speedup at alpha 0.5
         and 1.0;
      2. on the ARC engine, SpeculativeEngine.generate_ondevice (n-gram
         drafts, W 4, SPEC_TOKENS greedy tokens) on prompts of 1024
         tokens whose halves repeat: the run replaying the captured round
         (its launches counted: the spec path) against the eager round
         loop (cuda_graphs=False), tokens and stats bitwise; against
         plain decode_scan (graph), the first divergent step of each row;
         rounds, acceptance, ms per committed token beside decode's
         ms/step (host wall times in turns spec, scan, prefill, scan,
         spec, prefill, twice, each side on one state emptied in place,
         no graph captured inside the clock; the means, each less the
         prefill's); then the verify logits at every position of
         decode's own greedy stream, fed W tokens a round, against
         decode's logits at the same position: the median cosine over
         the positions at or above the lowest of 4 draws' medians less
         their spread, each draw the same decode with its attention
         outputs an ulp apart on the share at which the paged prefill at
         Tq = W differs from the paged decode (phase 3), beside the same
         decode with the paged decode's plain version (for the record);
      3. serve.py's build_loop with --spec_window 4 (its defaults: W4A16
         chunked prefill, dynamic pages, ARC): four HTTP requests, each
         status 200 with its tokens, and /health's spec stats.
    Returns the launches over the spec path's run."""
    from arcquant_tpu_torch import serve
    from arcquant_tpu_torch.benchmarks import bench_spec as bs
    from arcquant_tpu_torch.engine import NgramDrafter, SpeculativeEngine
    from arcquant_tpu_torch.engine.server import make_server

    eng = None
    for sel in (0.0, SELECT_FRAC):
        args = bs.build_parser().parse_args(
            ["--model", MODEL, "--batch_size", "4", "--prefill_seq_len",
             "1024", "--windows", "2,4,8", "--select_frac", str(sel)])
        del eng
        torch.cuda.empty_cache()
        eng = bs.build_engine(args)
        r = bs.run(args, eng)
        for w, v in r["windows"].items():
            log(f"  bench_spec select_frac {sel}: W={w} decode "
                f"{r['decode_ms_per_step']:.4f} ms/step, verify "
                f"{v['verify_ms']:.4f} ms ({v['vs_decode']:.3f}x), speedup "
                f"alpha 0.5 {v['speedup']['alpha=0.5']}, alpha 1.0 "
                f"{v['speedup']['alpha=1.0']}")
        log(f"  {json.dumps(r)}")
    cfg = eng.cfg
    spec = SpeculativeEngine(eng, NgramDrafter(), window=4)
    prompts = _halves(cfg, 1024, seed=4)
    b = len(prompts)
    toks, lens, _ = eng._pad_prompts(prompts)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # plain decode runs on one state, emptied in place, as the spec
    # engine's runs do: each graph is captured once
    dstate = eng.new_state()

    def prefill():
        return eng.prefill(eng.reset_state(dstate), toks, lens)
    spec.generate_ondevice(prompts, SPEC_TOKENS)          # the capture
    kernels = all_kernels()
    reset_counts(kernels)
    got, spec_ms = timed(lambda: spec.generate_ondevice(prompts,
                                                        SPEC_TOKENS))
    launches = launch_counts(kernels)
    stats = dict(spec.stats)
    log(f"  launches in generate_ondevice: {launches}")
    for name in SPEC_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} not launched by "
                            "generate_ondevice")
    for name in SPEC_IDLE_KERNELS:
        if launches[name] != 0:
            failures.append(f"kernel {name} launched by generate_ondevice")
    eng.cuda_graphs = False
    loop_got = spec.generate_ondevice(prompts, SPEC_TOKENS)
    loop_stats = dict(spec.stats)
    eng.cuda_graphs = True
    same = got == loop_got and stats == loop_stats
    ok = (same and [len(o) for o in got] == [SPEC_TOKENS] * b
          and all(0 <= t < cfg.vocab_size for o in got for t in o))
    log(f"  generate_ondevice graph vs eager round loop: tokens and stats "
        f"equal {same} (bar: bitwise), {SPEC_TOKENS} tokens a row in the "
        f"vocabulary {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[spec] generate_ondevice graph vs loop: equal "
                        f"{same}, stats {stats} vs {loop_stats}")

    def scan():
        logits, state = prefill()
        first = logits.argmax(-1).to(torch.int32)
        out, _ = eng.decode_scan(state, first, lens > 0, SPEC_TOKENS - 1)
        return torch.cat([first[:, None], out], dim=1).tolist()
    scan()                                                  # the capture
    # host wall times in turns, four runs each; no run captures a graph
    runs = {"spec": lambda: spec.generate_ondevice(prompts, SPEC_TOKENS),
            "scan": scan, "prefill": prefill}
    turns = {k: [] for k in runs}
    n_cap = len(eng.graph_captures)
    for name in ("spec", "scan", "prefill", "scan", "spec", "prefill") * 2:
        out, ms = timed(runs[name])
        turns[name].append(round(ms, 3))
        if name == "scan":
            plain = out
    if len(eng.graph_captures) != n_cap:
        failures.append(f"[spec] {len(eng.graph_captures) - n_cap} graph "
                        "captures inside the timed runs")
    spec_ms, scan_ms, prefill_ms = (statistics.mean(turns[k])
                                    for k in ("spec", "scan", "prefill"))
    diverge = [next((j for j, (a, c) in enumerate(zip(g, p)) if a != c),
                    None) for g, p in zip(got, plain)]
    rounds = stats["rounds"]
    alpha = stats["accepted"] / max(stats["proposed"], 1)
    spec_tok_ms = (spec_ms - prefill_ms) / SPEC_TOKENS
    dec_ms = (scan_ms - prefill_ms) / (SPEC_TOKENS - 1)
    log(f"  spec vs plain decode_scan: first divergent step per row "
        f"{diverge} (None: equal over {SPEC_TOKENS} tokens)")

    # verify logits against decode logits on decode's own token stream
    logits, state = prefill()
    cur = logits.argmax(-1).to(torch.int32)
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    dec_logits, fed = [], []
    for _ in range(SPEC_TOKENS):
        fed.append(cur)
        lg, state = eng.decode_step(state, cur, active)
        dec_logits.append(lg.float().cpu())
        cur = lg.argmax(-1).to(torch.int32)
    _, state = prefill()
    w = spec.window
    ver_logits = []
    for j in range(0, SPEC_TOKENS, w):
        vt = torch.stack(fed[j:j + w], dim=1)
        vlog, state = eng.verify_step(state, vt, torch.full((b,), w))
        state[2].add_(w)
        ver_logits += [vlog[:, i].float().cpu() for i in range(w)]
    # the floor: the same decode (eager: a graph keeps its kernel) with
    # the paged decode's outputs an ulp apart on the share at which the
    # paged prefill at Tq = W and the paged decode of the same queries
    # differ (phase 3), four draws; for the record, the same decode with
    # another correct attention, the paged decode's plain version
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    share = VERIFY_ULP_SHARE[w]["decode"]
    eng.cuda_graphs = False
    real = pdk._paged_decode_cuda

    def decode_with(attention):
        pdk._paged_decode_cuda = attention
        try:
            _, state = prefill()
            out = []
            for cur in fed:
                lg, state = eng.decode_step(state, cur, active)
                out.append(lg.float().cpu())
            return out
        finally:
            pdk._paged_decode_cuda = real
    try:
        ref_logits = decode_with(pdk.paged_decode_state_plain)
        draws = []
        for seed in range(4):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(20 + seed)
            draws.append(decode_with(_flipped_attention(real, gen, share)))
    finally:
        eng.cuda_graphs = True
    del state, vlog

    def against_decode(outs):
        cos = [_cosine(a, d) for a, d in zip(outs, dec_logits)]
        same = sum(int(torch.equal(a.argmax(-1), d.argmax(-1)))
                   for a, d in zip(outs, dec_logits))
        return dict(first_round=[round(c, 6) for c in cos[:w]],
                    min=round(min(cos), 6),
                    median=round(statistics.median(cos), 6),
                    argmax_equal=f"{same} of {len(cos)}")
    ver = against_decode(ver_logits)
    meds = [against_decode(d)["median"] for d in draws]
    bar = min(meds) - (max(meds) - min(meds))
    metrics = dict(
        rounds=rounds, proposed=stats["proposed"],
        accepted=stats["accepted"], acceptance=round(alpha, 4),
        tokens_per_round=round(SPEC_TOKENS / max(rounds, 1), 3),
        wall_ms_in_turns=turns,
        spec_ms_per_token=round(spec_tok_ms, 3),
        decode_ms_per_step=round(dec_ms, 3), first_divergent_step=diverge,
        verify_vs_decode=ver, ulp_share=share,
        ulp_flip_decode_vs_decode=[against_decode(d) for d in draws],
        plain_attention_decode_vs_decode=against_decode(ref_logits),
        card=card)
    log(f"  generate_ondevice ARC W {w} {cfg.num_layers} layers bs=4: "
        f"{json.dumps(metrics)}")
    ok = ver["median"] >= bar
    log(f"  verify vs decode logits over the {SPEC_TOKENS} positions: "
        f"median cosine {ver['median']} (bar: >= {bar:.6f}, the lowest "
        f"median of 4 draws of decode with {share:.4%} of its attention "
        f"outputs an ulp apart, {sorted(meds)}, less their spread) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[spec] verify vs decode median cosine "
                        f"{ver['median']} < {bar}")
    gc.collect()
    del eng, spec
    torch.cuda.empty_cache()

    args = serve.build_parser().parse_args(
        ["--model", MODEL, "--dynamic_pages", "--max_batch", "4",
         "--spec_window", "4"])
    loop = serve.build_loop(args)
    srv = make_server(loop, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    bodies = [dict(prompt=p, max_tokens=NEW_TOKENS)
              for p in _halves(cfg, 700, seed=5)]
    kernels = all_kernels()
    reset_counts(kernels)
    t0 = time.perf_counter()
    clients = [Client(srv.server_address[1], body) for body in bodies]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_launches = launch_counts(kernels)
    health = _get_stats(srv.server_address[1])
    srv.shutdown()
    srv.server_close()
    loop.shutdown()
    for c in clients:
        o, tk = c.out, c.out["tokens"] or []
        if (o["status"] != 200 or o["error"] or len(tk) != NEW_TOKENS
                or not all(0 <= t < cfg.vocab_size for t in tk)):
            failures.append(f"[spec] serve --spec_window 4: {o}")
    sp = health.get("stats", {}).get("spec", {})
    if not sp.get("rounds"):
        failures.append(f"[spec] /health has no spec stats: {health}")
    log(f"  serve --spec_window 4: statuses "
        f"{[c.out['status'] for c in clients]}, {len(bodies)} requests of "
        f"{NEW_TOKENS} tokens in {wall:.3f} s, /health spec {sp}, "
        f"launches {serve_launches}")
    del loop, srv
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _moe_generate(eng, cfg, fmt, card, failures):
    """generate() on the PROMPT_LENS prompts with each kernel's launches
    and the decode steps counted, then a timed prefill and NEW_TOKENS
    decode steps. Returns (launches, metrics, tokens, lens)."""
    prompts = prompts_for(cfg)
    steps = []
    inner = eng.decode_step
    eng.decode_step = lambda *a: steps.append(1) or inner(*a)
    kernels = all_kernels()
    reset_counts(kernels)
    n_cap = len(eng.graph_captures)
    out = eng.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    del eng.decode_step
    # a capture's warm-up step is a dense-mode forward too
    forwards = len(steps) + len(eng.graph_captures) - n_cap
    log(f"  launches in generate(): {launches}")
    what = f"the MoE {fmt} generate()"
    for name in MOE_KERNELS[fmt]:
        if launches[name] <= 0:
            failures.append(f"kernel {name} not launched by {what}")
    for name in MOE_IDLE_KERNELS[fmt]:
        if launches[name] != 0:
            failures.append(f"kernel {name} launched by {what}")
    want = cfg.num_layers * forwards
    log(f"  gemm_batched launches {launches['gemm_batched']} over "
        f"{len(steps)} decode steps and {forwards - len(steps)} capture "
        f"warm-up step(s) of {cfg.num_layers} layers (bar: exactly "
        f"{want}, one a layer a dense-mode forward) "
        f"{'ok' if launches['gemm_batched'] == want else 'FAIL'}")
    if launches["gemm_batched"] != want:
        failures.append(f"{what}: gemm_batched launched "
                        f"{launches['gemm_batched']} times, want {want}")
    if [len(o) for o in out] != [NEW_TOKENS] * len(PROMPT_LENS):
        failures.append(f"{what} lengths {[len(o) for o in out]}")
    if not all(0 <= t < cfg.vocab_size for o in out for t in o):
        failures.append(f"{what}: token out of range")
    log(f"  first tokens per request: {[o[:6] for o in out]}")

    toks, lens, _ = eng._pad_prompts(prompts)
    active = torch.ones(len(PROMPT_LENS), dtype=torch.bool)
    torch.cuda.reset_peak_memory_stats()
    state = eng.new_state()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    logits, state = eng.prefill(state, toks, lens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    # dispatch mode's per-layer transient: the decoded expert stacks (from
    # their shapes), and the prefill's measured peak above what it holds
    gpk, dpk = (eng.qparams["layers"][0]["moe"][n]
                for n in ("gateup_pk", "down_pk"))
    e = dpk.codes.shape[0]
    decoded = 2 * (gpk.kq * gpk.n + e * dpk.kq * dpk.n)
    log(f"  dispatch-mode prefill: the decoded stacks of a layer (gate/up "
        f"[{gpk.kq}, {gpk.n}] and down [{e}, {dpk.kq}, {dpk.n}], bf16) "
        f"{decoded / 2 ** 30:.3f} GiB; the prefill's peak above the memory "
        f"it starts with "
        f"{(torch.cuda.max_memory_allocated() - held) / 2 ** 30:.3f} GiB")
    finite = bool(torch.isfinite(logits).all())
    capture(eng, state)
    t0 = time.perf_counter()
    for _ in range(NEW_TOKENS):
        logits, state = eng.decode_step(
            state, logits.argmax(-1).to(torch.int32), active)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    finite = finite and bool(torch.isfinite(logits).all())
    if not finite:
        failures.append(f"{what}: non-finite logits")
    metrics = dict(
        prefill_ms=round(prefill_ms, 3),
        decode_ms_per_step=round(dec_s * 1e3 / NEW_TOKENS, 3),
        decode_tok_s=round(len(PROMPT_LENS) * NEW_TOKENS / dec_s, 2),
        weight_gib=round(_weight_gib(eng.qparams), 3),
        serve_peak_memory_gib=round(torch.cuda.max_memory_allocated()
                                    / 2 ** 30, 3),
        logits_finite=finite, card=card)
    del state, logits
    return launches, metrics, toks, lens


def _moe_ab(eng, toks, lens, fmt, failures):
    """Decode with gemm_batched against the same engine with the per-expert
    loop of gemm_{fmt} patched in (gemm.gemm_batched_chain), in turns
    (batched, loop, loop, batched), each prefilled and fed the first
    run's greedy tokens: the logits must be bitwise equal at every step
    of every run. Returns the ms/step of each run by name."""
    from arcquant_tpu_torch.kernels import gemm as gk
    active = torch.ones(len(PROMPT_LENS), dtype=torch.bool)
    real, runs, feed = gk._gemm_batched_cuda, [], None
    try:
        for name in ("batched", "loop", "loop", "batched"):
            gk._gemm_batched_cuda = (real if name == "batched"
                                     else gk.gemm_batched_chain)
            eng.drop_graphs()      # capture the step with this launcher
            n0 = gk.GEMM_BATCHED.launches
            logits, state = eng.prefill(eng.new_state(), toks, lens)
            steps, fed = [logits.clone()], []
            capture(eng, state)
            t0 = time.perf_counter()
            for i in range(NEW_TOKENS):
                cur = (logits.argmax(-1).to(torch.int32) if feed is None
                       else feed[i])
                fed.append(cur)
                logits, state = eng.decode_step(state, cur, active)
                steps.append(logits.clone())
            torch.cuda.synchronize()
            runs.append((name, steps, (time.perf_counter() - t0) * 1e3
                         / NEW_TOKENS, gk.GEMM_BATCHED.launches - n0))
            feed = fed
            del state, logits
    finally:
        gk._gemm_batched_cuda = real
        eng.drop_graphs()
    ref = runs[0][1]
    same = [all(bool(torch.equal(_bits(x), _bits(r[1][i]))) for r in runs[1:])
            for i, x in enumerate(ref)]
    used = [n for _, _, _, n in runs]
    ok = all(same) and used[1] == used[2] == 0 and used[0] == used[3] > 0
    log(f"  {fmt} gemm_batched vs the per-expert gemm_{fmt} loop (two runs "
        f"each, in turns), same tokens fed: logits bitwise equal in every "
        f"run at {sum(same)} of {len(same)} steps (prefill + {NEW_TOKENS} "
        f"decode; bar: all); gemm_batched launches per run {used} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"MoE {fmt}: batched vs loop decode bitwise at "
                        f"{same}, launches {used}")
    ms = {}
    for name, _, t, _ in runs:
        ms.setdefault(name, []).append(round(t, 3))
    del runs, ref
    return ms


def _noisy_kernel_gemms(gen, w8, batched):
    """The gemm_w8 and gemm_batched launchers w8 and batched with their
    f32 results times (1 + 2^-22 * N(0, 1)) before the cast: a forward on
    the kernels with another f32 summation order standing in."""
    def g8(xa, codes, scales, gs, gw, bias, out_dtype):
        return _noise(w8(xa, codes, scales, gs, gw, bias, torch.float32),
                      gen).to(out_dtype)

    def gb(xa, codes, scales, gs, gw, out_dtype):
        return _noise(batched(xa, codes, scales, gs, gw, torch.float32),
                      gen).to(out_dtype)
    return g8, gb


def _moe_mode_check(eng, cfg, failures, gate=True):
    """Dispatch against dense mode: the prefill of one 64-token prompt
    (4 x 64 padded tokens, dense mode) and the same prefill with
    moe.DENSE_MODE_MAX_T lowered to 0 (capacity dispatch), the row's
    logits held to the noise floor measured in the same run: the dense
    prefill against itself with the GEMMs' f32 results perturbed by
    2^-22 (lowest cosine of three draws, at most 0.999). gate=False logs
    the comparison without holding it (the 24-layer dummy model, whose
    logits move chaotically with an ulp: dispatch mode rounds each
    expert's down output to bf16 before the combine, as the JAX package
    does, dense mode combines them in f32)."""
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.models import moe
    toks, lens, _ = eng._pad_prompts([prompts_for(cfg)[3]])

    def prefill():
        return eng.prefill(eng.new_state(), toks, lens)[0][0].float()
    dense = prefill()
    saved = moe.DENSE_MODE_MAX_T
    real = gk._gemm_w8_cuda, gk._gemm_batched_cuda
    floors = []
    try:
        moe.DENSE_MODE_MAX_T = 0
        disp = prefill()
        moe.DENSE_MODE_MAX_T = saved
        for seed in range(3):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            gk._gemm_w8_cuda, gk._gemm_batched_cuda = _noisy_kernel_gemms(
                gen, *real)
            floors.append(_cosine(dense, prefill()))
    finally:
        moe.DENSE_MODE_MAX_T = saved
        gk._gemm_w8_cuda, gk._gemm_batched_cuda = real
    cos, bar = _cosine(disp, dense), min([0.999] + floors)
    same = int(disp.argmax()) == int(dense.argmax())
    ok = cos >= bar
    log(f"  {cfg.num_layers}-layer dispatch vs dense prefill of a "
        f"{int(lens[0])}-token prompt: logits cosine {cos:.6f}, greedy "
        f"token {'equal' if same else 'differs'} ("
        + (f"bar: cosine >= {bar:.6f}, the noise floor of 3 draws "
           if gate else "logged; the noise floor's 3 draws ")
        + f"{[round(x, 6) for x in floors]}"
        + (f", at most 0.999) {'ok' if ok else 'FAIL'}" if gate else ")"))
    if gate and not ok:
        failures.append(f"MoE dispatch vs dense prefill: cos {cos} < {bar}")


def moe_run(cfg, card, failures):
    """Phase 11: qwen1.5-moe-a2.7b at full width, all 24 layers, dummy
    weights from seed 0 (ARC select_frac 0.125, per-row activation and
    per-channel weight scales, W4A16 packed head), in w8 and then in w4
    (the same seed, so the same weights): each built, timed, driven
    through generate() on the PROMPT_LENS prompts (the one-shot 4 x 1024
    prefill in dispatch mode, decode in dense mode) with its launches,
    prefill ms, decode ms/step, weight GiB and peak memory; then the
    batched GEMM against the per-expert loop (_moe_ab); for w8 also the
    dispatch against dense mode check. Returns {fmt: launches}."""
    from arcquant_tpu_torch.config import QuantConfig
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import quantized

    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    calib = quantized.identity_calib(cfg, SELECT_FRAC, device="cuda")
    log(f"  ARC residual columns per site: "
        f"{ {s: c.select_num for s, c in calib[0].items()} }")
    paths = {}
    for fmt in ("w8", "w4"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = InferenceEngine.dummy(cfg, calib,
                                    qcfg.replace(weight_fmt=fmt), ecfg,
                                    seed=0, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated()
        log(f"  {fmt} MoE engine built ({cfg.num_layers} layers packed on "
            f"the card) in {build_s:.1f} s, packed weights "
            f"{_weight_gib(eng.qparams):.3f} GiB, peak device memory "
            f"{build_peak / 2 ** 30:.3f} GiB")
        launches, metrics, toks, lens = _moe_generate(eng, cfg, fmt, card,
                                                      failures)
        metrics.update(
            build_s=round(build_s, 1),
            build_peak_memory_gib=round(build_peak / 2 ** 30, 3),
            decode_ms_per_step_batched_vs_loop=_moe_ab(eng, toks, lens,
                                                       fmt, failures))
        if fmt == "w8":
            _moe_mode_check(eng, cfg, failures, gate=False)
        log(f"  MoE engine {MOE_MODEL} {cfg.num_layers} layers {fmt} bs=4: "
            f"{json.dumps(metrics)}")
        paths[fmt] = launches
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def moe_serve_run(card, failures):
    """Phase 11, continued: serve.py's build_loop with --model qwen1.5-moe-a2.7b
    and its defaults (w8, W4A16 prefill in chunks of 512, W4A4 decode,
    select_frac 0.125, dummy weights from seed 0), dynamic pages, batch
    4: four concurrent HTTP requests of NEW_TOKENS tokens, prompts of
    1500, 700, 40 and 12 tokens. Returns the launches over the run."""
    from arcquant_tpu_torch import serve
    from arcquant_tpu_torch.engine.server import make_server

    args = serve.build_parser().parse_args(
        ["--model", MOE_MODEL, "--dynamic_pages", "--max_batch", "4"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = serve.build_loop(args)
    log(f"  build_loop({MOE_MODEL}) in {time.perf_counter() - t0:.1f} s")
    cfg = loop.batcher.engine.cfg
    srv = make_server(loop, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    rng = np.random.default_rng(3)
    bodies = [dict(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                   max_tokens=NEW_TOKENS) for n in (1500, 700, 40, 12)]
    kernels = all_kernels()
    reset_counts(kernels)
    t0 = time.perf_counter()
    clients = [Client(srv.server_address[1], b) for b in bodies]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    health = _get_stats(srv.server_address[1])
    srv.shutdown()
    srv.server_close()
    loop.shutdown()
    for body, c in zip(bodies, clients):
        o, tk = c.out, c.out["tokens"] or []
        if (o["status"] != 200 or o["error"] or len(tk) != NEW_TOKENS
                or not all(0 <= t < cfg.vocab_size for t in tk)):
            failures.append(f"MoE serve: request of {len(body['prompt'])} "
                            f"tokens: {o}")
    log(f"  launches in the MoE serving run: {launches}")
    for name in MOE_SERVE_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} not launched by the MoE server")
    ttft = [c.out["ttft_s"] for c in clients if c.out.get("ttft_s")]
    metrics = dict(
        requests=len(clients), statuses=[c.out["status"] for c in clients],
        wall_s=round(wall, 3),
        output_tok_s=round(NEW_TOKENS * len(clients) / wall, 2),
        ttft_median_s=round(statistics.median(ttft), 4) if ttft else None,
        peak_memory_gib=round(peak / 2 ** 30, 3),
        server_stats=health.get("stats"), card=card)
    log(f"  serve {MOE_MODEL} {cfg.num_layers} layers: {json.dumps(metrics)}")
    del loop, srv
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _noisy_batched(gen):
    """The batched GEMM's plain version with its f32 result perturbed
    before it is rounded to the output dtype."""
    from arcquant_tpu_torch.kernels import gemm as gk

    def f(xa, codes, scales, gs, gw, out_dtype):
        return _noise(gk.gemm_batched_plain(xa, codes, scales, gs, gw,
                                            torch.float32), gen).to(out_dtype)
    return f


def moe_engine_check(cfg, failures):
    """Phase 15 for the MoE model: the engine cut to 1 layer (w8, ARC,
    full width), its prefill of the four prompts (dispatch mode) and 4
    decode steps (dense mode: gemm_batched) fed the same tokens, against
    the same forward with the plain versions (PlainKernels: gemm_batched
    too). The router and the quantizers read each forward's own
    activations, so both runs' top-k sets and quantized activations
    (o_in, mlp_in, down_in, sdown_in) are compared: where none
    differs, the bar is cosine >= 0.999 and equal greedy tokens; where a
    routing flip or an e2m1 flip shows, the noise floor measured in the
    same run (the plain forward against itself with every GEMM's f32
    result times (1 + 2^-22 N(0, 1)) and paged decode's times (1 + 2^-16
    N(0, 1)) before their rounding, lowest of five draws, at most 0.999),
    and equal tokens unless a floor draw's tokens differ too. The
    attention's noise is the size of the kernel's own deviation: its bf16
    outputs differ from the plain version's by one ulp on 0.2-0.3% of
    elements (phase 3 logs the share), which an f32 perturbation of about
    2^-16 reproduces (0.8 x 2^-16 over a bf16 ulp of 2^-7.5 relative),
    where 2^-22 flips almost none; in W4A4 such a flip can cross an e2m1
    boundary at o_in. A flip moves a whole row: one
    element's e2m1 step at mlp_in moves that token's gate/up in all 60
    experts, and a bf16 ulp of a row's largest element moves the row's
    global scale and so every element of it.
    Then dispatch against dense mode on the same engine (_moe_mode_check),
    gated. Both forwards decode eagerly (cuda_graphs=False): the spies on
    the router and the quantizer see only the calls a forward makes, and
    a graph's replay makes none."""
    from arcquant_tpu_torch.config import QuantConfig
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import moe, quantized

    cfg_l = cfg.replace(num_layers=1)
    calib = quantized.identity_calib(cfg_l, SELECT_FRAC, device="cuda")
    eng = InferenceEngine.dummy(
        cfg_l, calib, QuantConfig(quant_type="NVFP4", use_kernels=True,
                                  weight_fmt="w8", act_scale="row",
                                  w_scale="channel", quantize_lm_head=True),
        EngineConfig(max_batch=len(PROMPT_LENS),
                     max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8),
        seed=1, device="cuda", cuda_graphs=False)
    toks, lens, _ = eng._pad_prompts(prompts_for(cfg_l, seed=1))
    active = torch.ones(len(PROMPT_LENS), dtype=torch.bool)
    # per forward, in call order: ("route", its top-k sets) and
    # ("quantize", the quantized activation) of o_in and the MoE sites
    seen = []
    real_route, real_q = moe.route, quantized._act_quantize

    def route(*a):
        cw = real_route(*a)
        seen[-1].append(("route", cw > 0))
        return cw

    def quantize(*a):
        xa, gx = real_q(*a)
        seen[-1].append(("quantize", xa))
        return xa, gx

    def forward(fn, *a):
        seen.append([])
        return fn(*a)

    def run(feed=None):
        seen.clear()
        logits, state = forward(eng.prefill, eng.new_state(), toks, lens)
        outs, fed = [logits.float().cpu()], []
        for i in range(4):
            cur = (logits.argmax(-1).to(torch.int32) if feed is None
                   else feed[i])
            fed.append(cur)
            logits, state = forward(eng.decode_step, state, cur, active)
            outs.append(logits.float().cpu())
        return outs, fed, list(seen)

    moe.route, quantized._act_quantize = route, quantize
    try:
        got, fed, s_got = run()
        with PlainKernels():
            want, _, s_want = run(feed=fed)
        floors = noise_draws(lambda: run(feed=fed)[0], 5)
    finally:
        moe.route, quantized._act_quantize = real_route, real_q
    for i, (a, b) in enumerate(zip(got, want)):
        diff = {"route": 0, "quantize": 0}
        for (kind, x), (_, y) in zip(s_got[i], s_want[i]):
            diff[kind] += int(((x != y).any(-1) if kind == "route"
                               else x != y).sum())
        flips, moved = diff["route"], diff["quantize"]
        ok, cos, floor, same, noisy = floor_gate(a, b, b,
                                                 [f[i] for f in floors])
        what = "1-layer MoE " + ("prefill" if i == 0 else f"decode {i}")
        if flips == 0 and moved == 0:
            ok, bar = cos >= 0.999 and same, "cosine >= 0.999, equal tokens"
        else:
            bar = (f"cosine >= {floor:.6f}, the noise floor, at most 0.999; "
                   "equal tokens unless a floor draw's differ too: "
                   f"{'they do' if noisy else 'they do not'}")
        log(f"  {what}: tokens whose top-k set differs from the plain "
            f"forward's: {flips}, quantized activation elements that "
            f"differ: {moved}; logits cosine {cos:.6f}, greedy tokens "
            f"{'equal' if same else 'differ'} (bar: {bar}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{what} engine vs plain: cos {cos}, tokens "
                            f"equal {same}, routing flips {flips}, "
                            f"quantize flips {moved}")
    del s_got, s_want
    _moe_mode_check(eng, cfg_l, failures)
    del eng


def serving_qcfg():
    """serve.py's defaults: w8, W4A16 prefill, W4A4 decode, row scales."""
    from arcquant_tpu_torch.config import QuantConfig
    return QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel",
                       prefill_act_bits=16, quantize_lm_head=True)


class Client(threading.Thread):
    """One HTTP completion request in a thread; SSE when stream is set.
    Keeps the status, tokens, error, request id and TTFT (the server's
    ttft_s; for a stream, the time to the first token frame)."""

    def __init__(self, port, body):
        super().__init__(daemon=True)
        self.port, self.body = port, body
        self.out = dict(status=None, tokens=None, error="no response")

    def run(self):
        t0 = time.perf_counter()
        try:
            c = http.client.HTTPConnection("127.0.0.1", self.port,
                                           timeout=900)
            c.request("POST", "/v1/completions", json.dumps(self.body))
            r = c.getresponse()
            if self.body.get("stream"):
                ttft, final = None, {}
                for line in r:
                    line = line.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    frame = json.loads(line[6:])
                    if "token" in frame and ttft is None:
                        ttft = time.perf_counter() - t0
                    if frame.get("done"):
                        final = frame
                out = dict(final, ttft_s=ttft)
            else:
                out = json.loads(r.read())
            c.close()
            self.out = dict(status=r.status, tokens=out.get("tokens"),
                            error=out.get("error"),
                            request_id=out.get("request_id"),
                            ttft_s=out.get("ttft_s"))
        except Exception as e:                      # noqa: BLE001
            self.out["error"] = repr(e)


def _get_stats(port) -> dict:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", "/health")
    out = json.loads(c.getresponse().read())
    c.close()
    return out


def serving_run(cfg, qparams, calib, card, failures):
    """Phase 5: the HTTP server over the continuous batcher on the 28
    packed layers. Returns the kernels' launch counts over that run."""
    from arcquant_tpu_torch.engine import (ContinuousBatcher, EngineConfig,
                                           InferenceEngine)
    from arcquant_tpu_torch.engine.server import ServingLoop, make_server
    from arcquant_tpu_torch.kernels import paged_decode as pdk

    ecfg = EngineConfig(max_batch=8, max_seq_len=2048, prefill_chunk=512,
                        dynamic_pages=True, prefix_sharing=True)
    eng = InferenceEngine(cfg, qparams, calib, serving_qcfg(), ecfg,
                          device="cuda", quantize_params=False)
    batcher = ContinuousBatcher(eng)
    # which prefill route each admission took, and the paged_prefill
    # launches in it; the shared-prefix origin of every admitted request
    routes = {r: [0, 0] for r in ("one_shot", "chunked", "suffix")}
    origin = {}

    def wrap(name, route):
        inner = getattr(eng, name)

        def counted(*a, **kw):
            n0 = pdk.PAGED_PREFILL.launches
            out = inner(*a, **kw)
            routes[route][0] += 1
            routes[route][1] += pdk.PAGED_PREFILL.launches - n0
            return out
        setattr(eng, name, counted)
    wrap("_prefill_forward", "one_shot")
    wrap("_prefill_chunked", "chunked")
    wrap("_prefill_suffix", "suffix")
    inner_prefill = eng.prefill

    def prefill(state, tokens, lens, starts=None):
        for slot, r in enumerate(batcher.slots):
            if r is not None and lens[slot] > 0:
                origin[r.request_id] = (0 if starts is None
                                        else int(starts[slot]))
        return inner_prefill(state, tokens, lens, starts=starts)
    eng.prefill = prefill

    loop = ServingLoop(batcher)
    srv = make_server(loop, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    rng = np.random.default_rng(2)

    def toks(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()
    prefix = toks(SHARED_PREFIX)
    wave1 = [dict(prompt=toks(n), max_tokens=NEW_TOKENS)
             for n in SERVE_WAVE1]
    sharers = [dict(prompt=prefix + toks(SUFFIX), max_tokens=NEW_TOKENS)
               for _ in range(3)]
    sampled = dict(prompt=toks(SAMPLED_LEN), max_tokens=NEW_TOKENS,
                   temperature=0.8, top_p=0.9, seed=7, stream=True)
    wave2 = [dict(prompt=toks(SHORT_LEN), max_tokens=NEW_TOKENS), sampled,
             sharers[1], sharers[2]]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    reset_counts(kernels)
    t0 = time.perf_counter()
    clients = [Client(port, b) for b in wave1 + sharers[:1]]
    for c in clients:
        c.start()
    # the second wave goes out once the first is admitted (running or
    # done): the first sharer has then registered its prefix pages
    deadline = time.time() + 600
    while time.time() < deadline:
        st = _get_stats(port)["stats"]
        if st["running"] + st["finished"] >= len(clients) or loop.error:
            break
        time.sleep(0.02)
    log(f"  first wave admitted after {time.perf_counter() - t0:.3f} s: "
        f"{st}")
    late = [Client(port, b) for b in wave2]
    for c in late:
        c.start()
    clients += late
    for c in clients:
        c.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    health = _get_stats(port)
    srv.shutdown()
    srv.server_close()
    loop.shutdown()

    outs = [c.out for c in clients]
    for body, o in zip([c.body for c in clients], outs):
        tk = o["tokens"] or []
        if (o["status"] != 200 or o["error"] or len(tk) != NEW_TOKENS
                or not all(0 <= t < cfg.vocab_size for t in tk)):
            failures.append(f"serve: request of {len(body['prompt'])} "
                            f"tokens: {o}")
    log(f"  launches in the serving run: {launches}")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} not launched by the server")
    for name in ARC_IDLE_KERNELS:
        if launches[name] != 0:
            failures.append(f"kernel {name} launched by the ARC server")
    log(f"  prefill admissions [count, paged_prefill launches]: {routes}")
    if routes["chunked"][1] <= 0 or routes["suffix"][1] <= 0:
        failures.append(f"serve: paged_prefill not launched in both "
                        f"chunked and suffix admissions: {routes}")
    ps = ecfg.page_size
    shared_pages = [origin.get(o.get("request_id"), 0) // ps
                    for o in (c.out for c in late[2:])]
    log(f"  late sharers' shared pages: {shared_pages}")
    if any(n < SHARED_PREFIX // ps for n in shared_pages):
        failures.append(f"serve: late sharers mapped {shared_pages} shared "
                        f"pages, want >= {SHARED_PREFIX // ps} each")
    ttft = [o["ttft_s"] for o in outs if o.get("ttft_s") is not None]
    metrics = dict(
        requests=len(outs), output_tokens=NEW_TOKENS * len(outs),
        wall_s=round(wall, 3),
        output_tok_s=round(NEW_TOKENS * len(outs) / wall, 2),
        ttft_median_s=round(statistics.median(ttft), 4) if ttft else None,
        ttft_max_s=round(max(ttft), 4) if ttft else None,
        prefill_tokens_skipped_by_sharing=int(sum(origin.values())),
        prompt_tokens=int(sum(len(c.body["prompt"]) for c in clients)),
        peak_memory_gib=round(peak / 2 ** 30, 3),
        server_stats=health.get("stats"), card=card)
    log(f"  serve {MODEL} {cfg.num_layers} layers: {json.dumps(metrics)}")
    del eng, batcher, loop
    torch.cuda.empty_cache()
    return launches


class PlainKernels:
    """Context manager that routes the kernel entry points to their plain
    PyTorch versions (the engine-level reference): the megakernels to the
    chain of the same function, whose actq and GEMM entry points are then
    the plain versions (or, for a noise floor, the noisy GEMM); the
    large-M route's dequant and pin passes to theirs. `keep`: names of
    kernels (KERNEL_INFO's) left on the card."""

    def __init__(self, keep=()):
        self.keep = set(keep)

    def __enter__(self):
        from arcquant_tpu_torch.kernels import attention, gemm as gk
        from arcquant_tpu_torch.kernels import mlp_fused as mf
        from arcquant_tpu_torch.kernels import paged_decode as pdk
        from arcquant_tpu_torch.kernels import quantize as qk
        table = [("actq", qk, "_actq_cuda", qk.actq_plain),
                 ("gemm_w8", gk, "_gemm_w8_cuda", gk.gemm_w8_plain),
                 ("flash_attn", attention, "_flash_cuda",
                  attention.flash_attention_plain),
                 ("paged_decode", pdk, "_paged_decode_cuda",
                  pdk.paged_decode_state_plain),
                 ("paged_prefill", pdk, "_paged_prefill_cuda",
                  pdk.paged_prefill_plain),
                 ("gemm_actq", mf, "_gemm_actq_cuda", mf.gemm_actq_chain),
                 ("gu_actq", mf, "_gu_actq_cuda", mf.gu_actq_chain),
                 ("mlp_w8", mf, "_mlp_w8_cuda", mf.mlp_w8_chain),
                 ("gemm_w4", gk, "_gemm_w4_cuda", gk.gemm_w4_plain),
                 ("dequant_w8", gk, "_dequant_w8_cuda", gk.dequant_w8_plain),
                 ("dequant_w4", gk, "_dequant_w4_cuda", gk.dequant_w4_plain),
                 ("pin_rowmajor", gk, "_pin_rowmajor_cuda",
                  gk.pin_rowmajor_plain),
                 ("gemm_batched", gk, "_gemm_batched_cuda",
                  gk.gemm_batched_plain),
                 # the route's product stays torch.mm (a noise floor
                 # patches it); saved so that it is restored
                 (None, gk, "_mm_f32_cuda", gk._mm_f32_cuda)]
        self.saved = [(mod, name, getattr(mod, name),
                       getattr(mod, name) if kernel in self.keep else plain)
                      for kernel, mod, name, plain in table]
        for mod, name, _, plain in self.saved:
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, orig, _ in self.saved:
            setattr(mod, name, orig)
        return False


# kernel_checks' bar of each kernel's outputs against its plain version's
# on the same inputs (beside_plain)
PLAIN_BARS = {
    "actq": "bit-exact in plain and silu_mul mode; in rmsnorm mode bitwise "
            "actq_kernel_order, <= 1 e2m1 step on < 3% of elements, gx "
            "within 1e-2",
    "gemm_w8": "f32 sum order, + 1 bf16 ulp for bf16 outputs",
    "dequant_w8": "bit-exact",
    "flash_attn": "1 bf16 ulp + 2e-3",
    "paged_decode": "1 bf16 ulp + 2e-3, m within 1e-5, l within 1e-4, "
                    "empty rows 0"}


def _held_to_plain(kernel, out, ref, a, kw) -> bool:
    """One call of `kernel` against its plain version: PLAIN_BARS."""
    from arcquant_tpu_torch.kernels import quantize as qk
    if kernel == "actq":
        if kw["mode"] != "rmsnorm":
            return bitwise(out, ref)
        return (bitwise(out, qk.actq_kernel_order(*a, **kw))
                and one_step_bound(out[0], ref[0])
                and bool(torch.allclose(out[1], ref[1], rtol=1e-2)))
    if kernel == "gemm_w8":
        return sum_order_bound(out, ref, a[6] == torch.float32)
    if kernel == "dequant_w8":
        return bitwise([out], [ref])
    if kernel == "flash_attn":
        return close_bound(out, ref)
    (o, m, l), (po, pm, pl), sl = out, ref, a[4]
    return (close_bound(o, po)
            and bool(torch.allclose(m, pm, rtol=1e-5, atol=1e-5))
            and bool(torch.allclose(l, pl, rtol=1e-4))
            and bool((o[sl == 0] == 0).all()))


@contextlib.contextmanager
def beside_plain(kernels):
    """Every call of each of `kernels` (actq, gemm_w8, dequant_w8,
    flash_attn, paged_decode) also runs the kernel's plain version on the
    same inputs and holds the outputs to PLAIN_BARS: the kernels against
    their plain versions at the shapes and on the data of the path being
    driven. Yields {kernel: dict(calls, shapes, err, off, n, ok, share)}:
    the calls, their distinct shapes, the largest absolute error of the
    first output, how many of its n elements differ, whether every call
    met the bar, and the share of elements that differ in the calls that
    met it (what a floor may take as the kernel's own departure). Launch
    counts are not for reading in such a run."""
    from arcquant_tpu_torch.kernels import attention, gemm as gk
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    from arcquant_tpu_torch.kernels import quantize as qk
    table = {
        "actq": (qk, "_actq_cuda", qk.actq_plain, lambda a, kw:
                 f"{kw['mode']} M={a[0].shape[0]} K={kw['k']}"),
        "gemm_w8": (gk, "_gemm_w8_cuda", gk.gemm_w8_plain, lambda a, kw:
                    f"M={a[0].shape[0]} Kq={a[1].shape[0]} "
                    f"N={a[1].shape[1]}"),
        "dequant_w8": (gk, "_dequant_w8_cuda", gk.dequant_w8_plain,
                       lambda a, kw: f"Kq={a[0].shape[-2]} "
                       f"N={a[0].shape[-1]}"),
        "flash_attn": (attention, "_flash_cuda",
                       attention.flash_attention_plain, lambda a, kw:
                       f"B={a[0].shape[0]} Tq={a[0].shape[1]} "
                       f"Tk={a[1].shape[1]} H={a[0].shape[2]}/"
                       f"{a[1].shape[2]}"),
        "paged_decode": (pdk, "_paged_decode_cuda",
                         pdk.paged_decode_state_plain, lambda a, kw:
                         f"B={a[0].shape[0]} H={a[0].shape[1]}/"
                         f"{a[1].shape[2]} seq_lens {a[4].tolist()}")}
    seen = {k: dict(calls=0, shapes=set(), err=0.0, off=0, n=0, ok=True,
                    share=0.0, _within=[0, 0]) for k in kernels}

    def spy(kernel, real, plain, shape):
        def f(*a, **kw):
            out = real(*a, **kw)
            ref = plain(*a, **kw)
            o, r = (out[0], ref[0]) if isinstance(out, tuple) else (out, ref)
            st = seen[kernel]
            st["calls"] += 1
            st["shapes"].add(shape(a, kw))
            st["err"] = max(st["err"],
                            float((o.float() - r.float()).abs().max()))
            off = int((o != r).sum())
            st["off"] += off
            st["n"] += o.numel()
            if _held_to_plain(kernel, out, ref, a, kw):
                w = st["_within"]
                w[0] += off
                w[1] += o.numel()
                st["share"] = w[0] / w[1]
            else:
                st["ok"] = False
            return out
        return f

    saved = []
    for k in kernels:
        mod, name, plain, shape = table[k]
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, spy(k, saved[-1][2], plain, shape))
    try:
        yield seen
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def plain_gate(seen, what, failures) -> None:
    """beside_plain's result: each kernel called at least once, every
    call within its bar."""
    for k, st in seen.items():
        ok = st["ok"] and st["calls"] > 0
        log(f"  {what} {k} against its plain version on the path's own "
            f"inputs: {st['calls']} calls at {sorted(st['shapes'])}; max "
            f"abs err {st['err']:.4g}, {st['off'] / max(st['n'], 1):.4%} of "
            f"outputs apart (bar: {PLAIN_BARS[k]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{what} {k} against its plain version: "
                            f"{st['calls']} calls, max abs err {st['err']}")


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def engine_check(cfg, failures):
    """Phase 15: the engine cut to 1 and to 2 layers, and the w4 and BF16
    engines cut to 1 layer, each its prefill (4 x 1024: qkv and gateup
    take the large-M route; BF16's linears are the same f32-accumulated
    library products on both sides) and 4 decode steps (fed the same
    tokens) with the kernels against the same forward with the plain
    versions (the route's torch.mm is the same on both sides); the
    kernels' decode replays the captured step, the plain one is eager.

    1 layer: logits cosine >= 0.999 and equal greedy tokens at every
    step. 2 layers: the forward of random dummy weights is chaotic at
    the f32-ulp level (a 2-ulp perturbation of the GEMM outputs already
    moves the logits cosine to about 0.99 and changes greedy tokens), so
    the bar is that noise floor, measured in the same run: the kernels
    must stay at least as close to the plain forward as the plain
    forward with every GEMM output (the route's f32 product included)
    multiplied by (1 + 2^-22 * N(0, 1)) does."""
    from arcquant_tpu_torch.config import QuantConfig
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import quantized

    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    for layers, fmt in ((1, "w8"), (2, "w8"), (1, "w4"), (1, "BF16")):
        cfg_l = cfg.replace(num_layers=layers)
        calib = quantized.identity_calib(cfg_l, SELECT_FRAC, device="cuda")
        eng = InferenceEngine.dummy(
            cfg_l, calib, QuantConfig(quant_type="BF16") if fmt == "BF16"
            else qcfg.replace(weight_fmt=fmt), ecfg, seed=1, device="cuda")
        engine_vs_plain(eng, f"{layers}-layer {fmt}", failures)
        del eng


def engine_steps(eng, feed=None, decodes=4):
    """An engine's prefill of the PROMPT_LENS prompts from seed 1 and
    `decodes` decode steps, fed `feed` (else its greedy tokens): ([f32
    logits on the host], the tokens fed)."""
    toks, lens, _ = eng._pad_prompts(prompts_for(eng.cfg, seed=1))
    active = torch.ones(len(PROMPT_LENS), dtype=torch.bool)
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    outs, fed = [logits.float().cpu()], []
    for i in range(decodes):
        cur = (logits.argmax(-1).to(torch.int32) if feed is None
               else feed[i])
        fed.append(cur)
        logits, state = eng.decode_step(state, cur, active)
        outs.append(logits.float().cpu())
    return outs, fed


def engine_vs_plain(eng, label, failures, paged_floor=False, ref=None,
                    real=(), steps=engine_steps, draws=5):
    """engine_check's comparison on one engine of 1 or 2 layers: its
    steps (engine_steps: the prefill and 4 decode steps) with the kernels
    (the decode replaying the captured step) against the same forward
    with the plain versions (eager), fed the same tokens; at 1 layer
    cosine >= 0.999 and equal greedy tokens, at 2 the noise floor of the
    plain forward against itself with 2^-22 GEMM noise. Returns (the
    engine's logits of each step, the tokens fed).

    ref: the engine whose forward is the reference (default eng), on the
    same weights; real: kernels (KERNEL_INFO's names) left on the card in
    the reference run. The floors are always the reference engine on the
    plain versions against itself with noise. steps(engine, feed=None):
    the run of an engine (the other engine's tokens fed when given).

    paged_floor: moe_engine_check's floor at every depth instead
    (noise_draws, floor_gate): the plain forward against itself with
    every GEMM's f32 result (the batched expert GEMM's of an MoE engine
    too) times (1 + 2^-22 N(0, 1)) and paged decode's times
    (1 + 2^-16 N(0, 1)), the lowest of `draws` draws, at most 0.999;
    equal tokens unless a draw's differ too. Paged decode's outputs sit
    an ulp from its plain version's on 0.4-0.6% of elements, and at 1
    layer that alone moves a decode step's logits to cosine 0.9985 on
    some weights (on an H100, at identity 0.125 as well as a calibration,
    and at per-tensor scales)."""
    ref = eng if ref is None else ref
    layers = ref.cfg.num_layers
    got, fed = steps(eng)
    # the plain versions run eagerly: a capture would keep whatever the
    # patched entry points were when it was made
    graphs, ref.cuda_graphs = ref.cuda_graphs, False
    with PlainKernels(keep=real):
        want, _ = steps(ref, fed)
    if real:
        with PlainKernels():
            plain = steps(ref, fed)[0]
    else:
        plain = want
    floors = noise_draws(lambda: steps(ref, fed)[0],
                         draws if paged_floor else int(layers == 2),
                         paged=paged_floor)
    ref.cuda_graphs = graphs
    for i, (a, b) in enumerate(zip(got, want)):
        ok, cos, floor, same, noisy = floor_gate(a, b, plain[i],
                                                 [f[i] for f in floors])
        what = f"{label} " + ("prefill" if i == 0 else f"decode {i}")
        if paged_floor:
            bar = (f"cosine >= {floor:.6f}, the floor of GEMM and paged "
                   "decode noise, at most 0.999; equal tokens unless a "
                   f"draw's differ: {'they do' if noisy else 'they do not'}")
        elif layers == 1:
            ok = cos >= 0.999 and same
            bar = "cosine >= 0.999 and equal tokens"
        else:
            bar_cos = _cosine(plain[i], floors[0][i])
            ok = cos >= bar_cos
            bar = (f"cosine >= {bar_cos:.6f}, the plain forward vs "
                   "itself with 2^-22 GEMM noise")
        log(f"  {what}: logits cosine {cos:.6f}, greedy tokens "
            f"{'equal' if same else 'differ'} (bar: {bar}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{what} engine vs plain: cos {cos}, "
                            f"tokens equal {same}")
    return got, fed


def noise_draws(run, draws, paged=True):
    """`draws` runs of run() on the plain versions with every GEMM's f32
    result (the w8 GEMM's and the large-M route's product) times
    (1 + 2^-22 N(0, 1)) before its rounding, draw d from seed d; with
    `paged` also the batched expert GEMM's, and paged decode's times
    (1 + 2^-16 N(0, 1)). The noise floors' runs."""
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    floors = []
    with PlainKernels():
        for seed in range(draws):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            gk._gemm_w8_cuda = _noisy_gemm(gen)
            gk._mm_f32_cuda = _noisy_mm(gen)
            if paged:
                gk._gemm_batched_cuda = _noisy_batched(gen)
                pdk._paged_decode_cuda = _noisy_attention(
                    pdk.paged_decode_state_plain, gen, 2.0 ** -16)
            floors.append(run())
    return floors


def floor_gate(got, want, plain, floors) -> tuple:
    """The noise-floor bar at one step (moe_engine_check's rule): got's
    logits cosine to want's at least the floor, the lowest cosine of the
    noisy draws `floors` to the plain run's logits (at most 0.999), and
    equal greedy tokens unless a draw's differ from the plain run's too.
    Returns (ok, cosine, floor, tokens equal, a draw's tokens differ)."""
    cos = _cosine(got, want)
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    floor = min([0.999] + [_cosine(plain, f) for f in floors])
    noisy = any(not torch.equal(f.argmax(-1), plain.argmax(-1))
                for f in floors)
    return cos >= floor and (same or noisy), cos, floor, same, noisy


def _noise(y, gen, scale=2.0 ** -22):
    """y (f32) times (1 + scale * N(0, 1)): a stand-in for another f32
    summation order."""
    return y * (1 + scale * torch.randn(y.shape, generator=gen,
                                        device=y.device))


def _noisy_attention(fn, gen, scale=2.0 ** -22):
    """A paged attention plain version (query first, output first) whose
    f32 output is perturbed before it is rounded to the query's dtype."""
    def f(q, *a):
        out = fn(q.float(), *a)
        first = out[0] if isinstance(out, tuple) else out
        first = _noise(first, gen, scale).to(q.dtype)
        return (first, *out[1:]) if isinstance(out, tuple) else first
    return f


def _ulp_flips(y, gen, share):
    """y (bf16) with one ulp added or taken, at random, on a `share` of
    its finite non-zero elements."""
    bits = y.contiguous().view(torch.int16)
    mag = bits & 0x7FFF
    pick = ((torch.rand(y.shape, generator=gen, device=y.device) < share)
            & (mag > 0) & (mag < 0x7F7F))
    step = torch.where(torch.rand(y.shape, generator=gen, device=y.device)
                       < 0.5, 1, -1).to(torch.int16)
    return torch.where(pick, bits + step, bits).view(torch.bfloat16)


def _flipped_attention(fn, gen, share):
    """A paged attention (query first, output first, bf16) whose output
    has one ulp flipped on a `share` of its elements: the distance of the
    paged prefill kernel from its plain version, or from the paged
    decode kernel (VERIFY_ULP_SHARE)."""
    def f(q, *a):
        out = fn(q, *a)
        first = out[0] if isinstance(out, tuple) else out
        first = _ulp_flips(first, gen, share)
        return (first, *out[1:]) if isinstance(out, tuple) else first
    return f


def _noisy_gemm(gen):
    """The w8 GEMM plain version with its f32 result perturbed before it
    is rounded to the output dtype."""
    from arcquant_tpu_torch.kernels import gemm as gk

    def f(xa, codes, scales, gs, gw, bias, out_dtype):
        return _noise(gk.gemm_w8_plain(xa, codes, scales, gs, gw, bias,
                                       torch.float32), gen).to(out_dtype)
    return f


def _noisy_mm(gen):
    """The large-M route's f32 product (the f32 plain matmul) perturbed
    the same way."""
    def f(x, w):
        return _noise(x.float() @ w.float(), gen)
    return f


def _verify_floors(eng, run, fed, got, prec, failures):
    """The 1-layer verify's extra runs (eager; serving_engine_check's
    docstring): the kernels with the paged prefill spied (its share of
    outputs apart from the plain version's, and the run bitwise against
    the graph's `got`), the kernels with the paged prefill's plain
    version, and 5 reference draws with that share of the attention
    outputs flipped an ulp. Returns (that run's logits, the draws)."""
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    real = pdk._paged_prefill_cuda
    seen = [0, 0]

    def spy(q, *a):
        o = real(q, *a)
        if q.shape[1] == 4:             # the verify's launches
            seen[0] += int((o != pdk.paged_prefill_plain(q, *a)).sum())
            seen[1] += o.numel()
        return o
    try:
        pdk._paged_prefill_cuda = spy
        eager, _ = run(eng, "verify", feed=fed)
        pdk._paged_prefill_cuda = pdk.paged_prefill_plain
        iso, _ = run(eng, "verify", feed=fed)
    finally:
        pdk._paged_prefill_cuda = real
    share = seen[0] / max(seen[1], 1)
    same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(eager, got))
    log(f"  1-layer verify ({prec} prefill): the paged prefill's outputs "
        f"differing from its plain version's in this verify: {share:.4%}; "
        f"the eager kernel verify equals the graph's bit for bit: {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        failures.append(f"1-layer verify ({prec} prefill): eager kernel "
                        "verify differs from the graph's")
    ulp = []
    with PlainKernels():
        for seed in range(5):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(10 + seed)
            gk._gemm_w8_cuda = _noisy_gemm(gen)
            gk._mm_f32_cuda = _noisy_mm(gen)
            pdk._paged_prefill_cuda = _flipped_attention(
                pdk.paged_prefill_plain, gen, share)
            pdk._paged_decode_cuda = _noisy_attention(
                pdk.paged_decode_state_plain, gen)
            ulp.append(run(eng, "verify", feed=fed)[0])
    return iso, ulp


def _verify_bar(got, want, draws) -> tuple:
    """The verify's bar at one position (serving_engine_check's
    docstring): (ok, its text)."""
    c = [_cosine(want, f) for f in draws]
    bar = min(0.999, min(c) - (max(c) - min(c)))
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    noisy = any(not torch.equal(f.argmax(-1), want.argmax(-1))
                for f in draws)
    ok = _cosine(got, want) >= bar and (same or noisy)
    return ok, (f"cosine >= {bar:.6f}, the lowest of the ulp-flip draws "
                f"{[round(x, 6) for x in sorted(c)]} less their spread, at "
                f"most 0.999; equal tokens unless a draw's differ "
                f"({'some' if noisy else 'none'} do)")


def serving_engine_check(cfg, failures):
    """Phase 15, continued: the 1-layer engine with prefill_chunk 256,
    kernels against plain versions:
      chunked  the four prompts stream through the int4 pool in chunks;
      suffix   a prefix prefill of (512, 256, 128, 0) tokens, then the
               rest with those per-row starts;
    each followed by 4 decode steps fed the same tokens, with the A4
    prefill of the engine check and with serve.py's W4A16 one;
      verify   after the chunked prefill, speculative decoding's
               verify_step of the chunked case's 4 decode tokens in one
               step (W 4), against the same verify with the plain
               versions (and, for the record, against the plain decode
               steps of those tokens beside the decode's floor). Its bar
               at each position: equal tokens unless a floor draw's
               differ, and a cosine at or above the lowest of 5 draws
               less their spread (highest less lowest), at most 0.999,
               each draw the reference forward with the 2^-22 noise
               below and, in place of the paged prefill's, its plain
               version's output with one ulp flipped on the share of
               elements at which the kernel's output differs from the
               plain version's in this verify (a spy measures it on the
               eager kernel verify, which must equal the graph's bit for
               bit). The same verify with every kernel but the paged
               prefill (there its plain version) is held to the 2^-22
               floor, so no other kernel at the verify's M = 16 hides
               behind the paged prefill's ulps.

    The bar is equal greedy tokens and a logits cosine at or above the
    noise floor measured in the same run, at most 0.999: the reference
    forward against itself with the f32 results of its plain versions
    multiplied by (1 + 2^-22 * N(0, 1)) before rounding, the lowest
    cosine of three such draws. paged_prefill's bf16 outputs differ from
    the plain version's by one ulp on about 1% of elements, both equally
    close to an f64 reference (phase 3 checks that at the serving shape),
    and the A4 quantize of the o projection's input turns such flips into
    logit-level changes; after a W4A16 prefill the GEMM's bf16 outputs do
    the same through the int4 K/V codes."""
    from arcquant_tpu_torch.config import QuantConfig
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    from arcquant_tpu_torch.models import quantized

    cfg_l = cfg.replace(num_layers=1)
    calib = quantized.identity_calib(cfg_l, SELECT_FRAC, device="cuda")
    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8,
                        prefill_chunk=256)
    a4 = QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
                     act_scale="row", w_scale="channel",
                     quantize_lm_head=True)
    engines = {"A4": InferenceEngine.dummy(cfg_l, calib, a4, ecfg, seed=2,
                                           device="cuda")}
    engines["A16"] = InferenceEngine(
        cfg_l, engines["A4"].qparams, calib, serving_qcfg(), ecfg,
        device="cuda", quantize_params=False)
    toks, lens, _ = engines["A4"]._pad_prompts(prompts_for(cfg_l, seed=2))
    starts = np.asarray([512, 256, 128, 0], np.int32)
    active = torch.ones(len(PROMPT_LENS), dtype=torch.bool)

    def run(eng, case, feed=None):
        state = eng.new_state()
        if case == "suffix":
            pre = np.where(np.arange(512)[None] < starts[:, None],
                           toks[:, :512], 0)
            _, state = eng.prefill(state, pre, starts)
            suf = np.zeros_like(toks)
            for i, s0 in enumerate(starts):
                suf[i, :lens[i] - s0] = toks[i, s0:lens[i]]
            logits, state = eng.prefill(state, suf, lens, starts=starts)
        else:
            logits, state = eng.prefill(state, toks, lens)
        outs, fed = [logits.float().cpu()], []
        if case == "verify":
            # speculative decoding's verify of the 4 fed tokens in one
            # step (the paged prefill at Tq 4 over the pool)
            vlog, _ = eng.verify_step(state, torch.stack(feed, dim=1),
                                      torch.full((len(feed[0]),), 4))
            return outs + [vlog[:, i].float().cpu() for i in range(4)], feed
        for i in range(4):
            cur = (logits.argmax(-1).to(torch.int32) if feed is None
                   else feed[i])
            fed.append(cur)
            logits, state = eng.decode_step(state, cur, active)
            outs.append(logits.float().cpu())
        return outs, fed

    for prec in ("A4", "A16"):
        decode = {}
        for case in ("chunked", "verify", "suffix"):
            eng = engines[prec]
            eng.cuda_graphs = True
            # the verify feeds the chunked case's decode tokens
            got, fed = run(eng, case, feed=decode.get("fed"))
            floors = []
            eng.cuda_graphs = False        # the plain versions: eager
            with PlainKernels():
                want, _ = run(eng, case, feed=fed)
                for seed in range(3):
                    gen = torch.Generator(device="cuda")
                    gen.manual_seed(seed)
                    gk._gemm_w8_cuda = _noisy_gemm(gen)
                    gk._mm_f32_cuda = _noisy_mm(gen)
                    pdk._paged_prefill_cuda = _noisy_attention(
                        pdk.paged_prefill_plain, gen)
                    pdk._paged_decode_cuda = _noisy_attention(
                        pdk.paged_decode_state_plain, gen)
                    floors.append(run(eng, case, feed=fed)[0])
            if case == "verify":
                iso, ulp = _verify_floors(eng, run, fed, got, prec,
                                          failures)
            # tokens of the floor draws, for the log only
            noisy_same = [all(bool(torch.equal(f[i].argmax(-1),
                                               want[i].argmax(-1)))
                              for i in range(len(want))) for f in floors]
            for i, (a, b) in enumerate(zip(got, want)):
                cos = _cosine(a, b)
                same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                bar = min([0.999] + [_cosine(b, f[i]) for f in floors])
                what = f"1-layer {case} ({prec} prefill) " + (
                    "prefill" if i == 0 else f"position {i}" if
                    case == "verify" else f"decode {i}")
                if case == "verify" and i > 0:
                    ok, text = _verify_bar(a, b, [f[i] for f in ulp])
                else:
                    ok = cos >= bar and same
                    text = (f"equal tokens, cosine >= {bar:.6f}, the noise "
                            "floor, at most 0.999")
                log(f"  {what}: logits cosine {cos:.6f}, greedy tokens "
                    f"{'equal' if same else 'differ'} (bar: {text}) "
                    + ("ok" if ok else "FAIL"))
                if not ok:
                    failures.append(f"{what} engine vs plain: cos {cos}, "
                                    f"tokens equal {same}")
                if case == "verify" and i > 0:
                    # every kernel but the paged prefill, at the 2^-22
                    # floor: equal tokens unless a floor draw's differ
                    c = _cosine(iso[i], b)
                    same = bool(torch.equal(iso[i].argmax(-1), b.argmax(-1)))
                    noisy = any(not torch.equal(f[i].argmax(-1),
                                                b.argmax(-1)) for f in floors)
                    ok = c >= bar and (same or noisy)
                    log(f"  {what}, every kernel but the paged prefill (its "
                        f"plain version): logits cosine {c:.6f}, greedy "
                        f"tokens {'equal' if same else 'differ'} (bar: "
                        f"cosine >= {bar:.6f}, the 2^-22 noise floor, at "
                        f"most 0.999; equal tokens unless a floor draw's "
                        f"differ) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(f"{what} every kernel but the paged "
                                        f"prefill vs plain: cos {c}, tokens "
                                        f"equal {same}")
            log(f"  1-layer {case} ({prec} prefill): floor draws with tokens "
                f"equal to the reference at every step: "
                f"{sum(noisy_same)} of {len(noisy_same)}")
            if case == "chunked":
                decode = dict(fed=fed, want=want, floors=floors)
            elif case == "verify":
                # for the record: the verify (kernels, and plain) against
                # the plain decode of the same tokens, beside the decode's
                # floor; the paged prefill at Tq 4 and the paged decode
                # round their f32 sums to bf16 apart
                for i in range(1, 5):
                    d = decode["want"][i]
                    floor = min(_cosine(d, f[i]) for f in decode["floors"])
                    same = [bool(torch.equal(v[i].argmax(-1), d.argmax(-1)))
                            for v in (got, want)]
                    log(f"  1-layer verify ({prec} prefill) position {i} "
                        f"against the plain decode step: cosine kernels "
                        f"{_cosine(got[i], d):.6f}, plain "
                        f"{_cosine(want[i], d):.6f}; greedy tokens equal "
                        f"{same[0]} / {same[1]} (the decode's noise floor "
                        f"{floor:.6f})")
    del engines


# -- MoE's qdq and bf16 stacks, MoE eval and calibration, the tensor route ---

# [moe_qdq]: the 1-layer block comparisons' tokens (dense mode), the
# kernels the 24-layer BF16 and fake-format engines launch (attention
# only: their linears are library products) and the ones they must not
MOE_QDQ_TOKENS = 64
MOE_QDQ_KERNELS = ("flash_attn", "paged_decode")
# [moe_eval]: the packed route's kernels (the attention linears packed,
# the experts qdq stacks); [engine_tensor]: the megakernels and actq stay
# idle at per-tensor scales
MOE_EVAL_KERNELS = ("actq", "gemm_w8", "flash_attn")
TENSOR_KERNELS = ("gemm_w8", "dequant_w8", "flash_attn", "paged_decode")
TENSOR_IDLE_KERNELS = ("actq", "mlp_w8", "gu_actq", "gemm_actq")


def _tree_gib(tree) -> float:
    """Device bytes of every tensor in a parameter tree, in GiB."""
    from arcquant_tpu_torch.quant import packing
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size() / 2 ** 30
    if isinstance(tree, (packing.PackedWeight, packing.PackedWeightI8)):
        return nbytes(*tree) / 2 ** 30
    if isinstance(tree, dict):
        return sum(_tree_gib(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_gib(v) for v in tree)
    return 0.0


def _check_path(counts, busy, idle, what, failures):
    """Every kernel in busy launched, every other one idle (idle=None: the
    KERNEL_INFO kernels outside busy; else those named)."""
    for name in busy:
        if counts[name] <= 0:
            failures.append(f"kernel {name} not launched by {what}")
    for name in (idle if idle is not None
                 else [k for k in KERNEL_INFO if k not in busy]):
        if counts[name] != 0:
            failures.append(f"kernel {name} launched {counts[name]} times "
                            f"by {what}")


def _moe_block_checks(cfg, failures):
    """[moe_qdq], 1 layer at full width: moe_block on the qdq stacks
    (moe.quantize_moe_params, use_kernels=False: the fake activation qdq
    and the bf16 products) against the packed experts (w8 and w4: actq,
    #2 and #15 in dense mode; #6/#7 in dispatch mode), at tensor and at
    row activation scales (channel weight scales), on MOE_QDQ_TOKENS
    tokens in dense mode and in dispatch mode (DENSE_MODE_MAX_T 0,
    capacity T: no drop); the packed dense against the packed dispatch
    too. Both routes run the same router on the same input, so they pick
    the same experts; their f32 products sum in other orders, which can
    round an intermediate to the next bf16 value and the next quantize to
    the next e2m1 code. Bar: logits cosine >= the noise floor measured in
    the same run, the qdq block against itself with every f32 product of
    its stacks (gemm.matmul_f32) times (1 + 2^-22 N(0, 1)), lowest of
    three draws, at most 0.999."""
    from arcquant_tpu_torch.config import QuantConfig
    from arcquant_tpu_torch.kernels import gemm as gk
    from arcquant_tpu_torch.models import moe, quantized

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    raw = moe.init_moe_params(cfg, gen, device="cuda")
    calib = quantized.identity_calib(cfg.replace(num_layers=1), SELECT_FRAC,
                                     device="cuda")[0]
    x = torch.randn((1, MOE_QDQ_TOKENS, cfg.hidden_size), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = MOE_QDQ_TOKENS
    stacks = moe.quantize_moe_params(
        raw, calib, QuantConfig(use_kernels=False, w_scale="channel"))
    real_mm, saved = gk.matmul_f32, moe.DENSE_MODE_MAX_T

    def block(p, qcfg, dense):
        moe.DENSE_MODE_MAX_T = saved if dense else 0
        try:
            with torch.inference_mode():
                return moe.moe_block(cfg, p, x, calib, qcfg,
                                     capacity=None if dense else t).float()
        finally:
            moe.DENSE_MODE_MAX_T = saved

    for fmt in ("w8", "w4"):
        packed = moe.quantize_moe_params_packed(
            raw, calib, QuantConfig(weight_fmt=fmt, w_scale="channel"))
        for scale in ("tensor", "row"):
            q_fake = QuantConfig(use_kernels=False, w_scale="channel",
                                 act_scale=scale)
            q_pk = QuantConfig(use_kernels=True, weight_fmt=fmt,
                               w_scale="channel", act_scale=scale)
            ys = {}
            for mode in ("dense", "dispatch"):
                dense = mode == "dense"
                ys[mode] = block(packed, q_pk, dense)
                y_q = block(stacks, q_fake, dense)
                floors = []
                try:
                    for seed in range(3):
                        g = torch.Generator(device="cuda")
                        g.manual_seed(seed)
                        gk.matmul_f32 = (lambda a, b, g=g:
                                         _noise(real_mm(a, b), g))
                        floors.append(_cosine(y_q,
                                              block(stacks, q_fake, dense)))
                finally:
                    gk.matmul_f32 = real_mm
                cos, bar = _cosine(ys[mode], y_q), min([0.999] + floors)
                ok = cos >= bar and bool(torch.isfinite(ys[mode]).all())
                log(f"  1-layer moe_block {fmt} {scale} scales {mode} mode "
                    f"({t} tokens): packed vs qdq stacks cosine {cos:.7f}, "
                    f"max abs diff "
                    f"{float((ys[mode] - y_q).abs().max()):.4g} (bar: "
                    f">= {bar:.7f}, the floor of 3 draws "
                    f"{[round(f, 7) for f in floors]}, at most 0.999) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"[moe_qdq] {fmt} {scale} {mode}: "
                                    f"packed vs qdq {cos} < {bar}")
            cos = _cosine(ys["dispatch"], ys["dense"])
            ok = cos >= min([0.999] + floors)
            log(f"  1-layer moe_block {fmt} {scale} scales: packed dispatch "
                f"(capacity {t}) vs packed dense cosine {cos:.7f} (bar: >= "
                f"{min([0.999] + floors):.7f}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"[moe_qdq] {fmt} {scale}: dispatch vs "
                                f"dense {cos}")
        del packed
    del raw, stacks
    gc.collect()
    torch.cuda.empty_cache()


def _moe_engine_path(cfg, qcfg, label, card, failures):
    """One 24-layer [moe_qdq] engine: built layer by layer from dummy
    weights (seed 0; InferenceEngine.dummy quantizes each layer as it is
    drawn, so raw and quantized stacks never coexist), generate() on the
    PROMPT_LENS prompts with the launch counts (attention kernels only:
    no actq, no packed GEMM), a timed prefill and NEW_TOKENS decode steps
    on the graph, peak memory, then [graph] (bitwise the eager loop, ms
    in turns, idle share). Returns (launches, metrics)."""
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import quantized

    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    calib = quantized.identity_calib(cfg, SELECT_FRAC, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngine.dummy(cfg, calib, qcfg, ecfg, seed=0,
                                device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    layers_gib = _tree_gib(eng.qparams["layers"])
    kernels = all_kernels()
    reset_counts(kernels)
    out = eng.generate(prompts_for(cfg), NEW_TOKENS)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    log(f"  {label}: built in {build_s:.1f} s ({layers_gib:.3f} GiB of "
        f"layers, build peak {build_peak:.3f} GiB); launches in generate(): "
        f"{launches}; first tokens {[o[:6] for o in out]}")
    _check_path(launches, MOE_QDQ_KERNELS, None, f"[moe_qdq] {label}",
                failures)
    if [len(o) for o in out] != [NEW_TOKENS] * len(PROMPT_LENS):
        failures.append(f"[moe_qdq] {label}: generate lengths "
                        f"{[len(o) for o in out]}")
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, dec_ms, finite = _serve_timing(eng, prompts_for(cfg))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not finite:
        failures.append(f"[moe_qdq] {label}: non-finite logits")
    graph = graph_check(eng, f"[moe_qdq] {label}", card, failures)
    metrics = dict(prefill_ms=round(prefill_ms, 3),
                   decode_ms_per_step=round(dec_ms, 3),
                   build_s=round(build_s, 1), layers_gib=round(layers_gib, 3),
                   build_peak_memory_gib=round(build_peak, 3),
                   serve_peak_memory_gib=round(peak, 3),
                   graph=graph, card=card)
    log(f"  [moe_qdq] {label} {cfg.name} {cfg.num_layers} layers bs=4: "
        f"{json.dumps(metrics)}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, metrics


def moe_qdq_run(cfg, card, failures):
    """[moe_qdq]: Qwen1.5-MoE-A2.7B at full width. The 1-layer block
    checks (_moe_block_checks), then the 24-layer BF16 engine (the bf16
    expert stacks) and the NVFP4 fake-format engine (use_kernels=False,
    ARC 0.125, per-row activation and per-channel weight scales, the bf16
    head; the experts as qdq stacks), each through _moe_engine_path.
    Returns {"BF16": launches, "fake": launches}."""
    from arcquant_tpu_torch.config import QuantConfig

    t_phase = time.perf_counter()
    _moe_block_checks(cfg, failures)
    paths = {}
    for label, qcfg in (
            ("BF16", QuantConfig(quant_type="BF16")),
            ("fake", QuantConfig(quant_type="NVFP4", use_kernels=False,
                                 act_scale="row", w_scale="channel"))):
        paths[label], _ = _moe_engine_path(cfg, qcfg, label, card, failures)
    log(f"  [moe_qdq] took {time.perf_counter() - t_phase:.1f} s on {card}")
    return paths


def engine_tensor_run(card, failures):
    """[engine_tensor]: the Qwen2.5-7B packed w8 engine (28 layers, dummy
    weights from seed 0, ARC 0.125, packed head) at act_scale "tensor":
    one f32 scale a site activation through the unfused chain (no actq,
    no megakernel). generate() on the PROMPT_LENS prompts with its launch
    counts (TENSOR_IDLE_KERNELS 0), then [graph] (the decode graph
    bitwise the eager loop), then prefill ms and decode ms/step in turns
    beside the same weights at row scales (tensor, row, tensor, row).
    Then the engine cut to 1 layer (seed 1) against the plain versions
    (engine_vs_plain at its prefill and 4 decode steps, held to the floor
    of GEMM and paged decode noise: one scale a tensor ties every row's
    e2m1 codes to the tensor's largest element, so paged decode's
    one-ulp outputs can move a whole step, as at a calibration's Kq), and
    where the tensor route's logits sit: the 1-layer
    prefill logits of the packed and the fake (use_kernels=False) routes
    at each scale on those weights, each against BF16's, and tensor
    against row within each route, for the record. Returns the tensor
    engine's generate() launches."""
    from arcquant_tpu_torch.config import QuantConfig, get_model_config
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import quantized

    t_phase = time.perf_counter()
    cfg = get_model_config(MODEL)
    row = QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
                      act_scale="row", w_scale="channel",
                      quantize_lm_head=True)
    tensor = row.replace(act_scale="tensor")
    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    calib = quantized.identity_calib(cfg, SELECT_FRAC, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    eng = {"tensor": InferenceEngine.dummy(cfg, calib, tensor, ecfg, seed=0,
                                           device="cuda")}
    kernels = all_kernels()
    reset_counts(kernels)
    out = eng["tensor"].generate(prompts_for(cfg), NEW_TOKENS)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    log(f"  tensor scales: launches in generate(): {launches}; tokens "
        f"{[o[:8] for o in out]}; #12-#14 launches "
        f"{[launches[k] for k in ('mlp_w8', 'gu_actq', 'gemm_actq')]} "
        f"(bar: 0)")
    _check_path(launches, TENSOR_KERNELS, TENSOR_IDLE_KERNELS,
                "[engine_tensor]", failures)
    graph = graph_check(eng["tensor"], "[engine_tensor] tensor scales", card,
                        failures)
    eng["row"] = InferenceEngine.dummy(cfg, calib, row, ecfg, seed=0,
                                       device="cuda")
    times = {"tensor": [], "row": []}
    for name in ("tensor", "row") * 2:
        p_ms, d_ms, finite = _serve_timing(eng[name], prompts_for(cfg))
        times[name].append((round(p_ms, 3), round(d_ms, 3)))
        if not finite:
            failures.append(f"[engine_tensor] {name}: non-finite logits")
    log(f"  (prefill ms, decode ms/step) in turns: {times}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    cfg1 = cfg.replace(num_layers=1)
    calib1 = quantized.identity_calib(cfg1, SELECT_FRAC, device="cuda")
    e = InferenceEngine.dummy(cfg1, calib1, tensor, ecfg, seed=1,
                              device="cuda")
    engine_vs_plain(e, "[engine_tensor] 1-layer w8 tensor scales", failures,
                    paged_floor=True)
    del e
    fake = QuantConfig(quant_type="NVFP4", use_kernels=False,
                       act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    logits = {}
    for name, q in (("BF16", QuantConfig(quant_type="BF16")),
                    ("packed row", row), ("packed tensor", tensor),
                    ("fake row", fake),
                    ("fake tensor", fake.replace(act_scale="tensor"))):
        e = InferenceEngine.dummy(cfg1, calib1, q, ecfg, seed=1,
                                  device="cuda")
        toks, lens, _ = e._pad_prompts(prompts_for(cfg1, seed=1))
        logits[name] = e.prefill(e.new_state(), toks, lens)[0].float()
        del e
    to_bf16 = {k: round(_cosine(v, logits["BF16"]), 6)
               for k, v in logits.items() if k != "BF16"}
    pairs = {f"{a} vs {b}": round(_cosine(logits[a], logits[b]), 6)
             for a, b in (("packed tensor", "packed row"),
                          ("fake tensor", "fake row"),
                          ("packed tensor", "fake tensor"),
                          ("packed row", "fake row"))}
    log(f"  1 layer (seed 1), prefill logits cosine against BF16's: "
        f"{to_bf16}; between routes: {pairs} (for the record)")
    log(f"  [engine_tensor] {json.dumps(dict(times=times, graph=graph))}")
    log(f"  [engine_tensor] took {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")
    return launches


# -- [tp] and [lm_eval] --------------------------------------------------------

# [tp]: Qwen2.5-7B at tp 2, both ranks on cuda:0, the collectives over gloo.
TP_RANKS = 2
# generate --tp 2's kernels: actq at the column sites (the row sites'
# quantize is plain torch, as in the JAX package), the GEMMs at every
# site, the large-M route's dequant_w8 at o and gate-up (N >= Kq) in the
# prefill, flash attention in the prefill and paged decode; the TP layer
# fuses nothing and runs no chunked prefill.
TP_KERNELS = ("actq", "gemm_w8", "dequant_w8", "flash_attn", "paged_decode")
# Exact ARC's sites: (name, K, select at 0.125 rounded up to 16 x tp), the
# rows quantized.
TP_EXACT_ROWS = (4, 1024)
# The weight seeds of the ARC TP cut against the plain versions.
TP_ARC_SEEDS = (1, 2)
# [lm_eval]: make_lm at Qwen2.5-7B width cut to 2 layers, packed w8 at row
# scales; eight requests, a stream of rolling windows.
LM_EVAL_LAYERS = 2
LM_EVAL_MAX_LEN = 2048
LM_EVAL_STREAM = 3000
LM_EVAL_KERNELS = ("actq", "gemm_w8", "dequant_w8", "flash_attn")


def _tp_exact_sites(ctx, cfg):
    """[tp] check 4 on one rank: exact ARC (tp_exact_arc) at Qwen2.5-7B's
    o and down sites, select 0.125 rounded up to 16 x tp: the rank's
    shard of a random weight and its quantize of outlier activations at
    TP_EXACT_ROWS rows (every rank draws the same tensors). Returns
    {(site, m): (xa, gx)} on the host, and on rank 0 also the inputs
    under (site, m, "x") and (site, "calib")."""
    from arcquant_tpu_torch.models import quantized
    from arcquant_tpu_torch.parallel import tp as tpm

    tp, rank = ctx.tp, ctx.rank
    base = quantized.identity_calib(cfg.replace(num_layers=1), SELECT_FRAC)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    out = {}
    for site, calib_site, k in (("o", "o_in", cfg.q_size),
                                ("down", "down_in", cfg.intermediate_size)):
        sel = base[0][calib_site].select_num
        ke = -(-sel // (16 * tp)) * (16 * tp)
        ridx = torch.randperm(k, generator=gen, device="cuda").to(torch.int32)
        w = bf16_randn(gen, (cfg.hidden_size, k), k ** -0.5)
        calib = quantized.SiteCalib(ridx, ke)
        _, idx, pos, kc, _ = tpm.shard_linear_row(
            w, None, calib, tp, "w8", rank, "channel", exact=True)
        ks = k // tp
        if rank == 0:
            out[(site, "calib")] = (ridx.cpu(), ke)
        for m in TP_EXACT_ROWS:
            x = bf16_randn(gen, (m, k))
            cols = torch.randperm(k, generator=gen, device="cuda")[:k // 32]
            x[:, cols] *= 25
            xa, gx = tpm._quantize_x_rowshard_exact(
                x[:, rank * ks:(rank + 1) * ks], idx, pos, kc, ke, ks + kc,
                ctx, per_row=True)
            out[(site, m)] = (xa.cpu(), gx.cpu())
            if rank == 0:
                out[(site, m, "x")] = x.cpu()
        del w
    return out


def _tp_checks(ctx):
    """[tp] checks 2-4 on one rank (rank 0 logs; every rank returns its
    failures), each engine at 1 layer:

    2. the select-free TP engine (seed 1) against the single-device
       InferenceEngine on the same weights (rank 0 runs it; the other
       ranks join the TP run's collectives): engine_vs_plain with the
       single-device engine as the reference, its kernels kept, held to
       0.999 or the floor of GEMM and paged-decode noise where lower;
    3. for each weight seed of TP_ARC_SEEDS, the ARC 0.125 TP engine with
       the kernels against itself on the plain versions (engine_vs_plain,
       held to that floor), then against the plain versions with paged
       decode kept on the card (the flat 1-layer bar: every other
       kernel), then once more with every kernel of the step held to its
       plain version call by call at the rank's shapes (beside_plain:
       #10 at 14/2 heads and the [tp] sequence lengths among them);
    4. exact ARC's sharded quantize (returned for _tp_exact_gate)."""
    from arcquant_tpu_torch.config import QuantConfig, get_model_config
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import quantized
    from arcquant_tpu_torch.parallel import TPInferenceEngine

    global _QUIET
    _QUIET = ctx.rank != 0
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    cfg = get_model_config(MODEL)
    cfg1 = cfg.replace(num_layers=1)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
                       act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    calib = quantized.identity_calib(cfg1, 0.0, device=ctx.device)
    eng = TPInferenceEngine.dummy(cfg1, calib, qcfg, ecfg, ctx, seed=1)
    if ctx.rank == 0:
        single = InferenceEngine.dummy(cfg1, calib, qcfg, ecfg, seed=1,
                                       device=ctx.device)
        engine_vs_plain(eng, "[tp] 1-layer select-free TP vs single-device",
                        failures, paged_floor=True, ref=single,
                        real=tuple(KERNEL_INFO))
        del single
    else:
        engine_steps(eng)            # rank 0's TP run, its collectives
    calib = quantized.identity_calib(cfg1, SELECT_FRAC, device=ctx.device)
    for seed in TP_ARC_SEEDS:
        del eng
        eng = TPInferenceEngine.dummy(cfg1, calib, qcfg, ecfg, ctx,
                                      seed=seed)
        what = f"[tp] 1-layer ARC 0.125 TP, weights of seed {seed},"
        engine_vs_plain(eng, f"{what} kernels vs plain", failures,
                        paged_floor=True)
        engine_vs_plain(eng, f"{what} kernels vs plain but paged decode",
                        failures, real=("paged_decode",))
        with beside_plain(TP_KERNELS) as seen:
            engine_steps(eng)
        plain_gate(seen, what, failures)
    del eng
    return dict(failures=failures, exact=_tp_exact_sites(ctx, cfg))


def _tp_exact_gate(exact, tp, failures):
    """[tp] check 4's gate: the ranks' exact-ARC quantize re-assembled
    (plain columns, then residual chunks, in rank order) equals
    quantize_x_arc's xa and gx bit for bit (actq on the card)."""
    from arcquant_tpu_torch.kernels import quantize as qk

    r0 = exact[0]
    for site in ("o", "down"):
        ridx, ke = r0[(site, "calib")]
        for m in TP_EXACT_ROWS:
            x = r0[(site, m, "x")].cuda()
            k = x.shape[1]
            ks, kc = k // tp, ke // tp
            xa_ref, gx_ref = qk.quantize_x_arc(x, ridx.cuda(), ke)
            parts = [e[(site, m)] for e in exact]
            plain = torch.cat([xa[:, :ks] for xa, _ in parts], dim=1)
            res = torch.cat([xa[:, ks:ks + kc] for xa, _ in parts], dim=1)
            ok = (bitwise(plain, xa_ref[:, :k].cpu())
                  and bitwise(res, xa_ref[:, k:k + ke].cpu())
                  and all(bitwise(gx, gx_ref.cpu()) for _, gx in parts))
            log(f"  exact ARC at {site} (K {k}, select {ke}, {kc} residual "
                f"columns a rank), M {m}: the ranks' quantize re-assembled "
                f"{'bitwise equal to' if ok else 'DIFFERS from'} "
                f"quantize_x_arc (xa and gx) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"[tp] exact ARC {site} M {m} differs from "
                                "quantize_x_arc")


def tp_run(card, failures):
    """[tp]: tensor parallelism at Qwen2.5-7B full width over two ranks on
    the one card (gloo, parallel/mesh.py's launcher). 1. ``python -m
    arcquant_tpu_torch.generate --tp 2 --dist_backend gloo --check_ranks
    --quant_head`` through its main(): 28 layers, ARC 0.125, generate's
    qcfg (w8, row and channel scales) with the packed W4A16 head, the four
    [engine] prompts, 32 greedy tokens; each rank's prefill ms, decode ms/step,
    all_reduces a decode step and their ms, peak memory and launch counts
    (the path generate_tp); gates: the ranks' tokens and every step's
    logits bitwise equal (main raises otherwise), 2 SUM and 2 MAX
    all_reduces a layer a decode step, the path's kernels launched and no
    other. 2-4 in one more launch (_tp_checks) on 1-layer cuts, also
    with the packed head. Returns rank 0's launch counts."""
    from arcquant_tpu_torch import generate
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    cfg = get_model_config(MODEL)
    argv = ["--model", MODEL, "--tp", str(TP_RANKS), "--dist_backend",
            "gloo", "--max_new", str(NEW_TOKENS), "--check_ranks",
            "--quant_head"]
    for p in prompts_for(cfg):
        argv += ["--tokens", ",".join(map(str, p))]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = generate.main(argv)
    except Exception as e:       # a rank's failure, or ranks that disagree
        failures.append(f"[tp] generate --tp {TP_RANKS}: "
                        f"{type(e).__name__}: {e}")
        return None
    log(f"  python -m arcquant_tpu_torch.generate --tp {TP_RANKS} "
        f"--dist_backend gloo --quant_head (4 prompts of {PROMPT_LENS} tokens, "
        f"{NEW_TOKENS} new, 28 layers): {time.perf_counter() - t0:.1f} s "
        f"wall, the ranks' spawn and engine builds included; every step's "
        f"logits bitwise equal across the {TP_RANKS} ranks "
        f"({len(ranks[0]['steps'])} steps) ok")
    log(f"  (both ranks time-share one card and meet through the host "
        f"over gloo: these times are not tensor-parallel speed figures; "
        f"{card})")
    layers = cfg.num_layers
    for r, res in enumerate(ranks):
        pre = [s for s in res["steps"] if s["kind"] == "prefill"]
        dec = [s for s in res["steps"] if s["kind"] == "decode"]
        ms = [s["ms"] for s in dec]
        comm = [s["comm_ms"] for s in dec]
        pre_ms = ", ".join(f"{s['ms']:.2f}" for s in pre)
        log(f"  rank {r}: prefill {pre_ms} ms; decode {statistics.median(ms):.2f} ms/step (min "
            f"{min(ms):.2f}, max {max(ms):.2f}, {len(ms)} steps); a decode "
            f"step's all_reduces {dec[0]['comm']} in "
            f"{statistics.median(comm):.2f} ms (median, host clock, device "
            f"synchronized around each); peak device memory "
            f"{res['peak_bytes'] / 2 ** 30:.2f} GiB")
        bad = [s["comm"] for s in dec
               if s["comm"] != {"sum": 2 * layers, "max": 2 * layers}]
        if bad:
            failures.append(f"[tp] rank {r}: a decode step's all_reduces "
                            f"{bad[0]} != 2 SUM + 2 MAX a layer")
    counts = [dict({n: res["launches"].get(n, 0) for n in KERNEL_INFO},
                   actq_by_m=dict(sorted(res["actq_by_m"].items())))
              for res in ranks]
    log(f"  launches per rank (generate_tp): "
        f"{ {k: v for k, v in counts[0].items() if v} }")
    if any(c != counts[0] for c in counts[1:]):
        failures.append(f"[tp] the ranks' launch counts differ: {counts}")
    log(f"  the rank 0 outputs' first tokens: "
        f"{[o[:8] for o in ranks[0]['outputs']]}")
    _check_path(counts[0], TP_KERNELS, None, "[tp] generate --tp 2",
                failures)

    log(f"  [tp] 1-layer checks: select-free against the single device, "
        f"ARC 0.125 kernels against the plain versions, exact ARC, on "
        f"{TP_RANKS} ranks over gloo")
    gc.collect()
    torch.cuda.empty_cache()
    try:
        checks = launch(_tp_checks, TP_RANKS, "gloo")
    except Exception as e:
        failures.append(f"[tp] checks: {type(e).__name__}: {e}")
        return counts[0]
    for r, res in enumerate(checks):
        failures.extend(f"rank {r}: {f}" for f in res["failures"])
    _tp_exact_gate([res["exact"] for res in checks], TP_RANKS, failures)
    log(f"  [tp] took {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts[0]


class _WordTok:
    """A toy word tokenizer for [lm_eval] (the card has no transformers):
    the word w<i> is id i, any other word a hash of it; decode writes
    w<i> words."""
    bos_token_id = 1

    def __init__(self, vocab_size):
        self.vocab = vocab_size

    def encode(self, text):
        import zlib
        return [int(w[1:]) if w[:1] == "w" and w[1:].isdigit()
                and int(w[1:]) < self.vocab
                else 2 + zlib.crc32(w.encode()) % (self.vocab - 2)
                for w in text.split()]

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids)


class _Req:
    def __init__(self, *args):
        self.args = args


@contextlib.contextmanager
def _stub_lm_eval():
    """A minimal lm_eval package (api.model.LM) in sys.modules, as the
    port's test builds it: the card has no lm_eval."""
    import types
    pkg = types.ModuleType("lm_eval")
    api = types.ModuleType("lm_eval.api")
    mdl = types.ModuleType("lm_eval.api.model")

    class LM:
        def __init__(self):
            pass

    mdl.LM, api.model, pkg.api = LM, mdl, api
    saved = {k: sys.modules.get(k) for k in
             ("lm_eval", "lm_eval.api", "lm_eval.api.model")}
    sys.modules.update({"lm_eval": pkg, "lm_eval.api": api,
                        "lm_eval.api.model": mdl})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def lm_eval_run(card, failures):
    """[lm_eval]: evals/lm_eval_adapter.py's make_lm at Qwen2.5-7B width
    cut to LM_EVAL_LAYERS layers, dummy weights from seed 0, packed w8 at
    row scales with ARC 0.125 (#1, #2, #6 at gate/up, #9), through a stub
    lm_eval and a toy word tokenizer: loglikelihood of 8 requests (one
    batch of 8), loglikelihood_rolling of a LM_EVAL_STREAM-token stream in
    windows of LM_EVAL_MAX_LEN, generate_until; each timed, with the
    launch counts of the three calls. Gates: each loglikelihood equals
    evals/tasks.py's scorer on the same token sequences in the same padded
    batch within 1e-3 (the JAX adapter test's bar); the rolling value
    equals the sum of its windows, each scored by that scorer alone,
    within 1e-3 a window; generate_until stops at its string (and without
    one runs its max_gen_toks). Then the kernels against their plain
    versions on this path: the three calls again with every call of the
    path's kernels held to its plain version on the same inputs
    (beside_plain: actq at M 256, 8192 and 16384, the GEMMs and #6 at M
    8192 and 16384, #9 at B 8, T 1024 and 2048), and the nine scores
    (eight logliks, the rolling one) on the plain versions: the kernels'
    RMS distance from them (each in nats over the square root of the
    tokens it sums) at most twice the farthest of three draws of the plain versions carrying the kernels' own
    departures (actq_kernel_order, which is actq's bits; the w8 GEMM's and
    #9's bf16 outputs an ulp off on the shares at which the kernels'
    calls within their bars differ from the plain versions in the spied
    run, so a wrong call cannot widen the floor). Returns the launch
    counts."""
    from arcquant_tpu_torch.config import QuantConfig, get_model_config
    from arcquant_tpu_torch.evals import lm_eval_adapter as A
    from arcquant_tpu_torch.evals import tasks as T
    from arcquant_tpu_torch.kernels import attention, gemm as gk
    from arcquant_tpu_torch.kernels import quantize as qk
    from arcquant_tpu_torch.models import llama, quantized

    t_phase = time.perf_counter()
    cfg = get_model_config(MODEL).replace(num_layers=LM_EVAL_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, torch.bfloat16, "cuda")
    calib = quantized.identity_calib(cfg, SELECT_FRAC, device="cuda")
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
                       act_scale="row")
    qp = quantized.quantize_model_params(cfg, params, calib, qcfg,
                                         consume=True)
    del params
    tok = _WordTok(cfg.vocab_size)
    rng = np.random.default_rng(11)

    def words(n):
        return " ".join(f"w{i}" for i in rng.integers(2, cfg.vocab_size, n))

    reqs = [(words(n), " " + words(c)) for n, c in
            ((12, 3), (40, 1), (100, 8), (5, 20), (300, 4), (700, 2),
             (64, 64), (1, 1))]
    stream = words(LM_EVAL_STREAM)
    prompts = (words(30), words(30))
    every = all_kernels()
    with _stub_lm_eval():
        lm = A.make_lm(cfg, qp, calib, qcfg, tok, batch_size=8,
                       max_len=LM_EVAL_MAX_LEN)

    def calls(timed=None):
        """The three calls: (logliks, the rolling loglik, generations)."""
        t0 = time.perf_counter()
        lls = lm.loglikelihood([_Req(*r) for r in reqs])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rolled, = lm.loglikelihood_rolling([_Req(stream)])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outs = lm.generate_until([_Req(prompts[0], {"until": [" "],
                                                    "max_gen_toks": 3}),
                                  _Req(prompts[1], {"max_gen_toks": 3})])
        torch.cuda.synchronize()
        if timed is not None:
            timed.update(loglikelihood=t1 - t0,
                         loglikelihood_rolling=t2 - t1,
                         generate_until=time.perf_counter() - t2)
        return lls, rolled, outs

    torch.cuda.synchronize()
    reset_counts(every)
    times = {}
    lls, rolled, outs = calls(times)
    counts = launch_counts(every)
    log(f"  make_lm at {MODEL} width, {LM_EVAL_LAYERS} layers, packed w8 "
        f"row, ARC {SELECT_FRAC}: loglikelihood of {len(reqs)} requests "
        f"{times['loglikelihood'] * 1e3:.1f} ms, loglikelihood_rolling of "
        f"{LM_EVAL_STREAM} tokens in windows of {LM_EVAL_MAX_LEN} "
        f"{times['loglikelihood_rolling'] * 1e3:.1f} ms, generate_until of "
        f"2 requests {times['generate_until'] * 1e3:.1f} ms (host clock, "
        f"{card})")
    log(f"  launches (lm_eval): { {k: v for k, v in counts.items() if v} }")
    _check_path(counts, LM_EVAL_KERNELS, None, "[lm_eval]", failures)

    scorer = A._Scorer(cfg, qp, calib, qcfg, batch_size=8,
                       max_len=LM_EVAL_MAX_LEN)
    ll_fn = T.make_loglikelihood_fn(cfg, qp, qcfg, calib)
    rows = []
    for ctx, cont in reqs:
        ctx_t = tok.encode(ctx)
        rows.append((ctx_t + tok.encode(ctx + cont)[len(ctx_t):],
                     len(ctx_t)))
    order = sorted(range(len(rows)), key=lambda i: len(rows[i][0]))
    want = ll_fn(*scorer._pad_batch([rows[i] for i in order])).float().cpu()
    diff = max(abs(lls[i][0] - float(want[j])) for j, i in enumerate(order))
    ok = diff <= 1e-3 and all(np.isfinite(ll) and ll < 0 for ll, _ in lls)
    log(f"  loglikelihood against tasks.py's scorer on the same sequences "
        f"and batch: max |diff| {diff:.3g} (bar 1e-3; values "
        f"{[round(ll, 2) for ll, _ in lls]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[lm_eval] loglikelihood off the scorer by {diff}")
    # the rolling windows, each scored alone: [bos] + the first
    # max_len - 1 tokens, then max_len - 1 more after one token of context
    toks = tok.encode(stream)
    windows, start = [], 0
    while start < len(toks):
        win = toks[max(0, start - 1):start + LM_EVAL_MAX_LEN - 1]
        if start == 0:
            win = [tok.bos_token_id] + win
        windows.append(win)
        start += len(win) - 1
    parts = [float(ll_fn(*scorer._pad_batch([(w, 1)] + [([0, 0], 1)] * 7))
                   [0]) for w in windows]
    diff = abs(rolled - sum(parts))
    ok = diff <= 1e-3 * len(windows) and np.isfinite(rolled)
    log(f"  loglikelihood_rolling {rolled:.3f} against the sum of its "
        f"{len(windows)} windows {sum(parts):.3f}: |diff| {diff:.3g} (bar "
        f"1e-3 a window) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[lm_eval] rolling {rolled} != windows "
                        f"{sum(parts)}")
    ok = len(outs[0].split()) == 1 and len(outs[1].split()) == 3
    log(f"  generate_until: {outs} (the first stops at its string \" \" "
        f"after one token, the second, with none, runs its 3: "
        f"{'ok' if ok else 'FAIL'})")
    if not ok:
        failures.append(f"[lm_eval] generate_until kept its stop string: "
                        f"{outs}")

    # the kernels against their plain versions on this path's inputs
    with beside_plain(LM_EVAL_KERNELS) as seen:
        calls()
    plain_gate(seen, "[lm_eval]", failures)
    share = {k: seen[k]["share"] for k in ("gemm_w8", "flash_attn")}

    def scores():
        lls_, rolled_, _ = calls()
        return [ll for ll, _ in lls_] + [rolled_]

    def flipped_gemm(*a):
        y = gk.gemm_w8_plain(*a)
        return (_ulp_flips(y, gen, share["gemm_w8"])
                if y.dtype == torch.bfloat16 else y)

    got = [ll for ll, _ in lls] + [rolled]
    draws = []
    with PlainKernels():
        plain = scores()
        for seed in range(3):
            gen.manual_seed(20 + seed)
            qk._actq_cuda = qk.actq_kernel_order
            gk._gemm_w8_cuda = flipped_gemm
            attention._flash_cuda = _flipped_attention(
                attention.flash_attention_plain, gen, share["flash_attn"])
            draws.append(scores())

    # tokens each score sums: the continuations' words, the whole stream
    ntok = [len(cont.split()) for _, cont in reqs] + [LM_EVAL_STREAM]

    def dist(vals):
        """RMS over the scores of |score - plain's| / sqrt(tokens scored):
        per-token departures add up as a random walk."""
        return float(np.sqrt(np.mean([(v - p) ** 2 / n for v, p, n in
                                      zip(vals, plain, ntok)])))

    far = [dist(d) for d in draws]
    bar = 2 * max(far)
    ok = dist(got) <= bar
    log(f"  the 9 scores (8 logliks, the rolling one) against the plain "
        f"versions': RMS distance {dist(got):.4g} nats over sqrt(tokens); "
        f"the draws carrying the kernels' departures (actq_kernel_order, "
        f"the w8 GEMM's outputs an ulp off on {share['gemm_w8']:.4%}, #9's "
        f"on {share['flash_attn']:.4%}) {[float(f'{x:.4g}') for x in far]} "
        f"(bar: twice the farthest, {bar:.4g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[lm_eval] scores {dist(got)} from the plain "
                        f"versions', bar {bar}")
    del qp, lm, scorer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  [lm_eval] took {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts


# -- [pp], [dp], [ep] and [sp] ------------------------------------------------

# [pp]: Qwen2.5-7B at pp 2 (14 layers and their pool a rank), then the MoE
# model cut to MOE_PP_LAYERS layers (packed experts); both stages on cuda:0
# over gloo. The 28-layer path runs generate's kernels (GENERATE_KERNELS),
# its verify the paged prefill.
PP_RANKS = 2
MOE_PP_LAYERS = 2
MOE_PP_NEW = 3
# The verify's drafts after each row's greedy token (W 4).
PP_VERIFY_DRAFTS = (11, 12, 13)
# [dp]: Qwen2.5-7B width cut to DP_LAYERS, dp 2 x tp 2 (4 ranks),
# max_batch 8 (4 slots a dp group), dynamic pages (DP_PAGES split over the
# groups: 24 pages of 128 tokens a group), chunked prefill 512; the twelve
# requests' prompt lengths fill both groups' pools, so the seventh request
# finds no group with pages for it and requeues.
DP, DP_TP, DP_LAYERS = 2, 2, 2
DP_MAX_BATCH, DP_CHUNK, DP_PAGES = 8, 512, 48
DP_PROMPTS = (1500, 1200, 900, 700, 500, 300, 200, 100, 1500, 800, 64, 1000)
DP_NEW = 12
DP_DRAWS = 2
# The batcher's prefills: chunked (paged_prefill) whenever an admission
# holds a prompt over 512 tokens, one-shot (flash_attn) otherwise, so
# flash_attn may or may not run; the TP layer fuses nothing.
DP_KERNELS = ("actq", "gemm_w8", "dequant_w8", "paged_prefill",
              "paged_decode")
DP_IDLE_KERNELS = tuple(k for k in KERNEL_INFO
                        if k not in DP_KERNELS + ("flash_attn",))
# [ep]: Qwen1.5-MoE-A2.7B at tp 2 (30 experts and 8 of 16 heads a rank, the
# experts as qdq stacks): generate --tp 2 at 24 layers, then the cuts of
# EP_CUTS (activation scale, layers, weight seed) against the
# single-device engine on qdq stacks, each noise floor the lowest of
# EP_DRAWS draws. The 2-layer cut at tensor scales runs at a second weight
# seed: at seed 1 its decode 3 sits near its floor.
EP_RANKS, EP_DRAWS = 2, 3
EP_CUTS = (("row", 1, 1), ("row", 2, 1), ("tensor", 1, 1), ("tensor", 2, 1),
           ("tensor", 2, 2))
EP_KERNELS = TP_KERNELS
# [sp]: paged decode's state form at Qwen2.5-7B's attention shapes over sp 2
# (rank r owns tokens [r * SP_BOUND, (r + 1) * SP_BOUND) of each row; the
# 64- and 1056-token rows have none on rank 1), then ring attention.
SP_RANKS, SP_BOUND = 2, 4096
SP_LENS = (8192, 5000, 1056, 64)
SP_RING_T = 4096


def _arc_qcfg():
    from arcquant_tpu_torch.config import QuantConfig
    return QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
                       act_scale="row", w_scale="channel",
                       quantize_lm_head=True)


def _digest(logits) -> str:
    import hashlib
    return hashlib.sha256(logits.float().cpu().numpy().tobytes()).hexdigest()


def _digested(eng) -> list:
    """Wrap eng's prefill and decode_step (on the instance) to append a
    digest of each step's logits to the returned list."""
    out = []
    for name in ("prefill", "decode_step"):
        real = getattr(eng, name)

        def f(*a, real=real, **kw):
            logits, state = real(*a, **kw)
            out.append(_digest(logits))
            return logits, state
        setattr(eng, name, f)
    return out


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device)


def _pp_rank(ctx, model, layers, new_tokens, verify):
    """[pp] on one stage: PPInferenceEngine.dummy (seed 0, ARC 0.125, the
    packed head) through generate() on the [engine] prompts, each step
    recorded (ms, relay traffic, a digest of its logits); with `verify`
    a verify_step at W 4 after a fresh prefill."""
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.engine import EngineConfig
    from arcquant_tpu_torch.models import quantized
    from arcquant_tpu_torch.parallel import PPInferenceEngine, make_pp

    global _QUIET
    _QUIET = ctx.rank != 0
    torch.backends.cuda.matmul.allow_tf32 = False
    pctx = make_pp()
    cfg = get_model_config(model)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    calib = quantized.identity_calib(cfg, SELECT_FRAC, device=pctx.device)
    torch.cuda.reset_peak_memory_stats(pctx.device)
    t0 = time.perf_counter()
    eng = PPInferenceEngine.dummy(cfg, calib, _arc_qcfg(), ecfg, pctx, seed=0)
    build_s = time.perf_counter() - t0
    eng.record_steps()
    kernels = all_kernels()
    reset_counts(kernels)
    outputs = eng.generate(prompts_for(cfg), new_tokens)
    launches = launch_counts(kernels)
    out = dict(outputs=outputs, steps=eng.steps, launches=launches,
               peak_bytes=_peak(pctx.device), build_s=build_s)
    eng.steps = None
    if verify:
        toks, lens, _ = eng._pad_prompts(prompts_for(cfg))
        logits, state = eng.prefill(eng.new_state(), toks, lens)
        vt = torch.cat([logits.argmax(-1).to(torch.int32)[:, None].cpu(),
                        torch.tensor([PP_VERIFY_DRAFTS] * len(PROMPT_LENS),
                                     dtype=torch.int32)], dim=1)
        vv = torch.full((len(PROMPT_LENS),), vt.shape[1], dtype=torch.int32)
        out["verify"] = eng.verify_step(state, vt, vv)[0].cpu()
        out["verify_in"] = (vt, vv)
    return out


def _pp_single(cfg, new_tokens, verify_in):
    """The single-device eager engine on [pp]'s weights (seed 0): the
    digests of generate()'s steps, its outputs and the verify's logits."""
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import quantized

    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    calib = quantized.identity_calib(cfg, SELECT_FRAC, device="cuda")
    eng = InferenceEngine.dummy(cfg, calib, _arc_qcfg(), ecfg, seed=0,
                                device="cuda", cuda_graphs=False)
    digests = _digested(eng)
    outputs = eng.generate(prompts_for(cfg), new_tokens)
    digests = list(digests)          # generate's steps only
    verify = None
    if verify_in is not None:
        toks, lens, _ = eng._pad_prompts(prompts_for(cfg))
        _, state = eng.prefill(eng.new_state(), toks, lens)
        verify = eng.verify_step(state, *verify_in)[0].cpu()
    del eng
    return digests, outputs, verify


def _pp_gate(ranks, single, what, failures) -> None:
    """[pp]'s gates: both stages' outputs and digests equal, and every
    step's logits bitwise the single-device eager engine's (digests)."""
    digests, outputs, _ = single
    got = [[s["digest"] for s in r["steps"]] for r in ranks]
    same_ranks = all(g == got[0] for g in got) and all(
        r["outputs"] == ranks[0]["outputs"] for r in ranks)
    n_eq = sum(a == b for a, b in zip(got[0], digests))
    ok = (same_ranks and len(got[0]) == len(digests)
          and n_eq == len(digests) and ranks[0]["outputs"] == outputs)
    log(f"  {what}: {n_eq} of {len(digests)} steps' logits bitwise equal to "
        f"the single-device eager engine fed the same tokens, the stages' "
        f"logits and tokens {'equal' if same_ranks else 'DIFFER'} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{what}: PP logits differ from the single-device "
                        f"engine ({n_eq} of {len(digests)} steps equal, "
                        f"stages agree {same_ranks})")


def _rank_times(ranks, what) -> None:
    for r, res in enumerate(ranks):
        pre = [s for s in res["steps"] if s["kind"] == "prefill"]
        dec = [s for s in res["steps"] if s["kind"] == "decode"]
        ms = [s["ms"] for s in dec]
        log(f"  {what} rank {r}: prefill {pre[0]['ms']:.2f} ms (relay "
            f"{pre[0]['comm_bytes'] / 2 ** 20:.2f} MiB in "
            f"{pre[0]['comm_ms']:.2f} ms); decode "
            f"{statistics.median(ms):.2f} ms/step (min {min(ms):.2f}, "
            f"{len(ms)} steps), a step's collectives {dec[0]['comm']}, "
            f"{dec[0]['comm_bytes']} bytes in "
            f"{statistics.median(s['comm_ms'] for s in dec):.3f} ms "
            f"(median, host clock, device synchronized around each); peak "
            f"device memory {res['peak_bytes'] / 2 ** 30:.2f} GiB")


def _summed(ranks) -> dict:
    """The stages' launch counts summed (actq's by M too)."""
    out = {n: sum(r["launches"][n] for r in ranks) for n in KERNEL_INFO}
    by_m = {}
    for r in ranks:
        for m, n in r["launches"]["actq_by_m"].items():
            by_m[m] = by_m.get(m, 0) + n
    out["actq_by_m"] = dict(sorted(by_m.items()))
    return out


def pp_run(card, failures):
    """[pp]: pipeline parallelism over PP_RANKS stages on the one card
    (gloo, the relay's payloads through the host). 1. Qwen2.5-7B, 28
    layers (14 and their pool a stage), ARC 0.125, row scales, channel
    weight scales, the packed W4A16 head: the four [engine] prompts and
    32 greedy tokens through PPInferenceEngine.generate, each stage's
    prefill ms, decode ms/step, relay bytes and ms a step and peak
    memory; gates: every step's logits bitwise the single-device eager
    engine's on the same weights fed the same tokens, then verify_step at
    W 4 likewise; the path generate_pp (the stages' launches summed).
    2. Qwen1.5-MoE-A2.7B cut to MOE_PP_LAYERS, packed experts (#15):
    prefill and MOE_PP_NEW decode steps bitwise the single-device engine
    (moe_pp). Returns both paths' launch counts."""
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    cfg = get_model_config(MODEL)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = launch(_pp_rank, PP_RANKS, "gloo",
                       args=(MODEL, 0, NEW_TOKENS, True))
    except Exception as e:
        failures.append(f"[pp] {MODEL}: {type(e).__name__}: {e}")
        return None, None
    log(f"  PPInferenceEngine.generate, {MODEL} 28 layers over {PP_RANKS} "
        f"stages, 4 prompts of {PROMPT_LENS} tokens, {NEW_TOKENS} new: "
        f"{time.perf_counter() - t0:.1f} s wall (spawn and builds "
        f"{', '.join(f'{r['build_s']:.1f}' for r in ranks)} s included)")
    log(f"  (the stages time-share one card and relay through the host "
        f"over gloo: these times are no pipeline-parallel speed figures; "
        f"{card})")
    _rank_times(ranks, "[pp]")
    single = _pp_single(cfg, NEW_TOKENS, ranks[0]["verify_in"])
    _pp_gate(ranks, single, f"[pp] {MODEL} 28 layers", failures)
    vok = all(bitwise(r["verify"], single[2]) for r in ranks)
    log(f"  [pp] verify_step at W {ranks[0]['verify_in'][0].shape[1]}: "
        f"logits {'bitwise equal to' if vok else 'DIFFER from'} the "
        f"single-device engine's {'ok' if vok else 'FAIL'}")
    if not vok:
        failures.append("[pp] verify_step differs from the single-device "
                        "engine")
    pp_counts = _summed(ranks)
    log(f"  launches, the stages summed (generate_pp): "
        f"{ {k: v for k, v in pp_counts.items() if v} }")
    _check_path(pp_counts, GENERATE_KERNELS, ARC_IDLE_KERNELS,
                "[pp] generate", failures)
    del ranks, single

    moe_cfg = get_model_config(MOE_MODEL).replace(num_layers=MOE_PP_LAYERS)
    try:
        ranks = launch(_pp_rank, PP_RANKS, "gloo",
                       args=(MOE_MODEL, MOE_PP_LAYERS, MOE_PP_NEW, False))
    except Exception as e:
        failures.append(f"[pp] {MOE_MODEL}: {type(e).__name__}: {e}")
        return pp_counts, None
    _rank_times(ranks, f"[pp] {MOE_MODEL} {MOE_PP_LAYERS} layers")
    _pp_gate(ranks, _pp_single(moe_cfg, MOE_PP_NEW, None),
             f"[pp] {MOE_MODEL} {MOE_PP_LAYERS} layers, packed experts",
             failures)
    moe_counts = _summed(ranks)
    log(f"  launches, the stages summed (moe_pp): "
        f"{ {k: v for k, v in moe_counts.items() if v} }")
    _check_path(moe_counts, MOE_KERNELS["w8"], MOE_IDLE_KERNELS["w8"],
                "[pp] MoE generate", failures)
    log(f"  [pp] took {time.perf_counter() - t_phase:.1f} s on {card}")
    return pp_counts, moe_counts


class _Calls:
    """A dp engine's prefill and decode_step calls in order, each with its
    inputs and the page table it ran on (host copies) and its logits."""

    def __init__(self, eng):
        self.calls = []
        for name in ("prefill", "decode_step"):
            real = getattr(eng, name)

            def f(state, *a, real=real, name=name, **kw):
                pt = state[1].cpu().clone()
                logits, state = real(state, *a, **kw)
                self.calls.append((name, pt, [None if x is None else
                                              torch.as_tensor(x).cpu()
                                              for x in a],
                                   logits.float().cpu()))
                return logits, state
            setattr(eng, name, f)


def _replay(eng, calls, pages_local):
    """Feed a dp 1 engine the recorded calls, each on its page table with
    group g's local page p as global page g * pages_local + p (0 stays the
    sink): the logits of each call."""
    state = eng.new_state()
    spg = eng.ecfg.max_batch // DP
    group = (torch.arange(eng.ecfg.max_batch) // spg)[:, None]
    outs = []
    for name, pt, args, _ in calls:
        state[1].copy_(torch.where(pt > 0, pt + group * pages_local, pt))
        logits, state = getattr(eng, name)(state, *args)
        outs.append(logits.float().cpu())
    return outs


def _dp_rank(ctx):
    """[dp] on one rank of the dp 2 x tp 2 mesh: the TP engine (seed 0,
    ARC 0.125) under ContinuousBatcher with the twelve requests, then its
    calls replayed on the dp 1 TP engine of the same weights (this rank's
    tp group, the batch replicated over the dp groups): with the kernels,
    on the plain versions, and DP_DRAWS noise_draws; each call's live
    rows through floor_gate (the gate adds equal greedy tokens)."""
    import dataclasses

    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.engine import (ContinuousBatcher, EngineConfig,
                                           Request)
    from arcquant_tpu_torch.models import quantized
    from arcquant_tpu_torch.parallel import TPInferenceEngine, make_mesh

    global _QUIET
    _QUIET = ctx.rank != 0
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(dp=DP, tp=DP_TP)
    cfg = get_model_config(MODEL).replace(num_layers=DP_LAYERS)
    calib = quantized.identity_calib(cfg, SELECT_FRAC, device=mesh.device)
    ecfg = EngineConfig(max_batch=DP_MAX_BATCH, max_seq_len=2048,
                        dynamic_pages=True, prefill_chunk=DP_CHUNK,
                        num_pages=DP_PAGES)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    eng = TPInferenceEngine.dummy(cfg, calib, _arc_qcfg(), ecfg, mesh, seed=0)
    eng.record_steps()
    calls = _Calls(eng)
    bt = ContinuousBatcher(eng)
    spg = bt._slots_per_group
    admit, step = bt._admit, bt.step
    seen = dict(requeued=0, groups=set(), foreign=0)

    def admit_spy():
        admit()
        if bt.queue and any(s is None for s in bt.slots):
            seen["requeued"] += 1
        seen["groups"].update(s // spg for s, r in enumerate(bt.slots)
                              if r is not None)

    def step_spy():
        done = step()
        for s, r in enumerate(bt.slots):
            if r is None:
                continue
            mine = sorted(int(x) for x in bt._pt[s] if x)
            if mine != sorted(bt.allocs[s // spg].owned.get(s, [])) or any(
                    s in a.owned for g, a in enumerate(bt.allocs)
                    if g != s // spg):
                seen["foreign"] += 1
        return done

    bt._admit, bt.step = admit_spy, step_spy
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=DP_NEW) for n in DP_PROMPTS]
    kernels = all_kernels()
    reset_counts(kernels)
    t0 = time.perf_counter()
    for r in reqs:
        bt.submit(r)
    bt.run()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernels)
    out = dict(wall=wall, launches=launches, peak_bytes=_peak(mesh.device),
               errors=[r.error for r in reqs],
               lens=[len(r.output) for r in reqs],
               preempts=sum(r.preempts for r in reqs), seen=seen,
               steps=[{k: s[k] for k in ("kind", "ms", "comm", "comm_ms",
                                          "comm_bytes")} for s in eng.steps],
               freed=all(a.available() == a.capacity and not a.owned
                         for a in bt.allocs))
    pages_local = eng.page_groups()[1]
    eng.steps = None
    del bt
    ref = TPInferenceEngine.dummy(cfg, calib, _arc_qcfg(), dataclasses.replace(
        ecfg, num_pages=DP * pages_local), dataclasses.replace(mesh, dp=1),
        seed=0)
    clean = _replay(ref, calls.calls, pages_local)
    with PlainKernels():
        plain = _replay(ref, calls.calls, pages_local)
    floors = noise_draws(lambda: _replay(ref, calls.calls, pages_local),
                         DP_DRAWS)
    rows = []
    for i, (name, _, args, got) in enumerate(calls.calls):
        live = (args[1] > 0) if name == "prefill" else args[1].bool()
        _, cos, floor, same, _ = floor_gate(
            got[live], clean[i][live], plain[i][live],
            [f[i][live] for f in floors])
        rows.append((name, cos, floor, same))
    out["rows"] = rows
    return out


def dp_run(card, failures):
    """[dp]: data parallelism, Qwen2.5-7B width cut to DP_LAYERS, dp 2 x tp
    2 (4 ranks on the one card over gloo), max_batch 8, dynamic pages,
    chunked prefill 512: twelve requests through ContinuousBatcher (the
    path dp_tp, rank 0's launches). Gates: every request finishes; the
    admissions use both groups and one requeues; no slot holds a page of
    another group's pool; a decode step's collectives are 2 SUM and 2 MAX
    a layer plus one all_gather; every call's logits against the dp 1 TP
    engine fed the same (cosine >= 0.999 or the noise floor of the same
    run, whichever is lower, and equal greedy tokens)."""
    from arcquant_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    try:
        ranks = launch(_dp_rank, DP * DP_TP, "gloo")
    except Exception as e:
        failures.append(f"[dp] {type(e).__name__}: {e}")
        return None
    r0 = ranks[0]
    log(f"  ContinuousBatcher over the dp {DP} x tp {DP_TP} TP engine, "
        f"{len(DP_PROMPTS)} requests of {DP_PROMPTS} tokens, {DP_NEW} new "
        f"each: {r0['wall']:.1f} s (rank 0's host clock; four ranks "
        f"time-share one card over gloo, no data-parallel speed figure; "
        f"{card}); preemptions {r0['preempts']}; peak device memory a rank "
        f"{', '.join(f'{r['peak_bytes'] / 2 ** 30:.2f}' for r in ranks)} GiB")
    ok = (all(e is None for e in r0["errors"])
          and all(n == DP_NEW for n in r0["lens"]) and r0["freed"])
    log(f"  every request finished with {DP_NEW} tokens and the pools freed "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[dp] requests {r0['errors']} {r0['lens']}")
    s = r0["seen"]
    ok = s["requeued"] > 0 and s["groups"] == set(range(DP))
    log(f"  admissions used groups {sorted(s['groups'])}, requeued with a "
        f"free slot {s['requeued']} times {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[dp] admissions {s}")
    if s["foreign"]:
        failures.append(f"[dp] {s['foreign']} slot-steps hold a page "
                        "outside their group's allocator")
    log(f"  no slot holds a page of another group's pool "
        f"{'FAIL' if s['foreign'] else 'ok'}")
    dec = [st for st in r0["steps"] if st["kind"] == "decode"]
    want = {"sum": 2 * DP_LAYERS, "max": 2 * DP_LAYERS, "all_gather": 1}
    comm = {k: v for k, v in dec[0]["comm"].items() if v}
    ok = all({k: v for k, v in st["comm"].items() if v} == want
             for st in dec)
    log(f"  a decode step's collectives {comm} (want {want}), "
        f"{dec[0]['comm_bytes']} bytes gathered; decode "
        f"{statistics.median(st['ms'] for st in dec):.2f} ms/step, "
        f"collectives {statistics.median(st['comm_ms'] for st in dec):.3f} "
        f"ms (median, {len(dec)} steps) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[dp] decode collectives {comm} != {want}")
    bad = []
    for i, (name, cos, floor, same) in enumerate(r0["rows"]):
        if not (cos >= floor and same):
            bad.append((i, name, cos, floor, same))
    cmin = min(c for _, c, _, _ in r0["rows"])
    fmin = min(f for _, _, f, _ in r0["rows"])
    log(f"  {len(r0['rows'])} calls against the dp 1 TP engine fed the "
        f"same: min cosine {cmin:.6f} (bar: 0.999 or the call's noise "
        f"floor, lowest {fmin:.6f}), greedy tokens equal in "
        f"{sum(r[3] for r in r0['rows'])} {'ok' if not bad else 'FAIL'}")
    if bad:
        failures.append(f"[dp] calls off the dp 1 engine: {bad[:4]}")
    if any(r["rows"] != r0["rows"] for r in ranks[1:]):
        failures.append("[dp] the ranks' rows against the dp 1 engine "
                        "disagree")
    counts = dict({n: r0["launches"].get(n, 0) for n in KERNEL_INFO},
                  actq_by_m=r0["launches"]["actq_by_m"])
    log(f"  launches per rank (dp_tp): "
        f"{ {k: v for k, v in counts.items() if v} }")
    _check_path(counts, DP_KERNELS, DP_IDLE_KERNELS, "[dp] batcher",
                failures)
    log(f"  [dp] took {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts


@contextlib.contextmanager
def _spied(*targets):
    """Record each call of each (module, name, list[, arg]) target's
    function while the block runs: a clone of its output, or with `arg`
    (output, positional argument arg) clones, in call order."""
    saved = []
    for mod, name, store, *arg in targets:
        real = getattr(mod, name)

        def f(*a, real=real, store=store, arg=arg, **kw):
            y = real(*a, **kw)
            store.append((y.detach().clone(), a[arg[0]].detach().clone())
                         if arg else y.detach().clone())
            return y
        saved.append((mod, name, real))
        setattr(mod, name, f)
    try:
        yield
    finally:
        for mod, name, real in reversed(saved):
            setattr(mod, name, real)


def _moe_rows(tp_io, single_io) -> dict:
    """The MoE block of the TP engine (ep_moe_block) against the single
    device's (moe_block) call by call: the rows whose block inputs are
    bitwise equal, and on them the largest |difference| of the outputs
    over the row's largest output (one bf16 ulp of it is 2^-8)."""
    rows = total = 0
    worst = 0.0
    for (ya, xa), (yb, xb) in zip(tp_io, single_io):
        xa, xb = xa.reshape(-1, xa.shape[-1]), xb.reshape(-1, xb.shape[-1])
        ya = ya.reshape(xa.shape[0], -1).float()
        yb = yb.reshape(xa.shape[0], -1).float()
        same = (xa == xb).all(dim=-1)
        rows += int(same.sum())
        total += same.numel()
        if same.any():
            d = ((ya - yb).abs().amax(-1)
                 / yb.abs().amax(-1).clamp(min=1e-30))[same]
            worst = max(worst, float(d.max()))
    return dict(rows=rows, total=total, worst=worst)


def _ep_checks(ctx):
    """[ep]'s cuts on one rank (EP_CUTS: activation scale, layers, weight
    seed; select 0): the MoE TP engine's prefill and 3 decode steps and
    each decode step's collectives. Rank 0 holds them against the
    single-device engine on qdq stacks of the same weights
    (testing.qdq_moe_engine on the dummy tree) through engine_vs_plain
    (its kernels kept; the floor of GEMM and paged decode noise, EP_DRAWS
    draws); at 1 layer it also holds the MoE block of every step against
    the single device's on the rows whose inputs are equal (spies on
    ep.ep_moe_block and moe.moe_block). Then, a witness of where a gap
    comes from, the TP engine on the plain versions against the single
    engine on the plain versions, fed the same tokens. Returns {cut:
    dict(comm, got[, failures, witness, moe_rows])}."""
    import functools

    from arcquant_tpu_torch import testing
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.engine import EngineConfig
    from arcquant_tpu_torch.engine.engine import dummy_tree
    from arcquant_tpu_torch.models import llama, moe, quantized
    from arcquant_tpu_torch.parallel import TPInferenceEngine
    from arcquant_tpu_torch.parallel import ep as epm

    global _QUIET
    _QUIET = ctx.rank != 0
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_model_config(MOE_MODEL)
    ecfg = EngineConfig(max_batch=len(PROMPT_LENS),
                        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)
    steps = functools.partial(engine_steps, decodes=3)
    out = {}
    for scale, layers, seed in EP_CUTS:
        cfg = base.replace(num_layers=layers)
        qcfg = _arc_qcfg().replace(act_scale=scale)
        calib = quantized.identity_calib(cfg, 0.0, device=ctx.device)
        eng = TPInferenceEngine.dummy(cfg, calib, qcfg, ecfg, ctx, seed=seed)
        eng.record_steps()
        res = {}
        if ctx.rank == 0:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            raw = [llama.init_layer_params(cfg, gen, torch.bfloat16, "cuda")
                   for _ in range(layers)]
            single = testing.qdq_moe_engine(
                cfg, dummy_tree(cfg, gen, torch.bfloat16, "cuda", raw),
                calib, qcfg, ecfg, device="cuda")
            single.cuda_graphs = False
            del raw
            spy_tp, spy_single = [], []
            spies = ([(epm, "ep_moe_block", spy_tp, 2),
                      (moe, "moe_block", spy_single, 2)] if layers == 1
                     else [])
            res["failures"] = []
            with _spied(*spies):
                res["got"], fed = engine_vs_plain(
                    eng, f"[ep] {layers}-layer cut at {scale} scales, "
                    f"weights of seed {seed}: TP vs the single-device qdq "
                    "engine,", res["failures"], paged_floor=True, ref=single,
                    real=tuple(KERNEL_INFO), steps=steps, draws=EP_DRAWS)
            if layers == 1:
                # the single engine's first run is the one with the kernels
                res["moe_rows"] = _moe_rows(spy_tp, spy_single)
            del spy_tp, spy_single
        else:
            res["got"], fed = steps(eng)
        res["comm"] = [s["comm"] for s in eng.steps if s["kind"] == "decode"]
        eng.steps = None
        with PlainKernels():
            tp_plain = steps(eng, fed)[0]
            if ctx.rank == 0:
                res["witness"] = [_cosine(a, b) for a, b in zip(
                    tp_plain, steps(single, fed)[0])]
        del eng
        if ctx.rank == 0:
            del single
        out[(scale, layers, seed)] = res
    return out


def ep_run(card, failures):
    """[ep]: expert parallelism under TP, Qwen1.5-MoE-A2.7B at full width
    over EP_RANKS ranks on the one card (gloo): 1. python -m
    arcquant_tpu_torch.generate --model qwen1.5-moe-a2.7b --tp 2
    --check_ranks (24 layers, ARC 0.125, row scales; 30 experts as qdq
    stacks and 8 of 16 heads a rank), the four prompts, 32 greedy tokens:
    both ranks' logits bitwise equal at every step (main raises
    otherwise), decode ms/step, a decode step's collectives (2 SUM and 1
    MAX a layer), peak memory a rank, the path ep_tp (rank 0's
    launches). 2. The cuts of EP_CUTS (_ep_checks) against the
    single-device engine on qdq stacks fed the same tokens, through
    engine_vs_plain in rank 0 (cosine >= 0.999 or the noise floor of the
    same run, whichever is lower, and equal greedy tokens unless a floor
    draw's differ too: moe_engine_check's rule over EP_DRAWS draws); both
    ranks' logits bitwise equal; at 1 layer the MoE block on the rows
    whose inputs are bitwise the single device's within a bf16 ulp of
    the row's largest output (the f32 order of the ranks' partials); a
    decode step's MoE collectives: one SUM a layer, one MAX more at
    tensor scales. The witness (both engines on the plain versions) is
    logged, not gated."""
    from arcquant_tpu_torch import generate
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    cfg = get_model_config(MOE_MODEL)
    e_loc = cfg.num_experts // EP_RANKS
    d, f = cfg.hidden_size, cfg.moe_intermediate_size

    def ke(k):   # ARC columns at SELECT_FRAC, rounded up to 64
        return -(-int(k * SELECT_FRAC) // 64) * 64
    per_layer = e_loc * 2 * (2 * f * (d + ke(d)) + d * (f + ke(f)))
    raw = cfg.num_experts * 3 * f * d * 2
    log(f"  reckoned before the run: a rank's {e_loc} experts as bf16 qdq "
        f"stacks take {per_layer / 2 ** 30:.3f} GiB a layer, "
        f"{per_layer * cfg.num_layers / 2 ** 30:.2f} GiB over "
        f"{cfg.num_layers} layers, the {EP_RANKS} ranks "
        f"{EP_RANKS * per_layer * cfg.num_layers / 2 ** 30:.2f} GiB; each "
        f"layer is drawn whole (its bf16 experts {raw / 2 ** 30:.2f} GiB) "
        f"and sliced before its stacks are made")
    argv = ["--model", MOE_MODEL, "--tp", str(EP_RANKS), "--dist_backend",
            "gloo", "--max_new", str(NEW_TOKENS), "--check_ranks"]
    for p in prompts_for(cfg):
        argv += ["--tokens", ",".join(map(str, p))]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = generate.main(argv)
    except Exception as e:
        failures.append(f"[ep] generate --tp {EP_RANKS}: "
                        f"{type(e).__name__}: {e}")
        return None
    log(f"  python -m arcquant_tpu_torch.generate --model {MOE_MODEL} --tp "
        f"{EP_RANKS} --dist_backend gloo --check_ranks ({cfg.num_layers} "
        f"layers, 4 prompts of {PROMPT_LENS} tokens, {NEW_TOKENS} new): "
        f"{time.perf_counter() - t0:.1f} s wall, spawn and builds included; "
        f"every step's logits bitwise equal across the {EP_RANKS} ranks "
        f"({len(ranks[0]['steps'])} steps) ok")
    log(f"  (both ranks time-share one card over gloo: no expert-parallel "
        f"speed figure; {card})")
    layers = cfg.num_layers
    for r, res in enumerate(ranks):
        dec = [s for s in res["steps"] if s["kind"] == "decode"]
        ms = [s["ms"] for s in dec]
        log(f"  rank {r}: decode {statistics.median(ms):.2f} ms/step (min "
            f"{min(ms):.2f}, {len(ms)} steps); a decode step's collectives "
            f"{dec[0]['comm']} in "
            f"{statistics.median(s['comm_ms'] for s in dec):.2f} ms; peak "
            f"device memory {res['peak_bytes'] / 2 ** 30:.2f} GiB")
        want = {"sum": 2 * layers, "max": layers}
        if any({k: v for k, v in s["comm"].items() if v} != want
               for s in dec):
            failures.append(f"[ep] rank {r}: a decode step's collectives "
                            f"{dec[0]['comm']} != {want}")
    counts = dict({n: ranks[0]["launches"].get(n, 0) for n in KERNEL_INFO},
                  actq_by_m=dict(sorted(ranks[0]["actq_by_m"].items())))
    log(f"  launches per rank (ep_tp): "
        f"{ {k: v for k, v in counts.items() if v} }")
    _check_path(counts, EP_KERNELS, None, "[ep] generate --tp 2", failures)
    del ranks
    gc.collect()
    torch.cuda.empty_cache()
    try:
        checks = launch(_ep_checks, EP_RANKS, "gloo")
    except Exception as e:
        failures.append(f"[ep] checks: {type(e).__name__}: {e}")
        return counts
    for (scale, layers, seed), r0 in checks[0].items():
        r1 = checks[1][(scale, layers, seed)]
        what = (f"[ep] {layers}-layer cut at {scale} scales, weights of "
                f"seed {seed}")
        failures.extend(r0["failures"])
        same = all(bitwise(a, b) for a, b in zip(r0["got"], r1["got"]))
        want = {"sum": 2 * layers,
                "max": layers * (1 if scale == "row" else 2)}
        comm_ok = all({k: v for k, v in c.items() if v} == want
                      for c in r0["comm"] + r1["comm"])
        log(f"  {what}: the ranks' logits "
            f"{'bitwise equal' if same else 'DIFFER'}; a decode step's "
            f"collectives {r0['comm'][0]} (o: 1 SUM + 1 MAX, the MoE block "
            f"1 SUM{' + 1 MAX' if scale == 'tensor' else ''} a layer) "
            f"{'ok' if same and comm_ok else 'FAIL'}")
        if not (same and comm_ok):
            failures.append(f"{what}: ranks equal {same}, collectives "
                            f"{r0['comm'][0]} != {want}")
        log(f"    witness, not gated: the TP engine on the plain versions "
            f"against the single-device qdq engine on the plain versions, "
            f"fed the same tokens: logits cosine by step "
            f"{[round(c, 6) for c in r0['witness']]}")
        if "moe_rows" in r0:
            mr = r0["moe_rows"]
            ok = mr["rows"] >= mr["total"] // 2 and mr["worst"] <= 2.0 ** -8
            log(f"    the MoE block (ep_moe_block against moe_block, call "
                f"by call): {mr['rows']} of {mr['total']} rows take bitwise "
                f"equal inputs, their outputs at most {mr['worst']:.3g} of "
                f"the row's largest apart (bar: half the rows or more, "
                f"within 2^-8, a bf16 ulp of it) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{what}: the MoE block off the single "
                                f"device's on equal inputs {mr}")
    log(f"  [ep] took {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts


def _sp_rank(ctx):
    """[sp] on one shard: the full pool and this shard's pool of the same
    K/V (every rank draws the same tensors), #10's state form over the
    shard's pool against its plain version, sp_paged_decode's merge
    against paged_decode over the full pool, then ring_attention on the
    shard's slice."""
    from arcquant_tpu_torch.cache import paged
    from arcquant_tpu_torch.config import KV_PAGE_SIZE, get_model_config
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    from arcquant_tpu_torch.parallel import make_sp, ring_attention
    from arcquant_tpu_torch.parallel import sp_paged_decode

    global _QUIET
    _QUIET = ctx.rank != 0
    torch.backends.cuda.matmul.allow_tf32 = False
    sctx = make_sp()
    cfg = get_model_config(MODEL)
    hq, hkv, dh, page = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         KV_PAGE_SIZE)
    b, tmax = len(SP_LENS), max(SP_LENS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    k = bf16_randn(gen, (b, tmax, hkv, dh), 2.0)
    v = bf16_randn(gen, (b, tmax, hkv, dh))
    q = bf16_randn(gen, (b, hq, dh), 2.0)
    lens = torch.tensor(SP_LENS, dtype=torch.int32, device="cuda")
    one = cfg.replace(num_layers=1)

    def pool(off, n, local_lens):
        pps = n // page
        cache = paged.init_cache(one, 1 + b * pps, page, "cuda")
        pt = (1 + torch.arange(b)[:, None] * pps
              + torch.arange(pps)[None]).to(torch.int32).cuda()
        pos = torch.arange(n, device="cuda")[None].expand(b, n)
        pos = torch.where(pos < local_lens[:, None], pos, -1)
        paged.append_kv(cache, 0, k[:, off:off + n], v[:, off:off + n], pt,
                        pos)
        return cache, pt

    full, pt_full = pool(0, tmax, lens)
    lo = sctx.shard * SP_BOUND
    loc_lens = (lens - lo).clamp(0, SP_BOUND).to(torch.int32)
    cache, pt = pool(lo, SP_BOUND, loc_lens)
    args = (q, cache.codes[0], cache.params[0], pt, loc_lens)
    o, m, l = pdk._paged_decode_cuda(*args)
    po, pm, pl = pdk.paged_decode_state_plain(*args)
    torch.cuda.synchronize()
    empty = loc_lens == 0
    out = dict(
        state_ok=(close_bound(o[~empty], po[~empty])
                  and bool(torch.allclose(m, pm, rtol=1e-5, atol=1e-5))
                  and bool(torch.allclose(l, pl, rtol=1e-4))
                  and bool((o[empty] == 0).all())
                  and bool((m[empty] == -1e30).all())
                  and bool((l[empty] == 0).all())),
        state_err=(float((o.float() - po.float()).abs().max()),
                   float((m - pm).abs().max()),
                   float(((l - pl).abs() / pl.clamp(min=1e-30)).max())),
        empty_rows=[i for i in range(b) if bool(empty[i])],
        local_lens=loc_lens.tolist())
    kernels = all_kernels()
    reset_counts(kernels)
    merged = sp_paged_decode(q, cache, 0, pt, loc_lens, sctx)
    torch.cuda.synchronize()
    out["launches"] = launch_counts(kernels)
    single = pdk.paged_decode(q, full, 0, pt_full, lens)
    plain = pdk.paged_decode_state_plain(q, full.codes[0], full.params[0],
                                         pt_full, lens)[0]
    out["merge_ok"] = close_bound(merged, single) and close_bound(merged,
                                                                  plain)
    out["merge_err"] = (float((merged.float() - single.float()).abs().max()),
                        float((merged.float() - plain.float()).abs().max()))
    del full, cache, k, v

    t, tl = SP_RING_T, SP_RING_T // sctx.sp
    qr = torch.randn((1, t, hq, dh), generator=gen, device="cuda")
    kr = torch.randn((1, t, hkv, dh), generator=gen, device="cuda")
    vr = torch.randn((1, t, hkv, dh), generator=gen, device="cuda")
    sl = slice(sctx.shard * tl, (sctx.shard + 1) * tl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring = ring_attention(qr[:, sl], kr[:, sl], vr[:, sl], sctx)
    torch.cuda.synchronize()
    out["ring_ms"] = (time.perf_counter() - t0) * 1e3
    g = hq // hkv
    s = torch.einsum("bqhd,bkhd->bhqk", qr[:, sl],
                     kr.repeat_interleave(g, dim=2)) / dh ** 0.5
    qpos = torch.arange(sl.start, sl.stop, device="cuda")
    s = s.masked_fill(qpos[:, None] < torch.arange(t, device="cuda")[None],
                      float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                       vr.repeat_interleave(g, dim=2))
    out["ring_err"] = float((ring - ref).abs().max())
    return out


def sp_run(card, failures):
    """[sp]: sequence parallelism over SP_RANKS shards on the one card
    (gloo): #10's state form at Qwen2.5-7B's attention shapes (28/4
    heads, head_dim 128, pages of 128), B 4 of SP_LENS tokens, the pages
    owned by token range (rank r: [r * SP_BOUND, (r + 1) * SP_BOUND)), so
    the 1056- and 64-token rows are empty on rank 1: each rank's (out, m,
    l) against the plain version within #10's bar (out one bf16 ulp +
    2e-3, m 1e-5, l 1e-4 relative; an empty row out 0, m -1e30, l 0), the
    merged sp_paged_decode (the path sp_decode, rank 0's launches)
    against paged_decode and its plain version over the whole pool within
    #10's out bar; then ring_attention at B 1, T SP_RING_T, 28/4 heads in
    f32 against the plain f32 causal attention of each shard's rows
    (within 1e-4)."""
    from arcquant_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    try:
        ranks = launch(_sp_rank, SP_RANKS, "gloo")
    except Exception as e:
        failures.append(f"[sp] {type(e).__name__}: {e}")
        return None
    for r, res in enumerate(ranks):
        ok = res["state_ok"]
        log(f"  rank {r}: local lens {res['local_lens']} (empty rows "
            f"{res['empty_rows']}); paged_decode_state against its plain "
            f"version: out, m, l max errors {res['state_err']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[sp] rank {r}: #10's state off its plain "
                            f"version {res['state_err']}")
        ok = res["merge_ok"]
        log(f"  rank {r}: sp_paged_decode (1 MAX + 2 SUM) against "
            f"paged_decode and its plain version over the whole pool: max "
            f"abs errors {res['merge_err']} (bar one bf16 ulp + 2e-3) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[sp] rank {r}: the merge off the single "
                            f"device {res['merge_err']}")
        ok = res["ring_err"] <= 1e-4
        log(f"  rank {r}: ring_attention B 1 T {SP_RING_T} (its "
            f"{SP_RING_T // SP_RANKS} rows) against plain f32 causal "
            f"attention: max abs error {res['ring_err']:.3g} (bar 1e-4), "
            f"{res['ring_ms']:.1f} ms host clock "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[sp] rank {r}: ring attention error "
                            f"{res['ring_err']}")
    counts = dict({n: ranks[0]["launches"].get(n, 0) for n in KERNEL_INFO},
                  actq_by_m=ranks[0]["launches"]["actq_by_m"])
    log(f"  launches per rank (sp_decode): "
        f"{ {k: v for k, v in counts.items() if v} }")
    _check_path(counts, ("paged_decode",), None, "[sp] sp_paged_decode",
                failures)
    log(f"  [sp] took {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from arcquant_tpu_torch.config import get_model_config
    from arcquant_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = common.card()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    log("[build]")
    t0 = time.perf_counter()
    _build.library()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR})")

    failures: list = []
    cfg = get_model_config(MODEL)
    log(f"[kernels vs plain versions] {MODEL} shapes, median of {REPS} "
        f"CUDA-event runs, L2 flushed, on {card}")
    timer = Timer(REPS)
    summary = kernel_checks(cfg, lambda fn: timer(fn).median, failures)

    log(f"[engine] {MODEL} full width, 28 layers, on {card}")
    gen_launches, qparams, calib = engine_run(cfg, card, failures)

    log(f"[serve] HTTP server, {MODEL} full width, 28 layers, on {card}")
    serve_launches = serving_run(cfg, qparams, calib, card, failures)
    gc.collect()    # the serving phase's patched methods form cycles
    torch.cuda.empty_cache()

    log(f"[w4] {MODEL} full width, 28 layers, weight_fmt w4, ARC, "
        f"against the w8 engine, on {card}")
    w4_launches = w4_run(cfg, card, qparams, calib, failures)
    del qparams, calib
    torch.cuda.empty_cache()

    log(f"[select-free] {MODEL} full width, 28 layers, select_frac 0, "
        f"fused vs unfused decode, on {card}")
    free_launches = free_run(cfg, card, failures)

    log(f"[bench_e2e] benchmarks/benchmark_e2e.py, {MODEL} full width, 28 "
        f"layers, NVFP4 select-free then BF16, on {card}")
    e2e_launches = bench_e2e_run(card, failures)

    log(f"[spec] speculative decoding, {MODEL} full width, 28 layers, "
        f"bench_spec (select-free, ARC), generate_ondevice (ARC, W 4) "
        f"and serve --spec_window 4, on {card}")
    spec_launches = spec_run(card, failures)

    log(f"[eval] python -m arcquant_tpu_torch.evaluate, {MODEL} full width, "
        f"28 layers, synthetic stream, seqlen {EVAL_SEQLEN}, {EVAL_WINDOWS} "
        f"windows: BF16, NVFP4 fake (tensor, row), NVFP4 packed, on {card}")
    eval_launches = eval_run(card, failures)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[generate] python -m arcquant_tpu_torch.generate, {MODEL} full "
        f"width, 28 layers, against InferenceEngine.generate, on {card}")
    generate_run(card, failures)

    with tempfile.TemporaryDirectory() as work:
        log(f"[calibrate] python -m arcquant_tpu_torch.calibrate, {MODEL} "
            f"full width, 28 layers streamed, {CALIB_SAMPLES} x "
            f"{CALIB_SEQLEN} synthetic tokens, max, on {card}")
        calib, calib_launches, row9 = calibrate_run(card, work, failures)
        summary["flash_attn"]["calibrate"] = row9
        log(f"[calib_serve] the [calibrate] artifact served by "
            f"InferenceEngine, {MODEL} full width, 28 layers, on {card}")
        calib_serve_launches = calib_serve_run(card, calib, failures)
        del calib
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[ckpt] an HF directory and a quantized checkpoint at {MODEL} "
            f"widths, {CKPT_LAYERS} layers, through generate, evaluate and "
            f"save/load_quantized, on {card}")
        ckpt_launches = ckpt_run(card, work, failures)

    log(f"[lab] the GEMM lab at {MODEL}'s decode sites, M 4, w8 and w4, "
        f"median of 7 CUDA-event runs, L2 flushed, on {card}")
    lab_launches = lab_run(card, failures)

    moe_cfg = get_model_config(MOE_MODEL)
    log(f"[moe] {MOE_MODEL} full width, {moe_cfg.num_layers} layers, ARC, "
        f"w8 then w4, on {card}")
    moe_launches = moe_run(moe_cfg, card, failures)
    log(f"[moe serve] HTTP server, {MOE_MODEL} full width, "
        f"{moe_cfg.num_layers} layers, on {card}")
    moe_serve_launches = moe_serve_run(card, failures)

    log(f"[moe_qdq] {MOE_MODEL} full width: the qdq stacks against the "
        f"packed experts at 1 layer, then {moe_cfg.num_layers} layers in BF16 "
        f"and in the NVFP4 fake format (use_kernels=False), on {card}")
    moe_qdq_launches = moe_qdq_run(moe_cfg, card, failures)
    log(f"[moe_eval] python -m arcquant_tpu_torch.evaluate, {MOE_MODEL} full "
        f"width, {moe_cfg.num_layers} layers, seqlen {EVAL_SEQLEN}, "
        f"{EVAL_WINDOWS} windows: BF16, NVFP4 fake (tensor, row), NVFP4 "
        f"packed, on {card}")
    moe_eval_launches = eval_run(card, failures, MOE_MODEL, MOE_EVAL_KERNELS,
                                 "[moe_eval]")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        log(f"[moe_calibrate] python -m arcquant_tpu_torch.calibrate, "
            f"{MOE_MODEL} full width, {moe_cfg.num_layers} layers streamed, "
            f"{CALIB_SAMPLES} x {CALIB_SEQLEN} synthetic tokens, max, on "
            f"{card}")
        calib, moe_cal_launches, row9 = calibrate_run(
            card, work, failures, MOE_MODEL, "[moe_calibrate]")
        summary["flash_attn"]["calibrate_moe"] = row9
        log(f"[moe_calib_serve] the [moe_calibrate] artifact served by "
            f"InferenceEngine, {MOE_MODEL} full width, "
            f"{moe_cfg.num_layers} layers, on {card}")
        moe_cal_serve_launches = calib_serve_run(
            card, calib, failures, MOE_MODEL, MOE_KERNELS["w8"],
            MOE_IDLE_KERNELS["w8"], "[moe_calib_serve]")
        del calib
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[engine_tensor] {MODEL} full width, 28 layers, w8, ARC, "
        f"act_scale tensor against row, on {card}")
    tensor_launches = engine_tensor_run(card, failures)

    log(f"[tp] tensor parallelism, {MODEL} full width, tp {TP_RANKS}: "
        f"generate --tp {TP_RANKS} (28 layers) and 1-layer checks, both ranks "
        f"on cuda:0 over gloo, on {card}")
    tp_launches = tp_run(card, failures)
    log(f"[lm_eval] the lm-eval adapter, {MODEL} width, {LM_EVAL_LAYERS} "
        f"layers, packed w8, on {card}")
    lm_eval_launches = lm_eval_run(card, failures)

    log(f"[pp] pipeline parallelism, {MODEL} full width, 28 layers over "
        f"{PP_RANKS} stages, then {MOE_MODEL} at {MOE_PP_LAYERS} layers, "
        f"both stages on cuda:0 over gloo, on {card}")
    pp_launches, moe_pp_launches = pp_run(card, failures)
    log(f"[dp] data parallelism, {MODEL} width, {DP_LAYERS} layers, dp {DP} "
        f"x tp {DP_TP}, ContinuousBatcher, 4 ranks on cuda:0 over gloo, on "
        f"{card}")
    dp_launches = dp_run(card, failures)
    log(f"[ep] expert parallelism under TP, {MOE_MODEL} full width, tp "
        f"{EP_RANKS}: generate --tp {EP_RANKS} (24 layers) and the cuts "
        f"(scale, layers, seed) {EP_CUTS}, both ranks on cuda:0 over gloo, "
        f"on {card}")
    ep_launches = ep_run(card, failures)
    log(f"[sp] sequence parallelism, {MODEL} attention shapes, sp "
        f"{SP_RANKS}: paged decode's state and merge, ring attention, on "
        f"{card}")
    sp_launches = sp_run(card, failures)

    log("[engine check] 1 and 2 layers (w8), 1 layer (w4), 1 layer (BF16), "
        "kernels vs plain versions; the MoE model at 1 layer")
    engine_check(cfg, failures)
    serving_engine_check(cfg, failures)
    moe_engine_check(moe_cfg, failures)

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    # launches: over the twenty-eight main paths, the ARC generate(), the
    # HTTP server, the w4 generate(), the select-free generate(), the MoE
    # model's w8 and w4 generate() and HTTP server, benchmark_e2e in NVFP4
    # and BF16, the GEMM lab, generate_ondevice, evaluate's packed route,
    # calibrate, the calibrated engine and the checkpoint directory's
    # generate and evaluate; the MoE model's BF16 and fake-format
    # generate(), evaluate's packed route, calibrate and its calibrated
    # engine; the tensor-scale generate(); rank 0 of generate --tp 2; the
    # lm-eval adapter; the PP generate() of both models (the stages
    # summed); rank 0 of the dp x tp batcher, of the MoE generate --tp 2
    # and of sp_paged_decode; actq's also by M
    path_launches = dict(
        generate=gen_launches, serve=serve_launches, generate_w4=w4_launches,
        generate_select_free=free_launches,
        generate_moe=moe_launches["w8"], generate_moe_w4=moe_launches["w4"],
        serve_moe=moe_serve_launches, bench_e2e_nvfp4=e2e_launches["NVFP4"],
        bench_e2e_bf16=e2e_launches["BF16"], gemm_lab=lab_launches,
        spec=spec_launches, evaluate=eval_launches,
        calibrate=calib_launches, calib_serve=calib_serve_launches,
        ckpt=ckpt_launches, generate_moe_bf16=moe_qdq_launches["BF16"],
        generate_moe_fake=moe_qdq_launches["fake"],
        evaluate_moe=moe_eval_launches, calibrate_moe=moe_cal_launches,
        calib_serve_moe=moe_cal_serve_launches,
        generate_tensor=tensor_launches, generate_tp=tp_launches,
        lm_eval=lm_eval_launches, generate_pp=pp_launches,
        moe_pp=moe_pp_launches, dp_tp=dp_launches, ep_tp=ep_launches,
        sp_decode=sp_launches)
    actq_by_m = {p: c["actq_by_m"] for p, c in path_launches.items()}
    by_m = {}
    for c in actq_by_m.values():
        for m, n in c.items():
            by_m[m] = by_m.get(m, 0) + n
    log(f"actq launches by M over the {len(path_launches)} paths: "
        f"{dict(sorted(by_m.items()))}; by path: {actq_by_m}")
    summary["actq"]["launches_by_m"] = dict(sorted(by_m.items()))
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        s = summary[name]
        paths = {p: c[name] for p, c in path_launches.items()}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            **{k: s[k] for k in ("chain_ms", "w4_ms", "w4_bound_ms",
                                 "w4_chain_ms", "large_m", "small_m",
                                 "shapes", "launch_floor_ms", "launches_by_m",
                                 "verify", "calibrate", "calibrate_moe")
                 if k in s},
            shape=s["shape"], card=card))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
