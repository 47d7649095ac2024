"""Device times of the decode step's fused small-M kernels against the
unfused chains they replace, and of the activation quantize they fuse,
at the shapes of Qwen2.5-7B and Qwen1.5-MoE-A2.7B, each beside its bound:

  - #1 actq (``kernels/quantize.py:_actq_cuda``) at each M of
    ``--actq_m`` (decode 4-16 and the prefill's 4096), K 3584 (hidden)
    and 18944 (intermediate), each mode, each at the ARC width kq and at
    kq = k, beside the launch floor (an empty kernel of the same grid,
    ``quantize.launch_floor``, timed alike) where the checkout has one;

  - the decode megakernels (``kernels/mlp_fused.py``): gemm_actq at the
    qkv (rmsnorm, bias) and o (plain) sites, mlp_w8 (rmsnorm, select-free
    down_in) and gu_actq (ARC select_frac 0.125, down_in Kq 21504), at
    each M of ``--m``. Beside each: its CUDA chain (``*_chain``: actq and
    gemm_w8 launches) and the chain's GEMMs alone (``gemm_w8`` on the
    chain's own quantized activations, split-K reduce included), so that
    the megakernel's time less the GEMMs' is what its other phases and
    grid barriers take;
  - ``gemm_batched`` over the 60 experts' down projections (K 1408 with
    192 ARC columns, Kq 2048, N 2048), w8 and w4, on bf16 activations:
    beside the per-expert loop of gemm_w8 / gemm_w4
    (``gemm_batched_chain``) and ``torch.bmm`` over the decoded bf16
    stack (the library call).

  python -m arcquant_tpu_torch.benchmarks.bench_decode [--m 4 8 16]
      [--moe_m 4 8] [--actq_m 4 8 16 4096] [--no-actq] [--no-fused]
      [--no-moe] [--sweep]

``--sweep`` times the plans instead: actq at M 4 and 16 over a range of
slices a row, and gemm_actq (qkv) and mlp_w8 at M 4 and 16 with phase A
on a range of block counts (both patched over the wrappers' plans).

It imports the package by its absolute name, so it also times another
checkout of it: ``PYTHONPATH=<checkout> python <this file>``. One JSON
line per measurement (times in ms, CUDA events with L2 flushed,
``benchmarks/common.py``'s Timer), the card's name and power limit first.
Weights are random from fixed seeds.
"""

from __future__ import annotations

import argparse
import itertools
import json

import torch

from arcquant_tpu_torch.benchmarks.common import (Timer, bound_ms, card,
                                                  nbytes, require_cuda)
from arcquant_tpu_torch.config import get_model_config
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.kernels import mlp_fused as mf
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.quant import packing

SELECT_FRAC = 0.125


def _randn(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


def _select(k: int) -> int:
    return int(round(SELECT_FRAC * k / 64)) * 64


def _pack(gen, n, k, sel, bias, fmt="w8"):
    w = _randn(gen, (n, k), k ** -0.5)
    b = _randn(gen, (n,), 0.1) if bias else None
    return packing.pack_weight_arc(w, torch.arange(k, device="cuda"), sel,
                                   bias=b, fmt=fmt, w_scale="channel")


def _gemm(xa, gs, pw):
    return gk._gemm_w8_cuda(xa, pw.codes, pw.scales, gs.reshape(-1, 1),
                            mf._gw(pw), pw.bias, torch.bfloat16)


def _actq_inputs(gen, m, k, mode):
    a = _randn(gen, (m, 2 * k if mode == "silu_mul" else k), 2.0)
    w = ((_randn(gen, (k,), 0.1) + 1).to(torch.bfloat16)
         if mode == "rmsnorm" else None)
    return a, w


def actq_rows(ms, timer, emit):
    """#1 actq's rows (module docstring)."""
    cfg = get_model_config("qwen2.5-7b")
    h, f, eps = cfg.hidden_size, cfg.intermediate_size, cfg.rms_eps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    plan = getattr(qk, "actq_plan", None)     # absent in older checkouts
    for m in ms:
        for k, mode in itertools.product((h, f),
                                         ("plain", "rmsnorm", "silu_mul")):
            a, w = _actq_inputs(gen, m, k, mode)
            for kq in (packing.pad_kq(k, _select(k)), k):
                args = dict(mode=mode, k=k, kq=kq, eps=eps)
                xa, gx = qk._actq_cuda(a, w, **args)
                t = timer(lambda: qk._actq_cuda(a, w, **args))
                b_ms, b_by = bound_ms(0.0, nbytes(a, w, xa, gx))
                row = dict(kernel="actq", mode=mode, m=m, k=k, kq=kq,
                           ms=t.median, lo=t.lo, hi=t.hi, bound_ms=b_ms,
                           bound_by=b_by)
                if plan is not None:
                    n = plan(m, k, mode)
                    row.update(blocks=n, floor_ms=timer(
                        lambda: qk.launch_floor(n)).median)
                emit(row)
            del a, w
    torch.cuda.empty_cache()


def sweep_rows(timer, emit):
    """actq over slices a row, gemm_actq and mlp_w8 over phase A's
    blocks, at M 4 and 16 (each plan patched over the wrapper's for the
    run)."""
    cfg = get_model_config("qwen2.5-7b")
    h, f, eps = cfg.hidden_size, cfg.intermediate_size, cfg.rms_eps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    plan, phase_a = qk.actq_plan, mf.phase_a_blocks
    try:
        for m in (4, 16):
            for k, mode in ((h, "plain"), (h, "rmsnorm"), (f, "silu_mul")):
                a, w = _actq_inputs(gen, m, k, mode)
                args = dict(mode=mode, k=k, kq=packing.pad_kq(k, _select(k)),
                            eps=eps)
                for slices in (1, 2, 4, 8, 16, 24, 33, 48, 66):
                    qk.actq_plan = lambda m_, k_, mode_, s=slices: m_ * s
                    t = timer(lambda: qk._actq_cuda(a, w, **args))
                    emit(dict(sweep="actq", mode=mode, m=m, k=k,
                              slices=slices, blocks=m * slices,
                              ms=t.median, lo=t.lo, hi=t.hi))
                qk.actq_plan = plan
        nq = cfg.q_size + 2 * cfg.kv_size
        pw = _pack(gen, nq, h, 0, True)
        pw_gu, pw_dn = (_pack(gen, 2 * f, h, 0, False),
                        _pack(gen, h, f, 0, False))
        nw = (_randn(gen, (h,), 0.1) + 1).to(torch.bfloat16)
        for m in (4, 16):
            x = _randn(gen, (m, h), 2.0)
            for name, fn, args in (
                    ("gemm_actq qkv", mf._gemm_actq_cuda,
                     (x, pw, h, torch.bfloat16, nw, eps)),
                    ("mlp_w8", mf._mlp_w8_cuda,
                     (x, None, pw_gu, pw_dn, f, torch.bfloat16, nw, eps))):
                for nb in (m, 4 * m, plan(m, h, "rmsnorm"), 264, 396):
                    mf.phase_a_blocks = lambda m_, d_, mode_, n=nb: n
                    t = timer(lambda: fn(*args))
                    emit(dict(sweep=name, m=m, a_blocks=nb, ms=t.median,
                              lo=t.lo, hi=t.hi))
                mf.phase_a_blocks = phase_a
    finally:
        qk.actq_plan, mf.phase_a_blocks = plan, phase_a
    torch.cuda.empty_cache()


def fused_rows(ms, timer, emit):
    cfg = get_model_config("qwen2.5-7b")
    h, f, eps = cfg.hidden_size, cfg.intermediate_size, cfg.rms_eps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf = torch.bfloat16

    def row(kernel, case, m, args, cuda, chain, gemms, flops, inputs):
        """inputs: the tensors the function reads; the bound counts them
        and the outputs once."""
        byts = nbytes(*inputs, *cuda(*args))
        t = timer(lambda: cuda(*args))
        tc = timer(lambda: chain(*args))
        tg = timer(gemms)
        b_ms, b_by = bound_ms(flops, byts)
        emit(dict(kernel=kernel, case=case, m=m, ms=t.median, lo=t.lo,
                  hi=t.hi, chain_ms=tc.median, chain_gemm_ms=tg.median,
                  other_ms=t.median - tg.median, bound_ms=b_ms,
                  bound_by=b_by))

    nq = cfg.q_size + 2 * cfg.kv_size
    for site, pw, d, norm in (("qkv", _pack(gen, nq, h, 0, True), h, True),
                              ("o", _pack(gen, h, cfg.q_size, 0, False),
                               cfg.q_size, False)):
        nw = (_randn(gen, (d,), 0.1) + 1).to(bf) if norm else None
        mode = "rmsnorm" if norm else "plain"
        for m in ms:
            x = _randn(gen, (m, d), 2.0)
            xa, gx = qk._actq_cuda(x, nw, mode=mode, k=d, kq=pw.kq, eps=eps)
            row("gemm_actq", f"{site} {mode} D={d} Kq={pw.kq} N={pw.n}", m,
                (x, pw, d, bf, nw, eps), mf._gemm_actq_cuda,
                mf.gemm_actq_chain, lambda: _gemm(xa, gx, pw),
                2.0 * m * pw.kq * pw.n,
                (x, nw, pw.codes, pw.scales, pw.global_scale, pw.bias))
        del pw

    pw_gu, pw_dn = _pack(gen, 2 * f, h, 0, False), _pack(gen, h, f, 0, False)
    nw = (_randn(gen, (h,), 0.1) + 1).to(bf)
    for m in ms:
        x = _randn(gen, (m, h), 2.0)
        xa1, gx1 = qk._actq_cuda(x, nw, mode="rmsnorm", k=h, kq=pw_gu.kq,
                                 eps=eps)
        gu = _gemm(xa1, gx1, pw_gu)
        xa2, gx2 = qk._actq_cuda(gu, None, mode="silu_mul", k=f, kq=pw_dn.kq)

        def gemms(xa1=xa1, gx1=gx1, xa2=xa2, gx2=gx2):
            _gemm(xa1, gx1, pw_gu)
            _gemm(xa2, gx2, pw_dn)
        row("mlp_w8", f"rmsnorm D={h} F={f} Kq1={pw_gu.kq} Kq2={pw_dn.kq}",
            m, (x, None, pw_gu, pw_dn, f, bf, nw, eps), mf._mlp_w8_cuda,
            mf.mlp_w8_chain, gemms,
            2.0 * m * (pw_gu.kq * pw_gu.n + pw_dn.kq * pw_dn.n),
            (x, nw, *pw_gu[:3], *pw_dn[:3]))
    del pw_gu, pw_dn

    pw_gu = _pack(gen, 2 * f, h, _select(h), False)
    kq2 = packing.pad_kq(f, _select(f))
    for m in ms:
        xa1, gs1 = qk.quantize_x_arc(_randn(gen, (m, h), 2.0),
                                     torch.arange(h, device="cuda"),
                                     _select(h))
        row("gu_actq", f"Kq1={pw_gu.kq} N={pw_gu.n} Kq2={kq2}", m,
            (xa1, gs1, pw_gu, f, kq2, bf), mf._gu_actq_cuda,
            mf.gu_actq_chain, lambda xa1=xa1, gs1=gs1: _gemm(xa1, gs1, pw_gu),
            2.0 * m * pw_gu.kq * pw_gu.n,
            (xa1, gs1, *pw_gu[:3]))
    del pw_gu
    torch.cuda.empty_cache()


def moe_rows(ms, timer, emit):
    cfg = get_model_config("qwen1.5-moe-a2.7b")
    e, d, f = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    sel = _select(f)
    w = _randn(gen, (e * d, f), f ** -0.5)       # the experts' down rows
    ridx = torch.randperm(f, generator=gen, device="cuda")
    packs = {}
    for fmt in ("w8", "w4"):
        pw = packing.pack_weight_arc_rows(w, ridx, sel, fmt=fmt)

        def stack(t):
            return t.reshape(t.shape[0], e, -1).transpose(0, 1).contiguous()
        packs[fmt] = type(pw)(stack(pw.codes), stack(pw.scales),
                              pw.global_scale.reshape(e, d), None)
    del w
    kq = packs["w8"].kq
    wd = gk.dequant_weight(packs["w8"])           # [E, Kq, N] bf16, exact
    for m in ms:
        xa = _randn(gen, (e, m, kq), 2.0)
        gs = torch.rand((e, m, 1), generator=gen, device="cuda") + 0.5
        for fmt, pk in packs.items():
            gw = pk.global_scale.reshape(e, 1, d)
            args = (xa, pk.codes, pk.scales, gs, gw, torch.float32)
            y = gk._gemm_batched_cuda(*args)
            t = timer(lambda: gk._gemm_batched_cuda(*args))
            tl = timer(lambda: gk.gemm_batched_chain(*args))
            tb = timer(lambda: torch.bmm(xa, wd))
            b_ms, b_by = bound_ms(2.0 * e * m * kq * d,
                                  nbytes(xa, pk.codes, pk.scales, gs, gw, y))
            emit(dict(kernel="gemm_batched", fmt=fmt, e=e, m=m, kq=kq, n=d,
                      ms=t.median, lo=t.lo, hi=t.hi, chain_ms=tl.median,
                      library_ms=tb.median, bound_ms=b_ms, bound_by=b_by))
            del y
    del packs, wd
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.bench_decode")
    ap.add_argument("--m", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--moe_m", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--actq_m", type=int, nargs="+",
                    default=[4, 8, 16, 4096])
    ap.add_argument("--no-actq", action="store_true")
    ap.add_argument("--no-fused", action="store_true")
    ap.add_argument("--no-moe", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    require_cuda("bench_decode")
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer()

    def emit(row):
        print(json.dumps(row), flush=True)
    emit(dict(card=card(), torch=torch.__version__, cuda=torch.version.cuda))
    if args.sweep:
        sweep_rows(timer, emit)
        return
    if not args.no_actq:
        actq_rows(args.actq_m, timer, emit)
    if not args.no_fused:
        fused_rows(args.m, timer, emit)
    if not args.no_moe:
        moe_rows(args.moe_m, timer, emit)


if __name__ == "__main__":
    main()
