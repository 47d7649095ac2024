"""GEMM latency sweep over M (counterpart of ``benchmarks/bench_gemm.py``):
the production quantized GEMM (``kernels/gemm.py:gemm_dequant``, the
activation quantize excluded) against bf16 ``torch.matmul`` on the
unquantized weight, for M in {8 .. 4096}, N = K = 4096.

  python -m arcquant_tpu_torch.benchmarks.bench_gemm [--n 4096] [--k 4096]
      [--fmt w8] [--ke 0] [--ms 8 16 ...]

gemm_dequant takes the large-M route (dequant + torch.mm in f32 slices)
at M >= gemm.XLA_M when N >= Kq, the fused GEMM elsewhere; each row says
which. Times: median of 7 CUDA-event runs with L2 flushed, with the
min-max spread, on the card named in the header.
"""

from __future__ import annotations

import argparse

import torch

from ..kernels import gemm as gk
from ..kernels import quantize as qk
from ..quant import packing
from .common import Timer, card, require_cuda


def route(m: int, pw) -> str:
    """Which path gemm_dequant takes for M rows of `pw`."""
    return ("route" if gk.XLA_M and m >= gk.XLA_M and pw.n >= pw.kq
            else "fused")


def sweep(n: int, k: int, fmt: str, ke: int, ms, timer: Timer, log=print):
    """Rows (M, route, quant Timing, bf16 Timing)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    w = (torch.randn((n, k), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    ridx = torch.arange(k, device="cuda")
    pw = packing.pack_weight_arc(w, ridx, ke, fmt=fmt)
    wT = w.t().contiguous()
    log(f"# N={n} K={k} KE={ke} Kq={pw.kq} fmt={fmt} XLA_M={gk.XLA_M}; "
        f"{card()}")
    log(f"# {'M':>6} {'path':>6} {'quant_us':>10} {'[min-max]':>19} "
        f"{'bf16_us':>10} {'[min-max]':>19} {'speedup':>8}")
    rows = []
    for m in ms:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        xa, gx = qk.quantize_x_arc(x, ridx, ke, kq=pw.kq)
        tq = timer(lambda: gk.gemm_dequant(xa, pw, gx))
        tb = timer(lambda: torch.matmul(x, wT))
        log(f"  {m:>6} {route(m, pw):>6} {tq.median * 1e3:>10.2f} "
            f"[{tq.lo * 1e3:8.2f}-{tq.hi * 1e3:8.2f}] {tb.median * 1e3:>10.2f} "
            f"[{tb.lo * 1e3:8.2f}-{tb.hi * 1e3:8.2f}] "
            f"{tb.median / tq.median:>8.2f}")
        rows.append((m, route(m, pw), tq, tb))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.bench_gemm")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--fmt", default="w8", choices=["w4", "w8"])
    ap.add_argument("--ke", type=int, default=0)
    ap.add_argument("--ms", type=int, nargs="*",
                    default=[8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096])
    args = ap.parse_args(argv)
    require_cuda("bench_gemm")
    torch.backends.cuda.matmul.allow_tf32 = False
    sweep(args.n, args.k, args.fmt, args.ke, args.ms, Timer())


if __name__ == "__main__":
    main()
