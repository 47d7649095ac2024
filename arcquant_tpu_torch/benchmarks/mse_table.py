"""Algorithm-level MSE table (counterpart of ``benchmarks/mse_table.py``):
the linear-layer output MSE of NVFP4 + ARC at increasing compensated
channel counts k, against FP32 / INT8 / INT4 / W4A16 / plain NVFP4
baselines, on Gaussian activations with a planted outlier tail.

  python -m arcquant_tpu_torch.benchmarks.mse_table [--m 128] [--n 1024] \\
      [--k 4096] [--ks 0 64 128 ...] [--cpu]

It runs on the card unless --cpu is given. The inputs are drawn on the
host from torch.Generator seeds 0 (activations) and 1 (weights), then
moved to the device, so the card and the CPU see the same draws. They
are not the JAX script's draws (PRNGKey(0) and PRNGKey(1)); their
distribution is the same.
"""

from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

import torch

from ..quant import arc, numerics as N


def synthetic_outliers(gen: torch.Generator, m: int, k: int,
                       frac: float = 0.0625, scale: float = 20.0,
                       device="cpu") -> torch.Tensor:
    """Gaussian activations [m, k] f32 with a planted outlier tail: the
    last frac * k channels get N(0, scale^2) added. Drawn from `gen` (a
    CPU generator), then moved to `device`."""
    x = torch.randn((m, k), generator=gen, dtype=torch.float32)
    n_out = int(k * frac)
    boost = torch.randn((m, n_out), generator=gen,
                        dtype=torch.float32) * scale
    x[:, k - n_out:] += boost
    return x.to(device)


def _int8_qdq(t: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor INT8 qdq."""
    s = t.abs().amax() / 127.0
    return torch.round(t / s).clamp(-127, 127) * s


def table(x: torch.Tensor, w: torch.Tensor, ridx: torch.Tensor,
          ks: Sequence[int]) -> List[Tuple[str, float]]:
    """The table's rows, (name, output MSE against x @ w.T in f32), for
    activations x [M, K] and weights w [N, K] (f32), with ARC's channel
    order ridx; the k of ks past K are left out."""
    k = x.shape[1]
    y_true = x @ w.t()

    def mse(y):
        return float(((y - y_true) ** 2).mean())

    qw = N.quantize_tensor_qdq(w, "NVFP4")
    rows = [("fp32", mse(y_true)),
            ("int8 (w8a8 per-tensor)", mse(_int8_qdq(x) @ _int8_qdq(w).t())),
            ("int4 (w4a4 group128)",
             mse(N.int4_group_qdq(x) @ N.int4_group_qdq(w).t())),
            ("w4a16 (nvfp4 weights)", mse(x @ qw.t())),
            ("nvfp4 w4a4", mse(N.quantize_tensor_qdq(x, "NVFP4") @ qw.t()))]
    for ke in ks:
        if ke <= k:
            rows.append((f"nvfp4+arc k={ke}",
                         mse(arc.arc_linear_fake(x, w, ridx, ke))))
    return rows


def inputs(m: int, n: int, k: int, device="cpu"):
    """(x [m, k], w [n, k], ridx): seed 0's outlier activations, seed 1's
    N(0, 0.02^2) weights and the identity channel order (the outliers
    sit at the end, where ARC looks)."""
    x = synthetic_outliers(torch.Generator().manual_seed(0), m, k,
                           device=device)
    w = torch.randn((n, k), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float32).to(device) * 0.02
    return x, w, torch.arange(k, dtype=torch.int32, device=device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.mse_table")
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--ks", type=int, nargs="*",
                    default=[0, 64, 128, 256, 512, 1024, 2048])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.cpu:
        from .common import require_cuda
        require_cuda("mse_table")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if args.cpu else "cuda"
    m, n, k = args.m, args.n, args.k
    rows = table(*inputs(m, n, k, device), args.ks)
    width = max(len(r[0]) for r in rows)
    print(f"# M={m} N={n} K={k}, outlier tail 6.25% x20, on {device}")
    for name, v in rows:
        print(f"  {name:<{width}}  {v:12.6f}")


if __name__ == "__main__":
    main()
