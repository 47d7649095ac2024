"""GEMM lab on the card (counterpart of ``benchmarks/gemm_lab.py``): the
lab's kernel variants (``kernels/gemm_lab.py``, ``csrc/gemm_lab.cu``)
timed against the production GEMM (``kernels/gemm.py:gemm_dequant``) at
decode shapes, in one process, on the same bits.

  python -m arcquant_tpu_torch.benchmarks.gemm_lab --exp blocks   # (bks, bn) sweep
  python -m arcquant_tpu_torch.benchmarks.gemm_lab --exp scale    # decode modes
  python -m arcquant_tpu_torch.benchmarks.gemm_lab --exp w4       # w4 decodes
  python -m arcquant_tpu_torch.benchmarks.gemm_lab --exp shapes   # qwen2.5-7b, M 4
  python -m arcquant_tpu_torch.benchmarks.gemm_lab --exp dma      # copy-ring depth
  python -m arcquant_tpu_torch.benchmarks.gemm_lab --exp dmaprod  # production vs ring

Every row is the median of 7 CUDA-event runs with L2 flushed, its
min-max spread, its share of the weight-stream bound (the bytes of
codes, scales, activations and output over 3.35 TB/s; for the bf16
torch.matmul row, of the unquantized weight's bytes) and the card's
name and power limit. `exact` says whether a variant's output equals the
production GEMM's bit for bit. The sweeps run over Hopper tiles (BN
columns a block, BKS k rows a stage, the ring's depth) and k splits; a
configuration that does not fit a block's shared memory is printed as
skipped, one that is not instantiated in csrc/gemm_lab.cu as not built.
Times are device times: the timer holds the stream busy while the host
enqueues the call (``common.Timer``).
"""

from __future__ import annotations

import argparse
import statistics
from typing import Callable, Optional

import torch

from ..kernels import gemm as gk
from ..kernels import gemm_lab as gl
from ..kernels import quantize as qk
from ..quant import packing
from .common import (Timer, Timing, bound_ms, card, nbytes, require_cuda,
                     sum_order_bound)

# Qwen2.5-7B's decode GEMMs: (N, K) of the fused qkv, o, fused gate/up
# and down projections
SHAPES = {"qkv": (4608, 3584), "o": (3584, 3584), "gateup": (37888, 3584),
          "down": (3584, 18944)}
BLOCK_SWEEP = [(bn, bks) for bn in (64, 128, 256) for bks in (32, 64, 128, 256)]
STAGE_SWEEP = tuple(sorted({s for _, _, s in gl.RING_CONFIGS}))
SPLIT_SWEEP = (1, 2, 4, 8, 16)   # k splits of the default tile
DEFAULT = dict(bn=128, bks=128, stages=3)
AB_ROUNDS = 5   # best_by_site's alternating re-timing


class Case:
    """One weight packed in w8 and w4 from a seed, its activations
    quantized (per-row scales, select `ke` ARC columns), the decoded bf16
    weight and the production outputs."""

    def __init__(self, m: int, n: int, k: int, ke: int = 0, seed: int = 0):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        self.x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        self.w = (torch.randn((n, k), generator=gen, device="cuda")
                  * 0.02).to(torch.bfloat16)
        ridx = torch.arange(k, device="cuda")
        self.pw = {fmt: packing.pack_weight_arc(self.w, ridx, ke, fmt=fmt)
                   for fmt in ("w8", "w4")}
        self.kq = self.pw["w8"].kq
        self.xa, self.gx = qk.quantize_x_arc(self.x, ridx, ke, kq=self.kq)
        self.gs = self.gx.reshape(-1)
        self.m, self.n, self.k = m, n, k
        self.wT = self.w.t().contiguous()
        self.prod = {fmt: self.production(fmt)() for fmt in ("w8", "w4")}

    def gw(self, fmt: str) -> torch.Tensor:
        return self.pw[fmt].global_scale.float().reshape(-1).expand(
            self.n).contiguous()

    def operands(self, fmt: str):
        pw = self.pw[fmt]
        return self.xa, pw.codes, pw.scales, self.gs, self.gw(fmt)

    def production(self, fmt: str) -> Callable[[], torch.Tensor]:
        return lambda: gk.gemm_dequant(self.xa, self.pw[fmt], self.gx)

    def library(self) -> Callable[[], torch.Tensor]:
        """bf16 torch.matmul on the unquantized weight (the JAX lab's
        jnp.dot yardstick)."""
        return lambda: torch.matmul(self.x, self.wT)

    def bound_s(self, fmt: str) -> float:
        """The least time of the product in `fmt` (w8, w4, or bf16: the
        library call on the unquantized weight) on an H100 SXM."""
        if fmt == "bf16":
            ops = 2.0 * self.m * self.k * self.n
            moved = nbytes(self.wT, self.x)
        else:
            pw = self.pw[fmt]
            ops = 2.0 * self.m * self.kq * self.n
            moved = nbytes(pw.codes, pw.scales, self.xa)
        return bound_ms(ops, moved + 2 * self.m * self.n)[0] * 1e-3

    def f64(self, fmt: str) -> torch.Tensor:
        """The production function in f64: the accuracy reference."""
        wd = packing.dequantize_weight(self.pw[fmt], torch.float64)
        return (self.xa.double() @ wd) * self.gs.double()[:, None] \
            * self.gw(fmt).double()

    def exact(self, y: torch.Tensor, fmt: str = "w8") -> bool:
        p = self.prod[fmt]
        return y.shape == p.shape and bool(torch.equal(
            y.view(torch.int16), p.view(torch.int16)))


class Lab:
    """Times and prints rows; `log` receives each line."""

    def __init__(self, timer: Optional[Timer] = None, log=print):
        self.timer = timer or Timer()
        self.unheld = Timer(self.timer.reps, ahead=False)
        self.card = card()
        self.log = log

    def row(self, name: str, fn, bound_s: float, extra: str = ""):
        t = self.timer(fn)
        self.log(f"  {name:46s} {t}  {bound_s * 1e3 / t.median * 100:5.1f}% "
                 f"of the bound  {extra}  [{self.card}]")
        return t

    def skip(self, name: str, bn: int, bks: int, stages: int, mode: str,
             configs) -> bool:
        smem = gl.smem_bytes(bn, bks, stages, mode)
        if smem > gl.SMEM_MAX:
            self.log(f"  {name:46s} skipped: {smem} B of shared memory > "
                     f"{gl.SMEM_MAX}")
            return True
        if (bn, bks, stages, mode) not in configs:
            self.log(f"  {name:46s} not built (csrc/gemm_lab.cu)")
            return True
        return False

    def head(self, c: Case, fmt: str = "w8"):
        self.log(f"# M={c.m} N={c.n} K={c.k} Kq={c.kq} {fmt}; weight-stream "
                 f"bound {c.bound_s(fmt) * 1e6:.2f} us at 3.35 TB/s; "
                 f"{self.card}")
        lib = self.row("bf16 torch.matmul", c.library(), c.bound_s("bf16"))
        prod = self.row(f"production gemm_dequant {fmt}", c.production(fmt),
                        c.bound_s(fmt))
        return lib, prod


def exp_blocks(lab: Lab, m, n, k):
    c = Case(m, n, k)
    _, prod = lab.head(c)
    ops = c.operands("w8")
    for bn, bks in BLOCK_SWEEP:
        name = f"lab_w8 base bn={bn} bks={bks} stages=3"
        if lab.skip(name, bn, bks, 3, "base", gl.LAB_CONFIGS):
            continue
        y = gl.lab_w8(*ops, bn=bn, bks=bks, stages=3)
        t = lab.row(name, lambda bn=bn, bks=bks: gl.lab_w8(
            *ops, bn=bn, bks=bks, stages=3), c.bound_s("w8"),
            f"exact={c.exact(y)}")
        lab.log(f"  {'':46s} {prod.median / t.median:.3f}x production")
    plan = gk._split_plan(m, n, c.kq)[1]
    for splits in SPLIT_SWEEP:
        y = gl.lab_w8(*ops, splits=splits, **DEFAULT)
        lab.row(f"lab_w8 base bn=128 bks=128 stages=3 splits={splits}",
                lambda splits=splits: gl.lab_w8(*ops, splits=splits,
                                                **DEFAULT), c.bound_s("w8"),
                f"exact={c.exact(y)} (production plans {plan} splits)")


def _rel_err(y, ref) -> float:
    return float((y.double() - ref).abs().mean() / ref.abs().mean())


def exp_scale(lab: Lab, m, n, k, bks, bn):
    c = Case(m, n, k)
    lab.head(c)
    ops, f64 = c.operands("w8"), c.f64("w8")
    for mode in gl.W8_MODES:
        name = f"lab_w8 {mode} bn={bn} bks={bks} stages=3"
        if lab.skip(name, bn, bks, 3, mode, gl.LAB_CONFIGS):
            continue
        y = gl.lab_w8(*ops, mode=mode, bn=bn, bks=bks)
        lab.row(name, lambda mode=mode: gl.lab_w8(*ops, mode=mode, bn=bn,
                                                  bks=bks), c.bound_s("w8"),
                f"exact={c.exact(y)} error vs f64 {_rel_err(y, f64):.4g} "
                f"(production {_rel_err(c.prod['w8'], f64):.4g})")


def exp_w4(lab: Lab, m, n, k):
    c = Case(m, n, k)
    lab.head(c, "w4")
    lab.row("production gemm_dequant w8", c.production("w8"), c.bound_s("w8"))
    ops, f64 = c.operands("w4"), c.f64("w4")
    for bn, bks, stages, mode in gl.LAB_CONFIGS:
        if mode != "f32":
            continue
        y = gl.lab_w4(*ops, bn=bn, bks=bks, stages=stages)
        lab.row(f"lab_w4 f32 bn={bn} bks={bks} stages={stages}",
                lambda bn=bn, bks=bks, stages=stages: gl.lab_w4(
                    *ops, bn=bn, bks=bks, stages=stages), c.bound_s("w4"),
                f"exact={c.exact(y, 'w4')}")
    for mode in gl.W4_MODES:
        y = gl.lab_w4(*ops, mode=mode)
        err = float((y.float() - c.prod["w4"].float()).abs().max())
        lab.row(f"lab_w4 {mode} bn=128 bks=128 stages=3",
                lambda mode=mode: gl.lab_w4(*ops, mode=mode), c.bound_s("w4"),
                f"exact={c.exact(y, 'w4')} max_abs_err vs production "
                f"{err:.3g}, error vs f64 {_rel_err(y, f64):.4g}")


def exp_shapes(lab: Lab, m: int = 4):
    """Qwen2.5-7B's decode GEMMs: production (w8 and w4) against bf16
    torch.matmul and the bound."""
    out = {}
    for name, (n, k) in SHAPES.items():
        c = Case(m, n, k)
        lab.log(f"# {name}: M={m} N={n} K={k} Kq={c.kq}; bounds w8 "
                f"{c.bound_s('w8') * 1e6:.2f} us, w4 "
                f"{c.bound_s('w4') * 1e6:.2f} us at 3.35 TB/s")
        lib = lab.row(f"{name} bf16 torch.matmul", c.library(),
                      c.bound_s("bf16"))
        out[name] = dict(library=lib, bound_w8=c.bound_s("w8"),
                         bound_w4=c.bound_s("w4"))
        for fmt in ("w8", "w4"):
            out[name][fmt] = lab.row(f"{name} production {fmt}",
                                     c.production(fmt), c.bound_s(fmt))
        del c
    return out


def exp_dma(lab: Lab, m, n, k):
    c = Case(m, n, k)
    lab.head(c)
    ops = c.operands("w8")
    for stages in STAGE_SWEEP:
        for per_sm in (1, 2):
            name = f"lab_w8_ring bn=128 bks=128 stages={stages} {per_sm}/SM"
            if lab.skip(name, 128, 128, stages, "base",
                        [(*r, "base") for r in gl.RING_CONFIGS]):
                continue
            blocks = gl.ring_blocks(per_sm)
            y = gl.lab_w8_ring(*ops, stages=stages, blocks=blocks)
            lab.row(name, lambda stages=stages, blocks=blocks: gl.lab_w8_ring(
                *ops, stages=stages, blocks=blocks), c.bound_s("w8"),
                f"exact={c.exact(y)}")
    for stages in STAGE_SWEEP:
        name = f"lab_w8_ring_n bn=128 bks=128 stages={stages}"
        if lab.skip(name, 128, 128, stages, "base", gl.LAB_CONFIGS):
            continue
        y = gl.lab_w8_ring_n(*ops, stages=stages)
        lab.row(name, lambda stages=stages: gl.lab_w8_ring_n(
            *ops, stages=stages), c.bound_s("w8"), f"exact={c.exact(y)}")


def exp_dmaprod(lab: Lab, m: int = 4):
    """Production against lab_w8_ring (128 x 128, 3 stages, a block an
    SM) at Qwen2.5-7B's decode shapes."""
    tot_p = tot_r = 0.0
    for name, (n, k) in SHAPES.items():
        c = Case(m, n, k)
        ops = c.operands("w8")
        y = gl.lab_w8_ring(*ops)
        tp = lab.row(f"{name} production w8", c.production("w8"),
                     c.bound_s("w8"))
        tr = lab.row(f"{name} lab_w8_ring", lambda: gl.lab_w8_ring(*ops),
                     c.bound_s("w8"), f"exact={c.exact(y)}")
        tot_p += tp.median
        tot_r += tr.median
        del c
    lab.log(f"TOTAL: production {tot_p:.4f} ms, ring {tot_r:.4f} ms "
            f"({tot_p / tot_r:.3f}x)  [{lab.card}]")


def candidates(c: Case, fmt: str):
    """(name, callable, must) of every built lab variant of a format at
    the case's shape: w8 base tiles, the default tile at each split count
    of SPLIT_SWEEP that production's plan does not give, the rings; w4 f32
    tiles and the same splits. `must`: the variant keeps production's k
    order, so its output must equal production's bit for bit (else it is
    held to the sum-order bound)."""
    ops = c.operands(fmt)
    lab = gl.lab_w8 if fmt == "w8" else gl.lab_w4
    mode = "base" if fmt == "w8" else "f32"
    plan = gk._split_plan(c.m, c.n, c.kq)[1]
    out = []
    for bn, bks, stages, md in gl.LAB_CONFIGS:
        if md == mode:
            out.append((f"{lab.__name__} bn={bn} bks={bks} stages={stages}",
                        lambda bn=bn, bks=bks, stages=stages: lab(
                            *ops, bn=bn, bks=bks, stages=stages), True))
    for splits in SPLIT_SWEEP:
        if gl._plan(c.m, c.n, c.kq, splits)[0] != plan:
            out.append((f"{lab.__name__} bn=128 bks=128 stages=3 "
                        f"splits={splits}",
                        lambda splits=splits: lab(*ops, splits=splits,
                                                  **DEFAULT), False))
    if fmt == "w8":
        for bn, bks, stages in gl.RING_CONFIGS:
            for per_sm in (1, 2):
                blocks = gl.ring_blocks(per_sm)
                out.append((f"lab_w8_ring bn={bn} bks={bks} stages={stages} "
                            f"{per_sm}/SM",
                            lambda bn=bn, bks=bks, stages=stages, b=blocks:
                            gl.lab_w8_ring(*ops, bn=bn, bks=bks,
                                           stages=stages, blocks=b), True))
            out.append((f"lab_w8_ring_n bn={bn} bks={bks} stages={stages}",
                        lambda bn=bn, bks=bks, stages=stages:
                        gl.lab_w8_ring_n(*ops, bn=bn, bks=bks,
                                         stages=stages), plan == 1))
    return out


def _rounds(ts) -> Timing:
    """The per-round medians of one callable: their median, min and max."""
    meds = [t.median for t in ts]
    return Timing(statistics.median(meds), min(meds), max(meds),
                  statistics.median(t.host for t in ts))


def best_by_site(lab: Lab, m: int = 4, sites=SHAPES):
    """For each site and format: production, every built variant (timed;
    bitwise to production where it keeps production's k order, else
    within the sum-order bound), the fastest; then production, the
    fastest and the default tile re-timed in turns over AB_ROUNDS rounds
    (the selection's own timing is a minimum over many variants), and
    production and the fastest once more without the timer's hold (how
    much of a wrapper's host time an unheld timing counts). Returns a
    list of dicts (site, fmt, best, splits: production's k splits,
    variants: {name: (ms, exact, must, close)}, ab: {production, best,
    default: Timing over the rounds}, unheld: {production, best}, bound_ms)."""
    rows = []
    for name, (n, k) in sites.items():
        c = Case(m, n, k)
        for fmt in ("w8", "w4"):
            cands = candidates(c, fmt)
            fns = {w: fn for w, fn, _ in cands}
            variants = {}
            for what, fn, must in cands:
                y = fn()
                variants[what] = (lab.timer(fn).median, c.exact(y, fmt), must,
                                  sum_order_bound(y, c.prod[fmt], False))
            best = min(variants, key=lambda w: variants[w][0])
            default = f"lab_w{fmt[1]} bn=128 bks=128 stages=3"
            turns = {"production": c.production(fmt), "best": fns[best],
                     "default": fns[default]}
            per = {w: [] for w in turns}
            for _ in range(AB_ROUNDS):
                for w, fn in turns.items():
                    per[w].append(lab.timer(fn))
            ab = {w: _rounds(ts) for w, ts in per.items()}
            unheld = {w: lab.unheld(turns[w]) for w in ("production", "best")}
            b = c.bound_s(fmt) * 1e3
            n_must = sum(v[2] for v in variants.values())
            lab.log(f"  {name:6s} {fmt} M={m}: {len(variants)} variants "
                    f"({n_must} bitwise by design: "
                    f"{sum(v[1] for v in variants.values() if v[2])} exact; "
                    f"{len(variants) - n_must} held to the sum-order bound: "
                    f"{sum(v[3] for v in variants.values() if not v[2])} "
                    f"within); "
                    f"fastest {best} {variants[best][0]:.4f} ms; next: "
                    + "; ".join(f"{w} {variants[w][0]:.4f}" for w in sorted(
                        variants, key=lambda w: variants[w][0])[1:4]))
            lab.log(f"  {name:6s} {fmt} M={m}, {AB_ROUNDS} rounds in turns "
                    f"(median of round medians [min-max]; host ms a call): "
                    + "; ".join(f"{w} {t} host {t.host:.4f}"
                                for w, t in ab.items())
                    + f"; best/production "
                    f"{ab['best'].median / ab['production'].median:.3f}, "
                    f"default/production "
                    f"{ab['default'].median / ab['production'].median:.3f}; "
                    f"unheld: production {unheld['production']}, best "
                    f"{unheld['best']}; bound {b:.4f} ms  [{lab.card}]")
            rows.append(dict(site=name, fmt=fmt, best=best,
                             splits=gk._split_plan(m, n, c.kq)[1],
                             variants=variants, ab=ab, unheld=unheld,
                             bound_ms=b))
        del c
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.gemm_lab")
    ap.add_argument("--exp", default="blocks",
                    choices=["blocks", "scale", "w4", "shapes", "dma",
                             "dmaprod"])
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--bk", type=int, default=128,
                    help="k rows a stage (BKS) for --exp scale")
    ap.add_argument("--bn", type=int, default=128,
                    help="columns a block (BN) for --exp scale")
    a = ap.parse_args(argv)
    require_cuda("the GEMM lab")
    torch.backends.cuda.matmul.allow_tf32 = False
    lab = Lab()
    print(f"device={torch.cuda.get_device_name(0)} ({lab.card})")
    if a.exp == "blocks":
        exp_blocks(lab, a.m, a.n, a.k)
    elif a.exp == "scale":
        exp_scale(lab, a.m, a.n, a.k, a.bk, a.bn)
    elif a.exp == "w4":
        exp_w4(lab, a.m, a.n, a.k)
    elif a.exp == "shapes":
        exp_shapes(lab)
    elif a.exp == "dma":
        exp_dma(lab, a.m, a.n, a.k)
    else:
        exp_dmaprod(lab)


if __name__ == "__main__":
    main()
