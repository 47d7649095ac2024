"""Measure the small-M GEMM's k split for each weight shape on the card
and persist the plan table gemm._split_plan consults (counterpart of the
JAX package's ``benchmarks/gemm_autotune.py``; kernels/autotune.py).

  python -m arcquant_tpu_torch.benchmarks.gemm_autotune --model qwen2.5-7b --m 4 --reps 5
  python -m arcquant_tpu_torch.benchmarks.gemm_autotune --fmt w4 --head --select_frac 0.125
  python -m arcquant_tpu_torch.benchmarks.gemm_autotune --shapes 4096x37888,3584x4608

Every candidate split (the heuristic's first) is timed as a whole launch
in turns, `--reps` rounds of the median of 5 CUDA-event runs with L2
flushed. Prints, for each shape, the ms of each split, the choice, its
gain over the heuristic and the noise, beside the card's name and power
limit, then the table's entries as JSON. The table lands at
ARC_AUTOTUNE_FILE (default: arc_gemm_autotune_torch.json in the temp
directory); ``ship_table`` promotes it to the table shipped for the card
kind. Measures the GPU only: without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import sys

from .common import card, require_cuda


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="qwen2.5-7b",
                    help="model config name, or comma-separated list "
                         "('' for --shapes only)")
    ap.add_argument("--m", type=int, default=32,
                    help="decode batch size to tune at (<= 64)")
    ap.add_argument("--select_num", type=int, default=0,
                    help="ARC outlier count at every site (affects the "
                         "padded kq)")
    ap.add_argument("--select_frac", type=float, default=0.0,
                    help="ARC outlier fraction, each site's own count "
                         "(identity_calib's rule); overrides --select_num")
    ap.add_argument("--shapes", default="",
                    help="extra KQxN pairs, comma-separated")
    ap.add_argument("--fmt", default="w8", choices=["w8", "w4"])
    ap.add_argument("--reps", type=int, default=5,
                    help="rounds of every candidate, in turns (median and "
                         "noise recorded; >= 5 for shipped tables)")
    ap.add_argument("--head", action="store_true",
                    help="include the packed lm_head shape")
    ap.add_argument("--force", action="store_true",
                    help="re-measure shapes already in the table")
    return ap.parse_args(argv)


def shapes_of(args) -> list:
    """The (kq, n) shapes the flags name."""
    from ..config import get_model_config
    from ..kernels import autotune

    shapes = []
    for name in filter(None, args.model.split(",")):
        shapes += autotune.engine_weight_shapes(
            get_model_config(name), args.select_num, include_head=args.head,
            select_frac=args.select_frac)
    for s in filter(None, args.shapes.split(",")):
        kq, n = s.lower().split("x")
        shapes.append((int(kq), int(n)))
    return sorted(set(shapes))


def summary(key: str, e: dict) -> dict:
    """One printed entry: ms by split, the choice, the heuristic, the
    gain and the noise."""
    ms = e["ms"]
    h, s = e["heuristic"], e["splits"]
    return {"ms_by_splits": ms, "splits": s, "heuristic": h,
            "heuristic_over_best": round(ms[str(h)] / ms[str(s)], 4),
            "noise": e.get("noise")}


def main(argv=None):
    args = parse_args(argv)
    require_cuda("gemm_autotune")
    from ..kernels import autotune

    where = card()
    shapes = shapes_of(args)
    print(f"gemm_autotune {args.fmt} M={args.m}: {len(shapes)} shapes, "
          f"{args.reps} rounds, on {where}", flush=True)
    res = autotune.autotune_shapes(shapes, args.m, fmt=args.fmt,
                                   reps=args.reps, force=args.force)
    out = {k: summary(k, v) for k, v in res.items() if "splits" in v}
    for k, v in sorted(out.items()):
        print(f"{k:28s} splits {v['splits']:3d} (heuristic "
              f"{v['heuristic']:3d}, {v['heuristic_over_best']:.3f}x) "
              f"noise {v['noise']}  [{where}]")
    print(json.dumps(dict(table=out, card=where), sort_keys=True))
    print(f"table: {autotune._user_table_path()}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
