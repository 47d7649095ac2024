"""Promote a measured GEMM plan table to the one shipped for the card
kind, ``kernels/autotune_tables/<slug>.json`` (counterpart of the JAX
package's ``benchmarks/ship_table.py``).

  python -m arcquant_tpu_torch.benchmarks.ship_table [--src table.json] [--dst out.json] [--dry]

Prints every entry with the ms of its choice and of the heuristic's
split, the gain, the noise gate (kernels/autotune._noise_margin) and
the verdict, and flags the entries whose gain is inside the gate
(lookup_split keeps the heuristic for those). Entries are shipped as
measured: the gate is lookup_split's, applied on every read. Merges
into the existing shipped table (new entries win).
--src defaults to the user table (ARC_AUTOTUNE_FILE, else
arc_gemm_autotune_torch.json in the temp directory); --dst to the
current CUDA device's shipped table, and without a CUDA device it must
be given.
"""

from __future__ import annotations

import argparse
import json


def verdict(e: dict) -> str:
    """What lookup_split makes of one measured entry."""
    from ..kernels import autotune

    s, h = e["splits"], e["heuristic"]
    t_s, t_h = e["ms"][str(s)], e["ms"][str(h)]
    gate = autotune._noise_margin(e)
    if s == h:
        return "heuristic (measured fastest)"
    if t_h - t_s <= gate * t_s:
        return f"INSIDE NOISE (gate {gate:.1%}) -> heuristic"
    return f"{s} splits"


def main(argv=None):
    from ..kernels import autotune

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default="")
    ap.add_argument("--dst", default="")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args(argv)

    with open(args.src or autotune._user_table_path()) as f:
        src = json.load(f)
    dst_path = args.dst or autotune._shipped_table_path()
    if dst_path is None:
        raise SystemExit("ship_table: no CUDA device to name the shipped "
                         "table; pass --dst")
    try:
        with open(dst_path) as f:
            dst = json.load(f)
    except (OSError, ValueError):
        dst = {}

    for k in sorted(src):
        e = src[k]
        if "splits" not in e:
            print(f"{k:28s} not a split entry (the JAX package's format?): "
                  "skipped")
            continue
        what = verdict(e)
        s, h = e["splits"], e["heuristic"]
        print(f"{k:28s} best {s:3d} splits {e['ms'][str(s)]:.4f} ms, "
              f"heuristic {h:3d} {e['ms'][str(h)]:.4f} ms, "
              f"{e['ms'][str(h)] / e['ms'][str(s)]:.3f}x, noise "
              f"{float(e.get('noise', 0.0)):5.1%} -> {what}")
        dst[k] = e

    if args.dry:
        print(f"(dry run: not writing {dst_path})")
        return dst
    with open(dst_path, "w") as f:
        json.dump(dst, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(dst)} entries -> {dst_path}")
    return dst


if __name__ == "__main__":
    main()
