"""Measured per-shape GEMM plan (counterpart of
``arcquant_tpu/kernels/autotune.py``).

The small-M GEMM tile (``csrc/gemm_small_m.cuh``: gemm_w8, gemm_w4, the
decode megakernels, gemm_batched) splits k across blocks, and
``gemm._split_plan`` picks the split count by a heuristic
(``gemm.heuristic_splits``: about two blocks an SM). This module times
every candidate split of a weight shape on the card, once, persists the
winner, and ``_split_plan`` consults the table before its heuristic. On
an H100 the heuristic gives Qwen2.5-7B's gateup (N 37888, 296 blocks)
one split, while the GEMM lab measured 4-8 splits faster (PERF.md).

What is measured differs from the JAX package, whose candidates are the
TPU kernel's (bk, bn) blocks and its fused-vs-DMA choice: here they are
``gemm.split_candidates`` (the heuristic's count first, then 1 up to the
most splits that keep ``gemm._MIN_SPLIT_TILES`` k-tiles a split), each
timed as a whole launch (the split-K reduce included), in turns.
``lookup_split`` replaces ``lookup_blocks``. The JAX package's
``lookup`` (fused kernel vs manual DMA stream) has no counterpart: the
port folded the DMA variants into gemm_w8 and gemm_w4, and the port's
contract drops the choice (ROADMAP.md). A split changes only the f32
summation order of the output (each split's k-tiles in order, the
splits summed in order); every consumer of the plan takes
``_split_plan``'s answer, so the megakernels stay bitwise the chain
under any table.

Table resolution order (read once a process, by ``_load``):
  1. the file named by ARC_AUTOTUNE_FILE, else the user table
     ``arc_gemm_autotune_torch.json`` in the temp directory (TMPDIR,
     else /tmp; written by ``autotune_*`` and
     ``benchmarks/gemm_autotune.py``; not the JAX package's file);
  2. the table shipped for the card kind,
     ``kernels/autotune_tables/<slug>.json``, the slug from
     ``torch.cuda.get_device_name`` (``nvidia_h100_80gb_hbm3``); without
     a CUDA device there is none, and nothing initialises CUDA.
A miss, or an entry that fails its checks, means the heuristic. m 4 and
8 have buckets of their own and do not fall back to the 16 bucket as
the JAX package's do.

The table is read when a GEMM launches. A CUDA graph keeps the plan it
captured: the engine tunes at build, before any capture
(``ARC_GEMM_AUTOTUNE=1``), and a process that changes tables drops its
graphs (``InferenceEngine.drop_graphs``).
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys
import tempfile
import threading
from typing import Dict, Optional

import torch

_ENV_FILE = "ARC_AUTOTUNE_FILE"
_ENV_ENABLE = "ARC_GEMM_AUTOTUNE"     # "1": engines tune at build
_DEFAULT_NAME = "arc_gemm_autotune_torch.json"
# least relative gain over the heuristic for an entry to be trusted: the
# JAX package's session-to-session variance on its TPU (there the
# environment variable ARC_AUTOTUNE_MARGIN; a constant here)
_NOISE_MARGIN = 0.08

_lock = threading.Lock()
# key -> {"splits": s, "heuristic": h, "ms": {str(split): ms}, "noise": r}
_table: Optional[Dict[str, dict]] = None
_table_src: Optional[str] = None
# lookup_split's answers under the table in force, by (fmt, m, kq, n)
_resolved: Dict[tuple, Optional[int]] = {}


def _device_kind_slug() -> Optional[str]:
    """The current CUDA device's name as a file name, None without one."""
    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(torch.cuda.current_device())
    return re.sub(r"[^a-z0-9]+", "_", kind.lower()).strip("_")


def _shipped_table_path() -> Optional[str]:
    slug = _device_kind_slug()
    return (None if slug is None else
            os.path.join(os.path.dirname(__file__), "autotune_tables",
                         slug + ".json"))


def _user_table_path() -> str:
    return os.environ.get(_ENV_FILE) or os.path.join(tempfile.gettempdir(),
                                                     _DEFAULT_NAME)


def _key(fmt: str, m: int, kq: int, n: int) -> str:
    return f"{fmt}|{m}|{kq}|{n}"


def _load() -> Dict[str, dict]:
    global _table, _table_src
    t = _table
    if t is not None:
        return t
    with _lock:
        if _table is not None:
            return _table
        for path in (_user_table_path(), _shipped_table_path()):
            if path is None:
                continue
            try:
                with open(path) as f:
                    t = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(t, dict):
                _table, _table_src = t, path
                return _table
        _table, _table_src = {}, None
        return _table


def invalidate_cache() -> None:
    """Force a re-read of the table file (tests; a switch of tables)."""
    global _table, _table_src
    with _lock:
        _table = None
        _table_src = None
        _resolved.clear()


def _m_bucket(m: int) -> int:
    """4 and 8 get their own buckets (decode at bs 4 and 8); above that,
    multiples of 16."""
    if m <= 4:
        return 4
    if m <= 8:
        return 8
    return -(-m // 16) * 16


def _noise_margin(entry: dict) -> float:
    """Least relative gain over the heuristic's measured time for a table
    entry to be trusted: _NOISE_MARGIN or the entry's own measured
    spread, whichever is larger."""
    return max(_NOISE_MARGIN, float(entry.get("noise", 0.0)))


def _legal(splits, kq: int) -> bool:
    """splits gives a plan of the small-M tile at Kq: 1 <= splits <=
    k-tiles, and the per it implies covers [0, k_tiles) once, no split
    empty."""
    from . import gemm
    k_tiles = kq // gemm._BK
    return (isinstance(splits, int) and not isinstance(splits, bool)
            and 1 <= splits <= k_tiles and kq % gemm._BK == 0
            and gemm._plan_at(k_tiles, splits)[0] == splits)


def _ms(entry: dict, splits: int) -> Optional[float]:
    v = entry.get("ms", {}).get(str(splits)) if isinstance(
        entry.get("ms"), dict) else None
    return float(v) if isinstance(v, (int, float)) else None


def lookup_split(fmt: str, m: int, kq: int, n: int) -> Optional[int]:
    """The measured split count of the small-M tile for this shape, or
    None (the heuristic applies). An entry is used only if its "splits"
    is a legal plan for Kq and its time beats the heuristic's measured
    time ("ms" of heuristic_splits' count) by more than _noise_margin.
    Entries in the JAX package's format (fused/dma/bk/bn) carry no
    "splits" and are ignored. m is bucketed (_m_bucket). The answer is
    worked out once a shape and table (invalidate_cache forgets it), so
    a launch pays one dict lookup."""
    k = (fmt, m, kq, n)
    try:
        return _resolved[k]
    except KeyError:
        pass
    s = _resolve(fmt, m, kq, n)
    _resolved[k] = s
    return s


def _resolve(fmt: str, m: int, kq: int, n: int) -> Optional[int]:
    t = _load()
    if not t:
        return None
    e = t.get(_key(fmt, _m_bucket(m), kq, n))
    if not isinstance(e, dict):
        return None
    s = e.get("splits")
    if not _legal(s, kq):
        return None
    from . import gemm
    h = gemm.heuristic_splits(m, n, kq)
    if s == h:
        return None
    t_s, t_h = _ms(e, s), _ms(e, h)
    if t_s is None or t_h is None or t_h - t_s <= _noise_margin(e) * t_s:
        return None
    return s


def _persist() -> None:
    path = _user_table_path()
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(_table, f, indent=1, sort_keys=True)
    except OSError as e:
        print(f"autotune: persist to {path} failed: {e}", file=sys.stderr)


def _record(fmt: str, m: int, kq: int, n: int, entry: dict) -> None:
    """Put a measured entry in the table in force and write the table to
    the user file."""
    t = _load()
    with _lock:
        t[_key(fmt, _m_bucket(m), kq, n)] = entry
        _resolved.clear()
    _persist()


def measure_packed(pw, m: int, *, reps: int = 5, verbose: bool = False,
                   timer=None) -> dict:
    """Time every candidate split of one packed 2-D weight at batch m on
    the card; record the entry and return it.

    Each of `reps` rounds times every candidate once (the heuristic's
    first), as whole gemm_w8 / gemm_w4 launches through
    utils/timing.Timer (the median of 5 CUDA-event runs, L2 flushed).
    The entry: "splits" the fastest count, "heuristic" heuristic_splits'
    count, "ms" each candidate's median over the rounds, "noise" the
    larger relative spread (max - min) / median over the rounds of the
    winner and the heuristic, "reps". Raises without CUDA: nothing
    measures on the CPU."""
    from ..quant.packing import PackedWeight
    from ..utils.timing import Timer
    from . import gemm

    if not torch.cuda.is_available() or pw.codes.device.type != "cuda":
        raise RuntimeError("autotune.measure_packed times the GPU: it "
                           "needs a packed weight on a CUDA device")
    if pw.codes.dim() != 2 or not 1 <= m <= gemm._SMALL_M:
        raise ValueError(f"autotune: the small-M tile's split plan is "
                         f"tuned for 2-D weights at M <= {gemm._SMALL_M}")
    if reps < 1:
        raise ValueError("autotune: reps >= 1")
    w4 = isinstance(pw, PackedWeight)
    fmt = "w4" if w4 else "w8"
    kq, n, dev = pw.kq, pw.n, pw.codes.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xa = torch.randn((m, kq), generator=gen, device=dev).to(torch.bfloat16)
    gs = torch.ones((m, 1), dtype=torch.float32, device=dev)
    gw = pw.global_scale.float().reshape(1, -1).expand(1, n)
    timer = timer or Timer(5)
    cands = gemm.split_candidates(m, n, kq)
    rounds = {s: [] for s in cands}
    for _ in range(reps):
        for s in cands:
            rounds[s].append(timer(
                lambda s=s: gemm._gemm_cuda(w4, xa, pw.codes, pw.scales, gs,
                                            gw, pw.bias, torch.bfloat16,
                                            splits=s)))
    ms = {s: statistics.median(t.median for t in v)
          for s, v in rounds.items()}
    best, h = min(cands, key=lambda s: ms[s]), cands[0]

    def spread(s):
        v = rounds[s]
        if len(v) == 1:
            return (v[0].hi - v[0].lo) / v[0].median
        meds = [t.median for t in v]
        return (max(meds) - min(meds)) / ms[s]
    noise = max(spread(best), spread(h))
    entry = {"splits": best, "heuristic": h,
             "ms": {str(s): round(ms[s], 6) for s in cands},
             "noise": round(noise, 4), "reps": reps}
    if verbose:
        per = " ".join(f"{s}:{ms[s]:.4f}" for s in cands)
        print(f"autotune {fmt} m={m} {kq}x{n}: ms by splits {per} -> "
              f"{best} (heuristic {h}, {ms[h] / ms[best]:.3f}x, noise "
              f"{noise:.1%})", file=sys.stderr)
    _record(fmt, m, kq, n, entry)
    return entry


def _site_selects(cfg, select_num: int, select_frac: float):
    """select(k): the ARC column count of a site of width k: select_num
    at every site, or round(select_frac * k / 64) * 64 (identity_calib's
    rule) when select_frac is given."""
    if select_frac:
        return lambda k: int(round(select_frac * k / 64)) * 64
    return lambda k: select_num


def engine_weight_shapes(cfg, select_num: int = 0,
                         include_head: bool = False,
                         select_frac: float = 0.0) -> list:
    """Distinct (kq, n) decode-GEMM shapes of a model config in the fused
    engine layout (qkv / o / gateup / down; quantized.py
    quantize_layer_params_fused). include_head adds the packed lm_head
    (select-free). An MoE config adds its fused dense-decode gateup, one
    weight of N = E * 2F (models/moe.py). select_frac (not in the JAX
    package) gives each site its own ARC count, as an engine calibrated
    with identity_calib(cfg, select_frac) has."""
    from ..quant.packing import pad_kq

    sel = _site_selects(cfg, select_num, select_frac)
    h = cfg.hidden_size
    kv = cfg.num_kv_heads * cfg.head_dim
    q = cfg.num_heads * cfg.head_dim
    inter = cfg.intermediate_size
    shapes = {
        (pad_kq(h, sel(h)), q + 2 * kv),          # qkv
        (pad_kq(q, sel(q)), h),                   # o
        (pad_kq(h, sel(h)), 2 * inter),           # gateup
        (pad_kq(inter, sel(inter)), h),           # down
    }
    if include_head and getattr(cfg, "vocab_size", 0):
        shapes.add((pad_kq(h, 0), cfg.vocab_size))
    if getattr(cfg, "num_experts", 0):
        e, f = cfg.num_experts, cfg.moe_intermediate_size
        shapes.add((pad_kq(h, sel(h)), e * 2 * f))
    return sorted(shapes)


def autotune_shapes(shapes, m: int, *, fmt: str = "w8",
                    verbose: bool = True, reps: int = 5,
                    force: bool = False) -> Dict[str, dict]:
    """Tune random weights of the (kq, n) shapes at batch m on the card.
    Shapes already in the table are kept (measure once) unless force."""
    from ..quant.packing import pack_weight_arc_rows

    t = _load()
    out = {}
    for kq, n in shapes:
        k = _key(fmt, _m_bucket(m), kq, n)
        if k in t and not force:
            out[k] = t[k]
            continue
        if not torch.cuda.is_available():
            raise RuntimeError("autotune.autotune_shapes times the GPU: "
                               "torch sees no CUDA device")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(kq * 1000003 + n)
        w = (torch.randn((n, kq), generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        ridx = torch.arange(kq, dtype=torch.int32, device="cuda")
        pw = pack_weight_arc_rows(w, ridx, 0, fmt=fmt)
        del w
        k = _key(fmt, _m_bucket(m), pw.kq, pw.n)   # the padded shape
        out[k] = measure_packed(pw, m, reps=reps, verbose=verbose)
        del pw
    return out


def autotune_for_config(cfg, m: int, fmt: str = "w8",
                        select_num: int = 0, verbose: bool = True,
                        reps: int = 5) -> Dict[str, dict]:
    """Tune all decode-GEMM shapes of a model config at batch m."""
    return autotune_shapes(engine_weight_shapes(cfg, select_num), m,
                           fmt=fmt, verbose=verbose, reps=reps)


def _packed_leaves(tree):
    from ..quant.packing import PackedWeight, PackedWeightI8
    if isinstance(tree, (PackedWeight, PackedWeightI8)):
        return [tree]
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _packed_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in _packed_leaves(v)]
    return []


def autotune_engine(qparams, m: int, verbose: bool = True,
                    reps: int = 5) -> Dict[str, dict]:
    """Tune the distinct 2-D w8 and w4 packed weights of an engine's
    params (the head included) at batch m, on the weights themselves.
    Call at build, before any capture. Shapes already in the table are
    kept, so the steady-state cost is one table read. Stacked experts
    (gemm_batched) take the plan of the single GEMM of their shape and
    are not timed, as in the JAX package. m above the small-M tile's
    range has no split to tune."""
    from . import gemm
    from ..quant.packing import PackedWeight

    if not 1 <= m <= gemm._SMALL_M:
        return {}
    t = _load()
    seen, out = set(), {}
    for pw in _packed_leaves(qparams):
        if pw.codes.dim() != 2:
            continue
        fmt = "w4" if isinstance(pw, PackedWeight) else "w8"
        k = _key(fmt, _m_bucket(m), pw.kq, pw.n)
        if k in seen:
            continue
        seen.add(k)
        if k in t:
            out[k] = t[k]
            continue
        out[k] = measure_packed(pw, m, reps=reps, verbose=verbose)
    return out


def should_autotune(device=None) -> bool:
    """ARC_GEMM_AUTOTUNE=1 and the engine on a CUDA device (`device`, or
    any when None)."""
    if os.environ.get(_ENV_ENABLE) != "1":
        return False
    if device is not None:
        return torch.device(device).type == "cuda"
    return torch.cuda.is_available()
