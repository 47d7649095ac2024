"""Aggregate a profiler's chrome trace into a per-op time table, and
attribute the device time of an engine step to the profile rows
(counterpart of ``benchmarks/trace_summary.py``).

  python -m arcquant_tpu_torch.benchmarks.trace_summary <trace> [--top 30]

<trace> is a trace file (``.json`` or ``.json.gz``) or a directory: the
logdir of ``utils/timing.py``'s ``profile_trace`` (torch's
``tensorboard_trace_handler`` files, ``*.pt.trace.json[.gz]``) or the
JAX layouts the JAX script reads (``plugins/profile/*/*.trace.json.gz``,
``*.trace.json[.gz]``). It prints total device time, call count and
mean per op name, largest first.

Where the port departs from the JAX script: that script tells device
events by their process's name (tpu, device, xla, /gpu) and, when no
process matches, counts every event as device time. torch's traces name
their device process otherwise ("GPU 0"), so that fallback would count
the host's ``aten::`` ops and ``cudaLaunchKernel`` calls as device time.
Here an event whose category is a device activity (``kernel``,
``gpu_memcpy``, ``gpu_memset``: what kineto writes for CUPTI's kernel,
copy and fill records) is device time; a trace without such events
falls back to the JAX script's process rule, and a trace with neither
raises unless ``--all-pids`` (``device_only=False``) asks for every
event, host events then listed as host rows.

The graph map. A CUDA graph replay has no Python frames: the profiler
sees one ``cudaGraphLaunch`` and then the graph's kernels. The graph
was captured from one run of its body on one stream, so a replay's
device activities come in the order of the eager body's launches.
``map_graph`` profiles one eager run of the body on a state of its own,
every call that ``common.engine_calls`` counts inside a profiler range
(``engine_calls(..., ranges=True)``), links each eager device activity
to the range that launched it through the launch's correlation id,
then profiles replays of the graph and gives replay activity i of each
step the row of eager activity i. It raises (``MapError``) if the
counts differ or a name differs at any position (a device-to-device
copy or a fill is held by its kind: a graph may run such a node as a
kernel of CUDA's own, "memcpy32_post" for "Memcpy DtoD"); nothing is
skipped or re-aligned. The rows plus the unlabelled activities (embedding,
residual adds, casts) partition the replay's summed durations. The
profiler stretches the gaps and the span, not kernel durations, so the
unprofiled replay time is printed beside them. CUPTI drops a few device
records at a profile's start, so ``profiled`` runs a warm-up first and
the tables and maps keep only what it launched inside its measured
range; a profile that still lost records (a launch with none, or
replays of one graph holding different counts: ``ProfilerLoss``) is
taken again, PROFILES times at most.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import gzip
import json
import math
import os
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import common

# kineto's categories of CUPTI's device records: kernels, copies, fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host calls that launch them, which carry the correlation id
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the JAX script's markers of a device process
DEVICE_PROCESS_KEYS = ("tpu", "device", "xla", "/gpu")
# names of the unlabelled activities, and of all activities, a map prints
TOP_UNLABELLED = 8
TOP_KERNELS = 16


class MapError(RuntimeError):
    """The replay's activities are not the eager body's, or the rows do
    not partition the replay's device time."""


class ProfilerLoss(MapError):
    """A profile lost device records: a launch of the measured run with no
    record, or replays of one graph (grouped by their launch's
    correlation id) holding different counts. map_graph profiles again
    (PROFILES times in all)."""


PROFILES = 3
# the host calls that put work on the device, by name
LAUNCH_CALLS = ("Launch", "Memcpy", "Memset")
# profiled() runs its function inside a range of this name, after
# WARM_UP small kernels: on the card CUPTI drops a few device records at
# a profile's start (the first replay of a graph held 1-9 fewer than the
# others on an H100), and the warm-up's take the loss; device activities
# launched outside the range are left out of every table and map
MEASURED = "trace:measured"
WARM_UP = 64


def load_events(path: str) -> list:
    """The chrome-trace events of a trace directory or a single
    .json(.gz) trace file."""
    if os.path.isdir(path):
        pats = [os.path.join(path, "plugins", "profile", "*",
                             "*.trace.json.gz"),
                os.path.join(path, "*.trace.json.gz"),
                os.path.join(path, "*.trace.json")]
        files = sorted({f for p in pats for f in glob.glob(p)})
        if not files:
            raise FileNotFoundError(f"no trace files under {path}")
    else:
        files = [path]
    events = []
    for f in files:
        op = gzip.open if f.endswith(".gz") else open
        with op(f, "rt") as fh:
            data = json.load(fh)
        # chrome traces come as {"traceEvents": [...]} or as a bare
        # JSON array of events
        events += (data.get("traceEvents", []) if isinstance(data, dict)
                   else data)
    return events


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


def is_device(e) -> bool:
    """A complete event of a device activity (kernel, copy, fill)."""
    return e.get("ph") == "X" and "dur" in e and _cat(e) in DEVICE_CATS


def _launched_inside(events):
    """The correlation ids of the launch calls made inside the MEASURED
    range, or None for a trace without one."""
    win = [e for e in events if _cat(e) == "user_annotation"
           and e.get("name") == MEASURED]
    if not win:
        return None
    w = win[0]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    where = (w.get("pid"), w.get("tid"))
    return {_correlation(e) for e in events
            if _cat(e) in LAUNCH_CATS and _correlation(e) is not None
            and (e.get("pid"), e.get("tid")) == where
            and lo <= float(e["ts"]) <= hi}


def measured(events) -> list:
    """The events less the device activities launched outside the
    MEASURED range (profiled()'s warm-up), where the trace has one."""
    inside = _launched_inside(events)
    if inside is None:
        return list(events)
    return [e for e in events
            if not is_device(e) or _correlation(e) in inside]


def summarize(events, device_only: bool = True):
    """Aggregate complete ('X') events by name: (rows, device_pids), rows
    = [(name, total_us, count, on_device)] largest total first, as the
    JAX script's. Device events are those of a device category; without
    any, those of a process named as the JAX script's markers say.
    device_only=False keeps the host's events too; with device_only and
    no device event at all this raises (the JAX script would count
    every event as device time). A profiled() trace's warm-up is left
    out (measured())."""
    events = measured(events)
    pid_name = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_name[e.get("pid")] = str(e.get("args", {}).get("name", ""))
    if any(is_device(e) for e in events):
        on_device = is_device
        dev_pids = {e.get("pid") for e in events if is_device(e)}
    else:
        dev_pids = {p for p, n in pid_name.items()
                    if any(k in n.lower() for k in DEVICE_PROCESS_KEYS)}

        def on_device(e):
            return e.get("pid") in dev_pids
        if not dev_pids and device_only:
            raise ValueError(
                "the trace holds no device activity (no kernel, gpu_memcpy "
                "or gpu_memset event and no device process): was the "
                "profiler run with CUDA activity on a card? --all-pids "
                "(device_only=False) lists the host's events")
    agg = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        name = e.get("name", "?")
        # python source-frame spans ($file.py:line fn) nest and
        # double-count; they are host noise, not ops
        if name.startswith("$") or name.startswith("<"):
            continue
        dev = on_device(e)
        if device_only and not dev:
            continue
        a = agg[(name, dev)]
        a[0] += float(e["dur"])
        a[1] += 1
    rows = [(name, tot, cnt, dev) for (name, dev), (tot, cnt) in agg.items()]
    rows.sort(key=lambda r: -r[1])
    return rows, dev_pids


# -- the map: device activities to the rows that launched them --------------

def device_activities(events) -> list:
    """The device activities in device order (start time; one stream),
    a profiled() trace's warm-up left out."""
    return sorted((e for e in measured(events) if is_device(e)),
                  key=lambda e: float(e["ts"]))


def _op(e) -> str:
    """What a device activity does, to hold a replay's against the eager
    body's: its name, but a device-to-device copy and a fill by their
    kind, since a graph may run such a node as a kernel of CUDA's own
    ("memcpy32_post" in place of "Memcpy DtoD (Device -> Device)")."""
    name, cat = e.get("name", ""), _cat(e)
    if (cat == "gpu_memcpy" and "DtoD" in name) or (
            cat == "kernel" and name.startswith("memcpy")):
        return "memcpy DtoD"
    if cat == "gpu_memset" or (cat == "kernel" and name.startswith("memset")):
        return "memset"
    return name


def _correlation(e):
    return e.get("args", {}).get("correlation")


def label_activities(events):
    """(activities, labels, calls) of an eager run profiled under
    engine_calls(..., ranges=True): the device activities in order;
    for each, (row, in_arc): the outermost range around the host call
    that launched it (linked by correlation id; None outside every
    range) and whether an ARC residual range encloses that call; and
    the outermost ranges' count by row (the calls)."""
    prefix = common.RANGE
    threads = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        name, ts = e.get("name", ""), float(e["ts"])
        where = (e.get("pid"), e.get("tid"))
        if _cat(e) == "user_annotation" and name.startswith(prefix):
            threads[where].append((ts, 0, -float(e["dur"]),
                                   name[len(prefix):]))
        elif _cat(e) in LAUNCH_CATS and _correlation(e) is not None:
            threads[where].append((ts, 1, 0.0, _correlation(e)))
    calls = collections.Counter()
    by_corr = {}
    for items in threads.values():
        stack = []                      # (end, row) of the open ranges
        for ts, kind, neg_dur, ref in sorted(items, key=lambda t: t[:3]):
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if kind == 0:
                if not stack:
                    calls[ref] += 1
                stack.append((ts - neg_dur, ref))
            elif stack:
                by_corr[ref] = (stack[0][1], any(
                    r == common.ARC_RESIDUAL for _, r in stack))
    acts = device_activities(events)
    labels = [by_corr.get(_correlation(a), (None, False)) for a in acts]
    return acts, labels, calls


def _span(acts) -> Tuple[float, float]:
    """(span, busy) in us: last end less first start, and the union of
    the activities' intervals."""
    if not acts:
        return 0.0, 0.0
    spans = sorted((float(a["ts"]), float(a["ts"]) + float(a["dur"]))
                   for a in acts)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return max(e for _, e in spans) - spans[0][0], busy


def _tally(acts, labels, calls, steps: int) -> dict:
    """The attribution of device activities acts[i], labelled labels[i],
    over `steps` steps: {"rows": {row: {"calls", "ms_step", "ms_call",
    "arc_ms_step"}}, "unlabelled": {"ms_step", "top": [(name, ms_step,
    per_step)]}, "total_ms_step", "busy_ms_step", "span_ms_step",
    "gap_ms_step", "arc_ms_step", "activities_step", "steps", "kernels":
    [(name, ms_step, per_step)] of every activity name, largest first}.
    Raises
    MapError unless rows plus unlabelled sum to the activities'
    durations."""
    us = collections.Counter()
    arc_us = collections.Counter()
    free = collections.defaultdict(lambda: [0.0, 0])
    by_name = collections.defaultdict(lambda: [0.0, 0])
    durs = [float(a["dur"]) for a in acts]
    for a, (row, arc), d in zip(acts, labels, durs):
        name = a["name"]
        by_name[name][0] += d
        by_name[name][1] += 1
        if row is None:
            free[name][0] += d
            free[name][1] += 1
            continue
        us[row] += d
        if arc:
            arc_us[row] += d
    total = math.fsum(durs)
    free_us = math.fsum(v[0] for v in free.values())
    if not math.isclose(math.fsum(us.values()) + free_us, total,
                        rel_tol=1e-9, abs_tol=1e-6):
        raise MapError(f"rows {math.fsum(us.values())} us + unlabelled "
                       f"{free_us} us != the activities' {total} us")
    per = 1e3 * steps
    rows = {}
    for row in sorted(set(calls) | set(us)):
        n = calls.get(row, 0)
        rows[row] = dict(calls=n, ms_step=us[row] / per,
                         ms_call=us[row] / per / n if n else 0.0,
                         arc_ms_step=arc_us[row] / per)
    def ranked(agg):
        return [(n, v[0] / per, v[1] / steps)
                for n, v in sorted(agg.items(), key=lambda kv: -kv[1][0])]
    span, busy = _span(acts)
    return dict(rows=rows, unlabelled=dict(
        ms_step=free_us / per, activities_step=sum(v[1] for v in
                                                   free.values()) / steps,
        top=ranked(free)[:TOP_UNLABELLED]), kernels=ranked(by_name),
        total_ms_step=total / per, busy_ms_step=busy / per,
        span_ms_step=span / per, gap_ms_step=(span - busy) / per,
        arc_ms_step=math.fsum(arc_us.values()) / per,
        activities_step=len(durs) / steps, steps=steps)


def eager_map(events) -> dict:
    """The attribution of an eager run (one step) by correlation alone."""
    acts, labels, calls = label_activities(events)
    return _tally(acts, labels, calls, 1)


def _difference(ops, rep) -> str:
    """What a replay holds that the eager body does not, and the reverse:
    the replays grouped by their graph launch's correlation id."""
    steps = collections.defaultdict(list)
    for a in rep:
        steps[_correlation(a)].append(_op(a))
    want = collections.Counter(ops)
    out = []
    for corr, got in steps.items():
        have = collections.Counter(got)
        out.append(f"launch {corr}: {len(got)} activities, extra "
                   f"{dict((have - want).most_common(3))}, missing "
                   f"{dict((want - have).most_common(3))}")
    return "; " + "; ".join(out[:4]) + f" (the eager body's first "\
        f"{ops[:3]} and last {ops[-3:]})"


def _unrecorded(events) -> dict:
    """The launch, copy and fill calls of a profiled() trace's measured
    run with no device record of their own, by name."""
    inside = _launched_inside(events) or set()
    have = {_correlation(e) for e in events if is_device(e)}
    return dict(collections.Counter(
        e.get("name") for e in events
        if _cat(e) in LAUNCH_CATS and _correlation(e) in inside
        and any(k in e.get("name", "") for k in LAUNCH_CALLS)
        and _correlation(e) not in have))


def graph_map(eager_events, replay_events, steps: int) -> dict:
    """The attribution of `steps` replays of a graph: replay activity i
    of each step takes the row of activity i of the eager body's run.
    Raises MapError if the replays do not hold `steps` times the eager
    body's activities, or an activity differs at any position (by name;
    copies and fills by kind, _op)."""
    acts, labels, calls = label_activities(eager_events)
    rep = device_activities(replay_events)
    n = len(acts)
    ops = [_op(a) for a in acts]
    lost = _unrecorded(eager_events)
    if lost:
        raise ProfilerLoss(f"the eager run's calls without a device record: "
                           f"{lost}")
    per_launch = collections.Counter(_correlation(a) for a in rep)
    if len(per_launch) == steps and len(set(per_launch.values())) > 1:
        raise ProfilerLoss(f"replays of one graph hold "
                           f"{sorted(per_launch.values())} device records")
    if n == 0 or len(rep) != steps * n:
        raise MapError(f"{len(rep)} device activities over {steps} replays "
                       f"against {n} in the eager body"
                       + _difference(ops, rep))
    for i, a in enumerate(rep):
        if _op(a) != ops[i % n]:
            raise MapError(f"replay {i // n}, activity {i % n}: "
                           f"{a['name']!r}, the eager body's "
                           f"{acts[i % n]['name']!r}")
    return _tally(rep, labels * steps, calls, steps)


# -- on the card --------------------------------------------------------------

def profiled(fn: Callable[[], object], out: Optional[str] = None) -> list:
    """Run fn() under torch.profiler (host activity, and the card's where
    torch sees one, synchronized before the profile ends) inside the
    MEASURED range, after WARM_UP small kernels on the card, and return
    the chrome-trace events; `out` keeps the trace file there."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            if cuda:
                x = torch.zeros(1, device="cuda")
                for _ in range(WARM_UP):
                    x.add_(1)
                torch.cuda.synchronize()
            with torch.profiler.record_function(MEASURED):
                fn()
                if cuda:
                    torch.cuda.synchronize()
        path = os.path.join(out or tmp, "trace.pt.trace.json")
        if out:
            os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(path)
        return load_events(path)


def profile_calls(eng, fn: Callable[[], object], level: str = "ops",
                  out: Optional[str] = None):
    """(events, counts): fn() (a run of eng's forward) profiled with a
    range around each call engine_calls counts at `level`, and its
    counts."""
    with common.engine_calls(eng, level, ranges=True) as counts:
        events = profiled(fn, out)
    return events, dict(counts)


def check_calls(m: dict, counts: dict) -> None:
    """Raise MapError unless every row's calls equal engine_calls'."""
    got = {k: r["calls"] for k, r in m["rows"].items() if r["calls"]}
    if got != {k: n for k, n in counts.items() if n}:
        raise MapError(f"ranges by row {got} != engine_calls {counts}")


def _fresh_io(io):
    """A copy of a body's buffers, so that an eager run leaves the
    graph's own untouched."""
    return dataclasses.replace(io, **{
        f.name: getattr(io, f.name).clone()
        for f in dataclasses.fields(io)
        if isinstance(getattr(io, f.name), torch.Tensor)})


@torch.no_grad()
def map_graph(eng, g, state, steps: int = 8, level: str = "ops") -> dict:
    """Attribute `steps` replays of the captured step `g` (an engine
    _Graph, e.g. eng._decode_graph(state, None)) on `state` to the rows
    of engine_calls at `level`. The eager body runs once first, on a new
    state and buffers of its own, under the ranges; the graph's state is
    only replayed. Adds "calls" (engine_calls of that run) and
    "step_ms" (CUDA events around `steps` unprofiled replays) to
    graph_map's result, and "profiles": the profiles taken, more than
    one where a profile lost device records (ProfilerLoss, printed;
    PROFILES at most); raises MapError if a row's calls differ from
    engine_calls'."""
    common.require_cuda("map_graph")
    if g.graph is None:
        raise ValueError("map_graph needs a captured graph")
    eager = dataclasses.replace(g, io=_fresh_io(g.io), graph=None,
                                launches=None, counters=())
    eager_state = eng.new_state()
    for attempt in range(1, PROFILES + 1):
        torch.cuda.synchronize()
        ev, counts = profile_calls(eng, lambda: eager.run(eager_state),
                                   level)
        rep = profiled(lambda: [g.replay(state) for _ in range(steps)])
        try:
            m = graph_map(ev, rep, steps)
            break
        except ProfilerLoss as e:
            print(f"map_graph: profile {attempt} of {PROFILES} lost "
                  f"records ({e})", file=sys.stderr)
            if attempt == PROFILES:
                raise
    del eager, eager_state, ev, rep
    check_calls(m, counts)
    m["profiles"] = attempt
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        g.replay(state)
    end.record()
    end.synchronize()
    m.update(calls=counts, step_ms=start.elapsed_time(end) / steps)
    return m


def print_map(m: dict, title: str) -> None:
    """The rows largest first, the unlabelled bucket with its top names,
    and the replay's totals."""
    print(f"{title}: {m['activities_step']:.0f} device activities a step; "
          f"summed durations {m['total_ms_step']:.3f} ms a step, busy "
          f"{m['busy_ms_step']:.3f}, span {m['span_ms_step']:.3f}, gaps "
          f"{m['gap_ms_step']:.3f} (profiled)"
          + (f"; unprofiled {m['step_ms']:.3f} ms a step" if "step_ms" in m
             else ""))
    print(f"  {'row':34s} {'calls':>6s} {'ms/step':>9s} {'us/call':>9s} "
          f"{'share':>7s} {'ARC ms':>8s}")
    tot = m["total_ms_step"] or 1.0
    for row, r in sorted(m["rows"].items(), key=lambda kv: -kv[1]["ms_step"]):
        print(f"  {row:34s} {r['calls']:6d} {r['ms_step']:9.4f} "
              f"{r['ms_call'] * 1e3:9.2f} {r['ms_step'] / tot:7.2%} "
              f"{r['arc_ms_step']:8.4f}")
    u = m["unlabelled"]
    print(f"  {'unlabelled':34s} {u['activities_step']:6.0f} "
          f"{u['ms_step']:9.4f} {'':9s} {u['ms_step'] / tot:7.2%}")
    for name, ms, n in u["top"]:
        print(f"    {name[:60]:60s} {ms:9.4f} ms x{n:g}")
    print(f"  the ARC residual: {m['arc_ms_step']:.4f} ms a step "
          f"({m['arc_ms_step'] / tot:.2%}); by kernel:")
    for name, ms, n in m["kernels"][:TOP_KERNELS]:
        print(f"    {name[:60]:60s} {ms:9.4f} ms x{n:g} "
              f"({ms / n * 1e3:.2f} us each)")


def public(m: dict) -> dict:
    """A map's numbers, rounded, for a JSON line."""
    def r(v):
        return round(v, 5)
    out = {k: r(v) for k, v in m.items() if isinstance(v, float)}
    out["rows"] = {k: dict(calls=v["calls"], ms_step=r(v["ms_step"]),
                           us_call=round(v["ms_call"] * 1e3, 3),
                           arc_ms_step=r(v["arc_ms_step"]))
                   for k, v in m["rows"].items()}
    out["unlabelled"] = dict(ms_step=r(m["unlabelled"]["ms_step"]), top=[
        (n, r(ms), c) for n, ms, c in m["unlabelled"]["top"]])
    out["kernels"] = [(n[:80], r(ms), c) for n, ms, c in m["kernels"]]
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.trace_summary")
    ap.add_argument("trace", help="trace dir (profile_trace logdir) "
                    "or .json[.gz] trace file")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--all-pids", action="store_true",
                    help="include host-side events too")
    return ap


def table(rows, top: int) -> List[str]:
    """The table's lines: the op name, total us, count and mean us."""
    out = [f"{'op':60s} {'total_us':>12s} {'count':>8s} {'mean_us':>10s}"]
    for name, tot, cnt, _ in rows[:top]:
        out.append(f"{name[:60]:60s} {tot:12.1f} {cnt:8d} {tot / cnt:10.2f}")
    return out


def main(argv=None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
    rows, dev = summarize(load_events(args.trace),
                          device_only=not args.all_pids)
    total = sum(r[1] for r in rows)
    where = (f"device pids {sorted(dev, key=str)}" if dev else
             "no device activity: host events")
    print(f"{len(rows)} op names, {total / 1e3:.2f} ms total ({where})")
    print("\n".join(table(rows, args.top)))
    return {"rows": rows, "device_pids": dev}


if __name__ == "__main__":
    main()
