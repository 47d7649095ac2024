"""The port's trace tools on the CPU (benchmarks/trace_summary.py,
prefill_trace.py, verify_lab.py and decode_profile's in-graph pass):

- trace_summary's load_events and summarize against the JAX script's
  (loaded by path) on synthetic chrome traces with device-pid metadata in
  the JAX layout (plugins/profile/*/*.trace.json.gz): equal rows;
- a real CPU trace of utils/timing.py's profile_trace is found; its host
  events raise in device mode (where the JAX script would count them as
  device time) and are listed with --all-pids;
- kineto-shaped kernel, memcpy and memset events count as device, the
  host's runtime calls and ops do not;
- the graph map on synthetic sequences: rows plus unlabelled sum to the
  replay's durations, a nested ARC range stays inside its outer row, and
  a replay whose count or any name differs from the eager body's raises;
- the ranges on a test-tiny engine under the CPU profiler (the decode
  body select-free and at ARC 0.125, an ARC prefill with nested ARC
  residuals, the verify body at level "layers"): each row's outermost
  ranges equal engine_calls' count for the same run;
- verify_lab.plan at W 2 and 4 pinned to one eager verify step;
- decode_profile.run beside a graph map; the tools' main() raise without
  CUDA.
"""

import gzip
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from arcquant_tpu_torch.benchmarks import common, decode_profile
from arcquant_tpu_torch.benchmarks import prefill_trace, trace_summary as ts
from arcquant_tpu_torch.benchmarks import verify_lab
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.models import quantized
from arcquant_tpu_torch.utils.timing import profile_trace

JAX_SCRIPT = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "trace_summary.py"
QCFG = QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
                   act_scale="row", w_scale="channel", quantize_lm_head=True)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_trace_summary",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(name, pid, ts, dur, cat=None, tid=1, **args):
    e = dict(ph="X", name=name, pid=pid, tid=tid, ts=ts, dur=dur)
    if cat is not None:
        e["cat"] = cat
    if args:
        e["args"] = args
    return e


def _proc(pid, name):
    return dict(ph="M", name="process_name", pid=pid, args=dict(name=name))


def _jax_layout_trace(rng):
    """A JAX-profiler-shaped trace: a TPU process and a host process with
    repeated ops, python frame spans and one instant event."""
    ev = [_proc(1, "/device:TPU:0"), _proc(2, "/host:CPU")]
    t = 0.0
    for i in range(40):
        name = ["fusion.1", "convolution", "copy.3", "all-reduce"][i % 4]
        d = float(rng.integers(1, 50))
        ev.append(_x(name, 1, t, d))
        ev.append(_x("$engine.py:10 step" if i % 5 else "<lambda>", 2, t, d))
        ev.append(_x("PjitFunction(step)", 2, t, d * 2))
        t += d
    ev.append(dict(ph="i", name="marker", pid=2, ts=t))
    return ev


@pytest.mark.parametrize("device_only", [True, False])
def test_summarize_matches_the_jax_script_on_its_layout(tmp_path,
                                                        device_only):
    ev = _jax_layout_trace(np.random.default_rng(0))
    d = tmp_path / "plugins" / "profile" / "2024_01_01"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": ev}, f)
    jax = _jax_script()
    want_rows, want_pids = jax.summarize(jax.load_events(str(tmp_path)),
                                         device_only=device_only)
    rows, pids = ts.summarize(ts.load_events(str(tmp_path)),
                              device_only=device_only)
    assert rows == want_rows and pids == want_pids == {1}
    assert {r[0] for r in rows if r[3]} == {"fusion.1", "convolution",
                                            "copy.3", "all-reduce"}


def test_cpu_profile_trace_is_found_and_host_only_raises(tmp_path, capsys):
    with profile_trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert list(tmp_path.glob("*.pt.trace.json"))
    events = ts.load_events(str(tmp_path))
    assert any(e.get("cat") == "cpu_op" for e in events)
    with pytest.raises(ValueError, match="no device activity"):
        ts.summarize(events)
    with pytest.raises(ValueError, match="no device activity"):
        ts.main([str(tmp_path)])
    rows, pids = ts.summarize(events, device_only=False)
    assert pids == set() and rows and not any(r[3] for r in rows)
    assert "aten::mm" in {r[0] for r in rows}
    capsys.readouterr()
    out = ts.main([str(tmp_path), "--all-pids", "--top", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert "host events" in lines[0] and len(lines) == 2 + 5
    assert out["rows"] == rows


def _kineto_trace():
    """A torch/kineto-shaped trace: the host process (ops, runtime calls
    with correlation ids) and the device's, named "GPU 0", which matches
    none of the JAX script's markers."""
    ev = [_proc(100, "python3 100"), _proc(0, "GPU 0")]
    acts = [("gemm_kernel", "kernel", 30.0), ("Memcpy DtoD (Device -> "
                                              "Device)", "gpu_memcpy", 4.0),
            ("Memset (Device)", "gpu_memset", 2.0), ("gemm_kernel",
                                                     "kernel", 31.0)]
    t = 0.0
    for i, (name, cat, dur) in enumerate(acts):
        ev.append(_x("aten::op", 100, t, 9.0, "cpu_op"))
        ev.append(_x("cudaLaunchKernel", 100, t + 1, 5.0, "cuda_runtime",
                     correlation=i + 1))
        ev.append(_x(name, 0, t + 10, dur, cat, tid=7, correlation=i + 1))
        t += 50
    ev.append(_x("row:x", 0, 0, 200.0, "gpu_user_annotation", tid=7))
    return ev


def test_kineto_device_categories_count_as_device():
    ev = _kineto_trace()
    rows, pids = ts.summarize(ev)
    assert pids == {0}
    assert rows == [("gemm_kernel", 61.0, 2, True),
                    ("Memcpy DtoD (Device -> Device)", 4.0, 1, True),
                    ("Memset (Device)", 2.0, 1, True)]
    rows_all, _ = ts.summarize(ev, device_only=False)
    assert {r[0] for r in rows_all if not r[3]} == {
        "aten::op", "cudaLaunchKernel", "row:x"}
    # the JAX script finds no device process and counts the host's
    # launches and ops as device time: the departure the port makes
    jrows, jpids = _jax_script().summarize(ev)
    assert jpids == set() and "cudaLaunchKernel" in {r[0] for r in jrows}


def _eager_and_replays(steps=2, rename=None, drop=False):
    """An eager run (host ranges and launches, device activities linked by
    correlation) and `steps` replays of its activities. Row "a" launches
    k1 and k2 and, inside a nested ARC range, k3; an outermost ARC range
    launches k4; a device-to-device copy is launched outside every range
    (a graph may run it as CUDA's own memcpy kernel: replay 0 does)."""
    host, dev = 1, 0
    copy = "Memcpy DtoD (Device -> Device)"
    ev = [_x("row:a", host, 0, 100, "user_annotation"),
          _x("row:arc_residual", host, 50, 40, "user_annotation"),
          _x("row:arc_residual", host, 120, 20, "user_annotation"),
          _x("row:sample", host, 150, 5, "user_annotation"),
          _x("aten::copy_", host, 200, 10, "cpu_op")]
    for corr, (t, name) in enumerate(((10, "k1"), (30, "k2"), (60, "k3"),
                                      (125, "k4"), (202, copy)), 1):
        ev.append(_x("cudaLaunchKernel", host, t, 2, "cuda_runtime",
                     correlation=corr))
        ev.append(_x(name, dev, 1000 + t, 1.0, "gpu_memcpy" if name == copy
                     else "kernel", tid=7, correlation=corr))
    durs = {"k1": 3.0, "k2": 5.0, "k3": 7.0, "k4": 11.0, copy: 13.0}
    rep, t = [], 5000.0
    for s in range(steps):
        for name in durs:
            if drop and s == steps - 1 and name == copy:
                continue
            got, cat = name, "kernel"
            if name == copy:
                got, cat = ("memcpy32_post", "kernel") if s == 0 else (
                    copy, "gpu_memcpy")
            if rename and s == 1 and name == "k3":
                got = rename
            rep.append(_x(got, dev, t, durs[name] * (s + 1), cat, tid=7))
            t += durs[name] * (s + 1) + 1.0
    rep.append(_x("cudaGraphLaunch", host, 4990, 3, "cuda_runtime",
                  correlation=99))
    return ev, rep


def test_graph_map_sums_and_nests_the_arc_residual():
    ev, rep = _eager_and_replays(steps=2)
    m = ts.graph_map(ev, rep, 2)
    rows = m["rows"]
    assert set(rows) == {"a", "arc_residual", "sample"}
    # step means of (d, 2d): 1.5 x the first step's durations, in ms
    assert rows["a"]["calls"] == 1
    assert rows["a"]["ms_step"] == pytest.approx(1.5 * 15.0 / 1e3)
    assert rows["a"]["arc_ms_step"] == pytest.approx(1.5 * 7.0 / 1e3)
    assert rows["arc_residual"]["calls"] == 1
    assert rows["arc_residual"]["ms_step"] == pytest.approx(1.5 * 11 / 1e3)
    assert rows["sample"] == dict(calls=1, ms_step=0.0, ms_call=0.0,
                                  arc_ms_step=0.0)
    u = m["unlabelled"]
    assert u["ms_step"] == pytest.approx(1.5 * 13.0 / 1e3)
    assert u["top"] == [("Memcpy DtoD (Device -> Device)",
                         pytest.approx(13.0 / 1e3), 0.5),
                        ("memcpy32_post", pytest.approx(0.5 * 13.0 / 1e3),
                         0.5)]
    total = sum(r["ms_step"] for r in rows.values()) + u["ms_step"]
    assert total == pytest.approx(m["total_ms_step"])
    assert m["total_ms_step"] == pytest.approx(1.5 * 39.0 / 1e3)
    assert m["arc_ms_step"] == pytest.approx(1.5 * 18.0 / 1e3)
    assert m["activities_step"] == 5 and m["steps"] == 2
    assert {n for n, _, _ in m["kernels"]} == {
        "k1", "k2", "k3", "k4", "memcpy32_post",
        "Memcpy DtoD (Device -> Device)"}
    assert m["kernels"][0] == ("k4", pytest.approx(1.5 * 11.0 / 1e3), 1.0)
    assert sum(ms for _, ms, _ in m["kernels"]) == pytest.approx(
        m["total_ms_step"])
    # one us between activities: 10 gaps over the two steps
    assert m["gap_ms_step"] == pytest.approx(9 * 1.0 / 1e3 / 2)
    assert m["span_ms_step"] == pytest.approx(
        m["busy_ms_step"] + m["gap_ms_step"])
    # the eager run alone, by correlation
    e = ts.eager_map(ev)
    assert e["rows"]["a"]["ms_step"] == pytest.approx(3.0 / 1e3)
    assert e["unlabelled"]["ms_step"] == pytest.approx(1.0 / 1e3)


def test_graph_map_raises_on_a_count_or_name_mismatch():
    ev, rep = _eager_and_replays(steps=2, drop=True)
    with pytest.raises(ts.MapError, match="9 device activities over 2"):
        ts.graph_map(ev, rep, 2)
    ev, rep = _eager_and_replays(steps=2)
    with pytest.raises(ts.MapError, match="10 device activities over 3"):
        ts.graph_map(ev, rep, 3)
    ev, rep = _eager_and_replays(steps=2, rename="k3_other")
    with pytest.raises(ts.MapError, match="replay 1, activity 2"):
        ts.graph_map(ev, rep, 2)
    # a copy holds a copy's place, not a kernel's or a fill's
    ev, rep = _eager_and_replays(steps=2)
    for i, (name, cat) in enumerate((("memset32_post", "kernel"),
                                     ("k5", "kernel"))):
        rep[4]["name"], rep[4]["cat"] = name, cat
        with pytest.raises(ts.MapError, match="replay 0, activity 4"):
            ts.graph_map(ev, rep, 2)
    with pytest.raises(ts.MapError, match="0 in the eager body"):
        ts.graph_map([], rep, 2)


def test_graph_map_tells_a_profiler_loss():
    """profiled()'s warm-up (device work launched before the measured
    range) is left out of the tables and the map; a launch inside the
    range without its device record, or replays of one graph (grouped by
    their launch's correlation id) holding different counts, is a
    ProfilerLoss (map_graph profiles again), not a mismatch of the
    graph."""
    ev, rep = _eager_and_replays(steps=2)
    ev += [_x(ts.MEASURED, 1, 0, 300, "user_annotation"),
           _x("cudaLaunchKernel", 1, -50, 2, "cuda_runtime", correlation=77),
           _x("warm", 0, 900, 1.0, "kernel", tid=7, correlation=77)]
    assert [a["name"] for a in ts.device_activities(ev)][:4] == [
        "k1", "k2", "k3", "k4"]
    assert "warm" not in {r[0] for r in ts.summarize(ev)[0]}
    assert ts.graph_map(ev, rep, 2)["activities_step"] == 5
    lost = [e for e in ev if not (ts.is_device(e) and e["name"] == "k2")]
    with pytest.raises(ts.ProfilerLoss, match="without a device record: "
                       "{'cudaLaunchKernel': 1}"):
        ts.graph_map(lost, rep, 2)
    for i, a in enumerate(rep[:10]):
        a.setdefault("args", {})["correlation"] = 500 + i // 5
    assert ts.graph_map(ev, rep, 2)["activities_step"] == 5
    short = rep[:9] + [_x("k1", 0, 9000, 1.0, "kernel", tid=7,
                          correlation=500)]
    with pytest.raises(ts.ProfilerLoss, match=r"\[4, 6\] device records"):
        ts.graph_map(ev, short, 2)
    # equal groups of another size are the graph's own mismatch
    with pytest.raises(ts.MapError, match="against 5") as err:
        ts.graph_map(ev, rep[:4] + rep[5:9], 2)
    assert not isinstance(err.value, ts.ProfilerLoss)


def test_check_calls():
    ev, rep = _eager_and_replays()
    m = ts.graph_map(ev, rep, 2)
    ts.check_calls(m, {"a": 1, "arc_residual": 1, "sample": 1})
    with pytest.raises(ts.MapError, match="engine_calls"):
        ts.check_calls(m, {"a": 2, "arc_residual": 1, "sample": 1})


@pytest.fixture(scope="module")
def tiny():
    cfg = get_model_config("test-tiny")
    ecfg = EngineConfig(max_batch=4, max_seq_len=64, page_size=16)
    out = {}
    for frac in (0.0, 0.125):
        calib = quantized.identity_calib(cfg, select_frac=frac)
        out[frac] = InferenceEngine.dummy(cfg, calib, QCFG, ecfg,
                                          device="cpu")
    return cfg, out


def _prefilled(eng, t=16):
    toks = np.random.default_rng(0).integers(0, eng.cfg.vocab_size, (4, t))
    _, state = eng.prefill(eng.new_state(), toks, np.full((4,), t, np.int32))
    return state, toks


def _ranges(events, name):
    return sum(e.get("cat") == "user_annotation" and e["name"] == name
               for e in events)


@pytest.mark.parametrize("what,frac", [("decode", 0.0), ("decode", 0.125),
                                       ("prefill", 0.125), ("verify", 0.0)])
def test_ranges_equal_engine_calls_on_the_cpu(tiny, what, frac):
    """The body runs under the CPU profiler with the ranges, then again
    under engine_calls alone: each row's outermost ranges equal the
    calls (on the CPU no device activity exists: the graph body is run
    eagerly, as on the card before its capture)."""
    cfg, engines = tiny
    eng = engines[frac]
    state, toks = _prefilled(eng)
    level = "layers" if what == "verify" else "ops"
    if what == "decode":
        g = eng._decode_graph(state, None)
        g.io.active.fill_(True)
        assert g.graph is None

        def body():
            g.run(state)
    elif what == "verify":
        g = eng._verify_graph(state, 4)
        g.io.valid.fill_(4)

        def body():
            g.run(state)
    else:
        def body():
            eng.prefill(eng.new_state(), toks, np.full((4,), 16, np.int32))
    events, counts = ts.profile_calls(eng, body, level)
    _, labels, calls = ts.label_activities(events)
    assert labels == []
    with common.engine_calls(eng, level) as again:
        body()
    assert dict(calls) == counts == dict(again)
    if what == "verify":
        assert counts["attn_common"] == counts["mlp"] == cfg.num_layers
        assert counts["paged_prefill"] == counts["rope_append_kv"] == \
            cfg.num_layers
        assert counts["head"] == counts["rms_norm"] == 1
        return
    nested = _ranges(events, common.RANGE + common.ARC_RESIDUAL)
    if frac == 0.0:
        assert counts["mlp_w8_fused"] == cfg.num_layers and nested == 0
    elif what == "decode":
        # test-tiny at 0.125: only down_in has ARC columns, and its
        # residual (#18, the silu_mul recompute of its columns inside)
        # runs beside gateup_silu_quantize, outermost
        assert counts["gateup_silu_quantize"] == cfg.num_layers
        assert counts["arc_residual"] == nested == cfg.num_layers
        assert "silu_mul" not in counts
    else:
        # the prefill's silu_mul_quantize_gu nests it
        assert counts["silu_mul_quantize_gu"] == cfg.num_layers
        assert "arc_residual" not in counts and nested == cfg.num_layers


@pytest.mark.parametrize("w", [2, 4])
def test_verify_plan_is_pinned_to_the_verify_step(tiny, w):
    cfg, engines = tiny
    eng = engines[0.0]
    state, _ = _prefilled(eng)
    rows = verify_lab.plan(eng, w, state)
    for r in rows:
        r.fn()
    tokens = torch.ones((4, w), dtype=torch.int32)
    with common.engine_calls(eng, "layers") as counts:
        eng._verify_logits(state, tokens, torch.full((4,), w,
                                                     dtype=torch.int32))
    assert common.pin(rows, "verify", counts) == []
    assert counts["o_proj"] == cfg.num_layers


def test_decode_profile_prints_a_graph_map_beside_its_rows(tiny, capsys):
    """run(..., graph=m) with a stand-in timer: each row's isolated
    median x calls beside the map's ms a step for its key; keys no row
    has and the unlabelled bucket after them."""
    cfg = tiny[0]
    rows = decode_profile.plan(cfg, 4, "cpu")
    m = dict(way="fused", rows={
        "mlp_w8_fused": dict(calls=2, ms_step=0.5, ms_call=0.25,
                             arc_ms_step=0.0),
        "extra": dict(calls=1, ms_step=0.1, ms_call=0.1, arc_ms_step=0.0)},
        unlabelled=dict(ms_step=0.2), total_ms_step=0.8, busy_ms_step=0.8,
        span_ms_step=0.9, step_ms=1.0)

    def timer(fn):
        fn()
        return common.Timing(0.01, 0.01, 0.01)

    out = decode_profile.run(cfg, 4, timer, rows, graph=m)
    assert out["graph"] is m
    lines = capsys.readouterr().out.splitlines()
    # the budget's lines come first, then beside()'s
    mlp = [s for s in lines if s.startswith("fused mlp")][-1]
    assert mlp.split()[-4:] == ["0.0200", "0.5000", "2", "250.00"]
    gemm = [s for s in lines if s.startswith("gemm qkv ")][-1]
    assert gemm.split()[-4:] == ["0.0000", "0.0000", "0", "0.00"]
    assert any(s.startswith("(no row) extra") for s in lines)
    assert any(s.startswith("unlabelled (glue)") for s in lines)


@pytest.mark.parametrize("main", [prefill_trace.main, verify_lab.main,
                                  decode_profile.main])
def test_tool_mains_raise_without_cuda(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


def test_map_graph_needs_the_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, engines = tiny
    eng = engines[0.0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.map_graph(eng, None, None)
