"""The port's benchmark tools on the CPU, against the JAX package where
it has the function:

- benchmarks/mse_table.py's table() against the same rows computed by
  the JAX package's numerics (int4_group_qdq, quantize_tensor_qdq,
  arc_linear_fake) on the same x and w, within 1e-5 relative;
- bench_serving.run(--cpu) at test-tiny, 1 layer, offline and at an
  arrival rate: the JSON keys are the JAX script's (read from its
  source) plus device, every request finishes, and pct is the JAX
  script's;
- the two component profiles' plans at test-tiny: every row runs, and
  each row's multiplicity equals the calls that one eager step of the
  engine it attributes makes to the row's function (common.engine_calls):
  decode_profile against one select-free decode step at bs 4, fused
  (the megakernels engage at M 4 on the CPU too) and unfused;
  prefill_profile against one one-shot prefill (B 2, T 16) of the
  select-free NVFP4 engine and of the BF16 engine, per layer; and both
  profiles' run() with a stand-in timer: the totals and the noise mark.
"""

import ast
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.quant import arc as jarc
from arcquant_tpu.quant import numerics as JN
from arcquant_tpu_torch.benchmarks import bench_serving, common
from arcquant_tpu_torch.benchmarks import decode_profile, mse_table
from arcquant_tpu_torch.benchmarks import prefill_profile
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.models import quantized

JAX_SCRIPT = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "bench_serving.py"


def _jax_rows(x, w, ks):
    """The JAX script's rows (benchmarks/mse_table.py main) on x, w."""
    x, w = jnp.asarray(x), jnp.asarray(w)
    k = x.shape[1]
    ridx = jnp.arange(k, dtype=jnp.int32)
    y_true = x @ w.T

    def mse(y):
        return float(jnp.mean((y - y_true) ** 2))

    def int8_qdq(t):
        s = jnp.max(jnp.abs(t)) / 127.0
        return jnp.round(t / s).clip(-127, 127) * s

    q = JN.quantize_tensor_qdq
    rows = [mse(y_true), mse(int8_qdq(x) @ int8_qdq(w).T),
            mse(JN.int4_group_qdq(x) @ JN.int4_group_qdq(w).T),
            mse(x @ q(w, "NVFP4").T),
            mse(q(x, "NVFP4") @ q(w, "NVFP4").T)]
    return rows + [mse(jarc.arc_linear_fake(x, w, ridx, ke)) for ke in ks]


def test_mse_table_matches_jax():
    ks = [0, 16, 64]
    x, w, ridx = mse_table.inputs(16, 64, 256)
    rows = mse_table.table(x, w, ridx, ks + [512])    # 512 > K: left out
    assert [r[0] for r in rows] == [
        "fp32", "int8 (w8a8 per-tensor)", "int4 (w4a4 group128)",
        "w4a16 (nvfp4 weights)", "nvfp4 w4a4", "nvfp4+arc k=0",
        "nvfp4+arc k=16", "nvfp4+arc k=64"]
    want = _jax_rows(x.numpy(), w.numpy(), ks)
    assert rows[0][1] == 0.0 == want[0]
    np.testing.assert_allclose([v for _, v in rows[1:]], want[1:], rtol=1e-5)
    # the outlier tail: ARC's largest k beats plain NVFP4
    assert rows[-1][1] < rows[4][1]


def test_mse_table_main_prints_the_rows(capsys):
    mse_table.main(["--m", "8", "--n", "16", "--k", "128", "--ks", "0",
                    "64", "--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# M=8 N=16 K=128") and len(out) == 8
    assert out[-1].split()[0] == "nvfp4+arc"


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_bench_serving",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_keys() -> set:
    """The keys of the JAX script's JSON line, from its source: the
    `result = {...}` literal and every result["..."] assignment."""
    keys = set()
    for node in ast.walk(ast.parse(JAX_SCRIPT.read_text())):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if (isinstance(t, ast.Name) and t.id == "result"
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys}
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id == "result"):
                keys.add(t.slice.value)
    return keys


@pytest.mark.parametrize("rate,spec", [(0.0, 0), (50.0, 0), (0.0, 2)])
def test_bench_serving_runs_on_the_cpu(rate, spec):
    args = bench_serving.build_parser().parse_args(
        ["--model", "test-tiny", "--layers", "1", "--max_batch", "2",
         "--requests", "4", "--prompt_len", "16", "--max_new", "4",
         "--arrival_rate", str(rate), "--spec_window", str(spec), "--cpu"])
    r = bench_serving.run(args)
    out = bench_serving.public(r)
    keys = _jax_keys()
    assert "spec" in keys and "ttft_p95_s" in keys
    assert set(out) == (keys if spec else keys - {"spec"}) | {"device"}
    assert out["device"] == {"name": "cpu", "power_limit": None}
    assert out["layers"] == 1 and out["arrival_rate"] == rate
    for req in r["_requests"]:
        assert req.done and req.error is None and len(req.output) == 4
        assert req.t_first - req.t_submit <= req.t_done - req.t_submit
    assert out["ttft_p50_s"] <= out["ttft_p95_s"]
    assert out["latency_p50_s"] <= out["latency_p95_s"]
    json.dumps(out)


def test_pct_is_the_jax_scripts():
    jpct = _jax_script().pct
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 16, 33):
        xs = rng.random(n).tolist()
        for p in (0, 50, 95, 99, 100):
            assert bench_serving.pct(xs, p) == jpct(xs, p)


QCFG = QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
                   act_scale="row", w_scale="channel", quantize_lm_head=True)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_model_config("test-tiny")
    calib = quantized.identity_calib(cfg, select_frac=0.0)
    eng = InferenceEngine.dummy(cfg, calib, QCFG, EngineConfig(
        max_batch=4, max_seq_len=64, page_size=16), device="cpu",
        cuda_graphs=False)
    return cfg, calib, eng


@pytest.mark.parametrize("way", decode_profile.WAYS)
def test_decode_plan_is_pinned_to_the_step(tiny, way):
    cfg, calib, fused = tiny
    eng = fused if way == "fused" else InferenceEngine(
        cfg, fused.qparams, calib, QCFG, fused.ecfg, device="cpu",
        quantize_params=False, fused_decode=False, cuda_graphs=False)
    rows = decode_profile.plan(cfg, 4, "cpu")
    for r in rows:
        r.fn()
    state = eng.new_state()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    _, state = eng.prefill(state, toks, np.full((4,), 16, np.int32))
    with common.engine_calls(eng) as counts:
        eng.decode_scan(state, torch.ones(4, dtype=torch.int32),
                        torch.ones(4, dtype=torch.bool), 1)
    assert common.pin(rows, way, counts) == []
    assert counts["sample"] == 1 and counts["paged_decode"] == cfg.num_layers
    assert counts["mlp_w8_fused" if way == "fused"
                  else "silu_mul_quantize_gu"] == cfg.num_layers


@pytest.mark.parametrize("way", prefill_profile.WAYS)
def test_prefill_plan_is_pinned_to_the_prefill(tiny, way):
    cfg, calib, fused = tiny
    ecfg = EngineConfig(max_batch=2, max_seq_len=64, page_size=16)
    if way == "quant":
        eng = InferenceEngine(cfg, fused.qparams, calib, QCFG, ecfg,
                              device="cpu", quantize_params=False,
                              cuda_graphs=False)
    else:
        eng = InferenceEngine.dummy(cfg, calib, QuantConfig(quant_type="BF16"),
                                    ecfg, device="cpu", cuda_graphs=False)
    rows = prefill_profile.plan(cfg, 2, 16, "cpu")
    for r in rows:
        r.fn()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    per_layer = prefill_profile.layer_calls(eng, lambda: eng.prefill(
        eng.new_state(), toks, np.full((2,), 16, np.int32)))
    assert common.pin(rows, way, per_layer) == []
    assert per_layer["flash_attention"] == 1


def test_profiles_budget_sums_every_row_and_marks_noise(tiny, capsys):
    """run() of both profiles with a stand-in timer (the card's Timer
    needs CUDA): each way's total is the sum of median x multiplicity
    (lo and hi alike, the prefill's x num_layers), every row is printed,
    and a row whose hi - lo exceeds half its median is marked noisy."""
    cfg = tiny[0]
    spans = iter(range(1, 1000))

    def timer(fn):
        fn()
        i = next(spans)
        return common.Timing(float(i), i - 0.25, i + (1.0 if i % 3 else 0.0))

    d = decode_profile.run(cfg, 4, timer, decode_profile.plan(cfg, 4, "cpu"))
    p = prefill_profile.run(cfg, 2, 16, timer,
                            prefill_profile.plan(cfg, 2, 16, "cpu"))
    out = capsys.readouterr().out.splitlines()
    for res, scale in ((d, 1), (p, cfg.num_layers)):
        for way, (med, lo, hi) in res["totals"].items():
            for got, field in ((med, "median"), (lo, "lo"), (hi, "hi")):
                want = scale * sum(getattr(res["times"][r.name], field)
                                   * r.mults[way] for r in res["rows"])
                assert got == pytest.approx(want), (way, field)
        for r in res["rows"]:
            t = res["times"][r.name]
            line = next(s for s in out if s.startswith(r.name + " "))
            assert line.endswith("noisy") == (t.hi - t.lo > 0.5 * t.median)
