"""Data parallelism of arcquant_tpu_torch's TP engine (a dp 2 x tp 2 mesh,
parallel/mesh.py make_mesh, parallel/tp_engine.py) and the batcher's page
groups (engine/scheduler.py), held against the JAX package's dp x tp
engine and against the port's single-device engine.

Four gloo ranks on the CPU (parallel.launch, the worker dp_engine_run of
arcquant_tpu_torch/testing.py, which imports no JAX) run, in one spawn:
every step of the dp 2 x tp 2 engine, decode steps against decode_scan,
the collectives of a decode step, a sampled decode_scan, the batcher over
dynamic pages with chunked prefill and a page pool a dp group, the
replicated fallback (max_batch 3) and the dp 1 engine over the same tp
group. The JAX references run here on 4 devices of tests/conftest.py's
CPU mesh, their Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu.parallel import make_mesh as jmake_mesh
from arcquant_tpu.parallel.tp_engine import TPInferenceEngine as JTPEngine
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import (ContinuousBatcher, EngineConfig,
                                       InferenceEngine, Request)
from arcquant_tpu_torch.parallel import launch
from arcquant_tpu_torch.testing import (DP_EKW, TP_QKW, _steps, calib_arrays,
                                        cosine, tp_tasks)

NAME = "test-tiny"
# four rows, two a dp group, ragged
TOKS = np.asarray([[5, 17, 301, 42], [100, 200, 0, 0], [9, 8, 7, 6],
                   [1, 2, 3, 0]], np.int64)
LENS = np.asarray([4, 2, 4, 3], np.int32)
# the batcher's prompts (JAX's test_tp_engine_dynamic_pages_chunked_
# prefill_batcher) and then six 28-token prompts that chunk (16)
PROMPTS = [[5, 17, 301, 42], [100, 200, 33], [7, 8], [1, 2, 3]]
MORE = [list(range(1, 29))] * 6
STEPS = ("prefill", "decode1", "decode2", "decode3")


def _jax_run(cfg, params, calib):
    """The JAX dp 2 x tp 2 engine's logits of every step fed its greedy
    tokens, and its static generate of PROMPTS."""
    mesh = jmake_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    eng = JTPEngine(cfg, params, calib, JQuantConfig(**TP_QKW),
                    JEngineConfig(**DP_EKW), mesh)
    logits, state = eng.prefill(eng.new_state(), jnp.asarray(TOKS),
                                jnp.asarray(LENS))
    out, fed = {"prefill": np.asarray(logits)}, []
    act = jnp.asarray(LENS > 0)
    for i in range(3):
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(cur))
        logits, state = eng.decode_step(state, cur, act)
        out[f"decode{i + 1}"] = np.asarray(logits)
    return dict(logits=out, fed=fed, dp=eng.dp, page_groups=eng.page_groups(),
                generate=eng.generate([list(p) for p in PROMPTS], 4))


@pytest.fixture(scope="module")
def runs():
    cfg = jax_model_config(NAME)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    calib = jquantized.identity_calib(cfg, 0.0)
    ref = _jax_run(cfg, params, calib)
    params = jax.tree.map(np.asarray, params)
    task = ("dp_engine_run", (NAME, params, calib_arrays(calib), TOKS, LENS,
                              ref["fed"], PROMPTS, MORE))
    ranks = [r[0] for r in launch(tp_tasks, 4, "gloo", cpu=True,
                                  args=([task],))]
    return dict(ref=ref, params=params, calib=calib, ranks=ranks)


def _single(runs, ecfg):
    return InferenceEngine(get_model_config(NAME),
                           convert.params_from_numpy(runs["params"]),
                           convert.calib_from_numpy(runs["calib"]),
                           QuantConfig(**TP_QKW), ecfg, device="cpu")


def test_dp_tp_engine_matches_jax_and_single_device(runs):
    """Every step of the dp 2 x tp 2 engine (each dp group's two rows, the
    logits gathered) against the JAX dp x tp engine's and the port's
    single-device engine fed the same tokens: cosine >= 0.999 and equal
    greedy tokens; the four ranks' logits bitwise equal (JAX's
    test_dp_tp_engine_scan_matches_single_device)."""
    ref = runs["ref"]
    want = _steps(_single(runs, EngineConfig(**DP_EKW)), TOKS, LENS,
                  ref["fed"])
    r0 = runs["ranks"][0]
    assert r0["dp"] == ref["dp"] == 2
    for step in STEPS:
        for other in (ref["logits"][step], want[step]):
            assert cosine(r0[step], other) >= 0.999, step
            np.testing.assert_array_equal(r0[step].argmax(-1),
                                          other.argmax(-1), err_msg=step)
        for r in runs["ranks"][1:]:
            np.testing.assert_array_equal(r[step], r0[step], err_msg=step)


def test_dp_decode_scan_equals_decode_steps(runs):
    """decode_scan's greedy tokens equal 4 decode steps' from the same
    prefill, exactly; the prefill repeats bit for bit; a sampled scan
    repeats from its seed and agrees on every rank."""
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["scan"], r["step_toks"])
        np.testing.assert_array_equal(r["prefill_again"], r["prefill"])
        np.testing.assert_array_equal(*r["sampled"])
        np.testing.assert_array_equal(r["sampled"][0],
                                      runs["ranks"][0]["sampled"][0])


def test_dp_sampling_one_generator_a_group(runs):
    """At dp 2 the engine's draws (generate's and decode_scan's alike) take
    dp group g's rows from a generator seeded with mix_seed(seed, g), as
    JAX folds the dp index into its key; a sampled generate repeats from
    its seed and agrees on every rank."""
    r0 = runs["ranks"][0]
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["group_draws"],
                                      r["group_draws_want"])
        assert r["sampled_generate"][0] == r["sampled_generate"][1]
        assert r["sampled_generate"][0] == r0["sampled_generate"][0]


def test_dp_decode_collectives(runs):
    """A decode step makes TP's 2 SUM and 2 MAX all_reduces a layer within
    the tp group and one all_gather over the dp group (the logits), on
    every rank; the step record counts the same."""
    layers = get_model_config(NAME).num_layers
    for r in runs["ranks"]:
        assert r["collectives"] == {"all_reduce:sum": 2 * layers,
                                    "all_reduce:max": 2 * layers,
                                    "all_gather": 1}
        assert r["comm"] == {"sum": 2 * layers, "max": 2 * layers,
                             "all_gather": 1}


def test_dp_page_groups_on_both_engines(runs):
    """page_groups(): (2, B/dp * pps + 1, B/dp) on the dp 2 engine, static
    and dynamic (JAX's values), and (1, total_pages, max_batch) on the
    single-device engine."""
    r0 = runs["ranks"][0]
    e = EngineConfig(**DP_EKW)
    assert r0["page_groups"] == tuple(runs["ref"]["page_groups"])
    assert r0["page_groups"] == (2, 2 * e.pages_per_seq + 1, 2)
    assert r0["dyn_page_groups"] == (2, 2 * e.pages_per_seq + 1, 2)
    assert _single(runs, e).page_groups() == (1, e.total_pages(),
                                              e.max_batch)


def test_dp_batcher_page_groups_chunked_prefill(runs):
    """The batcher over the dp 2 engine with dynamic pages and chunked
    prefill: one allocator a dp group, every slot's pages from its own
    group's pool at every step; the short prompts' tokens equal the
    static engine's generate and the JAX dp x tp engine's; the long
    prompts (two chunks) with more requests than slots all finish; the
    pools are free after (JAX's test_tp_engine_dynamic_pages_chunked_
    prefill_batcher)."""
    r0 = runs["ranks"][0]
    assert r0["n_allocs"] == 2 and r0["one_group_alloc"]
    assert r0["groups_ok"] and r0["freed"]
    assert [o for _, o in r0["batch"]] == r0["want"]
    assert r0["want"] == runs["ref"]["generate"]
    assert all(err is None for err, _ in r0["batch"] + r0["more"])
    assert all(len(o) == 3 for _, o in r0["more"])
    for r in runs["ranks"][1:]:
        assert r["batch"] == r0["batch"] and r["more"] == r0["more"]


def test_dp_replicated_fallback(runs):
    """dp 2 that does not divide max_batch 3 falls back to every dp group
    serving the whole batch (dp 1 in the engine): its logits are the dp 1
    engine's rows, within the 0.999 bar, and each step gathers nothing."""
    r0 = runs["ranks"][0]
    assert r0["replicated_dp"] == 1
    for step in STEPS[:-1]:
        assert cosine(r0["replicated"][step],
                      r0["dp1"][step][:3]) >= 0.999, step


def test_single_device_batcher_one_group(runs):
    """On the single-device engine the batcher keeps one allocator (the
    `alloc` property), and its outputs equal the engine's own generate
    with dynamic pages."""
    e = EngineConfig(dynamic_pages=True, **DP_EKW)
    eng = _single(runs, e)
    bt = ContinuousBatcher(eng)
    assert bt.allocs is not None and len(bt.allocs) == 1
    assert bt.alloc is bt.allocs[0]
    reqs = [Request(prompt=list(p), max_new_tokens=4) for p in PROMPTS]
    for r in reqs:
        bt.submit(r)
    bt.run()
    assert [r.output for r in reqs] == eng.generate(
        [list(p) for p in PROMPTS], 4)
    assert bt.alloc.available() == bt.alloc.capacity
