"""Expert parallelism of arcquant_tpu_torch (parallel/ep.py, and MoE
layers under the TP engine) held against the JAX package's.

Gloo ranks on the CPU (parallel.launch, workers in
arcquant_tpu_torch/testing.py that import no JAX), one spawn a group
size: two ranks run the block at (dp 1, ep 2) and the MoE TP engine at
row and tensor activation scales; four ranks the block at (1, 4) in bf16,
in dispatch mode and quantized, with its collectives; eight ranks the
block at (2, 4). The JAX references run here on tests/conftest.py's
8-device CPU mesh, their Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import moe as jmoe
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu.parallel import ep as jep
from arcquant_tpu.parallel import make_mesh as jmake_mesh
from arcquant_tpu.parallel.tp_engine import TPInferenceEngine as JTPEngine
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig
from arcquant_tpu_torch.models import moe, quantized
from arcquant_tpu_torch.parallel import launch
from arcquant_tpu_torch.testing import (TP_EKW, TP_QKW, _steps, calib_arrays,
                                        cosine, qdq_moe_engine, to_numpy,
                                        to_torch, tp_tasks)

NAME = "test-tiny-moe"
# (dp, ep): JAX's test_ep_matches_single_device_bf16 cases
BF16_CASES = [(1, 2), (1, 4), (2, 4)]
SCALES = ("row", "tensor")
# A dispatch capacity under the 16 tokens' 32 assignments over 4 experts:
# some tokens drop, on one device and on the ep ranks alike.
TIGHT = 8
TOKS = np.asarray([[5, 17, 301, 42], [100, 200, 0, 0]], np.int64)
LENS = np.asarray([4, 2], np.int32)
STEPS = ("prefill", "decode1", "decode2", "decode3")


def _jmesh(dp, epn):
    devs = np.array(jax.devices()[:dp * epn]).reshape(dp, epn)
    return Mesh(devs, ("dp", "ep"))


def _jax_block(cfg, p, x, dp, epn, capacity=None, calib=None, qcfg=None):
    """JAX's EP block and its single-device moe_block on x."""
    ref = jmoe.moe_block(cfg, p, x, calib, qcfg, capacity=capacity)
    mesh = _jmesh(dp, epn)
    out = jep.make_ep_moe_forward(cfg, mesh, layer_calib=calib, qcfg=qcfg,
                                  capacity=capacity)(
        jep.shard_moe_params(p, mesh), x)
    return np.asarray(out, np.float32), np.asarray(ref, np.float32)


def _jax_engine(cfg, params, scale):
    """The JAX MoE TP engine (tp 2) at `scale`: every step's logits fed
    its greedy tokens."""
    mesh = jmake_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    eng = JTPEngine(cfg, params, jquantized.identity_calib(cfg, 0.0),
                    JQuantConfig(**dict(TP_QKW, act_scale=scale)),
                    JEngineConfig(**TP_EKW), mesh)
    logits, state = eng.prefill(eng.new_state(), jnp.asarray(TOKS),
                                jnp.asarray(LENS))
    out, fed = {"prefill": np.asarray(logits)}, []
    act = jnp.asarray(LENS > 0)
    for i in range(3):
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(cur))
        logits, state = eng.decode_step(state, cur, act)
        out[f"decode{i + 1}"] = np.asarray(logits)
    return out, fed


@pytest.fixture(scope="module")
def runs():
    cfg = jax_model_config(NAME)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    p = params["layers"][0]["moe"]
    ref, cases = {}, {2: {}, 4: {}, 8: {}}
    for dp, epn in BF16_CASES:
        x = jax.random.normal(jax.random.PRNGKey(3), (2 * dp, 8,
                                                      cfg.hidden_size),
                              jnp.bfloat16)
        ref[("bf16", dp, epn)] = _jax_block(cfg, p, x, dp, epn)
        cases[dp * epn][("bf16", dp, epn)] = (dp, np.asarray(x), None, None,
                                              None)
    x = jax.random.normal(jax.random.PRNGKey(4), (2, 8, cfg.hidden_size),
                          jnp.bfloat16)
    old = jmoe.DENSE_MODE_MAX_T
    try:
        jmoe.DENSE_MODE_MAX_T = 0
        for key, cap in (("dispatch", 16), ("dispatch_cap", TIGHT)):
            ref[key] = _jax_block(cfg, p, x, 1, 4, capacity=cap)
            cases[4][key] = (1, np.asarray(x), cap, 0, None)
    finally:
        jmoe.DENSE_MODE_MAX_T = old
    ref["x_dispatch"] = np.asarray(x)
    calib = jquantized.identity_calib(cfg, select_frac=0.1)
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 8, cfg.hidden_size),
                          jnp.bfloat16)
    # the JAX block at row scales (JAX's case); at tensor scales the
    # port's single-device block, whose qdq stacks are JAX's bit for bit
    # (the JAX qdq block takes ~25 s to run here)
    qcfg = JQuantConfig(quant_type="NVFP4", use_kernels=False,
                        w_scale="channel", act_scale="row")
    qp = jquantized.quantize_layer_params(params["layers"][0], calib[0],
                                          qcfg)["moe"]
    ref[("quant", "row")] = _jax_block(cfg, qp, x, 1, 4, calib=calib[0],
                                       qcfg=qcfg)
    for scale in SCALES:
        cases[4][("quant", scale)] = (1, np.asarray(x), None,
                                      jmoe.DENSE_MODE_MAX_T, (0.1, scale))
    ref["x_quant"] = np.asarray(x)
    engines = {s: _jax_engine(cfg, params, s) for s in SCALES}
    params = jax.tree.map(np.asarray, params)
    calib0 = calib_arrays(jquantized.identity_calib(cfg, 0.0))
    got = {}
    for n, group in cases.items():
        for key, c in group.items():   # dense threshold: the JAX default
            if c[3] is None:
                group[key] = c[:3] + (jmoe.DENSE_MODE_MAX_T,) + c[4:]
        tasks = [("ep_block_run", (NAME, params, group))]
        if n == 2:
            tasks.append(("ep_engine_run", (NAME, params, calib0, TOKS, LENS,
                                            engines["row"][1], SCALES)))
        got[n] = launch(tp_tasks, n, "gloo", cpu=True, args=(tasks,))
    return dict(ref=ref, got=got, engines=engines, params=params,
                calib0=calib0)


def _block(runs, key, rank=0):
    n = {"dispatch": 4, "dispatch_cap": 4}.get(
        key, 4 if key[0] == "quant" else None)
    n = n or key[1] * key[2]
    return runs["got"][n][rank][0][key]


@pytest.mark.parametrize("dp,epn", BF16_CASES)
def test_ep_matches_jax_bf16(runs, dp, epn):
    """The bf16 block over (dp, ep) ranks against JAX's EP block and its
    single-device moe_block, at JAX's bar (5e-2), equal on every rank
    (JAX's test_ep_matches_single_device_bf16)."""
    key = ("bf16", dp, epn)
    want, single = runs["ref"][key]
    y0 = _block(runs, key)[0]
    for ref in (want, single):
        np.testing.assert_allclose(y0, ref, atol=5e-2, rtol=5e-2)
    for r in range(1, dp * epn):
        np.testing.assert_array_equal(_block(runs, key, r)[0], y0)


def test_ep_dispatch_mode_matches_jax(runs):
    """Dispatch mode on every ep rank (DENSE_MODE_MAX_T 0, capacity 16,
    the global capacity) against JAX's (test_ep_dispatch_mode_matches_
    single_device)."""
    want, single = runs["ref"]["dispatch"]
    y0 = _block(runs, "dispatch")[0]
    for ref in (want, single):
        np.testing.assert_allclose(y0, ref, atol=5e-2, rtol=5e-2)


def test_ep_dispatch_capacity_matches_single_device(runs):
    """At a capacity that drops tokens (8 slots an expert for 16 tokens'
    32 assignments), the ep ranks keep and drop the single device's
    tokens: the block equals the port's and JAX's single-device
    moe_block at the same capacity. A rank ranks only the nonzero-weight
    assignments of its experts; JAX's ep_moe_block also ranks the
    zero-weight ones a token fills its top-k with on a rank, so it drops
    tokens its own single device keeps (the second check pins that fault
    of the reference, ROADMAP queue 3)."""
    cfg = get_model_config(NAME)
    p = convert.params_from_numpy(runs["params"])["layers"][0]["moe"]
    old = moe.DENSE_MODE_MAX_T
    try:
        moe.DENSE_MODE_MAX_T = 0
        single = to_numpy(moe.moe_block(cfg, p,
                                        to_torch(runs["ref"]["x_dispatch"]),
                                        capacity=TIGHT))
    finally:
        moe.DENSE_MODE_MAX_T = old
    jax_ep, jax_single = runs["ref"]["dispatch_cap"]
    y0 = _block(runs, "dispatch_cap")[0]
    for ref in (single, jax_single):
        np.testing.assert_allclose(y0, ref, atol=5e-2, rtol=5e-2)
    assert np.abs(jax_ep - jax_single).max() > 0.5


@pytest.mark.parametrize("scale", SCALES)
def test_ep_quantized_matches_jax(runs, scale):
    """The block on qdq stacks (NVFP4, ARC 0.1, channel weight scales)
    against the port's single-device moe_block at 5e-2, and at row scales
    against JAX's EP block and single-device block (JAX's
    test_ep_quantized_matches_single_device); at tensor scales the ranks'
    down_in scale is the MAX over every rank's experts."""
    cfg = get_model_config(NAME)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=False,
                       w_scale="channel", act_scale=scale)
    calib = quantized.identity_calib(cfg, 0.1)[0]
    p = convert.params_from_numpy(runs["params"])["layers"][0]["moe"]
    single = moe.moe_block(cfg, moe.quantize_moe_params(p, calib, qcfg),
                           to_torch(runs["ref"]["x_quant"]), calib, qcfg)
    refs = [to_numpy(single)]
    if scale == "row":
        refs += list(runs["ref"][("quant", "row")])
    y0 = _block(runs, ("quant", scale))[0]
    for ref in refs:
        np.testing.assert_allclose(y0, ref, atol=5e-2, rtol=5e-2)


def test_ep_collective_bill(runs):
    """Exactly one all_reduce (the routed sum) a bf16 block, counted by
    wrapping torch.distributed (JAX's test_ep_collective_bill); a
    quantized block adds the down_in scale's MAX at tensor scales only."""
    assert _block(runs, ("bf16", 1, 4))[1] == {"all_reduce:sum": 1}
    assert _block(runs, ("quant", "row"))[1] == {"all_reduce:sum": 1}
    assert _block(runs, ("quant", "tensor"))[1] == {"all_reduce:sum": 1,
                                                    "all_reduce:max": 1}
    # (2, 4): the dp groups' rows gathered after the block
    assert _block(runs, ("bf16", 2, 4))[1] == {"all_reduce:sum": 1,
                                               "all_gather": 1}


@pytest.mark.parametrize("scale", SCALES)
def test_moe_tp_engine_matches_jax_and_single_device(runs, scale):
    """The MoE TP engine (qdq expert stacks sharded over tp 2, select 0)
    at row and tensor scales, fed the JAX TP engine's tokens at row
    scales: against the JAX MoE TP engine and the port's single-device
    engine on qdq stacks at JAX's bars, cosine > 0.99 at the prefill and
    > 0.95 at decode (test_moe.py's test_tp_engine_moe_parity: a routing
    flip on the random router moves the next layer); both ranks' logits
    bitwise equal; a decode step's all_reduces: o's SUM and MAX and the
    MoE block's SUM a layer, and its MAX at tensor scales."""
    cfg = get_model_config(NAME)
    fed = runs["engines"]["row"][1]
    qcfg = QuantConfig(**dict(TP_QKW, act_scale=scale))
    single = _steps(qdq_moe_engine(
        cfg, convert.params_from_numpy(runs["params"]),
        convert.calib_from_numpy([{s: jquantized.SiteCalib(r, n)
                                   for s, (r, n) in layer.items()}
                                  for layer in runs["calib0"]]),
        qcfg, EngineConfig(**TP_EKW)), TOKS, LENS, fed)
    g0, g1 = (runs["got"][2][r][1][scale] for r in (0, 1))
    refs = [single]
    if scale == "row":
        refs.append(runs["engines"]["row"][0])
    for step in STEPS:
        np.testing.assert_array_equal(g0[step], g1[step], err_msg=step)
        for ref in refs:
            bar = 0.99 if step == "prefill" else 0.95
            assert cosine(g0[step], ref[step]) > bar, step
    layers = cfg.num_layers
    assert g0["collectives"] == {
        "all_reduce:sum": 2 * layers,
        "all_reduce:max": layers * (1 if scale == "row" else 2)}
