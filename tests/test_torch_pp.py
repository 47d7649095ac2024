"""Pipeline parallelism of arcquant_tpu_torch (parallel/pp.py and
parallel/pp_engine.py) held against the JAX package's and against the
port's single-device engine.

Two gloo ranks on the CPU (parallel.launch, workers in
arcquant_tpu_torch/testing.py that import no JAX) run, in one spawn: the
GPipe forward at microbatches 2 and 4; the PP engine on test-tiny with a
non-uniform calibration (select 64 at one layer's mlp_in, bucketed to
every layer) through generate, every step's logits, decode_scan and the
collectives of a decode step; then at select 0 speculative decoding,
sampled decode_scan, the batcher per step, with spec_window and with
decode bursts, and the refusals; and the PP engine on test-tiny-moe
(packed experts). The JAX references run here on 2 devices of
tests/conftest.py's CPU mesh, their Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.engine import InferenceEngine as JInferenceEngine
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu.parallel.pp import pp_quant_model_forward as jpp_forward
from arcquant_tpu.parallel.pp import stack_stage_params as jstack
from arcquant_tpu.parallel.pp_engine import PPInferenceEngine as JPPEngine
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.models import llama, quantized
from arcquant_tpu_torch.parallel import (PPContext, bucket_calib_uniform,
                                         launch, stack_stage_params)
from arcquant_tpu_torch.testing import (TP_EKW, TP_QKW, _steps, calib_arrays,
                                        tp_tasks)

NAME = "test-tiny"
PROMPTS = [[5, 17, 301, 42, 8], [100, 200, 33]]
SPEC_PROMPTS = [[1, 2, 3, 4] * 5, [7, 8, 7, 8, 7, 8]]
MICRO = (2, 4)


def _jmesh():
    return Mesh(np.array(jax.devices()[:2]).reshape(2), ("pp",))


def _nonuniform(cfg):
    """JAX's test_pp_engine_decode_token_identical calibration: select 0
    but 64 at layer 1's mlp_in."""
    calib = jquantized.identity_calib(cfg, select_frac=0.0)
    calib[1]["mlp_in"] = jquantized.SiteCalib(
        calib[1]["mlp_in"].reorder_index, 64)
    return calib


def _forward_case(cfg, params):
    """JAX's test_pp_matches_single_device inputs and its PP logits."""
    qcfg = JQuantConfig(quant_type="NVFP4", use_kernels=False,
                        act_scale="row")
    calib = jquantized.identity_calib(cfg, select_frac=0.25)
    qparams = jquantized.quantize_model_params(cfg, params, calib, qcfg)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (4, 12))
    pparams = jstack(cfg, qparams, calib, 2, _jmesh())
    want = {m: np.asarray(jpp_forward(cfg, pparams, calib, qcfg, _jmesh(),
                                      jnp.asarray(tokens, jnp.int32),
                                      microbatches=m)) for m in MICRO}
    return calib, tokens, want


def _engine_case(cfg, params):
    """The JAX PP engine (TP_QKW, TP_EKW) on the non-uniform calibration:
    generate's tokens, the prefill's fed tokens for 3 decode steps, a
    verify's inputs and decode_scan's tokens; and the JAX single-device
    engine's generate on the bucketed calibration."""
    from arcquant_tpu.parallel.pp_engine import bucket_calib_uniform as jb
    calib = _nonuniform(cfg)
    qcfg, ecfg = JQuantConfig(**TP_QKW), JEngineConfig(**TP_EKW)
    eng = JPPEngine(cfg, params, calib, qcfg, ecfg, _jmesh())
    out = {"generate": eng.generate([list(p) for p in PROMPTS], 5)}
    out["single_generate"] = JInferenceEngine(
        cfg, params, jb(calib), qcfg, ecfg).generate(
            [list(p) for p in PROMPTS], 5)
    toks, lens, _ = eng._pad_prompts(PROMPTS)
    logits, state = eng.prefill(eng.new_state(), jnp.asarray(toks),
                                jnp.asarray(lens))
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    act = jnp.asarray(lens > 0)
    out["scan"] = np.asarray(eng.decode_scan(state, first, act, 4)[0])
    # the scan donated its state: the steps start from a new prefill
    _, state = eng.prefill(eng.new_state(), jnp.asarray(toks),
                           jnp.asarray(lens))
    fed, cur = [], first
    for _ in range(3):
        fed.append(np.asarray(cur))
        logits, state = eng.decode_step(state, cur, act)
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
    vt = np.stack([np.asarray(cur), [7, 5], [8, 0]], 1).astype(np.int32)
    vv = np.asarray([3, 2], np.int32)
    return dict(calib=calib, toks=toks, lens=lens, fed=fed, vt=vt, vv=vv,
                **out)


def _moe_case():
    """JAX's test_pp_engine_moe_token_identical on test-tiny-moe (select
    0, TP_QKW, TP_EKW): the PP engine's generate and the single-device
    engine's."""
    cfg = jax_model_config("test-tiny-moe")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    calib = jquantized.identity_calib(cfg, select_frac=0.0)
    qcfg, ecfg = JQuantConfig(**TP_QKW), JEngineConfig(**TP_EKW)
    prompts = [list(p) for p in PROMPTS]
    return dict(
        params=jax.tree.map(np.asarray, params), calib=calib,
        generate=JPPEngine(cfg, params, calib, qcfg, ecfg,
                           _jmesh()).generate(prompts, 5),
        single=JInferenceEngine(cfg, params, calib, qcfg,
                                ecfg).generate(prompts, 5))


@pytest.fixture(scope="module")
def runs():
    """The JAX references, then one spawn of two stages running every
    check of the port's PP forward and engine."""
    cfg = jax_model_config(NAME)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    fcalib, ftokens, fwant = _forward_case(cfg, params)
    eng = _engine_case(cfg, params)
    moe = _moe_case()
    params = jax.tree.map(np.asarray, params)
    tasks = [("pp_forward", (NAME, params, calib_arrays(fcalib), ftokens,
                             MICRO)),
             ("pp_engine_run", (NAME, params, calib_arrays(eng["calib"]),
                                PROMPTS, eng["toks"], eng["lens"],
                                eng["fed"], eng["vt"], eng["vv"],
                                SPEC_PROMPTS)),
             ("pp_moe_run", ("test-tiny-moe", moe["params"],
                             calib_arrays(moe["calib"]),
                             [list(p) for p in PROMPTS]))]
    ranks = launch(tp_tasks, 2, "gloo", cpu=True, args=(tasks,))
    return dict(params=params, fwant=fwant, eng=eng, moe=moe, ranks=ranks)


@pytest.mark.parametrize("microbatches", MICRO)
def test_pp_forward_matches_jax(runs, microbatches):
    """pp_quant_model_forward against the JAX package's PP forward (JAX's
    test_pp_matches_single_device): rtol/atol 1e-5 on both stages."""
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[0][microbatches],
                                   runs["fwant"][microbatches],
                                   rtol=1e-5, atol=1e-5)


def test_pp_rejects_nonuniform_select():
    """stack_stage_params refuses a non-uniform select count across
    layers (JAX's test_pp_rejects_nonuniform_select); it runs no
    collective, so a context alone serves."""
    cfg = get_model_config(NAME)
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(cfg, gen, torch.float32)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=False,
                       act_scale="row")
    calib = quantized.identity_calib(cfg, select_frac=0.25)
    sc = calib[1]["attn_in"]
    calib[1]["attn_in"] = quantized.SiteCalib(sc.reorder_index, 0)
    qp = quantized.quantize_model_params(cfg, params, calib, qcfg)
    ctx = PPContext(2, 0, None, (0, 1), "gloo", torch.device("cpu"))
    with pytest.raises(AssertionError):
        stack_stage_params(cfg, qp, calib, 2, ctx)


def _engine(runs, rank=0):
    return runs["ranks"][rank][1]


def test_pp_engine_matches_jax_and_single_device(runs):
    """The PP engine on a non-uniform calibration (bucketed): generate's
    tokens equal the JAX PP engine's and the JAX single-device engine's
    on the bucketed calibration, decode_scan's the JAX PP engine's; every
    step's logits (prefill, 3 decode steps fed JAX's tokens, a verify)
    bit for bit the port's single-device engine's on the bucketed
    calibration, on both stages (JAX's test_pp_engine_decode_token_
    identical)."""
    e = runs["eng"]
    r0, r1 = _engine(runs, 0), _engine(runs, 1)
    assert r0["generate"] == e["generate"] == e["single_generate"]
    assert r1["generate"] == r0["generate"]
    np.testing.assert_array_equal(r0["scan"], e["scan"])
    cfg = get_model_config(NAME)
    calib = bucket_calib_uniform(convert.calib_from_numpy(e["calib"]))
    eng = InferenceEngine(cfg, convert.params_from_numpy(runs["params"]),
                          calib, QuantConfig(**TP_QKW),
                          EngineConfig(**TP_EKW), device="cpu")
    want = _steps(eng, e["toks"], e["lens"], e["fed"], e["vt"], e["vv"])
    for step, w in want.items():
        for r in (r0, r1):
            np.testing.assert_array_equal(r[step], w, err_msg=step)


def test_pp_decode_collectives(runs):
    """A decode step relays through the stages: pp - 1 sends (stage 0's),
    pp - 1 recvs (stage 1's), one broadcast of the logits on every stage,
    and no all_reduce."""
    c0, c1 = (_engine(runs, r)["collectives"] for r in (0, 1))
    assert c0 == {"send": 1, "broadcast": 1}
    assert c1 == {"recv": 1, "broadcast": 1}


def test_pp_spec_decode_and_sampling(runs):
    """Speculative decoding over the PP engine is token-identical to its
    greedy generate, generate_ondevice refuses it, a sampled decode_scan
    repeats from its seed on both stages and temperature 0 is the greedy
    scan (JAX's test_pp_spec_decode_and_sampling)."""
    r0, r1 = _engine(runs, 0), _engine(runs, 1)
    assert r0["spec"] == r0["spec_ref"]
    assert r1["spec"] == r0["spec"]
    assert "PP" in (r0["ondevice_error"] or "")
    np.testing.assert_array_equal(*r0["sampled"])
    np.testing.assert_array_equal(r0["sampled"][0], r1["sampled"][0])
    np.testing.assert_array_equal(*r0["greedy_scan"])


def test_pp_batcher_spec_and_burst(runs):
    """The batcher over the PP engine with spec_window 3 and with decode
    bursts of 4 equals per-step batching (JAX's
    test_pp_batcher_spec_and_burst)."""
    r0, r1 = _engine(runs, 0), _engine(runs, 1)
    assert r0["batch_spec"] == r0["batch"]
    assert r0["batch_burst"] == r0["batch"]
    assert r1["batch"] == r0["batch"]


def test_pp_moe_engine_token_identical(runs):
    """The PP engine on test-tiny-moe (packed experts) generates the JAX
    PP engine's and the single-device engine's tokens (JAX's
    test_pp_engine_moe_token_identical)."""
    m = runs["moe"]
    assert m["generate"] == m["single"]
    for r in runs["ranks"]:
        assert r[2] == m["generate"]


def test_pp_refusals(runs):
    """Dynamic pages and per-row starts (prefix sharing) are refused."""
    errors = _engine(runs)["errors"]
    assert "dynamic_pages" in errors["dynamic_pages"]
    assert "prefix sharing" in errors["starts"]
