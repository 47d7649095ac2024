"""The tensor-parallel serving engine of arcquant_tpu_torch
(parallel/tp_engine.py) held against the JAX package's TPInferenceEngine
and against the port's single-device engine.

Two gloo ranks on the CPU (parallel.launch, workers in
arcquant_tpu_torch/testing.py that import no JAX) run, in one spawn, the
TP engine on test-tiny with f32 params at select 0 and at ARC 0.5: the
one-shot prefill, 3 decode steps fed the JAX TP engine's greedy tokens, a
verify_step and a chunked prefill; then the serving contracts at select
0: the collectives of a decode step, speculative decoding and the
batcher's spec_window and decode burst against the engine's own greedy
decode, generate_ondevice's refusal, sampled decode_scan. A second spawn
runs ``python -m arcquant_tpu_torch.generate --tp 2 --dist_backend gloo
--cpu``. The JAX TP engine runs here on 2 devices of tests/conftest.py's
CPU mesh, its Pallas kernels in interpret mode.
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
from arcquant_tpu_torch import convert, generate
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.parallel import launch
from arcquant_tpu_torch.testing import (TP_CHUNK, TP_EKW, TP_QKW,
                                        calib_arrays, cosine, tp_tasks)

NAME = "test-tiny"
FRACS = (0.0, 0.5)
# Ragged prompts: 20 tokens (two chunks of TP_CHUNK) and 9.
PROMPTS = [list(range(1, 21)), [100, 200, 7, 8, 9, 10, 11, 12, 13]]
# The serving checks' prompts (JAX's test_tp_spec_decode_and_sampling):
# repetitive, so n-gram drafts get accepted.
SPEC_PROMPTS = [[1, 2, 3, 4] * 5, [7, 8, 7, 8, 7, 8]]
GEN_PROMPTS = [[5, 17, 301], [9, 8, 7, 6]]
GEN_NEW = 8
STEPS = ("prefill", "decode1", "decode2", "decode3", "verify", "chunked")


def _jax_run(cfg, params, frac):
    """The JAX TP engine's logits of every step, the fed tokens and the
    verify's inputs."""
    calib = jquantized.identity_calib(cfg, frac)
    mesh = jmake_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    qcfg = JQuantConfig(**TP_QKW)
    eng = JTPEngine(cfg, params, calib, qcfg, JEngineConfig(**TP_EKW), mesh)
    toks, lens, _ = eng._pad_prompts(PROMPTS)
    logits, state = eng.prefill(eng.new_state(), jnp.asarray(toks),
                                jnp.asarray(lens))
    out, fed = {"prefill": np.asarray(logits)}, []
    act = jnp.asarray(lens > 0)
    for i in range(3):
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(cur))
        logits, state = eng.decode_step(state, cur, act)
        out[f"decode{i + 1}"] = np.asarray(logits)
    vt = np.stack([np.asarray(jnp.argmax(logits, -1)), [7, 5],
                   [8, 0]], 1).astype(np.int32)
    vv = np.asarray([3, 2], np.int32)
    out["verify"] = np.asarray(eng.verify_step(state, jnp.asarray(vt),
                                               jnp.asarray(vv))[0])
    chunked = JTPEngine(cfg, params, calib, qcfg, JEngineConfig(
        prefill_chunk=TP_CHUNK, **TP_EKW), mesh)
    out["chunked"] = np.asarray(chunked.prefill(
        chunked.new_state(), jnp.asarray(toks), jnp.asarray(lens))[0])
    return dict(logits=out, fed=fed, toks=toks, lens=lens, vt=vt, vv=vv,
                calib=calib_arrays(calib))


@pytest.fixture(scope="module")
def runs():
    """The JAX references, then one spawn of two ranks running every
    check of the port's TP engine."""
    cfg = jax_model_config(NAME)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    ref = {frac: _jax_run(cfg, params, frac) for frac in FRACS}
    params = jax.tree.map(np.asarray, params)
    tasks = [("tp_engine_run", (NAME, params, r["calib"], r["toks"],
                                r["lens"], r["fed"], r["vt"], r["vv"]))
             for r in ref.values()]
    tasks.append(("tp_engine_serving", (NAME, params, ref[0.0]["calib"],
                                        SPEC_PROMPTS, GEN_PROMPTS, GEN_NEW)))
    ranks = launch(tp_tasks, 2, "gloo", cpu=True, args=(tasks,))
    return dict(ref=ref, params=params, ranks=ranks)


def _rows(step, logits, vv):
    """The compared rows of a step's logits: a verify's valid positions."""
    if step != "verify":
        return [logits]
    return [logits[b, :n] for b, n in enumerate(vv)]


@pytest.mark.parametrize("frac", FRACS)
def test_tp_engine_matches_jax(runs, frac):
    """Every step of the port's TP engine against the JAX TP engine's:
    logits cosine >= 0.999 and equal greedy tokens (JAX's
    test_tp_engine_matches_single_device and ..._with_arc_generates)."""
    ref = runs["ref"][frac]
    got = runs["ranks"][0][FRACS.index(frac)]
    for step in STEPS:
        for a, b in zip(_rows(step, got[step], ref["vv"]),
                        _rows(step, ref["logits"][step], ref["vv"])):
            c = cosine(a, b)
            assert c >= 0.999, f"{step}: logits cosine {c}"
            np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1),
                                          err_msg=step)


@pytest.mark.parametrize("frac", FRACS)
def test_tp_logits_bitwise_across_ranks(runs, frac):
    r0, r1 = (r[FRACS.index(frac)] for r in runs["ranks"])
    for step in STEPS:
        np.testing.assert_array_equal(r0[step], r1[step], err_msg=step)


def test_tp_engine_matches_single_device(runs):
    """At select 0 (per-row activation and per-channel weight scales) the
    TP engine's quantization grids are the single-device engine's: every
    step's logits cosine >= 0.999 against the port's InferenceEngine fed
    the same tokens (JAX's test_tp_engine_matches_single_device)."""
    ref = runs["ref"][0.0]
    got = runs["ranks"][0][0]
    cfg = get_model_config(NAME)
    params = convert.params_from_numpy(runs["params"])
    calib = convert.calib_from_numpy(jquantized.identity_calib(
        jax_model_config(NAME), 0.0))
    want = {}
    for chunk in (0, TP_CHUNK):
        eng = InferenceEngine(cfg, params, calib, QuantConfig(**TP_QKW),
                              EngineConfig(prefill_chunk=chunk, **TP_EKW),
                              device="cpu")
        logits, state = eng.prefill(eng.new_state(), ref["toks"],
                                    ref["lens"])
        if chunk:
            want["chunked"] = logits.numpy()
            continue
        want["prefill"] = logits.numpy()
        active = torch.as_tensor(ref["lens"] > 0)
        for i, cur in enumerate(ref["fed"]):
            logits, state = eng.decode_step(state, torch.tensor(cur),
                                            active)
            want[f"decode{i + 1}"] = logits.numpy()
        want["verify"] = eng.verify_step(state, ref["vt"], ref["vv"])[0].numpy()
    for step in STEPS:
        for a, b in zip(_rows(step, got[step], ref["vv"]),
                        _rows(step, want[step], ref["vv"])):
            assert cosine(a, b) >= 0.999, step


def _serving(runs, rank=0):
    return runs["ranks"][rank][len(FRACS)]


def test_tp_decode_communication_contract(runs):
    """A decode step makes exactly 2 all_reduce(SUM) (the o and down
    partials) and 2 all_reduce(MAX) (the row sites' global scales) a
    layer, and no other collective: none from the head or the sampling
    (JAX's test_tp_decode_communication_contract)."""
    layers = get_model_config(NAME).num_layers
    for r in range(2):
        assert _serving(runs, r)["collectives"] == {
            "all_reduce:sum": 2 * layers, "all_reduce:max": 2 * layers}


def test_tp_spec_decode_and_batcher(runs):
    """Speculative decoding (host verify loop) and the batcher with
    spec_window 3 and with decode bursts of 4 over the TP engine are
    token-identical to its own greedy decode, on both ranks (JAX's
    test_tp_spec_decode_and_sampling, test_tp_batcher_speculative,
    test_tp_batcher_decode_burst)."""
    s0, s1 = _serving(runs, 0), _serving(runs, 1)
    assert s0["spec"] == s0["generate"]
    assert s0["batch_spec"] == s0["batch"]
    assert s0["batch_burst"] == s0["batch"]
    for key in ("generate", "spec", "batch", "batch_spec", "batch_burst"):
        assert s1[key] == s0[key], key


def test_tp_sampled_decode_scan(runs):
    """A sampled decode_scan repeats from its seed and agrees across the
    ranks; temperature 0 is the greedy scan."""
    s0, s1 = _serving(runs, 0), _serving(runs, 1)
    np.testing.assert_array_equal(*s0["sampled"])
    np.testing.assert_array_equal(s0["sampled"][0], s1["sampled"][0])
    np.testing.assert_array_equal(*s0["greedy_scan"])


def test_tp_generate_ondevice_rejected(runs):
    assert "single-chip" in (_serving(runs)["ondevice_error"] or "")


def test_generate_tp_entry_point(runs, monkeypatch, capsys):
    """python -m arcquant_tpu_torch.generate --tp 2 --dist_backend gloo
    --cpu: rank 0 prints the batcher's outputs, which equal the TP
    engine's own greedy generate on the same dummy weights; every step's
    logits agree bitwise across the ranks (--check_ranks)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the ranks' torch threads
    argv = ["--model", NAME, "--tp", "2", "--dist_backend", "gloo", "--cpu",
            "--max_new", str(GEN_NEW), "--check_ranks"]
    for p in GEN_PROMPTS:
        argv += ["--tokens", ",".join(map(str, p))]
    results = generate.main(argv)
    want = _serving(runs)["dummy_generate"]
    assert [r["outputs"] for r in results] == [want, want]
    assert all(s["digest"] == t["digest"] for s, t in
               zip(results[0]["steps"], results[1]["steps"]))
    decode = [s for s in results[0]["steps"] if s["kind"] == "decode"]
    layers = get_model_config(NAME).num_layers
    assert decode and all(s["comm"] == {"sum": 2 * layers,
                                        "max": 2 * layers} for s in decode)
    out = capsys.readouterr().out
    assert "ranks agree" in out


def test_tp_refusals():
    """nccl without a card a rank raises and names gloo; a CUDA graph under
    gloo raises, and under nccl the captured step raises citing ROADMAP
    item 8.6 (the only part of the TP engine not ported). MoE under TP is
    served (experts sharded over the ranks, test_torch_ep.py), refused
    only when tp does not divide the experts."""
    from arcquant_tpu_torch.parallel import TPContext, TPInferenceEngine
    from arcquant_tpu_torch.parallel.tp_engine import check_tp
    from arcquant_tpu_torch.models import quantized
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="gloo"):
            launch(tp_tasks, 2, "nccl", args=([],))
        with pytest.raises(RuntimeError, match="gloo"):
            generate.main(["--model", NAME, "--tp", "2"])
    with pytest.raises(ValueError, match="gloo"):
        generate.main(["--model", NAME, "--tp", "2", "--cpu"])
    moe_cfg = get_model_config("test-tiny-moe")
    check_tp(moe_cfg, QuantConfig(**TP_QKW), 2)
    with pytest.raises(ValueError, match="num_experts"):
        check_tp(moe_cfg.replace(num_experts=3), QuantConfig(**TP_QKW), 2)
    cfg = get_model_config(NAME)
    for backend, exc, match in (("gloo", ValueError, "CUDA graph"),
                                ("nccl", NotImplementedError, "item 8.6")):
        ctx = TPContext(2, 0, None, backend, torch.device("cpu"))
        with pytest.raises(exc, match=match):
            TPInferenceEngine.dummy(cfg, quantized.identity_calib(cfg, 0.0),
                                    QuantConfig(**TP_QKW),
                                    EngineConfig(**TP_EKW), ctx,
                                    cuda_graphs=True)
