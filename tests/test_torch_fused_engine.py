"""The port's decode routes through the megakernels (kernels/mlp_fused.py)
held against the JAX engine with its own megakernels engaged (their
Pallas kernels in interpret mode).

Two engines at batch 4 with f32 params, as tests/test_torch_engine.py
runs them (W4A4 NVFP4, w8, per-row activation and per-channel weight
scales, W4A16 packed head, static pages of 16): test-qwen-tiny
select-free (select_frac 0, the north-star configuration's sites: every
decode layer takes quantize + GEMM at attn_in and o_in and the whole MLP
in one launch each) and test-tiny with ARC (select_frac 0.125: down_in
has 64 residual columns, so its MLP takes gateup + silu*mul + quantize
in one launch, then the residual and the down GEMM). The bar is the
engine-level one: logits cosine >= 0.999 and identical greedy tokens at
prefill and at each decode step. Counting calls shows the routes taken:
the fused functions at M = 4, none at prefill (M = 156) or at M = 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.engine import InferenceEngine as JEngine
from arcquant_tpu.kernels import mlp_fused as jmf
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.kernels import mlp_fused as mf
from arcquant_tpu_torch.testing import cosine, to_numpy

PROMPTS = [[5, 17, 301, 42, 8, 9, 10], [100, 200, 7],
           list(range(1, 40)), [3]]
STEPS = 4
QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
           act_scale="row", w_scale="channel", quantize_lm_head=True)
EKW = dict(max_batch=4, max_seq_len=64, page_size=16)
FUSED = ("gemm_w8_actq_fused", "mlp_w8_fused", "gateup_silu_quantize")


class Calls:
    """Counts the calls of the named functions of `module` (patched)."""

    def __init__(self, monkeypatch, module, names=FUSED):
        self.n = dict.fromkeys(names, 0)
        for name in names:
            real = getattr(module, name)

            def counted(*a, _real=real, _name=name, **kw):
                self.n[_name] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(module, name, counted)

    def take(self):
        out, self.n = self.n, dict.fromkeys(self.n, 0)
        return out


@pytest.fixture(scope="module", params=[("test-qwen-tiny", 0.0),
                                        ("test-tiny", 0.125)])
def jax_run(request):
    """The JAX engine's prefill + greedy decode logits, with the calls of
    its megakernels counted while it traces."""
    name, sel = request.param
    cfg = jax_model_config(name)
    params = jllama.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    rng = np.random.default_rng(1)
    for layer in params["layers"]:     # non-zero qkv biases (Qwen2)
        for proj in ("q", "k", "v"):
            if "b" in layer[proj]:
                layer[proj]["b"] = jnp.asarray(
                    rng.standard_normal(layer[proj]["b"].shape) * 0.1,
                    jnp.float32)
    calib = jquantized.identity_calib(cfg, select_frac=sel)
    mp = pytest.MonkeyPatch()
    calls = Calls(mp, jmf)
    try:
        jax.clear_caches()             # trace again: count the routes
        eng = JEngine(cfg, params, calib, JQuantConfig(**QKW),
                      JEngineConfig(**EKW))
        toks, lens, _ = eng._pad_prompts(PROMPTS)
        logits, state = eng.prefill(eng.new_state(), jnp.asarray(toks),
                                    jnp.asarray(lens))
        prefill_calls = calls.take()
        all_logits, fed = [np.asarray(logits)], []
        active = jnp.asarray(lens > 0)
        for _ in range(STEPS):
            cur = jnp.argmax(logits, -1).astype(jnp.int32)
            fed.append(np.asarray(cur))
            logits, state = eng.decode_step(state, cur, active)
            all_logits.append(np.asarray(logits))
        decode_calls = calls.take()
    finally:
        mp.undo()
        jax.clear_caches()
    return dict(name=name, sel=sel, layers=cfg.num_layers,
                qparams=jax.tree.map(np.asarray, eng.qparams), calib=calib,
                toks=toks, lens=lens, logits=all_logits, fed=fed,
                jax_calls=(prefill_calls, decode_calls))


def _port(run, fused_decode=True, **ekw):
    return InferenceEngine(
        get_model_config(run["name"]),
        convert.qparams_from_numpy(run["qparams"]),
        convert.calib_from_numpy(run["calib"]), QuantConfig(**QKW),
        EngineConfig(**{**EKW, **ekw}), device="cpu", quantize_params=False,
        fused_decode=fused_decode)


def _want(run):
    """Fused calls per decode step at M = 4, as the routes of the run's
    configuration give them: two quantize + GEMM sites per layer, and one
    MLP launch (the whole MLP select-free, gateup + quantize with ARC)."""
    mlp = "mlp_w8_fused" if run["sel"] == 0 else "gateup_silu_quantize"
    want = dict.fromkeys(FUSED, 0)
    want["gemm_w8_actq_fused"] = 2 * run["layers"]
    want[mlp] = run["layers"]
    return want


def _assert_close(got, want, what):
    got, want = to_numpy(got), np.asarray(want)
    c = cosine(got, want)
    assert c >= 0.999, f"{what}: logits cosine {c}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=what)


def test_jax_engaged_its_megakernels(jax_run):
    """The reference runs the routes the port is held to: none at
    prefill, the configuration's megakernels at decode (counted once,
    while the step is traced)."""
    prefill, decode = jax_run["jax_calls"]
    assert prefill == dict.fromkeys(FUSED, 0)
    assert decode == _want(jax_run)


def test_fused_decode_matches_jax(jax_run, monkeypatch):
    eng = _port(jax_run)
    calls = Calls(monkeypatch, mf)
    logits, state = eng.prefill(eng.new_state(), jax_run["toks"],
                                jax_run["lens"])
    assert calls.take() == dict.fromkeys(FUSED, 0)
    _assert_close(logits, jax_run["logits"][0], "prefill")
    active = torch.as_tensor(jax_run["lens"] > 0)
    for i, cur in enumerate(jax_run["fed"]):
        logits, state = eng.decode_step(state, torch.tensor(cur), active)
        assert calls.take() == _want(jax_run), f"decode step {i}"
        _assert_close(logits, jax_run["logits"][i + 1], f"decode step {i}")


def test_fused_decode_off_is_the_chain(jax_run, monkeypatch):
    """fused_decode=False takes no fused route and gives the same logits
    (on the CPU the fused functions' plain versions are the chain)."""
    fused, chain = _port(jax_run), _port(jax_run, fused_decode=False)
    calls = Calls(monkeypatch, mf)
    outs = []
    for eng in (fused, chain):
        _, state = eng.prefill(eng.new_state(), jax_run["toks"],
                               jax_run["lens"])
        logits, _ = eng.decode_step(state, torch.tensor(jax_run["fed"][0]),
                                    torch.ones(4, dtype=torch.bool))
        outs.append(logits)
        if eng is fused:
            assert calls.take() == _want(jax_run)
    assert calls.take() == dict.fromkeys(FUSED, 0)
    assert torch.equal(outs[0], outs[1])


def test_no_fused_route_at_two_rows(jax_run, monkeypatch):
    """At M = 2, below the actq minimum, every site runs the chain (the
    prefill has 2 x 39 rows)."""
    eng = _port(jax_run, max_batch=2)
    calls = Calls(monkeypatch, mf)
    out = eng.generate([PROMPTS[0], PROMPTS[2]], 3)
    assert [len(o) for o in out] == [3, 3]
    assert calls.take() == dict.fromkeys(FUSED, 0)


def test_quantized_mode_route(monkeypatch):
    """An ARC mlp_in with a select-free down_in takes the whole-MLP
    kernel in quantized mode (the rmsnorm quantize and its residual run
    before it), and gives the chain's logits."""
    from arcquant_tpu_torch.models import quantized
    cfg = get_model_config("test-tiny")
    calib = [dict(layer, mlp_in=quantized.SiteCalib(
        layer["mlp_in"].reorder_index, 64))
        for layer in quantized.identity_calib(cfg, 0.0)]
    qcfg, ecfg = QuantConfig(**QKW), EngineConfig(**EKW)
    fused = InferenceEngine.dummy(cfg, calib, qcfg, ecfg, device="cpu")
    chain = InferenceEngine(cfg, fused.qparams, calib, qcfg, ecfg,
                            device="cpu", quantize_params=False,
                            fused_decode=False)
    seen = []
    real = mf.mlp_w8_fused
    monkeypatch.setattr(mf, "mlp_w8_fused", lambda *a, **k: seen.append(
        k.get("norm_w") is None) or real(*a, **k))
    toks, lens, _ = fused._pad_prompts(PROMPTS)
    outs = []
    for eng in (fused, chain):
        _, state = eng.prefill(eng.new_state(), toks, lens)
        logits, _ = eng.decode_step(state, torch.arange(4),
                                    torch.ones(4, dtype=torch.bool))
        outs.append(logits)
    assert seen == [True] * cfg.num_layers
    assert torch.equal(outs[0], outs[1])
