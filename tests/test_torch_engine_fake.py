"""The engine's fake-format, BF16-on-MoE and per-tensor routes of
arcquant_tpu_torch held against the JAX engine.

Cases (f32 params, identity calib at select_frac 0.125, static pages of
16, the bf16 head; both packages' DENSE_MODE_MAX_T lowered to 16 so an
MoE prefill of 2 x 23 padded tokens takes dispatch mode and decode dense
mode):
  - fake: tests/test_engine.py's own fixture qcfg (NVFP4,
    use_kernels=False, per-row activation and per-channel weight scales):
    fake-quantized fused linears, rms_norm then the plain qdq at every
    site; on test-tiny and on test-tiny-moe (the experts as qdq stacks);
  - int4, mxfp4: the same engine in the other fake formats, on
    test-tiny (mxfp4 against the JAX engine run eagerly: EAGER);
  - bf16: quant_type BF16 on test-tiny-moe (the bf16 expert stacks);
  - tensor: the port's packed engine (use_kernels, w8) at
    act_scale="tensor" against the JAX engine at use_kernels=False, tensor
    activation scales, channel weight scales (the JAX engine's plain
    route past its fused gates), on test-tiny; on test-tiny-moe against
    the JAX packed engine at tensor scales (its own packed and fake MoE
    engines are 0.992-0.998 apart in cosine: the routes' epilogue orders
    differ, and one e2m1 flip moves a logit by O(0.1)).
The bar is ROADMAP's engine-level one: prefill and STEPS decode steps fed
the same tokens with logits cosine >= 0.999 and equal greedy tokens, and
generate's tokens equal. On the fake and BF16 routes the port launches
no quantize kernel and no packed GEMM, and on the tensor route no decode
megakernel: their entry points are replaced by ones that fail.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.engine import InferenceEngine as JEngine
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import moe as jmoe
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.kernels import mlp_fused as mf
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.models import moe
from arcquant_tpu_torch.testing import cosine, to_numpy

PROMPTS = [list(range(1, 24)), [5, 17, 301, 42, 8, 9, 10]]
STEPS = 4
DENSE_MAX_T = 16
EKW = dict(max_batch=2, max_seq_len=48, page_size=16)
FAKE = dict(quant_type="NVFP4", use_kernels=False, kv_quant=False,
            act_scale="row", w_scale="channel")
# case: (model, the JAX engine's qcfg, the port's)
CASES = {
    "fake-tiny": ("test-tiny", FAKE, FAKE),
    "fake-moe": ("test-tiny-moe", FAKE, FAKE),
    "int4-tiny": ("test-tiny", {**FAKE, "quant_type": "INT4"},
                  {**FAKE, "quant_type": "INT4"}),
    "mxfp4-tiny": ("test-tiny", {**FAKE, "quant_type": "MXFP4"},
                   {**FAKE, "quant_type": "MXFP4"}),
    "bf16-moe": ("test-tiny-moe", dict(quant_type="BF16"),
                 dict(quant_type="BF16")),
    "tensor-tiny": ("test-tiny", {**FAKE, "act_scale": "tensor"},
                    {**FAKE, "act_scale": "tensor", "use_kernels": True}),
    "tensor-moe": ("test-tiny-moe",
                   {**FAKE, "act_scale": "tensor", "use_kernels": True},
                   {**FAKE, "act_scale": "tensor", "use_kernels": True}),
}
# Cases whose JAX reference runs eagerly (jax.disable_jit), without its
# generate (minutes eagerly): the jitted JAX engine leaves its own eager
# forward below the bar there (MXFP4: decode logits cosine 0.9956-0.9984,
# XLA's fused ue8m0 scale math against its op-by-op one).
EAGER = ("mxfp4-tiny",)


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX engine's prefill + greedy decode logits and generate."""
    name, jkw, _ = CASES[case]
    cfg = jax_model_config(name)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    calib = jquantized.identity_calib(cfg, select_frac=0.125)
    with pytest.MonkeyPatch.context() as mp, (
            jax.disable_jit() if case in EAGER
            else contextlib.nullcontext()):
        mp.setattr(jmoe, "DENSE_MODE_MAX_T", DENSE_MAX_T)
        eng = JEngine(cfg, params, calib, JQuantConfig(**jkw),
                      JEngineConfig(**EKW))
        toks, lens, _ = eng._pad_prompts(PROMPTS)
        logits, state = eng.prefill(eng.new_state(), jnp.asarray(toks),
                                    jnp.asarray(lens))
        out, fed = [np.asarray(logits)], []
        active = jnp.asarray(lens > 0)
        for _ in range(STEPS):
            cur = jnp.argmax(logits, -1).astype(jnp.int32)
            fed.append(np.asarray(cur))
            logits, state = eng.decode_step(state, cur, active)
            out.append(np.asarray(logits))
        generated = None if case in EAGER else eng.generate(PROMPTS, STEPS)
    return dict(params=jax.tree.map(np.asarray, params), calib=calib,
                toks=toks, lens=lens, logits=out, fed=fed,
                generated=generated)


def _fail(what):
    def f(*a, **k):
        raise AssertionError(f"{what} ran")
    return f


def _assert_close(got, want, what):
    got, want = to_numpy(got), np.asarray(want)
    c = cosine(got, want)
    assert c >= 0.999, f"{what}: logits cosine {c}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_route_matches_jax(case, monkeypatch):
    name, _, kw = CASES[case]
    run = _jax_run(case)
    monkeypatch.setattr(moe, "DENSE_MODE_MAX_T", DENSE_MAX_T)
    if case.startswith("tensor"):
        for fn in ("mlp_w8_fused", "gateup_silu_quantize",
                   "gemm_w8_actq_fused"):
            monkeypatch.setattr(mf, fn, _fail(fn))
        monkeypatch.setattr(qk, "_actq", _fail("actq"))
    else:
        monkeypatch.setattr(qk, "_actq", _fail("actq"))
        monkeypatch.setattr(gk, "gemm_dequant", _fail("gemm_dequant"))
        monkeypatch.setattr(gk, "gemm_dequant_batched",
                            _fail("gemm_dequant_batched"))
    eng = InferenceEngine(get_model_config(name),
                          convert.params_from_numpy(run["params"]),
                          convert.calib_from_numpy(run["calib"]),
                          QuantConfig(**kw), EngineConfig(**EKW),
                          device="cpu")
    layer = eng.qparams["layers"][0]
    if case.startswith("tensor"):
        assert hasattr(layer["qkv"], "codes")
    elif kw["quant_type"] != "BF16":
        assert "w_aug" in layer["qkv"]
        if "moe" in layer:
            assert "w_aug" in layer["moe"]["gate"]
    logits, state = eng.prefill(eng.new_state(), run["toks"], run["lens"])
    _assert_close(logits, run["logits"][0], f"{case} prefill")
    active = torch.as_tensor(run["lens"] > 0)
    for i, cur in enumerate(run["fed"]):
        logits, state = eng.decode_step(state, torch.tensor(cur), active)
        _assert_close(logits, run["logits"][i + 1], f"{case} decode {i}")
    if run["generated"] is not None:
        assert eng.generate(PROMPTS, STEPS) == run["generated"]
