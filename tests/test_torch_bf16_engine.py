"""The unquantized (BF16) engine and the bf16 LM head of
arcquant_tpu_torch held against the JAX engine, and the end-to-end
benchmark script on the CPU.

Both engines run test-tiny and test-qwen-tiny (qkv bias) from the same
f32 params (as tests/test_torch_engine.py, whose docstring says why f32)
with ragged prompts over the int4 paged pool (pages of 16); the JAX side
runs its Pallas attention kernels in interpret mode. Two settings:
quant_type "BF16" (bf16 linears, no activation quantize, the bf16 head)
and the NVFP4 W4A4 + ARC engine with quantize_lm_head=False (the bf16
head). The bar is the engine-level one: prefill and decode steps with
logits cosine >= 0.999 and identical greedy tokens.
"""

import json

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
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.benchmarks import benchmark_e2e
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.models import llama, quantized
from arcquant_tpu_torch.testing import cosine, to_numpy
from arcquant_tpu_torch.utils import mem

PROMPTS = [[5, 17, 301, 42, 8, 9, 10], [100, 200, 7],
           list(range(1, 40)), [3]]
STEPS = 4
QKW = {"bf16": dict(quant_type="BF16"),
       "nvfp4_bf16_head": dict(quant_type="NVFP4", use_kernels=True,
                               weight_fmt="w8", act_scale="row",
                               w_scale="channel", quantize_lm_head=False)}
EKW = dict(max_batch=4, max_seq_len=64, page_size=16)


@pytest.fixture(scope="module", params=[
    ("test-tiny", "bf16"), ("test-qwen-tiny", "bf16"),
    ("test-tiny", "nvfp4_bf16_head"), ("test-qwen-tiny", "nvfp4_bf16_head")],
    ids=lambda p: "-".join(p))
def jax_run(request):
    """The JAX engine's prefill + greedy decode logits and generate()."""
    name, setting = request.param
    cfg = jax_model_config(name)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(0)
    for layer in params["layers"]:     # non-zero qkv biases (Qwen2)
        for proj in ("q", "k", "v"):
            if "b" in layer[proj]:
                layer[proj]["b"] = jnp.asarray(
                    rng.standard_normal(layer[proj]["b"].shape) * 0.1,
                    jnp.float32)
    calib = jquantized.identity_calib(cfg, select_frac=0.125)
    eng = JEngine(cfg, params, calib, JQuantConfig(**QKW[setting]),
                  JEngineConfig(**EKW))
    assert "lm_head_packed" not in eng.qparams
    toks, lens, _ = eng._pad_prompts(PROMPTS)
    logits, state = eng.prefill(eng.new_state(), jnp.asarray(toks),
                                jnp.asarray(lens))
    all_logits, fed = [np.asarray(logits)], []
    active = jnp.asarray(lens > 0)
    for _ in range(STEPS):
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(cur))
        logits, state = eng.decode_step(state, cur, active)
        all_logits.append(np.asarray(logits))
    return dict(name=name, setting=setting,
                params=jax.tree.map(np.asarray, params), calib=calib,
                toks=toks, lens=lens, logits=all_logits, fed=fed,
                generated=eng.generate(PROMPTS, STEPS))


def _port(run):
    return InferenceEngine(get_model_config(run["name"]),
                           convert.params_from_numpy(run["params"]),
                           convert.calib_from_numpy(run["calib"]),
                           QuantConfig(**QKW[run["setting"]]),
                           EngineConfig(**EKW), device="cpu")


def _assert_close(got, want, what):
    got, want = to_numpy(got), np.asarray(want)
    assert got.dtype == np.float32
    c = cosine(got, want)
    assert c >= 0.999, f"{what}: logits cosine {c}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=what)


def test_engine_matches_jax(jax_run):
    eng = _port(jax_run)
    assert "lm_head_packed" not in eng.qparams
    layer = eng.qparams["layers"][0]
    if jax_run["setting"] == "bf16":      # unquantized fused linears
        assert isinstance(layer["qkv"], dict) and isinstance(
            layer["gateup"], dict)
    logits, state = eng.prefill(eng.new_state(), jax_run["toks"],
                                jax_run["lens"])
    _assert_close(logits, jax_run["logits"][0], "prefill")
    active = torch.as_tensor(jax_run["lens"] > 0)
    for i, cur in enumerate(jax_run["fed"]):
        logits, state = eng.decode_step(state, torch.tensor(cur), active)
        _assert_close(logits, jax_run["logits"][i + 1], f"decode step {i}")


def test_generate_matches_jax(jax_run):
    assert _port(jax_run).generate(PROMPTS, STEPS) == jax_run["generated"]


def test_linear_matches_jax():
    """llama.linear: the f32-accumulated product, the bias in f32, the
    result in x's dtype (bf16 here), as the JAX package's."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((48, 64)).astype(np.float32) * 0.1
    b = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b, jnp.bfloat16)}
    want = np.asarray(jllama.linear(jp, jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    got = llama.linear(tp, convert.tensor_from_numpy(
        np.asarray(jnp.asarray(x, jnp.bfloat16))))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got), want, rtol=2.0 ** -7,
                               atol=1e-6)


def test_bf16_on_moe_raises():
    """BF16 on an MoE config, once refused, runs: the engine holds the
    bf16 expert stacks (moe.quantize_moe_params at BF16 is the tree as
    it is) and its prefill logits are the bf16 reference forward's
    (llama.model_forward, f32 params) at each row's last token, within
    the engine-level bar (its attention is flash's plain version, the
    reference's dense f32)."""
    cfg = get_model_config("test-tiny-moe")
    calib = quantized.identity_calib(cfg)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32)
    eng = InferenceEngine(cfg, params, calib, QuantConfig(quant_type="BF16"),
                          EngineConfig(**EKW), device="cpu")
    layer = eng.qparams["layers"][0]
    assert layer["moe"]["gate"]["w"] is params["layers"][0]["moe"]["gate"][
        "w"]
    prompts = [[5, 17, 301, 42, 8], [100, 200, 7]]
    toks, lens, _ = eng._pad_prompts(prompts)
    logits, _ = eng.prefill(eng.new_state(), toks, lens)
    for i, p in enumerate(prompts):
        want = llama.model_forward(cfg, params, torch.tensor([p]))[0, -1]
        assert cosine(to_numpy(logits[i]), to_numpy(want)) >= 0.999
        assert int(logits[i].argmax()) == int(want.argmax())
    assert [len(o) for o in eng.generate(prompts, 4)] == [4, 4]


@pytest.mark.parametrize("quant,head", [("BF16", True), ("NVFP4", True),
                                        ("NVFP4", False)])
def test_benchmark_e2e_runs_on_the_cpu(quant, head, capsys):
    args = benchmark_e2e.build_parser().parse_args(
        ["--model", "test-tiny", "--layers", "1", "--prefill_seq_len", "16",
         "--decode_steps", "2", "--warmup", "1", "--repeats", "2",
         "--quant", quant, "--cpu"] + ([] if head else ["--no-quant_head"]))
    r = benchmark_e2e.run(args)
    keys = {"model", "batch", "prefill", "decode_steps", "prefill_ms",
            "decode_ms_total", "decode_ms_per_step", "decode_tokens_per_s",
            "e2e_ms", "peak_mem_gb", "decode_ms_per_step_median", "spread",
            "device"}
    assert keys <= set(benchmark_e2e.public(r))
    assert r["batch"] == 4 and r["prefill"] == 16 and r["decode_steps"] == 2
    assert r["layers"] == 1 and r["_tokens_valid"]
    assert r["quant_head"] == (quant == "NVFP4" and head)   # head packed
    assert r["device"]["name"] == "cpu" and r["peak_mem_gb"] is None
    assert r["prefill_ms"] > 0 and r["decode_ms_per_step"] > 0
    text = benchmark_e2e.lines(r)
    assert text[0].startswith("Prefill time:") and "tok/s" in text[1]
    benchmark_e2e.main(["--model", "test-tiny", "--layers", "1",
                        "--prefill_seq_len", "8", "--decode_steps", "1",
                        "--warmup", "0", "--repeats", "1", "--quant", quant,
                        "--cpu", "--json"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert keys <= set(json.loads(out))
    if not torch.cuda.is_available():
        assert mem.live_device_bytes() == 0 and mem.device_mem_gb() is None
        with pytest.raises(RuntimeError, match="CUDA"):
            benchmark_e2e.main(["--model", "test-tiny", "--layers", "1"])
