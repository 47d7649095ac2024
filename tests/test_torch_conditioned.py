"""The conditioned dummy init (arcquant_tpu_torch.testing.conditioned_*)
and the port's engine held to the flat bar in bf16 against the JAX engine.

On llama.init_params' draws the bf16 forward is chaotic at the ulp level:
the JAX engine jitted and the same engine run eagerly disagree at logits
cosine 0.98, so tests/test_torch_engine.py runs f32 params. On the
conditioned init (a unit-rms embedding, the residual branches' outputs
scaled by CONDITIONED_BRANCH) the same W4A4 path in bf16 meets the
engine-level bar: prefill and 8 greedy decode steps, logits cosine >=
0.999 and equal greedy tokens, on test-tiny and test-qwen-tiny at 2 and
4 layers and on test-tiny-moe at 2, with the JAX engine's own
jit-against-eager cosine asserted at >= 0.999 beside it (the init, not a
looser bar, makes the difference). Both packages get the same bf16
arrays through numpy; the JAX side runs its Pallas kernels in interpret
mode, the port its plain versions on the CPU. A property test shows the
init neither amplifies noise nor hides quantization.
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
from arcquant_tpu.models import moe as jmoe
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.models import llama, moe, quantized
from arcquant_tpu_torch.testing import (branch_scale, conditioned_engine,
                                        conditioned_params, cosine,
                                        greedy_ties, same_greedy, to_numpy)

PROMPTS = [[5, 17, 301, 42, 8, 9, 10], [100, 200, 7],
           list(range(1, 40)), [3]]
STEPS = 8
QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
           act_scale="row", w_scale="channel", quantize_lm_head=True)
EKW = dict(max_batch=4, max_seq_len=64, page_size=16)
SELECT = 0.125
# the MoE engine: two prompts, dispatch mode for the 2 x 23-token prefill
# and dense mode for decode (both packages' limit lowered to 16)
MOE_PROMPTS = [list(range(1, 24)), [5, 17, 301, 42, 8, 9, 10]]
MOE_EKW = dict(max_batch=2, max_seq_len=48, page_size=16)
MOE_DENSE_MAX_T = 16


def _bf16_numpy(tree):
    """A tree of bf16 tensors as numpy bf16 arrays (the JAX dtype)."""
    if isinstance(tree, dict):
        return {k: _bf16_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16_numpy(v) for v in tree]
    return tree.contiguous().view(torch.int16).numpy().view(jnp.bfloat16)


def _params(name, layers, seed=0):
    """The conditioned init's bf16 tree of `name` cut to `layers` layers,
    as numpy; a Qwen2 config's qkv biases N(0, 0.1^2), as in the f32
    engine tests."""
    cfg = get_model_config(name).replace(num_layers=layers)
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = conditioned_params(cfg, gen)
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        for proj in ("q", "k", "v"):
            if "b" in layer[proj]:
                layer[proj]["b"] = torch.from_numpy(
                    rng.standard_normal(layer[proj]["b"].shape) * 0.1
                ).to(torch.bfloat16)
    return cfg, _bf16_numpy(params)


def _jax_steps(eng, toks, lens, fed=None, steps=STEPS):
    """The JAX engine's prefill and `steps` decode steps (greedy, or fed
    `fed`): ([logits], [tokens fed])."""
    logits, state = eng.prefill(eng.new_state(), jnp.asarray(toks),
                                jnp.asarray(lens))
    out, tokens = [np.asarray(logits, np.float32)], []
    active = jnp.asarray(lens > 0)
    for i in range(steps):
        cur = (jnp.argmax(logits, -1).astype(jnp.int32) if fed is None
               else jnp.asarray(fed[i]))
        tokens.append(np.asarray(cur))
        logits, state = eng.decode_step(state, cur, active)
        out.append(np.asarray(logits, np.float32))
    return out, tokens


def _port_steps(eng, toks, lens, fed):
    """The port's prefill and a decode step fed each of `fed` (numpy)."""
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    out = [to_numpy(logits)]
    active = torch.as_tensor(lens > 0)
    for cur in fed:
        logits, state = eng.decode_step(state, torch.tensor(cur), active)
        out.append(to_numpy(logits))
    return out


def _assert_flat(got, want, what):
    """The flat bar at every step: cosine >= 0.999 and equal greedy tokens
    at every row but ties (testing.greedy_ties: the reference's top-2
    logits closer than 2^-6 of the row's rms, the resolution of a head
    that reads a bf16 activation)."""
    for i, (a, b) in enumerate(zip(got, want)):
        c = cosine(a, b)
        assert c >= 0.999, f"{what} step {i}: logits cosine {c}"
        ok, ties, differ = same_greedy(a, b)
        assert ok, (f"{what} step {i}: greedy tokens differ at {differ} "
                    f"rows, {ties} of the rows ties")


@pytest.fixture(scope="module",
                params=[("test-tiny", 2), ("test-tiny", 4),
                        ("test-qwen-tiny", 2), ("test-qwen-tiny", 4)],
                ids=lambda p: f"{p[0]}-{p[1]}L")
def jax_run(request):
    """The JAX engine (jitted) on the conditioned bf16 params: prefill and
    STEPS greedy decode steps."""
    name, layers = request.param
    cfg, params = _params(name, layers)
    jcfg = jax_model_config(name).replace(num_layers=layers)
    calib = jquantized.identity_calib(jcfg, select_frac=SELECT)
    eng = JEngine(jcfg, jax.tree.map(jnp.asarray, params), calib,
                  JQuantConfig(**QKW), JEngineConfig(**EKW))
    toks, lens, _ = eng._pad_prompts(PROMPTS)
    logits, fed = _jax_steps(eng, toks, lens)
    return dict(cfg=cfg, params=params, calib=calib, toks=toks, lens=lens,
                logits=logits, fed=fed, eng=eng)


def test_engine_matches_jax_in_bf16(jax_run):
    """The port's engine (packing the raw bf16 params itself) against the
    JAX engine, fed the same tokens: the flat bar at every step."""
    eng = InferenceEngine(jax_run["cfg"],
                          convert.params_from_numpy(jax_run["params"]),
                          convert.calib_from_numpy(jax_run["calib"]),
                          QuantConfig(**QKW), EngineConfig(**EKW),
                          device="cpu")
    got = _port_steps(eng, jax_run["toks"], jax_run["lens"], jax_run["fed"])
    _assert_flat(got, jax_run["logits"], jax_run["cfg"].name)


@pytest.mark.parametrize("jax_run", [("test-tiny", 2)], indirect=True,
                         ids=["test-tiny-2L"])
def test_jax_jit_matches_eager_on_the_conditioned_init(jax_run):
    """The JAX engine's own jit-against-eager agreement on the new init:
    the flat bar at the prefill and the first decode step (on
    llama.init_params' bf16 draws the cosine is 0.98 from the first
    decode step on). Eager runs the Pallas kernels in interpret mode op
    by op, about 25 s a step, so one case and two steps."""
    with jax.disable_jit():
        eager, _ = _jax_steps(jax_run["eng"], jax_run["toks"],
                              jax_run["lens"], jax_run["fed"], steps=1)
    _assert_flat(jax_run["logits"][:2], eager, "JAX jit against eager")


def test_moe_engine_matches_jax_in_bf16(monkeypatch):
    """test-tiny-moe at 2 layers on the conditioned bf16 params (the
    experts' down and the shared expert's scaled too), ARC 0.125: the
    port against the JAX packed MoE engine, prefill (dispatch mode) and 8
    decode steps (dense mode), the flat bar at every step."""
    monkeypatch.setattr(jmoe, "DENSE_MODE_MAX_T", MOE_DENSE_MAX_T)
    monkeypatch.setattr(moe, "DENSE_MODE_MAX_T", MOE_DENSE_MAX_T)
    cfg, params = _params("test-tiny-moe", 2)
    jcfg = jax_model_config("test-tiny-moe").replace(num_layers=2)
    calib = jquantized.identity_calib(jcfg, select_frac=SELECT)
    jeng = JEngine(jcfg, jax.tree.map(jnp.asarray, params), calib,
                   JQuantConfig(**QKW), JEngineConfig(**MOE_EKW))
    toks, lens, _ = jeng._pad_prompts(MOE_PROMPTS)
    want, fed = _jax_steps(jeng, toks, lens)
    eng = InferenceEngine(cfg, convert.params_from_numpy(params),
                          convert.calib_from_numpy(calib),
                          QuantConfig(**QKW), EngineConfig(**MOE_EKW),
                          device="cpu")
    _assert_flat(_port_steps(eng, toks, lens, fed), want, "test-tiny-moe")


def _port_greedy_run(cfg, params, qcfg, fed=None):
    """The port's engine on the CPU (ARC 0.125, EKW): prefill of PROMPTS
    and STEPS decode steps, greedy or fed `fed`: (logits, tokens fed)."""
    eng = InferenceEngine(cfg, params, quantized.identity_calib(cfg, SELECT),
                          qcfg, EngineConfig(**EKW), device="cpu")
    toks, lens, _ = eng._pad_prompts(PROMPTS)
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    out, tokens = [to_numpy(logits)], []
    active = torch.as_tensor(lens > 0)
    for i in range(STEPS):
        cur = (logits.argmax(-1).to(torch.int32) if fed is None else fed[i])
        tokens.append(cur)
        logits, state = eng.decode_step(state, cur, active)
        out.append(to_numpy(logits))
    return out, tokens


def _stressed(cfg, params, fed, seed, scale=2.0 ** -8, qcfg=None):
    """_port_greedy_run (at `qcfg`, default QKW) fed `fed` with every w8
    GEMM's f32 output times (1 + scale N(0, 1)) before its rounding (the
    plain version's, on the CPU), noise drawn from `seed`."""
    real = gk.gemm_w8_plain
    gen = torch.Generator()
    gen.manual_seed(seed)

    def noisy(xa, codes, scales, gs, gw, bias, out_dtype):
        y = real(xa, codes, scales, gs, gw, bias, torch.float32)
        return (y * (1 + scale * torch.randn(y.shape, generator=gen))
                ).to(out_dtype)
    gk.gemm_w8_plain = noisy
    try:
        return _port_greedy_run(cfg, params, qcfg or QuantConfig(**QKW),
                                fed)[0]
    finally:
        gk.gemm_w8_plain = real


@pytest.mark.parametrize("name", ["test-tiny", "test-qwen-tiny"])
def test_conditioned_init_neither_amplifies_noise_nor_hides_quantization(
        name):
    """The property the init exists for, on the port's plain engine at 4
    layers, prefill and 8 decode steps: with every GEMM output perturbed
    by 2^-8 (three draws, fed the clean run's tokens) the logits stay at
    cosine >= 0.9995, and the greedy token is unchanged at every row on
    which the three draws agree (a row where one draw's token moves and
    another's does not is a tie the noise decides); on llama.init_params'
    draws the same noise drops the cosine below 0.99 (the chaotic init
    the checks were blind on). NVFP4 against BF16 on the same weights
    stays at or below 0.9995 at every step, and with the head left in
    bf16 (the layers' own quantization; the packed head's weights alone
    put 4e-3 between the two) at least 10 times the deficit of 2^-22 GEMM
    noise, the floor the chip's [conditioned] phase measures (17-27 times
    here): quantization not hidden."""
    cfg = get_model_config(name).replace(num_layers=4)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = conditioned_params(cfg, gen)
    clean, fed = _port_greedy_run(cfg, params, QuantConfig(**QKW))
    draws = [_stressed(cfg, params, fed, seed) for seed in range(3)]
    for i, ref in enumerate(clean):
        toks = np.stack([d[i].argmax(-1) for d in draws])
        agree = (toks == toks[0]).all(0)
        for d in draws:
            c = cosine(d[i], ref)
            assert c >= 0.9995, f"step {i}: 2^-8 noise cosine {c}"
        moved = agree & (toks[0] != ref.argmax(-1))
        assert not moved.any(), f"step {i}: every draw moves rows {moved}"
    bf16 = _port_greedy_run(cfg, params, QuantConfig(quant_type="BF16"),
                            fed)[0]
    apart = [cosine(a, b) for a, b in zip(clean, bf16)]
    assert max(apart) <= 0.9995, apart
    layers_only = QuantConfig(**dict(QKW, quantize_lm_head=False))
    clean, fed = _port_greedy_run(cfg, params, layers_only)
    bf16 = _port_greedy_run(cfg, params, QuantConfig(quant_type="BF16"),
                            fed)[0]
    floor = max(1 - cosine(a, b) for seed in range(3) for a, b in zip(
        _stressed(cfg, params, fed, seed, 2.0 ** -22, layers_only), clean))
    apart = [1 - cosine(a, b) for a, b in zip(clean, bf16)]
    assert min(apart) >= 10 * floor, (apart, floor)
    gen.manual_seed(0)
    chaotic = llama.init_params(cfg, gen)
    clean, fed = _port_greedy_run(cfg, chaotic, QuantConfig(**QKW))
    noisy = _stressed(cfg, chaotic, fed, 0)
    assert min(cosine(a, b) for a, b in zip(noisy, clean)) < 0.99


@pytest.mark.parametrize("name", ["test-qwen-tiny", "test-tiny-moe"])
def test_conditioned_engine_is_conditioned_params(name):
    """conditioned_engine (each layer packed as it is drawn) builds the
    engine of conditioned_params from the same seed: equal greedy
    generations and bitwise equal logits; its residual branches' output
    weights are init_layer_params' draws times branch_scale, the
    embedding of unit rms."""
    cfg = get_model_config(name)
    calib = quantized.identity_calib(cfg, SELECT)
    qcfg, ecfg = QuantConfig(**QKW), EngineConfig(**EKW)
    eng = conditioned_engine(cfg, calib, qcfg, ecfg, seed=3, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    params = conditioned_params(cfg, gen)
    ref = InferenceEngine(cfg, params, calib, qcfg, ecfg, device="cpu")
    assert eng.generate(PROMPTS, 4) == ref.generate(PROMPTS, 4)
    toks, lens, _ = eng._pad_prompts(PROMPTS)
    assert torch.equal(eng.prefill(eng.new_state(), toks, lens)[0],
                       ref.prefill(ref.new_state(), toks, lens)[0])
    gen.manual_seed(3)
    raw = llama.init_layer_params(cfg, gen)
    layer = params["layers"][0]
    outs = ([("o",), ("moe", "down"), ("moe", "sdown")] if cfg.num_experts
            else [("o",), ("down",)])
    for path in outs:
        a, b = layer, raw
        for k in path:
            a, b = a[k], b[k]
        assert torch.equal(a["w"], b["w"] * branch_scale(cfg))
    assert torch.equal(layer["q"]["w"], raw["q"]["w"])
    rms = params["embed"].float().pow(2).mean().sqrt()
    assert abs(float(rms) - 1.0) < 0.01


def test_greedy_ties_and_same_greedy():
    """A greedy token is a tie when the reference's top-2 gap is under
    2^-6 of the row's rms or a noise draw moves it; same_greedy holds
    every other row to equal tokens."""
    ref = np.array([[3.0, 1.0, 0.0, -1.0],     # decisive
                    [2.0, 2.0 - 2.0 ** -10, 0.0, -1.0],   # a tie by gap
                    [1.0, 0.5, 0.0, -1.0]])    # moved by the draw
    draw = ref.copy()
    draw[2, 1] = 1.5
    np.testing.assert_array_equal(greedy_ties(ref, [draw]),
                                  [False, True, True])
    np.testing.assert_array_equal(greedy_ties(ref), [False, True, False])
    got = ref.copy()
    got[1, 1], got[2, 1] = 3.0, 2.0              # flips at the ties only
    assert same_greedy(got, ref, [draw]) == (True, 2, 2)
    assert same_greedy(got, ref) == (False, 1, 2)
    got[0, 1] = 4.0                              # a decisive row flips
    assert not same_greedy(got, ref, [draw])[0]
