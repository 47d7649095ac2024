"""The serving slice of arcquant_tpu_torch held against the JAX engine.

Both engines run the W4A4 NVFP4 + ARC path (select_frac 0.125, w8
weights, per-row activation and per-channel weight scales, W4A16 packed
head, static pages of 16) on test-tiny and test-qwen-tiny (qkv bias)
with ragged prompts; the JAX side runs its Pallas kernels in interpret
mode. The port is built twice: from the raw params (it packs them
itself) and from the JAX engine's packed qparams. The bar is the
engine-level one of the JAX package: prefill and 8 decode steps with
logits cosine >= 0.999 and identical greedy tokens. Exact logits are
not the bar: one e2m1 boundary flip from an ulp of drift moves a logit
by O(0.1).

The params are f32, as in the JAX package's own engine tests: with
bf16 activations every GEMM output rounds to bf16, so an f32 summation
order difference becomes a bf16 ulp, and on a 39-token row of this tiny
random model that cascades into flips; the JAX engine jitted and the
same engine run eagerly then disagree with each other at logits cosine
0.98, and so does the port. bf16 is held on the card instead, by
chip_smoke.py's engine-level check at Qwen2.5-7B width.
"""

import subprocess
import sys
from pathlib import Path

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
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.models import quantized
from arcquant_tpu_torch.testing import cosine, to_numpy

PROMPTS = [[5, 17, 301, 42, 8, 9, 10], [100, 200, 7],
           list(range(1, 40)), [3]]
STEPS = 8
QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
           act_scale="row", w_scale="channel", quantize_lm_head=True)
EKW = dict(max_batch=4, max_seq_len=64, page_size=16)


@pytest.fixture(scope="module", params=["test-tiny", "test-qwen-tiny"])
def jax_run(request):
    """The JAX engine's prefill + greedy decode logits, its params."""
    name = request.param
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
    eng = JEngine(cfg, params, calib, JQuantConfig(**QKW),
                  JEngineConfig(**EKW))
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
    return dict(name=name, params=jax.tree.map(np.asarray, params),
                qparams=jax.tree.map(np.asarray, eng.qparams),
                calib=calib, toks=toks, lens=lens, logits=all_logits,
                fed=fed, generated=eng.generate(PROMPTS, STEPS))


def _port(run, route):
    cfg = get_model_config(run["name"])
    calib = convert.calib_from_numpy(run["calib"])
    if route == "raw":
        return InferenceEngine(cfg, convert.params_from_numpy(run["params"]),
                               calib, QuantConfig(**QKW), EngineConfig(**EKW),
                               device="cpu")
    return InferenceEngine(cfg, convert.qparams_from_numpy(run["qparams"]),
                           calib, QuantConfig(**QKW), EngineConfig(**EKW),
                           device="cpu", quantize_params=False)


def _assert_close(got, want, what):
    got, want = to_numpy(got), np.asarray(want)
    c = cosine(got, want)
    assert c >= 0.999, f"{what}: logits cosine {c}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=what)


@pytest.mark.parametrize("route", ["raw", "packed"])
def test_engine_matches_jax(jax_run, route):
    eng = _port(jax_run, route)
    if route == "raw":
        # the port's own packing reproduces the JAX bytes
        for a, b in zip(eng.qparams["layers"], jax_run["qparams"]["layers"]):
            np.testing.assert_array_equal(to_numpy(a["qkv"].codes),
                                          b["qkv"].codes)
            np.testing.assert_array_equal(to_numpy(a["down"].scales),
                                          b["down"].scales)
    logits, state = eng.prefill(eng.new_state(), jax_run["toks"],
                                jax_run["lens"])
    _assert_close(logits, jax_run["logits"][0], "prefill")
    active = torch.as_tensor(jax_run["lens"] > 0)
    for i, cur in enumerate(jax_run["fed"]):
        logits, state = eng.decode_step(state, torch.tensor(cur), active)
        _assert_close(logits, jax_run["logits"][i + 1], f"decode step {i}")
    assert state[2].tolist() == (jax_run["lens"] + STEPS).tolist()


def test_generate_and_decode_scan_match_jax(jax_run):
    eng = _port(jax_run, "packed")
    assert eng.generate(PROMPTS, STEPS) == jax_run["generated"]
    logits, state = eng.prefill(eng.new_state(), jax_run["toks"],
                                jax_run["lens"])
    first = logits.argmax(-1).to(torch.int32)
    toks, _ = eng.decode_scan(state, first, torch.as_tensor(
        jax_run["lens"] > 0), STEPS - 1)
    for i, gen in enumerate(jax_run["generated"]):
        assert [int(first[i])] + toks[i].tolist() == gen


def test_outside_the_slice_raises():
    """The settings the engine once refused now run (use_kernels=False,
    act_scale "tensor", BF16 on an MoE config: their parity is
    tests/test_torch_engine_fake.py's); what the JAX engine lacks too
    still raises, and so do the batcher's bad windows and a CUDA device
    where there is none."""
    cfg = get_model_config("test-tiny")
    calib = quantized.identity_calib(cfg)
    moe = get_model_config("test-tiny-moe")
    for c, ok in ((cfg, dict(use_kernels=False)),
                  (cfg, dict(act_scale="tensor")),
                  (moe, dict(quant_type="BF16"))):
        eng = InferenceEngine.dummy(c, quantized.identity_calib(c),
                                    QuantConfig(**{**QKW, **ok}),
                                    EngineConfig(**EKW), device="cpu")
        out = eng.generate([[5, 17, 301], [7]], 3)
        assert [len(o) for o in out] == [3, 3]
    for bad, err in ((dict(weight_fmt="w2"), ValueError),
                     (dict(act_scale="group"), ValueError),
                     (dict(quant_type="FP8"), ValueError),
                     (dict(act_bits=8), NotImplementedError)):
        with pytest.raises(err):
            InferenceEngine.dummy(cfg, calib, QuantConfig(**{**QKW, **bad}),
                                  EngineConfig(**EKW), device="cpu")
    eng = InferenceEngine.dummy(cfg, calib, QuantConfig(**QKW),
                                EngineConfig(**EKW), device="cpu")
    from arcquant_tpu_torch.engine import ContinuousBatcher
    # speculative batching is ported: a window below 2 and one beside a
    # decode burst are refused
    for kw in (dict(spec_window=1), dict(spec_window=3, decode_burst=4)):
        with pytest.raises(ValueError):
            ContinuousBatcher(eng, **kw)
    if not torch.cuda.is_available():
        # the entry points default to the card and never fall back
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine.dummy(cfg, calib, QuantConfig(**QKW),
                                  EngineConfig(**EKW))


def test_port_runs_without_jax():
    """Importing arcquant_tpu_torch, generating with a tiny dummy engine,
    a select-free decode at batch 4 through the fused routes, generating
    with a tiny MoE engine (in dispatch and dense mode), serving two
    HTTP requests through ServingLoop, calibrating (python -m
    arcquant_tpu_torch.calibrate --cpu), loading a checkpoint directory,
    saving and loading a quantized checkpoint, and the tools
    (evals/visualize.py's measure_mse, bench_serving.run --cpu at 1
    layer, mse_table, decode_profile and prefill_profile imported) load
    neither jax nor the JAX package, with safetensors, transformers and
    matplotlib blocked (the card's machine has none of them):
    load_tokenizer then raises ImportError."""
    code = (
        "import sys, torch\n"
        "sys.modules['safetensors'] = sys.modules['transformers'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "from arcquant_tpu_torch.config import QuantConfig, get_model_config\n"
        "from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine\n"
        "from arcquant_tpu_torch.models import quantized\n"
        "torch.set_num_threads(1)\n"
        "cfg = get_model_config('test-qwen-tiny').replace(num_layers=1)\n"
        "eng = InferenceEngine.dummy(\n"
        "    cfg, quantized.identity_calib(cfg, 0.125),\n"
        "    QuantConfig(w_scale='channel', act_scale='row',\n"
        "                quantize_lm_head=True),\n"
        "    EngineConfig(max_batch=2, max_seq_len=32, page_size=16,\n"
        "                 dynamic_pages=True, prefill_chunk=16,\n"
        "                 prefix_sharing=True), device='cpu')\n"
        "out = eng.generate([[1, 2, 3], [4]], 3)\n"
        "assert len(out) == 2 and all(len(o) == 3 for o in out), out\n"
        "from arcquant_tpu_torch.kernels import mlp_fused as mf\n"
        "calls = []\n"
        "real = mf.mlp_w8_fused\n"
        "mf.mlp_w8_fused = lambda *a, **k: calls.append(1) or real(*a, **k)\n"
        "free = InferenceEngine.dummy(\n"
        "    cfg, quantized.identity_calib(cfg, 0.0),\n"
        "    QuantConfig(w_scale='channel', act_scale='row',\n"
        "                quantize_lm_head=True),\n"
        "    EngineConfig(max_batch=4, max_seq_len=32, page_size=16),\n"
        "    device='cpu')\n"
        "out = free.generate([[1] * 20, [2], [3, 4], [5]], 2)\n"
        "assert [len(o) for o in out] == [2] * 4 and calls == [1, 1], calls\n"
        "mcfg = get_model_config('test-tiny-moe').replace(num_layers=1)\n"
        "moe_eng = InferenceEngine.dummy(\n"
        "    mcfg, quantized.identity_calib(mcfg, 0.5),\n"
        "    QuantConfig(w_scale='channel', act_scale='row',\n"
        "                quantize_lm_head=True, weight_fmt='w4'),\n"
        "    EngineConfig(max_batch=2, max_seq_len=160, page_size=16),\n"
        "    device='cpu')\n"
        "out = moe_eng.generate([list(range(1, 140)), [4]], 2)\n"
        "assert [len(o) for o in out] == [2, 2], out\n"
        "import http.client, json, threading\n"
        "from arcquant_tpu_torch.engine import ContinuousBatcher\n"
        "from arcquant_tpu_torch.engine.server import ServingLoop, make_server\n"
        "loop = ServingLoop(ContinuousBatcher(eng))\n"
        "srv = make_server(loop, port=0)\n"
        "threading.Thread(target=srv.serve_forever, daemon=True).start()\n"
        "res = []\n"
        "def post(p):\n"
        "    c = http.client.HTTPConnection('127.0.0.1', srv.server_address[1],\n"
        "                                   timeout=120)\n"
        "    c.request('POST', '/v1/completions',\n"
        "              json.dumps({'prompt': p, 'max_tokens': 3}))\n"
        "    r = c.getresponse()\n"
        "    res.append((r.status, json.loads(r.read())))\n"
        "ts = [threading.Thread(target=post, args=(p,))\n"
        "      for p in ([1, 2, 3] * 7, [4])]\n"
        "[t.start() for t in ts]\n"
        "[t.join(120) for t in ts]\n"
        "srv.shutdown(); loop.shutdown()\n"
        "assert [s for s, _ in res] == [200, 200], res\n"
        "assert all(len(o['tokens']) == 3 for _, o in res), res\n"
        "from arcquant_tpu_torch.benchmarks import benchmark_e2e\n"
        "from arcquant_tpu_torch.benchmarks import bench_gemm, gemm_lab\n"
        "r = benchmark_e2e.run(benchmark_e2e.build_parser().parse_args(\n"
        "    ['--model', 'test-tiny', '--layers', '1', '--prefill_seq_len',\n"
        "     '8', '--decode_steps', '1', '--warmup', '0', '--repeats', '1',\n"
        "     '--quant', 'BF16', '--cpu']))\n"
        "assert r['_tokens_valid'], r\n"
        "import contextlib, io, json, os, tempfile\n"
        "quiet = contextlib.redirect_stdout(io.StringIO())\n"
        "from arcquant_tpu_torch import calibrate, generate\n"
        "from arcquant_tpu_torch.calib import load_calibration\n"
        "from arcquant_tpu_torch.models import hf, llama\n"
        "from arcquant_tpu_torch.utils import load_quantized, save_quantized\n"
        "from arcquant_tpu_torch.utils.safetensors_io import write_safetensors\n"
        "tmp = tempfile.mkdtemp()\n"
        "with quiet:\n"
        "    c = calibrate.main(['--model', 'test-qwen-tiny', '--samples',\n"
        "                        '2', '--seqlen', '32', '--output', tmp,\n"
        "                        '--cpu'])\n"
        "calib = load_calibration(c['path'])\n"
        "assert [l['down_in'].select_num for l in calib] == [\n"
        "    l['down_in'].select_num for l in c['calib']]\n"
        "g = torch.Generator(); g.manual_seed(0)\n"
        "p = llama.init_params(cfg, g)\n"
        "t = {'model.embed_tokens.weight': p['embed'],\n"
        "     'model.norm.weight': p['final_norm'],\n"
        "     'lm_head.weight': p['lm_head']}\n"
        "names = {'attn_norm': 'input_layernorm',\n"
        "         'mlp_norm': 'post_attention_layernorm'}\n"
        "for k, v in p['layers'][0].items():\n"
        "    pre = 'model.layers.0.' + names.get(k, ('self_attn.' if k in 'qkvo'\n"
        "                                            else 'mlp.') + k + '_proj')\n"
        "    if torch.is_tensor(v):\n"
        "        t[pre + '.weight'] = v\n"
        "    else:\n"
        "        t.update({pre + ('.weight' if n == 'w' else '.bias'): w\n"
        "                  for n, w in v.items()})\n"
        "d = os.path.join(tmp, 'ckpt')\n"
        "os.makedirs(d)\n"
        "write_safetensors(os.path.join(d, 'model.safetensors'), t)\n"
        "json.dump(dict(model_type='qwen2', vocab_size=cfg.vocab_size,\n"
        "               hidden_size=cfg.hidden_size,\n"
        "               intermediate_size=cfg.intermediate_size,\n"
        "               num_hidden_layers=1, num_attention_heads=cfg.num_heads,\n"
        "               num_key_value_heads=cfg.num_kv_heads,\n"
        "               rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,\n"
        "               max_position_embeddings=512),\n"
        "          open(os.path.join(d, 'config.json'), 'w'))\n"
        "hcfg, hp = hf.load_hf_params(d, device='cpu')\n"
        "assert torch.equal(hp['layers'][0]['q']['b'], p['layers'][0]['q']['b'])\n"
        "with contextlib.redirect_stdout(io.StringIO()) as out:\n"
        "    generate.main(['--model', d, '--tokens', '1,2,3', '--max_new',\n"
        "                   '2', '--calib', c['path'], '--cpu'])\n"
        "assert len(json.loads(out.getvalue().split('] ')[1])) == 2\n"
        "heng = InferenceEngine(hcfg, hp, calib[:1], QuantConfig(\n"
        "    w_scale='channel', act_scale='row', quantize_lm_head=True),\n"
        "    EngineConfig(max_batch=2, max_seq_len=32, page_size=16),\n"
        "    device='cpu')\n"
        "save_quantized(os.path.join(tmp, 'q.safetensors'), heng.qparams)\n"
        "back = load_quantized(os.path.join(tmp, 'q.safetensors'), 'cpu')\n"
        "assert torch.equal(back['layers'][0]['qkv'].codes,\n"
        "                   heng.qparams['layers'][0]['qkv'].codes)\n"
        "try:\n"
        "    hf.load_tokenizer(d)\n"
        "    raise AssertionError('load_tokenizer without transformers')\n"
        "except ImportError as e:\n"
        "    assert 'transformers' in str(e), e\n"
        "from arcquant_tpu_torch.evals import visualize\n"
        "from arcquant_tpu_torch.benchmarks import (bench_serving,\n"
        "    decode_profile, mse_table, prefill_profile)\n"
        "x, _, ridx = mse_table.inputs(8, 4, 256)\n"
        "assert set(visualize.measure_mse(x, ridx, 64)) == {\n"
        "    'nvfp4', 'hadamard', 'arc'}\n"
        "r = bench_serving.run(bench_serving.build_parser().parse_args(\n"
        "    ['--model', 'test-tiny', '--layers', '1', '--max_batch', '2',\n"
        "     '--requests', '2', '--prompt_len', '8', '--max_new', '2',\n"
        "     '--cpu']))\n"
        "assert all(len(q.output) == 2 for q in r['_requests']), r\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'jax' or m.startswith(('jax.', 'arcquant_tpu.'))\n"
        "       or m == 'arcquant_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
