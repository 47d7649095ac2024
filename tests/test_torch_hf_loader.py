"""The HF checkpoint loader of arcquant_tpu_torch (models/hf.py), its
safetensors reader and writer (utils/safetensors_io.py), and the entry
points on a checkpoint directory, held against the JAX package's loader
and the ``safetensors`` package on small random checkpoints written to
a temporary directory (dense Llama with and without qkv bias, tied and
untied heads, names with and without the "model." prefix, Mixtral and
Qwen-MoE experts).

- the reader gives safe_open's tensors, the writer's files open in
  safe_open (dtypes, 0-d tensors, metadata);
- load_hf_params gives the JAX package's arrays bitwise (f32 and bf16),
  and the dense forward on them matches the JAX package's;
- load_tokenizer reads a toy tokenizer built with ``tokenizers``, and
  with transformers missing raises ImportError naming it;
- calibrate, serve, evaluate and generate --prompt on a directory, on
  the CPU (--cpu).
"""

import contextlib
import http.client
import io
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_file_torch

from arcquant_tpu.models import hf as jhf
from arcquant_tpu.models import llama as jllama
from arcquant_tpu_torch import calibrate, evaluate, generate, serve
from arcquant_tpu_torch.calib import compute_calibration, load_calibration
from arcquant_tpu_torch.config import get_model_config
from arcquant_tpu_torch.engine import (ContinuousBatcher, EngineConfig,
                                       InferenceEngine, Request)
from arcquant_tpu_torch.engine.server import make_server
from arcquant_tpu_torch.evals import eval_ppl, get_calib_samples
from arcquant_tpu_torch.evals import synthetic_stream
from arcquant_tpu_torch.models import hf, llama, quantized
from arcquant_tpu_torch.testing import cosine, to_numpy
from arcquant_tpu_torch.utils.safetensors_io import (read_safetensors,
                                                     write_safetensors)

TINY = "test-tiny"
MOE = "test-tiny-moe"


def _rand(rng, *shape):
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _checkpoint(cfg, style="llama", bias=False, tied=False, prefix=True,
                seed=0):
    """{name: f32 array} and config.json of a one-directory checkpoint of
    cfg's shapes; style llama (dense), mixtral or qwen_moe."""
    rng = np.random.default_rng(seed)
    d, m = cfg.hidden_size, "model." if prefix else ""
    t = {f"{m}embed_tokens.weight": _rand(rng, cfg.vocab_size, d),
         f"{m}norm.weight": 1 + _rand(rng, d)}
    for i in range(cfg.num_layers):
        pre = f"{m}layers.{i}"
        t[f"{pre}.input_layernorm.weight"] = 1 + _rand(rng, d)
        t[f"{pre}.post_attention_layernorm.weight"] = 1 + _rand(rng, d)
        for p, n in (("q", cfg.q_size), ("k", cfg.kv_size),
                     ("v", cfg.kv_size)):
            t[f"{pre}.self_attn.{p}_proj.weight"] = _rand(rng, n, d)
            if bias:
                t[f"{pre}.self_attn.{p}_proj.bias"] = _rand(rng, n)
        t[f"{pre}.self_attn.o_proj.weight"] = _rand(rng, d, cfg.q_size)
        if style == "llama":
            f = cfg.intermediate_size
            t[f"{pre}.mlp.gate_proj.weight"] = _rand(rng, f, d)
            t[f"{pre}.mlp.up_proj.weight"] = _rand(rng, f, d)
            t[f"{pre}.mlp.down_proj.weight"] = _rand(rng, d, f)
            continue
        e, f = cfg.num_experts, cfg.moe_intermediate_size
        mpre = pre + (".block_sparse_moe" if style == "mixtral" else ".mlp")
        names = (("w1", "w3", "w2") if style == "mixtral"
                 else ("gate_proj", "up_proj", "down_proj"))
        t[f"{mpre}.gate.weight"] = _rand(rng, e, d)
        for ei in range(e):
            t[f"{mpre}.experts.{ei}.{names[0]}.weight"] = _rand(rng, f, d)
            t[f"{mpre}.experts.{ei}.{names[1]}.weight"] = _rand(rng, f, d)
            t[f"{mpre}.experts.{ei}.{names[2]}.weight"] = _rand(rng, d, f)
        if style == "qwen_moe":
            fs = cfg.shared_expert_size
            t[f"{mpre}.shared_expert.gate_proj.weight"] = _rand(rng, fs, d)
            t[f"{mpre}.shared_expert.up_proj.weight"] = _rand(rng, fs, d)
            t[f"{mpre}.shared_expert.down_proj.weight"] = _rand(rng, d, fs)
            t[f"{mpre}.shared_expert_gate.weight"] = _rand(rng, 1, d)
    if not tied:
        t["lm_head.weight"] = _rand(rng, cfg.vocab_size, d)
    cj = dict(vocab_size=cfg.vocab_size, hidden_size=d,
              intermediate_size=cfg.intermediate_size,
              num_hidden_layers=cfg.num_layers,
              num_attention_heads=cfg.num_heads,
              num_key_value_heads=cfg.num_kv_heads, rope_theta=10000.0,
              rms_norm_eps=1e-5, max_position_embeddings=512,
              tie_word_embeddings=tied,
              model_type={"llama": "qwen2" if bias else "llama",
                          "mixtral": "mixtral",
                          "qwen_moe": "qwen2_moe"}[style])
    if style == "mixtral":
        cj.update(num_local_experts=cfg.num_experts,
                  num_experts_per_tok=cfg.num_experts_per_tok,
                  intermediate_size=cfg.moe_intermediate_size)
    elif style == "qwen_moe":
        cj.update(num_experts=cfg.num_experts,
                  num_experts_per_tok=cfg.num_experts_per_tok,
                  moe_intermediate_size=cfg.moe_intermediate_size,
                  shared_expert_intermediate_size=cfg.shared_expert_size,
                  norm_topk_prob=True)
    return t, cj


def _write(path, tensors, cfg_json, shards=1):
    path.mkdir(parents=True, exist_ok=True)
    names = list(tensors)
    for s in range(shards):
        save_file({k: tensors[k] for k in names[s::shards]},
                  str(path / f"model-{s + 1:05d}-of-{shards:05d}"
                      ".safetensors"))
    (path / "config.json").write_text(json.dumps(cfg_json))
    return str(path)


def _toy_tokenizer(path, vocab_size):
    """A word-level tokenizer whose words w<i> are the ids i (eos </s> 1),
    in transformers' PreTrainedTokenizerFast files."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {"<unk>": 0, "</s>": 1}
    vocab.update({f"w{i}": i for i in range(2, vocab_size)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "</s>",
         "unk_token": "<unk>"}))


def _leaves(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{name}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{name}/{i}")
    else:
        yield name, tree


def test_reader_matches_safe_open(tmp_path):
    rng = np.random.default_rng(0)
    want = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.integers(-9, 9, (7,)).astype(np.int8),
            "c": rng.integers(0, 255, (2, 2, 2)).astype(np.uint8),
            "d": np.asarray(3.5, np.float64),
            "e": rng.integers(0, 1 << 30, (4,)).astype(np.int64),
            "f": rng.standard_normal((6,)).astype(np.float16),
            "g": np.zeros((0, 3), np.int32),
            "h": rng.random(5) > 0.5}
    save_file(want, str(tmp_path / "n.safetensors"), metadata={"k": "v"})
    got, meta = read_safetensors(str(tmp_path / "n.safetensors"))
    assert meta == {"k": "v"} and set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)
    bf = torch.randn(4, 9).to(torch.bfloat16)
    save_file_torch({"w": bf, "x": torch.tensor(2.0)},
                    str(tmp_path / "t.safetensors"))
    got, meta = read_safetensors(str(tmp_path / "t.safetensors"))
    assert meta == {} and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), bf.view(torch.int16))
    assert got["x"].shape == () and float(got["x"]) == 2.0
    head = json.dumps({"a": {"dtype": "F32", "shape": [4],
                             "data_offsets": [0, 16]}}).encode().ljust(64)
    (tmp_path / "bad.safetensors").write_bytes(   # 8 of the 16 bytes
        len(head).to_bytes(8, "little") + head + bytes(8))
    with pytest.raises(ValueError, match="offsets"):
        read_safetensors(str(tmp_path / "bad.safetensors"))


def test_writer_opens_in_safe_open(tmp_path):
    rng = np.random.default_rng(1)
    want = {"w": torch.randn(5, 3).to(torch.bfloat16),
            "codes": torch.from_numpy(rng.integers(-8, 8, (64, 4)).astype(
                np.int8)),
            "scales": torch.from_numpy(rng.integers(0, 255, (4, 4)).astype(
                np.uint8)),
            "gs": torch.tensor(0.25), "n": torch.arange(6, dtype=torch.int32),
            "m": torch.ones(3, dtype=torch.bool),
            "t": torch.randn(2, 6).t()}     # not contiguous
    path = str(tmp_path / "w.safetensors")
    write_safetensors(path, want, {"tree": "{}"})
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"tree": "{}"}
        assert sorted(f.keys()) == sorted(want)
        for k, v in want.items():
            got = f.get_tensor(k)
            assert got.dtype == v.dtype and got.shape == v.shape
            assert torch.equal(got, v)
    back, meta = read_safetensors(path)
    assert meta == {"tree": "{}"}
    assert all(torch.equal(back[k], v) for k, v in want.items())


CASES = {"llama": dict(style="llama"),
         "qwen2_bias_tied_noprefix": dict(style="llama", bias=True,
                                          tied=True, prefix=False),
         "mixtral": dict(style="mixtral"),
         "qwen_moe": dict(style="qwen_moe", bias=True)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_load_hf_params_matches_jax(tmp_path, case, dtype):
    kw = CASES[case]
    cfg0 = get_model_config(TINY if kw["style"] == "llama" else MOE)
    t, cj = _checkpoint(cfg0.replace(num_layers=2), **kw)
    d = _write(tmp_path / case, t, cj, shards=2)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jcfg, jparams = jhf.load_hf_params(d, dtype=jdt)
    cfg, params = hf.load_hf_params(d, dtype=tdt, device="cpu")
    assert cfg == hf.load_hf_config(d)
    for field in ("num_layers", "qkv_bias", "tie_embeddings", "num_experts",
                  "moe_intermediate_size", "shared_expert_size",
                  "norm_topk_prob", "num_kv_heads"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert ("lm_head" in params) == (not kw.get("tied"))
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    got = dict(_leaves(params))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == tdt and g.device.type == "cpu", name
        if dtype == "bf16":
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if cfg.num_experts:
        lp = params["layers"][0]["moe"]
        assert lp["gate"]["w"].shape == (cfg.num_experts,
                                         cfg.moe_intermediate_size,
                                         cfg.hidden_size)
        assert lp["down"]["w"].shape == (cfg.num_experts, cfg.hidden_size,
                                         cfg.moe_intermediate_size)
        return
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    got = llama.model_forward(cfg, params, torch.from_numpy(toks))
    want = jllama.model_forward(jcfg, jparams, jnp.asarray(toks))
    want = np.asarray(want, np.float32)
    assert cosine(to_numpy(got), want) >= 0.999
    np.testing.assert_array_equal(to_numpy(got).argmax(-1), want.argmax(-1))


def test_moe_checkpoint_serves(tmp_path):
    """A loaded Qwen-MoE checkpoint is the layout the port's packed MoE
    engine takes: it generates."""
    cfg0 = get_model_config(MOE).replace(num_layers=1)
    t, cj = _checkpoint(cfg0, style="qwen_moe", bias=True)
    cfg, params = hf.load_hf_params(_write(tmp_path, t, cj), device="cpu")
    from arcquant_tpu_torch.config import QuantConfig
    eng = InferenceEngine(
        cfg, params, quantized.identity_calib(cfg, 0.5),
        QuantConfig(act_scale="row", w_scale="channel",
                    quantize_lm_head=True),
        EngineConfig(max_batch=2, max_seq_len=32, page_size=16),
        device="cpu")
    out = eng.generate([[1, 2, 3], [4]], 3)
    assert [len(o) for o in out] == [3, 3]


def test_load_hf_errors(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="config.json"):
        hf.load_hf_params(str(tmp_path), device="cpu")
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="safetensors"):
        hf._load_shards(str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            hf.load_hf_params(str(tmp_path))
    _toy_tokenizer(tmp_path, 16)
    tok = hf.load_tokenizer(str(tmp_path))
    assert tok.encode("w5 w7 w2") == [5, 7, 2] and tok.eos_token_id == 1
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        hf.load_tokenizer(str(tmp_path))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A Qwen2-style test-tiny checkpoint (qkv bias, untied head) with a
    toy tokenizer."""
    d = tmp_path_factory.mktemp("qwen_tiny")
    t, cj = _checkpoint(get_model_config(TINY), bias=True, seed=4)
    _write(d, t, cj)
    _toy_tokenizer(d, get_model_config(TINY).vocab_size)
    return d


def test_calibrate_and_evaluate_a_directory(ckpt_dir, tmp_path, capsys,
                                            monkeypatch):
    """calibrate --cpu on a directory equals compute_calibration on its
    loaded params; evaluate --cpu on the directory with that artifact
    prints eval_ppl of the same quantized params."""
    d = str(ckpt_dir)
    r = calibrate.main(["--model", d, "--samples", "4", "--seqlen", "64",
                        "--output", str(tmp_path), "--cpu"])
    path = tmp_path / f"{ckpt_dir.name}_calib_synthetic_max.npz"
    assert r["path"] == str(path)
    cfg, params = hf.load_hf_params(d, device="cpu")
    want, _, _ = compute_calibration(
        cfg, params, get_calib_samples("synthetic", None, 4, 64,
                                       cfg.vocab_size, 0),
        select_batch=32, device="cpu")
    got = load_calibration(str(path))
    for a, b in zip(got, want):
        for site in b:
            assert a[site].select_num == b[site].select_num
            assert torch.equal(a[site].reorder_index, b[site].reorder_index)
    monkeypatch.chdir(tmp_path)
    out = evaluate.main(["--model", d, "--eval_ppl", "--seqlen", "64",
                         "--ntokens", "256", "--calib", str(path),
                         "--use_kernels", "--act_scale", "row", "--cpu"])
    from arcquant_tpu_torch.config import QuantConfig
    qcfg = QuantConfig(use_kernels=True, act_scale="row")
    qp = quantized.quantize_model_params(cfg, params, got, qcfg)
    want_ppl = eval_ppl(cfg, qp, synthetic_stream(cfg.vocab_size, 256, 0),
                        64, qcfg, got)
    assert out["ppl"] == want_ppl
    assert f"Result,synthetic,{want_ppl}" in capsys.readouterr().out


def test_generate_prompt_from_a_directory(ckpt_dir):
    """generate --prompt: the tokenizer encodes the texts, the batcher
    stops at its eos, and the outputs print decoded; the tokens are the
    engine's on the loaded weights."""
    d = str(ckpt_dir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        generate.main(["--model", d, "--prompt", "w5 w17 w301",
                       "--prompt", "w9 w8", "--tokens", "3,4",
                       "--max_new", "6", "--cpu"])
    lines = buf.getvalue().splitlines()
    args = generate.build_parser().parse_args(["--model", d, "--cpu"])
    cfg, params = hf.load_hf_params(d, device="cpu")
    tok = hf.load_tokenizer(d)
    eng = InferenceEngine(cfg, params, quantized.identity_calib(cfg, 0.125),
                          generate.qcfg_of(args),
                          EngineConfig(max_batch=4, max_seq_len=2048),
                          device="cpu")
    bat = ContinuousBatcher(eng)
    reqs = [Request(prompt=p, max_new_tokens=6, eos_id=1)
            for p in ([5, 17, 301], [9, 8], [3, 4])]
    for r in reqs:
        bat.submit(r)
    bat.run()
    assert [ln.split("] ", 1)[1] for ln in lines] == [
        tok.decode(r.output) for r in reqs]
    with pytest.raises(ValueError, match="HF model dir"):
        generate.main(["--model", TINY, "--prompt", "w5", "--cpu"])


def test_serve_a_directory(ckpt_dir):
    """serve's build_loop on a directory and its tokenizer: a text prompt
    and a token-id prompt over HTTP, the text decoded."""
    args = serve.build_parser().parse_args(
        ["--model", str(ckpt_dir), "--cpu", "--max_batch", "2",
         "--max_seq_len", "64", "--prefill_chunk", "16"])
    loop = serve.build_loop(args)
    tok = serve.build_tokenizer(args)
    assert tok is not None
    assert serve.build_tokenizer(serve.build_parser().parse_args(
        ["--model", TINY])) is None
    srv = make_server(loop, port=0, tokenizer=tok)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        res = []
        for prompt in ("w5 w17 w301", [5, 17, 301]):
            c = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                           timeout=120)
            c.request("POST", "/v1/completions",
                      json.dumps({"prompt": prompt, "max_tokens": 3}))
            r = c.getresponse()
            res.append((r.status, json.loads(r.read())))
            c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        loop.shutdown()
    assert [s for s, _ in res] == [200, 200]
    assert res[0][1]["tokens"] == res[1][1]["tokens"]
    assert res[0][1]["text"] == tok.decode(res[0][1]["tokens"])
