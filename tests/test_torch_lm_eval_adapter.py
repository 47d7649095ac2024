"""The lm-eval-harness adapter of arcquant_tpu_torch
(evals/lm_eval_adapter.py) held against the JAX package's, through a stub
lm_eval package (the real one is not installed and nothing is
downloaded): the LM API's loglikelihood against the task harness's own
scorer, rolling windows, generate_until's stop strings, the next-token
function; then ``evaluate --lm_eval`` through the stub on an HF
directory, and the argument lists of arcquant_tpu_torch/evaluate.sh
parsed by the port's evaluate parser."""

import json
import re
import shlex
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.evals import lm_eval_adapter as JA
from arcquant_tpu.models import llama as jllama
from arcquant_tpu_torch import convert, evaluate
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.evals import lm_eval_adapter as A
from arcquant_tpu_torch.evals import tasks as T
from arcquant_tpu_torch.models import hf, llama, quantized
from arcquant_tpu_torch.utils.safetensors_io import write_safetensors

NAME = "test-tiny"
REQS = [("the quick brown", " fox jumps"), ("hello", " world"),
        ("", " unconditioned start")]


class _Tok:
    """Toy word tokenizer (deterministic within a process)."""
    bos_token_id = 1

    def encode(self, text):
        return [2 + (hash(w) % 400) for w in text.split()]

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids)


class _Req:
    def __init__(self, *args):
        self.args = args


@pytest.fixture(scope="module")
def model():
    """test-tiny f32 params in both packages."""
    jparams = jllama.init_params(jax_model_config(NAME),
                                 jax.random.PRNGKey(0), jnp.float32)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return get_model_config(NAME), params, jax_model_config(NAME), jparams


@pytest.fixture()
def stub_lm_eval(monkeypatch):
    """A minimal lm_eval: api.model.LM, and simple_evaluate scoring two
    loglikelihood requests a task."""
    pkg = types.ModuleType("lm_eval")
    api = types.ModuleType("lm_eval.api")
    mdl = types.ModuleType("lm_eval.api.model")

    class LM:
        def __init__(self):
            pass

    def simple_evaluate(model, tasks):
        res = {}
        for task in tasks:
            out = model.loglikelihood([_Req("a b", " c"), _Req(task, " d")])
            res[task] = {"ll": sum(ll for ll, _ in out),
                         "greedy": sum(g for _, g in out)}
        return {"results": res}

    mdl.LM = LM
    api.model = mdl
    pkg.api = api
    pkg.simple_evaluate = simple_evaluate
    monkeypatch.setitem(sys.modules, "lm_eval", pkg)
    monkeypatch.setitem(sys.modules, "lm_eval.api", api)
    monkeypatch.setitem(sys.modules, "lm_eval.api.model", mdl)
    return pkg


def test_loglikelihood_matches_direct_scorer(model, stub_lm_eval):
    cfg, params, jcfg, jparams = model
    lm = A.make_lm(cfg, params, None, None, _Tok(), batch_size=2, max_len=64)
    out = lm.loglikelihood([_Req(*r) for r in REQS])
    assert len(out) == 3
    for ll, greedy in out:
        assert np.isfinite(ll) and ll < 0
        assert isinstance(greedy, bool)
    tok = _Tok()
    ctx = tok.encode("the quick brown")
    cont = tok.encode("the quick brown fox jumps")[len(ctx):]
    sc = A._Scorer(cfg, params, None, None, batch_size=2, max_len=64)
    (ll0, g0), = sc.score([(ctx, cont)])
    assert abs(out[0][0] - ll0) < 1e-3 and out[0][1] == g0
    # the JAX adapter on the same requests
    want = JA.make_lm(jcfg, jparams, None, None, _Tok(), batch_size=2,
                      max_len=64).loglikelihood([_Req(*r) for r in REQS])
    for (a, ga), (b, gb) in zip(out, want):
        assert abs(a - b) < 1e-3 and ga == gb


def test_rolling_equals_split_sum(model):
    """Rolling logprob over a stream equals a direct score when one
    window holds it, and the JAX adapter's when it takes several."""
    cfg, params, jcfg, jparams = model
    sc = A._Scorer(cfg, params, None, None, batch_size=2, max_len=64)
    stream = list(range(5, 25))
    (direct, _), = sc.score([([1], stream)])
    rolled, = sc.score_rolling([stream], bos_id=1)
    assert abs(direct - rolled) < 1e-3
    sc2 = A._Scorer(cfg, params, None, None, batch_size=2, max_len=16)
    rolled2, = sc2.score_rolling([stream], bos_id=1)
    want, = JA._Scorer(jcfg, jparams, None, None, batch_size=2,
                       max_len=16).score_rolling([stream], bos_id=1)
    assert np.isfinite(rolled2) and abs(rolled2 - want) < 1e-3


def test_generate_until_stops_on_string(model, stub_lm_eval):
    cfg, params, jcfg, jparams = model
    req = [_Req("a b c", {"until": [" "], "max_gen_toks": 3})]
    outs = A.make_lm(cfg, params, None, None, _Tok(), batch_size=2,
                     max_len=64).generate_until(req)
    assert len(outs) == 1 and " " not in outs[0]
    assert outs == JA.make_lm(jcfg, jparams, None, None, _Tok(),
                              batch_size=2, max_len=64).generate_until(req)


def test_next_token_fn_greedy(model):
    cfg, params, jcfg, jparams = model
    toks = np.random.RandomState(0).randint(2, 100, (2, 16)).astype(np.int32)
    lens = np.asarray([16, 8], np.int32)
    got = A.make_next_token_fn(cfg, params, None, None)(
        torch.from_numpy(toks), torch.from_numpy(lens))
    logits = llama.model_forward(cfg, params, torch.from_numpy(toks))
    assert got.tolist() == [int(logits[0, 15].argmax()),
                            int(logits[1, 7].argmax())]
    want = JA.make_next_token_fn(jcfg, jparams, None, None)(
        jnp.asarray(toks), jnp.asarray(lens))
    assert got.tolist() == np.asarray(want).tolist()


def test_packed_route_matches_task_scorer(model, stub_lm_eval):
    """On the packed NVFP4 route (the kernels' plain versions here), the
    LM's loglikelihood is tasks.py's scorer on the same token sequences,
    in the same padded batches."""
    cfg, params, _, _ = model
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       act_scale="row")
    calib = quantized.identity_calib(cfg, 0.125)
    qp = quantized.quantize_model_params(cfg, params, calib, qcfg)
    lm = A.make_lm(cfg, qp, calib, qcfg, _Tok(), batch_size=4, max_len=64)
    out = lm.loglikelihood([_Req(*r) for r in REQS])
    sc = A._Scorer(cfg, qp, calib, qcfg, batch_size=4, max_len=64)
    tok = _Tok()
    rows = []
    for ctx, cont in REQS:
        ctx_t = tok.encode(ctx) if ctx else [1]
        rows.append((ctx_t + tok.encode(ctx + cont)[len(ctx_t):],
                     len(ctx_t)))
    order = sorted(range(len(rows)), key=lambda i: len(rows[i][0]))
    batch = [rows[i] for i in order] + [([0, 0], 1)]
    want = T.make_loglikelihood_fn(cfg, qp, qcfg, calib)(
        *sc._pad_batch(batch)).numpy()
    for j, i in enumerate(order):
        assert out[i][0] == pytest.approx(float(want[j]), abs=1e-5)


def _hf_dir(path, params, cfg):
    names = {"attn_norm": "input_layernorm",
             "mlp_norm": "post_attention_layernorm",
             "q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    t = {"model.embed_tokens.weight": params["embed"],
         "model.norm.weight": params["final_norm"]}
    for i, lp in enumerate(params["layers"]):
        for k, v in lp.items():
            t[f"model.layers.{i}.{names[k]}.weight"] = (
                v if torch.is_tensor(v) else v["w"])
    if "lm_head" in params:
        t["lm_head.weight"] = params["lm_head"]
    path.mkdir()
    write_safetensors(str(path / "model.safetensors"),
                      {k: v.contiguous() for k, v in t.items()})
    (path / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_eps, max_position_embeddings=512,
        tie_word_embeddings="lm_head" not in params)))
    return str(path)


def test_evaluate_lm_eval_entry_point(model, stub_lm_eval, tmp_path,
                                      monkeypatch, capsys):
    """evaluate --lm_eval on an HF directory prints an LmEval line a task
    with the stub harness's metrics over the adapter; without lm_eval it
    exits naming the package, and on a registry name naming the
    directory it needs."""
    cfg, params, _, _ = model
    d = _hf_dir(tmp_path / "ckpt", params, cfg)
    monkeypatch.setattr(hf, "load_tokenizer", lambda _: _Tok())
    monkeypatch.chdir(tmp_path)
    out = evaluate.main(["--model", d, "--quant_type", "BF16", "--lm_eval",
                         "t1,t2", "--seqlen", "64", "--cpu"])
    assert set(out["lm_eval"]) == {"t1", "t2"}
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("LmEval,")]
    assert [ln.split(",")[1] for ln in lines] == ["t1", "t2"]
    lm = A.make_lm(*hf.load_hf_params(d, device="cpu"), None, None, _Tok(),
                   max_len=64)
    want = sum(ll for ll, _ in lm.loglikelihood([_Req("a b", " c"),
                                                 _Req("t1", " d")]))
    assert out["lm_eval"]["t1"]["ll"] == pytest.approx(want, abs=1e-5)
    with pytest.raises(SystemExit, match="HF model directory"):
        evaluate.main(["--model", NAME, "--lm_eval", "t1", "--cpu"])
    monkeypatch.setitem(sys.modules, "lm_eval", None)
    with pytest.raises(SystemExit, match="lm_eval package"):
        evaluate.main(["--model", d, "--lm_eval", "t1", "--cpu"])


def test_evaluate_sh_arguments_parse():
    """Each of arcquant_tpu_torch/evaluate.sh's three invocations parses
    with the port's evaluate parser (a renamed flag fails here), with
    the root evaluate.sh's settings."""
    text = (Path(evaluate.__file__).parent / "evaluate.sh").read_text()
    calls = re.findall(r"python -m arcquant_tpu_torch\.evaluate ((?:.*\\\n)*"
                       r".*)", text)
    assert len(calls) == 3
    parsed = []
    for call in calls:
        argv = shlex.split(call.replace("\\\n", " ").replace(
            '"$MODEL"', "m").replace("$CALIB_ARG", "--calib c.npz"))
        parsed.append(evaluate.build_parser().parse_args(argv))
    assert all(a.quant_type == "NVFP4" and a.calib == "c.npz"
               for a in parsed)
    assert parsed[0].tasks.split(",") == [
        "piqa", "arc_challenge", "boolq", "hellaswag", "winogrande",
        "lambada", "arc_easy"]
    assert (parsed[1].tasks, parsed[1].num_fewshot) == ("mmlu", 5)
    assert (parsed[2].eval_ppl, parsed[2].dataset, parsed[2].seqlen) == (
        True, "wikitext2", 2048)
