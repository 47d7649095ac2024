"""The evals of arcquant_tpu_torch (evals/data.py, ppl.py, tasks.py) and
its two demos (``python -m arcquant_tpu_torch.evaluate`` and
``... generate``) held against the JAX package on test-tiny.

- synthetic_stream, the ARC_DATA_DIR mirror and the calibration windows:
  identical streams;
- eval_ppl in BF16 within 1e-3 relative of the JAX package's, and
  quantized (fake NVFP4 and MXFP4, packed NVFP4 w8) within 1e-2, on the
  same weights (bf16 params; the JAX side jits each layer, its Pallas
  kernels in interpret mode);
- evaluate_tasks on synthetic:16 and greedy:8 (zero- and one-shot) with
  the JAX package's accuracies (its scorer run eagerly);
- the demos run on the CPU (--cpu) in a temporary directory without
  importing JAX; generate's tokens are those of InferenceEngine.generate
  on the same dummy engine; what is not ported raises, naming its
  ROADMAP item, and without --cpu a machine with no CUDA raises.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.calib import save_calibration
from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.evals import data as jdata
from arcquant_tpu.evals import ppl as jppl
from arcquant_tpu.evals import tasks as jtasks
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert, evaluate, generate
from arcquant_tpu_torch.calib import load_calibration
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.evals import data, ppl, tasks
from arcquant_tpu_torch.models import quantized

ROOT = Path(__file__).resolve().parents[1]
NAME = "test-tiny"
SELECT = 0.125
SEQLEN = 64


@pytest.mark.parametrize("vocab,n,seed", [(512, 3000, 0), (152064, 2000, 3),
                                          (7, 500, 1)])
def test_synthetic_stream_identical(vocab, n, seed):
    got = data.synthetic_stream(vocab, n, seed)
    want = jdata.synthetic_stream(vocab, n, seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        data.get_token_stream("synthetic", "test", None, vocab, n, seed),
        jdata.get_token_stream("synthetic", "test", None, vocab, n, seed))


def test_local_mirror_and_calib_samples(tmp_path, monkeypatch):
    """ARC_DATA_DIR jsonl records, joined by the dataset's joiner
    (humaneval's fixed split), tokenized; and the calibration windows."""
    recs = {"wikitext2.test": [{"text": "a b"}, {"text": "c"}],
            "humaneval.test": [{"prompt": "def f():"}, {"prompt": "x"}]}
    for key, rows in recs.items():
        (tmp_path / f"{key}.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows) + "\n")
    monkeypatch.setenv("ARC_DATA_DIR", str(tmp_path))

    def tok(text):
        return [ord(c) for c in text]
    for ds, split in (("wikitext2", "test"), ("humaneval", "train")):
        got = data.get_token_stream(ds, split, tok)
        np.testing.assert_array_equal(
            got, jdata.get_token_stream(ds, split, tok))
    assert data._local_records("ptb", "test") is None
    np.testing.assert_array_equal(
        data.get_calib_samples("synthetic", None, 4, 32, 512, seed=2),
        jdata.get_calib_samples("synthetic", None, 4, 32, 512, seed=2))


@pytest.fixture(scope="module")
def model():
    """test-tiny bf16 params from the JAX package, numpy leaves, and a
    synthetic stream of 4 windows."""
    cfg = jax_model_config(NAME)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    stream = jdata.synthetic_stream(cfg.vocab_size, 4 * SEQLEN + 7, 0)
    return jax.tree.map(np.asarray, params), stream


PPL = {"bf16": (dict(quant_type="BF16"), 1e-3),
       "nvfp4_fake": (dict(use_kernels=False), 1e-2),
       "mxfp4_fake_row": (dict(quant_type="MXFP4", use_kernels=False,
                               act_scale="row"), 1e-2),
       "nvfp4_packed": (dict(use_kernels=True, act_scale="row"), 1e-2)}


def _quantized_both(params, kw):
    """(port params or tree, JAX params or tree, port/JAX qcfg and calib);
    both trees from the JAX package's quantize_model_params, so the two
    forwards run on the same weights."""
    jcfg = jax_model_config(NAME)
    jp = jax.tree.map(jnp.asarray, params)
    if kw.get("quant_type") == "BF16":
        return (convert.params_from_numpy(params), jp, None, None, None,
                None)
    jq, q = JQuantConfig(**kw), QuantConfig(**kw)
    jcalib = jquantized.identity_calib(jcfg, SELECT)
    jtree = jquantized.quantize_model_params(jcfg, jp, jcalib, jq)
    return (convert.fake_qparams_from_numpy(jax.tree.map(np.asarray, jtree)),
            jtree, q, jq, quantized.identity_calib(get_model_config(NAME),
                                                   SELECT), jcalib)


@pytest.mark.parametrize("setting", list(PPL))
def test_eval_ppl_matches_jax(model, setting):
    params, stream = model
    kw, rtol = PPL[setting]
    tree, jtree, q, jq, calib, jcalib = _quantized_both(params, kw)
    got = ppl.eval_ppl(get_model_config(NAME), tree, stream, SEQLEN, q,
                       calib, batch=2)
    want = jppl.eval_ppl(jax_model_config(NAME), jtree, jnp.asarray(stream),
                         SEQLEN, jq, jcalib, batch=2)
    assert np.isfinite(got) and got > 1
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_eval_ppl_refuses_raw_params_and_short_streams(model):
    params, stream = model
    cfg = get_model_config(NAME)
    raw = convert.params_from_numpy(params)
    with pytest.raises(ValueError, match="quantize first"):
        ppl.eval_ppl(cfg, raw, stream, SEQLEN, QuantConfig(),
                     quantized.identity_calib(cfg, SELECT))
    with pytest.raises(ValueError, match="shorter"):
        ppl.eval_ppl(cfg, raw, stream[:SEQLEN - 1], SEQLEN)


@pytest.mark.parametrize("setting,fewshot", [("bf16", 0), ("nvfp4_fake", 0),
                                             ("nvfp4_fake", 1)])
def test_evaluate_tasks_matches_jax(model, setting, fewshot):
    params, _ = model
    tree, jtree, q, jq, calib, jcalib = _quantized_both(params,
                                                         PPL[setting][0])
    names = ["synthetic:16", "greedy:8"]
    got = tasks.evaluate_tasks(get_model_config(NAME), tree, names, qcfg=q,
                               calib=calib, num_fewshot=fewshot)
    # the JAX scorer runs eagerly: jitted, XLA's fusions reorder the
    # quantized bf16 forward's f32 ops, and e2m1 flips move a summed
    # log-probability by up to 0.3 from the eager reference, enough to
    # change a choice (the port's scores are the eager ones' to 4e-6;
    # ROADMAP queue 3)
    with jax.disable_jit():
        want = jtasks.evaluate_tasks(jax_model_config(NAME), jtree, names,
                                     qcfg=jq, calib=jcalib,
                                     num_fewshot=fewshot)
    assert got == want
    assert set(got) == set(names)


def test_task_docs_and_fewshot_prefix():
    docs = tasks.load_task_docs("synthetic:5", vocab_size=300, seed=4)
    assert docs == jtasks.load_task_docs("synthetic:5", vocab_size=300,
                                         seed=4)
    assert (tasks._fewshot_prefix(docs, None, 2, True)
            == jtasks._fewshot_prefix(docs, None, 2, True))
    text = [("ctx", [" a", " b"], 1, "law"), (["p1", "p2"], [" q", " q"], 0,
                                              None)]
    assert (tasks._fewshot_prefix(text, "law", 2, False)
            == jtasks._fewshot_prefix(text, "law", 2, False))
    row = {"sentence": "The cat _ sat.", "option1": "A", "option2": "B",
           "answer": "2"}
    assert tasks._winogrande(row) == jtasks._winogrande(row)
    mmlu = {"question": " Q? ", "choices": ["w", "x", "y", "z"], "answer": 2,
            "subject": "law"}
    assert tasks._mmlu(mmlu) == jtasks._mmlu(mmlu)
    assert tasks._bucket(33) == jtasks._bucket(33) == 64


def _run_module(tmp_path, module, args):
    """Run `python -m module args` in tmp_path; assert JAX was never
    imported. Returns its stdout lines."""
    code = ("import runpy, sys\n"
            f"sys.argv = [{module!r}] + {args!r}\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n"
            "bad = [m for m in sys.modules if m == 'jax'\n"
            "       or m.startswith(('jax.', 'arcquant_tpu.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_evaluate_entry_point(tmp_path):
    lines = _run_module(tmp_path, "arcquant_tpu_torch.evaluate", [
        "--model", NAME, "--eval_ppl", "--dataset", "synthetic", "--seqlen",
        "64", "--ntokens", "512", "--tasks", "synthetic:16", "--cpu"])
    result = [ln for ln in lines if ln.startswith("Result,synthetic,")]
    assert len(result) == 1 and float(result[0].split(",")[2]) > 1
    assert any(ln.startswith("Task,synthetic:16,") and
               ln.endswith("shots=0") for ln in lines)
    logs = list((tmp_path / "results").glob(f"log_{NAME}_*.log"))
    assert len(logs) == 1 and "Result,synthetic," in logs[0].read_text()


def test_generate_entry_point_matches_engine(tmp_path):
    prompts = [[5, 17, 301], [9, 8, 7, 6, 5]]
    lines = _run_module(tmp_path, "arcquant_tpu_torch.generate", [
        "--model", NAME, "--tokens", "5,17,301", "--tokens", "9,8,7,6,5",
        "--max_new", "8", "--cpu"])
    outs = [json.loads(ln.split("] ", 1)[1]) for ln in lines
            if ln.startswith("[")]
    cfg = get_model_config(NAME)
    args = generate.build_parser().parse_args(["--model", NAME, "--cpu"])
    eng = InferenceEngine.dummy(
        cfg, quantized.identity_calib(cfg, args.select_frac),
        generate.qcfg_of(args), EngineConfig(max_batch=args.max_batch,
                                             max_seq_len=args.max_seq_len),
        seed=args.seed, device="cpu")
    assert outs == eng.generate(prompts, 8)
    assert [len(o) for o in outs] == [8, 8]


def test_generate_quant_head_matches_engine(capsys):
    """--quant_head serves the lm head packed (W4A16), as InferenceEngine
    does with quantize_lm_head=True; the default head stays bf16."""
    prompts = [[5, 17, 301], [9, 8, 7, 6, 5]]
    argv = ["--model", NAME, "--max_new", "6", "--cpu"]
    assert not generate.qcfg_of(
        generate.build_parser().parse_args(argv)).quantize_lm_head
    args = generate.build_parser().parse_args(argv + ["--quant_head"])
    qcfg = generate.qcfg_of(args)
    assert qcfg.quantize_lm_head
    generate.main(argv + ["--quant_head", "--tokens", "5,17,301",
                          "--tokens", "9,8,7,6,5"])
    outs = [json.loads(ln.split("] ", 1)[1]) for ln in
            capsys.readouterr().out.splitlines() if ln.startswith("[")]
    cfg = get_model_config(NAME)
    eng = InferenceEngine.dummy(
        cfg, quantized.identity_calib(cfg, args.select_frac), qcfg,
        EngineConfig(max_batch=args.max_batch, max_seq_len=args.max_seq_len),
        seed=args.seed, device="cpu")
    assert "lm_head_packed" in eng.qparams
    assert outs == eng.generate(prompts, 6)


def test_entry_points_with_a_calibration(tmp_path, capsys, monkeypatch):
    """--calib reads the JAX package's calibration .npz (calib/artifacts.py
    load_calibration, which serve.py imports too)."""
    jcfg = jax_model_config(NAME)
    rng = np.random.default_rng(0)
    jcalib = [{s: jquantized.SiteCalib(
        jnp.asarray(rng.permutation(c.reorder_index.shape[0]), jnp.int32),
        c.select_num) for s, c in layer.items()}
        for layer in jquantized.identity_calib(jcfg, SELECT)]
    path = str(tmp_path / "calib.npz")
    save_calibration(path, jcalib, {"model": NAME})
    calib = load_calibration(path)
    for layer, jlayer in zip(calib, jcalib):
        assert set(layer) == set(jlayer)
        for s in layer:
            assert layer[s].select_num == jlayer[s].select_num
            np.testing.assert_array_equal(layer[s].reorder_index.numpy(),
                                          np.asarray(jlayer[s].reorder_index))
    monkeypatch.chdir(tmp_path)
    evaluate.main(["--model", NAME, "--eval_ppl", "--seqlen", "32",
                   "--ntokens", "64", "--calib", path, "--cpu",
                   "--use_kernels", "--act_scale", "row"])
    generate.main(["--model", NAME, "--tokens", "1,2", "--max_new", "2",
                   "--calib", path, "--cpu"])
    out = capsys.readouterr().out
    assert "Result,synthetic," in out and "] [" in out


def test_entry_points_raise_outside_the_slice(tmp_path, monkeypatch):
    # a directory is a checkpoint (tests/test_torch_hf_loader.py): one
    # without config.json is refused
    with pytest.raises(FileNotFoundError, match="config.json"):
        evaluate.main(["--model", str(tmp_path), "--cpu"])
    # --lm_eval runs the adapter (tests/test_torch_lm_eval_adapter.py);
    # without the lm_eval package it exits naming it
    monkeypatch.setitem(sys.modules, "lm_eval", None)
    with pytest.raises(SystemExit, match="lm_eval package"):
        evaluate.main(["--model", NAME, "--lm_eval", "piqa", "--cpu"])
    # an MoE config, once refused, evaluates (the experts as qdq stacks)
    monkeypatch.chdir(tmp_path)
    moe_out = evaluate.main(["--model", "test-tiny-moe", "--eval_ppl",
                             "--seqlen", "32", "--ntokens", "64", "--cpu"])
    assert moe_out["windows"] == 2 and np.isfinite(moe_out["ppl"])
    with pytest.raises(ValueError, match="HF model dir"):
        generate.main(["--model", NAME, "--prompt", "hello", "--cpu"])
    # --tp runs the TP engine (tests/test_torch_tp_engine.py), an MoE
    # config included: its experts shard over the ranks
    # (tests/test_torch_ep.py), the ranks' logits bitwise equal
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ranks = generate.main(["--model", "test-tiny-moe", "--tp", "2",
                           "--dist_backend", "gloo", "--cpu", "--max_new",
                           "3", "--tokens", "5,17,301", "--check_ranks"])
    assert ranks[0]["outputs"] == ranks[1]["outputs"]
    assert len(ranks[0]["outputs"][0]) == 3
    d = evaluate.build_parser().parse_args(["--model", NAME])
    assert (d.quant_type, d.act_scale, d.select_frac, d.seqlen, d.ntokens,
            d.weight_fmt, d.kv_group_size, d.cpu) == (
                "NVFP4", "tensor", 0.125, 2048, 32768, "w8", 64, False)
    if not torch.cuda.is_available():
        # the demos default to the card and never fall back
        monkeypatch.chdir(tmp_path)
        with pytest.raises(RuntimeError, match="CUDA"):
            evaluate.main(["--model", NAME, "--eval_ppl"])
        with pytest.raises(RuntimeError, match="CUDA"):
            generate.main(["--model", NAME])
