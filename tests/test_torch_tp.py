"""Tensor parallelism of arcquant_tpu_torch (parallel/tp.py) held against
the JAX package's (arcquant_tpu/parallel/tp.py).

The sharders run in this process: each rank's packed shard must equal
slice i of the JAX sharders' [tp, ...] stack bit for bit (codes, scales,
global scales, index and position arrays), for w8 and w4, tensor and
channel weight scales, re-balanced and exact ARC. The sharded forward
runs in real process groups: two (and four) gloo ranks spawned by
parallel.launch on the CPU, whose workers (arcquant_tpu_torch/testing.py)
import no JAX; the JAX references run here on the 8-device CPU mesh of
tests/conftest.py. Each group runs all of its checks in one spawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.kernels.quantize import quantize_x_arc as jquantize_x_arc
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu.models.quantized import SiteCalib as JSiteCalib
from arcquant_tpu.parallel import make_mesh as jmake_mesh
from arcquant_tpu.parallel import shard_model_params_tp as jshard_model
from arcquant_tpu.parallel import tp as jtp
from arcquant_tpu.parallel import tp_quant_model_forward as jtp_forward
from arcquant_tpu.parallel.tp_engine import _shard_fused_col as j_fused_col
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.models.quantized import SiteCalib
from arcquant_tpu_torch.parallel import launch
from arcquant_tpu_torch.parallel import tp as tpm
from arcquant_tpu_torch.parallel.tp_engine import _shard_fused_col
from arcquant_tpu_torch.testing import (calib_arrays, cosine, to_numpy,
                                        tp_tasks)

TP = 2


def _slice(stack, i):
    """Shard i of a JAX packed stack, as the port's packed weight."""
    return convert.packed_from_numpy(type(stack)(
        *[None if f is None else np.asarray(f[i]) for f in stack]))


def _assert_same_pack(got, want, what):
    """Codes, scale bytes, global scales and bias bit for bit."""
    assert type(got) is type(want), what
    for field in ("codes", "scales", "global_scale", "bias"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), (what, field)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), (what, field)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    n, k = 64, 256
    w = rng.standard_normal((n, k)).astype(np.float32)
    w[:, rng.choice(k, 8, replace=False)] *= 20.0   # outlier channels
    bias = rng.standard_normal((n,)).astype(np.float32)
    ridx = rng.permutation(k).astype(np.int32)
    layer = {p: {"w": rng.standard_normal((m, k)).astype(np.float32)}
             for p, m in (("q", 64), ("k", 32), ("v", 32))}
    for p in ("q", "k", "v"):
        layer[p]["b"] = rng.standard_normal(
            (layer[p]["w"].shape[0],)).astype(np.float32)
    return dict(w=w, bias=bias, ridx=ridx, ke=128, layer=layer)


@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("w_scale", ["tensor", "channel"])
def test_sharders_bitwise_jax(weights, fmt, w_scale):
    w, ridx, ke = weights["w"], weights["ridx"], weights["ke"]
    jcal = JSiteCalib(jnp.asarray(ridx), ke)
    cal = SiteCalib(torch.as_tensor(ridx), ke)
    wt, bt = torch.as_tensor(w), torch.as_tensor(weights["bias"])

    jcol = jtp.shard_linear_col(jnp.asarray(w), jnp.asarray(weights["bias"]),
                                jcal, TP, fmt)
    for i in range(TP):
        _assert_same_pack(tpm.shard_linear_col(wt, bt, cal, TP, fmt, i),
                          _slice(jcol, i), f"col shard {i}")

    for exact in (False, True):
        jpw, jidx, jpos, jsel, _ = jtp.shard_linear_row(
            jnp.asarray(w), None, jcal, TP, fmt, w_scale, exact=exact)
        for i in range(TP):
            pw, idx, pos, sel, _ = tpm.shard_linear_row(
                wt, None, cal, TP, fmt, i, w_scale, exact=exact)
            what = f"row shard {i} exact={exact}"
            assert sel == jsel, what
            _assert_same_pack(pw, _slice(jpw, i), what)
            np.testing.assert_array_equal(to_numpy(idx), np.asarray(jidx)[i],
                                          err_msg=what)
            assert (pos is None) == (jpos is None), what
            if pos is not None:
                np.testing.assert_array_equal(to_numpy(pos),
                                              np.asarray(jpos)[i],
                                              err_msg=what)

    layer = weights["layer"]
    jlayer = jax.tree.map(jnp.asarray, layer)
    jq = JQuantConfig(weight_fmt=fmt, w_scale=w_scale)
    tlayer = convert.params_from_numpy(layer)
    jfused = j_fused_col(jlayer, ("q", "k", "v"), jcal, TP, jq)
    for i in range(TP):
        _assert_same_pack(
            _shard_fused_col(tlayer, ("q", "k", "v"), cal, TP,
                             QuantConfig(weight_fmt=fmt, w_scale=w_scale), i),
            _slice(jfused, i), f"fused qkv shard {i}")


def test_qwen72b_tp8_shard_contracts():
    """qwen2.5-72b shards tp 8: head counts, fused-QKV boundaries, the
    row-parallel K slices and the exact-ARC group alignment divide; the
    attention projections are packed for real at full width."""
    cfg = get_model_config("qwen2.5-72b")
    tp = 8
    assert cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    d, inter = cfg.hidden_size, cfg.intermediate_size
    assert (d // tp) % 16 == 0 and (inter // tp) % 16 == 0
    gran = 16 * tp
    ke_o = -(-(int(0.125 * d) // 64 * 64) // gran) * gran
    ke_d = -(-(int(0.125 * inter) // 64 * 64) // gran) * gran
    assert (ke_o // tp) % 16 == 0 and (ke_d // tp) % 16 == 0
    qs, kvs = cfg.q_size, cfg.kv_size
    lp = {p: {"w": torch.zeros((n, d), dtype=torch.bfloat16),
              "b": torch.zeros((n,), dtype=torch.bfloat16)}
          for p, n in (("q", qs), ("k", kvs), ("v", kvs))}
    calib = SiteCalib(torch.arange(d, dtype=torch.int32), ke_o)
    n_local = (qs + 2 * kvs) // tp
    for rank in (0, tp - 1):
        pw = _shard_fused_col(lp, ("q", "k", "v"), calib, tp,
                              QuantConfig(w_scale="channel"), rank)
        assert pw.codes.shape[1] == n_local
        assert n_local % cfg.head_dim == 0
    o_pw, o_idx, o_pos, o_sel, _ = tpm.shard_linear_row(
        torch.zeros((d, d), dtype=torch.bfloat16), None, calib, tp, "w8", 0,
        "channel", exact=True)
    assert o_sel == ke_o // tp and o_pos is not None
    assert o_pw.codes.shape[0] >= d // tp + ke_o // tp


# -- process groups ------------------------------------------------------------

def _exact_inputs(tp):
    k, n, ke, m = 128, 32, 64, 8
    rng = np.random.RandomState(0)
    w = rng.randn(n, k).astype(np.float32)
    ridx = rng.permutation(k).astype(np.int32)
    x = (rng.randn(m, k) * 2).astype(np.float32)
    return dict(k=k, ke=ke, w=w, ridx=ridx, x=x, tp=tp)


# The sharded forward's runs: (params, select_frac); "planted" multiplies
# every fifth embedding channel by 6 (JAX's test_tp_arc_runs_and_recovers_
# error), so that ARC matters.
RUNS = (("plain", 0.0), ("planted", 0.0), ("planted", 0.5))


def _model_runs():
    """{run: (params, calib)}, the tokens, and the bf16 forward of the
    planted params."""
    cfg = jax_model_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 16))
    out_ch = jnp.arange(0, cfg.hidden_size, 5)
    trees = {"plain": params, "planted": dict(
        params, embed=params["embed"].at[:, out_ch].multiply(6.0))}
    runs = {(p, frac): (trees[p], jquantized.identity_calib(cfg, frac))
            for p, frac in RUNS}
    base = np.asarray(jllama.model_forward(cfg, trees["planted"],
                                           jnp.asarray(tokens, jnp.int32)))
    return cfg, runs, tokens, base


@pytest.fixture(scope="module")
def group2():
    """One spawn of two gloo ranks: the exact-ARC quantize and the
    sharded forward of every run."""
    e = _exact_inputs(2)
    cfg, runs, tokens, base = _model_runs()
    tasks = [("tp_exact_quantize", (e["x"], e["w"], e["ridx"], e["ke"],
                                    (False, True)))]
    for params, calib in runs.values():
        tasks.append(("tp_forward", ("test-tiny",
                                     jax.tree.map(np.asarray, params),
                                     calib_arrays(calib), tokens)))
    results = launch(tp_tasks, 2, "gloo", cpu=True, args=(tasks,))
    return dict(exact=e, results=results, cfg=cfg, runs=runs, tokens=tokens,
                base=base)


@pytest.fixture(scope="module")
def group4():
    e = _exact_inputs(4)
    tasks = [("tp_exact_quantize", (e["x"], e["w"], e["ridx"], e["ke"],
                                    (False, True)))]
    return dict(exact=e, results=launch(tp_tasks, 4, "gloo", cpu=True,
                                        args=(tasks,)))


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("group", ["group2", "group4"])
def test_exact_arc_quantize_bitwise(request, group, per_row):
    """The exact-ARC row-site quantize, re-assembled across the ranks,
    equals quantize_x_arc's output bit for bit (the JAX package's
    test_exact_arc_tp_bit_parity)."""
    g = request.getfixturevalue(group)
    e = g["exact"]
    k, ke, tp = e["k"], e["ke"], e["tp"]
    ks, kc = k // tp, ke // tp
    xa_ref, gx_ref = jquantize_x_arc(jnp.asarray(e["x"]),
                                     jnp.asarray(e["ridx"]), ke, kq=k + ke,
                                     per_row=per_row)
    ref = np.asarray(xa_ref.astype(jnp.float32))
    got = [r[0][per_row] for r in g["results"]]
    for xa, gx in got:
        np.testing.assert_array_equal(gx.reshape(np.shape(gx_ref)),
                                      np.asarray(gx_ref))
    np.testing.assert_array_equal(
        np.concatenate([xa[:, :ks] for xa, _ in got], 1), ref[:, :k])
    np.testing.assert_array_equal(
        np.concatenate([xa[:, ks:ks + kc] for xa, _ in got], 1),
        ref[:, k:k + ke])


@pytest.mark.parametrize("run", [("plain", 0.0), ("planted", 0.5)])
def test_tp_forward_matches_jax(group2, run):
    """tp_quant_model_forward against the JAX package's on the same
    shards, at select 0 and at ARC 0.5 (JAX's test_tp_matches_single_
    device_no_arc and test_tp_arc_runs_and_recovers_error): both ranks'
    logits equal, cosine >= 0.999 and within 2e-2 of the JAX logits."""
    cfg, tokens = group2["cfg"], group2["tokens"]
    params, calib = group2["runs"][run]
    qcfg = JQuantConfig(quant_type="NVFP4", use_kernels=True)
    mesh = jmake_mesh(dp=1, tp=TP, devices=jax.devices()[:TP])
    qp = jshard_model(cfg, params, calib, qcfg, mesh)
    want = np.asarray(jtp_forward(cfg, qp, calib, qcfg, mesh,
                                  jnp.asarray(tokens, jnp.int32)))
    i = 1 + RUNS.index(run)
    r0, r1 = (r[i] for r in group2["results"])
    np.testing.assert_array_equal(r0, r1)
    assert cosine(r0, want) >= 0.999
    np.testing.assert_allclose(r0, want, rtol=2e-2, atol=2e-2)


def test_tp_arc_recovers_error(group2):
    """ARC 0.5 under TP (re-balanced selection) brings the logits of the
    planted params closer to their bf16 forward than select 0."""
    base = group2["base"]
    mse = {frac: float(np.mean(
        (group2["results"][0][1 + RUNS.index(("planted", frac))] - base)
        ** 2)) for frac in (0.0, 0.5)}
    assert np.isfinite(mse[0.5]) and mse[0.5] < mse[0.0], mse
