"""MoE calibration of arcquant_tpu_torch (calib/calibrate.py's MoE branch:
moe_block's taps on the raw experts) held against the JAX package's on
test-tiny-moe, f32 params, 2 samples of 32 tokens (the JAX package's
tests/test_calib.py::test_moe_calibration_end_to_end), in dense mode and
in dispatch mode (both packages' DENSE_MODE_MAX_T lowered below the
chunk's 64 tokens).

The bars, per metric and mode:
  - the JAX test's own: five sites a layer (sdown_in included) with their
    widths, ascending permutations, select counts a multiple of 64,
    4.5 <= avg_bits < 9, the .npz round trip keeping the five sites, a
    finite fake-quant forward from the artifact;
  - against the JAX package: equal select_num at every site, avg_bits
    within 1e-6;
  - the stats and the reorder indices (tests/test_torch_calib.py's rank
    windows: equal up to groups of stats chained within the bound). Layer 0
    sees the same input in both packages: its f32 sites within 1e-5 of
    JAX's, and the experts' down_in, whose tap is bf16 in both, within a
    bf16 ulp (2^-8; an f32-order ulp in the expert products can round an
    intermediate to the next bf16 value). The MoE block's output is
    bf16-rounded in both packages, so layer 1 already reads inputs a bf16
    ulp apart in a few elements: its stats are held within 5e-2 of the
    site's largest stat (measured: up to 3.7e-2, score's down_in; layer 0
    within 1.5e-6, and 1.2e-3 at down_in) and its orders to windows of that
    width.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.calib import calibrate as jcalibrate
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import moe as jmoe
from arcquant_tpu_torch import calibrate as calibrate_cli
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.calib import (compute_calibration, load_calibration,
                                      save_calibration)
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.evals import synthetic_stream
from arcquant_tpu_torch.models import llama, moe, quantized
from tests.test_torch_calib import RTOL, _groups_in_order

NAME = "test-tiny-moe"
S, T = 2, 32
BF16_ULP = 2.0 ** -8
DEEPER = 5e-2


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = jax_model_config(NAME)
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    tokens = synthetic_stream(cfg.vocab_size, S * T, seed=3).reshape(S, T)
    return jparams, params, tokens


MODES = {"dense": 256, "dispatch": 16}


@functools.lru_cache(maxsize=None)
def _both(metric, mode):
    """(JAX (calib, stats, bits), port (calib, stats, bits))."""
    jparams, params, tokens = _setup()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "DENSE_MODE_MAX_T", MODES[mode])
        mp.setattr(jmoe, "DENSE_MODE_MAX_T", MODES[mode])
        j = jcalibrate.compute_calibration(
            jax_model_config(NAME), jparams, jnp.asarray(tokens),
            metric=metric)
        p = compute_calibration(get_model_config(NAME), params, tokens,
                                metric=metric, device="cpu")
    return j, p


def _dims(cfg):
    return {"attn_in": cfg.hidden_size, "o_in": cfg.q_size,
            "mlp_in": cfg.hidden_size, "down_in": cfg.moe_intermediate_size,
            "sdown_in": cfg.shared_expert_size}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("metric", ["max", "hessian", "score"])
def test_moe_calibration_matches_jax(metric, mode):
    (jcalib, jstats, jbits), (calib, stats, bits) = _both(metric, mode)
    cfg = get_model_config(NAME)
    assert len(calib) == cfg.num_layers
    assert abs(bits - jbits) <= 1e-6 and 4.5 <= bits < 9.0
    report = []
    for li, (jl, pl) in enumerate(zip(jcalib, calib)):
        assert set(pl) == set(jl) == set(_dims(cfg))
        for site, k in _dims(cfg).items():
            order = pl[site].reorder_index.numpy()
            assert order.dtype == np.int32 and order.shape == (k,)
            np.testing.assert_array_equal(np.sort(order), np.arange(k))
            assert pl[site].select_num == jl[site].select_num, (li, site)
            assert pl[site].select_num % 64 == 0
            js = np.asarray(jstats[li][site])
            ps = stats[li][site].numpy()
            assert ps.dtype == np.float32 and ps.shape == js.shape
            bound = (DEEPER if li else
                     BF16_ULP if site == "down_in" else RTOL)
            # layer 0: relative to each stat; deeper: to the site's
            # largest (a score is a small difference of large terms)
            scale = np.abs(js).max() if li else np.abs(js)
            rel = np.abs(ps - js) / scale
            assert (rel <= bound).all(), (li, site, float(rel.max()))
            ok, tied = _groups_in_order(js, order, rtol=bound)
            assert ok, (li, site)
            report.append((li, site, float(rel.max()), tied))
    print(f"{metric} {mode} (layer, site, max rel, near-tied):", report)


def test_moe_artifact_round_trip_and_forward(tmp_path):
    """The five-site artifact through save/load_calibration, then a
    finite fake-quant forward of the model from it (the JAX test's
    end)."""
    _, (calib, _, _) = _both("max", "dense")
    _, params, tokens = _setup()
    cfg = get_model_config(NAME)
    path = str(tmp_path / "c.npz")
    save_calibration(path, calib)
    back = load_calibration(path)
    assert [set(layer) for layer in back] == [set(_dims(cfg))] * 2
    for a, b in zip(calib, back):
        for site in a:
            assert a[site].select_num == b[site].select_num
            assert torch.equal(a[site].reorder_index.to(torch.int32),
                               b[site].reorder_index.to(torch.int32))
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=False,
                       w_scale="channel")
    qp = quantized.quantize_model_params(cfg, params, back, qcfg)
    out = quantized.quant_model_forward(cfg, qp, back, qcfg,
                                        torch.from_numpy(tokens))
    assert out.shape == (S, T, cfg.vocab_size)
    assert bool(torch.isfinite(out).all())


def test_moe_site_activations_are_flat_taps():
    """site_activations on an MoE layer: the routed experts' down_in and
    the shared expert's sdown_in come back as one row [1, N, F] (dense
    mode: T x E routing-masked rows), the other sites as [B, T, K], and
    the layer's output is llama.layer_forward's."""
    from arcquant_tpu_torch.calib import calibrate
    _, params, tokens = _setup()
    cfg = get_model_config(NAME)
    x = params["embed"][torch.from_numpy(tokens).long()]
    pos = llama.positions_for(torch.from_numpy(tokens))
    cos, sin = llama.rope_cos_sin(cfg, pos)
    y, sites = calibrate.site_activations(cfg, params["layers"][0], x, cos,
                                          sin)
    assert set(sites) == set(_dims(cfg))
    assert tuple(sites["down_in"].shape) == (
        1, S * T * cfg.num_experts, cfg.moe_intermediate_size)
    assert tuple(sites["sdown_in"].shape) == (1, S * T,
                                              cfg.shared_expert_size)
    assert tuple(sites["attn_in"].shape) == (S, T, cfg.hidden_size)
    # each token has exactly top-k live expert rows in the tap
    live = (sites["down_in"][0].abs().amax(-1) > 0).reshape(
        S * T, cfg.num_experts)
    assert (live.sum(-1) <= cfg.num_experts_per_tok).all()
    # the same ops but attention (flash's plain version against dense
    # f32): an ulp there can move a bf16-rounded expert output by a bf16
    # ulp (measured: 0.15% of the elements, none further)
    want, _ = llama.layer_forward(cfg, params["layers"][0], x, cos, sin)
    diff = (y - want).abs()
    assert (diff <= 2.0 ** -7 * want.abs().amax(-1, keepdim=True)).all()


def test_moe_entry_point_streams_layers(tmp_path, capsys):
    """python -m arcquant_tpu_torch.calibrate on an MoE config (--cpu):
    its dummy layers are streamed, drawn in llama.init_params' order, and
    it writes the five-site artifact."""
    cfg = get_model_config(NAME)
    streamed = calibrate_cli.dummy_params(cfg, 0, "cpu")
    assert callable(streamed["layers"])
    want = llama.init_params(cfg, torch.Generator().manual_seed(0))
    for li in range(cfg.num_layers):
        got = streamed["layers"](li)["moe"]
        for name, leaf in want["layers"][li]["moe"].items():
            assert torch.equal(got[name]["w"], leaf["w"]), (li, name)
    out = calibrate_cli.main(["--model", NAME, "--samples", "2", "--seqlen",
                              "32", "--output", str(tmp_path), "--cpu"])
    assert "average bits:" in capsys.readouterr().out
    assert [set(layer) for layer in load_calibration(out["path"])] == [
        set(_dims(cfg))] * cfg.num_layers
