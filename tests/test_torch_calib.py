"""Calibration of arcquant_tpu_torch (calib/calibrate.py, calib/artifacts.py,
``python -m arcquant_tpu_torch.calibrate``) held against the JAX package
on test-tiny, f32 params (the JAX package's own calibration tests use
f32), 4 samples of 64 tokens.

- compute_calibration in each metric: per-site stats within rtol 1e-5
  of the JAX package's, equal select counts and avg_bits, reorder
  indices equal but within stated groups of stats tied to 1e-5. For
  score, the stat is the L2 of x - nvfp4_qdq(x), a small difference of
  large terms: its error is x's error, so the 1e-5 is taken relative to
  the channel's input L2 (the per-sample max of |x|'s column L2; for max
  and hessian the stat is itself that norm's kind). And an input an f32
  ulp apart in the two packages (their products sum in another order)
  can round to the next e2m1 code, which moves that channel's L2 by a
  code step: the test finds those channels (a site tap's qdq differing
  between the packages, each package fed its own residual stream, as
  calibration feeds it), counts them, and holds the stat and the order
  to the bound everywhere else;
- the site taps against the JAX package's at layer 0 (the same input);
- a valid ascending permutation; zero rows left out of the outlier share;
- streamed (callable) layers equal to the list; dummy weights drawn in
  llama.init_params' order, streamed or not;
- MoE calibration runs, five sites a layer (its parity:
  tests/test_torch_moe_calib.py);
- the .npz artifact across both packages, in both directions;
- ARC's own claim: calibrated ARC lowers the logits error of NVFP4
  against bf16 below select 0, on planted outlier channels;
- the entry point on the CPU (--cpu).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.calib import calibrate as jcalibrate
from arcquant_tpu.calib import load_calibration as jload_calibration
from arcquant_tpu.calib import load_calibration_meta as jload_meta
from arcquant_tpu.calib import save_calibration as jsave_calibration
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.quant import numerics as jN
from arcquant_tpu_torch import calibrate as calibrate_cli
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.calib import (compute_calibration, load_calibration,
                                      load_calibration_meta, save_calibration)
from arcquant_tpu_torch.calib import calibrate
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.evals import synthetic_stream
from arcquant_tpu_torch.models import llama, quantized
from arcquant_tpu_torch.testing import to_numpy

NAME = "test-tiny"
RTOL = 1e-5
S, T = 4, 64


@pytest.fixture(scope="module")
def setup():
    cfg = jax_model_config(NAME)
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    tokens = synthetic_stream(cfg.vocab_size, S * T, seed=1).reshape(S, T)
    return jparams, params, tokens


@pytest.fixture(scope="module")
def both(setup):
    """{metric: (JAX (calib, stats, bits), port (calib, stats, bits))};
    max also with select_batch 2 (the first two samples' shares)."""
    jparams, params, tokens = setup
    jcfg, cfg = jax_model_config(NAME), get_model_config(NAME)
    out = {}
    for metric, nsel in (("max", None), ("max", 2), ("hessian", None),
                         ("score", None)):
        j = jcalibrate.compute_calibration(jcfg, jparams, jnp.asarray(tokens),
                                           metric=metric, select_batch=nsel)
        p = compute_calibration(cfg, params, tokens, metric=metric,
                                select_batch=nsel, device="cpu")
        out[metric, nsel] = (j, p)
    return out


def _flipped_channels(setup):
    """Per layer ({site: channels where nvfp4_qdq of the two packages'
    site taps differ}, {site: the port's per-channel input L2, max over
    samples}), each package running its own site_activations on its own
    residual stream (JAX's jitted, as its calibration runs it)."""
    jparams, params, tokens = setup
    jcfg, cfg = jax_model_config(NAME), get_model_config(NAME)
    jsite = jax.jit(lambda p, x, c, s: jcalibrate.site_activations(
        jcfg, p, x, c, s))
    pos = np.broadcast_to(np.arange(T), (S, T))
    jcos, jsin = jllama.rope_cos_sin(jcfg, jnp.asarray(pos))
    cos, sin = llama.rope_cos_sin(cfg, torch.from_numpy(pos.copy()))
    jx = jparams["embed"][jnp.asarray(tokens)]
    x = params["embed"][torch.from_numpy(tokens).long()]
    flips, norms = [], []
    for li in range(cfg.num_layers):
        jx, jsites = jsite(jparams["layers"][li], jx, jcos, jsin)
        x, sites = calibrate.site_activations(cfg, params["layers"][li], x,
                                              cos, sin)
        layer = {}
        for site, a in sites.items():
            k = a.shape[-1]
            qp = np.asarray(jN.nvfp4_qdq(jnp.asarray(to_numpy(a).reshape(
                -1, k))))
            qj = np.asarray(jN.nvfp4_qdq(jsites[site].reshape(-1, k)))
            layer[site] = set(np.nonzero((qp != qj).any(axis=0))[0])
        flips.append(layer)
        norms.append({site: torch.sqrt((a.float() ** 2).sum(1)).amax(
            0).numpy() for site, a in sites.items()})
    return flips, norms


def _groups_in_order(jstat, porder, skip=(), rtol=RTOL):
    """Whether the port's order sorts JAX's stat ascending, up to groups of
    channels whose stats chain within rtol of each other (skip: channels
    left out); returns (ok, channels in groups of more than one)."""
    k = jstat.shape[0]
    rank = np.empty(k, np.int64)
    rank[porder] = np.arange(k)
    keep = np.array([c for c in range(k) if c not in skip])
    order = keep[np.argsort(jstat[keep], kind="stable")]
    s = jstat[order]
    new = np.concatenate([[True], s[1:] > s[:-1] * (1 + rtol) + 1e-30])
    gid = np.cumsum(new) - 1
    lo = np.full(gid[-1] + 1, k)
    hi = np.full(gid[-1] + 1, -1)
    np.minimum.at(lo, gid, rank[order])
    np.maximum.at(hi, gid, rank[order])
    sizes = np.bincount(gid)
    return bool((hi[:-1] < lo[1:]).all()), int(sizes[sizes > 1].sum())


@pytest.mark.parametrize("metric,nsel", [("max", None), ("max", 2),
                                         ("hessian", None),
                                         ("score", None)])
def test_compute_calibration_matches_jax(both, setup, metric, nsel):
    (jcalib, jstats, jbits), (calib, stats, bits) = both[metric, nsel]
    flips, norms = (_flipped_channels(setup) if metric == "score"
                    else (None, None))
    assert bits == jbits
    report = []
    for li, (jl, pl) in enumerate(zip(jcalib, calib)):
        assert set(jl) == set(pl) == set(quantized.QUANT_SITES)
        for site in jl:
            js = np.asarray(jstats[li][site])
            ps = stats[li][site].numpy()
            assert ps.dtype == np.float32 and ps.shape == js.shape
            assert pl[site].select_num == jl[site].select_num, (li, site)
            jorder = np.asarray(jl[site].reorder_index)
            porder = pl[site].reorder_index.numpy()
            assert porder.dtype == np.int32
            scale = norms[li][site] if norms else np.abs(js)
            off = set(np.nonzero(np.abs(ps - js) > RTOL * scale)[0])
            flipped = flips[li][site] if flips else set()
            # score: every channel off the bound shows an e2m1 flip
            assert off <= flipped, (li, site, sorted(off - flipped))
            # the order: equal but within groups of stats tied to RTOL
            ok, tied = _groups_in_order(js, porder, skip=flipped)
            assert ok, (li, site)
            moved = int((porder != jorder).sum())
            assert flipped or moved <= tied, (li, site, moved, tied)
            report.append((li, site, len(off), len(flipped), tied, moved))
    # stated per site: channels off the bound, flipped, in near-ties,
    # placed elsewhere than by the JAX package
    print(f"{metric} (layer, site, off, flipped, near-tied, moved):", report)
    assert sum(r[2] for r in report) <= (16 if metric == "score" else 0)


def test_site_activations_match_jax(setup):
    """Layer 0's four taps and output from the same input, f32."""
    jparams, params, tokens = setup
    jcfg, cfg = jax_model_config(NAME), get_model_config(NAME)
    pos = np.broadcast_to(np.arange(T), (S, T))
    jcos, jsin = jllama.rope_cos_sin(jcfg, jnp.asarray(pos))
    cos, sin = llama.rope_cos_sin(cfg, torch.from_numpy(pos.copy()))
    jx, jsites = jcalibrate.site_activations(
        jcfg, jparams["layers"][0], jparams["embed"][jnp.asarray(tokens)],
        jcos, jsin)
    x, sites = calibrate.site_activations(
        cfg, params["layers"][0], params["embed"][torch.from_numpy(
            tokens).long()], cos, sin)
    assert set(sites) == set(jsites)
    for site in jsites:
        want = np.asarray(jsites[site])
        np.testing.assert_allclose(to_numpy(sites[site]), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(to_numpy(x), np.asarray(jx), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jx)).max())


def test_calibration_is_an_ascending_permutation(both):
    calib, stats, bits = both["max", None][1]
    cfg = get_model_config(NAME)
    assert len(calib) == cfg.num_layers and 4.5 <= bits < 9.0
    for layer, lstats in zip(calib, stats):
        for site, sc in layer.items():
            k = sc.reorder_index.shape[0]
            assert torch.equal(torch.sort(sc.reorder_index).values,
                               torch.arange(k, dtype=torch.int32))
            assert sc.select_num % 64 == 0 and 0 <= sc.select_num <= k
            st = lstats[site][sc.reorder_index.long()]
            assert bool((st[1:] >= st[:-1]).all())


def test_outlier_count_ignores_zero_rows():
    """Zero rows (an MoE tap's unrouted slots) do not dilute the share;
    the share equals the JAX package's on the same rows."""
    rows = np.random.default_rng(2).standard_normal((1, 8, 32)).astype(
        np.float32)
    padded = np.concatenate([rows, np.zeros((1, 24, 32), np.float32)], 1)
    dense = calibrate._site_outlier_count(torch.from_numpy(rows))
    got = calibrate._site_outlier_count(torch.from_numpy(padded))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-6)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcalibrate._site_outlier_count(
            jnp.asarray(padded))))


def test_streamed_layers_equal_the_list(setup, both):
    _, params, tokens = setup
    cfg = get_model_config(NAME)
    calls = []

    def layers(li):
        calls.append(li)
        return params["layers"][li]
    calib, stats, bits = compute_calibration(
        cfg, dict(params, layers=layers), tokens, device="cpu")
    want_calib, want_stats, want_bits = both["max", None][1]
    assert calls == list(range(cfg.num_layers)) and bits == want_bits
    for li in range(cfg.num_layers):
        for site, sc in calib[li].items():
            assert torch.equal(stats[li][site], want_stats[li][site])
            assert torch.equal(sc.reorder_index,
                               want_calib[li][site].reorder_index)
            assert sc.select_num == want_calib[li][site].select_num


def test_dummy_weights_streamed_or_not(monkeypatch):
    """The entry point's dummy weights are llama.init_params' (the same
    seed, the same draws), whether its layers are streamed or a list."""
    cfg = get_model_config(NAME)
    whole = calibrate_cli.dummy_params(cfg, 3, "cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    want = llama.init_params(cfg, gen)
    monkeypatch.setattr(calibrate_cli, "_STREAM_ABOVE", 0)
    streamed = calibrate_cli.dummy_params(cfg, 3, "cpu")
    assert callable(streamed["layers"])
    for got in (whole, streamed):
        assert torch.equal(got["embed"], want["embed"])
        layers = got["layers"]
        for li in range(cfg.num_layers):
            lp = layers(li) if callable(layers) else layers[li]
            for name, p in lp.items():
                wp = want["layers"][li][name]
                assert (torch.equal(p, wp) if torch.is_tensor(p)
                        else all(torch.equal(p[k], wp[k]) for k in wp))
    with pytest.raises(ValueError, match="in order"):
        calibrate_cli.dummy_params(cfg, 3, "cpu")["layers"](1)


def test_moe_calibration_raises_item_5():
    """MoE calibration, once refused, runs (its parity with the JAX
    package is tests/test_torch_moe_calib.py's): five sites a layer,
    down_in as wide as an expert's intermediate, sdown_in as the shared
    expert's, valid permutations."""
    cfg = get_model_config("test-tiny-moe")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, torch.float32)
    calib, stats, bits = compute_calibration(
        cfg, params, np.zeros((1, 8), np.int32), device="cpu")
    widths = {"attn_in": cfg.hidden_size, "o_in": cfg.q_size,
              "mlp_in": cfg.hidden_size, "down_in": cfg.moe_intermediate_size,
              "sdown_in": cfg.shared_expert_size}
    assert len(calib) == cfg.num_layers and 4.5 <= bits < 9.0
    for layer in calib:
        assert set(layer) == set(widths)
        for site, k in widths.items():
            np.testing.assert_array_equal(
                np.sort(layer[site].reorder_index.numpy()), np.arange(k))


def test_artifacts_load_across_packages(tmp_path, both):
    """The port's .npz in the JAX loader and the JAX package's in the
    port's, the metadata with them."""
    (jcalib, _, _), (calib, _, _) = both["hessian", None]
    meta = {"model": NAME, "metric": "hessian", "average_bits": 6.075}
    save_calibration(str(tmp_path / "p.npz"), calib, meta=meta)
    jsave_calibration(str(tmp_path / "j.npz"), jcalib, meta=meta)
    from_port = jload_calibration(str(tmp_path / "p.npz"))
    from_jax = load_calibration(str(tmp_path / "j.npz"))
    assert jload_meta(str(tmp_path / "p.npz")) == meta
    assert load_calibration_meta(str(tmp_path / "j.npz")) == meta
    for src, got in ((calib, from_port), (jcalib, from_jax)):
        assert len(got) == len(src)
        for a, b in zip(src, got):
            assert set(a) == set(b)
            for site in a:
                assert a[site].select_num == b[site].select_num
                np.testing.assert_array_equal(
                    np.asarray(a[site].reorder_index),
                    np.asarray(b[site].reorder_index))
    assert from_jax[0]["attn_in"].reorder_index.dtype == torch.int32


def test_calibrated_arc_reduces_logits_error(setup):
    """ARC's claim on the port: with planted outlier channels (embedding
    columns 0::7 x 8, every layer's input has an outlier tail), NVFP4
    fake quant with the calibrated selection has a lower logits MSE
    against the bf16 forward than with select 0."""
    _, params, _ = setup
    cfg = get_model_config(NAME)
    embed = params["embed"].clone()
    embed[:, 0::7] *= 8.0
    params = dict(params, embed=embed)
    toks = synthetic_stream(cfg.vocab_size, 4 * 64, seed=7).reshape(4, 64)
    tt = torch.from_numpy(toks).long()
    ref = llama.model_forward(cfg, params, tt)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=False)

    def mse(calib):
        qp = quantized.quantize_model_params(cfg, params, calib, qcfg)
        out = quantized.quant_model_forward(cfg, qp, calib, qcfg, tt)
        return float(((out - ref) ** 2).mean())

    calib_real, _, _ = compute_calibration(cfg, params, toks, device="cpu")
    assert any(sc.select_num > 0 for layer in calib_real
               for sc in layer.values())
    mse0 = mse(quantized.identity_calib(cfg, 0.0))
    mse_arc = mse(calib_real)
    assert np.isfinite(mse0) and np.isfinite(mse_arc)
    assert mse_arc < mse0, (mse0, mse_arc)


def test_calibrate_entry_point(tmp_path, capsys):
    """python -m arcquant_tpu_torch.calibrate on the CPU: the JAX script's
    flags and defaults, its file name and meta, its printed lines; the
    artifact equals compute_calibration's on the same weights and
    samples, and the JAX package loads it."""
    d = calibrate_cli.build_parser().parse_args(["--model", NAME])
    assert (d.dataset, d.samples, d.seqlen, d.act_sort_metric,
            d.select_batch, d.output, d.seed, d.cpu) == (
                "synthetic", 128, 2048, "max", 32, "./saved", 0, False)
    r = calibrate_cli.main(["--model", NAME, "--samples", "4", "--seqlen",
                            "64", "--act_sort_metric", "score",
                            "--select_batch", "2", "--output",
                            str(tmp_path), "--cpu"])
    out = capsys.readouterr().out.splitlines()
    path = tmp_path / f"{NAME}_calib_synthetic_score.npz"
    assert out == [f"average bits: {r['avg_bits']:.3f}", f"saved: {path}"]
    assert jload_meta(str(path)) == {
        "model": NAME, "dataset": "synthetic", "metric": "score",
        "samples": 4, "seqlen": 64, "average_bits": r["avg_bits"]}
    cfg = get_model_config(NAME)
    from arcquant_tpu_torch.evals import get_calib_samples
    want, _, _ = compute_calibration(
        cfg, calibrate_cli.dummy_params(cfg, 0, "cpu"),
        get_calib_samples("synthetic", None, 4, 64, cfg.vocab_size, 0),
        metric="score", select_batch=2, device="cpu")
    for a, b in zip(jload_calibration(str(path)), want):
        for site in b:
            assert a[site].select_num == b[site].select_num
            np.testing.assert_array_equal(np.asarray(a[site].reorder_index),
                                          b[site].reorder_index.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            calibrate_cli.main(["--model", NAME, "--output", str(tmp_path)])
