"""The packed-vs-fake gap of the accuracy path, the port's against the
JAX package's own, on the same weights and tokens (test-tiny, every
layer, f32 and bf16 params, per-row activation scales, select 0.125).

The two routes of quant_model_forward are not one function up to
summation order, in either package: the packed linear's epilogue is
(y * gx) * gw, the fake one's y * (gx * gs), and packed attention is the
flash kernel (here its plain version, q scaled before the scores), the
fake one f32 dense attention (scaled after). So their perplexities and
logits differ a little in the reference itself. The port's gap is a
fault only where it exceeds the reference's by more than the tolerance:

- perplexity (eval_ppl over the synthetic stream, 4 windows of 64): the
  relative gap |packed - fake| / fake within 1e-5 of the JAX package's
  (an f32 perplexity near 500 has an ulp of 6e-8 relative; the windows'
  NLL sums add in another order in the two packages);
- logits (one forward of the same 4 x 64 tokens): the relative L2 gap
  within 5% (plus 1e-6) of the JAX package's.

The JAX side runs eagerly (jax.disable_jit, its Pallas kernels in
interpret mode), as the accuracy tests hold the port to the eager
reference: its jitted forward moves by more than these gaps on bf16
params (ROADMAP queue 3). At this size both packages' gaps are below
5e-7 (perplexity) and 3e-7 (logits); the 28-layer gap at Qwen2.5-7B
width is measured on the card (chip_smoke.py [eval]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.evals import data as jdata
from arcquant_tpu.evals import ppl as jppl
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.evals import ppl
from arcquant_tpu_torch.models import quantized

NAME = "test-tiny"
SELECT = 0.125
SEQLEN, WINDOWS = 64, 4
ROUTES = {"fake": dict(use_kernels=False, act_scale="row"),
          "packed": dict(use_kernels=True, act_scale="row")}


@pytest.fixture(scope="module", params=["f32", "bf16"])
def routes(request):
    """{route: (JAX tree, port tree)} from the same raw params, each
    package quantizing its own, and the synthetic stream."""
    dtype = jnp.float32 if request.param == "f32" else jnp.bfloat16
    jcfg, cfg = jax_model_config(NAME), get_model_config(NAME)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    out = {}
    for name, kw in ROUTES.items():
        jtree = jquantized.quantize_model_params(
            jcfg, jp, jquantized.identity_calib(jcfg, SELECT),
            JQuantConfig(**kw))
        tree = quantized.quantize_model_params(
            cfg, params, quantized.identity_calib(cfg, SELECT),
            QuantConfig(**kw))
        out[name] = (jtree, tree)
    stream = jdata.synthetic_stream(cfg.vocab_size, WINDOWS * SEQLEN, 0)
    return out, stream


def _gap(packed, fake) -> float:
    return abs(packed - fake) / abs(fake)


def test_ppl_gap_within_the_reference(routes):
    trees, stream = routes
    jcfg, cfg = jax_model_config(NAME), get_model_config(NAME)
    got, want = {}, {}
    for name, kw in ROUTES.items():
        jtree, tree = trees[name]
        with jax.disable_jit():
            want[name] = jppl.eval_ppl(
                jcfg, jtree, jnp.asarray(stream), SEQLEN, JQuantConfig(**kw),
                jquantized.identity_calib(jcfg, SELECT), batch=WINDOWS)
        got[name] = ppl.eval_ppl(cfg, tree, stream, SEQLEN, QuantConfig(**kw),
                                 quantized.identity_calib(cfg, SELECT),
                                 batch=WINDOWS)
    port, ref = (_gap(d["packed"], d["fake"]) for d in (got, want))
    print(f"PPL port {got}, JAX {want}: gap port {port:.3e}, JAX {ref:.3e}")
    assert all(np.isfinite(v) and v > 1 for v in got.values())
    assert port <= ref + 1e-5, (got, want)


def test_logits_gap_within_the_reference(routes):
    trees, stream = routes
    jcfg, cfg = jax_model_config(NAME), get_model_config(NAME)
    toks = stream[:WINDOWS * SEQLEN].reshape(WINDOWS, SEQLEN)
    got, want = {}, {}
    for name, kw in ROUTES.items():
        jtree, tree = trees[name]
        with jax.disable_jit():
            want[name] = np.asarray(jquantized.quant_model_forward(
                jcfg, jtree, jquantized.identity_calib(jcfg, SELECT),
                JQuantConfig(**kw), jnp.asarray(toks)), np.float64)
        got[name] = quantized.quant_model_forward(
            cfg, tree, quantized.identity_calib(cfg, SELECT),
            QuantConfig(**kw), torch.from_numpy(toks)).double().numpy()

    def rel(d):
        return float(np.linalg.norm(d["packed"] - d["fake"])
                     / np.linalg.norm(d["fake"]))
    port, ref = rel(got), rel(want)
    print(f"logits gap port {port:.4e}, JAX {ref:.4e}")
    assert port <= 1.05 * ref + 1e-6, (port, ref)
