"""The sampler of arcquant_tpu_torch on its own terms, after the JAX
package's tests/test_sampling.py and tests/test_request_features.py.

The port draws Gumbel noise from explicit torch.Generators, so its
streams are not jax.random's: only ``warp_logits`` (no randomness) is
held against the JAX function, its masks exactly and its values within
1e-6 relative (f32 softmax and cumsum in another order). The rest checks
the distribution: temperature 0 is greedy, top-k and top-p restrict the
support, draw frequencies match the softmax within 5 standard errors,
and a seeded request's stream does not depend on what shares its batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.engine.sampling import warp_logits as jax_warp
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import (ContinuousBatcher, EngineConfig,
                                       InferenceEngine, Request,
                                       SamplingParams, sample)
from arcquant_tpu_torch.engine import sampling as smp
from arcquant_tpu_torch.models import quantized


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _logits(seed, b, v):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(
        np.float32) * 2


WARPS = [
    dict(temperature=0.7),
    dict(temperature=[0.5, 1.0, 2.0, 1e-9], top_k=5),
    dict(temperature=1.3, top_p=0.8),
    dict(temperature=[1.0, 0.8, 0.6, 2.5], top_k=12,
         top_p=[0.9, 0.5, 1.0, 0.0]),
]


@pytest.mark.parametrize("kw", WARPS)
def test_warp_logits_matches_jax(kw):
    x = _logits(1, 4, 64)
    want = np.asarray(jax_warp(jnp.asarray(x), **{
        k: (jnp.asarray(v, jnp.float32) if isinstance(v, list) else v)
        for k, v in kw.items()}))
    got = smp.warp_logits(torch.from_numpy(x), **{
        k: (torch.tensor(v) if isinstance(v, list) else v)
        for k, v in kw.items()}).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    live = ~np.isinf(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-6)


def test_temperature_zero_is_greedy():
    x = torch.from_numpy(_logits(2, 4, 32))
    greedy = x.argmax(-1)
    for s in range(5):
        assert torch.equal(sample(x, _gen(s), temperature=0.0).long(),
                           greedy)
    # per row: rows 0 and 2 greedy, rows 1 and 3 hot
    t = torch.tensor([0.0, 5.0, 0.0, 5.0])
    outs = torch.stack([sample(x, _gen(s), temperature=t)
                        for s in range(50)])
    assert (outs[:, 0] == greedy[0]).all() and (outs[:, 2] == greedy[2]).all()
    assert len(set(outs[:, 1].tolist())) > 1


def test_top_k_restricts_support():
    x = torch.from_numpy(_logits(3, 2, 64))
    top = set(torch.topk(x, 4).indices.ravel().tolist())
    for s in range(200):
        got = sample(x, _gen(s), temperature=2.0, top_k=4)
        assert set(got.tolist()) <= top


def test_top_p_restricts_support():
    x = torch.zeros((1, 16))
    x[0, 7] = 5.0                      # p ~ 0.91 at temperature 1
    for s in range(100):
        assert int(sample(x, _gen(s), temperature=1.0, top_p=0.5)[0]) == 7
    seen = {int(sample(x, _gen(s), temperature=3.0)[0]) for s in range(300)}
    assert len(seen) > 1


def test_sampling_matches_softmax_frequencies():
    """20000 independent rows drawn at once: each frequency within 5
    standard errors (sqrt(p (1 - p) / n)) of its softmax probability."""
    n = 20000
    x = torch.tensor([[1.0, 0.0, -1.0, 2.0]]).expand(n, 4)
    p = torch.softmax(x[0], -1).numpy()
    draws = sample(x, _gen(3)).numpy()
    freq = np.bincount(draws, minlength=4) / n
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n)).all(), (
        freq, p)


def test_sample_with_keys_rows_independent():
    """A row's draw depends on its own generator only."""
    x = torch.from_numpy(_logits(4, 3, 50))
    a = smp.sample_with_keys(x, [_gen(1), _gen(2), _gen(3)], 1.0)
    b = smp.sample_with_keys(x[[2, 0]], [_gen(3), _gen(1)], 1.0)
    assert a[2] == b[0] and a[0] == b[1]
    g = [smp.row_generator(1234, step, "cpu") for step in (0, 0, 1)]
    r = smp.sample_with_keys(x[[0, 0, 0]], g, 1.0)
    assert r[0] == r[1]


@pytest.fixture(scope="module")
def eng():
    cfg = get_model_config("test-tiny")
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    return InferenceEngine.dummy(
        cfg, quantized.identity_calib(cfg, 0.125), qcfg,
        EngineConfig(max_batch=2, max_seq_len=64, page_size=16), seed=0,
        device="cpu")


PROMPTS = [[5, 17, 301, 42, 8], [100, 200, 7]]


def test_generate_and_decode_scan_sampling(eng):
    """Same seed, same tokens; temperature 0 is the greedy path."""
    sp = SamplingParams(temperature=1.0, top_k=8)
    a = eng.generate(PROMPTS, 6, sampling=sp, seed=1)
    assert a == eng.generate(PROMPTS, 6, sampling=sp, seed=1)
    assert a != eng.generate(PROMPTS, 6, sampling=sp, seed=2)
    assert all(0 <= t < eng.cfg.vocab_size for row in a for t in row)
    assert (eng.generate(PROMPTS, 6, sampling=SamplingParams(0.0))
            == eng.generate(PROMPTS, 6))

    toks, lens, _ = eng._pad_prompts(PROMPTS)

    def scan(sampling, seed=7):
        logits, state = eng.prefill(eng.new_state(), toks, lens)
        first = logits.argmax(-1).to(torch.int32)
        out, _ = eng.decode_scan(state, first, torch.ones(2, dtype=bool), 5,
                                 sampling=sampling, seed=seed)
        return out
    sp = SamplingParams(temperature=0.8, top_k=8)
    assert torch.equal(scan(sp), scan(sp))
    assert torch.equal(scan(SamplingParams(temperature=0.0)), scan(None))


def test_seeded_request_independent_of_batch(eng):
    """A seeded sampled request emits the same tokens whatever shares
    its batch and whatever the batcher's own seed; another seed gives
    another stream; a greedy companion keeps its greedy output."""
    def run(batcher_seed, companions, seed=1234):
        bt = ContinuousBatcher(eng, top_k=8, seed=batcher_seed)
        target = Request(prompt=list(PROMPTS[0]), max_new_tokens=8,
                         temperature=1.0, seed=seed)
        bt.submit(target)
        for c in companions:
            bt.submit(c)
        bt.run()
        return target.output

    greedy = ContinuousBatcher(eng)
    greedy.submit(Request(prompt=[9, 9, 9], max_new_tokens=8))
    greedy_out = greedy.run()[0].output

    companion = Request(prompt=[9, 9, 9], max_new_tokens=8)
    alone = run(0, [])
    assert alone == run(7, [companion]) == run(
        99, [Request(prompt=[3, 1, 4], max_new_tokens=8, temperature=1.5)])
    assert companion.output == greedy_out
    assert run(0, [], seed=4321) != alone
