"""The decode step the port captures as a CUDA graph (engine.py's
static-buffer decode body, with sampling and the eos update inside),
run eagerly on the CPU, held against the JAX engine's on-device
``decode_scan`` and against the port's own eager loop
(``cuda_graphs=False``).

  (a) the body against JAX ``decode_scan`` on test-tiny and
      test-qwen-tiny (f32 params, as tests/test_torch_engine.py, whose
      docstring says why; W4A4 NVFP4 + ARC, w8, pages of 16): greedy
      tokens equal, with an eos id hit mid-run and one inactive slot;
      the same run bitwise equal to the loop (tokens, seq_lens after,
      and each step's logits through decode_step);
  (b) no host read in the step: the body runs under a dispatch mode
      that raises on aten._local_scalar_dense, aten.nonzero and
      aten.is_nonzero, in five configurations (dense ARC, select-free
      with the fused routes, w4, BF16, test-tiny-moe in dense mode);
  (c) sampled decode_scan with a seed: the body bitwise equal to the
      loop;
and the bookkeeping around the graphs: the launch counts a capture
takes back and a replay adds (kernels/_build.py GraphLaunches), and the
engine's cache of decode bodies keyed by the state's tensors.

The card's side (capture, replay, bitwise against the loop at Qwen2.5-7B
width) is in tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.engine import InferenceEngine as JEngine
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.engine import engine as engine_mod
from arcquant_tpu_torch.engine.sampling import SamplingParams
from arcquant_tpu_torch.kernels import _build
from arcquant_tpu_torch.kernels import mlp_fused as mf
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.models import quantized

# three prompts in a batch of four: slot 3 is inactive throughout
PROMPTS = [[5, 17, 301, 42, 8, 9, 10], [100, 200, 7], list(range(1, 40))]
STEPS = 8
EOS_STEP = 3          # row 0's token at this step becomes the eos id
QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
           act_scale="row", w_scale="channel", quantize_lm_head=True)
EKW = dict(max_batch=4, max_seq_len=64, page_size=16)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


@pytest.fixture(scope="module", params=["test-tiny", "test-qwen-tiny"])
def scans(request):
    """JAX decode_scan with an eos id taken from the port's loop (row 0's
    token at EOS_STEP), and the port's body and loop on the JAX engine's
    packed params, each from the same prefill."""
    name = request.param
    cfg = jax_model_config(name)
    params = jllama.init_params(cfg, jax.random.PRNGKey(2), jnp.float32)
    rng = np.random.default_rng(2)
    for layer in params["layers"]:     # non-zero qkv biases (Qwen2)
        for proj in ("q", "k", "v"):
            if "b" in layer[proj]:
                layer[proj]["b"] = jnp.asarray(
                    rng.standard_normal(layer[proj]["b"].shape) * 0.1,
                    jnp.float32)
    calib = jquantized.identity_calib(cfg, select_frac=0.125)
    jeng = JEngine(cfg, params, calib, JQuantConfig(**QKW),
                   JEngineConfig(**EKW))
    toks, lens, _ = jeng._pad_prompts(PROMPTS)
    assert lens[3] == 0
    qparams = jax.tree.map(np.asarray, jeng.qparams)

    def port(cuda_graphs):
        return InferenceEngine(
            get_model_config(name), convert.qparams_from_numpy(qparams),
            convert.calib_from_numpy(calib), QuantConfig(**QKW),
            EngineConfig(**EKW), device="cpu", quantize_params=False,
            cuda_graphs=cuda_graphs)

    def run(eng, eos_id):
        logits, state = eng.prefill(eng.new_state(), toks, lens)
        first = logits.argmax(-1).to(torch.int32)
        out, state = eng.decode_scan(state, first, torch.as_tensor(lens > 0),
                                     STEPS, eos_id=eos_id)
        return first, out, state[2].clone()

    loop, body = port(False), port(True)
    eos = int(run(loop, None)[1][0, EOS_STEP])
    logits, state = jeng.prefill(jeng.new_state(), jnp.asarray(toks),
                                 jnp.asarray(lens))
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    jout, _ = jeng.decode_scan(state, first, jnp.asarray(lens > 0), STEPS,
                               eos_id=eos)
    return dict(eos=eos, lens=lens, toks=toks,
                jax=(np.asarray(first), np.asarray(jout)),
                body=run(body, eos), loop=run(loop, eos),
                engines=(body, loop))


def test_body_matches_jax_decode_scan(scans):
    """Greedy tokens equal to JAX's decode_scan, the eos id hit mid-run
    (the slot then repeats it) and the inactive slot repeating its
    first token."""
    first, out, _ = scans["body"]
    jfirst, jout = scans["jax"]
    np.testing.assert_array_equal(first.numpy(), jfirst)
    np.testing.assert_array_equal(out.numpy(), jout)
    row = out[0].tolist()
    hit = row.index(scans["eos"])
    assert 0 < hit < STEPS - 1
    assert row[hit:] == [scans["eos"]] * (STEPS - hit)
    assert out[3].tolist() == [int(first[3])] * STEPS


def test_body_bitwise_equals_loop(scans):
    """The body's tokens and seq_lens after the run equal the eager
    loop's; seq_lens stop growing where a slot retired."""
    _, out, lens_after = scans["body"]
    _, lout, llens_after = scans["loop"]
    assert torch.equal(out, lout)
    assert torch.equal(lens_after, llens_after)
    hit = out[0].tolist().index(scans["eos"])
    assert int(lens_after[0]) == scans["lens"][0] + hit + 1
    assert int(lens_after[3]) == 0


def test_body_decode_step_logits_bitwise_equal_loop(scans):
    """decode_step through the body returns the loop's logits bit for
    bit at every step, fed the same tokens."""
    body, loop = scans["engines"]
    toks, lens = scans["toks"], scans["lens"]
    active = torch.as_tensor(lens > 0)
    (lb, sb), (ll, sl) = (e.prefill(e.new_state(), toks, lens)
                          for e in (body, loop))
    for _ in range(4):
        cur = ll.argmax(-1).to(torch.int32)
        lb, sb = body.decode_step(sb, cur, active)
        ll, sl = loop.decode_step(sl, cur, active)
        assert torch.equal(_bits(lb), _bits(ll))
    assert torch.equal(sb[2], sl[2])


# -- (b) no host read ----------------------------------------------------------

class NoHostRead(TorchDispatchMode):
    """Raises on the ops that read a device value back to the host."""
    BANNED = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
              torch.ops.aten.is_nonzero)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.BANNED:
            raise AssertionError(f"host read in the decode step: {func}")
        return func(*args, **(kwargs or {}))


def test_no_host_read_mode_sees_host_reads():
    x = torch.arange(3)
    for read in (lambda: x[0].item(), lambda: torch.nonzero(x),
                 lambda: bool(x[1])):
        with NoHostRead(), pytest.raises(AssertionError, match="host read"):
            read()


CONFIGS = {
    "dense-arc": ("test-tiny", 0.125, dict(QKW)),
    "select-free-fused": ("test-qwen-tiny", 0.0, dict(QKW)),
    "w4": ("test-tiny", 0.125, dict(QKW, weight_fmt="w4")),
    "bf16": ("test-tiny", 0.125, dict(quant_type="BF16")),
    "moe-dense": ("test-tiny-moe", 0.125, dict(QKW)),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_decode_body_reads_nothing_back(config, monkeypatch):
    """decode_step and decode_scan (greedy with an eos id, and sampled
    with top-k and top-p) through the body make no host read; the
    select-free configuration takes its megakernels' routes."""
    name, sel, qkw = CONFIGS[config]
    cfg = get_model_config(name)
    eng = InferenceEngine.dummy(cfg, quantized.identity_calib(cfg, sel),
                                QuantConfig(**qkw), EngineConfig(**EKW),
                                seed=3, device="cpu")
    fused = {"n": 0}
    real = mf.mlp_w8_fused

    def counted(*a, **kw):
        fused["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(mf, "mlp_w8_fused", counted)
    toks, lens, _ = eng._pad_prompts([[5, 17, 301], [100, 200, 7, 1],
                                      [9, 8], [3]])
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    first = logits.argmax(-1).to(torch.int32)
    active = torch.ones(4, dtype=torch.bool)
    eos = int(first[0]) + 1
    with NoHostRead():
        logits, state = eng.decode_step(state, first, active)
        out, state = eng.decode_scan(state, first, active, 3, eos_id=eos)
        out, state = eng.decode_scan(
            state, first, active, 2,
            sampling=SamplingParams(0.8, top_k=8, top_p=0.9), seed=1)
    assert out.shape == (4, 2)
    assert torch.isfinite(logits).all()
    assert (fused["n"] > 0) == (config == "select-free-fused")


# -- (c) sampled runs ----------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    cfg = get_model_config("test-tiny")
    calib = quantized.identity_calib(cfg, 0.125)
    body = InferenceEngine.dummy(cfg, calib, QuantConfig(**QKW),
                                 EngineConfig(**EKW), seed=4, device="cpu")
    loop = InferenceEngine(cfg, body.qparams, calib, QuantConfig(**QKW),
                           EngineConfig(**EKW), device="cpu",
                           quantize_params=False, cuda_graphs=False)
    return body, loop


@pytest.mark.parametrize("sampling", [
    SamplingParams(temperature=0.8, top_k=8),
    SamplingParams(temperature=1.0, top_p=0.9)], ids=["top_k", "top_p"])
def test_sampled_scan_bitwise_equals_loop(tiny_pair, sampling):
    """Sampled decode_scan: the body's tokens equal the loop's for the
    same seed (one generator, reseeded, drawing once a step), with an
    eos id; another seed gives other tokens."""
    toks, lens, _ = tiny_pair[0]._pad_prompts(PROMPTS)

    def scan(eng, seed, eos_id=None):
        logits, state = eng.prefill(eng.new_state(), toks, lens)
        first = logits.argmax(-1).to(torch.int32)
        out, state = eng.decode_scan(state, first, torch.as_tensor(lens > 0),
                                     STEPS, eos_id=eos_id, sampling=sampling,
                                     seed=seed)
        return out, state[2]
    (a, la), (b, lb) = (scan(e, 5) for e in tiny_pair)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, scan(tiny_pair[0], 6)[0])
    eos = int(a[1, 2])
    (a, la), (b, lb) = (scan(e, 5, eos) for e in tiny_pair)
    assert torch.equal(a, b) and torch.equal(la, lb)


def test_scan_longer_than_its_out_buffer(tiny_pair, monkeypatch):
    """A scan past SCAN_CHUNK steps copies the out-buffer out as it
    fills and gives the loop's tokens; 0 steps gives [B, 0]."""
    monkeypatch.setattr(engine_mod, "SCAN_CHUNK", 3)
    body, loop = tiny_pair
    body.drop_graphs()
    toks, lens, _ = body._pad_prompts(PROMPTS)
    outs = []
    for eng in (body, loop):
        logits, state = eng.prefill(eng.new_state(), toks, lens)
        first = logits.argmax(-1).to(torch.int32)
        empty, state = eng.decode_scan(state, first, lens > 0, 0)
        assert empty.shape == (4, 0)
        outs.append(eng.decode_scan(state, first, lens > 0, 7)[0])
    body.drop_graphs()
    assert outs[0].shape == (4, 7) and torch.equal(*outs)


# -- the bookkeeping -----------------------------------------------------------

def test_graph_launches_take_back_the_capture_and_count_replays():
    """Counts added inside GraphLaunches are taken back when it exits;
    replayed(n) adds them n times, by_m included."""
    a, b = qk.ACTQ, mf.MLP_W8
    assert a in _build.KERNELS and b in _build.KERNELS
    saved = [(k, k.launches, dict(k.by_m)) for k in (a, b)]
    try:
        for k in (a, b):
            k.reset()
        a.launches, a.by_m[4] = 1, 1       # launched before the capture
        with _build.GraphLaunches() as rec:
            a.launches += 2
            a.by_m[4] += 2
            b.launches += 1
        assert (a.launches, dict(a.by_m), b.launches) == (1, {4: 1}, 0)
        assert rec.total == 3
        rec.replayed(5)
        assert (a.launches, dict(a.by_m), b.launches) == (11, {4: 11}, 5)
    finally:
        for k, n, by_m in saved:
            k.reset()
            k.launches = n
            k.by_m.update(by_m)


def test_decode_bodies_cached_by_state(tiny_pair, monkeypatch):
    """One body per (state, route, sampling), reused for the same state,
    at most GRAPH_CACHE kept (least recently used out), drop_graphs
    clears them; the loop engine keeps none."""
    monkeypatch.setattr(engine_mod, "GRAPH_CACHE", 2)
    body, loop = tiny_pair
    body.drop_graphs()
    states = [body.new_state() for _ in range(3)]
    first, active = (torch.zeros(4, dtype=torch.int32),
                     torch.ones(4, dtype=torch.bool))
    body.decode_scan(states[0], first, active, 1)
    body.decode_scan(states[0], first, active, 1)
    assert len(body._graphs) == 1
    body.decode_scan(states[0], first, active, 1,
                     sampling=SamplingParams(0.7))
    body.decode_step(states[1], first, active)
    key = engine_mod._state_key
    assert [(k[0], k[2]) for k in body._graphs] == [
        (key(states[0]), SamplingParams(0.7)), (key(states[1]), None)]
    body.decode_step(states[0], first, active)      # (states[0], greedy)
    assert [k[0] for k in body._graphs] == [key(states[1]), key(states[0])]
    body.drop_graphs()
    assert not body._graphs
    loop.decode_scan(loop.new_state(), first, active, 1)
    assert not loop._graphs
