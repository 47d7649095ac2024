"""Test helpers for holding the port against the JAX package.

Inputs are made with numpy and handed to both packages; bf16 crosses as
a uint16 view. Importing this module caps torch at one intra-op thread:
the test suite runs several pytest-xdist workers side by side, and each
would otherwise start one thread per core.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from .convert import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

# Tests that need an NVIDIA GPU (the CUDA kernels have no CPU mode).
# The marker is registered in tests/conftest.py; `require_cuda` decides
# at run time, inside the test, whether a card is present.
gpu = pytest.mark.gpu


def require_cuda() -> None:
    """Skip the calling test unless torch sees a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy (or a JAX array via np.asarray) -> torch, bf16 included."""
    return tensor_from_numpy(np.asarray(a), device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy f32 (bf16 widened exactly), other dtypes as is."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def outlier_x(rng: np.random.Generator, m: int, k: int,
              scale: float = 25.0) -> np.ndarray:
    """Gaussian activations with k/32 planted outlier channels (f32)."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    cols = rng.choice(k, k // 32, replace=False)
    x[:, cols] *= scale
    return x


# -- #18 arc_residual's inputs ------------------------------------------------

# e2m1's decision boundaries (ties go to the smaller magnitude), its grid
# and zero, in units of a group's scale
_E2M1_PLACES = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0,
                0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 0.0)
# xa's columns past the residual hold this: nothing may write them
ARC_SENTINEL = 7.0


def _bf16_f32(x) -> np.ndarray:
    """Values rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _bf16_step(x: np.ndarray, up: np.ndarray) -> np.ndarray:
    """The bf16 neighbour of each (bf16, nonzero) x away from zero where
    `up`, toward it elsewhere."""
    b = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    bits = b.view(torch.int16).numpy().astype(np.int32)
    bits = bits + np.where(up, 1, -1)
    return torch.from_numpy(bits.astype(np.int16)).view(
        torch.bfloat16).float().numpy()


def arc_residual_case(rng: np.random.Generator, m: int, k: int, ke: int,
                      mode: str = "plain", pad: int = 32):
    """Inputs of #18 arc_residual as numpy: (src, xa, gx, ridx), src
    [m, k] (plain) or [m, 2k] (silu_mul: gate, then up) and xa [m, k + ke
    + pad] f32 values exact in bf16, gx f32 [m, 1], ridx an int32
    permutation of k whose last ke entries are the residual columns.

    Rows r % 3 == 0 and 1 take gx 1 and 2^-3, and there each residual
    column's err = v / gx - xa[r, c] (v the selected value, src[r, c] or
    bf16(silu(g) u) with g 32, where silu is the identity in f32) is
    planted, a 16-column group at a time, kind (group + row) % 5: 0 the
    e2m1 boundaries (exact ties), grid points and zero of a normal ue4m3
    scale s, one element +-6 s so that the group's scale is s; 1 the same
    with a subnormal s (a multiple of 2^-9); 2 zeros, half of them -0.0;
    3 random; 4 kind 0's values moved one bf16 step either way. xa[r, c]
    is 0 or +-2 s or +-4 s where v stays exact. Rows r % 3 == 2 are
    random (gate N(0, 9) with a tenth of it in +-[20, 60]), gx the row's
    max / 2688 and xa near v / gx. xa[:, k:k+ke] holds garbage, its
    columns past k + ke ARC_SENTINEL."""
    if mode not in ("plain", "silu_mul") or ke % 16:
        raise ValueError(f"arc_residual_case: mode {mode!r}, ke {ke}")
    g = ke // 16
    kind = (np.arange(g)[None] + np.arange(m)[:, None]) % 5       # [m, G]
    s = np.where(kind == 1, rng.integers(1, 8, (m, g)) * 2.0 ** -9,
                 2.0 ** rng.integers(-6, 6, (m, g))
                 * (1 + rng.integers(0, 8, (m, g)) / 8))
    b = rng.choice(np.asarray(_E2M1_PLACES), (m, g, 16))
    top = rng.integers(0, 16, (m, g))
    np.put_along_axis(b, top[..., None], 6.0, axis=-1)
    sign = rng.choice([-1.0, 1.0], (m, g, 16))
    err = sign * b * s[..., None]
    near = np.where(err == 0, err, _bf16_step(err, rng.random(err.shape)
                                              < 0.5))
    is_top = np.arange(16)[None, None] == top[..., None]
    err = np.where((kind == 4)[..., None] & ~is_top, near, err)
    err = np.where((kind == 2)[..., None], np.copysign(0.0, sign), err)
    err = np.where((kind == 3)[..., None],
                   _bf16_f32(rng.standard_normal((m, g, 16))
                             * 2 * s[..., None]), err)
    err, s = err.reshape(m, ke), np.repeat(s, 16, axis=1)
    gx = np.where(np.arange(m)[:, None] % 3 == 0, 1.0, 0.125)
    q = rng.choice([0.0, 2.0, -2.0, 4.0, -4.0], (m, ke)) * s
    v = (err + q) * gx
    exact = (_bf16_f32(v) == v) & (kind.repeat(16, axis=1) != 2)
    q = np.where(exact, q, 0.0)
    v = np.where(exact, v, err * gx)
    gate = np.full((m, ke), 32.0)
    # the random rows
    rand = np.arange(m) % 3 == 2
    gr = rng.standard_normal((m, ke)) * 3
    wide = rng.random((m, ke)) < 0.1
    gr = np.where(wide, rng.choice([-1.0, 1.0], (m, ke))
                  * rng.uniform(20, 60, (m, ke)), gr)
    gr, ur = _bf16_f32(gr), _bf16_f32(rng.standard_normal((m, ke)))
    vr = (_bf16_f32(gr * (1 / (1 + np.exp(-gr.astype(np.float64)))) * ur)
          if mode == "silu_mul" else ur)
    gxr = np.maximum(np.abs(vr).max(axis=1, keepdims=True) / 2688, 1e-12)
    qr = _bf16_f32(vr / gxr * (1 + 0.05 * rng.standard_normal((m, ke))))
    v = np.where(rand[:, None], vr, v)
    q = np.where(rand[:, None], qr, q)
    gate = np.where(rand[:, None], gr, gate)
    gx = np.where(rand[:, None], gxr, gx).astype(np.float32)

    ridx = rng.permutation(k).astype(np.int32)
    cols = ridx[k - ke:]
    width = 2 * k if mode == "silu_mul" else k
    src = _bf16_f32(rng.standard_normal((m, width)) * 2)
    if mode == "silu_mul":
        src[:, cols] = gate
        src[:, cols + k] = np.where(rand[:, None], ur, v / 32)
    else:
        src[:, cols] = v
    xa = np.full((m, k + ke + pad), ARC_SENTINEL, np.float32)
    xa[:, :k + ke] = _bf16_f32(rng.standard_normal((m, k + ke)))
    xa[:, cols] = q
    return src.astype(np.float32), xa, gx, ridx


# -- the conditioned dummy init -----------------------------------------------
# llama.init_params' draws (unit norms, N(0, 1/K) linears, a 0.02
# embedding) make a forward of 2 or more layers chaotic at the ulp level:
# each unit-gain residual branch swamps the small embedding, so every
# layer's freshly quantized branch becomes the whole stream and one e2m1
# flip moves the logits. These weights keep the stream larger than the
# branches that write to it: an embedding of unit rms, and the outputs of
# the 2L residual branches (o and down; an MoE layer's expert and shared
# expert down) scaled by CONDITIONED_BRANCH / sqrt(2L), GPT-2's residual
# scaling, so that all branches together stay at CONDITIONED_BRANCH of
# the stream at any depth. The factor trades the noise floor against the
# quantization's own weight: at Qwen2.5-7B width and 2 layers the layers'
# NVFP4 against BF16 (the head in bf16) stands 8-10 times the deficit of
# 2^-22 GEMM noise from 1 at factors 1/4 to 1/16 and 15 times at 1/32
# (on an H100, chip_smoke.py [conditioned]).
CONDITIONED_BRANCH = 1 / 32


def branch_scale(cfg) -> float:
    """The factor of a residual branch's output weights at cfg's depth."""
    return CONDITIONED_BRANCH / math.sqrt(2 * cfg.num_layers)


def conditioned_layer(cfg, gen: torch.Generator, dtype=torch.bfloat16,
                      device="cpu"):
    """One decoder layer of the conditioned init: llama.init_layer_params'
    draws from `gen`, the residual branches' output weights times
    branch_scale(cfg) (then rounded to dtype again)."""
    from .models import llama
    scale = branch_scale(cfg)
    p = llama.init_layer_params(cfg, gen, dtype, device)
    outs = [p["o"]]
    if "moe" in p:
        outs += [p["moe"][k] for k in ("down", "sdown") if k in p["moe"]]
    else:
        outs.append(p["down"])
    for lin in outs:
        lin["w"] = lin["w"] * scale
    return p


# A greedy token is a tie when the reference's two largest logits are
# closer than this share of the row's rms: the head reads a bf16
# activation, and two forwards whose activations sit an ulp apart on most
# elements move a logit by up to about 1.5% of the row's rms (the port
# against the JAX engine on test-qwen-tiny, the same weights: 0.8-1.5%).
TIE_RESOLUTION = 2.0 ** -6


def greedy_ties(ref, draws=()) -> torch.Tensor:
    """The rows of reference logits `ref` [B, V] (numpy or torch) whose
    greedy token is a tie: a top-2 gap under TIE_RESOLUTION of the row's
    rms, or a greedy token that one of `draws` (the reference with noise,
    the same shape) changes. A bool tensor [B]."""
    ref = torch.as_tensor(np.asarray(ref, np.float64))
    top = ref.topk(2, dim=-1).values
    rms = ref.pow(2).mean(-1).sqrt()
    ties = top[:, 0] - top[:, 1] < TIE_RESOLUTION * rms
    for d in draws:
        d = torch.as_tensor(np.asarray(d, np.float64))
        ties |= d.argmax(-1) != ref.argmax(-1)
    return ties


def same_greedy(got, ref, draws=()) -> tuple:
    """Greedy tokens of logits `got` against the reference's, ties
    (greedy_ties) aside: (equal at every other row, the number of rows
    that are ties, the number of rows whose tokens differ)."""
    got = torch.as_tensor(np.asarray(got, np.float64))
    ties = greedy_ties(ref, draws)
    differ = got.argmax(-1) != torch.as_tensor(
        np.asarray(ref, np.float64)).argmax(-1)
    return (not bool((differ & ~ties).any()), int(ties.sum()),
            int(differ.sum()))


def conditioned_tree(cfg, gen: torch.Generator, dtype, device,
                     layers: list) -> dict:
    """The tree around `layers` (drawn first from gen), engine.dummy_tree's
    place: an N(0, 1) embedding, a unit final norm and, for an untied
    config, an N(0, 1/D) lm_head (unit-scale logits), drawn in that
    order."""
    def normal(shape, std):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * std).to(dtype)
    d = cfg.hidden_size
    tree = {"embed": normal((cfg.vocab_size, d), 1.0),
            "final_norm": torch.ones((d,), dtype=dtype, device=device),
            "layers": layers}
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal((cfg.vocab_size, d), d ** -0.5)
    return tree


def conditioned_params(cfg, gen: torch.Generator, dtype=torch.bfloat16,
                       device="cpu"):
    """The conditioned init's whole tree, in the layout
    convert.params_from_numpy and the engines take: the layers
    (conditioned_layer), then conditioned_tree's embedding and head."""
    layers = [conditioned_layer(cfg, gen, dtype, device)
              for _ in range(cfg.num_layers)]
    return conditioned_tree(cfg, gen, dtype, device, layers)


def conditioned_engine(cfg, calib, qcfg, ecfg, seed: int = 0, device="cuda",
                       **kw):
    """InferenceEngine.dummy (dense or MoE) on conditioned_params' weights
    from `seed` (the same draws), each layer packed as it is drawn, so the
    bf16 model never exists at once. kw: the constructor's switches
    (cuda_graphs, fused_decode)."""
    from .engine.engine import InferenceEngine
    return InferenceEngine.dummy(cfg, calib, qcfg, ecfg, seed, device,
                                 layer_init=conditioned_layer,
                                 tree=conditioned_tree, **kw)


# -- rank workers of the tensor-parallel tests -------------------------------
# parallel.launch runs them in processes of their own, which import the
# port and never JAX: the test passes numpy inputs (a calibration as
# [{site: (reorder_index, select_num)}]) and holds the results it gets
# back against the JAX package.

def calib_arrays(calib) -> list:
    """A calibration (either package's) as numpy: [{site: (index, KE)}]."""
    return [{s: (np.asarray(to_numpy(c.reorder_index)
                            if isinstance(c.reorder_index, torch.Tensor)
                            else c.reorder_index), int(c.select_num))
             for s, c in layer.items()} for layer in calib]


def _calib(arrays, device="cpu") -> list:
    from .models.quantized import SiteCalib
    return [{s: SiteCalib(torch.as_tensor(np.asarray(r)).to(device), n)
             for s, (r, n) in layer.items()} for layer in arrays]


def tp_tasks(ctx, tasks):
    """Run [(worker name, args)] of this module on one rank, in order."""
    return [globals()[name](ctx, *args) for name, args in tasks]


def tp_exact_quantize(ctx, x, w, ridx, ke, per_rows):
    """This rank's exact-ARC row-site quantize of x [M, K] (the shard's
    index and position arrays from shard_linear_row on w): {per_row:
    (xa, gx)} as numpy."""
    from .models.quantized import SiteCalib
    from .parallel import tp as tpm
    calib = SiteCalib(torch.as_tensor(ridx), ke)
    _, idx, pos, kc, _ = tpm.shard_linear_row(
        torch.as_tensor(w), None, calib, ctx.tp, "w8", ctx.rank, exact=True)
    ks = x.shape[1] // ctx.tp
    xl = torch.as_tensor(x)[:, ctx.rank * ks:(ctx.rank + 1) * ks]
    out = {}
    for per_row in per_rows:
        xa, gx = tpm._quantize_x_rowshard_exact(xl, idx, pos, kc, ke,
                                                ks + kc, ctx, per_row)
        out[per_row] = (to_numpy(xa), to_numpy(gx))
    return out


def tp_forward(ctx, name, params, calib, tokens):
    """tp_quant_model_forward's logits on this rank (numpy)."""
    from .config import QuantConfig, get_model_config
    from .parallel import tp as tpm
    cfg = get_model_config(name)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True)
    calib = _calib(calib)
    qp = tpm.shard_model_params_tp(cfg, params_from_numpy(params), calib,
                                   qcfg, ctx)
    return to_numpy(tpm.tp_quant_model_forward(
        cfg, qp, calib, qcfg, ctx, torch.as_tensor(tokens)))


# The TP engine tests' configuration: the port's engine tests' (W4A4 NVFP4,
# w8, per-row activation and per-channel weight scales, W4A16 packed head),
# two slots of 64 tokens on pages of 16; TP_CHUNK for chunked prefill.
TP_QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
              act_scale="row", w_scale="channel", quantize_lm_head=True)
TP_EKW = dict(max_batch=2, max_seq_len=64, page_size=16)
TP_CHUNK = 16
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "broadcast", "reduce", "reduce_scatter",
                "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "gather", "scatter", "send", "recv", "isend", "irecv",
                "barrier")


def _count_collectives(fn):
    """fn() with every torch.distributed collective wrapped: (its result,
    {name or "all_reduce:<op>": calls})."""
    import torch.distributed as dist
    counts, saved = {}, {}

    ops = {dist.ReduceOp.SUM: "sum", dist.ReduceOp.MAX: "max"}

    def wrap(name, orig):
        def f(*a, **kw):
            key = name
            if name == "all_reduce":
                op = kw.get("op", a[1] if len(a) > 1 else dist.ReduceOp.SUM)
                key = f"all_reduce:{ops.get(op, op)}"
            counts[key] = counts.get(key, 0) + 1
            return orig(*a, **kw)
        return f

    for name in _COLLECTIVES:
        if hasattr(dist, name):
            saved[name] = getattr(dist, name)
            setattr(dist, name, wrap(name, saved[name]))
    try:
        return fn(), counts
    finally:
        for name, orig in saved.items():
            setattr(dist, name, orig)


def tp_engine_run(ctx, name, params, calib, toks, lens, fed, verify_toks,
                  verify_valid):
    """One TP engine's steps on this rank (numpy logits): the one-shot
    prefill, 3 decode steps fed `fed`, a verify of verify_toks /
    verify_valid, and a chunked prefill (prefill_chunk TP_CHUNK)."""
    from .config import QuantConfig, get_model_config
    from .engine import EngineConfig
    from .parallel import TPInferenceEngine
    cfg = get_model_config(name)
    qcfg = QuantConfig(**TP_QKW)
    p, c = params_from_numpy(params), _calib(calib)
    eng = TPInferenceEngine(cfg, p, c, qcfg, EngineConfig(**TP_EKW), ctx)
    out = {}
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    out["prefill"] = to_numpy(logits)
    active = torch.as_tensor(lens > 0)
    for i, cur in enumerate(fed):
        logits, state = eng.decode_step(state, torch.as_tensor(cur), active)
        out[f"decode{i + 1}"] = to_numpy(logits)
    out["verify"] = to_numpy(eng.verify_step(state, verify_toks,
                                             verify_valid)[0])
    chunked = TPInferenceEngine(cfg, p, c, qcfg, EngineConfig(
        prefill_chunk=TP_CHUNK, **TP_EKW), ctx)
    out["chunked"] = to_numpy(chunked.prefill(chunked.new_state(), toks,
                                              lens)[0])
    return out


def graph_path_run(eng, toks, lens, fed, vt, vv, scan_steps) -> dict:
    """An engine's steps for the graph-path checks (numpy): _steps (the
    prefill, decode steps fed `fed`, a verify of vt / vv), a greedy
    decode_scan of scan_steps from the prefill's tokens, and a sampled
    one (top-k 8, seed 5) of 5."""
    from .engine import SamplingParams
    out = _steps(eng, toks, lens, fed, vt, vv)
    act = torch.as_tensor(np.asarray(lens) > 0)

    def scan(n, sampling=None):
        logits, state = eng.prefill(eng.new_state(), toks, lens)
        t, _ = eng.decode_scan(state, logits.argmax(-1).to(torch.int32),
                               act, n, sampling=sampling, seed=5)
        return to_numpy(t)

    out["scan"] = scan(scan_steps)
    out["sampled"] = scan(5, SamplingParams(temperature=0.9, top_k=8))
    return out


def _graphs_vs_eager(mesh, ekw, name, params, calib, toks, lens, fed, vt,
                     vv) -> dict:
    """The TP engine (TP_QKW, EngineConfig(**ekw)) over `mesh` on the graph
    path (cuda_graphs=True: on the CPU its bodies run eagerly) and
    eagerly, each through graph_path_run (verify at W = vt's width)."""
    from .config import QuantConfig, get_model_config
    from .engine import EngineConfig
    from .parallel import TPInferenceEngine
    cfg = get_model_config(name)
    p, c = params_from_numpy(params), _calib(calib)
    return {way: graph_path_run(
        TPInferenceEngine(cfg, p, c, QuantConfig(**TP_QKW),
                          EngineConfig(**ekw), mesh,
                          cuda_graphs=way == "graph"),
        toks, lens, fed, vt, vv, len(fed)) for way in ("graph", "eager")}


def tp_engine_graphs(ctx, *args):
    """_graphs_vs_eager on this rank's tp 2 engine (TP_EKW)."""
    return _graphs_vs_eager(ctx, TP_EKW, *args)


def tp_graph_gpu_run(ctx, name, layers, prompts, steps):
    """One rank's TP engine on the card at `layers` layers of name's width
    (dummy weights from seed 5, ARC 0.125, TP_QKW, batch 4): the prefill
    of `prompts` and a greedy decode_scan of `steps`, eagerly and then on
    the graph (captured on its state before the prefill), each with its
    step records (kind, comm, digest) and tokens; the captures."""
    from .config import QuantConfig, get_model_config
    from .engine import EngineConfig
    from .models import quantized
    from .parallel import TPInferenceEngine
    cfg = get_model_config(name).replace(num_layers=layers)
    eng = TPInferenceEngine.dummy(
        cfg, quantized.identity_calib(cfg, 0.125, device=ctx.device),
        QuantConfig(**TP_QKW), EngineConfig(max_batch=4, max_seq_len=256),
        ctx, seed=5)
    out = {"cuda_graphs": eng.cuda_graphs}
    toks, lens, _ = eng._pad_prompts(prompts)
    act = torch.as_tensor(lens > 0, device=ctx.device)
    for way in ("eager", "graph"):
        eng.cuda_graphs = way == "graph"
        state = eng.new_state()
        if eng.cuda_graphs:         # every slot inactive: the capture alone
            eng.decode_scan(state, torch.zeros_like(act, dtype=torch.int32),
                            torch.zeros_like(act), 0)
        eng.record_steps()
        logits, state = eng.prefill(state, toks, lens)
        t, _ = eng.decode_scan(state, logits.argmax(-1).to(torch.int32), act,
                               steps)
        out[way] = dict(tokens=to_numpy(t), steps=[
            {k: s[k] for k in ("kind", "comm", "digest")} for s in eng.steps])
        eng.steps = None
    out["captures"] = eng.graph_captures
    return out


def tp_engine_serving(ctx, name, params, calib, prompts, gen_prompts,
                      gen_new):
    """The TP engine's serving contracts on this rank: the collectives of
    one decode step, spec decode and the batcher's spec_window and decode
    burst against its own greedy decode, generate_ondevice's refusal, a
    sampled decode_scan twice and at temperature 0; and the greedy
    generate of generate.py's dummy engine (seed 0, select 0.125) on
    gen_prompts."""
    from .config import QuantConfig, get_model_config
    from .engine import (ContinuousBatcher, EngineConfig, NgramDrafter,
                         Request, SamplingParams, SpeculativeEngine)
    from .models import quantized
    from .parallel import TPInferenceEngine
    cfg = get_model_config(name)
    qcfg = QuantConfig(**TP_QKW)
    p, c = params_from_numpy(params), _calib(calib)
    ecfg = EngineConfig(**TP_EKW)

    def engine():
        return TPInferenceEngine(cfg, p, c, qcfg, ecfg, ctx)

    eng = engine()
    out = {"generate": eng.generate(prompts, 8)}
    toks, lens, _ = eng._pad_prompts(prompts)
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    first = logits.argmax(-1).to(torch.int32)
    act = torch.ones(ecfg.max_batch, dtype=torch.bool)
    _, out["collectives"] = _count_collectives(
        lambda: eng.decode_step(state, first, act))
    out["spec"] = SpeculativeEngine(engine(), NgramDrafter(),
                                    window=3).generate(prompts, 8)
    try:
        SpeculativeEngine(engine(), NgramDrafter(),
                          window=3).generate_ondevice([[1, 2, 3]], 4)
        out["ondevice_error"] = None
    except ValueError as e:
        out["ondevice_error"] = str(e)

    def batch(**kw):
        bt = ContinuousBatcher(engine(), **kw)
        reqs = [Request(prompt=list(q), max_new_tokens=6) for q in prompts]
        reqs.append(Request(prompt=[5, 17, 301], max_new_tokens=7))
        for r in reqs:
            bt.submit(r)
        bt.run()
        return [r.output for r in reqs]

    out["batch"] = batch()
    out["batch_spec"] = batch(spec_window=3)
    out["batch_burst"] = batch(decode_burst=4)

    def scan(sampling):
        logits, st = eng.prefill(eng.new_state(), toks, lens)
        t, _ = eng.decode_scan(st, logits.argmax(-1).to(torch.int32), act, 5,
                               sampling=sampling, seed=5)
        return to_numpy(t)

    sp = SamplingParams(temperature=0.9, top_k=8)
    out["sampled"] = (scan(sp), scan(sp))
    out["greedy_scan"] = (scan(SamplingParams(temperature=0.0)), scan(None))

    gcfg = get_model_config(name)
    gq = QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt="w8",
                     act_scale="row", w_scale="channel")
    dummy = TPInferenceEngine.dummy(
        gcfg, quantized.identity_calib(gcfg, 0.125), gq,
        EngineConfig(max_batch=4, max_seq_len=2048), ctx, seed=0)
    out["dummy_generate"] = dummy.generate(gen_prompts, gen_new)
    return out


# -- rank workers of the pipeline, data, expert and sequence parallel tests --

def _steps(eng, toks, lens, fed, vt=None, vv=None) -> dict:
    """An engine's logits (numpy) of the one-shot prefill of toks/lens,
    a decode step fed each of `fed`, and (vt given) a verify_step of
    vt/vv after them."""
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    out = {"prefill": to_numpy(logits)}
    active = torch.as_tensor(np.asarray(lens) > 0)
    for i, cur in enumerate(fed):
        logits, state = eng.decode_step(state, torch.tensor(np.asarray(cur)),
                                        active)
        out[f"decode{i + 1}"] = to_numpy(logits)
    if vt is not None:
        out["verify"] = to_numpy(eng.verify_step(state, vt, vv)[0])
    return out


def pp_forward(ctx, name, params, calib, tokens, microbatches):
    """pp_quant_model_forward's logits (numpy) on this stage, for each
    microbatch count, over the fake-quant NVFP4 params (JAX's
    test_pp_matches_single_device: row scales, use_kernels=False)."""
    from .config import QuantConfig, get_model_config
    from .models import quantized
    from .parallel import make_pp, pp_quant_model_forward, stack_stage_params
    cfg = get_model_config(name)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=False,
                       act_scale="row")
    calib = _calib(calib)
    pctx = make_pp(cpu=True)
    qp = quantized.quantize_model_params(cfg, params_from_numpy(params),
                                         calib, qcfg)
    pparams = stack_stage_params(cfg, qp, calib, pctx.pp, pctx)
    return {m: to_numpy(pp_quant_model_forward(cfg, pparams, calib, qcfg,
                                               pctx, tokens, m))
            for m in microbatches}


def pp_engine_run(ctx, name, params, calib, prompts, toks, lens, fed, vt,
                  vv, spec_prompts):
    """The PP engine's checks on this stage (the port's engine tests'
    qcfg, TP_QKW): generate on `prompts`, every step's logits of _steps,
    a greedy decode_scan after the prefill, the collectives of one decode
    step; on spec_prompts at select 0: generate, spec decode, a sampled
    decode_scan twice and at temperature 0, the batcher per step, with
    spec_window 3 and with decode bursts of 4; and the refusals."""
    from .config import QuantConfig, get_model_config
    from .engine import (ContinuousBatcher, EngineConfig, NgramDrafter,
                         Request, SamplingParams, SpeculativeEngine)
    from .parallel import PPInferenceEngine, make_pp
    cfg = get_model_config(name)
    qcfg = QuantConfig(**TP_QKW)
    p = params_from_numpy(params)
    pctx = make_pp(cpu=True)
    ecfg = EngineConfig(**TP_EKW)

    def engine(c=calib):
        return PPInferenceEngine(cfg, p, _calib(c), qcfg, ecfg, pctx)

    eng = engine()
    out = {"generate": eng.generate(prompts, 5)}
    out.update(_steps(eng, toks, lens, fed, vt, vv))
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    first = logits.argmax(-1).to(torch.int32)
    act = torch.as_tensor(np.asarray(lens) > 0)
    out["scan"] = to_numpy(eng.decode_scan(state, first, act, 4)[0])
    _, out["collectives"] = _count_collectives(
        lambda: eng.decode_step(state, first, act))

    zero = [{s: (np.asarray(r), 0) for s, (r, _) in layer.items()}
            for layer in calib]
    eng = engine(zero)
    out["spec_ref"] = eng.generate(spec_prompts, 8)
    out["spec"] = SpeculativeEngine(engine(zero), NgramDrafter(),
                                    window=3).generate(spec_prompts, 8)
    try:
        SpeculativeEngine(engine(zero), NgramDrafter(),
                          window=3).generate_ondevice([[1, 2, 3]], 4)
        out["ondevice_error"] = None
    except ValueError as e:
        out["ondevice_error"] = str(e)
    stoks, slens, _ = eng._pad_prompts(spec_prompts)

    def scan(sampling):
        lg, st = eng.prefill(eng.new_state(), stoks, slens)
        t, _ = eng.decode_scan(st, lg.argmax(-1).to(torch.int32),
                               torch.ones(ecfg.max_batch, dtype=torch.bool),
                               5, sampling=sampling, seed=5)
        return to_numpy(t)

    sp = SamplingParams(temperature=0.9, top_k=8)
    out["sampled"] = (scan(sp), scan(sp))
    out["greedy_scan"] = (scan(SamplingParams(temperature=0.0)), scan(None))

    def batch(**kw):
        bt = ContinuousBatcher(engine(zero), **kw)
        reqs = [Request(prompt=[1, 2, 3, 4] * 5, max_new_tokens=8),
                Request(prompt=[100, 200, 7], max_new_tokens=6)]
        for r in reqs:
            bt.submit(r)
        bt.run()
        return [r.output for r in reqs]

    out["batch"] = batch()
    out["batch_spec"] = batch(spec_window=3)
    out["batch_burst"] = batch(decode_burst=4)
    errors = {}
    try:
        PPInferenceEngine(cfg, p, _calib(zero), qcfg,
                          EngineConfig(dynamic_pages=True, **TP_EKW), pctx)
    except ValueError as e:
        errors["dynamic_pages"] = str(e)
    try:
        eng.prefill(eng.new_state(), stoks, slens, starts=np.zeros(2))
    except ValueError as e:
        errors["starts"] = str(e)
    out["errors"] = errors
    return out


def pp_moe_run(ctx, name, params, calib, prompts):
    """The PP engine's greedy generate on a MoE config (packed experts),
    the port's engine tests' qcfg."""
    from .config import QuantConfig, get_model_config
    from .engine import EngineConfig
    from .parallel import PPInferenceEngine, make_pp
    cfg = get_model_config(name)
    eng = PPInferenceEngine(cfg, params_from_numpy(params), _calib(calib),
                            QuantConfig(**TP_QKW), EngineConfig(**TP_EKW),
                            make_pp(cpu=True))
    return eng.generate(prompts, 5)


# dp x tp: max_batch 4 over dp 2, pages of 16.
DP_EKW = dict(max_batch=4, max_seq_len=32, page_size=16)


def dp_engine_run(ctx, name, params, calib, toks, lens, fed, prompts,
                  more):
    """The dp 2 x tp 2 TP engine's checks on this rank (TP_QKW): every
    step's logits of _steps fed `fed`, the same prefill again and 4
    decode steps against decode_scan, the collectives of one decode step,
    page_groups(), a sampled decode_scan twice; with dynamic pages and
    chunked prefill (16) the batcher on `prompts` and then `more`
    (long prompts that chunk, more requests than slots), against the
    static engine's generate; the replicated fallback (max_batch 3);
    and the dp 1 TP engine over this rank's tp group fed the same."""
    import dataclasses

    from .config import QuantConfig, get_model_config
    from .engine import ContinuousBatcher, EngineConfig, Request
    from .engine import SamplingParams
    from .engine import sampling as smp
    from .parallel import TPInferenceEngine, make_mesh
    cfg = get_model_config(name)
    qcfg = QuantConfig(**TP_QKW)
    p, c = params_from_numpy(params), _calib(calib)
    mesh = make_mesh(dp=2, tp=2, cpu=True)
    eng = TPInferenceEngine(cfg, p, c, qcfg, EngineConfig(**DP_EKW), mesh)
    out = {"dp": eng.dp, "page_groups": eng.page_groups()}
    out.update(_steps(eng, toks, lens, fed))
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    first = logits.argmax(-1).to(torch.int32)
    act = torch.as_tensor(np.asarray(lens) > 0)
    cur, st, step_toks = first, state, []
    logits2, st = eng.prefill(eng.new_state(), toks, lens)
    out["prefill_again"] = to_numpy(logits2)
    for _ in range(4):
        lg, st = eng.decode_step(st, cur, act)
        cur = lg.argmax(-1).to(torch.int32)
        step_toks.append(to_numpy(cur))
    out["step_toks"] = np.stack(step_toks, 1)
    out["scan"] = to_numpy(eng.decode_scan(state, first, act, 4)[0])
    eng.record_steps()
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    _, out["collectives"] = _count_collectives(
        lambda: eng.decode_step(state, first, act))
    out["comm"] = eng.steps[-1]["comm"]
    eng.steps = None

    def scan(sampling):
        lg, s2 = eng.prefill(eng.new_state(), toks, lens)
        t, _ = eng.decode_scan(s2, lg.argmax(-1).to(torch.int32), act, 5,
                               sampling=sampling, seed=5)
        return to_numpy(t)

    sp = SamplingParams(temperature=0.9, top_k=8)
    out["sampled"] = (scan(sp), scan(sp))
    # generate and decode_scan draw through _generator / _sample: group
    # g's rows from a generator of mix_seed(seed, g)
    lg, _ = eng.prefill(eng.new_state(), toks, lens)
    out["group_draws"] = to_numpy(eng._sample(lg, sp, eng._generator(5)))
    half = lg.shape[0] // 2
    out["group_draws_want"] = np.concatenate([to_numpy(smp.sample_p(
        lg[g * half:(g + 1) * half],
        torch.Generator().manual_seed(smp.mix_seed(5, g)), sp))
        for g in range(2)])
    out["sampled_generate"] = [eng.generate([list(q) for q in prompts], 3,
                                            sampling=sp, seed=5)
                               for _ in range(2)]

    st_eng = TPInferenceEngine(cfg, p, c, qcfg, EngineConfig(**DP_EKW), mesh)
    out["want"] = st_eng.generate([list(q) for q in prompts], 4)
    dyn = TPInferenceEngine(cfg, p, c, qcfg, EngineConfig(
        dynamic_pages=True, prefill_chunk=16, **DP_EKW), mesh)
    out["dyn_page_groups"] = dyn.page_groups()
    bt = ContinuousBatcher(dyn)
    groups_ok = []
    orig_step = bt.step

    def step():
        done = orig_step()
        spg = bt._slots_per_group
        groups_ok.append(all(
            sorted(int(x) for x in bt._pt[s] if x) == sorted(
                bt.allocs[s // spg].owned.get(s, []))
            and all(s not in a.owned for gi, a in enumerate(bt.allocs)
                    if gi != s // spg)
            for s in range(len(bt.slots)) if bt.slots[s] is not None))
        return done

    bt.step = step
    reqs = [Request(prompt=list(q), max_new_tokens=4) for q in prompts]
    for r in reqs:
        bt.submit(r)
    bt.run()
    out["batch"] = [(r.error, r.output) for r in reqs]
    reqs = [Request(prompt=list(q), max_new_tokens=3) for q in more]
    for r in reqs:
        bt.submit(r)
    bt.run()
    out["more"] = [(r.error, r.output) for r in reqs]
    out["groups_ok"] = all(groups_ok)
    out["n_allocs"] = len(bt.allocs)
    out["freed"] = all(a.available() == a.capacity and not a.owned
                       for a in bt.allocs)
    out["one_group_alloc"] = bt.alloc is None

    rep = TPInferenceEngine(cfg, p, c, qcfg, EngineConfig(
        max_batch=3, max_seq_len=32, page_size=16), mesh)
    out["replicated_dp"] = rep.dp
    out["replicated"] = _steps(rep, toks[:3], lens[:3],
                               [f[:3] for f in fed])
    ref = TPInferenceEngine(cfg, p, c, qcfg, EngineConfig(**DP_EKW),
                            dataclasses.replace(mesh, dp=1))
    out["dp1"] = _steps(ref, toks, lens, fed)
    return out


def dp_engine_graphs(ctx, *args):
    """_graphs_vs_eager on this rank's dp 2 x tp 2 engine (DP_EKW; a
    sampled body draws from one generator a dp group)."""
    from .parallel import make_mesh
    return _graphs_vs_eager(make_mesh(dp=2, tp=2, cpu=True), DP_EKW, *args)


def ep_block_run(ctx, name, params, cases):
    """make_ep_moe_forward's block on this rank for each key of `cases`:
    (dp, x, capacity, dense_max_t, quant) on a (dp, world / dp) mesh,
    layer 0's experts raw (quant None: bf16) or as qdq stacks (quant =
    (select_frac, act_scale): NVFP4, use_kernels=False, channel weight
    scales), moe.DENSE_MODE_MAX_T set to dense_max_t. Returns {key:
    (output, the collectives of the block)}."""
    from .config import QuantConfig, get_model_config
    from .models import moe, quantized
    from .parallel import make_ep_moe_forward, make_mesh, shard_moe_params
    cfg = get_model_config(name)
    p = params_from_numpy(params)["layers"][0]["moe"]
    world = torch.distributed.get_world_size()
    out = {}
    for key, (dp, x, capacity, dense_max, quant) in cases.items():
        mesh = make_mesh(dp=dp, tp=world // dp, cpu=True)
        qp, calib, qcfg = p, None, None
        if quant is not None:
            qcfg = QuantConfig(quant_type="NVFP4", use_kernels=False,
                               w_scale="channel", act_scale=quant[1])
            calib = quantized.identity_calib(cfg, quant[0])[0]
            qp = moe.quantize_moe_params(p, calib, qcfg)
        fwd = make_ep_moe_forward(cfg, mesh, layer_calib=calib, qcfg=qcfg,
                                  capacity=capacity)
        old = moe.DENSE_MODE_MAX_T
        moe.DENSE_MODE_MAX_T = dense_max
        try:
            local = shard_moe_params(qp, mesh)
            y, counts = _count_collectives(lambda: fwd(local, to_torch(x)))
        finally:
            moe.DENSE_MODE_MAX_T = old
        out[key] = (to_numpy(y), counts)
    return out


def qdq_moe_engine(cfg, params, calib, qcfg, ecfg, device="cpu"):
    """The single-device engine with an MoE config's experts as qdq stacks
    (moe.quantize_moe_params: the TP engine's expert form) and the
    attention sites packed."""
    from .engine import InferenceEngine
    from .models import moe, quantized
    layers = []
    for lp, lc in zip(params["layers"], calib):
        q = quantized.quantize_layer_params_fused(lp, lc, qcfg)
        q["moe"] = moe.quantize_moe_params(lp["moe"], lc, qcfg)
        layers.append(q)
    return InferenceEngine(cfg, dict(params, layers=layers), calib, qcfg,
                           ecfg, device=device, quantize_params=False)


def ep_engine_run(ctx, name, params, calib, toks, lens, fed, act_scales):
    """The MoE TP engine (qdq expert stacks sharded over tp) at each
    act_scale of `act_scales` on this rank: every step's logits of
    _steps (TP_QKW with that scale, select 0), and the collectives of a
    decode step."""
    from .config import QuantConfig, get_model_config
    from .engine import EngineConfig
    from .parallel import TPInferenceEngine
    cfg = get_model_config(name)
    p, c = params_from_numpy(params), _calib(calib)
    out = {}
    for scale in act_scales:
        qcfg = QuantConfig(**dict(TP_QKW, act_scale=scale))
        eng = TPInferenceEngine(cfg, p, c, qcfg, EngineConfig(**TP_EKW), ctx)
        out[scale] = _steps(eng, toks, lens, fed)
        logits, state = eng.prefill(eng.new_state(), toks, lens)
        _, out[scale]["collectives"] = _count_collectives(
            lambda: eng.decode_step(state, logits.argmax(-1).to(torch.int32),
                                    torch.as_tensor(np.asarray(lens) > 0)))
    return out


def sp_run(ctx, q, k, v, causal_cases, dq, pools):
    """ring_attention on this shard's slice of q/k/v (numpy [B, T, H, D])
    for each causal flag of `causal_cases`, and sp_flash_prefill's whole
    output; then sp_paged_decode of dq over this shard's pool
    (pools[shard]: the pool's codes/params, page table and local lens)
    with its state from paged_decode_state, and the merge's
    collectives; the ring's exchanges as its CommStats count them."""
    from .cache.paged import PagedKVCache
    from .kernels.paged_decode import paged_decode_state
    from .parallel import (make_sp, ring_attention, sp_flash_prefill,
                           sp_paged_decode)
    sctx = make_sp(cpu=True)
    n, i = sctx.sp, sctx.shard
    t_l = q.shape[1] // n
    sl = slice(i * t_l, (i + 1) * t_l)
    out = {}
    for causal in causal_cases:
        snap = sctx.comm.snapshot()
        out[("ring", causal)] = to_numpy(ring_attention(
            to_torch(q[:, sl]), to_torch(k[:, sl]), to_torch(v[:, sl]), sctx,
            causal))
        out[("ring_comm", causal)] = sctx.comm.since(snap)
    out["flash_prefill"] = to_numpy(sp_flash_prefill(
        sctx, to_torch(q), to_torch(k), to_torch(v)))
    codes, prm, pt, lens = pools[i]
    cache = PagedKVCache((torch.as_tensor(codes),), (torch.as_tensor(prm),))
    pt, lens = torch.as_tensor(pt), torch.as_tensor(lens)
    st = paged_decode_state(to_torch(dq), cache, 0, pt, lens)
    out["state"] = tuple(to_numpy(x) for x in st)
    y, out["sp_collectives"] = _count_collectives(
        lambda: sp_paged_decode(to_torch(dq), cache, 0, pt, lens, sctx))
    out["sp_decode"] = to_numpy(y)
    return out


def multihost_worker(coordinator: str, process_id: int) -> None:
    """One of two processes (`python -c`) joining through multihost_init
    over tcp://coordinator on the CPU: a SUM over both of 4 values each
    (every rank's global indices 4 * pid .. 4 * pid + 3), then the
    row-parallel matmul (x [1, 8] of ones times w = arange(32) [8, 4],
    each process holding K rows 4 * pid .. 4 * pid + 3), then
    multihost_init again (a no-op while the group exists). Prints
    "proc <pid> ok"."""
    import torch.distributed as dist

    from .parallel import make_mesh, multihost_init
    assert multihost_init(coordinator=coordinator, num_processes=2,
                          process_id=process_id) is True
    ctx = make_mesh(cpu=True)
    assert dist.get_world_size() == 2 and ctx.rank == process_id
    comm = ctx.tp_comm()
    x = torch.arange(4 * process_id, 4 * process_id + 4,
                     dtype=torch.float32).sum().reshape(1)
    got = float(comm.all_reduce(x, "sum")[0])
    assert got == 28.0, got
    w = torch.arange(32.0).reshape(8, 4)
    rows = slice(4 * process_id, 4 * process_id + 4)
    y = comm.all_reduce(torch.ones((1, 8))[:, rows] @ w[rows], "sum")
    want = torch.ones((1, 8)) @ w
    assert torch.equal(y, want), (y, want)
    assert multihost_init(coordinator=coordinator, num_processes=2,
                          process_id=process_id) is False
    dist.destroy_process_group()
    print(f"proc {process_id} ok", flush=True)
