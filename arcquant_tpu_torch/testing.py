"""Test helpers for holding the port against the JAX package.

Inputs are made with numpy and handed to both packages; bf16 crosses as
a uint16 view. Importing this module caps torch at one intra-op thread:
the test suite runs several pytest-xdist workers side by side, and each
would otherwise start one thread per core.
"""

from __future__ import annotations

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
