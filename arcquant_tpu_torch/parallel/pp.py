"""Pipeline parallelism on ``torch.distributed``: the layer-staged
quantized forward without a cache, GPipe microbatches (counterpart of
``arcquant_tpu/parallel/pp.py``).

The decoder stack is split into pp contiguous stages, rank s holding
layers [s * L/pp, (s + 1) * L/pp). Microbatches flow stage to stage: a
stage receives microbatch i from stage s - 1 (stage 0 embeds it), runs
its layers, and sends it on to s + 1; the last stage runs the final norm
and the head into its logits. So M microbatches finish in M + pp - 1
stage steps instead of M * pp, stage s working on microbatch i while
s + 1 works on i - 1. The last stage's logits are broadcast to every
stage at the end.

JAX runs every stage as one branch-free program over the "pp" axis,
computing garbage in the pipeline's bubble steps and merging the
stages' disjoint outputs with a psum; a rank here blocks on its recv
instead, and one broadcast replaces the psum. Every send has its recv in
the same order on both sides (microbatch order), so the stages cannot
deadlock; a stage that raises stops the others (``launch``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import ModelConfig, QuantConfig
from ..models import llama, quantized
from .mesh import PPContext

Params = Dict[str, Any]


def stage_range(num_layers: int, pp: int, stage: int) -> range:
    """The global layer indices of `stage`."""
    if num_layers % pp:
        raise ValueError(f"pp={pp} must divide the {num_layers} layers")
    per = num_layers // pp
    return range(stage * per, (stage + 1) * per)


def stack_stage_params(cfg: ModelConfig, qparams: Params, calib: list,
                       pp: int, ctx: PPContext) -> Params:
    """This stage's part of quantized params: its layers and their
    calibration, the replicated embedding, norm and head, and the
    layer-uniform select count of each site ("_sels"). A non-uniform
    select count across layers is refused (AssertionError), as in the
    JAX package, whose stacked stages need uniform shapes."""
    layers = qparams["layers"]
    l = len(layers)
    assert l % pp == 0, (l, pp)
    sels = {}
    for site in calib[0]:
        counts = {calib[i][site].select_num for i in range(l)}
        assert len(counts) == 1, (
            f"pp path needs a uniform select_num for site {site}; "
            f"got {sorted(counts)}")
        sels[site] = counts.pop()
    own = stage_range(l, pp, ctx.stage)
    out = {k: qparams[k] for k in ("embed", "final_norm", "lm_head")
           if k in qparams}
    out.update(layers=[layers[i] for i in own],
               calib=[calib[i] for i in own], _sels=sels)
    return out


@torch.no_grad()
def pp_quant_model_forward(cfg: ModelConfig, pparams: Params, calib: list,
                           qcfg: QuantConfig, ctx: PPContext, tokens,
                           microbatches: int = 0) -> torch.Tensor:
    """Pipelined quantized forward (no cache): tokens [B, T] -> f32 logits
    [B, T, V] on every stage. B must divide by `microbatches` (default
    min(pp, B)). `calib` is the whole model's (the stage's own travels in
    pparams)."""
    pp, s = ctx.pp, ctx.stage
    comm = ctx.comms()
    tokens = torch.as_tensor(tokens, device=ctx.device).long()
    b, t = tokens.shape
    m = microbatches or min(pp, b)
    assert b % m == 0, (b, m)
    mb = b // m
    cos, sin = llama.rope_cos_sin(cfg, llama.positions_for(tokens[:mb]))
    x_in = pparams["embed"][tokens]                      # [B, T, D]
    vocab = pparams.get("lm_head", pparams["embed"]).shape[0]
    out = torch.zeros((b, t, vocab), dtype=torch.float32, device=ctx.device)
    for i in range(m):
        x = x_in[i * mb:(i + 1) * mb] if s == 0 else comm.recv(
            x_in[:mb], s - 1)
        for lp, lc in zip(pparams["layers"], pparams["calib"]):
            x, _ = quantized.quant_layer_forward(cfg, lp, x, cos, sin, lc,
                                                 qcfg)
        if s < pp - 1:
            comm.send(x, s + 1)
        else:
            out[i * mb:(i + 1) * mb] = llama.head_logits(
                pparams, llama.rms_norm(x, pparams["final_norm"],
                                        cfg.rms_eps))
    return comm.broadcast(out, pp - 1)
