"""Perplexity (counterpart of ``arcquant_tpu/evals/ppl.py``): the
upstream accuracy protocol, non-overlapping seqlen windows of a token
stream, the summed NLL of each next token over shifted logits, exp of
the mean. The bf16 model and every quantized configuration run it; the
quantized-against-bf16 difference is the headline accuracy metric."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig, QuantConfig
from ..models import llama, quantized


def window_nll(params, cfg: ModelConfig, x: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
    """The f32 sum of -log p(tokens[:, i + 1] | ...) over a batch of
    windows, from the last layer's hidden states x [B, T, D]."""
    logits = llama.head_logits(params, llama.rms_norm(
        x, params["final_norm"], cfg.rms_eps))
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    picked = torch.gather(logp, -1, tokens[:, 1:, None].long())
    return -picked.sum()


@torch.inference_mode()
def eval_ppl(cfg: ModelConfig, params, token_stream, seqlen: int = 2048,
             qcfg: Optional[QuantConfig] = None, calib=None,
             batch: int = 1) -> float:
    """Perplexity over floor(N / seqlen) windows of token_stream ([N]
    ints, numpy or a tensor).

    params: the bf16 params, or with a qcfg (other than BF16) the
    already-quantized ones (quantized.quantize_model_params); raw params
    with a qcfg raise. The forward runs on params' device, `batch`
    windows at a time through every layer; each batch's NLL is summed in
    f32, the batches' sums in a Python float, and the perplexity is exp
    of the mean in f32."""
    stream = torch.as_tensor(np.asarray(token_stream), dtype=torch.long)
    nsamples = stream.shape[0] // seqlen
    if nsamples < 1:
        raise ValueError(f"token stream of {stream.shape[0]} tokens is "
                         f"shorter than seqlen {seqlen}")
    device = params["embed"].device
    toks = stream[:nsamples * seqlen].reshape(nsamples, seqlen).to(device)
    cos, sin = llama.rope_cos_sin(
        cfg, torch.arange(seqlen, device=device)[None, :])

    if qcfg is not None and qcfg.quant_type != "BF16":
        first = params["layers"][0]["q"]
        if isinstance(first, dict) and "w" in first:
            raise ValueError(
                "eval_ppl got a QuantConfig but raw bf16 layer params; "
                "quantize first with quantized.quantize_model_params")

        def layer(i, x):
            return quantized.quant_layer_forward(
                cfg, params["layers"][i], x, cos, sin, calib[i], qcfg)[0]
    else:
        def layer(i, x):
            return llama.layer_forward(cfg, params["layers"][i], x, cos,
                                       sin)[0]

    total = 0.0
    for b0 in range(0, nsamples, batch):
        tb = toks[b0:b0 + batch]
        x = params["embed"][tb]
        for i in range(cfg.num_layers):
            x = layer(i, x)
        total += float(window_nll(params, cfg, x, tb))
    mean = torch.tensor(total / (nsamples * (seqlen - 1)),
                        dtype=torch.float32)
    return float(torch.exp(mean))
