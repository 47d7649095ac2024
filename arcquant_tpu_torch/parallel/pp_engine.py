"""Pipeline-parallel serving engine: prefill and paged-int4 decode with a
KV pool a stage (counterpart of ``arcquant_tpu/parallel/pp_engine.py``).

pp is the capacity dimension: rank s holds the packed weights of layers
[s * L/pp, (s + 1) * L/pp) and a full page pool for those L/pp layers
only, so a model whose quantized weights and KV exceed one card's memory
serves across pp cards.

A prefill chunk, a decode step or a verify is a relay through the
stages: stage 0 embeds the tokens and runs its layers, each stage sends
the bf16 activation [B, T, D] to the next (a send, and the next stage's
blocking recv), and the last stage runs the final norm and the head and
broadcasts the logits to every stage. A step so makes pp - 1 sends, pp - 1
recvs and one broadcast, and no all_reduce. Every rank runs the same
host program (the base engine's forwards, chunk loop, decode loop and
sampling), so the stages keep identical page tables, seq_lens and
tokens; each send meets its recv in the same order on both sides in
every mode, and a stage that raises stops the others (``launch``).

Each stage runs InferenceEngine's own layer functions (_attn_common,
_o_proj, _mlp) with the same routes: the kernels of the one-shot
prefill (#1, #2, #6, #9), the chunked and verify forwards' paged prefill
(#11), paged decode (#10) and the decode megakernels (#12-#14); an MoE
config's packed experts (#15). The relay moves the activations as they
are, so the PP engine's logits are the single-device engine's bit for
bit. Like JAX's, it relays the full batch (decode GEMMs are bound by
their weights, so microbatches would re-stream each stage's weights),
refuses dynamic pages (static pools a stage) and prefix sharing, and
serves the packed NVFP4 path, the hybrid W4A16 prefill included.

Select counts: every layer's per-site select is raised to the maximum
over the layers (``bucket_calib_uniform``), as in JAX, whose stacked
stages need uniform shapes; the port keeps that calibration so its
engines agree with JAX's.

The engine decodes eagerly: gloo's send and recv cannot be captured in
a CUDA graph.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..cache import paged
from ..config import ModelConfig, QuantConfig
from ..engine.engine import (EngineConfig, InferenceEngine, _to_device,
                             dummy_tree, resolve_device)
from ..models import llama, quantized
from .mesh import PPContext, StepRecords
from .pp import stage_range

Params = Dict[str, Any]


def bucket_calib_uniform(calib: List[Dict[str, Any]]):
    """Raise every layer's per-site select_num to the maximum across
    layers (extra selected channels carry near-zero residuals, so
    accuracy only improves)."""
    smax = {site: max(c[site].select_num for c in calib)
            for site in calib[0]}
    return [{site: quantized.SiteCalib(c[site].reorder_index, smax[site])
             for site in calib[0]} for c in calib]


def _check(cfg: ModelConfig, qcfg: QuantConfig, ecfg: EngineConfig,
           pp: int) -> None:
    if cfg.num_layers % pp:
        raise ValueError(f"pp={pp} must divide the {cfg.num_layers} layers")
    if not (qcfg.use_kernels and qcfg.quant_type == "NVFP4"):
        raise ValueError("the PP engine serves the packed NVFP4 path "
                         "(use_kernels)")
    if ecfg.dynamic_pages:
        raise ValueError("PP engine: dynamic_pages not supported (static "
                         "pools a stage)")


class PPInferenceEngine(StepRecords, InferenceEngine):
    """Pipeline-staged quantized serving engine, one instance a stage.

    Same public API as InferenceEngine (new_state / prefill / decode_step
    / decode_scan / verify_step / generate); every stage builds it on the
    same weights and calls it with the same arguments. ``record_steps()``
    records each step's ms and relay traffic (StepRecords)."""

    def __init__(self, cfg: ModelConfig, params, calib, qcfg: QuantConfig,
                 ecfg: EngineConfig, mesh: PPContext):
        _check(cfg, qcfg, ecfg, mesh.pp)
        device = resolve_device(mesh.device)
        calib = bucket_calib_uniform(_to_device(calib, device))
        layers = [quantized.quantize_layer_params_fused(
            _to_device(params["layers"][i], device), calib[i], qcfg)
            for i in stage_range(cfg.num_layers, mesh.pp, mesh.stage)]
        self._setup(cfg, params, layers, calib, qcfg, ecfg, mesh)

    def _setup(self, cfg, params, layers, calib, qcfg, ecfg, mesh):
        self.mesh, self.pp = mesh, mesh.pp
        own = stage_range(cfg.num_layers, mesh.pp, mesh.stage)
        qparams = {k: params[k] for k in ("embed", "final_norm", "lm_head",
                                          "lm_head_packed") if k in params}
        qparams["layers"] = layers
        super().__init__(cfg, qparams, [calib[i] for i in own], qcfg, ecfg,
                         device=mesh.device, quantize_params=False,
                         cuda_graphs=False)
        self._last = mesh.stage == mesh.pp - 1
        if not self._last:      # only the last stage runs the head
            for k in ("lm_head", "lm_head_packed"):
                self.qparams.pop(k, None)
        self._stage_cfg = cfg.replace(num_layers=len(own))

    @classmethod
    def dummy(cls, cfg: ModelConfig, calib, qcfg: QuantConfig,
              ecfg: EngineConfig, mesh: PPContext, seed: int = 0,
              dtype=torch.bfloat16) -> "PPInferenceEngine":
        """InferenceEngine.dummy's weights (the same draws from `seed`):
        every stage draws every layer in order, keeps and packs its own
        and frees the rest, then draws the embedding."""
        _check(cfg, qcfg, ecfg, mesh.pp)
        device = resolve_device(mesh.device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        calib = bucket_calib_uniform(_to_device(calib, device))
        own = stage_range(cfg.num_layers, mesh.pp, mesh.stage)
        layers = []
        for i in range(cfg.num_layers):
            lp = llama.init_layer_params(cfg, gen, dtype, device)
            if i in own:
                layers.append(quantized.quantize_layer_params_fused(
                    lp, calib[i], qcfg))
            del lp
        eng = cls.__new__(cls)
        eng._setup(cfg, dummy_tree(cfg, gen, dtype, device, layers), layers,
                   calib, qcfg, ecfg, mesh)
        return eng

    # -- state: the stage's pool --------------------------------------------

    def new_state(self):
        """(cache, page_table, seq_lens): a full page pool for this stage's
        layers; the page table and seq_lens replicated."""
        e = self.ecfg
        cache = paged.init_cache(self._stage_cfg, e.total_pages(),
                                 e.page_size, self.device)
        seq_lens = torch.zeros((e.max_batch,), dtype=torch.int32,
                               device=self.device)
        return cache, self._page_table(), seq_lens

    # -- the relay ----------------------------------------------------------

    def _layers(self, x, cos, sin, cache, pt, append_pos, attend, qcfg):
        """This stage's part of the relay: receive the activation from the
        previous stage (stage 0: the embedded tokens), run the stage's
        layers, send it on; the last stage returns it final-normed."""
        comm, s = self.mesh.comms(), self.mesh.stage
        if s > 0:
            x = comm.recv(x, s - 1)
        x = self._layer_stack(x, cos, sin, cache, pt, append_pos, attend,
                              qcfg)
        if not self._last:
            comm.send(x, s + 1)
            return x
        return llama.rms_norm(x, self.qparams["final_norm"], self.cfg.rms_eps)

    def _head_logits(self, x2d: torch.Tensor) -> torch.Tensor:
        """The last stage's head logits, broadcast to every stage."""
        if self._last:
            logits = super()._head_logits(x2d)
        else:
            logits = torch.empty((x2d.shape[0], self.cfg.vocab_size),
                                 dtype=torch.float32, device=self.device)
        return self.mesh.comms().broadcast(logits, self.pp - 1)

    # -- public steps, recorded on request ------------------------------------

    def prefill(self, state, tokens, lens, starts=None):
        if starts is not None:
            raise ValueError("PP engine: prefix sharing (per-row starts) "
                             "not supported")
        return self._recorded("prefill", super().prefill, state, tokens,
                              lens)

    def decode_step(self, state, tokens, active):
        return self._recorded("decode", super().decode_step, state, tokens,
                              active)

    def verify_step(self, state, tokens, valid):
        return self._recorded("verify", super().verify_step, state, tokens,
                              valid)
