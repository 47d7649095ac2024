"""Tensor-parallel serving engine (counterpart of
``arcquant_tpu/parallel/tp_engine.py``): the InferenceEngine's prefill,
decode and verify steps on each rank's shard, the ranks meeting in
``torch.distributed`` collectives.

Sharding layout:

  fused QKV / gate-up   column-parallel: each rank owns num_heads/tp
                        query heads and num_kv_heads/tp kv heads (each
                        projection is sliced before the fused concat, so
                        head boundaries stay aligned)
  o / down              row-parallel with per-shard ARC residual
                        ownership and one all_reduce(SUM) each
  paged int4 KV pool    sharded over the kv-head axis: appends and the
                        paged attention kernels are rank-local
  embeddings / norms /
  lm_head / page table  replicated (hidden states replicated between
                        layers, as in Megatron)

The row sites' activation global scale is an all_reduce(MAX), so the
quantization grids match the unsharded engine's: a decode step makes 2
SUM and 2 MAX all_reduces a layer and no other collective (the head and
the sampling are replicated). tp must divide num_kv_heads.

JAX runs each step as one shard_map'd program; here each rank runs the
base engine's forwards (``_prefill_forward``: flash attention over the
chunk; ``_prefill_chunk_forward``: the paged prefill over the pool, for
chunked and suffix prefill and the verify; ``_decode_forward``: paged
decode) with ``_tp_layer`` as their layer, and the base engine's host
loops (chunks, ``decode_scan``'s steps, sampling on the device from a
generator every rank seeds alike, so the ranks keep identical tokens).

The TP engine decodes eagerly: gloo's collectives cannot be captured in
a CUDA graph, and a captured NCCL step is not ported (ROADMAP queue 1
item 8), nor are dp > 1 (the mesh's dp axis, page groups) and MoE
layers under TP.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional

import torch

from ..cache import paged
from ..config import ModelConfig, QuantConfig
from ..engine.engine import (EngineConfig, InferenceEngine, _to_device,
                             dummy_tree)
from ..kernels import gemm as gk
from ..kernels import quantize as qk
from ..models import llama
from ..models.quantized import SiteCalib
from ..quant import numerics as N
from ..quant import packing
from . import tp as tpm
from .mesh import TPContext


def _shard_fused_col(layer_p, projs, calib: SiteCalib, tp: int,
                     qcfg: QuantConfig, rank: int):
    """Column-parallel pack of shard `rank` of a FUSED projection group:
    each projection's N range sliced, then concatenated, so the shard
    owns whole heads of each of q/k/v (or gate/up). Per-channel weight
    scales are the rows' own; a tensor scale is taken over the shard's
    concatenation (the JAX engine's behaviour, kept)."""
    def shard_slice(w):
        ns = w.shape[0] // tp
        return w[rank * ns:(rank + 1) * ns]

    w = torch.cat([shard_slice(layer_p[pr]["w"]) for pr in projs], dim=0)
    bs = [layer_p[pr].get("b") for pr in projs]
    b = (torch.cat([shard_slice(x) for x in bs])
         if all(x is not None for x in bs) else None)
    gs = (N.nvfp4_global_scale(w, per_row=True)[:, 0]
          if qcfg.w_scale == "channel" else None)
    return packing.pack_weight_arc(
        w, calib.reorder_index, calib.select_num, bias=b,
        fmt=qcfg.weight_fmt, w_scale=qcfg.w_scale, global_scale=gs)


def _shard_layer(lp, lc: Dict[str, SiteCalib], qcfg: QuantConfig,
                 mesh: TPContext):
    """One layer's shard for this rank and its row sites' select counts."""
    tp, rank = mesh.tp, mesh.rank
    layer = {"attn_norm": lp["attn_norm"], "mlp_norm": lp["mlp_norm"],
             "qkv": _shard_fused_col(lp, ("q", "k", "v"), lc["attn_in"], tp,
                                     qcfg, rank),
             "gateup": _shard_fused_col(lp, ("gate", "up"), lc["mlp_in"],
                                        tp, qcfg, rank)}
    sels = {}
    for name, site in (("o", "o_in"), ("down", "down_in")):
        pw, idx, pos, sel, _ = tpm.shard_linear_row(
            lp[name]["w"], None, lc[site], tp, qcfg.weight_fmt, rank,
            qcfg.w_scale, exact=qcfg.tp_exact_arc)
        layer[name] = pw
        layer[f"{name}_idx"] = idx
        if pos is not None:
            layer[f"{name}_pos"] = pos
        sels.update({name: sel, f"_{name}_ke": lc[site].select_num})
    return layer, sels


def check_tp(cfg: ModelConfig, qcfg: QuantConfig, tp: int) -> None:
    """Raise unless the TP engine serves cfg at qcfg over tp ranks."""
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers under tensor parallelism (expert "
            "parallelism) are not ported (ROADMAP queue 1 item 8)")
    if cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_kv_heads="
                         f"{cfg.num_kv_heads}")
    if not (qcfg.use_kernels and qcfg.quant_type == "NVFP4"
            and qcfg.act_bits == 4):
        raise ValueError("the TP engine serves the packed NVFP4 W4A4 path "
                         "(use_kernels, act_bits 4)")


class TPInferenceEngine(InferenceEngine):
    """Tensor-parallel quantized serving engine, one instance a rank.

    Same public API as InferenceEngine (new_state / prefill / decode_step
    / decode_scan / verify_step / generate); every rank builds it on the
    same weights and calls it with the same arguments. Weights are
    quantized and sharded at construction; the KV pool holds this rank's
    kv heads. ``record_steps()`` makes every step append a record of its
    host ms, its all_reduces and a digest of its logits to ``steps``
    (the device synchronized around each step and collective)."""

    def __init__(self, cfg: ModelConfig, params, calib, qcfg: QuantConfig,
                 ecfg: EngineConfig, mesh: TPContext,
                 cuda_graphs: bool = False):
        check_tp(cfg, qcfg, mesh.tp)
        calib = _to_device(calib, mesh.device)
        layers, sels = [], []
        for li, lp in enumerate(params["layers"]):
            layer, sel = _shard_layer(_to_device(lp, mesh.device), calib[li],
                                      qcfg, mesh)
            layers.append(layer)
            sels.append(sel)
        self._setup(cfg, params, layers, sels, calib, qcfg, ecfg, mesh,
                    cuda_graphs)

    def _setup(self, cfg, params, layers, row_sels, calib, qcfg, ecfg, mesh,
               cuda_graphs):
        """The engine over this rank's sharded `layers` (and their row
        sites' select counts) and the replicated rest of `params`."""
        if cuda_graphs:
            if mesh.backend == "gloo":
                raise ValueError("gloo's collectives cannot be captured in "
                                 "a CUDA graph: the TP engine decodes "
                                 "eagerly (cuda_graphs=False)")
            raise NotImplementedError(
                "a captured NCCL decode step is not ported (ROADMAP queue 1 "
                "item 8): pass cuda_graphs=False")
        self.mesh, self.tp = mesh, mesh.tp
        self.steps: Optional[List[dict]] = None
        self._row_sels = row_sels
        qparams = {k: params[k] for k in ("embed", "final_norm", "lm_head",
                                          "lm_head_packed") if k in params}
        qparams["layers"] = layers
        super().__init__(cfg, qparams, calib, qcfg, ecfg, device=mesh.device,
                         quantize_params=False, fused_decode=False,
                         cuda_graphs=False)
        self._local_cfg = cfg.replace(num_heads=cfg.num_heads // mesh.tp,
                                      num_kv_heads=cfg.num_kv_heads
                                      // mesh.tp)

    @classmethod
    def dummy(cls, cfg: ModelConfig, calib, qcfg: QuantConfig,
              ecfg: EngineConfig, mesh: TPContext, seed: int = 0,
              dtype=torch.bfloat16,
              cuda_graphs: bool = False) -> "TPInferenceEngine":
        """InferenceEngine.dummy's weights (the same draws from `seed`),
        each layer drawn whole on every rank and sharded, so the full
        model never exists at once."""
        check_tp(cfg, qcfg, mesh.tp)
        device = mesh.device
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        calib = _to_device(calib, device)
        layers, sels = [], []
        for i in range(cfg.num_layers):
            lp = llama.init_layer_params(cfg, gen, dtype, device)
            layer, sel = _shard_layer(lp, calib[i], qcfg, mesh)
            layers.append(layer)
            sels.append(sel)
            del lp
        eng = cls.__new__(cls)
        eng._setup(cfg, dummy_tree(cfg, gen, dtype, device, layers), layers,
                   sels, calib, qcfg, ecfg, mesh, cuda_graphs)
        return eng

    # -- sharded state ------------------------------------------------------

    def new_state(self):
        """(cache, page_table, seq_lens): the pool of this rank's kv heads,
        the page table and seq_lens replicated."""
        e = self.ecfg
        cache = paged.init_cache(self._local_cfg, e.total_pages(),
                                 e.page_size, self.device)
        seq_lens = torch.zeros((e.max_batch,), dtype=torch.int32,
                               device=self.device)
        return cache, self._page_table(), seq_lens

    # -- the sharded layer --------------------------------------------------

    def _tp_layer(self, p, x, cos, sin, lc, sels, cache, li, pt, append_pos,
                  attend, qcfg):
        """One decoder layer on this rank's shard: the replicated
        activation quantize and the fused column GEMM, RoPE, the append
        into the local pool, `attend` (flash attention over the chunk,
        paged prefill or paged decode, as the base engine's forward
        chooses), the row-parallel o, the column gate-up, silu * up, the
        row-parallel down; each row GEMM's f32 partial summed over the
        ranks."""
        cfg, tp, ctx = self.cfg, self.tp, self.mesh
        b, t, d = x.shape
        dt = x.dtype
        qs_l = cfg.num_heads // tp * cfg.head_dim
        kvs_l = cfg.num_kv_heads // tp * cfg.head_dim
        per_row = qcfg.act_scale == "row"

        h = llama.rms_norm(x, p["attn_norm"], cfg.rms_eps)
        xa, gx = tpm._quantize_x_global(h.reshape(b * t, d), lc["attn_in"],
                                        p["qkv"].kq, per_row)
        qkv = gk.gemm_dequant(xa, p["qkv"], gx, out_dtype=dt)
        q = qkv[:, :qs_l].reshape(b, t, -1, cfg.head_dim)
        k = qkv[:, qs_l:qs_l + kvs_l].reshape(b, t, -1, cfg.head_dim)
        v = qkv[:, qs_l + kvs_l:].reshape(b, t, -1, cfg.head_dim)
        q, k_r = llama.apply_rope(q, k, cos, sin)
        paged.append_kv(cache, li, k_r, v, pt, append_pos)
        attn = attend(li, q, k_r, v).to(dt).reshape(b * t, qs_l)

        oa, go = tpm.quantize_x_row_site(attn, p, "o", sels, p["o"].kq, ctx,
                                         per_row)
        x = x + tpm._row_linear(p["o"], oa, go, ctx, dt).reshape(b, t, d)

        h = llama.rms_norm(x, p["mlp_norm"], cfg.rms_eps)
        xa, gx = tpm._quantize_x_global(h.reshape(b * t, d), lc["mlp_in"],
                                        p["gateup"].kq, per_row)
        gu = gk.gemm_dequant(xa, p["gateup"], gx, out_dtype=dt)
        i_l = gu.shape[1] // 2
        inter = qk._silu_mul(gu[:, :i_l], gu[:, i_l:])
        ia, gi = tpm.quantize_x_row_site(inter, p, "down", sels,
                                         p["down"].kq, ctx, per_row)
        return x + tpm._row_linear(p["down"], ia, gi, ctx, dt).reshape(
            b, t, d)

    def _layers(self, x, cos, sin, cache, pt, append_pos, attend, qcfg):
        for li, p in enumerate(self.qparams["layers"]):
            x = self._tp_layer(p, x, cos, sin, self.calib[li],
                               self._row_sels[li], cache, li, pt,
                               append_pos, attend, qcfg)
        return llama.rms_norm(x, self.qparams["final_norm"],
                              self.cfg.rms_eps)

    # -- public steps, recorded on request ------------------------------------

    def record_steps(self) -> None:
        """Record every later step (``steps``) and time the collectives."""
        self.steps = []
        self.mesh.comm.timed = True

    def _recorded(self, kind: str, fn, *args):
        if self.steps is None:
            return fn(*args)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda *a: None)
        sync(self.device)
        calls0, sec0 = self.mesh.comm.snapshot()
        t0 = time.perf_counter()
        logits, state = fn(*args)
        sync(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        calls, sec = self.mesh.comm.snapshot()
        self.steps.append(dict(
            kind=kind, ms=ms, comm_ms=(sec - sec0) * 1e3,
            comm={op: calls[op] - calls0[op] for op in calls},
            digest=hashlib.sha256(logits.float().cpu().numpy().tobytes())
            .hexdigest()))
        return logits, state

    def prefill(self, state, tokens, lens, starts=None):
        return self._recorded("prefill", super().prefill, state, tokens,
                              lens, starts)

    def decode_step(self, state, tokens, active):
        return self._recorded("decode", super().decode_step, state, tokens,
                              active)

    def verify_step(self, state, tokens, valid):
        return self._recorded("verify", super().verify_step, state, tokens,
                              valid)
