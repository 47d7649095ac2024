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

  MoE experts           the qdq expert stacks sharded on the expert
                        axis over the tp group (parallel/ep.py: routing
                        global, one all_reduce(SUM) a MoE block, one
                        MAX more at per-tensor scales); the router and
                        the shared expert replicated

The column sites' rmsnorm + quantize of the replicated activation is the
single-device engine's (quantize.rmsnorm_quantize_x: the actq kernel's
rmsnorm mode at select-free sites at per-row scales; JAX's TP engine
runs rms_norm then the quantize there, the same computation up to
rmsnorm's sum order). The row sites' activation global scale is an
all_reduce(MAX), so the quantization grids match the unsharded engine's:
a decode step makes 2 SUM and 2 MAX all_reduces a dense layer and no
other collective (the head and the sampling are replicated). tp must
divide num_kv_heads, and num_experts on a MoE config.

Data parallelism (a ``make_mesh(dp, tp)`` mesh, dp > 1 dividing
max_batch): dp group g serves slots [g * B/dp, (g + 1) * B/dp) against a
page pool of its own (page ids local to the group, ``page_groups()``;
the batcher keeps one free list a group). Every rank holds the whole
page table and seq_lens, updates them alike, and computes only its
group's rows; each step ends in one all_gather over the dp group (the
ranks at its tp index) of the step's logits (prefill: each row's last
logits; decode: [B/dp, V]; verify: [B/dp, W, V]), so every rank returns
the whole batch's and the batchers of all ranks stay identical.
Sampling (generate, decode_scan) draws group g's rows from a generator
of the seed mixed with g (JAX folds the dp index into its key), every
rank drawing every group's rows alike. When dp does not divide
max_batch every dp group serves the whole batch (replicated, JAX's
fallback); then, as at dp 1, the same step path runs over the whole
batch and gathers nothing.

JAX runs each step as one shard_map'd program; here each rank runs the
base engine's forwards (``_prefill_forward``: flash attention over the
chunk; ``_prefill_chunk_forward``: the paged prefill over the pool, for
chunked and suffix prefill and the verify; ``_decode_forward``: paged
decode) with ``_tp_layer`` as their layer, and the base engine's host
loops (chunks, ``decode_scan``'s steps, sampling on the device from a
generator every rank seeds alike, so the ranks keep identical tokens).

Under nccl the engine captures its steps as the single-device engine
does (``cuda_graphs``, by default there): ``decode_step``, ``decode_scan``
and ``verify_step`` replay a CUDA graph of this rank's step, its
collectives inside. The bodies the base engine captures call the step
by name (``_decode_logits``, ``_verify_logits``), which this engine
overrides with its own: its dp group's rows of the page table and
seq_lens, every group's seq_lens advanced, the logits gathered over the
dp group. A sampled body draws from one generator a dp group, each
registered with the graph and seeded in ``decode_scan`` as ``generate``
seeds them. A capture counts its collectives apart and each replay adds
them (``mesh.CommCapture``), so ``record_steps()`` still records a
step's collectives; a replay is timed around the replay. Under gloo on
the card the steps run eagerly (gloo's collectives cannot be captured;
``cuda_graphs=True`` raises); on the CPU there is nothing to capture, and
``cuda_graphs=True`` runs the same bodies eagerly.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..cache import paged
from ..config import ModelConfig, QuantConfig
from ..engine.engine import (EngineConfig, InferenceEngine, _to_device,
                             dummy_tree, split_qkv)
from ..kernels import gemm as gk
from ..kernels import quantize as qk
from ..kernels import rope_kv as rk
from ..engine import sampling as smp
from ..models import llama
from ..models import moe as moem
from ..models.quantized import SiteCalib
from ..quant import numerics as N
from ..quant import packing
from . import ep as epm
from . import tp as tpm
from .mesh import CommCapture, StepRecords, TPContext


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
    """One layer's shard for this rank and its row sites' select counts.
    A MoE layer's experts are sliced to the rank's E/tp before their qdq
    stacks are made (each expert quantizes on its own scales, so this
    equals slicing the whole layer's stacks)."""
    tp, rank = mesh.tp, mesh.rank
    layer = {"attn_norm": lp["attn_norm"], "mlp_norm": lp["mlp_norm"],
             "qkv": _shard_fused_col(lp, ("q", "k", "v"), lc["attn_in"], tp,
                                     qcfg, rank)}
    rows = (("o", "o_in"),)
    if "moe" in lp:
        layer["moe"] = moem.quantize_moe_params(
            epm.shard_moe_params(lp["moe"], mesh), lc, qcfg)
    else:
        layer["gateup"] = _shard_fused_col(lp, ("gate", "up"), lc["mlp_in"],
                                           tp, qcfg, rank)
        rows += (("down", "down_in"),)
    sels = {}
    for name, site in rows:
        pw, idx, pos, sel, _ = tpm.shard_linear_row(
            lp[name]["w"], None, lc[site], tp, qcfg.weight_fmt, rank,
            qcfg.w_scale, exact=qcfg.tp_exact_arc)
        layer[name] = pw
        layer[f"{name}_idx"] = idx
        if pos is not None:
            layer[f"{name}_pos"] = pos
        sels.update({name: sel, f"_{name}_ke": lc[site].select_num})
    return layer, sels


def captures(mesh: TPContext, cuda_graphs: Optional[bool]) -> bool:
    """Whether a TP engine over `mesh` captures its steps: as asked, by
    default under nccl. A CUDA graph under gloo on the card raises
    (gloo's collectives cannot be captured); on the CPU there is nothing
    to capture and the bodies run eagerly."""
    if cuda_graphs is None:
        return mesh.backend == "nccl"
    if cuda_graphs and mesh.backend == "gloo" and mesh.device.type == "cuda":
        raise ValueError("gloo's collectives cannot be captured in a CUDA "
                         "graph: over gloo on the card the TP engine "
                         "decodes eagerly (cuda_graphs=False); nccl "
                         "captures")
    return bool(cuda_graphs)


def check_tp(cfg: ModelConfig, qcfg: QuantConfig, tp: int) -> None:
    """Raise unless the TP engine serves cfg at qcfg over tp ranks."""
    if cfg.num_experts and cfg.num_experts % tp:
        raise ValueError(f"tp={tp} must divide num_experts="
                         f"{cfg.num_experts} (experts shard over the tp "
                         "ranks, parallel/ep.py)")
    if cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_kv_heads="
                         f"{cfg.num_kv_heads}")
    if not (qcfg.use_kernels and qcfg.quant_type == "NVFP4"
            and qcfg.act_bits == 4):
        raise ValueError("the TP engine serves the packed NVFP4 W4A4 path "
                         "(use_kernels, act_bits 4)")


class TPInferenceEngine(StepRecords, InferenceEngine):
    """Tensor-parallel quantized serving engine, one instance a rank.

    Same public API as InferenceEngine (new_state / prefill / decode_step
    / decode_scan / verify_step / generate); every rank builds it on the
    same weights and calls it with the same arguments. Weights are
    quantized and sharded at construction; the KV pool holds this rank's
    kv heads (of its dp group's slots, at dp > 1). ``record_steps()``
    makes every step append a record of its host ms, its collectives and
    a digest of its logits to ``steps`` (the device synchronized around
    each step and each collective run eagerly). cuda_graphs: as the
    single-device engine's, by default under nccl (``captures``)."""

    def __init__(self, cfg: ModelConfig, params, calib, qcfg: QuantConfig,
                 ecfg: EngineConfig, mesh: TPContext,
                 cuda_graphs: Optional[bool] = None):
        check_tp(cfg, qcfg, mesh.tp)
        cuda_graphs = captures(mesh, cuda_graphs)
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
        sites' select counts) and the replicated rest of `params`;
        cuda_graphs as ``captures`` settled it."""
        self.mesh, self.tp = mesh, mesh.tp
        self._row_sels = row_sels
        qparams = {k: params[k] for k in ("embed", "final_norm", "lm_head",
                                          "lm_head_packed") if k in params}
        qparams["layers"] = layers
        super().__init__(cfg, qparams, calib, qcfg, ecfg, device=mesh.device,
                         quantize_params=False, fused_decode=False,
                         cuda_graphs=cuda_graphs)
        self._local_cfg = cfg.replace(num_heads=cfg.num_heads // mesh.tp,
                                      num_kv_heads=cfg.num_kv_heads
                                      // mesh.tp)
        # the data-parallel axis: this rank's dp group serves its slot
        # run; a dp that does not divide max_batch replicates (dp 1)
        self.dp = (mesh.dp if mesh.dp > 1 and ecfg.max_batch % mesh.dp == 0
                   else 1)
        bl = ecfg.max_batch // self.dp
        g = mesh.dp_rank if self.dp > 1 else 0
        self._rows = slice(g * bl, (g + 1) * bl)

    @classmethod
    def dummy(cls, cfg: ModelConfig, calib, qcfg: QuantConfig,
              ecfg: EngineConfig, mesh: TPContext, seed: int = 0,
              dtype=torch.bfloat16,
              cuda_graphs: Optional[bool] = None) -> "TPInferenceEngine":
        """InferenceEngine.dummy's weights (the same draws from `seed`),
        each layer drawn whole on every rank and sharded, so the full
        model never exists at once."""
        check_tp(cfg, qcfg, mesh.tp)
        cuda_graphs = captures(mesh, cuda_graphs)
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

    def _pages_local(self) -> int:
        """A dp group's pool, its sink page 0 included: the static layout
        of its max_batch/dp slots, or with dynamic pages num_pages split
        evenly over the groups (at dp 1, ecfg.total_pages())."""
        e = self.ecfg
        if self.dp == 1:
            return e.total_pages()
        if e.dynamic_pages and e.num_pages:
            pl = e.num_pages // self.dp
            if pl < e.pages_per_seq + 1:
                raise ValueError(
                    f"num_pages={e.num_pages} gives {pl} pages a dp group "
                    f"< {e.pages_per_seq + 1} required")
            return pl
        return e.max_batch // self.dp * e.pages_per_seq + 1

    def page_groups(self):
        """One page pool a dp group (local ids; the batcher keeps one free
        list a group)."""
        return (self.dp, self._pages_local(), self.ecfg.max_batch // self.dp)

    def new_state(self):
        """(cache, page_table, seq_lens): the pool of this rank's kv heads
        (of its dp group), the whole page table and seq_lens replicated."""
        e = self.ecfg
        cache = paged.init_cache(self._local_cfg, self._pages_local(),
                                 e.page_size, self.device)
        seq_lens = torch.zeros((e.max_batch,), dtype=torch.int32,
                               device=self.device)
        return cache, self._page_table(), seq_lens

    def _page_table(self) -> torch.Tensor:
        """The static layout with page ids local to each dp group's pool
        (slot b at local slot b mod B/dp), or all-sink."""
        e = self.ecfg
        if e.dynamic_pages or self.dp == 1:
            return super()._page_table()
        bl, pps = e.max_batch // self.dp, e.pages_per_seq
        return (1 + (torch.arange(e.max_batch) % bl)[:, None] * pps
                + torch.arange(pps)[None, :]).to(torch.int32).to(self.device)

    # -- the sharded layer --------------------------------------------------

    def _tp_layer(self, p, x, cos, sin, lc, sels, cache, li, pt, append_pos,
                  attend, qcfg):
        """One decoder layer on this rank's shard: the replicated rmsnorm +
        activation quantize (_norm_quantize) and the fused column GEMM,
        RoPE with the append into the local pool (#17 rope_kv), `attend`
        (flash attention over the chunk, paged prefill or paged decode,
        as the base engine's forward chooses), the row-parallel o, then
        the column gate-up, silu * up and the row-parallel down, or a MoE
        layer's expert-parallel block (ep_moe_block over the tp group);
        each row GEMM's f32 partial summed over the ranks."""
        cfg, tp, ctx = self.cfg, self.tp, self.mesh
        b, t, d = x.shape
        dt = x.dtype
        qs_l = cfg.num_heads // tp * cfg.head_dim
        kvs_l = cfg.num_kv_heads // tp * cfg.head_dim
        per_row = qcfg.act_scale == "row"

        xa, gx = self._norm_quantize(x, p["attn_norm"], lc["attn_in"],
                                     p["qkv"].kq, per_row)
        qkv = gk.gemm_dequant(xa, p["qkv"], gx, out_dtype=dt)
        q, k, v = split_qkv(qkv, b, t, qs_l, kvs_l, cfg.head_dim)
        q, k_r = rk.rope_append_kv(q, k, v, cos, sin, cache, li, pt,
                                   append_pos)
        attn = attend(li, q, k_r, v).to(dt).reshape(b * t, qs_l)

        oa, go = tpm.quantize_x_row_site(attn, p, "o", sels, p["o"].kq, ctx,
                                         per_row)
        x = x + tpm._row_linear(p["o"], oa, go, ctx, dt).reshape(b, t, d)

        if "moe" in p:
            h = llama.rms_norm(x, p["mlp_norm"], cfg.rms_eps)
            return x + epm.ep_moe_block(cfg, p["moe"], h, ctx, lc,
                                        qcfg).to(dt)
        xa, gx = self._norm_quantize(x, p["mlp_norm"], lc["mlp_in"],
                                     p["gateup"].kq, per_row)
        gu = gk.gemm_dequant(xa, p["gateup"], gx, out_dtype=dt)
        i_l = gu.shape[1] // 2
        inter = qk._silu_mul(gu[:, :i_l], gu[:, i_l:])
        ia, gi = tpm.quantize_x_row_site(inter, p, "down", sels,
                                         p["down"].kq, ctx, per_row)
        return x + tpm._row_linear(p["down"], ia, gi, ctx, dt).reshape(
            b, t, d)

    def _norm_quantize(self, x, norm_w, site: SiteCalib, kq: int,
                       per_row: bool):
        """A column site's rmsnorm + quantize of the replicated activation
        x [B, T, D], the single-device engine's: the actq kernel's rmsnorm
        mode at a select-free site at per-row scales, else rms_norm then
        quantize_x_arc (the JAX TP engine's route everywhere; on the CPU
        the two are one computation)."""
        return qk.rmsnorm_quantize_x(x.reshape(-1, x.shape[-1]), norm_w,
                                     self.cfg.rms_eps, site.reorder_index,
                                     site.select_num, kq=kq, per_row=per_row)

    def _layers(self, x, cos, sin, cache, pt, append_pos, attend, qcfg):
        for li, p in enumerate(self.qparams["layers"]):
            x = self._tp_layer(p, x, cos, sin, self.calib[li],
                               self._row_sels[li], cache, li, pt,
                               append_pos, attend, qcfg)
        return llama.rms_norm(x, self.qparams["final_norm"],
                              self.cfg.rms_eps)

    # -- data parallelism: this group's rows, the logits gathered -----------

    def _local(self, state):
        """The state's view of this dp group's rows (its pool, and views
        of the page table's and seq_lens' rows, written in place)."""
        cache, pt, seq_lens = state
        return cache, pt[self._rows], seq_lens[self._rows]

    def _gather(self, logits: torch.Tensor) -> torch.Tensor:
        """The dp groups' logits in slot order: the step's one all_gather
        over the dp group (none at dp 1 or replicated)."""
        return logits if self.dp == 1 else self.mesh.dp_comm().all_gather(
            logits)

    def _generator(self, seed: int):
        """One generator a dp group, group g's seeded with
        mix_seed(seed, g) (JAX folds the dp index into its key only when
        the batch is dp-sharded); at dp 1 the base engine's."""
        if self.dp == 1:
            return super()._generator(seed)
        return [super(TPInferenceEngine, self)._generator(
            smp.mix_seed(seed, g)) for g in range(self.dp)]

    def _reseed(self, gen, seed: int) -> None:
        if not isinstance(gen, list):
            return super()._reseed(gen, seed)
        for g, x in enumerate(gen):
            x.manual_seed(smp.mix_seed(seed, g))

    def _sample(self, logits, sampling, gen) -> torch.Tensor:
        """The base engine's draw, each dp group's rows from its own
        generator (every rank draws every group's rows alike)."""
        if not isinstance(gen, list):
            return InferenceEngine._sample(logits, sampling, gen)
        return torch.cat([InferenceEngine._sample(part, sampling, g)
                          for part, g in zip(logits.chunk(self.dp), gen)])

    def _prefill_local(self, state, tokens, lens, starts=None):
        dev, r = self.device, self._rows
        tokens = torch.as_tensor(tokens, device=dev).long()
        lens = torch.as_tensor(lens, device=dev).to(torch.int32)
        if starts is not None:
            starts = torch.as_tensor(starts, device=dev)[r]
        logits, _ = InferenceEngine.prefill(self, self._local(state),
                                            tokens[r], lens[r], starts)
        seq_lens = state[2]              # the other groups' rows alike
        seq_lens.copy_(torch.where(lens > 0, lens, seq_lens))
        return self._gather(logits), state

    # the step the base engine's bodies and eager loop run: no host read,
    # so it captures as it is

    def _decode_logits(self, state, tokens, active):
        """This dp group's decode rows, every group's seq_lens advanced
        alike, the logits gathered: [B, V]."""
        r = self._rows
        cache, pt, seq_lens = self._local(state)
        new_lens = state[2] + active.to(torch.int32)
        logits = self._decode_forward(cache, pt, seq_lens, tokens[r],
                                      active[r])
        state[2].copy_(new_lens)
        return self._gather(logits)

    def _verify_logits(self, state, tokens, valid):
        """This dp group's verify rows, the logits gathered: [B, W, V]."""
        r = self._rows
        cache, pt, seq_lens = self._local(state)
        return self._gather(self._verify_forward(cache, pt, seq_lens,
                                                 tokens[r], valid[r]))

    def _capture_counters(self) -> list:
        return [CommCapture(self.mesh.comm)]

    def _scan_replay(self, g, state) -> None:
        self._recorded("decode", _replayed, g, state)

    # -- public steps, recorded on request ------------------------------------

    def prefill(self, state, tokens, lens, starts=None):
        return self._recorded("prefill", self._prefill_local, state, tokens,
                              lens, starts)

    def decode_step(self, state, tokens, active):
        return self._recorded("decode", super().decode_step, state, tokens,
                              active)

    def verify_step(self, state, tokens, valid):
        return self._recorded("verify", super().verify_step, state, tokens,
                              valid)


def _replayed(g, state):
    """One replay of a decode graph: (its logits, state)."""
    g.replay(state)
    return g.io.logits, state
