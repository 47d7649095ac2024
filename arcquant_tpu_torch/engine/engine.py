"""W4A4 serving engine over the paged int4 KV cache (counterpart of
``arcquant_tpu/engine/engine.py``, single device).

  - prefill: rmsnorm + act-quantize, fused qkv GEMM (w8 or w4 weights,
    qcfg.weight_fmt; with Qwen2's bias), RoPE, int4 KV quantize-append into the pool, causal flash
    attention over the bf16 chunk, quantize + o GEMM, rmsnorm +
    quantize + gateup GEMM, silu*mul + re-quantize + down GEMM; then the
    final norm and the W4A16 packed LM head on each row's last token.
  - chunked prefill (``prefill_chunk``) and suffix prefill (per-row
    ``starts``, prefix sharing): each chunk appends its K/V into the pool
    and attends straight over the int4 pool with the paged flash-prefill
    kernel, so long prompts use bounded activation memory.
  - hybrid prefill (``prefill_act_bits=16``): the prefill forwards run
    W4A16 (exact bf16 activations, unit scale), decode stays W4A4.
  - decode: the same sites at M = batch, with paged int4 flash-decode
    over the pool instead of flash attention.
  - quant_type "BF16": the same engine on unquantized bf16 linears
    (``llama.linear``, f32 accumulation) with no activation quantize,
    over the same int4 pool and attention kernels: the baseline the
    W4A4 engine is measured against. ``quantize_lm_head=False`` (and
    BF16) keep the bf16 LM head, an f32-accumulated product with f32
    logits.
  - the fake formats (MXFP4, MXFP6, INT4) and ``use_kernels=False``: the
    same engine on fake-quantized linears (qdq weights, rms_norm then the
    plain qdq quantize at every site, f32-accumulated products; an MoE
    layer's experts as qdq stacks), as the JAX engine runs them; the
    attention kernels and, for NVFP4 with quantize_lm_head, the packed
    head still run.
  - ``act_scale="tensor"`` on the packed route: one f32 scale over each
    site's activation (``quantize._quantize_x_tensor``, plain torch
    ops), a scalar tensor through the unfused chain; the megakernels
    never engage, and the decode step still captures as a graph (the
    scale stays on the device).

PyTorch runs eagerly: prefill runs op by op. The pool is preallocated
by ``new_state`` and every step writes into it in place (the JAX
engine's buffer donation); the returned state holds the same tensors.

Decode is the JAX engine's jitted ``decode_step`` and on-device
``decode_scan``: on the card, one decode step (the forward, the greedy
or sampled next token, the eos update) is captured once as a CUDA graph
over persistent buffers and replayed, ``decode_scan`` replaying it once
a step with no host read between steps. The graphs are keyed by the
state's tensors, the route and the sampling parameters (at most
``GRAPH_CACHE`` kept); the seed, the eos id and the step count are
device values or replay counts. ``cuda_graphs=False`` keeps the eager
loop, the graphs' A/B reference; on the CPU the same body runs
eagerly.

Speculative decoding's verify (``verify_step``, engine/spec.py) is the
JAX engine's: the paged chunk forward of W tokens a row at the decode
qcfg, every position's logits, seq_lens left to the caller; on the card
it replays a graph of its own, keyed like the decode step's and by W.

Where the JAX engine's gates engage its decode megakernels
(kernels/mlp_fused.py: W4A4 sites of 4 to 16 rows, per-row scales, w8
weights), the port takes its own, in JAX's order: quantize + GEMM in one
launch at a select-free attn_in (with the rmsnorm) and o_in; the whole
MLP in one launch when down_in is select-free (folding the rmsnorm when
mlp_in is select-free too); gateup + silu*mul + quantize in one launch,
then the ARC residual in torch and the down GEMM, when down_in has a
residual. They equal the unfused chain bit for bit; the chain runs
everywhere else, and everywhere with ``fused_decode=False``.

An MoE config (Qwen-MoE, Mixtral) keeps the attention sites and their
routes; its MLP is ``models/moe.py``'s ``moe_block`` after a plain
rms_norm, as in the JAX engine: dense mode (the fused GEMM over all
experts' gate/up, the batched GEMM for their down projections) up to
``moe.DENSE_MODE_MAX_T`` tokens, so at decode, capacity dispatch above.
"""

from __future__ import annotations

import collections
import functools
import sys
import time
import traceback
import weakref
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..cache import paged
from ..config import KV_PAGE_SIZE, ModelConfig, QuantConfig
from ..kernels import _build, attention, gemm as gk
from ..kernels import mlp_fused as mf
from ..kernels import paged_decode as pdk
from ..kernels import quantize as qk
from ..models import llama, moe, quantized
from ..quant import numerics as N
from ..quant import packing
from . import sampling as smp

# Captured decode graphs an engine keeps (the least recently used goes
# first): a batcher holds one state for its life, generate() makes one
# per call, and the allocator often hands a new state the freed one's
# addresses, which hit the cache.
GRAPH_CACHE = 4
# Steps of next tokens the decode body's out-buffer holds: decode_scan
# copies it out (on the device) after every SCAN_CHUNK steps.
SCAN_CHUNK = 64


@dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    max_seq_len: int = 2048
    page_size: int = KV_PAGE_SIZE
    num_pages: int = 0          # 0 = max_batch * pages_per_seq + 1
    # dynamic_pages=True: the page table starts empty (all-sink) and a
    # host-side PageAllocator (engine/scheduler.py) maps pages on demand,
    # so the pool may be smaller than max_batch * max_seq (requests queue
    # when it is full). False: static layout, slot i owns pages
    # [1 + i*pps, 1 + (i+1)*pps).
    dynamic_pages: bool = False
    # > 0: prompts longer than this prefill in chunks of this many tokens,
    # each attending straight over the int4 pool. 0 = one shot only.
    prefill_chunk: int = 0
    # Refcounted prefix sharing (needs dynamic_pages): a request whose
    # prompt shares a page-aligned prefix with a cached one reuses those
    # pages and prefills only its suffix.
    prefix_sharing: bool = False

    @property
    def pages_per_seq(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    def __post_init__(self):
        if self.prefix_sharing and not self.dynamic_pages:
            raise ValueError("prefix_sharing requires dynamic_pages "
                             "(the PageAllocator owns refcounts)")
        if self.dynamic_pages:
            need = self.pages_per_seq + 1
        else:
            need = self.max_batch * self.pages_per_seq + 1
        if self.num_pages and self.num_pages < need:
            raise ValueError(
                f"num_pages={self.num_pages} < {need} required ("
                + ("one sequence + sink" if self.dynamic_pages else
                   "max_batch*pages_per_seq+1 for the static page layout")
                + ")")

    def total_pages(self) -> int:
        return self.num_pages or self.max_batch * self.pages_per_seq + 1


def _a4_kernels(qcfg) -> bool:
    """NVFP4 W4A4 sites on the packed kernels (use_kernels), the JAX
    engine's condition for its Pallas quantize routes."""
    return (qcfg.quant_type == "NVFP4" and qcfg.use_kernels
            and qcfg.act_bits == 4)


def _norm_quantize(x2, norm_w, eps, site, qcfg):
    """rmsnorm + activation quantize of one site: (xa, gx). NVFP4 W4A4 on
    the kernels runs rmsnorm_quantize_x (the actq kernel's rmsnorm route
    at per-row scales; at per-tensor scales rms_norm, then the plain
    tensor quantize); every other setting (W4A16, BF16, the fake formats,
    use_kernels=False) applies rms_norm, then the site's quantize."""
    if _a4_kernels(qcfg):
        return qk.rmsnorm_quantize_x(x2, norm_w, eps, site.reorder_index,
                                     site.select_num,
                                     per_row=qcfg.act_scale == "row")
    return quantized._act_quantize(llama.rms_norm(x2, norm_w, eps), site,
                                   qcfg)


def _fused_ok(qcfg, fused: bool) -> bool:
    """The fused routes' common precondition, the JAX engine's gates:
    NVFP4 W4A4 sites on the kernels at per-row scales (a per-tensor scale
    takes the unfused chain), and the engine's switch."""
    return fused and _a4_kernels(qcfg) and qcfg.act_scale == "row"


def _single_gemm_fused_ok(pw, site, m, d, qcfg, fused):
    """Gate for the quantize + GEMM megakernel at an attn_in or o_in
    site: a select-free site on the actq kernel's shapes."""
    return (_fused_ok(qcfg, fused) and qk.actq_ok(m, d, pw.kq)
            and mf.gemm_actq_ok(pw, m, d, True, site.select_num))


def _attn_common(cfg, p, x2, layer_calib, qcfg, b, t, norm_w, fused=False):
    """rmsnorm + quantize + fused qkv GEMM, split into heads."""
    m, d = x2.shape
    if _single_gemm_fused_ok(p["qkv"], layer_calib["attn_in"], m, d, qcfg,
                             fused):
        qkv, _ = mf.gemm_w8_actq_fused(x2, p["qkv"], d, out_dtype=x2.dtype,
                                       norm_w=norm_w, norm_eps=cfg.rms_eps)
    else:
        xa, gx = _norm_quantize(x2, norm_w, cfg.rms_eps,
                                layer_calib["attn_in"], qcfg)
        qkv = quantized._q_linear(p["qkv"], xa, gx, x2.dtype)
    qs, kvs = cfg.q_size, cfg.kv_size
    q = qkv[:, :qs].reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = qkv[:, qs:qs + kvs].reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = qkv[:, qs + kvs:].reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _o_proj(cfg, p, attn, layer_calib, qcfg, b, t, fused=False):
    attn2 = attn.reshape(b * t, cfg.q_size)
    if _single_gemm_fused_ok(p["o"], layer_calib["o_in"], b * t,
                             cfg.q_size, qcfg, fused):
        y, _ = mf.gemm_w8_actq_fused(attn2, p["o"], cfg.q_size,
                                     out_dtype=attn.dtype)
        return y.reshape(b, t, -1)
    oa, go = quantized._act_quantize(attn2, layer_calib["o_in"], qcfg)
    return quantized._q_linear(p["o"], oa, go, attn.dtype).reshape(b, t, -1)


def _mlp(cfg, p, x, layer_calib, qcfg, norm_w, fused=False):
    if "moe" in p:
        # the routed experts (+ the shared expert) on the normed input,
        # as the JAX engine runs them: no fused rmsnorm quantize and no
        # megakernel
        return moe.moe_block(cfg, p["moe"], llama.rms_norm(x, norm_w,
                                                           cfg.rms_eps),
                             layer_calib, qcfg)
    b, t, d = x.shape
    m = b * t
    x2 = x.reshape(m, d)
    gate_up, down = p["gateup"], p["down"]
    f = cfg.intermediate_size
    sel2 = layer_calib["down_in"].select_num
    fok = _fused_ok(qcfg, fused)
    if (fok and layer_calib["mlp_in"].select_num == 0
            and qk.actq_ok(m, d, gate_up.kq)
            and mf.mlp_fused_ok(gate_up, down, m, f, True, sel2)):
        # the whole MLP, its rmsnorm + quantize included, in one launch
        out, _, _ = mf.mlp_w8_fused(x2, None, gate_up, down, f,
                                    out_dtype=x.dtype, norm_w=norm_w,
                                    norm_eps=cfg.rms_eps)
        return out.reshape(b, t, d)
    xa, gx = _norm_quantize(x2, norm_w, cfg.rms_eps,
                            layer_calib["mlp_in"], qcfg)
    if fok and mf.mlp_fused_ok(gate_up, down, m, f, True, sel2):
        out, _, _ = mf.mlp_w8_fused(xa, gx, gate_up, down, f,
                                    out_dtype=x.dtype)
        return out.reshape(b, t, d)
    c = layer_calib["down_in"]
    if fok and sel2 and mf.gu_actq_ok(gate_up, m, f, down.kq, True):
        # gateup + silu*mul + quantize in one launch; the ARC residual of
        # the selected columns is recomputed from gu, as the chain does
        ia, gu, gi = mf.gateup_silu_quantize(xa, gx, gate_up, f, down.kq,
                                             out_dtype=x.dtype)
        idx = qk._top(c.reorder_index, sel2, x.device)
        qk._arc_residual_into(qk._silu_mul(gu[:, idx], gu[:, idx + f]),
                              ia, gi, idx, f)
        return quantized._q_linear(down, ia, gi, x.dtype).reshape(b, t, d)
    gu = quantized._q_linear(gate_up, xa, gx, x.dtype)
    if _a4_kernels(qcfg):
        ia, gi = qk.silu_mul_quantize_gu(gu, c.reorder_index, c.select_num,
                                         per_row=qcfg.act_scale == "row")
    else:   # silu * up in f32, rounded to the activation dtype
        ia, gi = quantized._act_quantize(qk._silu_mul(gu[:, :f], gu[:, f:]),
                                         c, qcfg)
    return quantized._q_linear(down, ia, gi, x.dtype).reshape(b, t, d)


def pack_lm_head(head: torch.Tensor, qcfg: QuantConfig, step: int = 16384):
    """W4A16 packed LM head in qcfg.weight_fmt: the head packed like a
    linear with no ARC residual, in row chunks so the f32 transients of a
    150k-vocab head stay small. A tensor weight scale is taken over the
    whole head."""
    ridx = torch.arange(head.shape[1], dtype=torch.int32,
                        device=head.device)
    gs = (None if qcfg.w_scale == "channel"
          else head.abs().amax().float() * N.INV_NVFP4_GLOBAL_DIV)
    return packing.pack_weight_arc_rows(head, ridx, 0, fmt=qcfg.weight_fmt,
                                        global_scale=gs, step=step)


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (packing.PackedWeight, packing.PackedWeightI8)):
        return type(tree)(*(_to_device(x, device) for x in tree))
    if isinstance(tree, quantized.SiteCalib):
        return quantized.SiteCalib(tree.reorder_index.to(device),
                                   tree.select_num)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree


def dummy_tree(cfg: ModelConfig, gen: torch.Generator, dtype, device,
               layers: list) -> dict:
    """A dummy engine's tree around its layers (drawn first from gen): the
    embedding, drawn next, and a unit final norm."""
    embed = (torch.randn((cfg.vocab_size, cfg.hidden_size), generator=gen,
                         dtype=torch.float32, device=device) * 0.02).to(dtype)
    return {"embed": embed,
            "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype,
                                     device=device),
            "layers": layers}


def resolve_device(device) -> torch.device:
    """The engine's device. A CUDA device without a CUDA build or card
    raises: an entry point runs on the CPU only when asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return device


def _state_key(state) -> tuple:
    """The addresses of a state's tensors (every layer's pool, the page
    table, seq_lens): a graph captured on them is right for any state
    at the same addresses."""
    cache, pt, seq_lens = state
    return tuple(t.data_ptr()
                 for t in (*cache.codes, *cache.params, pt, seq_lens))


@dataclass
class _DecodeIO:
    """The persistent buffers the decode body reads and writes in place."""
    tokens: torch.Tensor            # [B] i32: fed in; the next tokens out
    active: torch.Tensor            # [B] bool: eos retires a slot
    eos: torch.Tensor               # [1] i32: the eos id, -1 for none
    step: torch.Tensor              # [1] i64: the out column written next
    out: torch.Tensor               # [B, SCAN_CHUNK] i32: next tokens
    logits: Optional[torch.Tensor] = None   # [B, V] f32 of the last step

    @classmethod
    def new(cls, b: int, device) -> "_DecodeIO":
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(z(b), z(b, dtype=torch.bool),
                   torch.full((1,), -1, dtype=torch.int32, device=device),
                   z(1, dtype=torch.int64), z(b, SCAN_CHUNK))


@dataclass
class _VerifyIO:
    """The persistent buffers the verify body reads and writes."""
    tokens: torch.Tensor            # [B, W] i32: carried token + drafts
    valid: torch.Tensor             # [B] i32: tokens of each row to append
    logits: Optional[torch.Tensor] = None   # [B, W, V] f32

    @classmethod
    def new(cls, b: int, w: int, device) -> "_VerifyIO":
        return cls(torch.zeros((b, w), dtype=torch.int32, device=device),
                   torch.zeros((b,), dtype=torch.int32, device=device))


@dataclass
class _Graph:
    """One step body over persistent buffers: `body(engine, state, io,
    gen)` runs it eagerly, in place; on the card `graph` holds its
    capture and `launches` the kernel launches one replay makes. `gen`
    is the generator a sampled body draws from (registered with the
    graph). The engine is held weakly: the engine caches its graphs, and
    a cycle through it would leave both to the cyclic garbage collector,
    which can free a graph's memory pool while another graph is being
    captured (and so break that capture)."""
    io: object
    body: Callable
    engine: "weakref.ref"
    gen: Optional[torch.Generator] = None
    graph: Optional["torch.cuda.CUDAGraph"] = None
    launches: Optional[_build.GraphLaunches] = None

    def run(self, state) -> None:
        """The body, run eagerly."""
        self.body(self.engine(), state, self.io, self.gen)

    def replay(self, state) -> None:
        """One step: the graph's replay (counting its kernel launches), or
        on the CPU the body run eagerly."""
        if self.graph is None:
            self.run(state)
            return
        self.graph.replay()
        self.launches.replayed()


def _failed_at(e: BaseException) -> str:
    """The innermost frame of the error that broke a capture, as
    file:line: source. A failed capture's end raises an error of its
    own, whose context is the op's."""
    f = traceback.extract_tb((e.__context__ or e).__traceback__)[-1]
    return f"{f.filename}:{f.lineno}: {f.line}"


class InferenceEngine:
    """Quantized decoder engine over a paged int4 KV cache.

    Usage:
      eng = InferenceEngine(cfg, params, calib, qcfg, ecfg)   # on "cuda"
      state = eng.new_state()
      logits, state = eng.prefill(state, tokens, lens)
      logits, state = eng.decode_step(state, tokens, active)

    params holds either the raw bf16 layers (quantize_params=True, the
    engine packs them) or packed layers as built by
    ``quantize_layer_params_fused`` (quantize_params=False). The head is
    packed (W4A16) when qcfg.quantize_lm_head is set and the quant type
    is NVFP4; otherwise "lm_head" (or the tied embedding) stays bf16.

    fused_decode=False keeps every site on the unfused chain (the A/B
    reference of the decode megakernels); by default the megakernels run
    where the JAX engine's gates engage them.

    cuda_graphs=False decodes with the eager loop (the A/B reference of
    the captured step); by default a decode step on the card replays a
    CUDA graph (module docstring). A capture or replay that fails
    raises. ``drop_graphs()`` forgets the captured steps (after patching
    a kernel entry point, say)."""

    def __init__(self, cfg: ModelConfig, params, calib, qcfg: QuantConfig,
                 ecfg: EngineConfig, device="cuda",
                 quantize_params: bool = True, fused_decode: bool = True,
                 cuda_graphs: bool = True):
        quantized.check_qcfg(qcfg)
        self.cfg, self.qcfg, self.ecfg = cfg, qcfg, ecfg
        self.fused_decode = fused_decode
        self.cuda_graphs = cuda_graphs
        self._graphs = collections.OrderedDict()
        self._capture_stream = None
        # one entry per capture: capture_ms, pool_bytes, launches
        self.graph_captures: List[dict] = []
        # hybrid serving mode: the prefill forwards quantize with this,
        # decode with qcfg
        self.qcfg_prefill = (qcfg.replace(act_bits=qcfg.prefill_act_bits)
                             if qcfg.prefill_act_bits else qcfg)
        self.device = resolve_device(device)
        self.calib = _to_device(calib, self.device)
        params = _to_device(params, self.device)
        self.qparams = {k: v for k, v in params.items() if k != "layers"}
        self.qparams["layers"] = (
            [quantized.quantize_layer_params_fused(lp, self.calib[i], qcfg)
             for i, lp in enumerate(params["layers"])]
            if quantize_params else params["layers"])
        if ("lm_head_packed" not in self.qparams and qcfg.quantize_lm_head
                and qcfg.quant_type == "NVFP4"):
            head = self.qparams.pop("lm_head", self.qparams["embed"])
            self.qparams["lm_head_packed"] = pack_lm_head(head, qcfg)
        self.inv_freq = llama.rope_inv_freq(cfg).to(self.device)

    @classmethod
    def dummy(cls, cfg: ModelConfig, calib, qcfg: QuantConfig,
              ecfg: EngineConfig, seed: int = 0, device="cuda",
              dtype=torch.bfloat16, **kw) -> "InferenceEngine":
        """Random ("dummy") weights from `seed`, packed layer by layer so
        the full bf16 model never exists at once (BF16: bf16 layers).
        kw: the constructor's switches (fused_decode, cuda_graphs)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        quantized.check_qcfg(qcfg)
        calib = _to_device(calib, device)
        layers = []
        for i in range(cfg.num_layers):
            lp = llama.init_layer_params(cfg, gen, dtype, device)
            layers.append(quantized.quantize_layer_params_fused(
                lp, calib[i], qcfg))
            del lp
        return cls(cfg, dummy_tree(cfg, gen, dtype, device, layers), calib,
                   qcfg, ecfg, device=device, quantize_params=False, **kw)

    def _head_logits(self, x2d: torch.Tensor) -> torch.Tensor:
        """LM head, f32 logits: the W4A16 packed GEMM (x padded to kq,
        unit activation scale) when the head is packed, else the bf16
        head's product accumulated like f32."""
        if "lm_head_packed" in self.qparams:
            pw = self.qparams["lm_head_packed"]
            xp = torch.nn.functional.pad(x2d.to(torch.bfloat16),
                                         (0, pw.kq - x2d.shape[-1]))
            return gk.gemm_dequant(xp, pw, 1.0, out_dtype=torch.float32)
        head = self.qparams.get("lm_head", self.qparams["embed"])
        return gk.matmul_f32(x2d, head.t())

    # -- state ------------------------------------------------------------

    def page_groups(self):
        """(n_groups, pages_per_group, slots_per_group) for the batcher's
        PageAllocators: the single-device engine has one page pool; the
        data-parallel TP engine one pool a dp group (page ids local to
        it), its slots in consecutive runs."""
        return (1, self.ecfg.total_pages(), self.ecfg.max_batch)

    def new_state(self):
        """(cache, page_table, seq_lens) on the engine's device. Static
        layout: slot i gets pages [1 + i*pps, 1 + (i+1)*pps); page 0 is
        the sink. Dynamic mode: the table starts all-sink and the
        scheduler's PageAllocator fills rows in (in place)."""
        e = self.ecfg
        cache = paged.init_cache(self.cfg, e.total_pages(), e.page_size,
                                 self.device)
        seq_lens = torch.zeros((e.max_batch,), dtype=torch.int32,
                               device=self.device)
        return cache, self._page_table(), seq_lens

    def _page_table(self) -> torch.Tensor:
        """new_state's page table: the static layout, or all-sink."""
        e = self.ecfg
        pps = e.pages_per_seq
        if e.dynamic_pages:
            return torch.zeros((e.max_batch, pps), dtype=torch.int32,
                               device=self.device)
        return (1 + torch.arange(e.max_batch)[:, None] * pps
                + torch.arange(pps)[None, :]).to(torch.int32).to(self.device)

    def reset_state(self, state):
        """Empty `state` in place for a new batch: seq_lens 0 and the page
        table as new_state lays it out. The pool keeps its stale K/V,
        which nothing reads (seq_lens masks every read), and the state
        its addresses, so the graphs captured on it stay valid. Returns
        the state."""
        _, pt, seq_lens = state
        seq_lens.zero_()
        pt.copy_(self._page_table())
        return state

    # -- forward pieces ----------------------------------------------------

    def _layers(self, x, cos, sin, cache, pt, append_pos, attend, qcfg):
        """The decoder layers, then the final norm."""
        x = self._layer_stack(x, cos, sin, cache, pt, append_pos, attend,
                              qcfg)
        return llama.rms_norm(x, self.qparams["final_norm"], self.cfg.rms_eps)

    def _layer_stack(self, x, cos, sin, cache, pt, append_pos, attend, qcfg):
        """The engine's layers on x [B, T, D], layer li appending into the
        pool's layer li and attending through attend(li, q, k, v)."""
        cfg, fused = self.cfg, self.fused_decode
        b, t, _ = x.shape
        for li, p in enumerate(self.qparams["layers"]):
            lc = self.calib[li]
            q, k, v = _attn_common(cfg, p, x.reshape(b * t, -1), lc, qcfg,
                                   b, t, norm_w=p["attn_norm"], fused=fused)
            q, k_r = llama.apply_rope(q, k, cos, sin)
            paged.append_kv(cache, li, k_r, v, pt, append_pos)
            attn = attend(li, q, k_r, v)
            x = x + _o_proj(cfg, p, attn, lc, qcfg, b, t, fused=fused)
            x = x + _mlp(cfg, p, x, lc, qcfg, norm_w=p["mlp_norm"],
                         fused=fused)
        return x

    def _prefill_forward(self, cache, pt, tokens, lens):
        """One-shot prefill of tokens [B, T] (right-padded), flash
        attention over the chunk. Returns last-token logits [B, V]."""
        b, t = tokens.shape
        positions = torch.arange(t, device=self.device)[None].expand(b, t)
        cos, sin = llama.rope_cos_sin(self.cfg, positions, self.inv_freq)
        append_pos = torch.where(positions < lens[:, None], positions,
                                 torch.full_like(positions, -1))
        x = self.qparams["embed"][tokens]
        x = self._layers(
            x, cos, sin, cache, pt, append_pos,
            lambda li, q, k, v: attention.flash_attention(q, k, v),
            self.qcfg_prefill)
        last = (lens.long() - 1).clamp(min=0)
        return self._head_logits(x[torch.arange(b, device=self.device),
                                   last])

    def _prefill_chunk_forward(self, cache, pt, tokens, lens, start,
                               all_logits: bool = False, qcfg=None):
        """One prefill chunk with per-row origin `start` ([B] i32): appends
        the chunk's K/V into the pool and attends straight over the int4
        pool (prefix + this chunk) with the paged flash-prefill kernel.
        All K/V, this chunk's included, round-trip through the int4 pool,
        exactly what decode later reads. Returns the logits of each row's
        last valid token in this chunk (clamped into the chunk; the caller
        keeps only rows whose last token is here), or with all_logits
        those of every position, [B, T, V]. qcfg defaults to the prefill
        phase's (qcfg_prefill)."""
        b, t = tokens.shape
        positions = start.long()[:, None] + torch.arange(
            t, device=self.device)[None]
        cos, sin = llama.rope_cos_sin(self.cfg, positions, self.inv_freq)
        append_pos = torch.where(positions < lens[:, None], positions,
                                 torch.full_like(positions, -1))
        # tokens in cache per row after this chunk
        kv_lens = torch.minimum(lens, start + t)
        x = self.qparams["embed"][tokens]
        x = self._layers(
            x, cos, sin, cache, pt, append_pos,
            lambda li, q, k, v: pdk.paged_prefill(q, cache, li, pt, start,
                                                  kv_lens),
            self.qcfg_prefill if qcfg is None else qcfg)
        if all_logits:
            return self._head_logits(x.reshape(b * t, -1)).reshape(b, t, -1)
        local_last = (lens.long() - 1 - start.long()).clamp(0, t - 1)
        return self._head_logits(x[torch.arange(b, device=self.device),
                                   local_last])

    # -- public steps ------------------------------------------------------

    @torch.no_grad()
    def prefill(self, state, tokens, lens, starts=None):
        """Prefill the batch. tokens [B, T] right-padded; lens [B] (0 =
        inactive slot). Returns (last-token logits [B, V] f32, state).

        Prompts longer than EngineConfig.prefill_chunk (when set) stream
        through _prefill_chunk_forward chunk by chunk. starts (optional
        [B] i32): per-row absolute origin of tokens[:, 0], for prefix
        sharing: only each row's suffix is prefilled; the shared prefix
        pages must already be mapped and lens stay absolute."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        lens = torch.as_tensor(lens, device=self.device).to(torch.int32)
        if tokens.shape[1] > self.ecfg.max_seq_len:
            raise ValueError(f"prefill length {tokens.shape[1]} exceeds KV "
                             f"capacity max_seq_len={self.ecfg.max_seq_len}")
        cache, pt, seq_lens = state
        if starts is not None:
            starts = torch.as_tensor(starts, device=self.device).to(
                torch.int32)
            logits = self._prefill_suffix(cache, pt, tokens, lens, starts)
        elif self.ecfg.prefill_chunk and (
                tokens.shape[1] > self.ecfg.prefill_chunk):
            logits = self._prefill_chunked(cache, pt, tokens, lens,
                                           self.ecfg.prefill_chunk)
        else:
            logits = self._prefill_forward(cache, pt, tokens, lens)
        # joining slots (lens > 0) restart their sequence; others keep
        # their running length
        seq_lens.copy_(torch.where(lens > 0, lens, seq_lens))
        return logits, (cache, pt, seq_lens)

    def _prefill_chunked(self, cache, pt, tokens, lens, c: int):
        """Host loop over chunks of c tokens from position 0."""
        b, t = tokens.shape
        zeros = torch.zeros((b,), dtype=torch.int32, device=self.device)
        return self._chunks(cache, pt, tokens, lens, zeros, c)

    def _prefill_suffix(self, cache, pt, tokens, lens, starts):
        """Per-row-origin (ragged) prefill: row b's tokens[b, i] sits at
        absolute position starts[b] + i. Chunks are origin-relative. A
        suffix shorter than the chunk runs as one chunk of its own length
        (the JAX engine pads it to the chunk; rows are independent, so
        only the padding's work differs)."""
        c = min(self.ecfg.prefill_chunk or tokens.shape[1], tokens.shape[1])
        return self._chunks(cache, pt, tokens, lens, starts, c)

    def _chunks(self, cache, pt, tokens, lens, starts, c: int):
        b, t = tokens.shape
        t_pad = -(-t // c) * c
        if t_pad != t:
            tokens = torch.nn.functional.pad(tokens, (0, t_pad - t))
        logits = None
        for off in range(0, t_pad, c):
            origin = starts + off
            lg = self._prefill_chunk_forward(cache, pt, tokens[:, off:off + c],
                                             lens, origin)
            # keep each row's logits from the chunk holding its last token
            here = (lens - 1 >= origin) & (lens - 1 < origin + c)
            logits = lg if logits is None else torch.where(here[:, None],
                                                           lg, logits)
        return logits

    def _decode_forward(self, cache, pt, seq_lens, tokens, active):
        """The decode forward of tokens [B] (device) for the active [B]
        slots: returns logits [B, V] f32 and advances seq_lens in place.
        Reads nothing back to the host."""
        positions = seq_lens.long()[:, None]                   # [B, 1]
        cos, sin = llama.rope_cos_sin(self.cfg, positions, self.inv_freq)
        append_pos = torch.where(active[:, None], positions,
                                 torch.full_like(positions, -1))
        new_lens = seq_lens + active.to(torch.int32)
        x = self.qparams["embed"][tokens.long()[:, None]]
        x = self._layers(
            x, cos, sin, cache, pt, append_pos,
            lambda li, q, k, v: pdk.paged_decode(
                q[:, 0], cache, li, pt, new_lens)[:, None],
            self.qcfg)
        logits = self._head_logits(x[:, 0])
        seq_lens.copy_(new_lens)
        return logits

    def _decode_body(self, state, io: _DecodeIO, gen, sampling) -> None:
        """One decode step on the persistent buffers, in place: the
        forward of io.tokens for io.active, then the eager loop's next
        token (argmax, or a draw from gen under sampling; inactive slots
        keep theirs), io.active cleared where it is io.eos, the next
        tokens into io.tokens and into io.out at column io.step, which
        advances (modulo SCAN_CHUNK). The logits stay in io.logits."""
        cache, pt, seq_lens = state
        io.logits = self._decode_forward(cache, pt, seq_lens, io.tokens,
                                         io.active)
        nxt = torch.where(io.active, self._sample(io.logits, sampling, gen),
                          io.tokens)
        io.active &= nxt != io.eos
        io.tokens.copy_(nxt)
        io.out.index_copy_(1, io.step, nxt[:, None])
        io.step.add_(1).remainder_(SCAN_CHUNK)

    def _verify_forward(self, cache, pt, seq_lens, tokens, valid):
        """The verify forward of tokens [B, W] (device), valid[b] of them
        appended at positions seq_lens[b].. : the chunk forward from
        origin seq_lens at the decode qcfg (a hybrid A16 prefill's qcfg
        would give tokens other than decode's), logits [B, W, V] f32 of
        every position. A row with valid 0 appends nothing (its K/V go to
        the sink page). seq_lens is not changed; reads nothing back to
        the host."""
        return self._prefill_chunk_forward(
            cache, pt, tokens.long(), seq_lens + valid, seq_lens,
            all_logits=True, qcfg=self.qcfg)

    def _verify_body(self, state, io: _VerifyIO, gen=None) -> None:
        cache, pt, seq_lens = state
        io.logits = self._verify_forward(cache, pt, seq_lens, io.tokens,
                                         io.valid)

    def _verify_graph(self, state, w: int) -> _Graph:
        """The verify body of (state, route, W)."""
        b = state[2].shape[0]
        return self._graph(state, ("verify", w), "verify step",
                           lambda: _VerifyIO.new(b, w, self.device),
                           InferenceEngine._verify_body)

    def drop_graphs(self) -> None:
        """Forget every captured step: the next one captures anew (needed
        after patching a function a step calls)."""
        self._graphs.clear()

    def _graph(self, state, key, what: str, new_io, body,
               sampled: bool = False) -> _Graph:
        """The step of (state, route, key): `body(engine, state, io, gen)`
        (a function, not a bound method: _Graph's docstring says why)
        over the buffers `new_io()` makes and, when sampled, a generator
        of its own; captured on `state` on first use (the least recently
        used one dropped beyond GRAPH_CACHE). The state enters the key by
        its tensors' addresses: a graph captured on them is right for any
        state at the same addresses."""
        full = (_state_key(state), self.fused_decode, key)
        g = self._graphs.pop(full, None)
        if g is None:
            while len(self._graphs) >= GRAPH_CACHE:
                self._graphs.popitem(last=False)
            g = self._capture(what, state, _Graph(
                new_io(), body, weakref.ref(self),
                torch.Generator(device=self.device) if sampled else None))
        self._graphs[full] = g
        return g

    def _capture(self, what: str, state, g: _Graph) -> _Graph:
        """A body over its new buffers and, on the card, its graph.

        The body must change nothing but the sink page on new buffers
        (every slot inactive, no token valid). A warm-up run of it goes
        first on the capture stream: it builds the kernels and runs every
        lazy initialisation (the kernels' shared-memory attributes,
        cuBLAS's workspace, constant tables) outside the capture. The
        capture is in the default global mode; the generator of a sampled
        body is registered with the graph, so each replay draws the next
        numbers. The body takes the state, so a cached graph holds no
        state alive."""
        if self.device.type != "cuda":
            return g
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            g.run(state)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        if g.gen is not None:
            graph.register_generator_state(g.gen)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        launches = _build.GraphLaunches()
        current = torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        try:
            with launches, torch.cuda.graph(graph, stream=stream):
                g.run(state)
        except Exception as e:
            torch.cuda.set_stream(current)    # a failed capture keeps it
            raise RuntimeError(
                f"capturing the {what} as a CUDA graph failed at "
                f"{_failed_at(e)}: {e}") from e
        rec = dict(what=what, capture_ms=(time.perf_counter() - t0) * 1e3,
                   pool_bytes=torch.cuda.memory_reserved(self.device)
                   - reserved, launches=launches.total)
        self.graph_captures.append(rec)
        print(f"{what} captured as a CUDA graph in "
              f"{rec['capture_ms']:.1f} ms: {rec['launches']} kernel "
              f"launches, graph pool {rec['pool_bytes'] / 2 ** 20:.1f} MiB",
              file=sys.stderr)
        g.graph, g.launches = graph, launches
        return g

    def _decode_graph(self, state, sampling) -> _Graph:
        """The decode body of (state, route, sampling)."""
        b = state[2].shape[0]
        return self._graph(
            state, sampling, "decode step",
            lambda: _DecodeIO.new(b, self.device),
            functools.partial(InferenceEngine._decode_body,
                              sampling=sampling),
            sampled=sampling is not None)

    @torch.no_grad()
    def decode_step(self, state, tokens, active):
        """One decode step for every active slot. tokens [B] i32, active
        [B] bool. Returns (logits [B, V] f32, state); on the card a copy
        of the graph's logits, which its next replay overwrites."""
        if not self.cuda_graphs:
            cache, pt, seq_lens = state
            tokens = torch.as_tensor(tokens, device=self.device)
            active = torch.as_tensor(active, device=self.device).bool()
            return (self._decode_forward(cache, pt, seq_lens, tokens,
                                         active), state)
        g = self._decode_graph(state, None)
        g.io.tokens.copy_(torch.as_tensor(tokens))
        g.io.active.copy_(torch.as_tensor(active))
        g.replay(state)
        logits = g.io.logits
        return (logits if g.graph is None else logits.clone()), state

    @torch.no_grad()
    def verify_step(self, state, tokens, valid):
        """Speculative decoding's verify, a multi-token decode step.

        tokens [B, W]: per row the last committed token, then W - 1
        drafts (right-padded); valid [B] in 0..W, how many are real (0:
        the row appends nothing). Appends their K/V at absolute positions
        seq_lens..seq_lens + valid - 1, attends over the int4 pool with
        the paged prefill kernel and returns (logits [B, W, V] f32 of
        every position, state) at the decode qcfg; on the card a copy of
        the graph's logits.

        seq_lens is unchanged: the caller commits the accepted length.
        Stale K/V past the committed length is overwritten by later
        appends and never attended (seq_lens masks every read), so a
        rejected draft needs no rollback."""
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int32)
        valid = torch.as_tensor(valid, device=self.device).to(torch.int32)
        if not self.cuda_graphs:
            cache, pt, seq_lens = state
            return self._verify_forward(cache, pt, seq_lens, tokens,
                                        valid), state
        g = self._verify_graph(state, tokens.shape[1])
        g.io.tokens.copy_(tokens)
        g.io.valid.copy_(valid)
        g.replay(state)
        logits = g.io.logits
        return (logits if g.graph is None else logits.clone()), state

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    @staticmethod
    def _sample(logits, sampling, gen) -> torch.Tensor:
        """argmax, or a draw from `gen` under `sampling`: [B] i32."""
        if sampling is None or sampling.is_greedy:
            return logits.argmax(-1).to(torch.int32)
        return smp.sample_p(logits, gen, sampling)

    @torch.no_grad()
    def decode_scan(self, state, first_tokens, active, num_steps: int,
                    eos_id: Optional[int] = None, sampling=None,
                    seed: int = 0):
        """num_steps decode steps, greedy or sampled under `sampling` (an
        engine.sampling.SamplingParams) with a generator seeded by
        `seed`. Slots that emit eos_id go inactive. Returns (tokens
        [B, num_steps] i32 on the device, the token of each step,
        repeating the last one after a slot retires; state).

        By default the decode body (sampling and the eos update inside)
        replays num_steps times with no host read in between, and the
        tokens are copied out on the device every SCAN_CHUNK steps (0
        steps only captures the state's graph); cuda_graphs=False runs
        the eager loop over decode_step."""
        if not self.cuda_graphs:
            toks = torch.as_tensor(first_tokens, device=self.device).to(
                torch.int32)
            act = torch.as_tensor(active, device=self.device).bool()
            gen = self._generator(seed)
            out = []
            for _ in range(num_steps):
                logits, state = self.decode_step(state, toks, act)
                nxt = torch.where(act, self._sample(logits, sampling, gen),
                                  toks)
                if eos_id is not None:
                    act = act & (nxt != eos_id)
                toks = nxt
                out.append(nxt)
            if not out:
                return toks[:, None][:, :0], state
            return torch.stack(out, dim=1), state
        if sampling is not None and sampling.is_greedy:
            sampling = None
        g = self._decode_graph(state, sampling)
        io = g.io
        io.tokens.copy_(torch.as_tensor(first_tokens))
        io.active.copy_(torch.as_tensor(active))
        io.eos.fill_(-1 if eos_id is None else eos_id)
        io.step.zero_()
        if g.gen is not None:
            g.gen.manual_seed(seed)
        parts = []
        for i in range(num_steps):
            g.replay(state)
            if (i + 1) % SCAN_CHUNK == 0 or i + 1 == num_steps:
                parts.append(io.out[:, :i % SCAN_CHUNK + 1].clone())
        if not parts:
            return io.out[:, :0].clone(), state
        return torch.cat(parts, dim=1), state

    # -- convenience -------------------------------------------------------

    def _pad_prompts(self, prompts):
        """Right-pad a prompt batch to [max_batch, T]: (tokens, lens, b)."""
        if isinstance(prompts, (list, tuple)):
            b = len(prompts)
            lens_b = [len(p) for p in prompts]
            toks = np.zeros((b, max(max(lens_b), 1)), np.int64)
            for i, p in enumerate(prompts):
                toks[i, :len(p)] = np.asarray(p, np.int64)
        else:
            toks = np.asarray(prompts, np.int64)
            b = toks.shape[0]
            lens_b = [toks.shape[1]] * b
        e = self.ecfg
        if b > e.max_batch:
            raise ValueError(f"{b} prompts > max_batch={e.max_batch}")
        toks = np.pad(toks, ((0, e.max_batch - b), (0, 0)))
        lens = np.zeros((e.max_batch,), np.int32)
        lens[:b] = lens_b
        return toks, lens, b

    def _alloc_prompt_pages(self, state, lens, b: int,
                            max_new_tokens: int, margin: int = 0):
        """Dynamic-page mode: map each row's worst-case page span up front
        (prompt + generation + `margin` tokens of headroom: a speculative
        verify writes up to window - 1 uncommitted tokens past the
        committed length), rows in order on consecutive pages after the
        sink, numbered in the pool of the row's page group
        (page_groups()). No-op under the static layout."""
        e = self.ecfg
        if not e.dynamic_pages:
            return state
        cache, pt, sl = state
        _, pages_per_group, spg = self.page_groups()
        pt_np = np.zeros((e.max_batch, e.pages_per_seq), np.int32)
        for i in range(b):
            if i % spg == 0:
                nxt = 1
            total = int(lens[i]) + max_new_tokens + margin
            need = -(-total // e.page_size)
            if need > e.pages_per_seq:
                raise ValueError(
                    f"prompt {i}: {int(lens[i])} + {max_new_tokens} new "
                    f"+ margin {margin} tokens exceed pages_per_seq="
                    f"{e.pages_per_seq} * page_size={e.page_size}")
            if nxt + need > pages_per_group:
                raise ValueError(
                    f"page pool exhausted at row {i}: {pages_per_group - 1}"
                    " usable pages; raise num_pages or use "
                    "ContinuousBatcher")
            pt_np[i, :need] = np.arange(nxt, nxt + need)
            nxt += need
        pt.copy_(torch.from_numpy(pt_np))
        return cache, pt, sl

    def generate(self, prompts, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 sampling=None, seed: int = 0) -> List[List[int]]:
        """Decode a batch of prompts (list of 1D int sequences or a
        [B, T] array). Greedy by default; `sampling` (a SamplingParams)
        samples on the device from a generator seeded by `seed`. Returns
        the generated token lists."""
        toks, lens, b = self._pad_prompts(prompts)
        e = self.ecfg
        if int(lens.max()) + max_new_tokens > e.max_seq_len:
            raise ValueError(f"prompt + {max_new_tokens} new tokens exceed "
                             f"max_seq_len={e.max_seq_len}")
        state = self._alloc_prompt_pages(self.new_state(), lens, b,
                                         max_new_tokens)
        logits, state = self.prefill(state, toks, lens)
        out = [[] for _ in range(b)]
        done = lens == 0
        gen = self._generator(seed)
        cur = self._sample(logits, sampling, gen)
        for _ in range(max_new_tokens):
            cur_np = cur.cpu().numpy()
            for i in range(b):
                if not done[i]:
                    tok = int(cur_np[i])
                    if eos_id is not None and tok == eos_id:
                        done[i] = True
                    else:
                        out[i].append(tok)
            if done.all():
                break
            active = torch.as_tensor(~done & (np.arange(e.max_batch) < b))
            logits, state = self.decode_step(state, cur, active)
            cur = self._sample(logits, sampling, gen)
        return out
