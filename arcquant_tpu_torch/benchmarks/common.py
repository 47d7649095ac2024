"""What the benchmark scripts and chip_smoke.py share: the card's
identity, the CUDA-event timer (``utils/timing.py``'s Timer and Timing,
imported here), the bound of an operation, the GEMMs' sum-order
tolerance, and the component profiles' rows, their budget and a spy
that counts an engine's calls.

H100 SXM published dense peaks (NVIDIA data sheet): 989 TFLOP/s bf16 on
the tensor cores and 3.35 TB/s of HBM3. A bound is the larger of an
operation's FLOPs and its bytes (each input read once, each output
written once) over these; they assume a 700 W power limit, so every
timing is printed beside the card's name and limit.
"""

from __future__ import annotations

import collections
import contextlib
import subprocess
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch

from ..utils.timing import Timer, Timing  # noqa: F401  (re-exported)

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def require_cuda(what: str) -> None:
    """Raise unless torch sees a CUDA device: the scripts measure the
    card and never fall back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures the GPU, and torch sees no "
                           "CUDA device")


def card() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (the first card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def bound_ms(flops: float, nbytes: float):
    """(the least time in ms on an H100 SXM, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def sum_order_bound(y: torch.Tensor, ref: torch.Tensor, f32: bool) -> bool:
    """f32 summation order: a few f32 ulps of the row's magnitude, plus
    one bf16 ulp of the value for bf16 outputs."""
    y, ref = y.double(), ref.double()
    scale = ref.abs().amax(dim=-1, keepdim=True)
    tol = (1e-5 * scale + 1e-6 * ref.abs() if f32
           else 1e-4 * scale + 2.0 ** -7 * ref.abs())
    return bool(((y - ref).abs() <= tol).all())


# -- component profiles (decode_profile.py, prefill_profile.py) ---------------

class Row(NamedTuple):
    """One component of a step: its name, a callable that runs it once,
    how many times each way of running the step calls it (`mults`, e.g.
    {"chain": 28, "fused": 0}), and the call it attributes, as
    engine_calls() keys it (None for an alternative no way runs)."""
    name: str
    fn: Callable[[], object]
    mults: Dict[str, int]
    key: Optional[str]


NOISY = 0.5   # a row whose hi - lo exceeds this share of its median


def budget(rows: Sequence[Row], times: Dict[str, Timing], ways: Sequence[str],
           unit: str = "us"):
    """Print each row's median [lo-hi] (ms x 1e3 for "us") and its
    multiplicity in each way, marked noisy where hi - lo exceeds NOISY
    of its median. Returns each way's total, {way: (median, lo, hi)} in
    ms: the sums of median x mult, lo x mult and hi x mult over every
    row (none is dropped)."""
    f = 1e3 if unit == "us" else 1.0
    heads = "  ".join(f"{w:>7s}" for w in ways)
    print(f"{'component':44s} {'median ' + unit:>12s} {'[lo-hi]':>20s}  "
          f"{heads}")
    totals = {w: [0.0, 0.0, 0.0] for w in ways}
    for r in rows:
        t = times[r.name]
        noisy = t.hi - t.lo > NOISY * t.median
        mults = "  ".join(f"x{r.mults.get(w, 0):6d}" for w in ways)
        span = f"[{t.lo * f:.3f}-{t.hi * f:.3f}]"
        print(f"{r.name:44s} {t.median * f:12.3f} {span:>20s}  {mults}"
              f"{'  noisy' if noisy else ''}", flush=True)
        for w in ways:
            k = r.mults.get(w, 0)
            for i, v in enumerate((t.median, t.lo, t.hi)):
                totals[w][i] += v * k
    return {w: tuple(totals[w]) for w in ways}


def _sites(eng) -> dict:
    """id of each linear's weight tensor in eng.qparams -> its site:
    qkv, o, gateup, down, lm_head."""
    out = {}
    for p in eng.qparams["layers"]:
        for site in ("qkv", "o", "gateup", "down"):
            w = p.get(site)
            if w is not None:
                out[id(w.codes if hasattr(w, "codes") else w["w"])] = site
    head = eng.qparams.get("lm_head_packed")
    if head is not None:
        out[id(head.codes)] = "lm_head"
    return out


# The prefix of the profiler ranges that engine_calls(..., ranges=True)
# opens: benchmarks/trace_summary.py attributes device time by them.
RANGE = "row:"
# The ARC residual (kernels/quantize.py arc_residual, #18; on the CPU its
# plain version, whose column take and silu_mul recompute nest inside it)
# is counted where it is outermost and opens a range at any depth: its
# share of the rows that call it is read from the nested ranges.
ARC_RESIDUAL = "arc_residual"


def _targets(level: str, site) -> list:
    """(owner, attribute, key) of each function engine_calls counts at
    `level`: "ops", the component profiles' functions (the kernels'
    wrappers and the torch ops between them), or "layers", verify_lab's
    components of a layer (its attention input, o projection and MLP,
    rope with the KV append, the attention) and the head. A key is a name,
    a function of the call's arguments, or None for the attribute's
    name; site(weight) names a linear's site."""
    from ..engine import engine as E
    from ..kernels import attention, gemm as gk, mlp_fused as mf
    from ..kernels import paged_decode as pdk, quantize as qk
    from ..kernels import rope_kv as rk
    from ..models import llama

    common = [(llama, "rms_norm", None), (rk, "rope_append_kv", None),
              (pdk, "paged_decode", None),
              (pdk, "paged_prefill", None),
              (attention, "flash_attention", None),
              (E.InferenceEngine, "_sample", "sample")]
    if level == "layers":
        return [(E, "_attn_common", "attn_common"), (E, "_o_proj", "o_proj"),
                (E, "_mlp", "mlp"),
                (E.InferenceEngine, "_head_logits", "head")] + common
    if level != "ops":
        raise ValueError(f"level {level!r}: 'ops' or 'layers'")
    return [
        (gk, "gemm_dequant", lambda a: f"gemm_dequant:{site(a[1])}"),
        (mf, "gemm_w8_actq_fused",
         lambda a: f"gemm_w8_actq_fused:{site(a[1])}"),
        (mf, "mlp_w8_fused", None), (mf, "gateup_silu_quantize", None),
        (llama, "linear", lambda a: f"linear:{site(a[0])}"),
        (qk, "quantize_x_arc", lambda a: f"quantize_x_arc:{a[0].shape[1]}"),
        (qk, "rmsnorm_quantize_x", None), (qk, "silu_mul_quantize_gu", None),
        (qk, "_silu_mul", "silu_mul"),
        (qk, "arc_residual", ARC_RESIDUAL)] + common


@contextlib.contextmanager
def engine_calls(eng, level: str = "ops", ranges: bool = False):
    """Count the calls that eng's forward makes to each function a
    profile row attributes, while the block runs. Yields a Counter keyed
    as the rows' keys. At level "ops": gemm_dequant:<site>,
    gemm_w8_actq_fused:<site>, linear:<site> (site qkv, o, gateup, down
    or lm_head, by the weight's identity in eng.qparams),
    quantize_x_arc:<K>, mlp_w8_fused, gateup_silu_quantize,
    rmsnorm_quantize_x, silu_mul_quantize_gu, silu_mul, arc_residual,
    rms_norm, rope_append_kv, paged_decode, paged_prefill,
    flash_attention and sample; at level "layers" (_targets) attn_common,
    o_proj, mlp, head and the same rms_norm ... sample. Only the
    outermost of nested counted calls counts: a fused wrapper's plain
    version on the CPU calls others.

    With `ranges`, each counted call also runs inside a
    ``torch.profiler.record_function`` range named RANGE + its key, and
    the ARC residual inside one at any depth (its nested share); a
    profiler then sees which row launched each kernel. Never enter it
    around a graph capture: the ranges are host-side only, and a graph
    keeps what it captured."""
    sites = _sites(eng)

    def site(w):
        return sites.get(id(w.codes if hasattr(w, "codes") else w["w"]), "?")

    counts = collections.Counter()
    depth = [0]
    saved = []
    for owner, name, key in _targets(level, site):
        raw = owner.__dict__[name]
        real = raw.__func__ if isinstance(raw, staticmethod) else raw

        def spy(*a, real=real, name=name, key=key, **kw):
            k = None
            if depth[0] == 0 or (ranges and key == ARC_RESIDUAL):
                k = key(a) if callable(key) else key or name
            if depth[0] == 0:
                counts[k] += 1
            depth[0] += 1
            try:
                if k is None or not ranges:
                    return real(*a, **kw)
                with torch.profiler.record_function(RANGE + k):
                    return real(*a, **kw)
            finally:
                depth[0] -= 1
        saved.append((owner, name, raw))
        setattr(owner, name,
                staticmethod(spy) if isinstance(raw, staticmethod) else spy)
    try:
        yield counts
    finally:
        for owner, name, raw in reversed(saved):
            setattr(owner, name, raw)


def pin(rows: Sequence[Row], way: str, counts) -> list:
    """The rows whose multiplicity in `way` differs from the calls
    counted (engine_calls), as (name, mult, calls), then each counted
    call that no row attributes, as (key, 0, calls); an alternative (key
    None) must have multiplicity 0. Empty when the plan is pinned."""
    bad = []
    for r in rows:
        m = r.mults.get(way, 0)
        got = counts.get(r.key, 0) if r.key else 0
        if m != got:
            bad.append((r.name, m, got))
    keys = {r.key for r in rows}
    bad += [(k, 0, n) for k, n in sorted(counts.items()) if k not in keys]
    return bad
