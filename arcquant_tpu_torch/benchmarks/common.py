"""What the benchmark scripts and chip_smoke.py share: the card's
identity, a CUDA-event timer (the port's counterpart of the JAX package's
timing helpers; CUDA events replace its two-length scan), the bound of
an operation and the GEMMs' sum-order tolerance.

H100 SXM published dense peaks (NVIDIA data sheet): 989 TFLOP/s bf16 on
the tensor cores and 3.35 TB/s of HBM3. A bound is the larger of an
operation's FLOPs and its bytes (each input read once, each output
written once) over these; they assume a 700 W power limit, so every
timing is printed beside the card's name and limit.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, NamedTuple

import torch

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


class Timing(NamedTuple):
    """ms: the median of the runs, their min and max, and the median
    host time of a call (until it returns, its launches enqueued)."""
    median: float
    lo: float
    hi: float
    host: float = 0.0

    def __str__(self) -> str:
        return f"{self.median:.4f} ms [{self.lo:.4f}-{self.hi:.4f}]"


class Timer:
    """CUDA-event device time of a callable: two warm-up calls, then `reps`
    runs, each after a 256 MB write that flushes the 50 MB L2, so that
    weights come from HBM as in a real step.

    With `ahead` (the default) the stream is then held busy
    (``torch.cuda._sleep``) for twice the call's host time, taken at the
    second warm-up, before the start event is recorded: the host enqueues
    the call while the card waits, so the events bracket its device work
    alone. Without it, a kernel of a few tens of microseconds behind a
    wrapper whose Python outlasts the flush is timed with the card idle
    while the host is still in the wrapper."""

    CYCLES_PER_MS = 1.98e6   # the H100 SXM's top SM clock; lower clocks hold longer

    def __init__(self, reps: int = 7, ahead: bool = True):
        if reps < 5:
            raise ValueError("at least 5 timed runs")
        self.reps, self.ahead = reps, ahead
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn: Callable[[], object]) -> Timing:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        hold_ms = min(50.0, 2e3 * (time.perf_counter() - t0) + 0.05)
        torch.cuda.synchronize()
        times, host = [], []
        for _ in range(self.reps):
            self.flush.zero_()
            if self.ahead:
                torch.cuda._sleep(int(hold_ms * self.CYCLES_PER_MS))
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return Timing(statistics.median(times), min(times), max(times),
                      statistics.median(host))
