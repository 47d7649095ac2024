"""Device-memory accounting (counterpart of ``arcquant_tpu/utils/mem.py``).

The JAX package falls back to summing its live buffers where the
platform exposes no allocator statistics; the CUDA caching allocator
does expose them, so the peak here is ``torch.cuda.max_memory_allocated``
(the allocator's peak of tensor bytes since the last reset, as the
reference benchmark reports) and the live figure
``torch.cuda.memory_allocated``. Neither counts the allocator's cached
free blocks or the CUDA context.
"""

from __future__ import annotations

from typing import Optional

import torch


def live_device_bytes() -> int:
    """Bytes of the tensors alive on the current CUDA device (0 without
    one)."""
    return torch.cuda.memory_allocated() if torch.cuda.is_available() else 0


def reset_peak() -> None:
    """Start a new peak window (no-op without a CUDA device)."""
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def device_mem_gb() -> Optional[float]:
    """Peak device memory since the last reset_peak, in GiB; None without
    a CUDA device."""
    if not torch.cuda.is_available():
        return None
    peak = torch.cuda.max_memory_allocated()
    return peak / 2 ** 30 if peak else None
