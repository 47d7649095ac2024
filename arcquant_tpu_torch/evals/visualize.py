"""Quantization-error analysis and plots (counterpart of
``arcquant_tpu/evals/visualize.py``): per-layer activation-quantization
MSE of NVFP4, Hadamard + NVFP4 and NVFP4 + ARC, per-channel error bars
and MSE-vs-k evolution curves.

Every function is plain torch on the input's device; none launches a
kernel. The plots import matplotlib when called (headless backend), so
importing this module needs none.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..quant import arc, numerics as N


def hadamard_transform(x: torch.Tensor, block_size: Optional[int] = None
                       ) -> torch.Tensor:
    """Power-of-2 butterfly Hadamard transform over the last dim, whole or
    blockwise, scaled by 1/sqrt(block) (so it is its own inverse). Sums in
    f32, the result in x's dtype."""
    k = x.shape[-1]
    bs = block_size or k
    if bs & (bs - 1):
        raise ValueError(f"block_size {bs} not a power of 2")
    h = x.reshape(-1, k // bs, bs).float()
    step = 1
    while step < bs:
        h = h.reshape(-1, k // bs, bs // (2 * step), 2, step)
        a, b = h[..., 0, :], h[..., 1, :]
        h = torch.stack([a + b, a - b], dim=-2)
        step *= 2
    h = h.reshape(x.shape).to(x.dtype)
    return h / torch.sqrt(torch.tensor(float(bs), dtype=torch.float32,
                                       device=x.device)).to(x.dtype)


def _mse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b) ** 2).mean())


def measure_mse(x: torch.Tensor, reorder_index: torch.Tensor,
                select_num: int) -> Dict[str, float]:
    """Activation-quantization MSE under three schemes:
      nvfp4     plain NVFP4 qdq;
      hadamard  rotate, NVFP4 qdq, rotate back (only when K is a power
                of 2);
      arc       NVFP4 + the ARC residual of the select_num top channels,
                folded back onto those channels."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    k = x2.shape[-1]
    out = {"nvfp4": _mse(N.quantize_tensor_qdq(x2, "NVFP4"), x2)}
    if 1 << (k.bit_length() - 1) == k:
        qh = N.quantize_tensor_qdq(hadamard_transform(x2), "NVFP4")
        out["hadamard"] = _mse(hadamard_transform(qh), x2)
    xa, gs = arc.arc_quantize_x_qdq(x2, reorder_index, select_num)
    if select_num:
        idx = arc.top_channels(reorder_index, select_num).to(x2.device)
        rec = xa[:, :k].index_add(1, idx, xa[:, k:])
    else:
        rec = xa
    out["arc"] = _mse(rec * gs, x2)
    return out


def mse_evolution(x: torch.Tensor, reorder_index: torch.Tensor,
                  ks: Sequence[int]) -> List[float]:
    """ARC MSE as a function of the number of compensated channels."""
    return [measure_mse(x, reorder_index, k)["arc"] for k in ks]


def plot_layer_mse(records: List[Dict[str, float]], path: str) -> None:
    """Line plot of per-layer MSE per scheme, written to `path`."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 4))
    for scheme in records[0]:
        ax.plot([r[scheme] for r in records], label=scheme, marker="o")
    ax.set_xlabel("layer")
    ax.set_ylabel("activation quantization MSE")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_channel_error(x: torch.Tensor, path: str) -> None:
    """Per-channel NVFP4 quantization-error bar plot, written to `path`."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    x2 = x.reshape(-1, x.shape[-1]).float()
    q = N.quantize_tensor_qdq(x2, "NVFP4")
    err = ((q - x2) ** 2).mean(dim=0).cpu().numpy()
    fig, ax = plt.subplots(figsize=(10, 3))
    ax.bar(range(err.shape[0]), err, width=1.0)
    ax.set_xlabel("input channel")
    ax.set_ylabel("MSE")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
