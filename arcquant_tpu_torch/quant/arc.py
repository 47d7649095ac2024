"""Augmented Residual Channels (ARC), the fake-quant reference ops
(counterpart of ``arcquant_tpu/quant/arc.py``).

ARC appends the quantized residual of the outlier activation channels
as extra K columns of the same GEMM and duplicates the matching weight
columns, given reorder_index (ascending channel importance, outliers
last) and select_num = KE (a multiple of 64):

  activations:  x_aug = [ qdq(x) , qdq(x - qdq(x))[:, top_KE] ]
  weights:      w_aug = [ qdq(w) , qdq(w)[:, top_KE] ]
  GEMM:         y = x_aug @ w_aug.T * (global_x * global_w)

The layout is the flat [all K groups][KE residual groups] one of the
JAX package; the global scales stay out of x_aug and w_aug and are
applied after the product.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import numerics as N


def top_channels(reorder_index: torch.Tensor,
                 select_num: int) -> torch.Tensor:
    """The `select_num` most important channels: the end of
    reorder_index (int64, for indexing)."""
    if select_num == 0:
        return torch.zeros((0,), dtype=torch.long,
                           device=reorder_index.device)
    return reorder_index[-select_num:].long()


def arc_quantize_x_qdq(x: torch.Tensor, reorder_index: torch.Tensor,
                       select_num: int, quant_type: str = "NVFP4",
                       per_row: bool = False, gs_reduce=None):
    """Fake-quantize an activation matrix x [M, K] with the ARC residual
    appended. Returns (x_aug f32 [M, K + KE] in scaled units, global
    scale: NVFP4's f32, per row [M, 1] or per tensor, else 1.0). The
    residual is taken from the already-rounded qdq(x). gs_reduce, when
    given, maps the global scale to the one that sharded callers agree
    on (a max across shards)."""
    if quant_type == "NVFP4":
        gs = N.nvfp4_global_scale(x, per_row=per_row)
        if gs_reduce is not None:
            gs = gs_reduce(gs)
    else:
        gs = torch.ones((), dtype=torch.float32, device=x.device)
    xs = x.float() / gs
    qx = N.group_qdq(xs, quant_type)
    if select_num == 0:
        return qx, gs
    idx = top_channels(reorder_index, select_num).to(x.device)
    qerr = N.group_qdq((xs - qx)[:, idx], quant_type)
    return torch.cat([qx, qerr], dim=1), gs


def arc_quantize_w_qdq(w: torch.Tensor, reorder_index: torch.Tensor,
                       select_num: int, quant_type: str = "NVFP4",
                       per_channel: bool = False):
    """Fake-quantize a weight matrix w [N, K] with the outlier columns
    duplicated. Returns (w_aug [N, K + KE] in w's dtype, scaled units,
    global scale: NVFP4's f32, per output channel [N] or per tensor,
    else 1.0)."""
    if quant_type == "NVFP4":
        gs = (N.nvfp4_global_scale(w, per_row=True)[:, 0] if per_channel
              else N.nvfp4_global_scale(w))
    else:
        gs = torch.ones((), dtype=torch.float32, device=w.device)
    ws = w.float() / (gs[:, None] if gs.dim() else gs)
    qw = N.group_qdq(ws, quant_type)
    if select_num == 0:
        return qw.to(w.dtype), gs
    idx = top_channels(reorder_index, select_num).to(w.device)
    qwk = N.group_qdq(ws[:, idx], quant_type)
    return torch.cat([qw, qwk], dim=1).to(w.dtype), gs


def arc_linear_fake(x: torch.Tensor, w: torch.Tensor,
                    reorder_index: torch.Tensor, select_num: int,
                    quant_type: str = "NVFP4",
                    bias: Optional[torch.Tensor] = None,
                    per_row: bool = False,
                    per_channel: bool = False) -> torch.Tensor:
    """The whole fake-quant ARC linear: x_aug @ w_aug.T (f32) * gx * gw
    (+ bias in f32), cast to x's dtype."""
    x2 = x.reshape(-1, x.shape[-1])
    xa, gx = arc_quantize_x_qdq(x2, reorder_index, select_num, quant_type,
                                per_row=per_row)
    wa, gw = arc_quantize_w_qdq(w, reorder_index, select_num, quant_type,
                                per_channel=per_channel)
    gw2 = gw.reshape(1, -1) if gw.dim() else gw
    y = (xa.float() @ wa.float().t()) * gx * gw2
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*x.shape[:-1], w.shape[0]).to(x.dtype)


def average_bits(k: int, select_num: int) -> float:
    """Effective bits an element of NVFP4 + ARC: 4.5 (K + KE) / K."""
    return 4.5 * (k + select_num) / k
