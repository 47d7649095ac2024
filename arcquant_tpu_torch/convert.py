"""Carry parameters across from the JAX package.

Takes the JAX package's parameter trees after ``jax.tree.map(np.asarray,
tree)``, i.e. numpy arrays, by duck typing (no jax import): bf16 arrays
(numpy dtype name "bfloat16") are passed as uint16 views.

  params_from_numpy  raw bf16 params: embed, final_norm, lm_head and the
                     per-layer dicts of linears {"w", "b"?} and norms
  packed_from_numpy  one packed weight, w8 or w4 (a layer's linear or the
                     head)
  qparams_from_numpy a packed engine tree (the JAX engine's ``qparams``)
  calib_from_numpy   per-layer dicts of SiteCalib
"""

from __future__ import annotations

import numpy as np
import torch

from .models.quantized import SiteCalib
from .quant.packing import PackedWeight, PackedWeightI8


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy array -> torch tensor; bf16 goes through a uint16 view."""
    a = np.array(a)           # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(x, device):
    if x is None or isinstance(x, (int, float, str)):
        return x
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device) for v in x]
    return tensor_from_numpy(x, device)


def params_from_numpy(params, device="cpu"):
    """Raw (unquantized) parameter tree -> the same tree of tensors."""
    return _tree(params, device)


def packed_from_numpy(pw, device="cpu"):
    """A JAX PackedWeightI8 (int8 codes) or PackedWeight (uint8 codes),
    numpy leaves -> the port's PackedWeightI8 or PackedWeight."""
    codes = np.asarray(pw.codes)
    kinds = {np.dtype(np.int8): PackedWeightI8,
             np.dtype(np.uint8): PackedWeight}
    if codes.dtype not in kinds:
        raise ValueError(f"packed weight with {codes.dtype} codes")
    return kinds[codes.dtype](
        codes=tensor_from_numpy(codes, device),
        scales=tensor_from_numpy(np.asarray(pw.scales).view(np.uint8),
                                 device),
        global_scale=tensor_from_numpy(pw.global_scale, device).float(),
        bias=None if pw.bias is None else tensor_from_numpy(pw.bias, device))


def _packed_tree(x, device):
    """Packed weights (stacked ones too) to the port's, nested dicts of
    them and of arrays (an MoE layer's "moe": router {"w"}, gateup_pk,
    down_pk, sgate/sup/sdown, shared_gate {"w"}) alike."""
    if hasattr(x, "codes"):
        return packed_from_numpy(x, device)
    if isinstance(x, dict):
        return {k: _packed_tree(v, device) for k, v in x.items()}
    return tensor_from_numpy(x, device)


def qparams_from_numpy(qparams, device="cpu"):
    """A packed engine tree (embed, final_norm, layers of
    {attn_norm, mlp_norm, qkv, o, and gateup, down or an MoE layer's
    "moe"}, lm_head_packed?)."""
    out = {k: _packed_tree(v, device) for k, v in qparams.items()
           if k != "layers"}
    out["layers"] = [_packed_tree(layer, device)
                     for layer in qparams["layers"]]
    return out


def calib_from_numpy(calib, device="cpu"):
    """list of {site: SiteCalib(reorder_index, select_num)} -> torch."""
    return [{s: SiteCalib(tensor_from_numpy(c.reorder_index, device),
                          int(c.select_num))
             for s, c in layer.items()} for layer in calib]
