"""Packed quantized-checkpoint persistence (counterpart of
``arcquant_tpu/utils/checkpoint.py``, whose orbax directory becomes one
safetensors file written and read by ``utils/safetensors_io.py``).

The reference re-quantizes the weights from the HF checkpoint at every
launch; a saved packed tree (codes, scales, global scales, biases)
restores without the original weights. The tree (dicts, lists,
PackedWeight / PackedWeightI8, tensors) is flattened to dotted names
("layers.3.gateup.codes"); its shape, with the packed weights' format
tags (the JAX package's 4 and 8) and any non-tensor leaves, is the JSON
of the header's "arcquant.tree" metadata entry.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import torch

from ..engine.engine import resolve_device
from ..quant.packing import PackedWeight, PackedWeightI8
from .safetensors_io import read_safetensors, write_safetensors

_TREE_KEY = "arcquant.tree"
_TAG_W4, _TAG_W8 = 4, 8


def _flatten(tree, name: str, tensors: Dict[str, torch.Tensor]):
    """The JSON skeleton of `tree`, its tensors added to `tensors` under
    dotted names."""
    if isinstance(tree, torch.Tensor):
        tensors[name] = tree
        return name
    if isinstance(tree, (PackedWeight, PackedWeightI8)):
        out = {"__packed__": _TAG_W8 if isinstance(tree, PackedWeightI8)
               else _TAG_W4}
        for k, v in tree._asdict().items():
            out[k] = _flatten(v, f"{name}.{k}", tensors)
        return out
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{name}.{k}" if name else k, tensors)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, f"{name}.{i}", tensors)
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    if isinstance(tree, (bool, int, float, str)):
        return {"__value__": tree}
    raise TypeError(f"{name}: cannot save a {type(tree).__name__}")


def _unflatten(skel, tensors: Dict[str, torch.Tensor]):
    if isinstance(skel, str):
        return tensors[skel]
    if isinstance(skel, list):
        return [_unflatten(v, tensors) for v in skel]
    if isinstance(skel, dict):
        if "__value__" in skel:
            return skel["__value__"]
        tag = skel.get("__packed__")
        if tag is not None:
            cls = PackedWeightI8 if tag == _TAG_W8 else PackedWeight
            return cls(**{k: _unflatten(skel[k], tensors)
                          for k in cls._fields})
        return {k: _unflatten(v, tensors) for k, v in skel.items()}
    return skel


def save_quantized(path: str, qparams: Dict[str, Any]) -> None:
    """Write a quantized parameter tree (packed weights included, from
    any device) to the safetensors file `path`."""
    tensors: Dict[str, torch.Tensor] = {}
    skel = _flatten(qparams, "", tensors)
    write_safetensors(path, tensors, {_TREE_KEY: json.dumps(skel)})


def load_quantized(path: str, device="cuda") -> Dict[str, Any]:
    """The tree save_quantized wrote to `path`, its tensors on `device`
    (the card unless "cpu"): the same tensor bytes, dtypes and
    PackedWeight / PackedWeightI8 types."""
    tensors, meta = read_safetensors(path, resolve_device(device))
    if _TREE_KEY not in meta:
        raise ValueError(f"{path}: no {_TREE_KEY!r} metadata; not written "
                         "by save_quantized")
    return _unflatten(json.loads(meta[_TREE_KEY]), tensors)
