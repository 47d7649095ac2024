"""Calibration artifact persistence (counterpart of
``arcquant_tpu/calib/artifacts.py``): one .npz holds, per layer and
site, a reorder index (ascending channel importance, int32) and its ARC
select count, keyed "layer<i>/<site>", plus the metadata the calibration
run records. The format is the JAX package's: a file either package
writes loads in the other."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..models.quantized import SiteCalib


def save_calibration(path: str, calib: List[Dict[str, SiteCalib]],
                     meta: dict | None = None) -> None:
    """Write `calib` (per layer {site: SiteCalib}) and `meta` to `path`:
    "layer<i>/<site>/reorder_index" int32 arrays, "__select_nums__" and
    "__meta__" as JSON bytes (uint8), "__num_layers__"."""
    arrays = {}
    select = {}
    for i, layer in enumerate(calib):
        for site, sc in layer.items():
            arrays[f"layer{i}/{site}/reorder_index"] = (
                sc.reorder_index.detach().to("cpu", torch.int32).numpy())
            select[f"layer{i}/{site}"] = int(sc.select_num)
    arrays["__select_nums__"] = np.frombuffer(
        json.dumps(select).encode(), dtype=np.uint8)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    arrays["__num_layers__"] = np.asarray(len(calib))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_calibration(path: str, device="cpu") -> List[Dict[str, SiteCalib]]:
    """The per-layer {site: SiteCalib} of a calibration .npz, the reorder
    indices on `device`. Sites come from the file's keys (an MoE config
    adds sdown_in)."""
    data = np.load(path)
    select = json.loads(bytes(data["__select_nums__"]).decode())
    calib: List[Dict[str, SiteCalib]] = [
        {} for _ in range(int(data["__num_layers__"]))]
    for lk, n in select.items():
        layer_s, site = lk.split("/", 1)
        calib[int(layer_s[len("layer"):])][site] = SiteCalib(
            torch.from_numpy(data[f"{lk}/reorder_index"]).to(device), n)
    return calib


def load_calibration_meta(path: str) -> dict:
    """The metadata a calibration .npz was saved with."""
    return json.loads(bytes(np.load(path)["__meta__"]).decode())
