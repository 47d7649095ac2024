"""Calibration artifact loading (counterpart of
``arcquant_tpu/calib/artifacts.py``): one .npz holds, per layer and
site, a reorder index (ascending channel importance) and its ARC select
count, keyed "layer<i>/<site>"."""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from ..models.quantized import SiteCalib


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
