"""The safetensors file format, read and written with numpy and torch
alone (the card's machine has no ``safetensors`` package).

A file is a little-endian u64 header length, a JSON header mapping each
tensor name to {"dtype", "shape", "data_offsets": [begin, end]} (byte
offsets into the data that follows), with an optional "__metadata__"
map of strings to strings, then the tensors' raw little-endian bytes.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# safetensors dtype code -> (torch dtype, numpy dtype the bytes are read as)
_DTYPES = {
    "F64": (torch.float64, np.float64), "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16), "BF16": (torch.bfloat16, np.uint16),
    "I64": (torch.int64, np.int64), "I32": (torch.int32, np.int32),
    "I16": (torch.int16, np.int16), "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8), "BOOL": (torch.bool, np.bool_),
    "F8_E4M3": (torch.float8_e4m3fn, np.uint8),
    "F8_E5M2": (torch.float8_e5m2, np.uint8),
}
_CODES = {t: code for code, (t, _) in _DTYPES.items()}


def read_safetensors(path: str, device="cpu"
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """({name: tensor on `device`}, the header's __metadata__ or {}) of
    one .safetensors file. The data is mapped, not read whole; a header
    whose offsets or sizes do not fit the file raises ValueError."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None) or {}
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(_DTYPES)}")
        tdtype, ndtype = _DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        size = int(np.prod(shape, dtype=np.int64)) * np.dtype(ndtype).itemsize
        if not 0 <= begin <= end <= data.shape[0] or end - begin != size:
            raise ValueError(f"{path}: {name} has offsets {begin}:{end} for "
                             f"{info['dtype']} {list(shape)} in "
                             f"{data.shape[0]} bytes of data")
        arr = np.array(data[begin:end]).view(np.dtype(ndtype).newbyteorder(
            "<")).astype(ndtype, copy=False).reshape(shape)
        t = torch.from_numpy(arr)
        if t.dtype != tdtype:
            t = t.view(tdtype)
        out[name] = t.to(device)
    del data
    return out, meta


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (any device; names in the dict's order) and
    `metadata` (str -> str) as one .safetensors file."""
    header, arrays, offset = {}, [], 0
    for name, t in tensors.items():
        if t.dtype not in _CODES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             "code")
        arr = t.detach().to("cpu").contiguous().reshape(-1).view(
            torch.uint8).numpy()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + arr.size]}
        arrays.append(arr)
        offset += arr.size
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for arr in arrays:
            f.write(memoryview(arr))
