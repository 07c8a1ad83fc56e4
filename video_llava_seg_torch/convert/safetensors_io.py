"""A small reader of the `*.safetensors` format, so loading a checkpoint
needs no `safetensors` package.

Layout: an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__"}), then the raw little-endian tensor buffers, offsets
counted from the end of the header.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of one file, on the CPU, in their stored dtype."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: {name} has unsupported dtype "
                                 f"{info['dtype']}")
            begin, end = info["data_offsets"]
            fh.seek(base + begin)
            raw = np.frombuffer(fh.read(end - begin), dtype=np.uint8)
            t = torch.from_numpy(raw.copy()).view(_DTYPES[info["dtype"]])
            out[name] = t.reshape(info["shape"])
    return out
