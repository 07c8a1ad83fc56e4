"""COCO compressed-RLE encoding of binary masks (copy of the encoder of
`video_llava_seg_tpu/ops/masks.py`, pinned to it by
`tests/test_torch_host_io.py`): column-major runs, 5-bit LEB chars with
delta coding, offset 48 — byte-compatible with pycocotools."""

from __future__ import annotations

from typing import Dict

import numpy as np


def rle_counts_from_mask(mask: np.ndarray) -> np.ndarray:
    """Uncompressed RLE counts (column-major, starting with a zero-run)."""
    if mask.ndim != 2:
        raise ValueError(f"expected a 2-D mask, got {mask.ndim}-D")
    flat = np.asarray(mask, dtype=np.uint8, order="F").flatten(order="F")
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [flat.size]])
    runs = ends - starts
    if flat.size == 0:
        return np.asarray([0], dtype=np.int64)
    if flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return runs.astype(np.int64)


def _counts_to_string(counts) -> bytes:
    """pycocotools rleToString: delta-coded 5-bit LEB with offset 48."""
    out = bytearray()
    cnts = [int(c) for c in counts]
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def encode_rle(mask: np.ndarray) -> Dict:
    """Binary [H, W] mask -> COCO compressed RLE dict."""
    h, w = mask.shape
    counts = rle_counts_from_mask(mask)
    return {"size": [int(h), int(w)], "counts": _counts_to_string(counts)}
