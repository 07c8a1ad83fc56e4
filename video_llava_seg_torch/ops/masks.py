"""COCO compressed RLE of binary masks and box extraction (copy of
`video_llava_seg_tpu/ops/masks.py`, pinned to it by
`tests/test_torch_host_io.py` and `tests/test_torch_amg.py`):
column-major runs, 5-bit LEB chars with delta coding, offset 48 —
byte-compatible with pycocotools."""

from __future__ import annotations

from typing import Dict, List, Union

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


def mask_from_rle_counts(counts, size) -> np.ndarray:
    """Inverse of rle_counts_from_mask. size = (h, w)."""
    h, w = size
    total = int(np.sum(counts))
    if total != h * w:
        raise ValueError(f"RLE counts sum to {total}, not {h} x {w}")
    vals = np.zeros(total, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        c = int(c)
        if val:
            vals[pos:pos + c] = 1
        pos += c
        val ^= 1
    return vals.reshape((h, w), order="F")


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


def _string_to_counts(s: Union[bytes, str]) -> List[int]:
    """pycocotools rleFrString: the inverse of _counts_to_string."""
    if isinstance(s, str):
        s = s.encode("ascii")
    cnts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def decode_rle(rle: Dict) -> np.ndarray:
    """COCO RLE dict (compressed str / bytes counts, or a list) -> binary
    [H, W] uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _string_to_counts(counts)
    return mask_from_rle_counts(np.asarray(counts, dtype=np.int64), (h, w))


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _string_to_counts(counts)
    return int(np.sum(counts[1::2]))


def mask_to_box(mask: np.ndarray):
    """Tight inclusive (x0, y0, x1, y1) box of a binary mask; None if empty
    (sam2/utils/misc.py:66-89)."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())
