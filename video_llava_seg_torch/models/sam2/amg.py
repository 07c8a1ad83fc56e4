"""AMG utilities (copy of `video_llava_seg_tpu/models/sam2/amg.py`, pinned
to it by `tests/test_torch_amg.py`; the reference's sam2/utils/amg.py),
numpy on the host.

Point grids, crop boxes, stability scores, greedy box NMS, RLE helpers on
top of `ops/masks.py`, and small-region removal through the port's
`ops/connected_components` on a CPU tensor (the reference uses cv2)."""

from __future__ import annotations

import math
from typing import Any, Dict, Generator, List, Tuple

import numpy as np

import torch

from video_llava_seg_torch.ops.connected_components import (
    connected_components,
)
from video_llava_seg_torch.ops.masks import (
    decode_rle,
    encode_rle,
    mask_from_rle_counts,
    rle_area,
    rle_counts_from_mask,
)


class MaskData:
    """Dict of parallel arrays/lists with filter/cat (amg.py:24-77)."""

    def __init__(self, **kwargs):
        self._stats: Dict[str, Any] = dict(kwargs)

    def __setitem__(self, k, v):
        self._stats[k] = v

    def __delitem__(self, k):
        del self._stats[k]

    def __getitem__(self, k):
        return self._stats[k]

    def __contains__(self, k):
        return k in self._stats

    def items(self):
        return self._stats.items()

    def filter(self, keep: np.ndarray):
        keep = np.asarray(keep)
        if keep.dtype == bool:
            idx = np.flatnonzero(keep)
        else:
            idx = keep
        for k, v in self._stats.items():
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                self._stats[k] = v[idx]
            elif isinstance(v, list):
                self._stats[k] = [v[i] for i in idx]
            else:
                raise TypeError(f"unsupported type {type(v)} for key {k}")

    def cat(self, other: "MaskData"):
        for k, v in other.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = v
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + v
            else:
                raise TypeError(f"unsupported type {type(v)} for key {k}")

    def __len__(self):
        for v in self._stats.values():
            if v is not None:
                return len(v)
        return 0


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Evenly spaced 2D points in [0,1]^2 (amg.py:181-188)."""
    offset = 1 / (2 * n_per_side)
    points_one_side = np.linspace(offset, 1 - offset, n_per_side)
    px = np.tile(points_one_side[None, :], (n_per_side, 1))
    py = np.tile(points_one_side[:, None], (1, n_per_side))
    return np.stack([px, py], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [build_point_grid(int(n_per_side / (scale_per_layer**i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, ...], n_layers: int,
                        overlap_ratio: float):
    """Crop boxes of different sizes, (x0, y0, x1, y1) (amg.py:202-236)."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i)
                       for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i)
                       for i in range(n_crops_per_side)]
        for x0 in crop_box_x0:
            for y0 in crop_box_y0:
                box = [x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)]
                crop_boxes.append(box)
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box) -> np.ndarray:
    x0, y0, _, _ = crop_box
    return boxes + np.asarray([[x0, y0, x0, y0]], boxes.dtype)


def uncrop_points(points: np.ndarray, crop_box) -> np.ndarray:
    x0, y0, _, _ = crop_box
    return points + np.asarray([[x0, y0]], points.dtype)


def uncrop_masks(masks: np.ndarray, crop_box, orig_h: int,
                 orig_w: int) -> np.ndarray:
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    out = np.zeros((masks.shape[0], orig_h, orig_w), masks.dtype)
    out[:, y0:y1, x0:x1] = masks
    return out


def is_box_near_crop_edge(boxes: np.ndarray, crop_box, orig_box,
                          atol: float = 20.0) -> np.ndarray:
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    b = uncrop_boxes_xyxy(boxes, crop_box).astype(np.float32)
    near_crop = np.isclose(b, crop[None], atol=atol, rtol=0)
    near_image = np.isclose(b, orig[None], atol=atol, rtol=0)
    near_crop = np.logical_and(near_crop, ~near_image)
    return np.any(near_crop, axis=1)


def box_xyxy_to_xywh(box: np.ndarray) -> np.ndarray:
    out = np.array(box, np.float32, copy=True)
    out[..., 2] = out[..., 2] - out[..., 0]
    out[..., 3] = out[..., 3] - out[..., 1]
    return out


def batch_iterator(batch_size: int, *args) -> Generator:
    if not args or any(len(a) != len(args[0]) for a in args):
        raise ValueError("batch_iterator needs sequences of one length")
    n_batches = len(args[0]) // batch_size + int(
        len(args[0]) % batch_size != 0)
    for b in range(n_batches):
        yield [arg[b * batch_size: (b + 1) * batch_size] for arg in args]


def calculate_stability_score(masks: np.ndarray, mask_threshold: float,
                              threshold_offset: float) -> np.ndarray:
    """IoU between high/low-threshold binarizations (amg.py:158-178).
    The row length is explicit: with no mask left (a filter dropped them
    all) the JAX copy's reshape(0, -1) raises."""
    flat = masks.reshape(masks.shape[0], int(np.prod(masks.shape[1:])))
    intersections = np.sum(flat > (mask_threshold + threshold_offset),
                           axis=-1).astype(np.float32)
    unions = np.sum(flat > (mask_threshold - threshold_offset),
                    axis=-1).astype(np.float32)
    return np.where(unions > 0, intersections / np.maximum(unions, 1), 1.0)


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """XYXY boxes around masks; [0,0,0,0] for empty (amg.py:305-348)."""
    if masks.size == 0:
        return np.zeros((*masks.shape[:-2], 4), np.float32)
    shape = masks.shape
    flat = masks.reshape(-1, shape[-2], shape[-1]).astype(bool)
    n, h, w = flat.shape
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        ys, xs = np.nonzero(flat[i])
        if ys.size == 0:
            continue
        boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return boxes.reshape(*shape[:-2], 4)


def box_area(boxes: np.ndarray) -> np.ndarray:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def batched_nms(boxes: np.ndarray, scores: np.ndarray,
                iou_threshold: float) -> np.ndarray:
    """Greedy NMS; returns kept indices sorted by score."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    order = np.argsort(-scores)
    keep = []
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x1 - x0) * (y1 - y0)
    suppressed = np.zeros(len(boxes), bool)
    for idx in order:
        if suppressed[idx]:
            continue
        keep.append(idx)
        xx0 = np.maximum(x0[idx], x0)
        yy0 = np.maximum(y0[idx], y0)
        xx1 = np.minimum(x1[idx], x1)
        yy1 = np.minimum(y1[idx], y1)
        inter = np.maximum(0, xx1 - xx0) * np.maximum(0, yy1 - yy0)
        union = areas[idx] + areas - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)
        suppressed |= iou > iou_threshold
        suppressed[idx] = True
    return np.asarray(keep, np.int64)


def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """Uncompressed RLE (amg.py mask_to_rle_pytorch single-mask semantics)."""
    h, w = mask.shape
    return {"size": [h, w],
            "counts": rle_counts_from_mask(mask).tolist()}


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        return decode_rle(rle).astype(bool)
    return mask_from_rle_counts(np.asarray(counts, np.int64),
                                rle["size"]).astype(bool)


def area_from_rle(rle: Dict[str, Any]) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        return rle_area(rle)
    return int(sum(counts[1::2]))


def coco_encode_rle(uncompressed_rle: Dict[str, Any]) -> Dict[str, Any]:
    mask = rle_to_mask(uncompressed_rle)
    return encode_rle(mask.astype(np.uint8))


def remove_small_regions(mask: np.ndarray, area_thresh: float,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """Remove small holes ("holes") or islands ("islands") of a binary
    mask through connected components (amg.py:269-293)."""
    if mode not in ("holes", "islands"):
        raise ValueError(f"mode must be 'holes' or 'islands', got {mode!r}")
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask).astype(bool)
    labels, areas = connected_components(torch.from_numpy(working[None]))
    labels, areas = labels[0].numpy(), areas[0].numpy()
    small = (labels > 0) & (areas < area_thresh)
    if not small.any():
        return mask, False
    fill = working & ~small
    if correct_holes:
        # keep everything but the large background regions (fills holes)
        new_mask = ~fill
    else:
        new_mask = fill
        if not new_mask.any():
            # every island was small: keep the single largest one
            best = labels[small][np.argmax(areas[small])]
            new_mask = labels == best
    return new_mask.astype(mask.dtype), True
