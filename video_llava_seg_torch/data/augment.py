"""Training augmentations (port of `video_llava_seg_tpu/data/augment.py`,
pinned to it by `tests/test_torch_data.py`; the reference's
llava/train/vision_augmentation.py). numpy.

Random crops that must contain (a fraction of) the mask's active pixels,
with a bounded number of retries, drawn from a `random.Random` in the
same order as the JAX package."""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np


def mask_to_bbox(masks: np.ndarray, raise_error_if_null_mask: bool = True):
    """masks: [N, H, W] -> [N, 4] (x1, y1, w, h) (vision_augmentation.py:16-53)."""
    out = np.zeros((masks.shape[0], 4), np.int64)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if ys.size == 0:
            if raise_error_if_null_mask:
                raise ValueError(f"mask {i} is empty")
            continue
        out[i] = [xs.min(), ys.min(), xs.max() - xs.min() + 1,
                  ys.max() - ys.min() + 1]
    return out


def compute_mask_containing_image_crop(
        mask: np.ndarray, target_dims: Tuple[int, int],
        min_crop_mask_coverage: float = 1e-8, num_tries: int = 10,
        rng: Optional[random.Random] = None):
    """Sample a (x1, y1) crop of target_dims containing >= coverage of the
    mask's active pixels; None after num_tries failures
    (vision_augmentation.py:56-135)."""
    assert mask.ndim == 2
    rng = rng or random
    x1, y1, bw, bh = mask_to_bbox(mask[None])[0].tolist()
    x2, y2 = x1 + bw, y1 + bh
    im_h, im_w = mask.shape
    crop_h, crop_w = target_dims
    required = max(1, int((mask > 0).sum() * min_crop_mask_coverage))

    x1_min = max(0, x1 - crop_w + 1)
    x1_max = min(im_w - crop_w, x2 - 1)
    y1_min = max(0, y1 - crop_h + 1)
    y1_max = min(im_h - crop_h, y2 - 1)
    if x1_max < x1_min or y1_max < y1_min:
        raise ValueError(
            f"Invalid crop range: box=({x1},{y1},{x2},{y2}) "
            f"image=({im_h},{im_w}) crop=({crop_h},{crop_w})")

    for _ in range(num_tries):
        cx = rng.randint(x1_min, x1_max)
        cy = rng.randint(y1_min, y1_max)
        crop = mask[cy:cy + crop_h, cx:cx + crop_w]
        if int((crop > 0).sum()) >= required:
            return cx, cy
    return None


def compute_mask_containing_video_crop(
        masks: np.ndarray, target_dims: Tuple[int, int],
        min_crop_mask_coverage: float = 1e-8, num_tries: int = 10,
        rng: Optional[random.Random] = None):
    """Video variant: collapse T by any() then crop (vision_augmentation.py:
    138-164). masks: [T, H, W]."""
    merged = np.any(masks > 0, axis=0)
    return compute_mask_containing_image_crop(
        merged, target_dims, min_crop_mask_coverage, num_tries, rng)
