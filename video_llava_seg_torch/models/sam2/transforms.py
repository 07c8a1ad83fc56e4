"""SAM2 input / output transforms (port of
`video_llava_seg_tpu/models/sam2/transforms.py`; the reference's
sam2/utils/transforms.py).

The image goes to the device as uint8 and is scaled, resized
(antialiased bilinear, `ops.resize`) and normalised there. Mask
post-processing fills holes and removes sprinkles with
`ops.connected_components` on the masks' device, then resizes the
logits to the original image size."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from video_llava_seg_torch.ops.connected_components import (
    fill_holes_and_sprinkles,
)
from video_llava_seg_torch.ops.resize import interpolate, interpolate_hw

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class SAM2Transforms:
    def __init__(self, resolution: int, mask_threshold: float = 0.0,
                 max_hole_area: float = 0.0, max_sprinkle_area: float = 0.0):
        self.resolution = resolution
        self.mask_threshold = mask_threshold
        self.max_hole_area = max_hole_area
        self.max_sprinkle_area = max_sprinkle_area

    def _prep(self, img: torch.Tensor) -> torch.Tensor:
        """uint8 [..., H, W, 3] -> normalised fp32 [..., res, res, 3] on
        img's device."""
        x = img.float() / 255.0
        x = interpolate(x, (self.resolution, self.resolution), "bilinear",
                        antialias=True)
        mean = torch.tensor(MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(STD, dtype=torch.float32, device=x.device)
        return (x - mean) / std

    def __call__(self, image: np.ndarray, device) -> torch.Tensor:
        """uint8 [H, W, 3] -> normalised fp32 [res, res, 3] on `device`."""
        return self._prep(torch.as_tensor(np.asarray(image), device=device))

    def forward_batch(self, images: List[np.ndarray],
                      device) -> torch.Tensor:
        """uint8 [H, W, 3] images of any sizes -> [B, res, res, 3]."""
        return torch.stack([self(i, device) for i in images])

    def transform_coords(self, coords, normalize: bool = False,
                         orig_hw: Optional[Tuple[int, int]] = None):
        """[..., 2] (x, y) -> model-frame coords in [0, resolution]."""
        coords = np.asarray(coords, np.float32).copy()
        if normalize:
            h, w = orig_hw
            coords[..., 0] = coords[..., 0] / w
            coords[..., 1] = coords[..., 1] / h
        return coords * self.resolution

    def transform_boxes(self, boxes, normalize: bool = False,
                        orig_hw: Optional[Tuple[int, int]] = None):
        return self.transform_coords(
            np.asarray(boxes).reshape(-1, 2, 2), normalize, orig_hw)

    def postprocess_masks(self, masks: torch.Tensor,
                          orig_hw: Tuple[int, int]) -> torch.Tensor:
        """[B, M, H, W] logits -> hole-filled, resized to orig_hw (fp32)."""
        b, m = masks.shape[0], masks.shape[1]
        x = masks.float().reshape(b * m, *masks.shape[2:])
        if self.max_hole_area > 0 or self.max_sprinkle_area > 0:
            x = fill_holes_and_sprinkles(x, self.mask_threshold,
                                         self.max_hole_area,
                                         self.max_sprinkle_area)
        x = x.reshape(b, m, *x.shape[1:])
        return interpolate_hw(x, tuple(orig_hw), "bilinear")
