"""Frame preprocessing in torch, on the model's device (port of the
frame paths of `video_llava_seg_tpu/data/vicas.py` and
`video_llava_seg_tpu/inference/utils.py`, which use PIL and a host
resize).

- `clip_preprocess_frames`: pad to square with the CLIP mean colour, PIL
  BICUBIC resize (antialiased, a=-0.5; horizontal then vertical pass,
  each rounded to uint8 as PIL does), rescale and CLIP-normalise.
- `preprocess_seg_inputs`: resize the long side to the seg head's input
  size (bilinear, align_corners=False, no antialias), zero-pad, [0, 1].
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from video_llava_seg_torch.ops.resize import interpolate, pil_resize
from video_llava_seg_torch.vision_utils import get_resize_padding_params

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def expand2square(frames: torch.Tensor, fill) -> torch.Tensor:
    """[T, H, W, 3] -> [T, S, S, 3] centre-padded with `fill`."""
    t, h, w, c = frames.shape
    if h == w:
        return frames
    s = max(h, w)
    out = torch.empty((t, s, s, c), dtype=frames.dtype, device=frames.device)
    out[...] = torch.tensor(fill, dtype=frames.dtype, device=frames.device)
    y0, x0 = (s - h) // 2, (s - w) // 2
    out[:, y0:y0 + h, x0:x0 + w] = frames
    return out


def clip_preprocess_frames(frames: torch.Tensor,
                           image_size: int) -> torch.Tensor:
    """uint8 [T, H, W, 3] -> CLIP-normalised fp32 [T, S, S, 3]."""
    fill = tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)
    x = pil_resize(expand2square(frames, fill), (image_size, image_size))
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x / 255.0 - mean) / std


def preprocess_seg_inputs(seg_frames: torch.Tensor, seg_meta: Dict[str, Any],
                          tgt_size: int, pad_mode: str = "topleft"
                          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """uint8 [T, H, W, 3] -> fp32 [T, tgt, tgt, 3] in [0, 1], plus a copy
    of `seg_meta` with `resized_image_size` and `padding` set."""
    x = seg_frames.float() / 255.0
    h, w = x.shape[1:3]
    (nh, nw), (pl, pr, pt, pb) = get_resize_padding_params(
        h, w, tgt_size, pad_mode=pad_mode)
    x = interpolate(x, (nh, nw), "bilinear")
    x = F.pad(x, (0, 0, pl, pr, pt, pb))
    meta = copy.copy(seg_meta)
    meta["resized_image_size"] = (nh, nw)
    meta["padding"] = (pl, pr, pt, pb)
    return x, meta
