"""SAM2 model builder (port of `video_llava_seg_tpu/models/sam2/build.py`;
the reference's sam2/build_sam.py).

`build_sam2(variant, checkpoint=...)` returns (params, cfg) on `device`
(`build_sam2_image_predictor` / `build_sam2_video_predictor` wrap it):
a reference torch checkpoint converted to the JAX package's tree, or,
without one, random weights drawn from `seed`. Variants are the bare
names (tiny, small, base_plus, large, sam2-test-tiny) or the reference's
model ids ('facebook/sam2.1-hiera-tiny')."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from video_llava_seg_torch import bridge
from video_llava_seg_torch.models.sam2 import base
from video_llava_seg_torch.models.sam2.config import SAM2Config, sam2_config


def default_dtype(device) -> torch.dtype:
    """bf16 on the card, fp32 on the CPU (the JAX predictor's choice:
    bf16 on its accelerator, fp32 elsewhere for the parity tests)."""
    return torch.float32 if torch.device(device).type == "cpu" \
        else torch.bfloat16


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference .pt checkpoint's 'model' state dict, floats as fp32
    (build_sam.py:141-151 key layout); tensors only (weights_only)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items()}


def build_sam2(variant: str = "small", checkpoint: Optional[str] = None,
               image_size: int = 1024, seed: int = 0, device="cuda",
               dtype: Optional[torch.dtype] = None,
               **overrides) -> Tuple[dict, SAM2Config]:
    cfg = sam2_config(variant, image_size=image_size, **overrides)
    dtype = dtype or default_dtype(device)
    if checkpoint is not None:
        from video_llava_seg_torch.convert.sam2_torch import (
            convert_sam2_base,
        )

        params = bridge.cast_tree(
            convert_sam2_base(load_torch_state_dict(checkpoint), cfg),
            device, dtype)
    else:
        g = torch.Generator(device=device).manual_seed(seed)
        params = base.init(cfg, g, device, dtype)
    return params, cfg


def build_sam2_image_predictor(variant: str = "small",
                               checkpoint: Optional[str] = None,
                               seed: int = 0, device="cuda", **kwargs):
    """A SAM2ImagePredictor over `build_sam2`'s model; kwargs go to the
    predictor (mask_threshold, max_hole_area, max_sprinkle_area)."""
    from video_llava_seg_torch.models.sam2.image_predictor import (
        SAM2ImagePredictor,
    )

    params, cfg = build_sam2(variant, checkpoint, seed=seed, device=device)
    return SAM2ImagePredictor(params, cfg, device=device, **kwargs)


def build_sam2_video_predictor(variant: str = "small",
                               checkpoint: Optional[str] = None,
                               seed: int = 0, device="cuda", **kwargs):
    """A SAM2VideoPredictor over `build_sam2`'s model with the video
    predictor's post-processing defaults (build_sam.py:88-102:
    fill_hole_area 8); kwargs go to the predictor."""
    from video_llava_seg_torch.models.sam2.video_predictor import (
        SAM2VideoPredictor,
    )

    params, cfg = build_sam2(variant, checkpoint, seed=seed, device=device)
    kwargs.setdefault("fill_hole_area", 8)
    return SAM2VideoPredictor(params, cfg, device=device, **kwargs)
