"""Hiera trunk + FPN neck (port of
`video_llava_seg_tpu/models/sam2/image_encoder.py`). 1x1 lateral convs,
top-down x2 upsampling on the configured levels, sine position
encodings, `scalp` drops the lowest-resolution level(s). NHWC maps."""

from __future__ import annotations

from typing import Dict, List

import torch

from video_llava_seg_torch.models.sam2 import hiera
from video_llava_seg_torch.models.sam2.position_encoding import (
    sine_pos_embed_on,
)
from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.resize import interpolate


def init(cfg, g, device, dtype):
    return {
        "trunk": hiera.init(cfg.hiera, g, device, dtype),
        "neck": {"convs": [nn.conv2d_init(g, c, cfg.fpn.d_model, (1, 1),
                                          device, dtype)
                           for c in cfg.hiera.channel_list]},
    }


def apply_neck(params, cfg, xs: List[torch.Tensor]):
    """xs: Hiera pyramid, highest-res first. Returns (features, pos),
    each highest-res first."""
    convs = params["neck"]["convs"]
    n = len(convs) - 1
    out = [None] * len(convs)
    pos = [None] * len(convs)
    prev = None
    for i in range(n, -1, -1):
        lateral = nn.conv2d(convs[n - i], xs[i])
        if i in cfg.fpn.fpn_top_down_levels and prev is not None:
            h, w = lateral.shape[1], lateral.shape[2]
            td = interpolate(prev.float(), (h, w),
                             cfg.fpn.fpn_interp_model).to(lateral.dtype)
            prev = lateral + td
            if cfg.fpn.fuse_type == "avg":
                prev = prev / 2
        else:
            prev = lateral
        out[i] = prev
        pe = sine_pos_embed_on(prev.shape[1], prev.shape[2],
                               cfg.fpn.pos_num_feats,
                               cfg.fpn.pos_temperature, prev.device,
                               prev.dtype)
        pos[i] = pe[None].expand(*prev.shape[:3], pe.shape[-1])
    return out, pos


def apply(params, cfg, images: torch.Tensor) -> Dict:
    """images: [B, H, W, 3] normalised -> {vision_features,
    vision_pos_enc, backbone_fpn} (NHWC)."""
    pyramid = hiera.apply(params["trunk"], cfg.hiera, images)
    features, pos = apply_neck(params, cfg, pyramid)
    if cfg.fpn.scalp > 0:
        features = features[: -cfg.fpn.scalp]
        pos = pos[: -cfg.fpn.scalp]
    return {"vision_features": features[-1], "vision_pos_enc": pos,
            "backbone_fpn": features}
