"""SAM2 base model, the image parts (port of
`video_llava_seg_tpu/models/sam2/base.py`; the reference's
sam2/modeling/sam2_base.py).

`init` builds the JAX package's tree without `memory_attention` and
`memory_encoder`: the memory bank, `forward_sam_heads`,
`use_mask_as_output`, `encode_new_memory` and the non-overlap constraint
belong to the video predictor (ROADMAP queue 1 item 4). A converted
checkpoint (`convert.sam2_torch.convert_sam2_base`) holds the whole
tree; the image predictor reads only its image parts."""

from __future__ import annotations

from typing import Dict

import torch

from video_llava_seg_torch.models.sam2 import (
    image_encoder,
    mask_decoder,
    prompt_encoder,
)
from video_llava_seg_torch.ops import nn


def init(cfg, g: torch.Generator, device, dtype) -> Dict:
    c = cfg.hidden_dim
    p = {
        "image_encoder": image_encoder.init(cfg, g, device, dtype),
        "prompt_encoder": prompt_encoder.init(cfg, g, device, dtype),
        "mask_decoder": mask_decoder.init(cfg, g, device, dtype),
        "no_mem_embed": nn.trunc_normal(g, (1, 1, c), 0.02, device, dtype),
        "no_mem_pos_enc": nn.trunc_normal(g, (1, 1, c), 0.02, device, dtype),
        "maskmem_tpos_enc": nn.trunc_normal(
            g, (cfg.num_maskmem, 1, 1, cfg.mem_dim), 0.02, device, dtype),
    }
    if cfg.use_obj_ptrs_in_encoder:
        p["mask_downsample"] = nn.conv2d_init(g, 1, 1, (4, 4), device, dtype)
        if cfg.use_mlp_for_obj_ptr_proj:
            p["obj_ptr_proj"] = nn.mlp_init(g, [c, c, c], device, dtype)
        else:
            p["obj_ptr_proj"] = nn.dense_init(g, c, c, device, dtype)
        if cfg.pred_obj_scores:
            p["no_obj_ptr"] = nn.trunc_normal(g, (1, c), 0.02, device, dtype)
    if cfg.proj_tpos_enc_in_obj_ptrs:
        p["obj_ptr_tpos_proj"] = nn.dense_init(g, c, cfg.mem_dim, device,
                                               dtype)
    if cfg.no_obj_embed_spatial:
        p["no_obj_embed_spatial"] = nn.trunc_normal(
            g, (1, cfg.mem_dim), 0.02, device, dtype)
    return p


def forward_image(params, cfg, images: torch.Tensor) -> Dict:
    """images [B, H, W, 3] normalised -> the backbone dict, with the SAM
    decoder's high-res projections (conv_s0 / conv_s1) applied to the two
    highest-resolution FPN levels (sam2_base.py:467-478)."""
    out = image_encoder.apply(params["image_encoder"], cfg, images)
    if cfg.use_high_res_features_in_sam:
        fpn = list(out["backbone_fpn"])
        fpn[0] = nn.conv2d(params["mask_decoder"]["conv_s0"], fpn[0])
        fpn[1] = nn.conv2d(params["mask_decoder"]["conv_s1"], fpn[1])
        out["backbone_fpn"] = fpn
    return out


def prepare_backbone_features(cfg, backbone_out: Dict):
    """The last num_feature_levels maps (NHWC, high -> low resolution),
    their position encodings and (h, w) sizes."""
    n = cfg.num_feature_levels
    feats = backbone_out["backbone_fpn"][-n:]
    pos = backbone_out["vision_pos_enc"][-n:]
    sizes = [(f.shape[1], f.shape[2]) for f in feats]
    return feats, pos, sizes
