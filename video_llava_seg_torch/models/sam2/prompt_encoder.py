"""SAM2 prompt encoder, the part the [SEG] head uses (port of
`video_llava_seg_tpu/models/sam2/prompt_encoder.py`): the dense PE grid
and `no_mask_embed`. Point, box and mask prompts belong to the standalone
SAM2 predictors (ROADMAP queue 1: the SAM2 image predictor); their
parameters are built so the tree keeps the JAX package's layout."""

from __future__ import annotations

from video_llava_seg_torch.models.sam2.position_encoding import (
    random_pe_grid,
    random_pe_init,
)
from video_llava_seg_torch.ops import nn


def init(cfg, g, device, dtype):
    d = cfg.hidden_dim
    mask_ch = cfg.mask_in_chans
    return {
        "pe_layer": random_pe_init(g, d // 2, device),
        "point_embeddings": nn.trunc_normal(g, (4, d), 1.0, device, dtype),
        "not_a_point_embed": nn.trunc_normal(g, (1, d), 1.0, device, dtype),
        "no_mask_embed": nn.trunc_normal(g, (1, d), 1.0, device, dtype),
        "mask_downscaling": {
            "conv1": nn.conv2d_init(g, 1, mask_ch // 4, (2, 2), device,
                                    dtype),
            "ln1": nn.layer_norm_init(mask_ch // 4, device, dtype),
            "conv2": nn.conv2d_init(g, mask_ch // 4, mask_ch, (2, 2), device,
                                    dtype),
            "ln2": nn.layer_norm_init(mask_ch, device, dtype),
            "conv3": nn.conv2d_init(g, mask_ch, d, (1, 1), device, dtype),
        },
    }


def get_dense_pe(params, cfg, device):
    """[H, W, C] positional grid of the image embedding (fp32)."""
    s = cfg.image_embedding_size
    return random_pe_grid(params["pe_layer"], (s, s), device)
