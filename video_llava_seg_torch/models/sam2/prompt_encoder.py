"""SAM2 prompt encoder: points / boxes / masks -> sparse + dense
embeddings (port of `video_llava_seg_tpu/models/sam2/prompt_encoder.py`).

Boxes are two points with labels 2 (top-left) and 3 (bottom-right), so
the sparse path is one vectorised op:

    emb[i] = (label == -1) ? not_a_point : PE(coord) + point_type[label]

The [SEG] head uses the dense PE grid and `no_mask_embed` only; the SAM2
image predictor and the automatic mask generator use the rest."""

from __future__ import annotations

from typing import Optional

import torch

from video_llava_seg_torch.models.sam2.position_encoding import (
    random_pe_coords,
    random_pe_grid,
    random_pe_init,
)
from video_llava_seg_torch.ops import nn


def init(cfg, g, device, dtype):
    d = cfg.hidden_dim
    mask_ch = cfg.mask_in_chans
    return {
        "pe_layer": random_pe_init(g, d // 2, device),
        # 4 point types: negative click, positive click, box TL, box BR
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


def embed_points(params, cfg, coords: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """coords [B, P, 2] absolute pixel (x, y) in the model frame; labels
    [B, P] int (-1 pad, 0 negative, 1 positive, 2 box TL, 3 box BR).
    Returns [B, P, C] (fp32: the PE's type)."""
    coords = coords.float() + 0.5  # pixel-centre shift
    pe = random_pe_coords(params["pe_layer"], coords,
                          (cfg.image_size, cfg.image_size))
    pe = torch.where((labels == -1)[..., None], 0.0, pe)
    type_table = torch.cat([params["not_a_point_embed"],
                            params["point_embeddings"]], dim=0)
    return pe + type_table[torch.clamp(labels + 1, 0, 4)]


def embed_masks(params, masks_nhwc: torch.Tensor) -> torch.Tensor:
    """masks [B, 4H, 4W, 1] -> dense embeddings [B, H, W, C]."""
    p = params["mask_downscaling"]
    x = nn.conv2d(p["conv1"], masks_nhwc, stride=(2, 2), padding="VALID")
    x = nn.gelu(nn.layer_norm(p["ln1"], x, 1e-6))
    x = nn.conv2d(p["conv2"], x, stride=(2, 2), padding="VALID")
    x = nn.gelu(nn.layer_norm(p["ln2"], x, 1e-6))
    return nn.conv2d(p["conv3"], x)


def apply(params, cfg, coords, labels, masks: Optional[torch.Tensor] = None,
          boxes: Optional[torch.Tensor] = None):
    """Returns (sparse [B, N, C], dense [B, H, W, C]). boxes [B, 4] (x0, y0,
    x1, y1) are appended as two labelled corner points. The caller adds
    the reference's (-1) pad point where it wants one."""
    sparse = embed_points(params, cfg, coords, labels)
    if boxes is not None:
        b = boxes.reshape(boxes.shape[0], 2, 2)
        blabels = torch.tensor([2, 3], device=b.device).expand(b.shape[0], 2)
        sparse = torch.cat([sparse, embed_points(params, cfg, b, blabels)],
                           dim=1)
    if masks is not None:
        dense = embed_masks(params, masks)
    else:
        s = cfg.image_embedding_size
        dense = params["no_mask_embed"].reshape(1, 1, 1, -1).expand(
            sparse.shape[0], s, s, cfg.hidden_dim)
    return sparse, dense
