"""[SEG]-token-driven SAM2 segmentation head (port of
`video_llava_seg_tpu/models/seg_head.py`).

Each [SEG] hidden state is projected to Q sparse prompt embeddings; the
SAM2 mask decoder decodes one mask per (frame, object, query) in one
batched call against the per-frame Hiera + FPN features; masks are
upscaled, unpadded and resized to the original frame size, and only then
reduced by a max over the Q queries (max does not commute with the
bilinear resizes)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from video_llava_seg_torch.models.sam2 import (
    image_encoder as sam2_image_encoder,
    mask_decoder as sam2_mask_decoder,
    prompt_encoder as sam2_prompt_encoder,
)
from video_llava_seg_torch.models.sam2.config import sam2_config
from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.resize import interpolate_hw
from video_llava_seg_torch.timing import stage

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def make_sam2_cfg(cfg):
    return sam2_config(cfg.seg_backbone, image_size=cfg.image_size)


def init(cfg, llm_hidden_size: int, g, device, dtype):
    sam2_cfg = make_sam2_cfg(cfg)
    return {
        "image_encoder": sam2_image_encoder.init(sam2_cfg, g, device, dtype),
        "prompt_encoder": sam2_prompt_encoder.init(sam2_cfg, g, device,
                                                   dtype),
        "mask_decoder": sam2_mask_decoder.init(sam2_cfg, g, device, dtype),
        "no_mem_embed": nn.trunc_normal(g, (1, 1, sam2_cfg.hidden_dim), 0.02,
                                        device, dtype),
        "proj_token": nn.dense_init(
            g, llm_hidden_size, sam2_cfg.hidden_dim * cfg.seg_num_queries,
            device, dtype),
    }


def convert_torch(sd, cfg, sam2_cfg, prefix: str = "",
                  no_mem_embed=None):
    """Torch SegmentationHeadSAM2 state dict -> params (keys
    image_encoder.*, prompt_encoder.*, mask_decoder.*, no_mem_embed,
    proj_token). A saved reference checkpoint does not hold no_mem_embed
    (the reference keeps it as a plain attribute), so real checkpoints
    pass it from the SAM2 backbone checkpoint."""
    from video_llava_seg_torch.convert.sam2_torch import (
        convert_image_encoder,
        convert_mask_decoder,
        convert_prompt_encoder,
    )

    if f"{prefix}no_mem_embed" in sd:
        no_mem = torch.as_tensor(sd[f"{prefix}no_mem_embed"])
    elif no_mem_embed is not None:
        no_mem = torch.as_tensor(no_mem_embed)
    else:
        raise KeyError(
            "no_mem_embed is not in the seg-head state dict (the reference "
            "does not save it): pass the SAM2 backbone checkpoint's "
            "no_mem_embed through no_mem_embed= (load_llava_weights("
            "sam2_ckpt=...))")
    if no_mem.dim() == 4:  # [1, C, 1, 1] in the reference head
        no_mem = no_mem.reshape(1, 1, -1)
    return {
        "image_encoder": convert_image_encoder(sd,
                                               f"{prefix}image_encoder."),
        "prompt_encoder": convert_prompt_encoder(sd,
                                                 f"{prefix}prompt_encoder."),
        "mask_decoder": convert_mask_decoder(sd, sam2_cfg,
                                             f"{prefix}mask_decoder."),
        "no_mem_embed": no_mem,
        "proj_token": {
            "kernel": torch.as_tensor(sd[f"{prefix}proj_token.weight"]).t()
            .contiguous(),
            "bias": torch.as_tensor(sd[f"{prefix}proj_token.bias"]),
        },
    }


def encode_video_frames(params, sam2_cfg, frames: torch.Tensor):
    """frames [T, H, W, 3] RGB in [0, 1] -> (backbone feats [T, h, w, C],
    high-res FPN list)."""
    mean = torch.tensor(IMAGE_MEAN, dtype=frames.dtype, device=frames.device)
    std = torch.tensor(IMAGE_STD, dtype=frames.dtype, device=frames.device)
    out = sam2_image_encoder.apply(params["image_encoder"], sam2_cfg,
                                   (frames - mean) / std)
    fpn = out["backbone_fpn"]
    high_res = [nn.conv2d(params["mask_decoder"]["conv_s0"], fpn[0]),
                nn.conv2d(params["mask_decoder"]["conv_s1"], fpn[1])]
    feats = fpn[2] + params["no_mem_embed"].reshape(1, 1, 1, -1).to(
        fpn[2].dtype)
    return feats, high_res


def decode_masks_batched(params, cfg, sam2_cfg, backbone_feats,
                         high_res_feats, seg_tokens):
    """backbone_feats [B, T, h, w, C]; high_res_feats list of [B, T, ...];
    seg_tokens [B, N, llm_hidden]. Returns [B, N, Q, T, 4h, 4w] low-res
    mask logits, Q unreduced."""
    q = cfg.seg_num_queries
    bsz, t = backbone_feats.shape[:2]
    n = seg_tokens.shape[1]
    c = sam2_cfg.hidden_dim
    sparse = nn.dense(params["proj_token"], seg_tokens).reshape(
        bsz, n * q, 1, c)
    s = sam2_cfg.image_embedding_size
    dense = params["prompt_encoder"]["no_mask_embed"].reshape(1, 1, 1, c)
    image_pe = sam2_prompt_encoder.get_dense_pe(
        params["prompt_encoder"], sam2_cfg, backbone_feats.device)

    # flat batch [B, T, NQ]: image features repeat over NQ, prompts
    # broadcast over T
    def tile_img(x):
        flat = x.reshape(bsz * t, *x.shape[2:])
        return flat.repeat_interleave(n * q, dim=0)

    img = tile_img(backbone_feats)
    hr = [tile_img(h) for h in high_res_feats]
    sp = sparse[:, None].expand(bsz, t, n * q, 1, c).reshape(
        bsz * t * n * q, 1, c)
    dn = dense.to(img.dtype).expand(bsz * t * n * q, s, s, c)
    low_res, _, _, _ = sam2_mask_decoder.apply(
        params["mask_decoder"], sam2_cfg, img, image_pe, sp, dn,
        multimask_output=False, high_res_features=hr)
    low_res = low_res.reshape(bsz, t, n, q, 4 * s, 4 * s)
    return low_res.permute(0, 2, 3, 1, 4, 5)


def postprocess_masks(masks, meta: Dict[str, Any], image_size: int,
                      resize_to_original_dims: bool):
    """Upscale to model resolution, unpad, optionally resize to the
    original frame size. masks [..., h, w] -> fp32."""
    masks = interpolate_hw(masks.float(), (image_size, image_size),
                           "bilinear")
    pl, pr, pt, pb = meta["padding"]
    h0, w0 = meta["resized_image_size"]
    masks = masks[..., pt:image_size - pb, pl:image_size - pr]
    if tuple(masks.shape[-2:]) != (h0, w0):
        raise ValueError(f"unpadded mask {tuple(masks.shape)} does not match "
                         f"the resized frame {(h0, w0)}")
    if not resize_to_original_dims:
        return masks
    th, tw = meta["orig_image_size"]
    return interpolate_hw(masks, (int(th), int(tw)), "bilinear")


def forward(params, cfg, sam2_cfg, video_frames: List[torch.Tensor],
            seg_tokens: List[torch.Tensor], seg_meta: List[Dict[str, Any]],
            resize_to_original_dims: bool,
            timings: Optional[Dict[str, float]] = None) -> List[torch.Tensor]:
    """Per-video lists in, list of [N, T, H', W'] mask logits out."""
    outputs = []
    for frames, tokens, meta in zip(video_frames, seg_tokens, seg_meta):
        dev = frames.device
        with stage(timings, "seg_encode", dev):
            feats, high_res = encode_video_frames(params, sam2_cfg, frames)
        with stage(timings, "seg_decode", dev):
            low = decode_masks_batched(
                params, cfg, sam2_cfg, feats[None],
                [h[None] for h in high_res],
                tokens[None].to(feats.dtype))[0]       # [N, Q, T, h, w]
        with stage(timings, "seg_postprocess", dev):
            post = postprocess_masks(low, meta, sam2_cfg.image_size,
                                     resize_to_original_dims)
            outputs.append(post.amax(dim=1))
    return outputs
