"""SAM2 base model (port of `video_llava_seg_tpu/models/sam2/base.py`;
the reference's sam2/modeling/sam2_base.py): `init` builds the JAX
package's whole tree (image encoder, prompt encoder, mask decoder,
memory attention, memory encoder and the memory embeddings);
`forward_image` / `prepare_backbone_features` encode frames;
`forward_sam_heads` (sam2_base.py:257-413), `use_mask_as_output`
(:415-466), `encode_new_memory` (:676-724) and
`apply_non_overlapping_constraints` (:889-907) are the per-frame steps
the video predictor composes. The memory bank itself (which memories a
frame attends to, sam2_base.py:497-674) lives in the video predictor.

Masks and scores leave these functions in fp32, whatever the compute
dtype (bf16 on the card), as the JAX package's do."""

from __future__ import annotations

from typing import Dict

import torch

from video_llava_seg_torch.models.sam2 import (
    image_encoder,
    mask_decoder,
    memory,
    prompt_encoder,
)
from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.resize import interpolate_hw

# placeholder score of a missing object (sam2_base.py NO_OBJ_SCORE)
NO_OBJ_SCORE = -1024.0


def init(cfg, g: torch.Generator, device, dtype) -> Dict:
    c = cfg.hidden_dim
    p = {
        "image_encoder": image_encoder.init(cfg, g, device, dtype),
        "prompt_encoder": prompt_encoder.init(cfg, g, device, dtype),
        "mask_decoder": mask_decoder.init(cfg, g, device, dtype),
        "memory_attention": memory.memory_attention_init(cfg, g, device,
                                                         dtype),
        "memory_encoder": memory.memory_encoder_init(cfg, g, device, dtype),
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


# ---------------------------------------------------------------------------
# SAM heads
# ---------------------------------------------------------------------------

def forward_sam_heads(params, cfg, backbone_features, point_coords=None,
                      point_labels=None, mask_inputs=None,
                      high_res_features=None,
                      multimask_output: bool = False):
    """_forward_sam_heads (sam2_base.py:257-413), NHWC features.

    backbone_features [B, H, W, C]; point_coords [B, P, 2] / labels [B, P]
    in the model frame (None: the reference's empty-point path); the
    reference's (-1) pad point is appended here; mask_inputs [B, 16H,
    16W, 1] logits or binary. Returns (low_res_multimasks,
    high_res_multimasks, ious, low_res_masks, high_res_masks, obj_ptr,
    object_score_logits), masks fp32 [B, M, h, w]."""
    b = backbone_features.shape[0]
    dev, dt = backbone_features.device, backbone_features.dtype
    if point_coords is None:
        point_coords = torch.zeros((b, 1, 2), device=dev)
        point_labels = -torch.ones((b, 1), dtype=torch.int32, device=dev)
    else:
        point_coords = torch.cat([point_coords.float(), torch.zeros(
            (b, 1, 2), device=dev)], dim=1)
        point_labels = torch.cat([point_labels, -torch.ones(
            (b, 1), dtype=point_labels.dtype, device=dev)], dim=1)
    sam_mask_prompt = None
    if mask_inputs is not None:
        target = cfg.image_embedding_size * 4
        m = mask_inputs.float()
        if m.shape[1] != target:
            m = interpolate_hw(m[..., 0], (target, target), "bilinear",
                               antialias=True)[..., None]
        sam_mask_prompt = m.to(dt)
    pe = params["prompt_encoder"]
    sparse, dense = prompt_encoder.apply(pe, cfg, point_coords, point_labels,
                                         masks=sam_mask_prompt)
    image_pe = prompt_encoder.get_dense_pe(pe, cfg, dev)
    low_res_multimasks, ious, sam_output_tokens, object_score_logits = (
        mask_decoder.apply(params["mask_decoder"], cfg, backbone_features,
                           image_pe, sparse.to(dt), dense.to(dt),
                           multimask_output=multimask_output,
                           high_res_features=high_res_features))
    is_obj_appearing = object_score_logits > 0
    if cfg.pred_obj_scores:
        low_res_multimasks = torch.where(is_obj_appearing[:, None, None],
                                         low_res_multimasks, NO_OBJ_SCORE)
    low_res_multimasks = low_res_multimasks.float()
    high_res_multimasks = interpolate_hw(
        low_res_multimasks, (cfg.image_size, cfg.image_size), "bilinear")

    sam_output_token = sam_output_tokens[:, 0]
    if multimask_output:
        best = torch.argmax(ious, dim=-1)
        bi = torch.arange(b, device=dev)
        low_res_masks = low_res_multimasks[bi, best][:, None]
        high_res_masks = high_res_multimasks[bi, best][:, None]
        if sam_output_tokens.shape[1] > 1:
            sam_output_token = sam_output_tokens[bi, best]
    else:
        low_res_masks, high_res_masks = low_res_multimasks, \
            high_res_multimasks

    if cfg.use_obj_ptrs_in_encoder:
        if cfg.use_mlp_for_obj_ptr_proj:
            obj_ptr = nn.mlp_apply(params["obj_ptr_proj"], sam_output_token)
        else:
            obj_ptr = nn.dense(params["obj_ptr_proj"], sam_output_token)
    else:
        obj_ptr = sam_output_token
    if cfg.pred_obj_scores:
        if cfg.soft_no_obj_ptr:
            lam = torch.sigmoid(object_score_logits).to(obj_ptr.dtype)
        else:
            lam = is_obj_appearing.to(obj_ptr.dtype)
        if cfg.fixed_no_obj_ptr:
            obj_ptr = lam * obj_ptr
        obj_ptr = obj_ptr + (1.0 - lam) * params["no_obj_ptr"].to(
            obj_ptr.dtype)
    return (low_res_multimasks, high_res_multimasks, ious.float(),
            low_res_masks, high_res_masks, obj_ptr,
            object_score_logits.float())


def use_mask_as_output(params, cfg, backbone_features, high_res_features,
                       mask_inputs):
    """_use_mask_as_output (sam2_base.py:415-466): a binary mask input
    [B, H, W, 1] (H = the image size) becomes the output logits (+-10),
    with an object pointer decoded from the mask (through
    `forward_sam_heads` on the mask downsampled by `mask_downsample`).
    Returns forward_sam_heads' seven outputs."""
    out_scale, out_bias = 20.0, -10.0
    mask_f = mask_inputs.float()
    b = mask_f.shape[0]
    high_res_masks = (mask_f * out_scale + out_bias)[..., 0][:, None]
    low_res_masks = interpolate_hw(
        high_res_masks, (high_res_masks.shape[-2] // 4,
                         high_res_masks.shape[-1] // 4),
        "bilinear", antialias=True)
    ious = torch.ones((b, 1), device=mask_f.device)
    if not cfg.use_obj_ptrs_in_encoder:
        obj_ptr = torch.zeros((b, cfg.hidden_dim), device=mask_f.device,
                              dtype=backbone_features.dtype)
    else:
        small = nn.conv2d(params["mask_downsample"],
                          mask_f.to(backbone_features.dtype), stride=(4, 4),
                          padding="VALID")
        obj_ptr = forward_sam_heads(params, cfg, backbone_features,
                                    mask_inputs=small,
                                    high_res_features=high_res_features)[5]
    lam = (mask_f.reshape(b, -1) > 0.0).any(dim=1, keepdim=True).float()
    object_score_logits = out_scale * lam + out_bias
    if cfg.pred_obj_scores:
        lam_p = lam.to(obj_ptr.dtype)
        if cfg.fixed_no_obj_ptr:
            obj_ptr = lam_p * obj_ptr
        obj_ptr = obj_ptr + (1.0 - lam_p) * params["no_obj_ptr"].to(
            obj_ptr.dtype)
    return (low_res_masks, high_res_masks, ious, low_res_masks,
            high_res_masks, obj_ptr, object_score_logits)


# ---------------------------------------------------------------------------
# memory encoding
# ---------------------------------------------------------------------------

def encode_new_memory(params, cfg, pix_feat, high_res_masks,
                      object_score_logits, is_mask_from_pts: bool = False):
    """_encode_new_memory (sam2_base.py:676-724). pix_feat [B, H, W, C];
    high_res_masks [B, 1, 16H, 16W] fp32 logits. Returns
    (maskmem_features [B, H, W, mem_dim], maskmem_pos_enc [H, W,
    mem_dim]), in pix_feat's dtype."""
    if cfg.non_overlap_masks_for_mem_enc:
        high_res_masks = apply_non_overlapping_constraints(high_res_masks)
    if cfg.binarize_mask_from_pts_for_mem_enc and is_mask_from_pts:
        mask_for_mem = (high_res_masks > 0).float()
    else:
        mask_for_mem = torch.sigmoid(high_res_masks.float())
    mask_for_mem = (mask_for_mem * cfg.sigmoid_scale_for_mem_enc
                    + cfg.sigmoid_bias_for_mem_enc)
    feats, pos = memory.memory_encoder_apply(
        params["memory_encoder"], cfg, pix_feat, mask_for_mem[:, 0][..., None],
        skip_mask_sigmoid=True)
    if cfg.no_obj_embed_spatial:
        is_obj = (object_score_logits > 0).to(feats.dtype)     # [B, 1]
        feats = feats + (1.0 - is_obj)[:, :, None, None] * params[
            "no_obj_embed_spatial"].reshape(1, 1, 1, -1).to(feats.dtype)
    return feats, pos


def apply_non_overlapping_constraints(pred_masks):
    """Keep only the highest-scoring object at each pixel
    (sam2_base.py:889-907); the others' logits are clamped to at most
    -10. pred_masks [N_obj, 1, H, W]."""
    n = pred_masks.shape[0]
    if n == 1:
        return pred_masks
    max_obj = torch.argmax(pred_masks, dim=0, keepdim=True)
    obj_ids = torch.arange(n, device=pred_masks.device)[:, None, None, None]
    keep = max_obj == obj_ids
    return torch.where(keep, pred_masks, pred_masks.clamp(max=-10.0))
