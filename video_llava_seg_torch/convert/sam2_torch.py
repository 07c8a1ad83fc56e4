"""SAM2 torch state dict -> the port's parameter trees (port of
`video_llava_seg_tpu/convert/sam2_torch.py`): the Hiera trunk + FPN neck,
the prompt encoder and the mask decoder (what the seg head runs), the
memory encoder and memory attention, and the whole SAM2 base model
(`convert_sam2_base`, what `models/sam2/build.build_sam2` loads).

Layout changes (to the JAX package's layout, which the port shares):
  Linear weight [out, in]        -> kernel [in, out]
  Conv2d weight OIHW             -> HWIO
  ConvTranspose2d weight IOHW    -> HWIO, spatially flipped
  NCHW positional buffers        -> NHWC
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


def _lin(sd, prefix):
    p = {"kernel": _t(sd[f"{prefix}.weight"]).t().contiguous()}
    if f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


def _conv(sd, prefix):
    p = {"kernel": _t(sd[f"{prefix}.weight"]).permute(2, 3, 1, 0)
         .contiguous()}
    if f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


def _conv_t(sd, prefix):
    # torch ConvTranspose2d (IOHW) == the JAX layout's conv_transpose with
    # the spatial axes flipped
    w = _t(sd[f"{prefix}.weight"]).flip(2, 3)
    p = {"kernel": w.permute(2, 3, 0, 1).contiguous()}
    if f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


def _ln(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"])}


def _mlp(sd, prefix, n):
    return {"layers": [_lin(sd, f"{prefix}.layers.{i}") for i in range(n)]}


def _attn(sd, prefix):
    return {
        "q_proj": _lin(sd, f"{prefix}.q_proj"),
        "k_proj": _lin(sd, f"{prefix}.k_proj"),
        "v_proj": _lin(sd, f"{prefix}.v_proj"),
        "out_proj": _lin(sd, f"{prefix}.out_proj"),
    }


def convert_hiera(sd: Mapping, prefix: str = "") -> Dict:
    num_blocks = 0
    while f"{prefix}blocks.{num_blocks}.norm1.weight" in sd:
        num_blocks += 1
    blocks = []
    for i in range(num_blocks):
        b = f"{prefix}blocks.{i}"
        blk = {
            "norm1": _ln(sd, f"{b}.norm1"),
            "qkv": _lin(sd, f"{b}.attn.qkv"),
            "proj_attn": _lin(sd, f"{b}.attn.proj"),
            "norm2": _ln(sd, f"{b}.norm2"),
            "mlp": _mlp(sd, f"{b}.mlp", 2),
        }
        if f"{b}.proj.weight" in sd:
            blk["proj"] = _lin(sd, f"{b}.proj")
        blocks.append(blk)
    return {
        "patch_embed": _conv(sd, f"{prefix}patch_embed.proj"),
        "pos_embed": _t(sd[prefix + "pos_embed"]).permute(0, 2, 3, 1)
        .contiguous(),
        "pos_embed_window": _t(sd[prefix + "pos_embed_window"])
        .permute(0, 2, 3, 1).contiguous(),
        "blocks": blocks,
    }


def convert_image_encoder(sd: Mapping,
                          prefix: str = "image_encoder.") -> Dict:
    num_convs = 0
    while f"{prefix}neck.convs.{num_convs}.conv.weight" in sd:
        num_convs += 1
    return {
        "trunk": convert_hiera(sd, f"{prefix}trunk."),
        "neck": {"convs": [_conv(sd, f"{prefix}neck.convs.{i}.conv")
                           for i in range(num_convs)]},
    }


def convert_prompt_encoder(sd: Mapping,
                           prefix: str = "sam_prompt_encoder.") -> Dict:
    pts = [_t(sd[f"{prefix}point_embeddings.{i}.weight"])[0]
           for i in range(4)]
    return {
        "pe_layer": {"gaussian_matrix": _t(
            sd[f"{prefix}pe_layer.positional_encoding_gaussian_matrix"])},
        "point_embeddings": torch.stack(pts, dim=0),
        "not_a_point_embed": _t(sd[f"{prefix}not_a_point_embed.weight"]),
        "no_mask_embed": _t(sd[f"{prefix}no_mask_embed.weight"]),
        "mask_downscaling": {
            "conv1": _conv(sd, f"{prefix}mask_downscaling.0"),
            "ln1": _ln(sd, f"{prefix}mask_downscaling.1"),
            "conv2": _conv(sd, f"{prefix}mask_downscaling.3"),
            "ln2": _ln(sd, f"{prefix}mask_downscaling.4"),
            "conv3": _conv(sd, f"{prefix}mask_downscaling.6"),
        },
    }


def convert_mask_decoder(sd: Mapping, cfg,
                         prefix: str = "sam_mask_decoder.") -> Dict:
    num_mask_tokens = cfg.num_multimask_outputs + 1
    layers = []
    for i in range(cfg.twoway_depth):
        b = f"{prefix}transformer.layers.{i}"
        layers.append({
            "self_attn": _attn(sd, f"{b}.self_attn"),
            "norm1": _ln(sd, f"{b}.norm1"),
            "cross_attn_t2i": _attn(sd, f"{b}.cross_attn_token_to_image"),
            "norm2": _ln(sd, f"{b}.norm2"),
            "mlp": _mlp(sd, f"{b}.mlp", 2),
            "norm3": _ln(sd, f"{b}.norm3"),
            "norm4": _ln(sd, f"{b}.norm4"),
            "cross_attn_i2t": _attn(sd, f"{b}.cross_attn_image_to_token"),
        })
    p = {
        "transformer": {
            "layers": layers,
            "final_attn": _attn(
                sd, f"{prefix}transformer.final_attn_token_to_image"),
            "norm_final": _ln(sd, f"{prefix}transformer.norm_final_attn"),
        },
        "iou_token": _t(sd[f"{prefix}iou_token.weight"]),
        "mask_tokens": _t(sd[f"{prefix}mask_tokens.weight"]),
        "output_upscaling": {
            "dc1": _conv_t(sd, f"{prefix}output_upscaling.0"),
            "ln": _ln(sd, f"{prefix}output_upscaling.1"),
            "dc2": _conv_t(sd, f"{prefix}output_upscaling.3"),
        },
        "output_hypernetworks_mlps": [
            _mlp(sd, f"{prefix}output_hypernetworks_mlps.{i}", 3)
            for i in range(num_mask_tokens)
        ],
        "iou_prediction_head": _mlp(sd, f"{prefix}iou_prediction_head",
                                    cfg.iou_head_depth),
    }
    if f"{prefix}conv_s0.weight" in sd:
        p["conv_s0"] = _conv(sd, f"{prefix}conv_s0")
        p["conv_s1"] = _conv(sd, f"{prefix}conv_s1")
    if f"{prefix}obj_score_token.weight" in sd:
        p["obj_score_token"] = _t(sd[f"{prefix}obj_score_token.weight"])
        if f"{prefix}pred_obj_score_head.layers.0.weight" in sd:
            p["pred_obj_score_head"] = _mlp(
                sd, f"{prefix}pred_obj_score_head", 3)
        else:
            p["pred_obj_score_head"] = _lin(sd,
                                            f"{prefix}pred_obj_score_head")
    return p


def convert_memory_encoder(sd: Mapping,
                           prefix: str = "memory_encoder.") -> Dict:
    layers = []
    for i in range(4):
        base_i = 3 * i
        layers.append({
            "conv": _conv(sd, f"{prefix}mask_downsampler.encoder.{base_i}"),
            "ln": _ln(sd, f"{prefix}mask_downsampler.encoder.{base_i + 1}"),
        })
    p = {
        "mask_downsampler": {
            "layers": layers,
            "final": _conv(sd, f"{prefix}mask_downsampler.encoder.12"),
        },
        "pix_feat_proj": _conv(sd, f"{prefix}pix_feat_proj"),
        "fuser": {"layers": []},
    }
    i = 0
    while f"{prefix}fuser.layers.{i}.dwconv.weight" in sd:
        b = f"{prefix}fuser.layers.{i}"
        p["fuser"]["layers"].append({
            "dwconv": _conv(sd, f"{b}.dwconv"),
            "norm": _ln(sd, f"{b}.norm"),
            "pwconv1": _lin(sd, f"{b}.pwconv1"),
            "pwconv2": _lin(sd, f"{b}.pwconv2"),
            "gamma": _t(sd[f"{b}.gamma"]),
        })
        i += 1
    if f"{prefix}out_proj.weight" in sd:
        p["out_proj"] = _conv(sd, f"{prefix}out_proj")
    return p


def convert_memory_attention(sd: Mapping, cfg,
                             prefix: str = "memory_attention.") -> Dict:
    layers = []
    for i in range(cfg.memory_attention.num_layers):
        b = f"{prefix}layers.{i}"
        layers.append({
            "self_attn": _attn(sd, f"{b}.self_attn"),
            "cross_attn_image": _attn(sd, f"{b}.cross_attn_image"),
            "linear1": _lin(sd, f"{b}.linear1"),
            "linear2": _lin(sd, f"{b}.linear2"),
            "norm1": _ln(sd, f"{b}.norm1"),
            "norm2": _ln(sd, f"{b}.norm2"),
            "norm3": _ln(sd, f"{b}.norm3"),
        })
    return {"layers": layers, "norm": _ln(sd, f"{prefix}norm")}


def convert_sam2_base(sd: Mapping, cfg) -> Dict:
    """A whole SAM2Base state dict -> the JAX package's SAM2 tree. conv_s0
    / conv_s1 stay inside the mask decoder's params (the reference's
    layout); `models/sam2/base.forward_image` applies them."""
    p = {
        "image_encoder": convert_image_encoder(sd),
        "prompt_encoder": convert_prompt_encoder(sd),
        "mask_decoder": convert_mask_decoder(sd, cfg),
        "memory_attention": convert_memory_attention(sd, cfg),
        "memory_encoder": convert_memory_encoder(sd),
        "no_mem_embed": _t(sd["no_mem_embed"]),
        "no_mem_pos_enc": _t(sd["no_mem_pos_enc"]),
        "maskmem_tpos_enc": _t(sd["maskmem_tpos_enc"]),
    }
    if "mask_downsample.weight" in sd:
        p["mask_downsample"] = _conv(sd, "mask_downsample")
    if "obj_ptr_proj.layers.0.weight" in sd:
        p["obj_ptr_proj"] = _mlp(sd, "obj_ptr_proj", 3)
    elif "obj_ptr_proj.weight" in sd:
        p["obj_ptr_proj"] = _lin(sd, "obj_ptr_proj")
    if "obj_ptr_tpos_proj.weight" in sd:
        p["obj_ptr_tpos_proj"] = _lin(sd, "obj_ptr_tpos_proj")
    if "no_obj_ptr" in sd:
        p["no_obj_ptr"] = _t(sd["no_obj_ptr"])
    if "no_obj_embed_spatial" in sd:
        p["no_obj_embed_spatial"] = _t(sd["no_obj_embed_spatial"])
    return p
