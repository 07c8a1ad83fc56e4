"""NVIDIA RADIO checkpoint -> the port's ViT tree (port of
`video_llava_seg_tpu/convert/radio.py`).

RADIO's trunk is a timm VisionTransformer (ViT-H/16 for nvidia/RADIO)
behind a ViTPatchGenerator:

  radio_model.model.patch_generator.embedder.{weight,bias}  Linear(3*p*p, d)
  radio_model.model.patch_generator.pos_embed               [1, N, d]
  radio_model.model.patch_generator.cls_token.token         [1, K, d]
  radio_model.model.blocks.{i}.norm1|attn.qkv|attn.proj|norm2|mlp.fc1|mlp.fc2
  radio_model.model.norm.{weight,bias}                      final LayerNorm
  radio_model.input_conditioner.norm_{mean,std}             input statistics

The reference's load-time adaptations are kept: a bicubic
align_corners=True interpolation of the patch embedder when the
checkpoint's patch size differs, and of the position table when its
token grid differs (`ops/resize.interpolate`, fp32).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from video_llava_seg_torch.ops.resize import interpolate


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


def _lin(sd, prefix):
    p = {"kernel": _t(sd[f"{prefix}.weight"]).t().contiguous()}
    if f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


def _ln(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"])}


def _split_qkv(sd, prefix, d):
    """timm's fused qkv Linear(d, 3d) -> q / k / v dense params."""
    w = _t(sd[f"{prefix}.weight"])                 # [3d, d]
    b = sd.get(f"{prefix}.bias")
    out = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        p = {"kernel": w[i * d:(i + 1) * d].t().contiguous()}
        if b is not None:
            p["bias"] = _t(b)[i * d:(i + 1) * d].clone()
        out[name] = p
    return out


def _convert_embedder(sd, cfg):
    """ViTPatchLinear -> conv kernel [p, p, 3, d] (HWIO), interpolated when
    the checkpoint's patch size differs."""
    w = _t(sd["patch_generator.embedder.weight"])  # [d, 3*ps*ps]
    d = w.shape[0]
    src_p = int(math.sqrt(w.shape[1] // 3))
    if src_p * src_p * 3 != w.shape[1]:
        raise ValueError(f"RADIO embedder of shape {tuple(w.shape)} is not "
                         "a square RGB patch")
    k = w.reshape(d, 3, src_p, src_p).permute(2, 3, 1, 0)  # (c h w) order
    if src_p != cfg.patch_size:
        k = interpolate(k.reshape(src_p, src_p, 3 * d),
                        (cfg.patch_size, cfg.patch_size), "bicubic",
                        align_corners=True).reshape(
            cfg.patch_size, cfg.patch_size, 3, d)
    p = {"kernel": k.contiguous()}
    if "patch_generator.embedder.bias" in sd:
        p["bias"] = _t(sd["patch_generator.embedder.bias"])
    return p


def _convert_pos_embed(sd, cfg):
    """[1, N, d] absolute table -> [num_patches, d], resized to the
    configured grid when the sizes differ."""
    pe = _t(sd["patch_generator.pos_embed"])[0]    # [N, d]
    n_src = int(math.sqrt(pe.shape[0]))
    if n_src * n_src != pe.shape[0]:
        raise ValueError(f"RADIO position table of {pe.shape[0]} rows is "
                         "not a square grid")
    n_dst = cfg.num_patches_per_side
    if n_src != n_dst:
        grid = interpolate(pe.reshape(n_src, n_src, -1), (n_dst, n_dst),
                           "bicubic", align_corners=True)
        return grid.reshape(n_dst * n_dst, -1)
    return pe.contiguous()


def convert_radio(sd: Dict[str, torch.Tensor], cfg,
                  prefix: str = "radio_model.") -> dict:
    """Convert a RADIO state dict (keys relative to the RADIOVisionTower's
    `vision_tower` module, i.e. starting with `radio_model.`)."""
    model_sd = {k[len(prefix) + len("model."):]: v for k, v in sd.items()
                if k.startswith(prefix + "model.")}
    d = cfg.hidden_size
    p = {
        "patch_embedding": _convert_embedder(model_sd, cfg),
        "position_embedding": _convert_pos_embed(model_sd, cfg),
        # unused by RADIO (no pre-norm); kept so the tree has init()'s keys
        "pre_layrnorm": {"scale": torch.ones(d), "bias": torch.zeros(d)},
        "post_layernorm": _ln(model_sd, "norm"),
        "layers": [],
    }
    cls_key = "patch_generator.cls_token.token"
    if cls_key in model_sd:
        tok = _t(model_sd[cls_key])[0]             # [K, d]
        if tok.shape[0] != cfg.num_register_tokens:
            raise ValueError(
                f"checkpoint has {tok.shape[0]} cls/register tokens, the "
                f"config expects {cfg.num_register_tokens}")
        p["register_tokens"] = tok.contiguous()
    mean_key = f"{prefix}input_conditioner.norm_mean"
    std_key = f"{prefix}input_conditioner.norm_std"
    if mean_key in sd:
        p["input_conditioner"] = {"mean": _t(sd[mean_key]).reshape(3),
                                  "std": _t(sd[std_key]).reshape(3)}
    else:
        p["input_conditioner"] = {"mean": torch.zeros(3),
                                  "std": torch.ones(3)}
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        layer = {
            "layer_norm1": _ln(model_sd, f"{b}.norm1"),
            "layer_norm2": _ln(model_sd, f"{b}.norm2"),
            "out_proj": _lin(model_sd, f"{b}.attn.proj"),
            "fc1": _lin(model_sd, f"{b}.mlp.fc1"),
            "fc2": _lin(model_sd, f"{b}.mlp.fc2"),
        }
        layer.update(_split_qkv(model_sd, f"{b}.attn.qkv", d))
        p["layers"].append(layer)
    return p
