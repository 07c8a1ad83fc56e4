"""HF CLIPVisionModel state dict -> the port's ViT tree (port of
`video_llava_seg_tpu/convert/hf_clip.py`)."""

from __future__ import annotations

import torch


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


def convert_clip_vision(sd, num_layers: int,
                        prefix: str = "vision_model.") -> dict:
    """Keys as in transformers.CLIPVisionModel."""
    p = {
        "patch_embedding": {"kernel": _t(
            sd[f"{prefix}embeddings.patch_embedding.weight"]).permute(
            2, 3, 1, 0).contiguous()},
        "class_embedding": _t(sd[f"{prefix}embeddings.class_embedding"]),
        "position_embedding": _t(
            sd[f"{prefix}embeddings.position_embedding.weight"]),
        "pre_layrnorm": _ln(sd, f"{prefix}pre_layrnorm"),
        "post_layernorm": _ln(sd, f"{prefix}post_layernorm"),
        "layers": [],
    }
    for i in range(num_layers):
        b = f"{prefix}encoder.layers.{i}"
        p["layers"].append({
            "layer_norm1": _ln(sd, f"{b}.layer_norm1"),
            "q_proj": _lin(sd, f"{b}.self_attn.q_proj"),
            "k_proj": _lin(sd, f"{b}.self_attn.k_proj"),
            "v_proj": _lin(sd, f"{b}.self_attn.v_proj"),
            "out_proj": _lin(sd, f"{b}.self_attn.out_proj"),
            "layer_norm2": _ln(sd, f"{b}.layer_norm2"),
            "fc1": _lin(sd, f"{b}.mlp.fc1"),
            "fc2": _lin(sd, f"{b}.mlp.fc2"),
        })
    return p
