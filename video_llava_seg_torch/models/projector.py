"""Multimodal projector (port of `video_llava_seg_tpu/models/projector.py`):
'linear' | 'mlp{N}x_gelu' | 'identity'. Plain denses (cuBLAS on the card),
as the JAX package leaves them to XLA."""

from __future__ import annotations

import re

import torch

from video_llava_seg_torch.ops import nn


def init(cfg, g, device, dtype):
    t = cfg.projector_type
    if t == "identity":
        return {"layers": []}
    if t == "linear":
        return {"layers": [nn.dense_init(g, cfg.mm_hidden_size,
                                         cfg.hidden_size, device, dtype)]}
    m = re.match(r"^mlp(\d+)x_gelu$", t)
    if not m:
        raise ValueError(f"Unknown projector type: {t}")
    layers = [nn.dense_init(g, cfg.mm_hidden_size, cfg.hidden_size, device,
                            dtype)]
    for _ in range(1, int(m.group(1))):
        layers.append(nn.dense_init(g, cfg.hidden_size, cfg.hidden_size,
                                    device, dtype))
    return {"layers": layers}


def apply(params, x):
    if not params.get("layers"):
        return x
    out = nn.dense(params["layers"][0], x)
    for layer in params["layers"][1:]:
        out = nn.dense(layer, nn.gelu(out))
    return out


def convert_torch(sd, cfg, prefix: str = "") -> dict:
    """Torch mm_projector state dict ('0.weight', '2.weight', ...)."""
    if cfg.projector_type == "identity":
        return {"layers": []}
    layers = []
    idx = 0
    while f"{prefix}{idx}.weight" in sd:
        layers.append({
            "kernel": torch.as_tensor(sd[f"{prefix}{idx}.weight"]).t()
            .contiguous(),
            "bias": torch.as_tensor(sd[f"{prefix}{idx}.bias"]),
        })
        idx += 2  # GELU between the linears
    return {"layers": layers}
