"""1-D Llama RoPE, half-split rotate (port of the 1-D half of
`video_llava_seg_tpu/ops/rope.py`). The 2-D axial RoPE belongs to SAM2
memory attention, which is off the serving slice (ROADMAP queue 1: the
SAM2 memory and video predictor)."""

from __future__ import annotations

import torch


def rope_1d_cos_sin(positions: torch.Tensor, head_dim: int,
                    theta: float = 500000.0):
    """cos/sin [..., seq, head_dim] (fp32) for the given position ids."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    ang = positions[..., None].float() * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_1d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [..., H, S, D]; cos/sin: [..., S, D], broadcast over heads."""
    if cos.dim() == x.dim() - 1:
        cos = cos.unsqueeze(-3)
        sin = sin.unsqueeze(-3)
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)
