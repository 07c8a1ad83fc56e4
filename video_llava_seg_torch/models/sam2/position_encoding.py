"""SAM2 position encodings (port of
`video_llava_seg_tpu/models/sam2/position_encoding.py`): the sine grid of
the FPN neck and the memory, the 1-D sine encoding of the object
pointers' temporal positions, and the random-Fourier encodings of the
prompt encoder (its dense grid and its point prompts)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def sine_pos_embed_hw(h: int, w: int, num_pos_feats: int,
                      temperature: int = 10000,
                      normalize: bool = True) -> np.ndarray:
    """[H, W, C] sine embedding, channels concat(pos_y, pos_x) (numpy copy
    of the JAX package's table)."""
    npf = num_pos_feats // 2
    scale = 2 * math.pi
    y = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x = np.arange(1, w + 1, dtype=np.float64)[None, :] * np.ones((h, 1))
    if normalize:
        eps = 1e-6
        y = y / (y[-1:, :] + eps) * scale
        x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(npf, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / npf)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])],
                  axis=3).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])],
                  axis=3).reshape(h, w, -1)
    return np.concatenate([py, px], axis=2).astype(np.float32)


@functools.lru_cache(maxsize=16)
def sine_pos_embed_on(h: int, w: int, num_pos_feats: int, temperature: int,
                      device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`sine_pos_embed_hw` as a tensor on `device` in `dtype`, copied from
    the host once per (shape, device, dtype): the FPN neck asks for four of
    them on every encode (~85 MiB in fp32 at 1024^2). Built outside
    inference mode, so that a predictor's first call (under
    `torch.inference_mode`) caches no inference tensor for a later
    autograd-recorded call."""
    with torch.inference_mode(False):
        return torch.from_numpy(sine_pos_embed_hw(
            h, w, num_pos_feats, temperature)).to(device, dtype)


def sine_pos_embed_1d(pos: torch.Tensor, dim: int,
                      temperature: int = 10000) -> torch.Tensor:
    """get_1d_sine_pe (the reference's sam2/modeling/sam2_utils.py:64-74):
    pos [...] -> fp32 [..., dim], the sines of all frequencies, then
    their cosines."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * (dim_t // 2) / pe_dim)
    pos_embed = pos.float()[..., None] / dim_t
    return torch.cat([torch.sin(pos_embed), torch.cos(pos_embed)], dim=-1)


def random_pe_init(g, num_pos_feats: int, device, scale: float = 1.0):
    return {"gaussian_matrix": scale * torch.randn(
        (2, num_pos_feats), generator=g, device=device, dtype=torch.float32)}


def random_pe_encode(params, coords: torch.Tensor) -> torch.Tensor:
    """coords in [0, 1]^2, [..., 2] -> [..., 2 * num_pos_feats] (fp32)."""
    c = 2.0 * coords.float() - 1.0
    c = c @ params["gaussian_matrix"].float()
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def random_pe_grid(params, size, device) -> torch.Tensor:
    """Dense PE grid [H, W, C]."""
    h, w = size
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return random_pe_encode(params, torch.stack([gx, gy], dim=-1))


def random_pe_coords(params, coords: torch.Tensor, image_size) -> torch.Tensor:
    """Absolute pixel coords [..., 2] (x, y) -> PE, normalised by the image
    size (h, w)."""
    h, w = image_size
    scale = torch.tensor([w, h], dtype=torch.float32, device=coords.device)
    return random_pe_encode(params, coords.float() / scale)
