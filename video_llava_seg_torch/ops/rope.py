"""Rotary position embeddings (port of `video_llava_seg_tpu/ops/rope.py`):
the 1-D Llama RoPE (half-split rotate) and the 2-D axial RoPE of SAM2's
memory attention (interleaved (even, odd) channel pairs; the reference's
sam2/modeling/position_encoding.py:168-222)."""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# 2-D axial RoPE (SAM2 memory attention)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def axial_rope_cos_sin(dim: int, end_x: int, end_y: int,
                       theta: float = 10000.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables [end_x * end_y, dim // 2] (numpy copy of the JAX
    package's): the first dim // 4 rotary pairs carry x-position
    frequencies, the next dim // 4 y-position ones; tokens row-major over
    (y, x)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4)[: dim // 4].astype(
        np.float64) / dim))
    t = np.arange(end_x * end_y, dtype=np.float64)
    ang = np.concatenate([np.outer(t % end_x, freqs),
                          np.outer(np.floor(t / end_x), freqs)], axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=32)
def axial_rope_on(dim: int, end_x: int, end_y: int, theta: float,
                  repeat: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`axial_rope_cos_sin` tiled `repeat` times along the tokens (memory
    keys: stacked frames of one grid), fp32 on `device`, copied from the
    host once per (grid, dim, repeat, device): memory attention asks for
    them in every layer of every tracked frame. Built outside inference
    mode, so that the video predictor (under `torch.inference_mode`)
    caches no inference tensor for a later autograd-recorded call."""
    cos, sin = axial_rope_cos_sin(dim, end_x, end_y, theta)
    with torch.inference_mode(False):
        return (torch.from_numpy(np.tile(cos, (repeat, 1))).to(device),
                torch.from_numpy(np.tile(sin, (repeat, 1))).to(device))


def _rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate interleaved (even, odd) channel pairs of x [..., N, D] by
    angles cos/sin [N, D / 2], in fp32; x's dtype out."""
    xf = x.float()
    x2 = xf.reshape(*xf.shape[:-1], -1, 2)
    xe, xo = x2[..., 0], x2[..., 1]
    out = torch.stack([xe * cos - xo * sin, xe * sin + xo * cos], dim=-1)
    return out.reshape(xf.shape).to(x.dtype)


def apply_axial_rope(q: torch.Tensor, k: torch.Tensor, end_x: int,
                     end_y: int, theta: float = 10000.0,
                     repeat_freqs_k: bool = False, num_k_exclude: int = 0):
    """Axial RoPE on q [..., Nq, D] and k [..., Nk, D]. Nq is end_x *
    end_y; Nk beyond Nq needs repeat_freqs_k (the memory's keys are
    stacked frames of the query grid). The trailing `num_k_exclude` keys
    (object pointers) stay unrotated."""
    d, nq = q.shape[-1], q.shape[-2]
    if nq != end_x * end_y:
        raise ValueError(f"axial RoPE: {nq} queries on a {end_x} x {end_y} "
                         "grid")
    cos, sin = axial_rope_on(d, end_x, end_y, float(theta), 1, q.device)
    q_out = _rotate_pairs(q, cos, sin)
    nk_rope = k.shape[-2] - num_k_exclude
    if nk_rope == 0:
        return q_out, k
    if nk_rope != nq and not (repeat_freqs_k and nk_rope % nq == 0):
        raise ValueError(f"axial RoPE: {nk_rope} rotated keys over {nq} "
                         "queries need repeat_freqs_k and a multiple")
    cos_k, sin_k = axial_rope_on(d, end_x, end_y, float(theta),
                                 nk_rope // nq, q.device)
    k_out = _rotate_pairs(k[..., :nk_rope, :], cos_k, sin_k)
    if num_k_exclude > 0:
        k_out = torch.cat([k_out, k[..., nk_rope:, :]], dim=-2)
    return q_out, k_out
