"""Image interpolation with torch `F.interpolate` semantics as matmuls
(port of `video_llava_seg_tpu/ops/resize.py`).

`_resize_matrix` is a numpy copy of the JAX package's weight-matrix
builder (bilinear / bicubic a=-0.75 / nearest, align_corners, torch-style
antialias), pinned to the original by `tests/test_torch_ops.py`; the
resize itself is `out = W_h @ x @ W_w^T` in fp32.

`pil_bicubic_matrix` builds the weights of PIL's antialiased bicubic
resample (a=-0.5), which CLIP preprocessing and SAM2's video frame loader
use; the card's machine has no PIL, so the port resizes those frames with
`pil_resize` (inference/utils.py, data/video_io.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch/OpenCV a=-0.75, PIL a=-0.5)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a,
                 0.0),
    )


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    return np.clip(1.0 - np.abs(x), 0.0, None)


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, method: str,
                   antialias: bool, align_corners: bool = False) -> np.ndarray:
    """[out_size, in_size] weight matrix for 1-D torch-style interpolation."""
    if method == "nearest":
        # torch legacy 'nearest': src = floor(dst * in/out)
        idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(
            np.int64)
        idx = np.clip(idx, 0, in_size - 1)
        m = np.zeros((out_size, in_size), np.float32)
        m[np.arange(out_size), idx] = 1.0
        return m

    if method == "bilinear":
        kernel, support = _linear_kernel, 1.0
    elif method == "bicubic":
        kernel, support = _cubic_kernel, 2.0
    else:
        raise ValueError(f"unknown method: {method}")

    scale = in_size / out_size
    m = np.zeros((out_size, in_size), np.float32)
    if antialias and scale > 1.0:
        for i in range(out_size):
            center = (i + 0.5) * scale
            supp = support * scale
            xmin = max(int(center - supp + 0.5), 0)
            xmax = min(int(center + supp + 0.5), in_size)
            j = np.arange(xmin, xmax)
            w = kernel((j - center + 0.5) / scale)
            s = w.sum()
            if s > 0:
                m[i, xmin:xmax] = w / s
        return m

    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        ac_scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = dst * ac_scale
    else:
        src = (dst + 0.5) * scale - 0.5
    radius = int(np.ceil(support)) + 1
    base = np.floor(src).astype(np.int64)
    offsets = np.arange(-radius + 1, radius + 1)
    idx = base[:, None] + offsets[None, :]
    dist = src[:, None] - idx
    w = kernel(dist)
    w = w / np.sum(w, axis=1, keepdims=True)
    idx = np.clip(idx, 0, in_size - 1)
    np.add.at(m, (np.repeat(np.arange(out_size), idx.shape[1]), idx.ravel()),
              w.ravel())
    return m


@functools.lru_cache(maxsize=64)
def pil_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of PIL's BICUBIC resample (a=-0.5, support
    stretched by the downscale factor, taps renormalised)."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    m = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        j = np.arange(xmin, xmax)
        w = _cubic_kernel((j - center + 0.5) / fscale, a=-0.5)
        s = w.sum()
        if s != 0:
            m[i, xmin:xmax] = w / s
    return m.astype(np.float32)


def _pil_pass(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """One PIL bicubic pass along `axis`, in float64, rounded and clipped
    to uint8 levels as PIL's 8-bit resample stores each pass."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    m = torch.from_numpy(pil_bicubic_matrix(in_size, out_size)).to(
        x.device, torch.float64)
    y = torch.movedim(torch.tensordot(x.double(), m, dims=([axis], [1])),
                      -1, axis)
    return torch.floor(y + 0.5).clamp_(0, 255).float()


def pil_resize(frames: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`PIL.Image.resize((w, h))` (BICUBIC, antialiased) of uint8 frames
    [..., H, W, C] on their device: the horizontal pass, then the
    vertical, each rounded to uint8 levels. Returns fp32 levels [..., h,
    w, C]. PIL runs in 22-bit fixed point, so a pixel may land one level
    away."""
    x = frames.float()
    x = _pil_pass(x, size[1], axis=x.dim() - 2)
    return _pil_pass(x, size[0], axis=x.dim() - 3)


@functools.lru_cache(maxsize=64)
def _matrix(in_size, out_size, method, antialias, align_corners, device):
    """`_resize_matrix` on `device`, copied from the host once per shape
    and device (an image resize to 1024^2 reads ~12 MB of them). Built
    outside inference mode: the SAM2 predictors run under
    `torch.inference_mode`, and a cached inference tensor would break
    every later autograd-recorded call at the shape (the tensordot saves
    it for backward)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_resize_matrix(
            in_size, out_size, method, antialias, align_corners)).to(device)


def _interp_axes(x: torch.Tensor, size: Tuple[int, int], method: str,
                 antialias: bool, h_axis: int, w_axis: int,
                 align_corners: bool = False) -> torch.Tensor:
    in_h, in_w = x.shape[h_axis], x.shape[w_axis]
    out_h, out_w = size
    if (in_h, in_w) == (out_h, out_w):
        return x
    xf = x.float()
    if in_h != out_h:
        mh = _matrix(in_h, out_h, method, antialias, align_corners, x.device)
        xf = torch.movedim(torch.tensordot(mh, xf, dims=([1], [h_axis])),
                           0, h_axis)
    if in_w != out_w:
        mw = _matrix(in_w, out_w, method, antialias, align_corners, x.device)
        xf = torch.movedim(torch.tensordot(xf, mw, dims=([w_axis], [1])),
                           -1, w_axis)
    return xf.to(x.dtype)


def interpolate(x, size, method: str = "bilinear", antialias: bool = False,
                align_corners: bool = False):
    """Resize [..., H, W, C] (NHWC)."""
    return _interp_axes(x, size, method, antialias, x.dim() - 3, x.dim() - 2,
                        align_corners)


def interpolate_hw(x, size, method: str = "bilinear",
                   antialias: bool = False):
    """Resize [..., H, W] (no channel dim, e.g. mask logits)."""
    return _interp_axes(x, size, method, antialias, x.dim() - 2, x.dim() - 1)
