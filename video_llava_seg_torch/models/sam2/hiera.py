"""Hiera hierarchical ViT trunk (port of
`video_llava_seg_tpu/models/sam2/hiera.py`).

With `USE_FUSED_BLOCK` (the default) every block, windowed or global,
runs through `ops.hiera_block.hiera_block` (K4); the JAX package's
Mosaic legality gate (`hiera_block_supported`) has no counterpart, so
no block falls out of it. With `USE_FUSED_BLOCK = False` the blocks take
the JAX package's per-op path: LN1, the dim-change shortcut, then

- windowed blocks: the post-norm map zero-padded to window multiples,
  the qkv dense on the map, `ops.window_attention.window_attention` (K7;
  the 2x2 q pool inside it), the crop and the out projection;
- global blocks: `_attention` over the whole map (`ops.attention`, K2 /
  K3 on the card, for 256 queries or more; the plain twin below, as the
  JAX package picks XLA there), Hiera-B+'s head dim 56 and Hiera-L's 72
  zero-padded to the next head dim a kernel has, as K4's
  `attention_stage` pads them;

then the residual and the LN2 -> GELU MLP. The switch is a module
attribute, as in the JAX package. The JAX package's partition-based
window path (`USE_FUSED_WINDOW_ATTN = False`) has no counterpart: the
fused window path computes the same function."""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.attention import attention
from video_llava_seg_torch.ops.hiera_block import (
    attention_head_dim,
    hiera_block,
    max_pool_2x2,
)
from video_llava_seg_torch.ops.resize import interpolate
from video_llava_seg_torch.ops.window_attention import window_attention

_LN_EPS = 1e-6  # hieradet norm_layer = partial(LayerNorm, eps=1e-6)

USE_FUSED_BLOCK = True


def block_dims(cfg):
    """Per-block (dim_in, dim_out, num_heads, window_size, has_q_pool).
    A stage's first block keeps the previous stage's window (hieradet)."""
    dims = []
    embed_dim, num_heads = cfg.embed_dim, cfg.num_heads
    cur_stage = 1
    stage_ends = set(cfg.stage_ends)
    q_pool_blocks = set(cfg.q_pool_blocks)
    for i in range(cfg.depth):
        dim_out = embed_dim
        window_size = cfg.window_spec[cur_stage - 1]
        if i in cfg.global_att_blocks:
            window_size = 0
        if i - 1 in stage_ends:
            dim_out = int(embed_dim * cfg.dim_mul)
            num_heads = int(num_heads * cfg.head_mul)
            cur_stage += 1
        dims.append((embed_dim, dim_out, num_heads, window_size,
                     i in q_pool_blocks))
        embed_dim = dim_out
    return dims


def init(cfg, g, device, dtype):
    p = {
        "patch_embed": nn.conv2d_init(
            g, 3, cfg.embed_dim, (cfg.patch_kernel, cfg.patch_kernel),
            device, dtype),
        "pos_embed": torch.zeros(
            (1, *cfg.window_pos_embed_bkg_spatial_size, cfg.embed_dim),
            device=device, dtype=dtype),
        "pos_embed_window": torch.zeros(
            (1, cfg.window_spec[0], cfg.window_spec[0], cfg.embed_dim),
            device=device, dtype=dtype),
        "blocks": [],
    }
    for din, dout, _, _, _ in block_dims(cfg):
        blk = {
            "norm1": nn.layer_norm_init(din, device, dtype),
            "qkv": nn.dense_init(g, din, dout * 3, device, dtype),
            "proj_attn": nn.dense_init(g, dout, dout, device, dtype),
            "norm2": nn.layer_norm_init(dout, device, dtype),
            "mlp": nn.mlp_init(g, [dout, int(dout * cfg.mlp_ratio), dout],
                               device, dtype),
        }
        if din != dout:
            blk["proj"] = nn.dense_init(g, din, dout, device, dtype)
        p["blocks"].append(blk)
    return p


def get_pos_embed(params, hw):
    """Bicubic-resized background PE + tiled window PE."""
    h, w = hw
    bkg = interpolate(params["pos_embed"], (h, w), "bicubic")
    win = params["pos_embed_window"]
    wh, ww = win.shape[1], win.shape[2]
    return bkg + win.repeat(1, h // wh, w // ww, 1)


def _attention_fused_windows(blk, x, num_heads: int, ws: int,
                             q_stride: Optional[Tuple[int, int]]):
    """qkv dense on the map, K7, crop, out projection. A map the window
    does not divide is zero-padded BEFORE the qkv dense, so pad tokens
    carry the qkv bias as keys (the reference's window partition pads
    the post-norm map); the output is cropped at pooled resolution."""
    b, h, w, _ = x.shape
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    qkv = nn.dense(blk["qkv"], x)                  # [B, Hp, Wp, 3*dout]
    o = window_attention(qkv, num_heads=num_heads, ws=ws, q_pool=q_stride)
    ps = q_stride[0] if q_stride is not None else 1
    oh, ow = h // ps, w // ps
    if o.shape[1] != oh or o.shape[2] != ow:
        o = o[:, :oh, :ow]
    return nn.dense(blk["proj_attn"], o)


def _attention(blk, x, num_heads: int,
               q_stride: Optional[Tuple[int, int]]):
    """MultiScaleAttention: qkv -> optional q max-pool -> SDPA -> proj."""
    b, h, w, _ = x.shape
    qkv = nn.dense(blk["qkv"], x.reshape(b, h * w, -1))
    dout = qkv.shape[-1] // 3
    head_dim = dout // num_heads
    qkv = qkv.reshape(b, h * w, 3, num_heads, head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    oh, ow = h, w
    if q_stride is not None:
        q = max_pool_2x2(q.reshape(b, h, w, -1))
        oh, ow = q.shape[1], q.shape[2]
        q = q.reshape(b, oh * ow, num_heads, head_dim)
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    backend = "auto" if q.shape[2] >= 256 else "plain"
    # zero columns add nothing to q . k and give zero outputs; the scale
    # stays the true head dim's
    pad = attention_head_dim(head_dim) - head_dim if backend == "auto" else 0
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    o = attention(q, k, v, scale=1.0 / math.sqrt(head_dim), backend=backend)
    if pad:
        o = o[..., :head_dim]
    o = o.permute(0, 2, 1, 3).reshape(b, oh, ow, dout)
    return nn.dense(blk["proj_attn"], o)


def _block_per_op(blk, x, *, din: int, dout: int, heads: int, ws: int,
                  q_stride: Optional[Tuple[int, int]]):
    shortcut = x
    xn = nn.layer_norm(blk["norm1"], x, _LN_EPS)
    if din != dout:
        shortcut = nn.dense(blk["proj"], xn)
        if q_stride is not None:
            shortcut = max_pool_2x2(shortcut)
    if ws > 0:
        xw = _attention_fused_windows(blk, xn, heads, ws, q_stride)
    else:
        xw = _attention(blk, xn, heads, q_stride)
    x = shortcut + xw
    return x + nn.mlp_apply(blk["mlp"],
                            nn.layer_norm(blk["norm2"], x, _LN_EPS),
                            act=nn.gelu)


def apply(params, cfg, x: torch.Tensor) -> List[torch.Tensor]:
    """x: NHWC [B, H, W, 3]. Returns the per-stage pyramid, highest
    resolution first."""
    x = nn.conv2d(params["patch_embed"], x,
                  stride=(cfg.patch_stride, cfg.patch_stride),
                  padding=[(cfg.patch_padding, cfg.patch_padding)] * 2)
    x = x + get_pos_embed(params, (x.shape[1], x.shape[2])).to(x.dtype)
    outputs = []
    stage_ends = set(cfg.stage_ends)
    for i, (blk, (din, dout, heads, ws, has_pool)) in enumerate(
            zip(params["blocks"], block_dims(cfg))):
        q_stride = cfg.q_stride if has_pool else None
        if USE_FUSED_BLOCK:
            x = hiera_block(blk, x, num_heads=heads, ws=ws,
                            q_stride=q_stride, eps=_LN_EPS)
        else:
            x = _block_per_op(blk, x, din=din, dout=dout, heads=heads,
                              ws=ws, q_stride=q_stride)
        if i in stage_ends:
            outputs.append(x)
    return outputs
