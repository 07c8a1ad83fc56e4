"""Windowed multi-head attention over a fused-qkv NHWC map, port of
`video_llava_seg_tpu/ops/window_attention.py` (`_win_kernel`, K7).

Layout contract, as in the JAX package: `qkv` is the fused qkv dense of
a [B, H, W, C] token map, [B, H, W, 3C] with the last axis [q | k | v]
and each of them heads-major ([num_heads, head_dim]). H and W are
multiples of the window side (callers zero-pad the pre-qkv map and crop
the output). With `q_pool=(2, 2)` the queries are 2x2 max-pooled per
window (Hiera's stage transitions) and the output is the pooled map
[B, H/2, W/2, C].

On a CUDA tensor `window_attention` launches the C entry
`kernels.window_entry` names. At head dims 96, 56 and 72 (every windowed
block of Hiera-T / S / B+ / L) that is `csrc/window_attention_sm90.cu`:
a persistent grid whose producer thread loads each strip of windows'
q / k / v by TMA straight from the map, consumer warpgroups that pool q
while staging it and run both products on wgmma with all of a window's
keys (up to 256) in one tile, the output written in map layout. K4's
chain (`ops/hiera_block.py`) calls the same kernel for its windowed
blocks. Other head dims and strips past a head dim's key tile take
`csrc/window_attention.cu`: one block per 64 queries of an (image,
window, head), rows gathered through the map's strides. Neither makes a
partitioned or pooled copy. On a CPU tensor it runs
`window_attention_plain` (the twin of `window_attention_xla`). The JAX
package's tile picker and Mosaic legality gate have no counterpart here.
When autograd records the call, the kernel runs inside
`ops.recompute.recompute` and the backward recomputes through the plain
version (the JAX package's `_wa_bwd`)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.ops.recompute import needs_grad, recompute


def window_attention_plain(qkv, *, num_heads: int, ws: int, scale: float,
                           ps: int = 1):
    """Windowed SDPA over a fused-qkv NHWC map [B, H, W, 3C] (H, W
    multiples of ws); ps > 1 max-pools q 2x2 per window."""
    b, h, w, c3 = qkv.shape
    if c3 % 3 or (c3 // 3) % num_heads:
        raise ValueError(f"window_attention: {c3} channels do not split "
                         f"into q, k, v of {num_heads} heads")
    if h % ws or w % ws or ws % ps:
        raise ValueError(f"window_attention: ws {ws} must divide the "
                         f"{h}x{w} map and be divided by the q pool {ps}")
    c = c3 // 3
    hd = c // num_heads
    n_w, n_wr = w // ws, h // ws
    q_ws = ws // ps
    x = qkv.reshape(b, n_wr, ws, n_w, ws, 3, num_heads, hd)
    x = x.permute(0, 1, 3, 5, 6, 2, 4, 7)
    x = x.reshape(b * n_wr * n_w, 3, num_heads, ws, ws, hd)
    q, k, v = x[:, 0], x[:, 1], x[:, 2]
    if ps > 1:
        q = q.reshape(-1, num_heads, q_ws, ps, q_ws, ps, hd).amax(dim=(3, 5))
    q = q.reshape(-1, num_heads, q_ws * q_ws, hd)
    k = k.reshape(-1, num_heads, ws * ws, hd)
    v = v.reshape(-1, num_heads, ws * ws, hd)
    s = torch.einsum("whid,whjd->whij", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("whij,whjd->whid", p.float(), v.float()).to(qkv.dtype)
    o = o.reshape(b, n_wr, n_w, num_heads, q_ws, q_ws, hd)
    o = o.permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(b, h // ps, w // ps, c)


def window_attention(qkv, *, num_heads: int, ws: int,
                     scale: Optional[float] = None,
                     q_pool: Optional[Tuple[int, int]] = None):
    """K7 on CUDA, `window_attention_plain` on the CPU; each checks the
    shapes it takes.

    qkv: [B, H, W, 3C] (layout contract above). Returns [B, H, W, C], or
    [B, H/ps, W/ps, C] with q_pool=(ps, ps)."""
    ps = 1
    if q_pool is not None:
        if q_pool[0] != q_pool[1]:
            raise ValueError(f"window_attention: q_pool {q_pool} must be "
                             "square")
        ps = q_pool[0]
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1] // 3 // num_heads)
    kw = dict(num_heads=num_heads, ws=ws, scale=scale, ps=ps)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, **kw)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device "
                         f"{qkv.device}")

    def kernel(_, t):
        kernels.LAUNCHES.add("K7")
        return kernels.window_attention(t.contiguous(), **kw)

    if needs_grad({}, qkv):
        return recompute(kernel,
                         lambda _, t: window_attention_plain(t, **kw), {},
                         qkv)
    return kernel(None, qkv)
