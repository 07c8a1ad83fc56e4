"""One Hiera MultiScaleBlock, port of `video_llava_seg_tpu/ops/hiera_block.py`
(`_block_kernel` + `_mlp_tail`, K4).

LN1 -> [dim-change shortcut projection] -> [2x2 max-pool of the shortcut]
-> post-norm zero padding to window multiples -> fused qkv dense ->
windowed SDPA (optional 2x2 max-pool of q per window) or global SDPA ->
crop -> proj + residual -> LN2 -> erf-GELU MLP + residual.

The TPU kernel runs the whole block in one launch with its weights in
VMEM. On CUDA the block is a chain of the port's hand-written kernels
with the same math:

  layernorm_sm90.cu -> [gemm_bf16_sm90.cu shortcut proj] ->
  [pool_sm90.cu] -> gemm_bf16_sm90.cu (qkv) -> attention ->
  gemm_bf16_sm90.cu (proj + bias + residual) -> layernorm_sm90.cu ->
  gemm_bf16_sm90.cu (fc1 + bias + erf-GELU) -> gemm_bf16_sm90.cu (fc2 +
  bias + residual)

(the LayerNorms and the pool on the entries `kernels.layernorm_entry` /
`kernels.maxpool_entry` name: the sm90 row streams at every width of
Hiera-T / S / B+ / L, layernorm.cu / pool.cu for the shapes they refuse)

The attention of a windowed block is one `kernels.window_attention`
launch on the padded fused-qkv map as it lies, which pools q while
loading and writes the cropped (pooled) map: window_attention_sm90.cu at
head dims 96, 56 and 72 (every windowed block of Hiera-T / S / B+ / L),
window_attention.cu where `kernels.window_entry` sends a call there
(other head dims). A global block keeps `attention_stage`: attention_sm90.cu
over the whole map as one window, with no copy at head dim 96
(Hiera-T / S); at Hiera-B+'s 56 and Hiera-L's 72, which no attention
kernel has, q, k and v are zero-padded to the next instance (64 / 80,
`attention_head_dim`) and the output cropped: zero columns add nothing
to q . k, V's zero columns give zero outputs, and the scale stays
1 / sqrt(true head dim).

Between launches only layout work in torch: the zero pad of the
post-norm map, and strided q/k/v views of a global block's fused qkv.

Kept from the TPU kernel: the post-norm zero padding of maps a window
does not divide (ws=14 on the 64x64 stage-3 map pads to 70), which is
semantics. Dropped: the Mosaic legality gate (`hiera_block_supported`)
and the gap-padded storage of odd windows, which a CUDA kernel does not
need.

`hiera_block_plain` is the plain PyTorch version (the twin of
`hiera_block_xla` + `window_attention_xla`, the latter's twin
`window_attention_plain` living in `ops/window_attention.py`); the CPU
path runs it.

When autograd records the call (training), the kernel chain runs inside
`ops.recompute.recompute`: weights cast to the input's dtype for the
launches, only x and the weights saved, and the backward recomputed
through `hiera_block_plain` (the JAX package's `_hb_bwd`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from video_llava_seg_torch import kernels
from video_llava_seg_torch.bridge import tree_map
from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.recompute import needs_grad, recompute
from video_llava_seg_torch.ops.window_attention import window_attention_plain


def max_pool_2x2(x):
    """NHWC max pool, kernel == stride == 2 (hieradet do_pool), VALID:
    an odd edge row or column is dropped."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def hiera_block_plain(blk, x, *, num_heads: int, ws: int,
                      q_stride: Optional[Tuple[int, int]], eps: float):
    """Plain PyTorch block with the TPU kernel's semantics."""
    ps = q_stride[0] if q_stride is not None else 1
    b, h, w, _ = x.shape
    xn = nn.layer_norm(blk["norm1"], x, eps)
    shortcut = nn.dense(blk["proj"], xn) if "proj" in blk else x
    if ps > 1:
        shortcut = max_pool_2x2(shortcut)
    if ws == 0:
        if w != h or ps != 1:
            raise ValueError("global Hiera blocks take square unpooled maps")
        ws = h
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    if pad_h or pad_w:
        # POST-norm zero padding (hieradet window_partition)
        xn = F.pad(xn, (0, 0, 0, pad_w, 0, pad_h))
    qkv = nn.dense(blk["qkv"], xn)
    hd = (qkv.shape[-1] // 3) // num_heads
    o = window_attention_plain(qkv, num_heads=num_heads, ws=ws,
                               scale=1.0 / math.sqrt(hd), ps=ps)
    o = o[:, :h // ps, :w // ps]
    h1 = shortcut + nn.dense(blk["proj_attn"], o)
    return h1 + nn.mlp_apply(blk["mlp"], nn.layer_norm(blk["norm2"], h1, eps),
                             act=nn.gelu)


def attention_head_dim(hd: int) -> int:
    """The head dim `attention_stage` hands `kernels.attention` for a true
    head dim hd: hd itself where a kernel has it, else the next head dim
    of attention_sm90.cu (Hiera-B+'s 56 -> 64, Hiera-L's 72 -> 80)."""
    if hd in kernels.ATTENTION_HEAD_DIMS or hd in kernels.FLASH_SM90_HEAD_DIMS:
        return hd
    above = [d for d in kernels.FLASH_SM90_HEAD_DIMS if d > hd]
    if not above:
        raise ValueError(f"attention_stage: no attention kernel above head "
                         f"dim {hd}")
    return min(above)


def attention_stage(qkv, *, num_heads: int, ws: int, ps: int):
    """Attention over ws x ws windows by `kernels.attention` on a
    contiguous fused-qkv map [B, Hp, Wp, 3C] (Hp, Wp multiples of ws):
    window partition (one copy, none for a single window), [a 2x2 max
    pool of q], one window per batch row, and the unpartition of its [window,
    token, head, hd] output into the (pooled) map [B, Hp/ps, Wp/ps, C],
    possibly a view. The chain runs it for global blocks (ws = the map's
    side, ps = 1); chip_smoke times it at the windowed kinds, which the
    chain ran through it before window_attention_sm90.cu. A head dim no
    kernel has is zero-padded to `attention_head_dim`'s and the output
    cropped back."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    n_wr, n_w = hp // ws, wp // ws
    nwin = b * n_wr * n_w
    if n_wr * n_w == 1:
        win = qkv.view(b, ws, ws, c3)
    else:
        win = qkv.view(b, n_wr, ws, n_w, ws, c3).permute(
            0, 1, 3, 2, 4, 5).contiguous().view(nwin, ws, ws, c3)
    q_ws = ws // ps
    if ps > 1:
        q = kernels.maxpool2x2(win[..., :c].contiguous())
        q = q.view(nwin, q_ws * q_ws, num_heads, hd)
    else:
        q = win[..., :c].reshape(nwin, ws * ws, num_heads, hd)
    k = win[..., c:2 * c].reshape(nwin, ws * ws, num_heads, hd)
    v = win[..., 2 * c:].reshape(nwin, ws * ws, num_heads, hd)
    pad = attention_head_dim(hd) - hd
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    o = kernels.attention(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                          v.permute(0, 2, 1, 3), scale=1.0 / math.sqrt(hd))
    if pad:
        o = o[..., :hd]
    # [nwin, q_ws*q_ws, heads, hd] storage -> pooled map
    o = o.permute(0, 2, 1, 3).reshape(b, n_wr, n_w, q_ws, q_ws, c)
    return o.permute(0, 1, 3, 2, 4, 5).reshape(b, n_wr * q_ws, n_w * q_ws, c)


def _hiera_block_cuda(blk, x, *, num_heads: int, ws: int, ps: int,
                      eps: float):
    b, h, w, cin = x.shape
    xn = kernels.layernorm(x, blk["norm1"]["scale"], blk["norm1"]["bias"],
                           eps)
    if "proj" in blk:
        c = blk["proj"]["kernel"].shape[1]
        shortcut = kernels.gemm(xn.view(-1, cin), blk["proj"]["kernel"],
                                blk["proj"]["bias"]).view(b, h, w, c)
    else:
        shortcut = x
    if ps > 1:
        shortcut = kernels.maxpool2x2(shortcut)
    windowed = ws > 0
    if not windowed:
        if w != h or ps != 1:
            raise ValueError("global Hiera blocks take square unpooled maps")
        ws = h
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    if pad_h or pad_w:
        xn = F.pad(xn, (0, 0, 0, pad_w, 0, pad_h))
    qkv = kernels.gemm(xn.reshape(-1, cin), blk["qkv"]["kernel"],
                       blk["qkv"]["bias"])
    c = qkv.shape[1] // 3
    qkv = qkv.view(b, h + pad_h, w + pad_w, 3 * c)
    hd = c // num_heads
    oh, ow = h // ps, w // ps
    if windowed:
        o = kernels.window_attention(qkv, num_heads=num_heads, ws=ws,
                                     scale=1.0 / math.sqrt(hd), ps=ps,
                                     out_hw=(oh, ow))
    else:
        o = attention_stage(qkv, num_heads=num_heads, ws=ws,
                            ps=ps).contiguous()
    h1 = kernels.gemm(o.view(-1, c), blk["proj_attn"]["kernel"],
                      blk["proj_attn"]["bias"],
                      residual=shortcut.reshape(-1, c))
    h2 = kernels.layernorm(h1, blk["norm2"]["scale"], blk["norm2"]["bias"],
                           eps)
    mlp0, mlp1 = blk["mlp"]["layers"]
    f = kernels.gemm(h2, mlp0["kernel"], mlp0["bias"], act="gelu")
    y = kernels.gemm(f, mlp1["kernel"], mlp1["bias"], residual=h1)
    return y.view(b, oh, ow, c)


def hiera_block(blk, x, *, num_heads: int, ws: int,
                q_stride: Optional[Tuple[int, int]] = None,
                eps: float = 1e-6, kernel=None):
    """Windowed (ws > 0) or global (ws == 0) Hiera block on an NHWC map.

    kernel: test-only stand-in for the CUDA chain, fn(blk, x), so the CPU
    tests can drive the recompute Function."""
    ps = q_stride[0] if q_stride is not None else 1

    def plain(b_, x_):
        return hiera_block_plain(b_, x_, num_heads=num_heads, ws=ws,
                                 q_stride=q_stride, eps=eps)

    if kernel is None:
        if x.device.type == "cpu":
            return plain(blk, x)
        if x.device.type != "cuda":
            raise ValueError(f"hiera_block: unsupported device {x.device}")

        def kernel(b_, x_):
            kernels.LAUNCHES.add("K4")
            return _hiera_block_cuda(tree_map(lambda t: t.to(x_.dtype), b_),
                                     x_.contiguous(), num_heads=num_heads,
                                     ws=ws, ps=ps, eps=eps)
    if needs_grad(blk, x):
        return recompute(kernel, plain, blk, x)
    return kernel(blk, x)
