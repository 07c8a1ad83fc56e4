"""SAM2 memory encoder and memory attention (port of
`video_llava_seg_tpu/models/sam2/memory.py`; the reference's
sam2/modeling/memory_encoder.py and memory_attention.py), NHWC maps,
[B, N, C] token sequences.

The memory encoder downsamples a frame's mask logits 16x (four conv k3
s2 -> LayerNorm2d -> GELU, then a 1x1), adds them to the projected image
features, runs a ConvNeXt fuser and projects to mem_dim; its position
encoding is the sine grid, built once per shape.

Memory attention is num_layers of RoPE self-attention over the current
frame's tokens, RoPE cross-attention into the memory (the spatial
memories of the bank's frames, then the object-pointer tokens, which
RoPE leaves alone) and a ReLU FFN. Its attention is one head of d_model
(256 at full width): `ops.attention.attention`, on the card K2 at head
dim 256 (csrc/attention_sm90.cu), where the query set has at least
KERNEL_MIN_QUERIES rows (`rope_attention_backend`), the plain twin below
that, as the JAX package chooses between its Pallas kernel and XLA. The
memory holds only valid entries (see the video predictor's bank), so the
attention takes no mask and every query row sees every key.
"""

from __future__ import annotations

import math

import torch

from video_llava_seg_torch.models.sam2.position_encoding import (
    sine_pos_embed_on,
)
from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.attention import attention
from video_llava_seg_torch.ops.rope import apply_axial_rope

_LN_EPS = 1e-5
# query sets from this many rows take the flash kernel (`backend="auto"`
# in the JAX package's _rope_attn_apply); at full width every query set
# is a 64 x 64 frame's 4096 tokens
KERNEL_MIN_QUERIES = 256


# ---------------------------------------------------------------------------
# memory encoder
# ---------------------------------------------------------------------------

def memory_encoder_init(cfg, g: torch.Generator, device, dtype):
    me = cfg.memory_encoder
    layers = []
    cin = 1
    for _ in range(4):
        cout = cin * 4
        layers.append({
            "conv": nn.conv2d_init(g, cin, cout, (3, 3), device, dtype),
            "ln": nn.layer_norm_init(cout, device, dtype),
        })
        cin = cout
    p = {
        "mask_downsampler": {
            "layers": layers,
            "final": nn.conv2d_init(g, cin, me.mask_downsampler_embed_dim,
                                    (1, 1), device, dtype),
        },
        "pix_feat_proj": nn.conv2d_init(g, me.in_dim, me.in_dim, (1, 1),
                                        device, dtype),
        "fuser": {"layers": [{
            "dwconv": nn.conv2d_init(g, 1, me.in_dim, (7, 7), device, dtype),
            "norm": nn.layer_norm_init(me.in_dim, device, dtype),
            "pwconv1": nn.dense_init(g, me.in_dim, 4 * me.in_dim, device,
                                     dtype),
            "pwconv2": nn.dense_init(g, 4 * me.in_dim, me.in_dim, device,
                                     dtype),
            "gamma": 1e-6 * torch.ones(me.in_dim, device=device,
                                       dtype=dtype),
        } for _ in range(me.fuser_layers)]},
    }
    if me.out_dim != me.in_dim:
        p["out_proj"] = nn.conv2d_init(g, me.in_dim, me.out_dim, (1, 1),
                                       device, dtype)
    return p


def _cx_block(p, x):
    """ConvNeXt block, NHWC (memory_encoder.py:61-121)."""
    y = nn.conv2d(p["dwconv"], x, padding=[(3, 3), (3, 3)],
                  groups=x.shape[-1])
    y = nn.layer_norm(p["norm"], y, 1e-6)
    y = nn.dense(p["pwconv2"], nn.gelu(nn.dense(p["pwconv1"], y)))
    return x + y * p["gamma"].to(y.dtype)


def memory_encoder_apply(params, cfg, pix_feat: torch.Tensor,
                         masks: torch.Tensor,
                         skip_mask_sigmoid: bool = False):
    """pix_feat [B, H, W, C_in]; masks [B, 16H, 16W, 1] logits (or, with
    skip_mask_sigmoid, already the encoder's input). Returns
    (vision_features [B, H, W, mem_dim], vision_pos_enc [H, W, mem_dim])."""
    x = masks if skip_mask_sigmoid else torch.sigmoid(masks)
    x = x.to(pix_feat.dtype)
    for layer in params["mask_downsampler"]["layers"]:
        x = nn.conv2d(layer["conv"], x, stride=(2, 2),
                      padding=[(1, 1), (1, 1)])
        x = nn.gelu(nn.layer_norm(layer["ln"], x, 1e-6))
    y = nn.conv2d(params["pix_feat_proj"], pix_feat)
    y = y + nn.conv2d(params["mask_downsampler"]["final"], x)
    for layer in params["fuser"]["layers"]:
        y = _cx_block(layer, y)
    if "out_proj" in params:
        y = nn.conv2d(params["out_proj"], y)
    pos = sine_pos_embed_on(y.shape[1], y.shape[2],
                            cfg.memory_encoder.pos_num_feats, 10000,
                            y.device, y.dtype)
    return y, pos


# ---------------------------------------------------------------------------
# memory attention
# ---------------------------------------------------------------------------

def _rope_attn_init(g, d_model, kv_in_dim, device, dtype):
    kv_in = kv_in_dim if kv_in_dim is not None else d_model
    return {
        "q_proj": nn.dense_init(g, d_model, d_model, device, dtype),
        "k_proj": nn.dense_init(g, kv_in, d_model, device, dtype),
        "v_proj": nn.dense_init(g, kv_in, d_model, device, dtype),
        "out_proj": nn.dense_init(g, d_model, d_model, device, dtype),
    }


def rope_attention_backend(nq: int) -> str:
    """The attention of `_rope_attn_apply` over nq queries: "auto" (the
    flash kernel on the card, K2) from KERNEL_MIN_QUERIES rows, "plain"
    below (the JAX package's backend="xla")."""
    return "auto" if nq >= KERNEL_MIN_QUERIES else "plain"


def _rope_attn_apply(p, cfg, q, k, v, *, rope_k_repeat: bool,
                     num_k_exclude_rope: int = 0):
    """RoPEAttention (transformer.py:289-360): project, axial RoPE on a
    sqrt(Nq) x sqrt(Nq) grid, attend, project out."""
    ma = cfg.memory_attention
    heads = ma.num_heads
    q = nn.dense(p["q_proj"], q)
    k = nn.dense(p["k_proj"], k)
    v = nn.dense(p["v_proj"], v)
    b, nq, c = q.shape
    hd = c // heads
    qh = q.view(b, nq, heads, hd).transpose(1, 2)
    kh = k.view(b, k.shape[1], heads, hd).transpose(1, 2)
    vh = v.view(b, v.shape[1], heads, hd).transpose(1, 2)
    side = int(round(math.sqrt(nq)))
    if side * side != nq:
        raise ValueError(f"RoPE grid must be square, got {nq} queries")
    qh, kh = apply_axial_rope(qh, kh, side, side, ma.rope_theta,
                              repeat_freqs_k=rope_k_repeat,
                              num_k_exclude=num_k_exclude_rope)
    o = attention(qh, kh, vh, backend=rope_attention_backend(nq))
    return nn.dense(p["out_proj"], o.transpose(1, 2).reshape(b, nq, c))


def memory_attention_init(cfg, g: torch.Generator, device, dtype):
    ma = cfg.memory_attention
    layers = [{
        "self_attn": _rope_attn_init(g, ma.d_model, None, device, dtype),
        "cross_attn_image": _rope_attn_init(g, ma.d_model, ma.kv_in_dim,
                                            device, dtype),
        "linear1": nn.dense_init(g, ma.d_model, ma.dim_feedforward, device,
                                 dtype),
        "linear2": nn.dense_init(g, ma.dim_feedforward, ma.d_model, device,
                                 dtype),
        "norm1": nn.layer_norm_init(ma.d_model, device, dtype),
        "norm2": nn.layer_norm_init(ma.d_model, device, dtype),
        "norm3": nn.layer_norm_init(ma.d_model, device, dtype),
    } for _ in range(ma.num_layers)]
    return {"layers": layers,
            "norm": nn.layer_norm_init(ma.d_model, device, dtype)}


def memory_attention_apply(params, cfg, curr, memory, curr_pos, memory_pos,
                           num_obj_ptr_tokens: int = 0):
    """curr [B, N, C], the current frame's tokens; memory [B, M,
    kv_in_dim], the spatial memories then the num_obj_ptr_tokens pointer
    tokens; curr_pos / memory_pos their position encodings. Returns
    [B, N, C]. MemoryAttention.forward with pos_enc_at_input (0.1 * pos
    added to the input) and the sam2.1 flags (the keys get their position
    encoding, the queries do not)."""
    ma = cfg.memory_attention
    output = curr
    if ma.pos_enc_at_input and curr_pos is not None:
        output = output + 0.1 * curr_pos
    k_in = memory + memory_pos if ma.pos_enc_at_cross_attn_keys else memory
    for layer in params["layers"]:
        t2 = nn.layer_norm(layer["norm1"], output, _LN_EPS)
        output = output + _rope_attn_apply(layer["self_attn"], cfg, t2, t2,
                                           t2, rope_k_repeat=False)
        t2 = nn.layer_norm(layer["norm2"], output, _LN_EPS)
        q_in = t2 + curr_pos if ma.pos_enc_at_cross_attn_queries else t2
        output = output + _rope_attn_apply(
            layer["cross_attn_image"], cfg, q_in, k_in, memory,
            rope_k_repeat=True, num_k_exclude_rope=num_obj_ptr_tokens)
        t2 = nn.layer_norm(layer["norm3"], output, _LN_EPS)
        output = output + nn.dense(layer["linear2"], torch.relu(
            nn.dense(layer["linear1"], t2)))
    return nn.layer_norm(params["norm"], output, _LN_EPS)
