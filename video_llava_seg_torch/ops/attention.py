"""Attention: the plain twin of `attention_reference` and the dispatcher
onto the hand-written flash kernels (port of
`video_llava_seg_tpu/ops/attention.py`).

Layouts as in the JAX package: q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D],
Hq % Hkv == 0 (GQA, kv head = q head // group).

On a CUDA tensor `attention()` launches the CUDA kernel of
`csrc/attention.cu`: the multi-tile online-softmax form (counterpart of
`_flash_kernel`, K2) when Skv > 1024, the plain-softmax form
(`_flash_kernel_single`, K3) otherwise, the same split as `_fa_core`. On
a CPU tensor it runs the plain twin. There is no other fallback.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from video_llava_seg_torch import kernels

# large-negative mask value (avoids exp(-inf - (-inf)) NaNs)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

SINGLE_BLOCK_MAX_KV = 1024


def attention_reference(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        kv_valid_len: Optional[int] = None, kv_mask=None,
                        q_positions=None, k_scale=None, v_scale=None):
    """Plain softmax attention, scores and softmax in fp32.

    kv_mask: optional bool [B, Skv], False keys masked. Causal masking
    aligns the diagonal to the sequence ends; q_positions ([Sq] absolute
    key-space positions) overrides the query positions.

    k_scale / v_scale: optional fp32 [B, Hkv, Skv] for an int8 K/V
    cache: the products read the int8 values as they are and the per-key
    scales fold in exactly, into the scores after the QK product and into
    the softmax weights before the PV product (which then runs with
    weights rounded to q's dtype)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq ({hq}) must be a multiple of Hkv ({hkv})")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    group = hq // hkv
    # GQA without repeating K/V: fold the group into the query axis
    qg = q.reshape(b, hkv, group * sq, d).float()
    s = torch.matmul(qg, k.float().transpose(-1, -2)) * scale
    if k_scale is not None:
        s = s * k_scale[:, :, None, :].float()
    s = s.reshape(b, hq, sq, skv)
    if q_positions is not None:
        qi = q_positions.to(q.device)[:, None]
    else:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    ki = torch.arange(skv, device=q.device)[None, :]
    if causal:
        s = s.masked_fill(~(ki <= qi)[None, None], MASK_VALUE)
    if kv_valid_len is not None:
        s = s.masked_fill((ki >= kv_valid_len)[None, None], MASK_VALUE)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    pg = p.reshape(b, hkv, group * sq, skv)
    if v_scale is not None:
        pg = (pg * v_scale[:, :, None, :].float()).to(q.dtype)
    else:
        pg = pg.to(v.dtype)
    out = torch.matmul(pg.float(), v.float()).reshape(b, hq, sq, d)
    return out.to(q.dtype)


def attention(q, k, v, *, causal: bool = False,
              scale: Optional[float] = None, backend: str = "auto",
              kv_mask=None, window: Optional[int] = None,
              alibi: bool = False):
    """Flash kernel on CUDA (K2 / K3), the plain twin on CPU.

    backend='plain' always runs the twin (the JAX package's
    backend='xla', chosen by callers for short query sets)."""
    if window is not None or alibi:
        raise NotImplementedError("ROADMAP queue 1 item 3")
    if backend == "plain" or q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, scale=scale,
                                   kv_mask=kv_mask)
    if backend != "auto":
        raise ValueError(f"unknown attention backend: {backend}")
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kv_bias = None
    if kv_mask is not None:
        kv_bias = torch.where(kv_mask, 0.0, MASK_VALUE).float().contiguous()
    single = k.shape[2] <= SINGLE_BLOCK_MAX_KV
    kernels.LAUNCHES.add("K3" if single else "K2")
    return kernels.attention(q, k, v, scale=scale, causal=causal,
                             kv_bias=kv_bias, two_pass=single)
