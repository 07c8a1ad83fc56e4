"""Attention: the plain twin of `attention_reference` and the dispatcher
onto the hand-written flash kernels (port of
`video_llava_seg_tpu/ops/attention.py`).

Layouts as in the JAX package: q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D],
Hq % Hkv == 0 (GQA, kv head = q head // group).

On a CUDA tensor `attention()` launches a hand-written CUDA kernel: the
multi-tile online-softmax form (counterpart of `_flash_kernel`, K2) when
Skv > 1024, the plain-softmax form (`_flash_kernel_single`, K3) of
`csrc/attention.cu` otherwise, the same split as `_fa_core`. K2 runs
`csrc/attention_sm90.cu` (TMA + wgmma) at head dim 128, the LLM's, and
`csrc/attention.cu` at the other head dims (`kernels.attention_entry`). On
a CPU tensor it runs the plain twin, and autograd differentiates the
twin. There is no other fallback.

When an input requires grad, the CUDA call goes through `_FlashAttention`
(the counterpart of the JAX package's `custom_vjp` around
`flash_attention`): its forward launches the same kernel with the
per-row logsumexp as a second output, and its backward launches K6a
(`_bwd_dq_kernel`: delta pre-pass + dQ) and K6b (`_bwd_dkv_kernel`: dK,
dV summed over the GQA group): `csrc/attention_bwd_sm90.cu` (TMA +
wgmma) at head dim 128, `csrc/attention_bwd.cu` at the other head dims
(`kernels.attention_bwd_entry`). The per-key bias gets no gradient (it
is a mask). Under `torch.utils.checkpoint` the
forward runs, and counts, a second time during the backward.

`flash_forward_plain` / `flash_backward_plain` are the plain versions of
the forward with its logsumexp and of the two backward kernels, with the
formulas of the JAX backward (`attention.py:462-471`); the tests hold
them against the Pallas kernels in interpret mode and the card against
them.
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


def _masked_scores(q, k, kv_bias, causal: bool, scale: float):
    """fp32 scores [B, Hq, Sq, Skv] with the flash kernels' masking: the
    per-key bias added, causal entries (diagonal at the sequence ends) set
    to MASK_VALUE."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, (hq // hkv) * sq, d).float()
    s = (torch.matmul(qg, k.float().transpose(-1, -2)) * scale).reshape(
        b, hq, sq, skv)
    if kv_bias is not None:
        s = s + kv_bias.float()[:, None, None, :]
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~(ki <= qi), MASK_VALUE)
    return s


def flash_forward_plain(q, k, v, kv_bias=None, causal: bool = False,
                        scale: Optional[float] = None):
    """Plain version of the flash forward with its residual:
    (out [B, Hq, Sq, D] in q's dtype, lse fp32 [B, Hq, Sq]). Softmax
    weights are rounded to v's dtype before the PV product, as the
    kernels do."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = _masked_scores(q, k, kv_bias, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    out = torch.matmul(p.float().reshape(b, hkv, -1, skv), v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype), lse


def flash_backward_plain(q, k, v, kv_bias, out, lse, dout,
                         causal: bool = False,
                         scale: Optional[float] = None):
    """Plain version of K6a + K6b: (dq, dk, dv) from the forward's output
    and logsumexp. delta = rowsum(dO * O); p = exp(s - lse); dV = p^T dO
    (p rounded to dO's dtype); dS = p (dO V^T - delta) scale, rounded to
    q's dtype; dQ = dS K; dK = dS^T Q; dK and dV summed over each kv
    head's group of q heads. fp32 sums throughout."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = _masked_scores(q, k, kv_bias, causal, scale)
    p = torch.exp(s - lse.float()[..., None])            # [B, Hq, Sq, Skv]
    do = dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    pg = p.to(dout.dtype).float().reshape(b, hkv, group * sq, skv)
    dog = do.reshape(b, hkv, group * sq, d)
    dv = torch.matmul(pg.transpose(-1, -2), dog)
    dp = torch.matmul(dog, v.float().transpose(-1, -2)).reshape(
        b, hq, sq, skv)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dsg = ds.reshape(b, hkv, group * sq, skv)
    dq = torch.matmul(dsg, k.float()).reshape(b, hq, sq, d)
    dk = torch.matmul(dsg.transpose(-1, -2),
                      q.float().reshape(b, hkv, group * sq, d))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """K2 / K3 forward with the logsumexp saved; K6a + K6b backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, causal, scale, single):
        kernels.LAUNCHES.add("K3" if single else "K2")
        out, lse = kernels.attention(q, k, v, scale=scale, causal=causal,
                                     kv_bias=kv_bias, two_pass=single,
                                     with_lse=True)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        kw = dict(scale=ctx.scale, causal=ctx.causal, kv_bias=kv_bias)
        kernels.LAUNCHES.add("K6a")
        dq, delta = kernels.attention_bwd_dq(q, k, v, out, dout, lse, **kw)
        kernels.LAUNCHES.add("K6b")
        dk, dv = kernels.attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, causal: bool = False,
              scale: Optional[float] = None, backend: str = "auto",
              kv_mask=None, window: Optional[int] = None,
              alibi: bool = False):
    """Flash kernel on CUDA (K2 / K3, backward K6a / K6b), the plain twin
    on CPU.

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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_bias, causal, float(scale),
                                     single)
    kernels.LAUNCHES.add("K3" if single else "K2")
    return kernels.attention(q, k, v, scale=scale, causal=causal,
                             kv_bias=kv_bias, two_pass=single)
