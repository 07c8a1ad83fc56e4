"""Attention: the plain twin of `attention_reference` and the dispatcher
onto the hand-written flash kernels (port of
`video_llava_seg_tpu/ops/attention.py`).

Layouts as in the JAX package: q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D],
Hq % Hkv == 0 (GQA, kv head = q head // group).

On a CUDA tensor `attention()` launches a hand-written CUDA kernel: the
multi-tile online-softmax form (counterpart of `_flash_kernel`, K2) when
Skv > 1024, the plain-softmax form (`_flash_kernel_single`, K3)
otherwise, the same split as `_fa_core`. K2 runs
`csrc/attention_sm90.cu` (TMA + wgmma) at head dims 64 / 80 / 96 / 128
(the LLM's, the per-op Hiera trunk's global blocks; a per-key bias only
at 128) and `csrc/attention.cu` at the other head dims. A sliding window
(Mistral) or ALiBi (MPT), which the JAX package sends to its XLA
reference, takes K2 on `csrc/attention_sm90.cu` at head dim 128 over any
number of keys: the window as a lower bound on the keys, ALiBi as a
per-(batch, head, key) bias `alibi_key_bias` (slope_h * j with the pad
mask folded in; softmax is invariant to the per-row constant slope_h * i
that separates it from the reference's slope_h * (j - i)); other head
dims raise. K3 runs `csrc/attention_short_sm90.cu` (persistent, K/V
resident, Q streamed by TMA, wgmma) at head dim 16 with Skv <= 64, the
mask decoder's image->token attention, and `csrc/attention.cu`'s
two-pass form elsewhere (`kernels.attention_entry` names the route). On
a CPU tensor it runs the plain twin, and autograd differentiates the
twin. There is no other fallback.

When an input requires grad, the CUDA call goes through `_FlashAttention`
(the counterpart of the JAX package's `custom_vjp` around
`flash_attention`): its forward launches the same kernel with the
per-row logsumexp as a second output, and its backward
(`kernels.attention_bwd`) computes K6a (`_bwd_dq_kernel`: dQ) and K6b
(`_bwd_dkv_kernel`: dK, dV summed over the GQA group):
`csrc/attention_short_bwd_sm90.cu` in one pass wherever the forward took
attention_short_sm90.cu (the mask decoder), the TMA + wgmma pair of
`csrc/attention_bwd_sm90.cu` at head dim 128, `csrc/attention_bwd.cu`'s
pair elsewhere (`kernels.attention_bwd_entry`; each call counts one K6a
and one K6b). The per-key bias gets no gradient (it
is a mask). Under `torch.utils.checkpoint` the
forward runs, and counts, a second time during the backward. A window or
ALiBi under autograd on the card takes the same Function at head dim 128
(both families train there): K2 with the window, or with ALiBi as the
per-head key bias, and its logsumexp of that key form; the backward
reads the same window and bias, so p = exp(scale q.k + slope_h j -
lse_i) is the reference's softmax. Other head dims raise a ValueError.

`flash_forward_plain` / `flash_backward_plain` are the plain versions of
the forward with its logsumexp and of the two backward kernels, with the
formulas of the JAX backward (`attention.py:462-471`); the tests hold
them against the Pallas kernels in interpret mode and the card against
them.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from video_llava_seg_torch import kernels

# large-negative mask value (avoids exp(-inf - (-inf)) NaNs)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

SINGLE_BLOCK_MAX_KV = 1024


def alibi_slopes(num_heads: int) -> np.ndarray:
    """The standard ALiBi head slopes (MPT's attention), fp32 [num_heads]:
    a geometric sequence from 2^(-8 / n) for the largest power of two n
    <= num_heads, then every other slope of 2n's sequence for the heads
    left (the JAX package's `alibi_slopes`)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    n = 2 ** math.floor(math.log2(num_heads))
    slopes = pow2_slopes(n)
    if n < num_heads:
        slopes += pow2_slopes(2 * n)[0::2][: num_heads - n]
    return np.asarray(slopes, np.float32)


@functools.lru_cache(maxsize=None)
def _alibi_slopes_on(num_heads: int, device: torch.device) -> torch.Tensor:
    """`alibi_slopes` as an fp32 tensor on `device`, built once (outside
    inference mode, so a later autograd pass may read it): a copy from
    pageable host memory waits for the device's stream, once a layer of
    every MPT prefill and decode step."""
    with torch.inference_mode(False):
        return torch.from_numpy(alibi_slopes(num_heads)).to(device)


def _slopes_of(alibi, num_heads: int, device):
    """The ALiBi slopes an `alibi` argument names: None for False, those
    of `num_heads` heads for True, the tensor itself for a tensor (a
    tensor-parallel rank's global heads)."""
    if torch.is_tensor(alibi):
        return alibi
    return _alibi_slopes_on(num_heads, device) if alibi else None


def alibi_key_bias(slopes: torch.Tensor, skv: int, kv_mask=None,
                   batch: int = 1) -> torch.Tensor:
    """The per-(batch, head, key) fp32 bias [B, H, Skv] that K2 adds to
    its scores for ALiBi: slope_h * j, MASK_VALUE where kv_mask (bool
    [B, Skv], optional) is False. It differs from the reference's
    slope_h * (j - i) by slope_h * i, a constant of each query row, which
    the softmax cancels: the output is the same, the logsumexp is not."""
    j = torch.arange(skv, device=slopes.device, dtype=torch.float32)
    bias = slopes.float()[:, None] * j[None, :]
    if kv_mask is None:
        return bias[None].expand(batch, -1, -1).contiguous()
    return torch.where(kv_mask[:, None, :], bias[None],
                       MASK_VALUE).contiguous()


def attention_reference(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        kv_valid_len: Optional[int] = None, kv_mask=None,
                        window: Optional[int] = None, alibi=False,
                        q_positions=None, k_scale=None, v_scale=None):
    """Plain softmax attention, scores and softmax in fp32.

    kv_mask: optional bool [B, Skv], False keys masked. Query i sits at
    key slot i + Skv - Sq (the diagonal at the sequence ends);
    q_positions ([Sq] absolute key-space positions) overrides it. With
    rel = key slot - query slot: causal keeps rel <= 0, window (Mistral's
    sliding window) keeps rel > -window, and alibi (MPT) adds slope_h *
    rel to head h's scores before any mask, as the JAX package does
    (`alibi_slopes(Hq)`, or a tensor of q's heads' slopes: a
    tensor-parallel rank's heads take their global heads' slopes).

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
    rel = ki - qi
    slopes = _slopes_of(alibi, hq, q.device)
    if slopes is not None:
        s = s + slopes[None, :, None, None] * rel[None, None].float()
    if causal:
        s = s.masked_fill(~(rel <= 0)[None, None], MASK_VALUE)
    if window is not None:
        s = s.masked_fill(~(rel > -window)[None, None], MASK_VALUE)
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


def _masked_scores(q, k, kv_bias, causal: bool, scale: float,
                   window: Optional[int] = None):
    """fp32 scores [B, Hq, Sq, Skv] with the flash kernels' masking: the
    bias added (per key [B, Skv], or per head and key [B, Hq, Skv]),
    causal entries (diagonal at the sequence ends) and keys at or past
    `window` slots behind the query set to MASK_VALUE."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, (hq // hkv) * sq, d).float()
    s = (torch.matmul(qg, k.float().transpose(-1, -2)) * scale).reshape(
        b, hq, sq, skv)
    if kv_bias is not None:
        bias = kv_bias.float()
        s = s + (bias[:, :, None, :] if bias.dim() == 3
                 else bias[:, None, None, :])
    rel = (torch.arange(skv, device=q.device)[None, :]
           - torch.arange(sq, device=q.device)[:, None] - (skv - sq))
    if causal:
        s = s.masked_fill(~(rel <= 0), MASK_VALUE)
    if window is not None:
        s = s.masked_fill(~(rel > -window), MASK_VALUE)
    return s


def flash_forward_plain(q, k, v, kv_bias=None, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None):
    """Plain version of the flash forward with its residual:
    (out [B, Hq, Sq, D] in q's dtype, lse fp32 [B, Hq, Sq]). Softmax
    weights are rounded to v's dtype before the PV product, as the
    kernels do. kv_bias: fp32 [B, Skv] or [B, Hq, Skv]; window: keys at
    rel <= -window masked, as `attention_reference`."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = _masked_scores(q, k, kv_bias, causal, scale, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    out = torch.matmul(p.float().reshape(b, hkv, -1, skv), v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype), lse


def flash_backward_plain(q, k, v, kv_bias, out, lse, dout,
                         causal: bool = False,
                         scale: Optional[float] = None,
                         window: Optional[int] = None):
    """Plain version of K6a + K6b: (dq, dk, dv) from the forward's output
    and logsumexp. delta = rowsum(dO * O); p = exp(s - lse); dV = p^T dO
    (p rounded to dO's dtype); dS = p (dO V^T - delta) scale, rounded to
    q's dtype; dQ = dS K; dK = dS^T Q; dK and dV summed over each kv
    head's group of q heads. fp32 sums throughout. kv_bias and window as
    `flash_forward_plain`: the lse must be that forward's, of the same
    bias and window (for ALiBi, of its key form)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = _masked_scores(q, k, kv_bias, causal, scale, window)
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
    """K2 / K3 forward with the logsumexp saved; K6a + K6b backward.
    kv_bias: the per-key pad bias [B, Skv] or ALiBi's per-head key bias
    [B, Hq, Skv] (`alibi_key_bias`), saved as given: the backward reads
    the bias whose logsumexp the forward wrote. window: 0 for none."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, causal, scale, single, window=0):
        out, lse = kernels.attention(q, k, v, scale=scale, causal=causal,
                                     kv_bias=kv_bias, two_pass=single,
                                     with_lse=True, window=window)
        kernels.LAUNCHES.add("K3" if single else "K2")
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        kw = dict(scale=ctx.scale, causal=ctx.causal, kv_bias=kv_bias,
                  window=ctx.window)
        kernels.LAUNCHES.add("K6a")
        kernels.LAUNCHES.add("K6b")
        dq, dk, dv = kernels.attention_bwd(q, k, v, out, dout, lse, **kw)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, *, causal: bool = False,
              scale: Optional[float] = None, backend: str = "auto",
              kv_mask=None, window: Optional[int] = None,
              alibi=False):
    """Flash kernel on CUDA (K2 / K3, backward K6a / K6b), the plain twin
    on CPU.

    backend='plain' always runs the twin (the JAX package's
    backend='xla', chosen by callers for short query sets). window /
    alibi: Mistral's sliding window, MPT's ALiBi (`attention_reference`'s
    semantics; alibi a tensor: a tensor-parallel rank's slopes); on CUDA
    they take K2 on attention_sm90.cu at head dim 128 over any number of
    keys, and under autograd `_FlashAttention` with K6a / K6b on
    attention_bwd_sm90.cu, so both families train on the card there;
    other head dims raise a ValueError."""
    if window is not None and window < 1:
        raise ValueError(f"attention: window must be >= 1, got {window}")
    if backend == "plain" or q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, scale=scale,
                                   kv_mask=kv_mask, window=window,
                                   alibi=alibi)
    if backend != "auto":
        raise ValueError(f"unknown attention backend: {backend}")
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    slopes = _slopes_of(alibi, q.shape[1], q.device)
    if window is not None or slopes is not None:
        if slopes is not None:
            kv_bias = alibi_key_bias(slopes, k.shape[2], kv_mask,
                                     batch=q.shape[0])
        else:
            kv_bias = _pad_bias(kv_mask)
        if grad:
            # K2 refuses either form off head dim 128 (a ValueError), so
            # nothing is counted there
            return _FlashAttention.apply(q, k, v, kv_bias, causal,
                                         float(scale), False, window or 0)
        out = kernels.attention(q, k, v, scale=scale, causal=causal,
                                kv_bias=kv_bias, window=window or 0)
        kernels.LAUNCHES.add("K2")
        return out
    kv_bias = _pad_bias(kv_mask)
    single = k.shape[2] <= SINGLE_BLOCK_MAX_KV
    if grad:
        return _FlashAttention.apply(q, k, v, kv_bias, causal, float(scale),
                                     single)
    kernels.LAUNCHES.add("K3" if single else "K2")
    return kernels.attention(q, k, v, scale=scale, causal=causal,
                             kv_bias=kv_bias, two_pass=single)


def _pad_bias(kv_mask):
    """The per-key fp32 bias [B, Skv] of a bool key mask (0 where True,
    MASK_VALUE where False), or None."""
    if kv_mask is None:
        return None
    return torch.where(kv_mask, 0.0, MASK_VALUE).float().contiguous()
