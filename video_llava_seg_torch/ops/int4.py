"""W4A8 dense: int4 weights packed two per byte, per-row int8
activations, int32 accumulation (port of `video_llava_seg_tpu/ops/int4.py`,
whose `_w4a8_kernel` is K5).

Packing layout ("halves"), bit-identical to the JAX package's so a JAX
tree loads unchanged: byte row i of the packed [in/2, out] tensor holds
W[i] in its low nibble and W[i + in/2] in its high nibble. The low plane
multiplies x[:, :in/2], the high plane x[:, in/2:], and the two int32
sums add.

`w4a8_dense` quantizes the activations per row (plain PyTorch, as the
JAX package leaves it to XLA), then runs the product: on a CUDA tensor
a hand-written kernel (K5; `kernels.w4a8_entry` names it: the TMA + wgmma
tile of `csrc/w4a8_sm90.cu` above 8 rows, the TMA weight stream of
`csrc/w4a8_gemv_sm90.cu` at <= 8 rows (decode, the lm_head),
`csrc/w4a8.cu` at widths TMA cannot address), on a CPU tensor
`w4a8_matmul_plain`. The accumulation is integer and the epilogue is two
fp32 multiplies in a fixed order, so the two agree bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_llava_seg_torch import kernels


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-7, 7] (shape [in, out], in even) into int8
    bytes [in/2, out]: low nibble = q[i], high nibble = q[i + in/2]."""
    in_dim = q.shape[0]
    if in_dim % 2:
        raise ValueError(f"pack_int4: in ({in_dim}) must be even")
    half = in_dim // 2
    q32 = q.to(torch.int32)
    byte = (q32[:half] & 0xF) | ((q32[half:] & 0xF) << 4)  # 0..255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def unpack_int4(packed: torch.Tensor):
    """Inverse of pack_int4: int8 [in/2, out] -> (lo, hi) int8 planes,
    lo = rows [0, in/2), hi = rows [in/2, in)."""
    p32 = packed.to(torch.int32) & 0xFF
    lo = p32 & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = (p32 >> 4) & 0xF
    hi = torch.where(hi >= 8, hi - 16, hi)
    return lo.to(torch.int8), hi.to(torch.int8)


def int_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [m, k] @ int8 [k, n] -> int32: float64 holds every
    product and partial sum of int8 values exactly (|sum| <= k * 127 *
    128 < 2^53), so the order of the sums does not matter."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [m, k] @ int8 [k, n] -> int32: on a CUDA tensor the
    int32 mode of `kernels.gemm_s8` (int8 tensor cores: `csrc/
    w8a8_sm90.cu` where k and n are multiples of 16, `csrc/w8a8.cu`
    elsewhere; the product XLA computes for the JAX package, no TPU
    kernel, so no K1..K8 launch count), on a CPU tensor
    `int_matmul_plain`. Both are exact, so they agree bit for bit."""
    if a.device.type == "cpu":
        return int_matmul_plain(a, b)
    return kernels.gemm_s8(a.contiguous(), b.contiguous())


def gemm_s8_plain(a: torch.Tensor, b: torch.Tensor,
                  a_scale: Optional[torch.Tensor] = None,
                  w_scale: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  act: str = "none") -> torch.Tensor:
    """Plain PyTorch version of `kernels.gemm_s8` (csrc/w8a8.cu and
    w8a8_sm90.cu), with its arguments. Without scales the exact int32
    product; with them the W8A8 dense epilogue step by step in fp32, each
    step rounded to bf16 as the kernels round it: bf16((acc * a_scale) *
    w_scale) [+ bias] [* bf16(scale) | act] [+ residual]. The activations
    are the kernels' forms, v / (1 + exp(-1.702 v)) (as v * (1 / ..)) and
    (0.5 v) (1 + erf(v / sqrt 2)), in fp32 on the bf16 value."""
    acc = int_matmul_plain(a, b)
    if a_scale is None:
        return acc

    def rbf(v):
        return v.to(torch.bfloat16).float()

    v = rbf(acc.float() * a_scale.reshape(-1, 1) * w_scale)
    if bias is not None:
        v = rbf(v + bias.float())
    if scale:
        qs = rbf(torch.tensor(float(scale), device=v.device))
        v = rbf(v * qs)
    if act == "quick_gelu":
        v = rbf(v * torch.reciprocal(1.0 + torch.exp(v * -1.702)))
    elif act == "gelu":
        v = rbf((v * 0.5) * (1.0 + torch.erf(v * 0.70710678118654752)))
    if residual is not None:
        v = v + residual.float()
    return v.to(torch.bfloat16)


def w4a8_matmul_plain(xq, a_scale, packed, w_scale, out_dtype):
    """Plain PyTorch version of K5. xq int8 [rows, in]; a_scale fp32
    [rows, 1]; packed int8 [in/2, out]; w_scale fp32 [out].
    Returns [rows, out] in out_dtype."""
    half = packed.shape[0]
    lo, hi = unpack_int4(packed)
    acc = (int_matmul_plain(xq[:, :half], lo)
           + int_matmul_plain(xq[:, half:], hi))
    return (acc.float() * a_scale * w_scale).to(out_dtype)


def w4a8_integer_product(xq: torch.Tensor, packed: torch.Tensor
                         ) -> torch.Tensor:
    """int32(xq @ unpack(packed)) as fp32 [rows, out]: K5 with unit scales
    and fp32 output on the card (`w4a8_matmul_plain` on the CPU). Exact
    while |sums| < 2^24; a row-parallel rank's partial products, which
    are summed over the ranks and then scaled once
    (`parallel/tensor_parallel.row_parallel_dense`)."""
    ones_a = torch.ones((xq.shape[0], 1), device=xq.device)
    ones_w = torch.ones((packed.shape[1],), device=xq.device)
    if xq.device.type == "cpu":
        return w4a8_matmul_plain(xq, ones_a, packed, ones_w, torch.float32)
    kernels.LAUNCHES.add("K5")
    return kernels.w4a8_matmul(xq.contiguous(), ones_a, packed, ones_w,
                               torch.float32)


def w4a8_dense(p, x: torch.Tensor) -> torch.Tensor:
    """nn.dense body for a 'kernel_q4a' param dict; x [..., in]. Bias, if
    any, is added in x.dtype after the product."""
    from video_llava_seg_torch.ops.quantization import (
        quantize_activations_rowwise,
    )

    packed = p["kernel_q4a"]
    half, out = packed.shape
    lead = x.shape[:-1]
    xq, a_scale = quantize_activations_rowwise(x.reshape(-1, 2 * half))
    if x.device.type == "cpu":
        y = w4a8_matmul_plain(xq, a_scale, packed, p["kernel_scale"],
                              x.dtype)
    else:
        kernels.LAUNCHES.add("K5")
        y = kernels.w4a8_matmul(xq, a_scale, packed, p["kernel_scale"],
                                x.dtype)
    y = y.reshape(*lead, out)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y
