"""NN primitives over plain dict trees of tensors (port of
`video_llava_seg_tpu/ops/nn.py`).

Same tree layout as the JAX package: dense kernels `[in, out]`, conv
kernels HWIO, activations NHWC, so a JAX tree bridges leaf for leaf
(`bridge.from_jax`). The compute dtype is the input's; parameters are
cast to it.

Init functions take an explicit `torch.Generator` and device and build
the JAX package's tree shape (not its random numbers: the two frameworks
draw differently from one seed).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def trunc_normal(g: torch.Generator, shape, std: float, device, dtype):
    """Normal(0, std) clipped at +-2 std (JAX truncated_normal's support)."""
    x = torch.randn(tuple(shape), generator=g, device=device,
                    dtype=torch.float32)
    return (x.clamp_(-2.0, 2.0) * std).to(dtype)


def lecun_normal(g, shape, in_dim: int, device, dtype):
    return trunc_normal(g, shape, 1.0 / math.sqrt(max(1, in_dim)), device,
                        dtype)


def dense_init(g, in_dim: int, out_dim: int, device, dtype,
               bias: bool = True):
    p = {"kernel": lecun_normal(g, (in_dim, out_dim), in_dim, device, dtype)}
    if bias:
        p["bias"] = torch.zeros(out_dim, device=device, dtype=dtype)
    return p


def layer_norm_init(dim: int, device, dtype):
    return {"scale": torch.ones(dim, device=device, dtype=dtype),
            "bias": torch.zeros(dim, device=device, dtype=dtype)}


def rms_norm_init(dim: int, device, dtype):
    return {"scale": torch.ones(dim, device=device, dtype=dtype)}


def conv2d_init(g, in_ch: int, out_ch: int, kernel: Tuple[int, int], device,
                dtype, bias: bool = True):
    kh, kw = kernel
    p = {"kernel": lecun_normal(g, (kh, kw, in_ch, out_ch),
                                in_ch * kh * kw, device, dtype)}
    if bias:
        p["bias"] = torch.zeros(out_ch, device=device, dtype=dtype)
    return p


def conv_transpose2d_init(g, in_ch: int, out_ch: int, kernel, device, dtype):
    return conv2d_init(g, in_ch, out_ch, kernel, device, dtype)


def embedding_init(g, num: int, dim: int, device, dtype, std=0.02):
    return {"embedding": trunc_normal(g, (num, dim), std, device, dtype)}


def mlp_init(g, dims: Sequence[int], device, dtype, bias: bool = True):
    return {"layers": [dense_init(g, dims[i], dims[i + 1], device, dtype,
                                  bias) for i in range(len(dims) - 1)]}


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def dense(p, x):
    """x @ kernel (+ bias) over the four kernel kinds of the JAX package:
    float `kernel`; `kernel_q4a` (W4A8, `ops/int4.py`, K5 on the card);
    `kernel_qa` (W8A8) and `kernel_q` (weight-only int8), which the JAX
    package leaves to XLA and the port to plain PyTorch.

    A LoRA adapter {"a", "b", "s"} attached to the dict (a quantized base
    under QLoRA, `train.lora.merge`) adds the rank-r side branch
    ((x @ a) @ b) * s in x's dtype, so no float copy of the base weights
    is ever built."""
    lora = p.get("lora")
    if lora is not None:
        base = {k: v for k, v in p.items() if k != "lora"}
        delta = torch.matmul(torch.matmul(x, lora["a"].to(x.dtype)),
                             lora["b"].to(x.dtype))
        return dense(base, x) + delta * lora["s"].to(x.dtype)
    if "kernel_q4a" in p:
        from video_llava_seg_torch.ops.int4 import w4a8_dense

        return w4a8_dense(p, x)
    if "kernel_qa" in p:
        # per-row int8 activations x int8 weights, exact int32 sums, then
        # act-row x weight-column scales
        from video_llava_seg_torch.ops.int4 import int_matmul
        from video_llava_seg_torch.ops.quantization import (
            quantize_activations_rowwise,
        )

        xq, a_scale = quantize_activations_rowwise(x)
        acc = int_matmul(xq.reshape(-1, xq.shape[-1]), p["kernel_qa"])
        y = (acc.reshape(*x.shape[:-1], -1).float() * a_scale
             * p["kernel_scale"]).to(x.dtype)
    elif "kernel_q" in p:
        # int8 values are exact in bf16; the per-output-channel scale
        # commutes with the contraction, so it scales the output
        scale = p["kernel_scale"]
        if scale.dtype == torch.bfloat16:
            # a train-mode tree (quantize_tree(train_mode=True)): all bf16
            y = torch.matmul(x, p["kernel_q"].to(x.dtype))
            y = y * scale.to(x.dtype)
        else:
            y = torch.matmul(x.float(), p["kernel_q"].float())
            y = (y * scale).to(x.dtype)
    else:
        y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def layer_norm(p, x, eps: float = 1e-5):
    """LayerNorm over the last axis, statistics in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rms_norm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def layer_norm_2d(p, x, eps: float = 1e-6):
    """Channel LayerNorm of an NHWC map (stats over channels per pixel)."""
    return layer_norm(p, x, eps)


def _same_pads(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p, x, stride: Tuple[int, int] = (1, 1), padding="SAME",
           groups: int = 1):
    """NHWC conv with an HWIO kernel (I = input channels / groups).
    padding: 'SAME' | 'VALID' | [(lo, hi), (lo, hi)]."""
    w = p["kernel"].to(x.dtype)
    kh, kw = w.shape[:2]
    if padding == "SAME":
        pads = [_same_pads(x.shape[1], kh, stride[0]),
                _same_pads(x.shape[2], kw, stride[1])]
    elif padding == "VALID":
        pads = [(0, 0), (0, 0)]
    else:
        pads = [tuple(pp) for pp in padding]
    xc = x.permute(0, 3, 1, 2)
    (ht, hb), (wl, wr) = pads
    if ht or hb or wl or wr:
        xc = F.pad(xc, (wl, wr, ht, hb))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(stride),
                 groups=groups)
    y = y.permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def conv_transpose2d(p, x, stride: Tuple[int, int]):
    """NHWC transposed conv, output H*stride for kernel == stride. The
    HWIO kernel is applied as `lax.conv_transpose` does (spatially flipped
    relative to torch's ConvTranspose2d weight)."""
    w = p["kernel"].to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=tuple(stride))
    y = y.permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def embedding_lookup(p, ids):
    return p["embedding"][ids]


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def mlp_apply(p, x, act=torch.relu, sigmoid_output: bool = False):
    n = len(p["layers"])
    for i, layer in enumerate(p["layers"]):
        x = dense(layer, x)
        if i < n - 1:
            x = act(x)
    if sigmoid_output:
        x = torch.sigmoid(x)
    return x
