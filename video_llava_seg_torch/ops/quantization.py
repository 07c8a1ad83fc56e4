"""Symmetric int8 / int4 quantization of dense kernels and activations
(port of `video_llava_seg_tpu/ops/quantization.py`).

A quantized dense param is {"kernel_q" | "kernel_qa" | "kernel_q4a":
int8, "kernel_scale": fp32 [out], ("bias": ...)}; `nn.dense` dispatches
on the key:

- `kernel_q`: weight-only int8, converted to the compute dtype at use
  (`quantize_tree(bits=8)`);
- `kernel_qa`: W8A8, int8 weights and per-row int8 activations
  (`bits=8, act_quant=True`);
- `kernel_q4a`: W4A8, int4 weights packed two per byte
  (`ops/int4.py`, `bits=4, act_quant=True`).

Rounding is half to even (`torch.round`, as `jnp.round`) and every
division runs in fp32, so the int8 leaves are bit-equal to the JAX
package's. The divisors are tensors, never Python scalars: on CUDA
PyTorch divides by a scalar as a multiply by its fp32 reciprocal, which
is not the IEEE division the CPU, the JAX package and `csrc/w8a8.cu`
compute.
"""

from __future__ import annotations

from typing import Tuple

import torch

_QMAX = {8: 127.0, 4: 7.0}


def quantize_kernel(kernel: torch.Tensor, bits: int = 8):
    """Symmetric per-output-channel quantization of a [in, out] kernel.
    Returns (int8 [in, out], fp32 scale [out])."""
    qmax = _QMAX[bits]
    kf = kernel.float()
    amax = kf.abs().amax(dim=0)
    scale = amax / torch.full_like(amax, qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(kf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize_kernel(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale).to(dtype)


def quantize_tree(params, bits: int = 8, min_size: int = 1 << 16,
                  skip: Tuple[str, ...] = ("embed_tokens",),
                  act_quant: bool = False, train_mode: bool = False):
    """Quantize every 2-D dense 'kernel' leaf with at least `min_size`
    elements; embeddings (`skip`) and small kernels stay float. Under
    4-bit, kernels with an odd input dim stay float too (they cannot be
    packed two rows per byte). Returns a new tree.

    train_mode (the frozen base of a QLoRA tree): weight-only, with
    'kernel_scale' stored in bf16, which switches `nn.dense`'s kernel_q
    branch to an all-bf16 product (as in the JAX package)."""
    if bits not in _QMAX:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if train_mode and act_quant:
        raise ValueError("act-quant rounding has no gradient; train_mode "
                         "is weight-only")
    key_out = ("kernel_qa" if act_quant and bits == 8
               else "kernel_q4a" if act_quant else "kernel_q")

    def go(tree, path=()):
        if isinstance(tree, dict):
            kernel = tree.get("kernel")
            if (kernel is not None and not any(s in path for s in skip)
                    and kernel.dim() == 2 and kernel.numel() >= min_size
                    and not (key_out == "kernel_q4a"
                             and kernel.shape[0] % 2)):
                q, scale = quantize_kernel(kernel, bits)
                if key_out == "kernel_q4a":
                    from video_llava_seg_torch.ops.int4 import pack_int4
                    q = pack_int4(q)
                out = {k: v for k, v in tree.items() if k != "kernel"}
                out[key_out] = q
                out["kernel_scale"] = (scale.to(torch.bfloat16)
                                       if train_mode else scale)
                return out
            return {k: go(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [go(v, path) for v in tree]
        return tree

    return go(params)


def quantize_activations_rowwise(x: torch.Tensor):
    """Dynamic symmetric per-row int8 quantization.
    Returns (int8 [..., in], fp32 scale [..., 1]) with x ~ q * scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        amax / torch.full_like(amax, 127.0))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantized_nbytes(params) -> int:
    from video_llava_seg_torch.bridge import tree_map

    sizes = []
    tree_map(lambda t: sizes.append(t.numel() * t.element_size()), params)
    return sum(sizes)
