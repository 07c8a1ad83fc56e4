"""One ViT encoder layer (CLIP and RADIO towers), port of
`video_llava_seg_tpu/ops/vit_block.py` (`_vit_kernel`, K1, and its W8A8
form `_vit_kernel_i8`, K8).

LN1 -> q, k, v denses (q pre-scaled by 1/sqrt(hd)) -> per-frame SDPA with
keys at index >= kv_len masked -> out proj + residual -> LN2 ->
quick_gelu / gelu MLP + residual.

The TPU kernel holds a whole layer's weights in VMEM and runs the layer
in one launch. A layer's weights (~25 MB at CLIP-L) do not fit a Hopper
block's 227 KB of shared memory, so on CUDA the layer is a short chain
of the port's hand-written kernels that keeps the same math and masking
contract:

  layernorm_sm90.cu -> gemm_bf16_sm90.cu x3 (q with the scale fused,
  k, v) -> attention_sm90.cu (kv_len mask) -> gemm_bf16_sm90.cu (out
  proj + bias + residual) -> layernorm_sm90.cu -> gemm_bf16_sm90.cu (fc1
  + bias + activation) -> gemm_bf16_sm90.cu (fc2 + bias + residual)

(the LayerNorms on layernorm_sm90.cu at CLIP's and RADIO's widths, up to
1280; `kernels.layernorm_entry` sends wider ones to layernorm.cu)

Between launches only views and reshapes: q/k/v are read in place
through strides and the attention output lands in [frames, tokens,
heads, hd] order, ready for the out projection.

`vit_layer_plain` is the plain PyTorch version (the twin of
`vit_layer_xla`); the CPU path runs it.

A layer whose six denses are all `kernel_qa` (W8A8: int8 weights [in,
out] with fp32 per-column scales, `quantize_tree(bits=8,
act_quant=True)`) takes the K8 chain on CUDA, the same steps with every
dense an int8 product on the tensor cores and the activations quantized
per row in the kernels:

  ln_quant_rows -> gemm_s8 x3 (q with the bf16 attention scale, k, v) ->
  attention_sm90.cu (kv_len mask, scale 1) -> quant_rows -> gemm_s8 (out
  proj + bias + residual) -> ln_quant_rows -> gemm_s8 (fc1 + bias +
  activation) -> quant_rows -> gemm_s8 (fc2 + bias + residual)

(the row quantizers on w8a8_rows_sm90.cu at CLIP's and RADIO's widths,
the LayerNorm's scale and bias read as the tree stores them; gemm_s8 on
w8a8_sm90.cu where K and N are multiples of 16; `kernels.quant_rows_entry`
and `kernels.gemm_s8_entry` send other widths to csrc/w8a8.cu)

Each step rounds to bf16 where the TPU kernel does. A mixed or
weight-only quantized layer runs `vit_layer_plain` through `nn.dense` on
every device, as the JAX package runs such a layer in XLA. The W8A8 form
is forward only: the TPU kernel has no VJP (the activation rounding has
no useful gradient), so a call that autograd records raises.

When autograd records the call (training: the tower's weights are
trainable fp32 masters), the kernel chain runs inside
`ops.recompute.recompute`: the forward casts the weights to the input's
dtype (bf16) for the launches and saves only x and the weights, the
backward recomputes the layer through `vit_layer_plain` (the JAX
package's `_vl_bwd`).
"""

from __future__ import annotations

import math

import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.bridge import tree_map
from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.recompute import needs_grad, recompute

_MASK = -1e30
_ACTS = {"quick_gelu": nn.quick_gelu, "gelu": nn.gelu}


def vit_layer_plain(p, x, *, num_heads: int, eps: float, kv_len: int,
                    act: str = "quick_gelu"):
    """Plain PyTorch layer with the TPU kernel's semantics."""
    residual = x
    h = nn.layer_norm(p["layer_norm1"], x, eps)
    b, n, d = h.shape
    hd = d // num_heads
    q = nn.dense(p["q_proj"], h).reshape(b, n, num_heads, hd)
    k = nn.dense(p["k_proj"], h).reshape(b, n, num_heads, hd)
    v = nn.dense(p["v_proj"], h).reshape(b, n, num_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / math.sqrt(hd)
    if kv_len < n:
        s = s.masked_fill(torch.arange(n, device=x.device) >= kv_len, _MASK)
    p_att = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p_att.float(), v.float()).to(
        x.dtype).reshape(b, n, d)
    x = residual + nn.dense(p["out_proj"], o)
    residual = x
    h = nn.layer_norm(p["layer_norm2"], x, eps)
    h = nn.dense(p["fc2"], _ACTS[act](nn.dense(p["fc1"], h)))
    return residual + h


_DENSE_NAMES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


def layer_quant_kind(p):
    """None (all-float layer), 'w8a8' (all six denses `kernel_qa`) or
    'w8' (any other mix of quantized denses)."""
    kinds = set()
    for name in _DENSE_NAMES:
        d = p[name]
        kinds.add("kernel_qa" if "kernel_qa" in d
                  else "kernel_q" if "kernel_q" in d else "fp")
    if kinds == {"kernel_qa"}:
        return "w8a8"
    if kinds == {"fp"}:
        return None
    return "w8"


def _vit_layer_cuda_i8(p, x, *, num_heads: int, eps: float, kv_len: int,
                       act: str):
    bt, n, d = x.shape
    hd = d // num_heads
    dt = x.dtype
    x2 = x.reshape(bt * n, d)

    def ln(name):
        return p[name]["scale"], p[name]["bias"]

    def dense(name, xq, a_scale, **kw):
        w = p[name]
        bias = w.get("bias")
        return kernels.gemm_s8(
            xq, w["kernel_qa"], a_scale, w["kernel_scale"].float(),
            bias=None if bias is None else bias.to(dt).contiguous(), **kw)

    hq, h_s = kernels.ln_quant_rows(x2, *ln("layer_norm1"), eps)
    q = dense("q_proj", hq, h_s, scale=1.0 / math.sqrt(hd))
    k = dense("k_proj", hq, h_s)
    v = dense("v_proj", hq, h_s)

    def heads(t):
        return t.view(bt, n, num_heads, hd).permute(0, 2, 1, 3)

    o = kernels.attention(heads(q), heads(k), heads(v), scale=1.0,
                          kv_len=kv_len)
    cq, c_s = kernels.quant_rows(o.permute(0, 2, 1, 3).reshape(bt * n, d))
    h1 = dense("out_proj", cq, c_s, residual=x2)
    gq, g_s = kernels.ln_quant_rows(h1, *ln("layer_norm2"), eps)
    f = dense("fc1", gq, g_s, act=act)
    fq, f_s = kernels.quant_rows(f)
    y = dense("fc2", fq, f_s, residual=h1)
    return y.view(bt, n, d)


def _vit_layer_cuda(p, x, *, num_heads: int, eps: float, kv_len: int,
                    act: str):
    bt, n, d = x.shape
    hd = d // num_heads
    x2 = x.reshape(bt * n, d)
    h = kernels.layernorm(x2, p["layer_norm1"]["scale"],
                          p["layer_norm1"]["bias"], eps)
    q = kernels.gemm(h, p["q_proj"]["kernel"], p["q_proj"]["bias"],
                     scale=1.0 / math.sqrt(hd))
    k = kernels.gemm(h, p["k_proj"]["kernel"], p["k_proj"]["bias"])
    v = kernels.gemm(h, p["v_proj"]["kernel"], p["v_proj"]["bias"])

    def heads(t):
        return t.view(bt, n, num_heads, hd).permute(0, 2, 1, 3)

    o = kernels.attention(heads(q), heads(k), heads(v), scale=1.0,
                          kv_len=kv_len)
    o = o.permute(0, 2, 1, 3).reshape(bt * n, d)
    h1 = kernels.gemm(o, p["out_proj"]["kernel"], p["out_proj"]["bias"],
                      residual=x2)
    h2 = kernels.layernorm(h1, p["layer_norm2"]["scale"],
                           p["layer_norm2"]["bias"], eps)
    f = kernels.gemm(h2, p["fc1"]["kernel"], p["fc1"]["bias"], act=act)
    y = kernels.gemm(f, p["fc2"]["kernel"], p["fc2"]["bias"], residual=h1)
    return y.view(bt, n, d)


def vit_layer(p, x, *, num_heads: int, eps: float, kv_len: int = -1,
              act: str = "quick_gelu", kernel=None):
    """x: [frames, tokens, D]; keys at index >= kv_len are masked (pad
    tokens otherwise pass through token-locally).

    kernel: test-only stand-in for the CUDA chain, fn(p, x), so the CPU
    tests can drive the recompute Function."""
    if kv_len < 0:
        kv_len = x.shape[1]
    kw = dict(num_heads=num_heads, eps=eps, kv_len=kv_len, act=act)

    def plain(p_, x_):
        return vit_layer_plain(p_, x_, **kw)

    quant = layer_quant_kind(p)
    if quant == "w8":
        return plain(p, x)
    if quant == "w8a8":
        if needs_grad(p, x):
            raise NotImplementedError(
                "the W8A8 ViT layer is forward only (serving): its "
                "activation rounding has no gradient")
        if x.device.type == "cpu":
            return plain(p, x)
        if x.device.type != "cuda":
            raise ValueError(f"vit_layer: unsupported device {x.device}")
        kernels.LAUNCHES.add("K8")
        return _vit_layer_cuda_i8(p, x.contiguous(), **kw)
    if kernel is None:
        if x.device.type == "cpu":
            return plain(p, x)
        if x.device.type != "cuda":
            raise ValueError(f"vit_layer: unsupported device {x.device}")

        def kernel(p_, x_):
            kernels.LAUNCHES.add("K1")
            return _vit_layer_cuda(tree_map(lambda t: t.to(x_.dtype), p_),
                                   x_.contiguous(), **kw)
    if needs_grad(p, x):
        return recompute(kernel, plain, p, x)
    return kernel(p, x)
