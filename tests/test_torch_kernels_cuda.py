"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU or
interpret mode); elsewhere they skip. Inputs are bf16; the plain
reference runs in fp32 on the same bf16 values. Bound: max |kernel -
plain| / max |plain| <= 2e-2 (bf16 keeps ~3 significant digits and the
kernels round intermediates to bf16 where the plain fp32 path does not).
The W4A8 kernel (K5) sums integers and must equal its plain version bit
for bit. The flash backward (K6a / K6b) and the forward's logsumexp are
held against `flash_backward_plain` / `flash_forward_plain` in fp32 on
the same bf16 inputs, with the same bound; every kernel op's output must
carry a grad_fn when an input requires grad. K7 (window attention from
the fused-qkv map) is held against `window_attention_plain` in fp32 with
the same bound; K8's building blocks are exact where the TPU kernel's
arithmetic is (gemm_s8 bit-equal to the float64 int8 product and to
nn.dense's epilogue, quant_rows bit-equal to
`quantize_activations_rowwise`), and the whole W8A8 layer is held
against `vit_layer_plain` over the same quantized tree in bf16 (bound
3e-2: an int8 rounding flip of a bf16 activation moves a row by one
quantization step). K2 at head dim 128 (csrc/attention_sm90.cu, TMA +
wgmma) is held to the same bound, to its logsumexp within 1e-5 (both sum
exp() in fp32 over the same scores), and on a left-pad row that sees only
masked keys to the mean of its visible V rows. K6a / K6b at head dim 128
(csrc/attention_bwd_sm90.cu) are held to the plain backward with the same
bound, and on the left-pad rows, which the plain backward treats
differently, to attention_bwd.cu at the same inputs. Run on the card:
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import math

import pytest
import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.bridge import tree_map
from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.attention import (
    MASK_VALUE,
    attention,
    attention_reference,
    flash_backward_plain,
    flash_forward_plain,
)
from video_llava_seg_torch.ops.hiera_block import (
    hiera_block,
    hiera_block_plain,
)
from video_llava_seg_torch.ops.int4 import w4a8_dense, w4a8_matmul_plain
from video_llava_seg_torch.ops.vit_block import vit_layer, vit_layer_plain

pytestmark = pytest.mark.requires_cuda
BOUND = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()


def _f32(tree):
    return tree_map(lambda t: t.float(), tree)


def _randn(g, *shape, dev, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(
        torch.bfloat16)


def test_layernorm(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    for cols in (96, 1024, 100):
        x = _randn(g, 333, cols, dev=dev, scale=3.0)
        p = {"scale": _randn(g, cols, dev=dev), "bias": _randn(g, cols,
                                                               dev=dev)}
        got = kernels.layernorm(x, p["scale"], p["bias"], 1e-5)
        want = nn.layer_norm(_f32(p), x.float(), 1e-5)
        assert _rel(got, want) < BOUND


@pytest.mark.parametrize("act", ["none", "quick_gelu", "gelu"])
def test_gemm_epilogues(dev, act):
    g = torch.Generator(device=dev).manual_seed(1)
    m, k, n = 1000, 264, 392
    a = _randn(g, m, k, dev=dev)
    b = _randn(g, k, n, dev=dev, scale=1 / math.sqrt(k))
    bias = _randn(g, n, dev=dev)
    res = _randn(g, m, n, dev=dev)
    got = kernels.gemm(a, b, bias, residual=res, scale=0.5, act=act)
    y = (a.float() @ b.float() + bias.float()) * 0.5
    y = {"none": y, "quick_gelu": nn.quick_gelu(y), "gelu": nn.gelu(y)}[act]
    assert _rel(got, y + res.float()) < BOUND


def test_maxpool(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    x = _randn(g, 3, 14, 10, 96, dev=dev)
    want = x.float().reshape(3, 7, 2, 5, 2, 96).amax(dim=(2, 4))
    assert torch.equal(kernels.maxpool2x2(x).float(), want)


@pytest.mark.parametrize("sq,skv,hq,hkv,d,causal,mask", [
    (1500, 1500, 8, 2, 128, True, False),   # K2: causal GQA prefill
    (700, 1300, 4, 4, 64, True, True),      # K2: cross lengths + kv_bias
    (700, 1300, 4, 4, 128, True, True),     # K2 on attention_sm90.cu
    (4096, 7, 8, 8, 16, False, False),      # K3: mask-decoder shape
    (300, 1000, 2, 1, 96, False, True),     # K3: many keys, two walks
])
def test_attention_kernel(dev, sq, skv, hq, hkv, d, causal, mask):
    g = torch.Generator(device=dev).manual_seed(3)
    q = _randn(g, 2, hq, sq, d, dev=dev)
    k = _randn(g, 2, hkv, skv, d, dev=dev)
    v = _randn(g, 2, hkv, skv, d, dev=dev)
    kv_mask = None
    if mask:
        kv_mask = torch.ones(2, skv, dtype=torch.bool, device=dev)
        kv_mask[:, :50] = False
    before = kernels.LAUNCHES.snapshot()
    got = attention(q, k, v, causal=causal, kv_mask=kv_mask)
    name = "K3" if skv <= 1024 else "K2"
    assert kernels.LAUNCHES.snapshot()[name] == before[name] + 1
    want = attention_reference(q.float(), k.float(), v.float(),
                               causal=causal, kv_mask=kv_mask)
    rows = slice(50, None) if (mask and causal) else slice(None)
    assert _rel(got[:, :, rows], want[:, :, rows]) < BOUND


def _dense(g, din, dout, dev):
    return {"kernel": _randn(g, din, dout, dev=dev, scale=1 / math.sqrt(din)),
            "bias": _randn(g, dout, dev=dev, scale=0.1)}


def _ln(g, d, dev):
    return {"scale": (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
        torch.bfloat16), "bias": _randn(g, d, dev=dev, scale=0.1)}


def test_vit_layer_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    d, heads = 256, 4
    p = {"layer_norm1": _ln(g, d, dev), "layer_norm2": _ln(g, d, dev),
         "q_proj": _dense(g, d, d, dev), "k_proj": _dense(g, d, d, dev),
         "v_proj": _dense(g, d, d, dev), "out_proj": _dense(g, d, d, dev),
         "fc1": _dense(g, d, 4 * d, dev), "fc2": _dense(g, 4 * d, d, dev)}
    x = _randn(g, 3, 137, d, dev=dev)
    got = vit_layer(p, x, num_heads=heads, eps=1e-5, kv_len=130)
    want = vit_layer_plain(_f32(p), x.float(), num_heads=heads, eps=1e-5,
                           kv_len=130)
    assert _rel(got, want) < BOUND


@pytest.mark.parametrize("shape,heads,ws,ps,proj", [
    ((2, 32, 32, 96), 1, 8, 1, False),      # stage-1 windowed
    ((2, 32, 32, 96), 2, 8, 2, True),       # q-pool transition
    ((1, 16, 16, 192), 2, 14, 1, False),    # padded ws=14
    ((1, 16, 16, 192), 2, 0, 1, False),     # global
])
def test_hiera_block_kernel(dev, shape, heads, ws, ps, proj):
    g = torch.Generator(device=dev).manual_seed(5)
    b, h, w, din = shape
    dout = 2 * din if proj else din
    blk = {"norm1": _ln(g, din, dev), "norm2": _ln(g, dout, dev),
           "qkv": _dense(g, din, 3 * dout, dev),
           "proj_attn": _dense(g, dout, dout, dev),
           "mlp": {"layers": [_dense(g, dout, 4 * dout, dev),
                              _dense(g, 4 * dout, dout, dev)]}}
    if proj:
        blk["proj"] = _dense(g, din, dout, dev)
    x = _randn(g, *shape, dev=dev)
    q_stride = (ps, ps) if ps > 1 else None
    got = hiera_block(blk, x, num_heads=heads, ws=ws, q_stride=q_stride)
    want = hiera_block_plain(_f32(blk), x.float(), num_heads=heads, ws=ws,
                             q_stride=q_stride, eps=1e-6)
    assert got.shape == want.shape
    assert _rel(got, want) < BOUND


def _w4a8_inputs(g, rows, in_dim, out, dev):
    xq = torch.randint(-127, 128, (rows, in_dim), generator=g, device=dev,
                       dtype=torch.int8)
    packed = torch.randint(-128, 128, (in_dim // 2, out), generator=g,
                           device=dev, dtype=torch.int8)
    a_scale = torch.rand(rows, 1, generator=g, device=dev) * 0.05 + 1e-3
    w_scale = torch.rand(out, generator=g, device=dev) * 0.02 + 1e-4
    return xq, a_scale, packed, w_scale


@pytest.mark.parametrize("rows", [1, 2, 3, 8, 9, 130, 300])
@pytest.mark.parametrize("in_dim,out", [(256, 384), (4096, 6144),
                                        (14336, 4096), (136, 100)])
def test_w4a8_kernel_bit_exact(dev, rows, in_dim, out):
    """K5 equals its plain version bit for bit (integer sums, a fixed
    two-multiply epilogue), in both regimes and both output types."""
    g = torch.Generator(device=dev).manual_seed(6)
    xq, a_scale, packed, w_scale = _w4a8_inputs(g, rows, in_dim, out, dev)
    for dt in (torch.bfloat16, torch.float32):
        got = kernels.w4a8_matmul(xq, a_scale, packed, w_scale, dt)
        want = w4a8_matmul_plain(xq, a_scale, packed, w_scale, dt)
        assert got.dtype == dt
        assert torch.equal(got, want), (dt, (got.float() - want.float())
                                        .abs().max().item())


def test_w4a8_dense_counts_k5(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    _, _, packed, w_scale = _w4a8_inputs(g, 1, 512, 256, dev)
    p = {"kernel_q4a": packed, "kernel_scale": w_scale,
         "bias": _randn(g, 256, dev=dev)}
    x = _randn(g, 2, 5, 512, dev=dev)
    before = kernels.LAUNCHES.snapshot()["K5"]
    got = w4a8_dense(p, x)
    assert kernels.LAUNCHES.snapshot()["K5"] == before + 1
    want = w4a8_dense({k: v.cpu() for k, v in p.items()}, x.cpu())
    assert torch.equal(got.cpu(), want)


FLASH_CASES = {
    # name: (b, hq, hkv, sq, skv, d, causal, masked)
    "llm_causal_gqa": (1, 4, 2, 1100, 1100, 128, True, False),
    "cross_causal": (1, 2, 1, 300, 1200, 64, True, False),
    "bias_masked": (2, 2, 2, 200, 180, 32, False, True),
    "mask_decoder": (4, 8, 8, 4096, 7, 16, False, False),
    "odd_dims": (1, 3, 1, 77, 1030, 96, False, False),
    "bias_masked_d128": (2, 4, 1, 600, 1100, 128, False, True),
}


def _flash_inputs(name, dev):
    b, hq, hkv, sq, skv, d, causal, masked = FLASH_CASES[name]
    g = torch.Generator(device=dev).manual_seed(8)
    q = _randn(g, b, hq, sq, d, dev=dev)
    k = _randn(g, b, hkv, skv, d, dev=dev)
    v = _randn(g, b, hkv, skv, d, dev=dev)
    do = _randn(g, b, hq, sq, d, dev=dev)
    kv_mask = None
    if masked:
        kv_mask = torch.ones(b, skv, dtype=torch.bool, device=dev)
        kv_mask[0, 3:40] = False
        kv_mask[-1, -25:] = False
    return q, k, v, do, kv_mask, causal


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_attention_lse(dev, name):
    """K2 / K3 write the logsumexp of each row."""
    q, k, v, _, kv_mask, causal = _flash_inputs(name, dev)
    bias = (None if kv_mask is None else
            torch.where(kv_mask, 0.0, MASK_VALUE).float().contiguous())
    scale = 1.0 / math.sqrt(q.shape[-1])
    want_o, want_lse = flash_forward_plain(q.float(), k.float(), v.float(),
                                           bias, causal=causal, scale=scale)
    for two_pass in (False, True):
        o, lse = kernels.attention(q, k, v, scale=scale, causal=causal,
                                   kv_bias=bias, two_pass=two_pass,
                                   with_lse=True)
        assert _rel(o, want_o) < BOUND
        assert (lse - want_lse).abs().max().item() < 1e-2


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_backward(dev, name):
    """attention() under autograd: the forward saves the logsumexp, the
    backward launches K6a and K6b; masked keys get exactly zero dK/dV."""
    q, k, v, do, kv_mask, causal = _flash_inputs(name, dev)
    bias = (None if kv_mask is None else
            torch.where(kv_mask, 0.0, MASK_VALUE).float())
    scale = 1.0 / math.sqrt(q.shape[-1])
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = kernels.LAUNCHES.snapshot()
    out = attention(*leaves, causal=causal, kv_mask=kv_mask)
    assert out.grad_fn is not None
    out.backward(do)
    after = kernels.LAUNCHES.snapshot()
    assert after["K6a"] == before["K6a"] + 1
    assert after["K6b"] == before["K6b"] + 1
    qf, kf, vf = q.float(), k.float(), v.float()
    o32, lse32 = flash_forward_plain(qf, kf, vf, bias, causal=causal,
                                     scale=scale)
    want = flash_backward_plain(qf, kf, vf, bias, o32, lse32, do.float(),
                                causal=causal, scale=scale)
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.bfloat16
        assert _rel(t.grad, w) < BOUND
    if kv_mask is not None:
        for t in leaves[1:]:
            assert not t.grad.transpose(1, 2)[~kv_mask].any()


def test_kernel_ops_have_grad_fn(dev):
    """No CUDA op cuts the graph: K1, K2, K3 and K4 outputs carry a
    grad_fn when an input requires grad, and the K1 / K4 recompute
    gradients equal the plain layer's autograd."""
    g = torch.Generator(device=dev).manual_seed(9)
    q = _randn(g, 1, 2, 1100, 64, dev=dev).requires_grad_(True)
    kv = _randn(g, 1, 2, 1100, 64, dev=dev)
    assert attention(q, kv, kv, causal=True).grad_fn is not None
    assert attention(q[:, :, :300], kv[:, :, :7],
                     kv[:, :, :7]).grad_fn is not None
    d = 128
    p = {"layer_norm1": _ln(g, d, dev), "layer_norm2": _ln(g, d, dev),
         "q_proj": _dense(g, d, d, dev), "k_proj": _dense(g, d, d, dev),
         "v_proj": _dense(g, d, d, dev), "out_proj": _dense(g, d, d, dev),
         "fc1": _dense(g, d, 4 * d, dev), "fc2": _dense(g, 4 * d, d, dev)}
    p = tree_map(lambda t: t.float().requires_grad_(True), p)  # masters
    x = _randn(g, 2, 40, d, dev=dev).requires_grad_(True)
    y = vit_layer(p, x, num_heads=2, eps=1e-5)
    assert y.grad_fn is not None
    gy = _randn(g, *y.shape, dev=dev)
    got = torch.autograd.grad(y, [x, p["fc1"]["kernel"]], gy)
    want = torch.autograd.grad(
        vit_layer_plain(p, x, num_heads=2, eps=1e-5, kv_len=40),
        [x, p["fc1"]["kernel"]], gy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    blk = {"norm1": _ln(g, 64, dev), "norm2": _ln(g, 64, dev),
           "qkv": _dense(g, 64, 192, dev), "proj_attn": _dense(g, 64, 64, dev),
           "mlp": {"layers": [_dense(g, 64, 256, dev),
                              _dense(g, 256, 64, dev)]}}
    blk = tree_map(lambda t: t.float().requires_grad_(True), blk)
    xh = _randn(g, 2, 16, 16, 64, dev=dev).requires_grad_(True)
    yh = hiera_block(blk, xh, num_heads=2, ws=8)
    assert yh.grad_fn is not None
    gh = _randn(g, *yh.shape, dev=dev)
    got = torch.autograd.grad(yh, [xh, blk["qkv"]["kernel"]], gh)
    want = torch.autograd.grad(
        hiera_block_plain(blk, xh, num_heads=2, ws=8, q_stride=None,
                          eps=1e-6), [xh, blk["qkv"]["kernel"]], gh)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# K7 and K8 (the window attention and the W8A8 layer)
# ---------------------------------------------------------------------------

from video_llava_seg_torch.ops.int4 import int_matmul, int_matmul_plain  # noqa: E402
from video_llava_seg_torch.ops.quantization import (  # noqa: E402
    quantize_activations_rowwise,
    quantize_tree,
)
from video_llava_seg_torch.ops.window_attention import (  # noqa: E402
    window_attention,
    window_attention_plain,
)

W8A8_BOUND = 3e-2


@pytest.mark.parametrize("shape,heads,ws,ps", [
    ((2, 64, 64, 3 * 96), 1, 8, 1),      # hiera-small stage 1
    ((2, 64, 64, 3 * 96), 1, 8, 2),      # stage-1 -> 2 transition
    ((2, 32, 32, 3 * 192), 2, 4, 1),     # stage 2
    ((2, 32, 32, 3 * 192), 2, 4, 2),     # stage-2 -> 3 transition
    ((1, 28, 42, 3 * 384), 4, 14, 1),    # stage 3 (padded maps: 70)
    ((1, 28, 28, 3 * 384), 4, 14, 2),    # stage-3 -> 4 transition
    ((2, 14, 14, 3 * 768), 8, 7, 1),     # stage 4
    ((1, 16, 16, 3 * 64), 2, 16, 2),     # 256 keys, hd 32
    ((1, 16, 16, 3 * 144), 2, 8, 2),     # Hiera-L's hd 72, padded to 80
])
def test_window_attention_kernel(dev, shape, heads, ws, ps):
    g = torch.Generator(device=dev).manual_seed(10)
    qkv = _randn(g, *shape, dev=dev)
    q_pool = (ps, ps) if ps > 1 else None
    before = kernels.LAUNCHES.snapshot()["K7"]
    got = window_attention(qkv, num_heads=heads, ws=ws, q_pool=q_pool)
    assert kernels.LAUNCHES.snapshot()["K7"] == before + 1
    hd = shape[-1] // 3 // heads
    want = window_attention_plain(qkv.float(), num_heads=heads, ws=ws,
                                  scale=hd ** -0.5, ps=ps)
    assert got.shape == want.shape
    assert _rel(got, want) < BOUND


def test_attention_head_dim_80(dev):
    """RADIO ViT-H's 16 heads of 80 (the D = 80 instance)."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (_randn(g, 2, 16, 577, 80, dev=dev) for _ in range(3))
    for two_pass in (False, True):
        got = kernels.attention(q, k, v, scale=80 ** -0.5, kv_len=570,
                                two_pass=two_pass)
        want = attention_reference(q.float(), k.float(), v.float(),
                                   kv_valid_len=570)
        assert _rel(got, want) < BOUND


@pytest.mark.parametrize("m,k,n", [(1, 64, 4), (130, 1024, 1024),
                                   (577, 1280, 5120), (300, 4100, 36)])
def test_gemm_s8_bit_exact(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(12)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    want = int_matmul_plain(a, b)
    assert torch.equal(kernels.gemm_s8(a, b), want)
    assert torch.equal(int_matmul(a, b), want)
    # the dense epilogue: nn.dense's kernel_qa arithmetic, bit for bit
    a_s = torch.rand(m, 1, generator=g, device=dev) * 0.05 + 1e-3
    w_s = torch.rand(n, generator=g, device=dev) * 0.02 + 1e-4
    bias = _randn(g, n, dev=dev)
    res = _randn(g, m, n, dev=dev)
    y = (want.float() * a_s * w_s).to(torch.bfloat16) + bias
    assert torch.equal(kernels.gemm_s8(a, b, a_s, w_s, bias=bias), y)
    assert torch.equal(kernels.gemm_s8(a, b, a_s, w_s, bias=bias,
                                       residual=res), res + y)
    assert torch.equal(kernels.gemm_s8(a, b, a_s, w_s, bias=bias,
                                       scale=0.125), y * 0.125)


def test_quant_rows_bit_exact(dev):
    g = torch.Generator(device=dev).manual_seed(13)
    x = _randn(g, 333, 1280, dev=dev, scale=3.0)
    x[7] = 0
    q, s = kernels.quant_rows(x)
    wq, ws = quantize_activations_rowwise(x)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    ln = {"scale": torch.rand(1280, generator=g, device=dev) + 0.5,
          "bias": torch.randn(1280, generator=g, device=dev) * 0.1}
    q, s = kernels.ln_quant_rows(x, ln["scale"], ln["bias"], 1e-6)
    wq, ws = quantize_activations_rowwise(nn.layer_norm(ln, x, 1e-6))
    # the norm sums in another order: a bf16 value may move by one ulp
    assert (q.int() - wq.int()).abs().max().item() <= 1
    assert (q != wq).float().mean().item() < 1e-3
    torch.testing.assert_close(s, ws, rtol=1e-2, atol=0)


@pytest.mark.parametrize("d,heads,act", [(1024, 16, "quick_gelu"),
                                         (1280, 16, "gelu")])
def test_w8a8_layer_kernel(dev, d, heads, act):
    g = torch.Generator(device=dev).manual_seed(14)
    p = {"layer_norm1": _ln(g, d, dev), "layer_norm2": _ln(g, d, dev),
         "q_proj": _dense(g, d, d, dev), "k_proj": _dense(g, d, d, dev),
         "v_proj": _dense(g, d, d, dev), "out_proj": _dense(g, d, d, dev),
         "fc1": _dense(g, d, 4 * d, dev), "fc2": _dense(g, 4 * d, d, dev)}
    p = quantize_tree(p, 8, act_quant=True)
    x = _randn(g, 2, 577, d, dev=dev)
    before = kernels.LAUNCHES.snapshot()["K8"]
    got = vit_layer(p, x, num_heads=heads, eps=1e-6, kv_len=570, act=act)
    assert kernels.LAUNCHES.snapshot()["K8"] == before + 1
    want = vit_layer_plain(p, x, num_heads=heads, eps=1e-6, kv_len=570,
                           act=act)
    assert _rel(got, want) < W8A8_BOUND


# --- csrc/attention_sm90.cu: the online form at head dim 128 -------------

# |kernel lse - plain lse| in natural-log units (chip_smoke.py's LSE_BOUND)
LSE_BOUND = 1e-5

SM90_CASES = {
    # name: (b, hq, hkv, sq, skv, causal, kv_len)
    "ragged_causal": (1, 4, 4, 1000, 1000, True, None),   # no 128 multiple
    "cross_causal_gqa4": (1, 8, 2, 300, 1200, True, None),  # Sq < Skv
    "kv_len": (2, 2, 2, 500, 640, False, 600),
    "causal_kv_len_gqa4": (1, 8, 2, 700, 700, True, 650),
    "one_tile": (1, 1, 1, 57, 57, False, None),
}


@pytest.mark.parametrize("name", sorted(SM90_CASES))
def test_flash_sm90(dev, name):
    """The TMA + wgmma kernel against the plain forward: output within
    BOUND and logsumexp within LSE_BOUND, ragged lengths, Sq < Skv,
    kv_len < Skv, GQA groups 1 and 4."""
    b, hq, hkv, sq, skv, causal, kv_len = SM90_CASES[name]
    assert kernels.attention_entry(128, False) == "vls_flash_fwd_sm90"
    g = torch.Generator(device=dev).manual_seed(15)
    q = _randn(g, b, hq, sq, 128, dev=dev)
    k = _randn(g, b, hkv, skv, 128, dev=dev)
    v = _randn(g, b, hkv, skv, 128, dev=dev)
    scale = 128 ** -0.5
    o, lse = kernels.attention(q, k, v, scale=scale, causal=causal,
                               kv_len=-1 if kv_len is None else kv_len,
                               with_lse=True)
    # keys past kv_len as a mask bias: the same weights for every row that
    # sees a key
    bias = None
    if kv_len is not None:
        keep = torch.arange(skv, device=dev) < kv_len
        bias = torch.where(keep, 0.0, MASK_VALUE).float().expand(
            b, skv).contiguous()
    want_o, want_lse = flash_forward_plain(q.float(), k.float(), v.float(),
                                           bias, causal=causal, scale=scale)
    assert torch.isfinite(o.float()).all()
    assert _rel(o, want_o) < BOUND
    assert (lse - want_lse).abs().max().item() < LSE_BOUND


def _visible_mean(v, hq, sq, causal):
    """[B, Hq, Sq, D] fp32: each query row's mean over the V rows its
    causal diagonal lets it see, what the kernels give a row whose visible
    keys are all masked by the bias (their scores are all equal)."""
    b, hkv, skv, d = v.shape
    csum = v.float().cumsum(2)                     # [B, Hkv, Skv, D]
    last = (torch.arange(sq, device=v.device) + (skv - sq) if causal
            else torch.full((sq,), skv - 1, device=v.device))
    mean = csum[:, :, last] / (last + 1).float()[None, None, :, None]
    return mean.repeat_interleave(hq // hkv, dim=1)


def test_flash_sm90_left_pad_all_rows(dev):
    """The batch-2 prefill with row 1 left-padded (per-key bias): every
    row, pad rows included. Real rows match the plain forward; a pad row
    sees only masked keys, all its scores are the same finite number, and
    it gets the mean of its visible V rows (the plain versions give
    another finite value there, see test_torch_flash_sm90.py) with the
    mask value as its logsumexp."""
    g = torch.Generator(device=dev).manual_seed(16)
    b, hq, hkv, s, pad = 2, 8, 2, 1100, 333
    q = _randn(g, b, hq, s, 128, dev=dev)
    k = _randn(g, b, hkv, s, 128, dev=dev)
    v = _randn(g, b, hkv, s, 128, dev=dev)
    kv_mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    kv_mask[1, :pad] = False
    bias = torch.where(kv_mask, 0.0, MASK_VALUE).float().contiguous()
    before = kernels.LAUNCHES.snapshot()["K2"]
    o = attention(q, k, v, causal=True, kv_mask=kv_mask)
    assert kernels.LAUNCHES.snapshot()["K2"] == before + 1
    o, lse = kernels.attention(q, k, v, scale=128 ** -0.5, causal=True,
                               kv_bias=bias, with_lse=True)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    want_o, want_lse = flash_forward_plain(q.float(), k.float(), v.float(),
                                           bias, causal=True)
    want_o[1, :, :pad] = _visible_mean(v, hq, s, True)[1, :, :pad]
    assert _rel(o, want_o) < BOUND
    assert (lse[0] - want_lse[0]).abs().max().item() < LSE_BOUND
    assert (lse[1, :, pad:] - want_lse[1, :, pad:]).abs().max().item() \
        < LSE_BOUND
    assert torch.equal(lse[1, :, :pad],
                       torch.full_like(lse[1, :, :pad], MASK_VALUE))


def test_flash_sm90_fused_qkv_views(dev):
    """q, k and v as the LLM builds them: column slices of one fused-qkv
    [B, S, (Hq + 2 Hkv) D] buffer, viewed [B, S, H, D] and transposed.
    The kernel reads them through their strides: bit-equal to the same
    call on contiguous copies, and within BOUND of the plain forward."""
    g = torch.Generator(device=dev).manual_seed(17)
    b, s, hq, hkv, d = 2, 777, 8, 2, 128
    qkv = _randn(g, b, s, (hq + 2 * hkv) * d, dev=dev)
    q = qkv[..., :hq * d].reshape(b, s, hq, d).transpose(1, 2)
    k = qkv[..., hq * d:(hq + hkv) * d].reshape(b, s, hkv, d).transpose(1, 2)
    v = qkv[..., (hq + hkv) * d:].reshape(b, s, hkv, d).transpose(1, 2)
    assert not q.is_contiguous()
    got = kernels.attention(q, k, v, scale=d ** -0.5, causal=True)
    same = kernels.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             scale=d ** -0.5, causal=True)
    assert torch.equal(got, same)
    want, _ = flash_forward_plain(q.float(), k.float(), v.float(),
                                  causal=True)
    assert _rel(got, want) < BOUND


def test_flash_sm90_autograd(dev):
    """attention() under autograd at head dim 128: _FlashAttention's
    forward runs the new kernel with the logsumexp, K6a / K6b read it."""
    g = torch.Generator(device=dev).manual_seed(18)
    q = _randn(g, 1, 8, 1300, 128, dev=dev)
    k = _randn(g, 1, 2, 1300, 128, dev=dev)
    v = _randn(g, 1, 2, 1300, 128, dev=dev)
    do = _randn(g, 1, 8, 1300, 128, dev=dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = kernels.LAUNCHES.snapshot()
    out = attention(*leaves, causal=True)
    out.backward(do)
    after = kernels.LAUNCHES.snapshot()
    assert [after[n] - before[n] for n in ("K2", "K6a", "K6b")] == [1, 1, 1]
    qf, kf, vf = q.float(), k.float(), v.float()
    o32, lse32 = flash_forward_plain(qf, kf, vf, None, causal=True)
    want = flash_backward_plain(qf, kf, vf, None, o32, lse32, do.float(),
                                causal=True, scale=128 ** -0.5)
    assert _rel(out, o32) < BOUND
    for t, w in zip(leaves, want):
        assert _rel(t.grad, w) < BOUND


# --- csrc/attention_bwd_sm90.cu: K6a / K6b at head dim 128 ---------------

SM90_BWD_NAMES = ("vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90")
SM90_BWD_CASES = {
    # name: (b, hq, hkv, sq, skv, causal, masked)
    "ragged_causal_gqa1": (1, 4, 4, 1000, 1000, True, False),  # no 64 mult.
    "ragged_causal_gqa4": (1, 8, 2, 777, 777, True, False),
    "cross_causal_gqa4": (1, 8, 2, 300, 1200, True, False),    # Sq < Skv
    "bias_2048": (2, 8, 2, 2048, 2048, False, True),  # chip_smoke's case
    "one_tile": (1, 1, 1, 57, 57, False, False),
}


def _bwd_inputs(seed, b, hq, hkv, sq, skv, masked, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = _randn(g, b, hq, sq, 128, dev=dev)
    k = _randn(g, b, hkv, skv, 128, dev=dev)
    v = _randn(g, b, hkv, skv, 128, dev=dev)
    do = _randn(g, b, hq, sq, 128, dev=dev)
    kv_mask = bias = None
    if masked:
        kv_mask = torch.ones(b, skv, dtype=torch.bool, device=dev)
        kv_mask[0, 100:141] = False
        kv_mask[-1, :337] = False
        bias = torch.where(kv_mask, 0.0, MASK_VALUE).float().contiguous()
    return q, k, v, do, kv_mask, bias


@pytest.mark.parametrize("name", sorted(SM90_BWD_CASES))
def test_flash_bwd_sm90(dev, name):
    """The TMA + wgmma backward against the plain backward on the kernel
    forward's output and logsumexp: dQ, dK, dV within BOUND and delta =
    rowsum(dO * O); ragged lengths, GQA 1 and 4, Sq < Skv under the causal
    mask, the 2048-key per-key bias with its masked keys at exactly zero
    dK and dV."""
    b, hq, hkv, sq, skv, causal, masked = SM90_BWD_CASES[name]
    assert kernels.attention_bwd_entry(128) == SM90_BWD_NAMES
    q, k, v, do, kv_mask, bias = _bwd_inputs(19, b, hq, hkv, sq, skv,
                                             masked, dev)
    kw = dict(scale=128 ** -0.5, causal=causal, kv_bias=bias)
    out, lse = kernels.attention(q, k, v, with_lse=True, **kw)
    dq, delta = kernels.attention_bwd_dq(q, k, v, out, do, lse, **kw)
    dk, dv = kernels.attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    want = flash_backward_plain(q.float(), k.float(), v.float(), bias,
                                out.float(), lse, do.float(), causal=causal,
                                scale=128 ** -0.5)
    for got, w in zip((dq, dk, dv), want):
        assert torch.isfinite(got.float()).all()
        assert _rel(got, w) < BOUND
    rowsum = (do.float() * out.float()).sum(-1)
    assert (delta - rowsum).abs().max().item() < 1e-4 * max(
        rowsum.abs().max().item(), 1.0)
    if kv_mask is not None:
        for g in (dk, dv):
            assert not g.transpose(1, 2)[~kv_mask].any()


def test_flash_bwd_sm90_left_pad_all_rows(dev):
    """The batch-2 causal train shape with row 1 left-padded (per-key
    bias): a pad query row sees only masked keys, its lse is the mask
    value, and both backward kernels give its visible keys p = 1. Every
    row of dQ and every key of dK / dV against attention_bwd.cu at the
    same inputs; real rows also against the plain backward (whose pad rows
    differ: it gives causally masked keys the mask value, not -inf)."""
    b, hq, hkv, s, pad = 2, 8, 2, 1100, 333
    g = torch.Generator(device=dev).manual_seed(20)
    q = _randn(g, b, hq, s, 128, dev=dev)
    k = _randn(g, b, hkv, s, 128, dev=dev)
    v = _randn(g, b, hkv, s, 128, dev=dev)
    do = _randn(g, b, hq, s, 128, dev=dev)
    kv_mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    kv_mask[1, :pad] = False
    bias = torch.where(kv_mask, 0.0, MASK_VALUE).float().contiguous()
    kw = dict(scale=128 ** -0.5, causal=True, kv_bias=bias)
    out, lse = kernels.attention(q, k, v, with_lse=True, **kw)
    dq, delta = kernels.attention_bwd_dq(q, k, v, out, do, lse, **kw)
    dk, dv = kernels.attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    odq, odelta = kernels._attention_bwd_dq(
        "vls_attention_bwd_dq", q, k, v, out, do, lse, **kw)
    odk, odv = kernels._attention_bwd_dkv(
        "vls_attention_bwd_dkv", q, k, v, do, lse, odelta, **kw)
    for got, old in ((dq, odq), (dk, odk), (dv, odv)):
        assert torch.isfinite(got.float()).all()
        assert _rel(got, old) < BOUND
        assert _rel(got[1], old[1]) < BOUND
    assert _rel(dq[1, :, :pad], odq[1, :, :pad]) < BOUND
    assert (delta - odelta).abs().max().item() < 1e-3
    want = flash_backward_plain(q.float(), k.float(), v.float(), bias,
                                out.float(), lse, do.float(), causal=True,
                                scale=128 ** -0.5)
    assert _rel(dq[0], want[0][0]) < BOUND
    assert _rel(dq[1, :, pad:], want[0][1, :, pad:]) < BOUND


def test_flash_bwd_sm90_fused_qkv_views(dev):
    """q, k, v as column slices of one fused-qkv buffer and dO as the
    head-merge view of a [B, S, Hq * D] gradient: read in place through
    their strides, bit-equal to the same calls on contiguous copies."""
    g = torch.Generator(device=dev).manual_seed(21)
    b, s, hq, hkv, d = 2, 777, 8, 2, 128
    qkv = _randn(g, b, s, (hq + 2 * hkv) * d, dev=dev)
    q = qkv[..., :hq * d].reshape(b, s, hq, d).transpose(1, 2)
    k = qkv[..., hq * d:(hq + hkv) * d].reshape(b, s, hkv, d).transpose(1, 2)
    v = qkv[..., (hq + hkv) * d:].reshape(b, s, hkv, d).transpose(1, 2)
    do = _randn(g, b, s, hq * d, dev=dev).reshape(b, s, hq, d).transpose(
        1, 2)
    kw = dict(scale=d ** -0.5, causal=True)
    out, lse = kernels.attention(q, k, v, with_lse=True, **kw)

    def grads(q, k, v, do):
        dq, delta = kernels.attention_bwd_dq(q, k, v, out, do, lse, **kw)
        return (dq, delta) + kernels.attention_bwd_dkv(q, k, v, do, lse,
                                                       delta, **kw)

    got = grads(q, k, v, do)
    same = grads(*(t.contiguous() for t in (q, k, v, do)))
    for a, c in zip(got, same):
        assert torch.equal(a, c)


def test_flash_bwd_sm90_autograd(dev):
    """attention() under autograd at head dim 128 with a key mask: one K2,
    K6a and K6b launch each, gradients within BOUND of the plain backward
    and masked keys at exactly zero."""
    b, hq, hkv, s = 2, 8, 2, 1300
    q, k, v, do, kv_mask, bias = _bwd_inputs(22, b, hq, hkv, s, s, True, dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = kernels.LAUNCHES.snapshot()
    out = attention(*leaves, kv_mask=kv_mask)
    out.backward(do)
    after = kernels.LAUNCHES.snapshot()
    assert [after[n] - before[n] for n in ("K2", "K6a", "K6b")] == [1, 1, 1]
    qf, kf, vf = q.float(), k.float(), v.float()
    o32, lse32 = flash_forward_plain(qf, kf, vf, bias)
    want = flash_backward_plain(qf, kf, vf, bias, o32, lse32, do.float(),
                                scale=128 ** -0.5)
    for t, w in zip(leaves, want):
        assert _rel(t.grad, w) < BOUND
    for t in leaves[1:]:
        assert not t.grad.transpose(1, 2)[~kv_mask].any()
