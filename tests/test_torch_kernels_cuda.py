"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU or
interpret mode); elsewhere they skip. Inputs are bf16; the plain
reference runs in fp32 on the same bf16 values. Bound: max |kernel -
plain| / max |plain| <= 2e-2 (bf16 keeps ~3 significant digits and the
kernels round intermediates to bf16 where the plain fp32 path does not).
The W4A8 kernels (K5: csrc/w4a8_sm90.cu above 8 rows at TMA-aligned
widths, csrc/w4a8_gemv_sm90.cu at <= 8 rows there, csrc/w4a8.cu
elsewhere) sum integers and must equal their plain version bit for bit,
on the route `kernels.w4a8_entry` names; the decode kernel also at the
full Llama-3-8B widths, over two calls, in a CUDA-graph replay and
against w4a8.cu's GEMV. The flash backward (K6a / K6b) and the
forward's logsumexp are held against `flash_backward_plain` / `flash_forward_plain` in fp32 on
the same bf16 inputs, with the same bound; every kernel op's output must
carry a grad_fn when an input requires grad. K7 (window attention from
the fused-qkv map) is held against `window_attention_plain` in fp32 with
the same bound, and at head dim 96 (csrc/window_attention_sm90.cu, TMA +
wgmma) at the seven Hiera-S kinds within 1e-2, two calls bit-identical,
its crop equal to the full map's; K4's windowed blocks take it (one
launch a block, no attention launch, pool_sm90.cu only for the
shortcut);
K8's building blocks are exact where the TPU kernel's arithmetic is
(gemm_s8, csrc/w8a8_sm90.cu where K and N are multiples of 16 and
csrc/w8a8.cu elsewhere, bit-equal to the float64 int8 product, to
nn.dense's epilogue, to `gemm_s8_plain` in every epilogue and to each
other; quant_rows bit-equal to `quantize_activations_rowwise`), and the
whole W8A8 layer is held against `vit_layer_plain` over the same
quantized tree in bf16 (bound 3e-2: an int8 rounding flip of a bf16
activation moves a row by one quantization step). K2 at head dim 128
(csrc/attention_sm90.cu, TMA + wgmma) is held to the same bound, to its
logsumexp within 1e-5 (both sum exp() in fp32 over the same scores), and
on a left-pad row that sees only masked keys to the mean of its visible
V rows. K3 at head dim 16 over at most 64 keys
(csrc/attention_short_sm90.cu) is held to the same bounds on the mask
decoder's [B, S, H, 16] views, and a row no key is visible to at O = 0,
lse = 0. The online form at head dims 64 / 80 / 96
(csrc/attention_sm90.cu, persistent) is held to the plain forward within
1e-2 relative (chip_smoke.py's BOUNDS["K2"]), to its logsumexp within
1e-5, to attention_reference and to attention.cu (forced by `route`) at
the towers' links, the trunk's global block, 577 rows with kv_len, Sq <
64, GQA and causal cases, and a row no key is visible to at O = 0, lse =
0; K1 and K4 take it on the card. K6a / K6b at head dim 128
(csrc/attention_bwd_sm90.cu) are held to the plain backward with the
same bound, and on the left-pad rows, which the plain backward treats
differently, to attention_bwd.cu at the same inputs. K6a + K6b in one
pass at head dim 16 over at most 64 keys
(csrc/attention_short_bwd_sm90.cu) are held to the plain backward with
the same bound on the mask decoder's views, GQA, causal and bias cases,
with masked keys at exactly zero dK / dV, a row no key is visible to at
dQ = 0, and two calls bit-identical. At head dim 256 (SAM2's memory
attention: csrc/attention_sm90.cu with 64-key K / V tiles) the online
form is held to the plain forward within 1e-2 and to its logsumexp at
memory attention's self and full-bank cross shapes, a ragged bank, the
two-pass form and a causal kv_len case; a memory-attention layer at full
width takes it twice and stays within BOUND of the fp32 plain layer; a
K4 global block at Hiera-L's head dim 72 takes attention_sm90.cu
zero-padded to 80.
Run on the card:
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


# rows: the decode kernel (1-8), then w4a8_sm90.cu's 128-row tiles whole
# (128, 256), one row past them (129, 257) and partial (9, 130, 200, 300);
# widths: in/2 = 2080 leaves a 32-row K tail past the 128-row box, out =
# 272 a partial channel tile; (136, 100) stays on w4a8.cu (its GEMV and
# its mma.sync tile)
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8, 9, 128, 129, 130,
                                  200, 256, 257, 300])
@pytest.mark.parametrize("in_dim,out", [(256, 384), (4096, 6144),
                                        (14336, 4096), (136, 100),
                                        (4160, 272)])
def test_w4a8_kernel_bit_exact(dev, rows, in_dim, out):
    """K5 equals its plain version bit for bit (integer sums, a fixed
    two-multiply epilogue), in every regime and both output types, on the
    route `w4a8_entry` names."""
    g = torch.Generator(device=dev).manual_seed(6)
    xq, a_scale, packed, w_scale = _w4a8_inputs(g, rows, in_dim, out, dev)
    entry = kernels.w4a8_entry(rows, in_dim // 2, out)
    aligned = out % 16 == 0 and (in_dim // 2) % 16 == 0
    assert entry == ("vls_w4a8" if not aligned else "vls_w4a8_sm90"
                     if rows > 8 else "vls_w4a8_gemv_sm90")
    for dt in (torch.bfloat16, torch.float32):
        got = kernels.w4a8_matmul(xq, a_scale, packed, w_scale, dt)
        want = w4a8_matmul_plain(xq, a_scale, packed, w_scale, dt)
        assert got.dtype == dt
        assert torch.equal(got, want), (dt, (got.float() - want.float())
                                        .abs().max().item())


@pytest.mark.parametrize("in_dim,out", [(4096, 6144), (4096, 4096),
                                        (4096, 28672), (14336, 4096)])
def test_w4a8_sm90_llama_prefill_shape(dev, in_dim, out):
    """The Llama-3-8B denses at ~1,000 prefill rows reach w4a8_sm90.cu
    through `w4a8_matmul` and equal the plain version bit for bit; the
    mma.sync tile of w4a8.cu, named by `route`, gives the same bits."""
    rows = 1000
    assert kernels.w4a8_entry(rows, in_dim // 2, out) == "vls_w4a8_sm90"
    g = torch.Generator(device=dev).manual_seed(8)
    xq, a_scale, packed, w_scale = _w4a8_inputs(g, rows, in_dim, out, dev)
    want = w4a8_matmul_plain(xq, a_scale, packed, w_scale, torch.bfloat16)
    got = kernels.w4a8_matmul(xq, a_scale, packed, w_scale, torch.bfloat16)
    assert torch.equal(got, want)
    old = kernels.w4a8_matmul(xq, a_scale, packed, w_scale, torch.bfloat16,
                              route="vls_w4a8")
    assert torch.equal(old, want)


# the fused Llama-3-8B denses of a decode step and the lm_head
LLAMA_DECODE = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                (4096, 128256)]


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("in_dim,out", LLAMA_DECODE)
def test_w4a8_gemv_sm90_llama_decode(dev, rows, in_dim, out):
    """Every Llama-3-8B decode dense at 1 and 2 rows reaches
    w4a8_gemv_sm90.cu and equals the plain version bit for bit in both
    output types; w4a8.cu's GEMV, named by `route`, gives the same bits;
    each call counts one launch of its C entry."""
    assert kernels.w4a8_entry(rows, in_dim // 2, out) == "vls_w4a8_gemv_sm90"
    g = torch.Generator(device=dev).manual_seed(11)
    xq, a_scale, packed, w_scale = _w4a8_inputs(g, rows, in_dim, out, dev)
    for dt in (torch.bfloat16, torch.float32):
        before = kernels.W4A8_LAUNCHES.snapshot()
        got = kernels.w4a8_matmul(xq, a_scale, packed, w_scale, dt)
        old = kernels.w4a8_matmul(xq, a_scale, packed, w_scale, dt,
                                  route="vls_w4a8")
        after = kernels.W4A8_LAUNCHES.snapshot()
        want = w4a8_matmul_plain(xq, a_scale, packed, w_scale, dt)
        assert torch.equal(got, want)
        assert torch.equal(old, want)
        assert {e: after[e] - before[e] for e in after} == {
            "vls_w4a8": 1, "vls_w4a8_sm90": 0, "vls_w4a8_gemv_sm90": 1}


@pytest.mark.parametrize("rows,in_dim,out", [(2, 4096, 4096),
                                             (8, 14336, 4096),
                                             (3, 4160, 272)])
def test_w4a8_gemv_sm90_calls_repeat_bitwise(dev, rows, in_dim, out):
    """Two calls give the same bits (the K parts' sums are integers, added
    in a fixed order)."""
    g = torch.Generator(device=dev).manual_seed(12)
    xq, a_scale, packed, w_scale = _w4a8_inputs(g, rows, in_dim, out, dev)
    first = kernels.w4a8_matmul(xq, a_scale, packed, w_scale, torch.bfloat16)
    second = kernels.w4a8_matmul(xq, a_scale, packed, w_scale,
                                 torch.bfloat16)
    assert torch.equal(first, second)


def test_w4a8_gemv_sm90_graph_replay(dev):
    """A CUDA graph of three decode calls (wo and w_down: K split in
    clusters; the lm_head: whole tiles) replays to the eager results,
    three replays in a row."""
    g = torch.Generator(device=dev).manual_seed(13)
    cases = [(_w4a8_inputs(g, 2, i, o, dev), dt) for i, o, dt in
             ((4096, 4096, torch.bfloat16), (14336, 4096, torch.bfloat16),
              (4096, 128256, torch.float32))]
    run = [lambda c=c, dt=dt: kernels.w4a8_matmul(*c, dt) for c, dt in cases]
    eager = [f() for f in run]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in run:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in run]
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


def test_w4a8_sm90_row_slice_of_a_larger_tensor(dev):
    """Rows 16..16+300 of a larger activation tensor (a row stride the
    tensor maps address, no copy) give the plain product of that slice."""
    g = torch.Generator(device=dev).manual_seed(9)
    xq, a_scale, packed, w_scale = _w4a8_inputs(g, 400, 512, 256, dev)
    got = kernels.w4a8_matmul(xq[16:316], a_scale[16:316], packed, w_scale,
                              torch.float32)
    want = w4a8_matmul_plain(xq[16:316], a_scale[16:316], packed, w_scale,
                             torch.float32)
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("lead", [(1, 3), (2, 5), (2, 150)])
def test_w4a8_dense_route_on_the_card(dev, lead):
    """The bf16 dense on the card, one K5 launch, equals the CPU result on
    each route: 3 rows w4a8_gemv_sm90.cu, 10 and 300 rows
    w4a8_sm90.cu."""
    g = torch.Generator(device=dev).manual_seed(10)
    _, _, packed, w_scale = _w4a8_inputs(g, 1, 512, 256, dev)
    p = {"kernel_q4a": packed, "kernel_scale": w_scale,
         "bias": _randn(g, 256, dev=dev)}
    x = _randn(g, *lead, 512, dev=dev)
    rows = math.prod(lead)
    assert kernels.w4a8_entry(rows, 256, 256) == (
        "vls_w4a8_sm90" if rows > 8 else "vls_w4a8_gemv_sm90")
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

from video_llava_seg_torch.ops.int4 import (  # noqa: E402
    gemm_s8_plain,
    int_matmul,
    int_matmul_plain,
)
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


# window_attention_sm90.cu at the seven window kinds of SAM2.1-hiera-small
# at 1024^2 (head dim 96; batch 1-2 of the 8 frames): two heads and more,
# pad keys (ws 7: 49 of 64, ws 14: 196 of 208), packed windows (ws 4, the
# pooled ws 4 / 8); then Hiera-L's kinds (head dim 72: ws 16's 256-key
# tile plain and pooled) and Hiera-B+'s (head dim 56) at smaller maps
WINDOW_SM90_KINDS = [
    ((1, 256, 256, 3 * 96), 1, 8, 1),
    ((1, 256, 256, 3 * 192), 2, 8, 2),
    ((2, 128, 128, 3 * 192), 2, 4, 1),
    ((2, 128, 128, 3 * 384), 4, 4, 2),
    ((2, 70, 70, 3 * 384), 4, 14, 1),
    ((2, 70, 70, 3 * 768), 8, 14, 2),
    ((2, 35, 35, 3 * 768), 8, 7, 1),
    ((1, 64, 64, 3 * 144), 2, 8, 1),
    ((1, 64, 64, 3 * 288), 4, 8, 2),
    ((2, 32, 32, 3 * 288), 4, 4, 1),
    ((2, 32, 32, 3 * 576), 8, 4, 2),
    ((2, 32, 32, 3 * 576), 8, 16, 1),
    ((2, 32, 32, 3 * 1152), 16, 16, 2),
    ((1, 64, 64, 3 * 112), 2, 8, 1),
    ((1, 64, 64, 3 * 224), 4, 8, 2),
    ((2, 32, 32, 3 * 224), 4, 4, 1),
    ((2, 32, 32, 3 * 448), 8, 4, 2),
    ((2, 28, 28, 3 * 448), 8, 14, 1),
    ((2, 28, 28, 3 * 896), 16, 14, 2),
    ((2, 14, 14, 3 * 896), 16, 7, 1),
]
WINDOW_BOUND = 1e-2  # chip_smoke.py's BOUNDS["K7"]


@pytest.mark.parametrize("shape,heads,ws,ps", WINDOW_SM90_KINDS)
def test_window_attention_sm90_kinds(dev, shape, heads, ws, ps):
    """K7 takes window_attention_sm90.cu at every Hiera-S / L / B+ kind:
    within 1e-2 of the plain version in fp32, two calls bit-identical, its crop
    (out_hw) equal to the full map's, and window_attention.cu (forced)
    within the same bound."""
    g = torch.Generator(device=dev).manual_seed(12)
    qkv = _randn(g, *shape, dev=dev)
    q_pool = (ps, ps) if ps > 1 else None
    hd = shape[-1] // 3 // heads
    assert kernels.window_entry(hd, ws, ps) == kernels.WINDOW_SM90_ENTRY
    before = kernels.WINDOW_LAUNCHES.snapshot()
    got = window_attention(qkv, num_heads=heads, ws=ws, q_pool=q_pool)
    after = kernels.WINDOW_LAUNCHES.snapshot()
    assert after[kernels.WINDOW_SM90_ENTRY] == \
        before[kernels.WINDOW_SM90_ENTRY] + 1
    assert after["vls_window_attention"] == before["vls_window_attention"]
    want = window_attention_plain(qkv.float(), num_heads=heads, ws=ws,
                                  scale=hd ** -0.5, ps=ps)
    assert got.shape == want.shape
    assert _rel(got, want) < WINDOW_BOUND
    again = window_attention(qkv, num_heads=heads, ws=ws, q_pool=q_pool)
    assert torch.equal(got, again)
    oh, ow = shape[1] // ps - 3, shape[2] // ps - 1
    crop = kernels.window_attention(qkv, num_heads=heads, ws=ws,
                                    scale=hd ** -0.5, ps=ps, out_hw=(oh, ow))
    assert crop.is_contiguous() and torch.equal(crop, got[:, :oh, :ow])
    old = kernels.window_attention(qkv, num_heads=heads, ws=ws,
                                   scale=hd ** -0.5, ps=ps,
                                   route="vls_window_attention")
    assert _rel(old, want) < WINDOW_BOUND


@pytest.mark.parametrize("hd,ws,ps", [(72, 16, 1), (72, 16, 2), (72, 8, 1),
                                      (56, 14, 1), (56, 4, 2), (96, 8, 1)])
def test_window_attention_sm90_nonfinite_neighbour(dev, hd, ws, ps):
    """A head whose q, k and v hold inf and NaN leaves every other head's
    output equal to what it is without them: the tail box's columns past
    a head are TMA's zeros, never the next head's values."""
    g = torch.Generator(device=dev).manual_seed(14)
    heads, side = 3, 2 * ws
    qkv = _randn(g, 1, side, side, 3 * heads * hd, dev=dev)
    bad = qkv.clone().view(1, side, side, 3, heads, hd)
    bad[..., 1, :] = float("nan")
    bad[..., 1, ::2] = float("inf")
    kw = dict(num_heads=heads, ws=ws, scale=hd ** -0.5, ps=ps)
    want = kernels.window_attention(qkv, **kw)
    got = kernels.window_attention(bad.view_as(qkv), **kw)
    cut = lambda t: t.view(*t.shape[:3], heads, hd)[..., ::2, :]  # noqa
    assert torch.equal(cut(got), cut(want))
    assert torch.isfinite(cut(got)).all()


def test_window_attention_sm90_refusals_on_the_card(dev):
    """The new route at a head dim or window it does not take raises
    before any launch."""
    qkv = torch.zeros((1, 16, 16, 3 * 128), device=dev, dtype=torch.bfloat16)
    before = kernels.WINDOW_LAUNCHES.snapshot()
    with pytest.raises(ValueError, match="serves head dims"):
        kernels.window_attention(qkv, num_heads=2, ws=8, scale=0.1,
                                 route=kernels.WINDOW_SM90_ENTRY)
    with pytest.raises(ValueError, match="serves head dims"):
        kernels.window_attention(qkv[..., :3 * 96].contiguous(), num_heads=1,
                                 ws=16, scale=0.1,
                                 route=kernels.WINDOW_SM90_ENTRY)
    assert kernels.WINDOW_LAUNCHES.snapshot() == before


# K4's windowed blocks at head dim 96: (shape, heads, ws, ps, proj)
HIERA_WINDOW_KINDS = [
    ((2, 32, 32, 96), 1, 8, 1, False),
    ((2, 32, 32, 96), 2, 8, 2, True),
    ((2, 16, 16, 192), 2, 4, 1, False),
    ((2, 16, 16, 192), 4, 4, 2, True),
    ((1, 16, 16, 384), 4, 14, 1, False),   # padded to 28
    ((1, 16, 16, 384), 8, 14, 2, True),    # padded to 28, pooled to 8
    ((2, 8, 8, 768), 8, 7, 1, False),      # padded to 14
    # Hiera-B+ / L's head dims 56 / 72
    ((2, 32, 32, 112), 2, 8, 1, False),
    ((1, 16, 16, 144), 4, 8, 2, True),
    ((1, 16, 16, 144), 2, 14, 1, False),   # padded to 28
    ((2, 32, 32, 576), 8, 16, 1, False),   # Hiera-L's ws 16
    ((1, 32, 32, 576), 16, 16, 2, True),   # its pooled ws 16
]


@pytest.mark.parametrize("shape,heads,ws,ps,proj", HIERA_WINDOW_KINDS)
def test_hiera_block_window_sm90(dev, shape, heads, ws, ps, proj):
    """K4's chain sends a windowed block's attention to one launch of the
    entry `window_entry` names (window_attention_sm90.cu at head dims 96,
    56 and 72; no attention launch, pool_sm90.cu
    only for the shortcut) and stays within 2e-2 of `hiera_block_plain`."""
    g = torch.Generator(device=dev).manual_seed(13)
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
    counts = (kernels.WINDOW_LAUNCHES, kernels.ATTENTION_LAUNCHES,
              kernels.MAXPOOL_LAUNCHES)
    before = [c.snapshot() for c in counts]
    got = hiera_block(blk, x, num_heads=heads, ws=ws, q_stride=q_stride)
    after = [c.snapshot() for c in counts]
    win = {e: after[0][e] - before[0][e] for e in after[0]}
    entry = kernels.window_entry(dout // heads, ws, ps)
    assert win == {e: int(e == entry) for e in kernels.WINDOW_ROUTES}
    assert after[1] == before[1]
    pooled = {e: after[2][e] - before[2][e] for e in after[2]}
    assert pooled == {e: int(e == kernels.MAXPOOL_SM90_ENTRY and ps > 1)
                      for e in kernels.MAXPOOL_ROUTES}
    want = hiera_block_plain(_f32(blk), x.float(), num_heads=heads, ws=ws,
                             q_stride=q_stride, eps=1e-6)
    assert got.shape == want.shape
    assert _rel(got, want) < BOUND


def _hiera_tiny_kinds():
    """(index, map side, din, dout, heads, ws, pooled) of one block of
    each kind of SAM2.1-hiera-tiny's trunk at 1024^2."""
    from video_llava_seg_torch.models.sam2 import hiera
    from video_llava_seg_torch.models.sam2.config import sam2_config

    hc = sam2_config("tiny").hiera
    dims = hiera.block_dims(hc)
    side, kinds = 1024 // hc.patch_stride, {}
    for i, (din, dout, nh, ws, pool) in enumerate(dims):
        hw = side // (2 ** sum(1 for j in range(i) if dims[j][4]))
        kind = ("global" if ws == 0 else "q-pool" if pool
                else "padded" if hw % ws else "windowed")
        kinds.setdefault(kind, (i, hw, din, dout, nh, ws, pool))
    return kinds


@pytest.mark.parametrize("kind", ["windowed", "q-pool", "padded", "global"])
def test_hiera_tiny_block_batch_1(dev, kind):
    """K4 at one SAM2.1-hiera-tiny block of each kind over one 1024^2
    image (the image predictor's set_image: batch 1, where every
    persistent plan meets a single image) within BOUND of its fp32
    twin."""
    i, hw, din, dout, nh, ws, pool = _hiera_tiny_kinds()[kind]
    g = torch.Generator(device=dev).manual_seed(50 + i)
    blk = {"norm1": _ln(g, din, dev), "norm2": _ln(g, dout, dev),
           "qkv": _dense(g, din, 3 * dout, dev),
           "proj_attn": _dense(g, dout, dout, dev),
           "mlp": {"layers": [_dense(g, dout, 4 * dout, dev),
                              _dense(g, 4 * dout, dout, dev)]}}
    if din != dout:
        blk["proj"] = _dense(g, din, dout, dev)
    x = _randn(g, 1, hw, hw, din, dev=dev)
    q_stride = (2, 2) if pool else None
    got = hiera_block(blk, x, num_heads=nh, ws=ws, q_stride=q_stride)
    want = hiera_block_plain(_f32(blk), x.float(), num_heads=nh, ws=ws,
                             q_stride=q_stride, eps=1e-6)
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


# (1, 64, 4), (300, 4100, 36) and (64, 1036, 256) stay on w8a8.cu (K or
# N % 16), the others take w8a8_sm90.cu
@pytest.mark.parametrize("m,k,n", [(1, 64, 4), (130, 1024, 1024),
                                   (577, 1280, 5120), (300, 4100, 36),
                                   (64, 1036, 256)])
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
    for act in ("quick_gelu", "gelu"):
        assert torch.equal(
            kernels.gemm_s8(a, b, a_s, w_s, bias=bias, act=act),
            gemm_s8_plain(a, b, a_s, w_s, bias=bias, act=act)), act


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
    assert (kernels.attention_entry(128, False, skv, hkv)
            == "vls_flash_fwd_sm90")
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
    assert kernels.attention_bwd_entry(128, skv, hkv) == SM90_BWD_NAMES
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


# --- csrc/w8a8_sm90.cu: gemm_s8 on TMA + wgmma ----------------------------

# every epilogue of the dense mode: K8's q (CLIP-L's bf16 1/8, RADIO-H's
# 1/sqrt(80)), k / v (bias), out proj and fc2 (bias + residual), fc1
# (bias + quick_gelu or erf-GELU), and a dense without bias
GEMM_S8_EPILOGUES = {
    "bias": dict(bias=True),
    "bias_residual": dict(bias=True, residual=True),
    "qscale": dict(bias=True, scale=0.125),
    "qscale_hd80": dict(bias=True, scale=80 ** -0.5),
    "quick_gelu": dict(bias=True, act="quick_gelu"),
    "gelu": dict(bias=True, act="gelu"),
    "residual_no_bias": dict(residual=True),
}


def _gemm_s8_inputs(g, m, k, n, dev):
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    a_s = torch.rand(m, 1, generator=g, device=dev) * 2e-3 + 1e-4
    w_s = torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-4
    return a, b, a_s, w_s


# (rows, K, N): the six dense widths of CLIP-L (1024 -> 1024 / 4096, 4096
# -> 1024) and RADIO-H (1280 / 5120) at a few hundred rows with an M
# tail; a K tail past the 128-deep stage (K = 1040, 4128), N not a
# multiple of 128 (272, 400), one row and one tile row and a bit
@pytest.mark.parametrize("m,k,n", [(300, 1024, 1024), (300, 1024, 4096),
                                   (300, 4096, 1024), (300, 1280, 1280),
                                   (300, 1280, 5120), (300, 5120, 1280),
                                   (129, 1040, 272), (1, 64, 48),
                                   (257, 4128, 400)])
def test_gemm_s8_sm90_bit_exact(dev, m, k, n):
    """w8a8_sm90.cu equals w8a8.cu (forced by `route`) and the plain
    product bit for bit: the int32 mode and every dense epilogue."""
    assert kernels.gemm_s8_entry(m, k, n) == "vls_gemm_s8_sm90"
    g = torch.Generator(device=dev).manual_seed(23)
    a, b, a_s, w_s = _gemm_s8_inputs(g, m, k, n, dev)
    want = int_matmul_plain(a, b)
    assert torch.equal(kernels.gemm_s8(a, b), want)
    assert torch.equal(kernels.gemm_s8(a, b, route="vls_gemm_s8"), want)
    bias = _randn(g, n, dev=dev)
    res = _randn(g, m, n, dev=dev, scale=4.0)
    for name, ep in GEMM_S8_EPILOGUES.items():
        kw = dict(bias=bias if ep.get("bias") else None,
                  residual=res if ep.get("residual") else None,
                  scale=ep.get("scale"), act=ep.get("act", "none"))
        got = kernels.gemm_s8(a, b, a_s, w_s, **kw)
        old = kernels.gemm_s8(a, b, a_s, w_s, route="vls_gemm_s8", **kw)
        plain = gemm_s8_plain(a, b, a_s, w_s, **kw)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, old), name
        assert torch.equal(got, plain), name


def test_gemm_s8_counts_its_route(dev):
    """Each launch adds one to the count of the C entry it took."""
    g = torch.Generator(device=dev).manual_seed(25)
    a, b, _, _ = _gemm_s8_inputs(g, 40, 256, 128, dev)
    before = kernels.GEMM_S8_LAUNCHES.snapshot()
    kernels.gemm_s8(a, b)
    int_matmul(a, b)
    kernels.gemm_s8(a, b, route="vls_gemm_s8")
    after = kernels.GEMM_S8_LAUNCHES.snapshot()
    assert after["vls_gemm_s8_sm90"] - before["vls_gemm_s8_sm90"] == 2
    assert after["vls_gemm_s8"] - before["vls_gemm_s8"] == 1


# --- csrc/attention_short_sm90.cu: K3 at head dim 16, <= 64 keys ---------

SHORT = "vls_attention_short_sm90"
SHORT_CASES = {
    # name: (b, hq, hkv, sq, skv, kv_len, bias)
    "serving": (8, 8, 8, 4096, 7, None, False),   # chip_smoke's shapes
    "train": (64, 8, 8, 4096, 7, None, False),
    # the SAM2 image predictor's predict (a box: 2 corners + the pad
    # point + 6 output tokens) and the automatic mask generator's point
    # batch (the point + the pad point + 6 output tokens)
    "predict": (1, 8, 8, 4096, 9, None, False),
    "amg_batch": (64, 8, 8, 4096, 8, None, False),
    "partial_tile_gqa4": (3, 8, 2, 1000, 7, None, False),  # no 64 multiple
    "bias": (2, 8, 8, 777, 7, None, True),
    "kv_len": (2, 4, 4, 300, 7, 5, False),
    "keys_13": (2, 8, 8, 500, 13, None, True),     # 16-key tile
    "keys_29_gqa2": (2, 8, 4, 333, 29, None, False),  # 32-key tile
    "keys_64": (1, 8, 8, 640, 64, 50, True),       # 64-key tile
}


def _short_inputs(name, dev):
    """The mask decoder's layout: q, k, v as [B, H, S, 16] views of
    [B, S, H, 16] buffers."""
    b, hq, hkv, sq, skv, kv_len, with_bias = SHORT_CASES[name]
    g = torch.Generator(device=dev).manual_seed(31)
    q = _randn(g, b, sq, hq, 16, dev=dev).transpose(1, 2)
    k = _randn(g, b, skv, hkv, 16, dev=dev).transpose(1, 2)
    v = _randn(g, b, skv, hkv, 16, dev=dev).transpose(1, 2)
    bias = None
    if with_bias:
        bias = (2 * torch.randn(b, skv, generator=g, device=dev)).float()
        bias[-1, 1] = MASK_VALUE
    return q, k, v, kv_len, bias


@pytest.mark.parametrize("name", sorted(SHORT_CASES))
def test_attention_short_sm90(dev, name):
    """The persistent TMA + wgmma K3 against the plain forward: output
    within BOUND and logsumexp within LSE_BOUND, with and without the
    logsumexp (the same output bit for bit), against attention_reference
    where there is no bias, and within BOUND of attention.cu's two-pass
    form on the same inputs; partial last q tile, GQA, kv_len < Skv as
    the plain version's mask bias, a per-key bias, 8 / 16 / 32 / 64-key
    tiles."""
    q, k, v, kv_len, bias = _short_inputs(name, dev)
    b, hq, sq, _ = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert kernels.attention_entry(16, True, skv, hkv) == SHORT
    before = kernels.ATTENTION_LAUNCHES.snapshot()[SHORT]
    kw = dict(scale=0.25, kv_len=-1 if kv_len is None else kv_len,
              kv_bias=bias, two_pass=True)
    o, lse = kernels.attention(q, k, v, with_lse=True, **kw)
    o2 = kernels.attention(q, k, v, **kw)
    assert kernels.ATTENTION_LAUNCHES.snapshot()[SHORT] == before + 2
    plain_bias = bias
    if kv_len is not None:
        keep = torch.where(torch.arange(skv, device=dev) < kv_len, 0.0,
                           MASK_VALUE).float()
        plain_bias = keep if bias is None else bias + keep
        plain_bias = plain_bias.expand(b, skv).contiguous()
    want_o, want_lse = flash_forward_plain(q.float(), k.float(), v.float(),
                                           plain_bias, scale=0.25)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert torch.equal(o, o2)
    assert _rel(o, want_o) < BOUND
    assert (lse - want_lse).abs().max().item() < LSE_BOUND
    if bias is None:
        ref = attention_reference(q.float(), k.float(), v.float(),
                                  scale=0.25, kv_valid_len=kv_len)
        assert _rel(o, ref) < BOUND
    old = kernels.attention(q, k, v, route="vls_attention_bf16", **kw)
    assert _rel(o, old.float()) < BOUND


def test_attention_short_sm90_no_visible_key(dev):
    """A row that sees no key writes O = 0 and lse = 0: causal with Sq >
    Skv (rows i < Sq - Skv see nothing; the rest match the plain forward)
    and kv_len = 0 (no row sees a key)."""
    g = torch.Generator(device=dev).manual_seed(32)
    b, hq, sq, skv = 2, 8, 300, 7
    q = _randn(g, b, sq, hq, 16, dev=dev).transpose(1, 2)
    k = _randn(g, b, skv, hq, 16, dev=dev).transpose(1, 2)
    v = _randn(g, b, skv, hq, 16, dev=dev).transpose(1, 2)
    o, lse = kernels.attention(q, k, v, scale=0.25, causal=True,
                               two_pass=True, with_lse=True)
    dead = sq - skv
    assert not o[:, :, :dead].any() and not lse[:, :, :dead].any()
    want_o, want_lse = flash_forward_plain(q.float(), k.float(), v.float(),
                                           causal=True, scale=0.25)
    assert _rel(o[:, :, dead:], want_o[:, :, dead:]) < BOUND
    assert (lse[:, :, dead:] - want_lse[:, :, dead:]).abs().max().item() \
        < LSE_BOUND
    o, lse = kernels.attention(q, k, v, scale=0.25, kv_len=0, two_pass=True,
                               with_lse=True)
    assert not o.any() and not lse.any()


def test_attention_short_sm90_main_path_and_autograd(dev):
    """ops.attention at the mask decoder's serving shape counts K3 and
    takes the new entry; under autograd (the train step) its forward
    does too, with the logsumexp K6a / K6b read."""
    q, k, v, _, _ = _short_inputs("serving", dev)
    before = kernels.LAUNCHES.snapshot()["K3"]
    routes = kernels.ATTENTION_LAUNCHES.snapshot()
    out = attention(q, k, v)
    assert kernels.LAUNCHES.snapshot()["K3"] == before + 1
    after = kernels.ATTENTION_LAUNCHES.snapshot()
    assert after[SHORT] == routes[SHORT] + 1
    assert _rel(out, attention_reference(q.float(), k.float(),
                                         v.float())) < BOUND
    g = torch.Generator(device=dev).manual_seed(33)
    do = _randn(g, *q.shape, dev=dev)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = attention(*leaves)
    out.backward(do)
    assert kernels.ATTENTION_LAUNCHES.snapshot()[SHORT] == after[SHORT] + 1
    qf, kf, vf = q.float(), k.float(), v.float()
    o32, lse32 = flash_forward_plain(qf, kf, vf)
    want = flash_backward_plain(qf, kf, vf, None, o32, lse32, do.float(),
                                scale=0.25)
    assert _rel(out, o32) < BOUND
    for t, w in zip(leaves, want):
        assert _rel(t.grad, w) < BOUND


# --- csrc/attention_sm90.cu at head dims 64 / 80 / 96 --------------------

SM90 = "vls_flash_fwd_sm90"
CUDA_C = "vls_attention_bf16"
# relative bound of the head-dim instances (chip_smoke.py's BOUNDS["K2"])
HD_BOUND = 1e-2

HD_CASES = {
    # name: (b, hq, hkv, sq, skv, d, causal, kv_len), the main-path
    # shapes first: the towers' links at their [B, S, H, D] views, the
    # trunk's global block
    "clip_l_link": (32, 16, 16, 577, 577, 64, False, 577),
    "radio_h_link": (32, 16, 16, 577, 577, 80, False, 577),
    "trunk_global": (8, 4, 4, 4096, 4096, 96, False, None),
    "kv_len_577_d64": (2, 4, 4, 577, 577, 64, False, 530),
    "kv_len_577_d80": (2, 4, 4, 577, 577, 80, False, 450),
    "kv_len_577_d96": (2, 4, 4, 577, 577, 96, False, 500),
    "short_q_d64": (2, 4, 2, 37, 700, 64, False, None),
    "short_q_d80": (1, 2, 2, 50, 300, 80, True, None),
    "short_q_d96": (2, 2, 1, 17, 1030, 96, False, 900),
    "gqa4_causal_d64": (1, 8, 2, 700, 1300, 64, True, None),
    "gqa4_causal_d80": (1, 8, 2, 1000, 1000, 80, True, 950),
    "gqa2_d96": (2, 4, 2, 300, 2048, 96, False, None),
}


def _hd_inputs(name, dev, seed=40):
    """q, k, v of an HD_CASES case as the ViT chain builds them ([B, S, H,
    D] buffers viewed [B, H, S, D])."""
    b, hq, hkv, sq, skv, d, causal, kv_len = HD_CASES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = _randn(g, b, sq, hq, d, dev=dev).transpose(1, 2)
    k = _randn(g, b, skv, hkv, d, dev=dev).transpose(1, 2)
    v = _randn(g, b, skv, hkv, d, dev=dev).transpose(1, 2)
    return q, k, v, causal, kv_len


@pytest.mark.parametrize("name", sorted(HD_CASES))
def test_flash_sm90_head_dims(dev, name):
    """The head-dim instances against the plain forward (output within
    HD_BOUND, logsumexp within LSE_BOUND), against attention_reference
    and within HD_BOUND of attention.cu (forced by `route`) on the same
    inputs: the main-path shapes, 577 rows and keys with kv_len, Sq < 64,
    GQA, causal with Sq < Skv."""
    q, k, v, causal, kv_len = _hd_inputs(name, dev)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert kernels.attention_entry(d, False, skv, hkv) == (
        SM90 if skv >= kernels.FLASH_SM90_MIN_KEYS else CUDA_C)
    scale = d ** -0.5
    kw = dict(scale=scale, causal=causal,
              kv_len=-1 if kv_len is None else kv_len)
    before = kernels.ATTENTION_LAUNCHES.snapshot()[SM90]
    o, lse = kernels.attention(q, k, v, with_lse=True, route=SM90, **kw)
    o2 = kernels.attention(q, k, v, route=SM90, **kw)
    assert kernels.ATTENTION_LAUNCHES.snapshot()[SM90] == before + 2
    bias = None
    if kv_len is not None:
        bias = torch.where(torch.arange(skv, device=dev) < kv_len, 0.0,
                           MASK_VALUE).float().expand(b, skv).contiguous()
    want_o, want_lse = flash_forward_plain(q.float(), k.float(), v.float(),
                                           bias, causal=causal, scale=scale)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert torch.equal(o, o2)
    assert _rel(o, want_o) < HD_BOUND
    assert (lse - want_lse).abs().max().item() < LSE_BOUND
    del want_o, want_lse
    ref = attention_reference(q.float(), k.float(), v.float(), scale=scale,
                              causal=causal, kv_valid_len=kv_len)
    assert _rel(o, ref) < HD_BOUND
    old = kernels.attention(q, k, v, route=CUDA_C, **kw)
    assert kernels.ATTENTION_LAUNCHES.snapshot()[SM90] == before + 2
    assert _rel(o, old.float()) < HD_BOUND


@pytest.mark.parametrize("d", [64, 80, 96])
def test_flash_sm90_head_dims_no_visible_key(dev, d):
    """A row that sees no key writes O = 0 and lse = 0: causal with Sq >
    Skv (rows i < Sq - Skv see nothing; the rest match the plain forward)
    and kv_len = 0 (no row sees a key)."""
    g = torch.Generator(device=dev).manual_seed(41)
    b, hq, sq, skv = 2, 4, 400, 300
    q = _randn(g, b, sq, hq, d, dev=dev).transpose(1, 2)
    k = _randn(g, b, skv, hq, d, dev=dev).transpose(1, 2)
    v = _randn(g, b, skv, hq, d, dev=dev).transpose(1, 2)
    scale = d ** -0.5
    o, lse = kernels.attention(q, k, v, scale=scale, causal=True,
                               with_lse=True, route=SM90)
    dead = sq - skv
    assert not o[:, :, :dead].any() and not lse[:, :, :dead].any()
    want_o, want_lse = flash_forward_plain(q.float(), k.float(), v.float(),
                                           causal=True, scale=scale)
    assert _rel(o[:, :, dead:], want_o[:, :, dead:]) < HD_BOUND
    assert (lse[:, :, dead:] - want_lse[:, :, dead:]).abs().max().item() \
        < LSE_BOUND
    o, lse = kernels.attention(q, k, v, scale=scale, kv_len=0,
                               with_lse=True, route=SM90)
    assert not o.any() and not lse.any()


def test_flash_sm90_head_dims_route_refusals(dev):
    """Below head dim 128 the per-key bias, and fewer keys than
    FLASH_SM90_MIN_KEYS, stay on attention.cu; forcing the sm90 entry with
    a bias there, or at head dim 32, raises before any launch."""
    g = torch.Generator(device=dev).manual_seed(42)
    q, k, v = (_randn(g, 1, 2, 300, 64, dev=dev) for _ in range(3))
    bias = torch.zeros(1, 300, device=dev)
    few = kernels.FLASH_SM90_MIN_KEYS - 1
    before = kernels.ATTENTION_LAUNCHES.snapshot()
    kernels.attention(q, k, v, scale=0.125, kv_bias=bias)
    kernels.attention(q, k[:, :, :few], v[:, :, :few], scale=0.125)
    after = kernels.ATTENTION_LAUNCHES.snapshot()
    assert after[CUDA_C] == before[CUDA_C] + 2 and after[SM90] == before[SM90]
    with pytest.raises(ValueError, match="per-key bias at 128"):
        kernels.attention(q, k, v, scale=0.125, kv_bias=bias, route=SM90)
    q32 = q[..., :32].contiguous()
    with pytest.raises(ValueError, match="head dims"):
        kernels.attention(q32, q32, q32, scale=0.125, route=SM90)


@pytest.mark.parametrize("d,heads,act", [(256, 4, "quick_gelu"),
                                         (320, 4, "gelu")])
def test_vit_layer_head_dims_on_sm90(dev, d, heads, act):
    """K1 at head dims 64 / 80 over 577 tokens (kv_len 570): its
    attention link takes attention_sm90.cu, and the layer stays within
    BOUND of its fp32 twin."""
    g = torch.Generator(device=dev).manual_seed(43)
    p = {"layer_norm1": _ln(g, d, dev), "layer_norm2": _ln(g, d, dev),
         "q_proj": _dense(g, d, d, dev), "k_proj": _dense(g, d, d, dev),
         "v_proj": _dense(g, d, d, dev), "out_proj": _dense(g, d, d, dev),
         "fc1": _dense(g, d, 4 * d, dev), "fc2": _dense(g, 4 * d, d, dev)}
    x = _randn(g, 2, 577, d, dev=dev)
    before = kernels.ATTENTION_LAUNCHES.snapshot()[SM90]
    got = vit_layer(p, x, num_heads=heads, eps=1e-5, kv_len=570, act=act)
    assert kernels.ATTENTION_LAUNCHES.snapshot()[SM90] == before + 1
    want = vit_layer_plain(_f32(p), x.float(), num_heads=heads, eps=1e-5,
                           kv_len=570, act=act)
    assert _rel(got, want) < BOUND


def test_hiera_block_global_on_sm90(dev):
    """A K4 global block at head dim 96 over a 24 x 24 map (576 keys)
    takes attention_sm90.cu and stays within BOUND of its fp32 twin."""
    g = torch.Generator(device=dev).manual_seed(44)
    b, hw, c, heads = 2, 24, 192, 2
    blk = {"norm1": _ln(g, c, dev), "norm2": _ln(g, c, dev),
           "qkv": _dense(g, c, 3 * c, dev),
           "proj_attn": _dense(g, c, c, dev),
           "mlp": {"layers": [_dense(g, c, 4 * c, dev),
                              _dense(g, 4 * c, c, dev)]}}
    x = _randn(g, b, hw, hw, c, dev=dev)
    before = kernels.ATTENTION_LAUNCHES.snapshot()[SM90]
    got = hiera_block(blk, x, num_heads=heads, ws=0, q_stride=None)
    assert kernels.ATTENTION_LAUNCHES.snapshot()[SM90] == before + 1
    want = hiera_block_plain(_f32(blk), x.float(), num_heads=heads, ws=0,
                             q_stride=None, eps=1e-6)
    assert _rel(got, want) < BOUND


# ---- gemm_bf16_sm90.cu: the bf16 denses of K1 and K4 ----

GEMM_SM90 = "vls_gemm_bf16_sm90"
GEMM_OLD = "vls_gemm_bf16"
# one bf16 rounding of the output (2^-8 of an element) where the kernel
# and `gemm_plain` round apart; chip_smoke.py's BOUNDS["gemm_bf16"]
GEMM_BOUND = 1e-2


# (m, k, n): ragged rows, K 96 / 192 (a zero-filled tail past the 64-deep
# stage), N 96 / 288 (a partial 64-column box), a K tail past 1,024, and
# a CLIP-L-wide fc1 over a slice of its rows
@pytest.mark.parametrize("m,k,n", [(1000, 264, 392), (300, 96, 96),
                                   (4100, 192, 288), (129, 1032, 1152),
                                   (2309, 1024, 4096)])
@pytest.mark.parametrize("bias,res,scale", [(True, True, 0.5),
                                            (False, False, 1.0),
                                            (True, False, 0.125),
                                            (False, True, 1.0)])
@pytest.mark.parametrize("act", ["none", "quick_gelu", "gelu"])
def test_gemm_bf16_sm90(dev, m, k, n, bias, res, scale, act):
    """The routed entry (gemm_bf16_sm90.cu, one launch counted on it)
    against `gemm_plain` and against gemm_bf16.cu forced by `route`."""
    g = torch.Generator(device=dev).manual_seed(50)
    a = _randn(g, m, k, dev=dev)
    b = _randn(g, k, n, dev=dev, scale=1 / math.sqrt(k))
    kw = dict(residual=_randn(g, m, n, dev=dev) if res else None,
              scale=scale, act=act)
    bv = _randn(g, n, dev=dev, scale=0.1) if bias else None
    assert kernels.gemm_bf16_entry(m, k, n) == GEMM_SM90
    before = kernels.GEMM_BF16_LAUNCHES.snapshot()
    got = kernels.gemm(a, b, bv, **kw)
    after = kernels.GEMM_BF16_LAUNCHES.snapshot()
    assert after[GEMM_SM90] == before[GEMM_SM90] + 1
    assert after[GEMM_OLD] == before[GEMM_OLD]
    want = kernels.gemm_plain(a, b, bv, **kw)
    old = kernels.gemm(a, b, bv, route=GEMM_OLD, **kw)
    assert kernels.GEMM_BF16_LAUNCHES.snapshot()[GEMM_OLD] == \
        after[GEMM_OLD] + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _rel(got, want) < GEMM_BOUND
    assert _rel(old, want) < GEMM_BOUND


@pytest.mark.parametrize("chain", ["vit", "hiera_proj", "hiera"])
def test_chains_take_gemm_bf16_sm90(dev, chain):
    """K1's six denses and K4's four (+ the shortcut projection) launch
    gemm_bf16_sm90.cu, and the chains stay within BOUND of their fp32
    twins."""
    g = torch.Generator(device=dev).manual_seed(51)
    before = kernels.GEMM_BF16_LAUNCHES.snapshot()
    if chain == "vit":
        d = 256
        p = {"layer_norm1": _ln(g, d, dev), "layer_norm2": _ln(g, d, dev),
             "q_proj": _dense(g, d, d, dev), "k_proj": _dense(g, d, d, dev),
             "v_proj": _dense(g, d, d, dev),
             "out_proj": _dense(g, d, d, dev),
             "fc1": _dense(g, d, 4 * d, dev), "fc2": _dense(g, 4 * d, d, dev)}
        x = _randn(g, 3, 577, d, dev=dev)
        got = vit_layer(p, x, num_heads=4, eps=1e-5, kv_len=577)
        want = vit_layer_plain(_f32(p), x.float(), num_heads=4, eps=1e-5,
                               kv_len=577)
        n_dense = 6
    else:
        din = 96
        dout = 2 * din if chain == "hiera_proj" else din
        heads = dout // 96
        blk = {"norm1": _ln(g, din, dev), "norm2": _ln(g, dout, dev),
               "qkv": _dense(g, din, 3 * dout, dev),
               "proj_attn": _dense(g, dout, dout, dev),
               "mlp": {"layers": [_dense(g, dout, 4 * dout, dev),
                                  _dense(g, 4 * dout, dout, dev)]}}
        q_stride = None
        if chain == "hiera_proj":
            blk["proj"] = _dense(g, din, dout, dev)
            q_stride = (2, 2)
        x = _randn(g, 2, 32, 32, din, dev=dev)
        got = hiera_block(blk, x, num_heads=heads, ws=8, q_stride=q_stride)
        want = hiera_block_plain(_f32(blk), x.float(), num_heads=heads, ws=8,
                                 q_stride=q_stride, eps=1e-6)
        n_dense = 4 + (chain == "hiera_proj")
    after = kernels.GEMM_BF16_LAUNCHES.snapshot()
    assert after[GEMM_SM90] == before[GEMM_SM90] + n_dense
    assert after[GEMM_OLD] == before[GEMM_OLD]
    assert _rel(got, want) < BOUND


def test_gemm_bf16_sm90_refusals_on_the_card(dev):
    """A bad `route`, or K / N off a multiple of 8, raises before any
    launch."""
    a = torch.zeros(64, 128, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(128, 64, device=dev, dtype=torch.bfloat16)
    before = kernels.GEMM_BF16_LAUNCHES.snapshot()
    with pytest.raises(ValueError, match="route"):
        kernels.gemm(a, b, route="cublas")
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.gemm(a[:, :124].contiguous(), b[:124])
    assert kernels.GEMM_BF16_LAUNCHES.snapshot() == before


# --- csrc/attention_short_bwd_sm90.cu: K6a + K6b in one pass at head dim 16

SHORT_BWD = "vls_attention_short_bwd_sm90"
SHORT_BWD_CASES = {
    # name: (b, hq, hkv, sq, skv, causal, masked keys)
    "train": (64, 8, 8, 4096, 7, False, None),     # chip_smoke's shape
    "gqa2_causal_bias": (2, 8, 4, 333, 13, True, (4, 9)),
    "partial_tile_gqa4": (3, 8, 2, 1000, 7, False, None),
    "keys_29_gqa2": (2, 8, 4, 333, 29, False, None),
    "keys_64_bias": (1, 8, 8, 640, 64, False, (0, 63)),
}


def _short_bwd_inputs(name, dev, seed=34):
    """The mask decoder's layout: q, k, v and dO as [B, H, S, 16] views of
    [B, S, H, 16] buffers; the kernel forward's output and logsumexp."""
    b, hq, hkv, sq, skv, causal, masked = SHORT_BWD_CASES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (_randn(g, b, sq, hq, 16, dev=dev).transpose(1, 2)
             for _ in range(2))
    k, v = (_randn(g, b, skv, hkv, 16, dev=dev).transpose(1, 2)
            for _ in range(2))
    bias = None
    if masked is not None:
        bias = (2 * torch.randn(b, skv, generator=g, device=dev)).float()
        bias[:, list(masked)] = MASK_VALUE
    kw = dict(scale=0.25, causal=causal, kv_bias=bias)
    out, lse = kernels.attention(q, k, v, two_pass=True, with_lse=True, **kw)
    return q, k, v, out, do, lse, kw, masked


@pytest.mark.parametrize("name", sorted(SHORT_BWD_CASES))
def test_attention_short_bwd_sm90(dev, name):
    """The one-pass backward against the plain backward on the kernel
    forward's output and logsumexp: dQ, dK, dV within BOUND, also against
    attention_bwd.cu's pair on the same inputs; two calls bit-identical
    (no float atomics); masked keys at exactly zero dK / dV; one launch
    counted on the new entry and none on a pair; 8 / 16 / 32 / 64-key
    tiles, GQA 2 and 4, a partial last q tile, causal with Sq > Skv."""
    q, k, v, out, do, lse, kw, masked = _short_bwd_inputs(name, dev)
    assert kernels.attention_bwd_entry(16, k.shape[2], k.shape[1]) == (
        SHORT_BWD,)
    before = kernels.ATTENTION_BWD_LAUNCHES.snapshot()
    got = kernels.attention_bwd(q, k, v, out, do, lse, **kw)
    after = kernels.ATTENTION_BWD_LAUNCHES.snapshot()
    assert {e: after[e] - before[e] for e in after} == {
        e: int(e == SHORT_BWD) for e in after}
    again = kernels.attention_bwd(q, k, v, out, do, lse, **kw)
    want = flash_backward_plain(q.float(), k.float(), v.float(),
                                kw["kv_bias"], out.float(), lse, do.float(),
                                causal=kw["causal"], scale=0.25)
    dq, delta = kernels.attention_bwd_dq(q, k, v, out, do, lse, **kw)
    old = (dq,) + kernels.attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    for t, t2, w, o in zip(got, again, want, old):
        assert t.dtype == torch.bfloat16 and torch.isfinite(t.float()).all()
        assert torch.equal(t, t2)
        assert _rel(t, w) < BOUND
        assert _rel(t, o.float()) < BOUND
    assert got[0].shape == q.shape and got[1].shape == k.shape
    if masked is not None:
        for t in got[1:]:
            assert not t[:, :, list(masked)].any()


def test_attention_short_bwd_sm90_no_visible_key(dev):
    """Causal with Sq > Skv: rows i < Sq - Skv see no key (the forward
    wrote O = 0, lse = 0), get dQ = 0 and add nothing to dK / dV; the
    rest match the plain backward."""
    g = torch.Generator(device=dev).manual_seed(35)
    b, hq, sq, skv = 2, 8, 300, 7
    q, do = (_randn(g, b, sq, hq, 16, dev=dev).transpose(1, 2)
             for _ in range(2))
    k, v = (_randn(g, b, skv, hq, 16, dev=dev).transpose(1, 2)
            for _ in range(2))
    kw = dict(scale=0.25, causal=True)
    out, lse = kernels.attention(q, k, v, two_pass=True, with_lse=True, **kw)
    dq, dk, dv = kernels.attention_bwd(q, k, v, out, do, lse, **kw)
    dead = sq - skv
    assert not dq[:, :, :dead].any()
    live = [t[:, :, dead:] for t in (q, out, do)]
    want = flash_backward_plain(live[0].float(), k.float(), v.float(), None,
                                live[1].float(), lse[:, :, dead:],
                                live[2].float(), causal=True, scale=0.25)
    for t, w in zip((dq[:, :, dead:], dk, dv), want):
        assert _rel(t, w) < BOUND


def test_attention_short_bwd_sm90_autograd(dev):
    """attention() under autograd on the mask decoder's views (the train
    step's image->token attention): one K3 launch forward, one K6a and one
    K6b counted, the backward on the one-pass entry and on no pair, and
    the gradients within BOUND of the plain backward."""
    q, k, v, _, do, _, _, _ = _short_bwd_inputs("partial_tile_gqa4", dev)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    before = kernels.LAUNCHES.snapshot()
    routes = kernels.ATTENTION_BWD_LAUNCHES.snapshot()
    out = attention(*leaves)
    out.backward(do)
    after = kernels.LAUNCHES.snapshot()
    assert [after[n] - before[n] for n in ("K3", "K6a", "K6b")] == [1, 1, 1]
    now = kernels.ATTENTION_BWD_LAUNCHES.snapshot()
    assert {e: now[e] - routes[e] for e in now} == {
        e: int(e == SHORT_BWD) for e in now}
    qf, kf, vf = q.float(), k.float(), v.float()
    o32, lse32 = flash_forward_plain(qf, kf, vf, scale=0.25)
    want = flash_backward_plain(qf, kf, vf, None, o32, lse32, do.float(),
                                scale=0.25)
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.bfloat16
        assert _rel(t.grad, w) < BOUND


# ---- csrc/attention_sm90.cu at head dim 256: SAM2's memory attention ----

WIDE_CASES = {
    # name: (b, sq, skv, two_pass, causal, kv_len): memory attention's
    # self shape, the cross shape over a full bank (7 memories of 4096
    # tokens + 16 pointers x 4 tokens), a ragged bank at batch 2 (two
    # objects), the two-pass form a 32 x 32 grid would take, causal with
    # kv_len
    "memory_self": (1, 4096, 4096, False, False, None),
    "memory_full_bank": (1, 4096, 7 * 4096 + 64, False, False, None),
    "memory_ragged_bank_b2": (2, 4096, 2 * 4096 + 12, False, False, None),
    "two_pass_32x32": (1, 1024, 1024, True, False, None),
    "causal_kv_len": (1, 300, 500, False, True, 450),
}


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_flash_sm90_head_dim_256(dev, name):
    """The head-dim-256 instance (64-key K / V tiles) against the plain
    forward (output within HD_BOUND, logsumexp within LSE_BOUND), on
    attention_sm90.cu whatever the form, two calls bit-identical."""
    b, sq, skv, two_pass, causal, kv_len = WIDE_CASES[name]
    g = torch.Generator(device=dev).manual_seed(45)
    q = _randn(g, b, sq, 1, 256, dev=dev).transpose(1, 2)
    k = _randn(g, b, skv, 1, 256, dev=dev).transpose(1, 2)
    v = _randn(g, b, skv, 1, 256, dev=dev).transpose(1, 2)
    assert kernels.attention_entry(256, two_pass, skv, 1) == SM90
    kw = dict(scale=1 / 16, causal=causal, two_pass=two_pass,
              kv_len=-1 if kv_len is None else kv_len)
    before = kernels.ATTENTION_LAUNCHES.snapshot()[SM90]
    o, lse = kernels.attention(q, k, v, with_lse=True, **kw)
    o2 = kernels.attention(q, k, v, **kw)
    assert kernels.ATTENTION_LAUNCHES.snapshot()[SM90] == before + 2
    bias = None
    if kv_len is not None:
        bias = torch.where(torch.arange(skv, device=dev) < kv_len, 0.0,
                           MASK_VALUE).float().expand(b, skv).contiguous()
    want_o, want_lse = flash_forward_plain(q.float(), k.float(), v.float(),
                                           bias, causal=causal, scale=1 / 16)
    assert torch.equal(o, o2)
    assert _rel(o, want_o) < HD_BOUND
    assert (lse - want_lse).abs().max().item() < LSE_BOUND


def test_flash_sm90_head_dim_256_refusals(dev):
    """No kernel takes a per-key bias at head dim 256: refused before any
    launch, routed or forced."""
    g = torch.Generator(device=dev).manual_seed(46)
    q = _randn(g, 1, 1, 256, 256, dev=dev)
    bias = torch.zeros(1, 256, device=dev)
    before = kernels.ATTENTION_LAUNCHES.snapshot()
    with pytest.raises(ValueError, match="per-key bias"):
        kernels.attention(q, q, q, scale=1 / 16, kv_bias=bias)
    with pytest.raises(ValueError, match="per-key bias at 128"):
        kernels.attention(q, q, q, scale=1 / 16, kv_bias=bias, route=SM90)
    assert kernels.ATTENTION_LAUNCHES.snapshot() == before


def test_hiera_block_global_padded_on_sm90(dev):
    """A K4 global block at Hiera-L's head dim 72 (C 144, 2 heads) over a
    24 x 24 map: q, k and v zero-padded to 80 take attention_sm90.cu once,
    and the block stays within BOUND of its fp32 twin."""
    g = torch.Generator(device=dev).manual_seed(47)
    b, hw, c, heads = 2, 24, 144, 2
    blk = {"norm1": _ln(g, c, dev), "norm2": _ln(g, c, dev),
           "qkv": _dense(g, c, 3 * c, dev),
           "proj_attn": _dense(g, c, c, dev),
           "mlp": {"layers": [_dense(g, c, 4 * c, dev),
                              _dense(g, 4 * c, c, dev)]}}
    x = _randn(g, b, hw, hw, c, dev=dev)
    before = kernels.ATTENTION_LAUNCHES.snapshot()
    got = hiera_block(blk, x, num_heads=heads, ws=0, q_stride=None)
    after = kernels.ATTENTION_LAUNCHES.snapshot()
    assert {e: after[e] - before[e] for e in after} == {
        e: int(e == SM90) for e in after}
    want = hiera_block_plain(_f32(blk), x.float(), num_heads=heads, ws=0,
                             q_stride=None, eps=1e-6)
    assert _rel(got, want) < BOUND


def test_memory_attention_on_the_card(dev):
    """One memory-attention layer at full width (d_model 256, one head,
    a 64 x 64 frame) over two spatial memories and two pointers: K2
    twice (self- and cross-attention) on attention_sm90.cu, within BOUND
    of the fp32 plain layer on the CPU over the same bf16 weights."""
    import dataclasses

    from video_llava_seg_torch.models.sam2 import memory
    from video_llava_seg_torch.models.sam2.config import sam2_config

    sc = sam2_config("tiny")
    sc = dataclasses.replace(sc, memory_attention=dataclasses.replace(
        sc.memory_attention, num_layers=1))
    g = torch.Generator(device=dev).manual_seed(48)
    params = memory.memory_attention_init(sc, g, dev, torch.bfloat16)
    hw, m = 4096, sc.mem_dim
    nt = 2 * sc.hidden_dim // m
    curr, curr_pos = (_randn(g, 1, hw, 256, dev=dev) for _ in range(2))
    mem, mem_pos = (_randn(g, 1, 2 * hw + nt, m, dev=dev) for _ in range(2))
    before = kernels.LAUNCHES.snapshot()["K2"]
    sm90 = kernels.ATTENTION_LAUNCHES.snapshot()[SM90]
    got = memory.memory_attention_apply(params, sc, curr, mem, curr_pos,
                                        mem_pos, num_obj_ptr_tokens=nt)
    assert kernels.LAUNCHES.snapshot()["K2"] == before + 2
    assert kernels.ATTENTION_LAUNCHES.snapshot()[SM90] == sm90 + 2
    cpu = tree_map(lambda t: t.float().cpu(), params)
    want = memory.memory_attention_apply(
        cpu, sc, *(t.float().cpu() for t in (curr, mem, curr_pos, mem_pos)),
        num_obj_ptr_tokens=nt)
    assert _rel(got.cpu(), want) < BOUND
