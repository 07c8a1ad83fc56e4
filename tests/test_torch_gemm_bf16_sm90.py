"""The CPU side of csrc/gemm_bf16_sm90.cu (`kernels.gemm` on TMA and wgmma:
every bf16 dense of K1 and K4): the route `gemm` takes at every main-path
dense shape of the configs, the four bf16 tensor maps the wrapper hands
the C entry (and the views the chains pass), the refusal of what TMA
cannot address and of a bad `route`, the chains' dense calls as
chip_smoke.py counts them, and `gemm_plain`, the product the card is
held to, against the JAX package's dense + bias + activation forms. The
kernel itself runs only on the card (tests/test_torch_kernels_cuda.py,
`-k gemm`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_llava_seg_torch import kernels
from video_llava_seg_torch.config import VideoLlavaConfig, VisionTowerConfig
from video_llava_seg_torch.models.sam2 import hiera
from video_llava_seg_torch.models.sam2.config import sam2_config
from video_llava_seg_torch.ops import hiera_block as thb
from video_llava_seg_torch.ops import nn as tnn
from video_llava_seg_torch.ops import vit_block as tvb
from video_llava_seg_torch.ops.attention import attention_reference
from video_llava_seg_torch.ops.window_attention import window_attention_plain
from video_llava_seg_tpu.ops import nn as jnn
from video_llava_seg_tpu.ops.vit_block import _quick_gelu_f32

SM90 = "vls_gemm_bf16_sm90"
FRAMES, SEG_FRAMES = 32, 8


def _tower_shapes():
    """(name, m, k, n) of K1's denses: CLIP-L/14-336 over 32 frames (and
    its S2 pass at 672, four 336 crops a frame), RADIO-H / L / B at 384."""
    clip = VideoLlavaConfig().vision
    towers = [("CLIP-L", clip, 1), ("CLIP-L S2 672", clip, 4)]
    towers += [(name.split("/")[1], VisionTowerConfig.radio(name), 1)
               for name in ("nvidia/RADIO", "nvidia/RADIO-L",
                            "nvidia/RADIO-B")]
    out = []
    for name, vc, crops in towers:
        rows = FRAMES * crops * (vc.num_patches + int(vc.use_cls_token)
                                 + vc.num_register_tokens)
        for dense, m, k, n, _ in chip_smoke.vit_dense_calls(
                rows, vc.hidden_size, vc.intermediate_size, vc.num_heads,
                "gelu"):
            out.append((f"{name} {dense}", m, k, n))
    return out


def _trunk_shapes():
    """(name, m, k, n) of K4's denses at every block of Hiera-T / S / B+ /
    L over 8 frames at 1024^2, the shortcut projections included."""
    out = {}
    for variant in ("tiny", "small", "base_plus", "large"):
        hc = sam2_config(variant).hiera
        side = 1024 // hc.patch_stride
        pools = 0
        for i, (din, dout, _, ws, pool) in enumerate(hiera.block_dims(hc)):
            for dense, m, k, n, _ in chip_smoke.hiera_dense_calls(
                    SEG_FRAMES, side >> pools, din, dout, ws, pool,
                    int(dout * hc.mlp_ratio)):
                out.setdefault((m, k, n), f"hiera-{variant} {i} {dense}")
            pools += bool(pool)
    return [(name, *shape) for shape, name in out.items()]


SHAPES = _tower_shapes() + _trunk_shapes()


@pytest.mark.parametrize("name,m,k,n", SHAPES,
                         ids=[f"{s[0]}-{s[1]}x{s[2]}x{s[3]}" for s in SHAPES])
def test_gemm_bf16_entry_route(name, m, k, n):
    """Every main-path dense takes gemm_bf16_sm90.cu."""
    assert kernels.gemm_bf16_entry(m, k, n) == SM90
    assert SM90 in kernels._SIGNATURES and SM90 in kernels.GEMM_BF16_ROUTES


def test_gemm_bf16_entry_refusals():
    """No rows (nothing to launch) and widths TMA cannot address name
    gemm_bf16.cu; `gemm` itself refuses K or N off a multiple of 8."""
    assert kernels.gemm_bf16_entry(0, 1024, 1024) == "vls_gemm_bf16"
    assert kernels.gemm_bf16_entry(64, 1028, 1024) == "vls_gemm_bf16"
    assert kernels.gemm_bf16_entry(64, 1024, 1020) == "vls_gemm_bf16"


def _read(t, g, c0, c1):
    """The element the map (offset, dims, byte stride, box) addresses at
    (inner c0, outer c1), read from t's storage."""
    off, d0, d1, stride = g[:4]
    assert 0 <= c0 < d0 and 0 <= c1 < d1 and off % 2 == 0 and stride % 2 == 0
    return t.reshape(-1)[(off + c1 * stride) // 2 + c0].item()


def _chain_operands():
    """The views the chains pass: K4's `xn.view(-1, cin)` of a LayerNorm
    map [B, H, W, C] and `o.view(-1, c)` of the cropped attention output,
    K1's `h` [frames x tokens, d]."""
    rng = np.random.default_rng(0)
    xn = torch.from_numpy(rng.standard_normal((2, 14, 14, 96))).to(
        torch.bfloat16)
    o = torch.from_numpy(rng.standard_normal((2, 7, 9, 192))).to(
        torch.bfloat16)[:, :, :7].contiguous()
    return [(xn.view(-1, 96), 288), (o.view(-1, 192), 192),
            (torch.zeros(3 * 577, 1024, dtype=torch.bfloat16), 4096)]


@pytest.mark.parametrize("case", range(3))
def test_gemm_bf16_sm90_tensor_maps(case):
    """A's map is [K x M] over its row stride with the 64 x 128 box, B's
    [N x K] with the 64 x 64 box, C's and the residual's [N x M] with the
    64 x 64 box; every addressed element is the one the plain product
    reads or writes. Without a residual its map repeats C's."""
    a, n = _chain_operands()[case]
    m, k = a.shape
    b = torch.arange(k * n, dtype=torch.float32).remainder(97).to(
        torch.bfloat16).reshape(k, n)
    c = torch.arange(m * n, dtype=torch.float32).remainder(89).to(
        torch.bfloat16).reshape(m, n)
    res = torch.arange(m * n, dtype=torch.float32).remainder(83).to(
        torch.bfloat16).reshape(m, n)
    g = kernels.gemm_bf16_sm90_geometry(a, b, c, res)
    assert len(g) == 24
    ga, gb, gc, gr = g[:6], g[6:12], g[12:18], g[18:]
    assert ga == (0, k, m, 2 * k, 64, 128)
    assert gb == (0, n, k, 2 * n, 64, 64)
    assert gc == gr == (0, n, m, 2 * n, 64, 64)
    assert kernels.gemm_bf16_sm90_geometry(a, b, c)[18:] == gc
    assert (kernels.GEMM_BF16_SM90_BOX_K, kernels.GEMM_BF16_SM90_BOX_ROWS,
            kernels.GEMM_BF16_SM90_BOX_COLS,
            kernels.GEMM_BF16_SM90_OUT_ROWS) == (64, 128, 64, 64)
    rng = np.random.default_rng(case)
    for _ in range(50):
        r, kk, col = (int(rng.integers(x)) for x in (m, k, n))
        assert _read(a, ga, kk, r) == a[r, kk].item()
        assert _read(b, gb, col, kk) == b[kk, col].item()
        assert _read(c, gc, col, r) == c[r, col].item()
        assert _read(res, gr, col, r) == res[r, col].item()


def test_gemm_bf16_sm90_geometry_of_a_row_slice():
    """A block of rows of a wider activation tensor keeps its row stride
    (the map addresses through it)."""
    big = torch.zeros(64, 512, dtype=torch.bfloat16)
    b = torch.zeros(256, 128, dtype=torch.bfloat16)
    c = torch.zeros(32, 128, dtype=torch.bfloat16)
    res = torch.zeros(32, 256, dtype=torch.bfloat16)[:, :128]
    g = kernels.gemm_bf16_sm90_geometry(big[16:48, :256], b, c, res)
    assert g[:4] == (0, 256, 32, 1024)
    assert g[18:22] == (0, 128, 32, 512)


@pytest.mark.parametrize("case", ["k_not_8", "n_not_8", "misaligned_base",
                                  "column_slice", "row_stride", "k_mismatch",
                                  "c_shape", "residual_shape",
                                  "residual_stride", "dtype"])
def test_gemm_bf16_sm90_geometry_refuses(case):
    """What TMA cannot address raises instead of reaching the C entry: K
    or N not a multiple of 8, a base off 16 bytes, a view whose last dim
    is not contiguous or whose row stride is not a multiple of 16 bytes
    (an operand's or the residual's), a K that differs between the
    operands, an output or residual of another shape and an operand that
    is not bf16."""
    bf = torch.bfloat16
    a = torch.zeros(32, 256, dtype=bf)
    b = torch.zeros(256, 128, dtype=bf)
    c = torch.zeros(32, 128, dtype=bf)
    res = None
    if case == "k_not_8":
        a, b = torch.zeros(32, 264, dtype=bf)[:, :260], torch.zeros(
            260, 128, dtype=bf)
    elif case == "n_not_8":
        b, c = torch.zeros(256, 132, dtype=bf), torch.zeros(32, 132, dtype=bf)
    elif case == "misaligned_base":
        a = torch.zeros(32 * 256 + 8, dtype=bf)[4:4 + 32 * 256].reshape(
            32, 256)
    elif case == "column_slice":
        a = torch.zeros(256, 32, dtype=bf).t()
    elif case == "row_stride":
        a = torch.zeros(32, 260, dtype=bf)[:, :256]
    elif case == "k_mismatch":
        b = torch.zeros(248, 128, dtype=bf)
    elif case == "c_shape":
        c = torch.zeros(32, 136, dtype=bf)
    elif case == "residual_shape":
        res = torch.zeros(31, 128, dtype=bf)
    elif case == "residual_stride":
        res = torch.zeros(32, 132, dtype=bf)[:, :128]
    elif case == "dtype":
        b = torch.zeros(256, 128, dtype=torch.float32)
    with pytest.raises(ValueError, match="gemm_bf16_sm90"):
        kernels.gemm_bf16_sm90_geometry(a, b, c, res)


@pytest.mark.parametrize("kw,match", [({"route": "cublas"}, "route"),
                                      ({}, "CUDA tensor")])
def test_gemm_arguments_are_checked(kw, match):
    """`route` names a C entry of GEMM_BF16_ROUTES or `gemm` raises before
    any launch; a CPU tensor never reaches a kernel."""
    a = torch.zeros(16, 64, dtype=torch.bfloat16)
    b = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        kernels.gemm(a, b, **kw)


@pytest.mark.parametrize("act", ["none", "quick_gelu", "gelu"])
@pytest.mark.parametrize("bias,res,scale", [(True, True, 0.5),
                                            (False, False, 1.0),
                                            (True, False, 0.125)])
def test_gemm_plain_matches_jax_dense_forms(act, bias, res, scale):
    """`gemm_plain` in fp32 is the JAX package's dense: x @ W + b, times
    the scale, through `_quick_gelu_f32` (K1) or the XLA twin's exact
    GELU (`nn.gelu`, K4's `_gelu_f32` reference), plus the residual;
    numpy inputs from a seed, 2e-5 absolute."""
    rng = np.random.default_rng(7)
    m, k, n = 75, 96, 136
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    r = rng.standard_normal((m, n)).astype(np.float32)
    y = jnp.dot(x, w, precision=jax.lax.Precision.HIGHEST)
    if bias:
        y = y + b
    y = {"none": lambda t: t, "quick_gelu": _quick_gelu_f32,
         "gelu": jnn.gelu}[act](y * scale)
    if res:
        y = y + r
    got = kernels.gemm_plain(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(b) if bias else None,
        residual=torch.from_numpy(r) if res else None, scale=scale, act=act)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=0, atol=2e-5)


def test_gemm_plain_rounds_once_to_the_input_dtype():
    """On bf16 operands the epilogue runs in fp32 and rounds once."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((9, 64))).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((64, 16))).to(torch.bfloat16)
    res = torch.from_numpy(rng.standard_normal((9, 16))).to(torch.bfloat16)
    got = kernels.gemm_plain(a, b, residual=res, act="gelu")
    want = (torch.nn.functional.gelu(a.float() @ b.float())
            + res.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.fixture
def stand_ins(monkeypatch):
    """The chains' kernels replaced by CPU versions in fp32, `gemm`
    recording (m, k, n, epilogue) of each call."""
    calls = []

    def gemm(a, b, bias=None, residual=None, scale=1.0, act="none"):
        ep = {}
        if scale != 1.0:
            ep["scale"] = scale
        if act != "none":
            ep["act"] = act
        if residual is not None:
            ep["residual"] = True
        assert bias is not None and a.is_contiguous()
        calls.append((a.shape[0], a.shape[1], b.shape[1], ep))
        return kernels.gemm_plain(a, b, bias, residual, scale, act)

    def attention(q, k, v, *, scale, kv_len=-1):
        mask = None
        if kv_len >= 0:
            mask = (torch.arange(k.shape[2]) < kv_len).expand(k.shape[0], -1)
        return attention_reference(q, k, v, scale=scale, kv_mask=mask)

    def window_attention(qkv, *, num_heads, ws, scale, ps=1, out_hw=None):
        o = window_attention_plain(qkv, num_heads=num_heads, ws=ws,
                                   scale=scale, ps=ps)
        if out_hw is not None:
            o = o[:, :out_hw[0], :out_hw[1]].contiguous()
        return o

    monkeypatch.setattr(kernels, "gemm", gemm)
    monkeypatch.setattr(kernels, "attention", attention)
    monkeypatch.setattr(kernels, "window_attention", window_attention)
    monkeypatch.setattr(kernels, "layernorm", lambda x, g, b, eps:
                        tnn.layer_norm({"scale": g, "bias": b}, x, eps))
    monkeypatch.setattr(kernels, "maxpool2x2", thb.max_pool_2x2)
    return calls


def _dense(g, din, dout):
    return {"kernel": torch.randn(din, dout, generator=g) / math.sqrt(din),
            "bias": torch.randn(dout, generator=g) * 0.1}


def _ln(g, d):
    return {"scale": 1 + 0.1 * torch.randn(d, generator=g),
            "bias": 0.1 * torch.randn(d, generator=g)}


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_vit_chain_dense_calls(stand_ins, act):
    """K1's chain makes the six calls `chip_smoke.vit_dense_calls`
    counts (the 23 x 6 per bf16 CLIP-L query its launch check asserts)
    and, on fp32 stand-ins for its kernels, equals `vit_layer_plain`."""
    g = torch.Generator().manual_seed(0)
    d, dff, heads, n = 64, 256, 4, 37
    p = {"layer_norm1": _ln(g, d), "layer_norm2": _ln(g, d),
         "q_proj": _dense(g, d, d), "k_proj": _dense(g, d, d),
         "v_proj": _dense(g, d, d), "out_proj": _dense(g, d, d),
         "fc1": _dense(g, d, dff), "fc2": _dense(g, dff, d)}
    x = torch.randn(3, n, d, generator=g)
    got = tvb._vit_layer_cuda(p, x, num_heads=heads, eps=1e-5, kv_len=30,
                              act=act)
    want = tvb.vit_layer_plain(p, x, num_heads=heads, eps=1e-5, kv_len=30,
                               act=act)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert stand_ins == [(m, k, n_, ep) for _, m, k, n_, ep in
                         chip_smoke.vit_dense_calls(3 * n, d, dff, heads,
                                                    act)]


# (din, dout, heads, ws, pool, hw): the block kinds of the trunk at small
# widths: windowed, q-pool with the shortcut projection, padded, global
BLOCKS = [(32, 32, 1, 4, False, 8), (32, 64, 2, 4, True, 8),
          (64, 64, 2, 3, False, 4), (64, 64, 2, 0, False, 4)]


@pytest.mark.parametrize("din,dout,heads,ws,pool,hw", BLOCKS)
def test_hiera_chain_dense_calls(stand_ins, din, dout, heads, ws, pool, hw):
    """K4's chain makes the calls `chip_smoke.hiera_dense_calls` counts
    (4 a block, + 1 where the width changes: 16 x 4 + 3 per
    SAM2.1-hiera-small trunk) and, on fp32 stand-ins, equals
    `hiera_block_plain`."""
    g = torch.Generator().manual_seed(1)
    blk = {"norm1": _ln(g, din), "norm2": _ln(g, dout),
           "qkv": _dense(g, din, 3 * dout),
           "proj_attn": _dense(g, dout, dout),
           "mlp": {"layers": [_dense(g, dout, 4 * dout),
                              _dense(g, 4 * dout, dout)]}}
    if din != dout:
        blk["proj"] = _dense(g, din, dout)
    x = torch.randn(2, hw, hw, din, generator=g)
    ps = 2 if pool else 1
    got = thb._hiera_block_cuda(blk, x, num_heads=heads, ws=ws, ps=ps,
                                eps=1e-6)
    want = thb.hiera_block_plain(blk, x, num_heads=heads, ws=ws,
                                 q_stride=(2, 2) if pool else None, eps=1e-6)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert stand_ins == [(m, k, n, ep) for _, m, k, n, ep in
                         chip_smoke.hiera_dense_calls(2, hw, din, dout, ws,
                                                      pool, 4 * dout)]


def test_trunk_dense_calls_count():
    """SAM2.1-hiera-small: 16 blocks x 4 denses + 3 shortcut projections,
    the count chip_smoke.py's launch check asserts per trunk, and the sum
    of the launches over its dense cases."""
    assert chip_smoke.trunk_dense_calls() == 16 * 4 + 3
    cases = chip_smoke.dense_cases(VideoLlavaConfig())
    trunk = [c for c in cases if c[0].startswith("sam2.1-hiera-small")]
    assert sum(c[-1] for c in trunk) == 67
    assert all(c[-1] == 23 for c in cases if c[0] == "CLIP-L/14-336")
