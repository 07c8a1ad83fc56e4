"""The CPU side of csrc/attention_sm90.cu at head dims 64 / 80 / 96 (the
online form on TMA and wgmma for the towers' attention link, K4's blocks
and the per-op Hiera trunk's global blocks): the route
`kernels.attention_entry` takes at every main-path attention call of the
configs and what it refuses, the tensor-map geometry (both boxes) of the
views the ViT and K4 chains hand the kernel, and the plain forward with
its logsumexp (`flash_forward_plain`, what the card holds the kernel
against) against the JAX package's `_fa_core(save_lse=True)` in
interpret mode at these head dims. The kernel itself runs only on the
card (tests/test_torch_kernels_cuda.py).

Tolerance of the plain-vs-Pallas comparison: fp32 on both sides, 2e-5
absolute on outputs and logsumexps (sums in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.config import VideoLlavaConfig, VisionTowerConfig
from video_llava_seg_torch.models.sam2 import hiera
from video_llava_seg_torch.models.seg_head import make_sam2_cfg
from video_llava_seg_torch.ops import attention as tatt
from video_llava_seg_torch.ops import hiera_block as hb
from video_llava_seg_tpu.ops import attention as jatt

ATOL = 2e-5
SM90 = "vls_flash_fwd_sm90"
SHORT = "vls_attention_short_sm90"
CUDA_C = "vls_attention_bf16"


def _towers():
    """(name, tower config) of every tower the configs serve."""
    cfg = VideoLlavaConfig()
    return [("CLIP-L", cfg.vision),
            ("S2 CLIP-L", dataclasses.replace(cfg.vision,
                                              s2_scales=(336, 672, 1008))),
            ("RADIO-H", VisionTowerConfig.radio()),
            ("RADIO-L", VisionTowerConfig.radio("nvidia/RADIO-L")),
            ("RADIO-B", VisionTowerConfig.radio("nvidia/RADIO-B"))]


def _trunk_blocks():
    """(block, head dim, keys, heads, global) of every block of the seg
    head's SAM2.1-hiera-small trunk at its image size: K4 calls the
    online form once a block over ws^2 keys a window, or the whole map's
    for a global block."""
    sc = make_sam2_cfg(VideoLlavaConfig().seg)
    dims = hiera.block_dims(sc.hiera)
    side = sc.image_size // sc.hiera.patch_stride
    out = []
    for i, (_, dout, nh, ws, _) in enumerate(dims):
        hw = side // (2 ** sum(1 for j in range(i) if dims[j][4]))
        out.append((i, dout // nh, ws * ws if ws else hw * hw, nh, ws == 0))
    return out


def _main_path_calls():
    """(name, d, two_pass, Skv, Hkv, bias, entry wanted) of every
    attention call of the serving, train and vision paths."""
    cfg = VideoLlavaConfig()
    calls = []
    for name, vc in _towers():
        # ops/vit_block.py: the online form over the crop's tokens
        n = vc.num_patches + int(vc.use_cls_token) + vc.num_register_tokens
        calls.append((f"{name} link", vc.hidden_size // vc.num_heads, False,
                      n, vc.num_heads, False, SM90))
    for i, hd, keys, nh, glob in _trunk_blocks():
        calls.append((f"K4 block {i}", hd, False, keys, nh, False, SM90))
        if glob:
            # the per-op trunk: ops.attention's split, K2 above 1024 keys
            single = keys <= tatt.SINGLE_BLOCK_MAX_KV
            calls.append((f"per-op trunk block {i}", hd, single, keys, nh,
                          False, SM90))
    lc = cfg.llm
    for bias in (False, True):
        calls.append((f"LLM prefill{' (left pad)' if bias else ''}",
                      lc.head_dim, False, 5196, lc.num_kv_heads, bias, SM90))
    sc = make_sam2_cfg(cfg.seg)
    heads = sc.twoway_heads
    n_tok = int(sc.pred_obj_scores) + 1 + (sc.num_multimask_outputs + 1) + 1
    calls.append(("mask decoder (K3)",
                  sc.hidden_dim // sc.attention_downsample_rate // heads,
                  True, n_tok, heads, False, SHORT))
    return calls


@pytest.mark.parametrize("call", _main_path_calls(), ids=lambda c: c[0])
def test_route_of_every_main_path_call(call):
    """The towers' links (CLIP-L, S2, RADIO-H / L / B: head dims 64 / 80
    over 577 keys), every K4 block (head dim 96, 16-196 keys a window,
    4096 for a global block), the per-op trunk's global blocks and the
    LLM (head dim 128, with and without its pad bias) take
    attention_sm90.cu; the mask decoder takes attention_short_sm90.cu."""
    _, d, two_pass, skv, hkv, bias, want = call
    assert kernels.attention_entry(d, two_pass, skv, hkv, bias=bias) == want
    assert want in kernels._SIGNATURES and want in kernels.ATTENTION_ROUTES


@pytest.mark.parametrize("d", kernels.ATTENTION_HEAD_DIMS)
def test_route_refusals(d):
    """attention.cu keeps head dims 16 / 32, a per-key bias below head dim
    128, fewer than FLASH_SM90_MIN_KEYS keys and the two-pass form beyond
    the mask decoder's; head dim 128 keeps every online call."""
    few = kernels.FLASH_SM90_MIN_KEYS - 1
    hd = d in kernels.FLASH_SM90_HEAD_DIMS
    assert (kernels.attention_entry(d, False, 577, 16) == SM90) == hd
    assert (kernels.attention_entry(d, False, 577, 16, bias=True) == SM90) \
        == (d == 128)
    assert (kernels.attention_entry(d, False, few, 16) == SM90) \
        == (d == 128)
    assert kernels.attention_entry(d, True, 577, 16) == CUDA_C


def _views(b, s, h, d):
    """q, k, v as the chains build them: ops/vit_block.py's [B*S, H*D]
    denses viewed [B, S, H, D] and permuted to [B, H, S, D]."""
    return tuple(torch.zeros(b * s, h * d, dtype=torch.bfloat16)
                 .view(b, s, h, d).permute(0, 2, 1, 3) for _ in range(3))


def test_forced_route_refusals():
    """A forced sm90 route with a per-key bias below head dim 128, at head
    dim 32, or in the two-pass form is refused before any launch (the
    route checks run before the device check, so the CPU reaches them)."""
    q, k, v = _views(1, 64, 2, 64)
    bias = torch.zeros(1, 64)
    with pytest.raises(ValueError, match="per-key bias at 128"):
        kernels.attention(q, k, v, scale=0.125, kv_bias=bias, route=SM90)
    with pytest.raises(ValueError, match="head dims"):
        kernels.attention(*_views(1, 64, 2, 32), scale=0.125, route=SM90)
    with pytest.raises(ValueError, match="head dims"):
        kernels.attention(q, k, v, scale=0.125, two_pass=True, route=SM90)


def _geometry(q, k, v):
    return tuple(kernels._forward_geometry(SM90, q.shape, q.stride(),
                                           k.shape, k.stride(), v.stride(),
                                           q.element_size()))


def _addresses(t, g):
    """A TMA coordinate (c, s, h, b) of geometry g addresses t[b, h, s, c]:
    its byte offset through g's strides from the view's first element."""
    rng = np.random.default_rng(0)
    for _ in range(10):
        c, si, hi, bi = (int(rng.integers(x)) for x in g[:4])
        byte = 2 * c + si * g[4] + hi * g[5] + bi * g[6]
        assert byte // 2 == (bi * t.stride(0) + hi * t.stride(1)
                             + si * t.stride(2) + c)


@pytest.mark.parametrize("d,heads", [(64, 16), (80, 16), (96, 4)])
def test_geometry_of_vit_views(d, heads):
    """The ViT chain's [bt, n, h, hd] dense outputs (an H stride of 128 /
    160 / 192 bytes): dims (D, S, H, B) and byte strides of S, H, B; the
    leading box 64 columns x 128 rows and, at head dims 80 / 96, the q, k
    and v maps of the 16 / 32-column remainder box after them (6 x 11
    int64)."""
    b, s = 3, 577
    q, k, v = _views(b, s, heads, d)
    g = _geometry(q, k, v)
    rem = d % 64
    assert len(g) == (66 if rem else 33)
    row = 2 * heads * d
    for i in range(3):
        gi = g[11 * i:11 * i + 11]
        assert gi[:7] == (d, s, heads, b, row, 2 * d, row * s)
        assert gi[7:] == kernels.FLASH_SM90_BOX
        _addresses((q, k, v)[i], gi)
        if rem:
            assert g[33 + 11 * i:44 + 11 * i] == gi[:7] + (rem, 128, 1, 1)


@pytest.mark.parametrize("ws", [0, 8, 14])
def test_k4_hands_the_kernel_its_views(monkeypatch, ws):
    """ops/hiera_block.attention_stage at a SAM2.1-hiera-small stage-3
    width (384 channels, 4 heads of 96) hands kernels.attention the
    column slices of its fused-qkv map: k and v start 768 / 1536 bytes
    into the row (16-byte aligned), rows are 2304 bytes, a head 192;
    their geometry carries both boxes (64 + 32 columns), and the call
    routes to attention_sm90.cu. ws 0: a global block (the whole 16 x 16
    map, 256 keys)."""
    b, side, heads, hd = 2, 28 if ws == 14 else 16, 4, 96
    c = heads * hd
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q, k, v, kw))
        return torch.zeros(q.shape, dtype=q.dtype)

    monkeypatch.setattr(kernels, "attention", spy)
    qkv = torch.zeros(b, side, side, 3 * c, dtype=torch.bfloat16)
    out = hb.attention_stage(qkv, num_heads=heads, ws=ws or side, ps=1)
    assert out.shape == (b, side, side, c)
    (q, k, v, kw), = seen
    keys = (ws or side) ** 2
    assert k.shape[1:] == (heads, keys, hd)
    assert kw.get("route") is None and not kw.get("two_pass", False)
    assert kernels.attention_entry(hd, False, keys, heads) == SM90
    g = _geometry(q, k, v)
    assert len(g) == 66
    base = q.data_ptr()
    assert (k.data_ptr() - base, v.data_ptr() - base) == (2 * c, 4 * c)
    assert all((t.data_ptr() % 16) == 0 for t in (q, k, v))
    for i, t in enumerate((q, k, v)):
        gi = g[11 * i:11 * i + 11]
        assert gi[4:6] == (2 * 3 * c, 2 * hd)
        assert g[33 + 11 * i:44 + 11 * i][7:] == (32, 128, 1, 1)
        _addresses(t, gi)


PLAIN_CASES = {
    # name: (b, hq, hkv, sq, skv, causal, kv_len); kv_len < Skv rides a
    # mask bias on both sides (what the kernel's kv_len computes)
    "vit_kv_len": (2, 2, 2, 77, 77, False, 70),          # short-KV regime
    "online_kv_len_ragged_q": (1, 2, 1, 70, 1030, False, 1000),
    "causal_sq_lt_skv": (1, 2, 2, 40, 1100, True, None),
}


@pytest.mark.parametrize("d", [64, 80, 96])
@pytest.mark.parametrize("name", sorted(PLAIN_CASES))
def test_plain_forward_with_lse_matches_pallas(name, d):
    """flash_forward_plain (out, lse) against the JAX package's
    `_fa_core(save_lse=True)` in interpret mode (its short-KV kernel up to
    1024 keys, the online kernel above) at head dims 64 / 80 / 96:
    non-causal with kv_len < Skv, Sq no multiple of the block, causal
    with Sq < Skv, GQA 2."""
    b, hq, hkv, sq, skv, causal, kv_len = PLAIN_CASES[name]
    r = np.random.default_rng(d)
    q = r.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = r.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = r.standard_normal((b, hkv, skv, d)).astype(np.float32)
    bias = None
    if kv_len is not None:
        bias = np.where(np.arange(skv) < kv_len, 0.0,
                        tatt.MASK_VALUE).astype(np.float32)
        bias = np.broadcast_to(bias, (b, skv)).copy()
    scale = d ** -0.5
    jout, jlse = jatt._fa_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), causal=causal,
        scale=scale, block_q=256, block_k=512, interpret=True,
        save_lse=True)
    out, lse = tatt.flash_forward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), causal=causal,
        scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=0)
