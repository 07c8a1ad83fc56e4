"""The CPU side of csrc/attention_short_sm90.cu (K3 on TMA and wgmma: the
two-pass form at head dim 16 with at most 64 keys, K/V resident, Q
streamed): the route `kernels.attention_entry` takes at every main-path
attention shape, the tensor-map geometry of the mask decoder's
transposed views and what it refuses, and the plain forward with its
logsumexp (`flash_forward_plain`, what the card holds the kernel
against) against the JAX package's Pallas kernel in interpret mode in the
K3 regime. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py).

Tolerance of the plain-vs-Pallas comparison: fp32 on both sides over 7
keys, 2e-5 absolute on outputs and logsumexps (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.config import VideoLlavaConfig
from video_llava_seg_torch.models.sam2 import hiera
from video_llava_seg_torch.models.sam2 import mask_decoder as md
from video_llava_seg_torch.models.seg_head import make_sam2_cfg
from video_llava_seg_torch.ops import attention as tatt
from video_llava_seg_tpu.ops import attention as jatt

ATOL = 2e-5
SHORT = "vls_attention_short_sm90"
CUDA_C = "vls_attention_bf16"
SM90 = "vls_flash_fwd_sm90"


def _mask_decoder_shape(cfg):
    """(heads, head dim, image queries, prompt tokens) of the mask
    decoder's image->token attention."""
    sc = make_sam2_cfg(cfg.seg)
    heads = sc.twoway_heads
    hd = sc.hidden_dim // sc.attention_downsample_rate // heads
    n_tok = int(sc.pred_obj_scores) + 1 + (sc.num_multimask_outputs + 1) + 1
    return heads, hd, sc.image_embedding_size ** 2, n_tok


def _main_path_calls():
    """(name, d, two_pass, Skv, Hkv, entry wanted) of every attention call
    on the serving, train and vision paths, from the configs."""
    cfg = VideoLlavaConfig()
    heads, hd, _, n_tok = _mask_decoder_shape(cfg)
    single = n_tok <= tatt.SINGLE_BLOCK_MAX_KV
    calls = [("mask decoder (serving and train)", hd, single, n_tok, heads,
              SHORT)]
    for name, vc in (("K1 / K8 link, CLIP-L", cfg.vision),
                     ("K1 / K8 link, RADIO-H",
                      type(cfg.vision).radio())):
        # ops/vit_block.py calls kernels.attention in its online form
        calls.append((name, vc.hidden_size // vc.num_heads, False,
                      vc.num_patches + 1, vc.num_heads, SM90))
    lc = cfg.llm
    calls.append(("K2, LLM prefill and train forward", lc.head_dim, False,
                  5196, lc.num_kv_heads, SM90))
    sc = make_sam2_cfg(cfg.seg)
    side = sc.image_size // sc.hiera.patch_stride
    pools = 0
    for din, dout, nh, ws, pool in hiera.block_dims(sc.hiera):
        hw = side // (2 ** pools)
        pools += bool(pool)
        if ws == 0:
            skv = hw * hw
            calls.append(("per-op trunk global block", dout // nh,
                          skv <= tatt.SINGLE_BLOCK_MAX_KV, skv, nh, SM90))
    return calls


@pytest.mark.parametrize("call", _main_path_calls(), ids=lambda c: c[0])
def test_route_at_every_main_path_shape(call):
    """The mask decoder's image->token attention (head dim 16, 7 keys, 8
    heads; serving batch 8 frames, train 64 frame-objects) takes the new
    entry; K1's / K8's link (head dims 64 and 80 over 577 keys), the
    per-op trunk's global blocks (head dim 96 over 4096 keys) and K2 at
    head dim 128 take attention_sm90.cu."""
    _, d, two_pass, skv, hkv, want = call
    assert kernels.attention_entry(d, two_pass, skv, hkv) == want
    assert want in kernels._SIGNATURES and want in kernels.ATTENTION_ROUTES


@pytest.mark.parametrize("skv,hkv,want", [
    (1, 8, SHORT), (7, 8, SHORT), (8, 1, SHORT), (9, 8, SHORT),
    (64, 8, SHORT), (64, 16, SHORT), (65, 8, CUDA_C), (64, 17, CUDA_C),
    (1000, 8, CUDA_C), (0, 8, CUDA_C)])
def test_route_limits(skv, hkv, want):
    """Up to 64 keys (one wgmma N tile) and a batch row's K/V within the
    resident slot (SHORT_SM90_KV_SLOT_MAX); the online form and other
    head dims never take the new entry."""
    assert kernels.attention_entry(16, True, skv, hkv) == want
    assert kernels.attention_entry(16, False, skv, hkv) == CUDA_C
    assert kernels.attention_entry(32, True, skv, hkv) == CUDA_C


@pytest.mark.parametrize("skv,n", [(1, 8), (7, 8), (8, 8), (9, 16),
                                   (16, 16), (17, 32), (33, 64), (64, 64)])
def test_key_tile(skv, n):
    assert kernels.short_sm90_key_tile(skv) == n


def _geometry(q, k, v):
    """What kernels.attention hands attention_short_sm90.cu for q, k, v."""
    return tuple(kernels._forward_geometry(SHORT, q.shape, q.stride(),
                                           k.shape, k.stride(), v.stride(),
                                           q.element_size()))


def _decoder_views(b, nq, n_tok, heads, hd):
    """q, k, v as mask_decoder._attn_apply builds them: [B, N, C] dense
    outputs reshaped to [B, N, H, D] and transposed to [B, H, N, D]."""
    c = heads * hd
    q = torch.zeros(b, nq, c, dtype=torch.bfloat16)
    k = torch.zeros(b, n_tok, c, dtype=torch.bfloat16)
    v = torch.zeros(b, n_tok, c, dtype=torch.bfloat16)
    return tuple(t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)
                 for t in (q, k, v))


@pytest.mark.parametrize("b,nq,n_tok", [(8, 4096, 7), (64, 4096, 7),
                                        (2, 300, 13), (1, 70, 33)])
def test_geometry_of_mask_decoder_views(b, nq, n_tok):
    """dims (D, S, H, B) innermost first and the byte strides of S, H, B
    of the transposed views (32 bytes a head, 256-byte rows); q's box is
    16 columns x 64 rows of one head, k's all heads' keys rounded up to
    the score tile, v's at least 16 keys (TMA zero-fills past Skv); a
    coordinate addresses t[b, h, s, c] through the strides."""
    heads, hd = 8, 16
    q, k, v = _decoder_views(b, nq, n_tok, heads, hd)
    assert not q.is_contiguous()
    g = _geometry(q, k, v)
    assert len(g) == 33
    gq, gk, gv = g[:11], g[11:22], g[22:]
    row = 2 * heads * hd
    n = kernels.short_sm90_key_tile(n_tok)
    assert gq == (hd, nq, heads, b, row, 2 * hd, row * nq, hd,
                  kernels.SHORT_SM90_BQ, 1, 1)
    assert gk == (hd, n_tok, heads, b, row, 2 * hd, row * n_tok, hd, n,
                  heads, 1)
    assert gv == gk[:8] + (max(n, 16), heads, 1)
    rng = np.random.default_rng(0)
    t = k
    for _ in range(10):
        c, si, hi, bi = (int(rng.integers(x)) for x in gk[:4])
        byte = 2 * c + si * gk[4] + hi * gk[5] + bi * gk[6]
        assert byte // 2 == (bi * t.stride(0) + hi * t.stride(1)
                             + si * t.stride(2) + c)


def test_mask_decoder_hands_the_kernel_its_views(monkeypatch):
    """mask_decoder._attn_apply at the real widths (256 channels, 8 heads
    of 16) sends image->token attention (>= 256 queries) to
    ops.attention with backend 'auto', as views whose route is the new
    entry and whose geometry the kernel takes."""
    cfg = VideoLlavaConfig()
    heads, hd, _, n_tok = _mask_decoder_shape(cfg)
    sc = make_sam2_cfg(cfg.seg)
    g = torch.Generator().manual_seed(0)
    p = md._attn_init(g, sc.hidden_dim, sc.attention_downsample_rate,
                      torch.device("cpu"), torch.bfloat16)
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q, k, v, kw))
        return tatt.attention(q, k, v, **kw)

    monkeypatch.setattr(md, "attention", spy)
    img = torch.randn(2, 256, sc.hidden_dim, generator=g).to(torch.bfloat16)
    tok = torch.randn(2, n_tok, sc.hidden_dim, generator=g).to(
        torch.bfloat16)
    out = md._attn_apply(p, img, tok, tok, heads)
    assert out.shape == img.shape
    (q, k, v, kw), = seen
    assert kw["backend"] == "auto"
    assert q.shape == (2, heads, 256, hd) and k.shape == (2, heads, n_tok, hd)
    single = k.shape[2] <= tatt.SINGLE_BLOCK_MAX_KV
    assert kernels.attention_entry(hd, single, n_tok, heads) == SHORT
    gq = _geometry(q, k, v)[:11]
    assert gq[4:7] == (2 * heads * hd, 2 * hd, 2 * heads * hd * 256)


def test_refusals():
    """A forced route the shapes do not fit, views TMA cannot read and an
    unknown route are refused before any launch (the route and shape
    checks run before the device check, so the CPU reaches them)."""
    q, k, v = _decoder_views(2, 128, 7, 8, 16)
    kw = dict(scale=0.25, two_pass=True, route=SHORT)
    for bad in (_decoder_views(2, 128, 65, 8, 16),      # > 64 keys
                _decoder_views(2, 128, 7, 4, 32),       # head dim 32
                _decoder_views(2, 128, 64, 24, 16)):    # slot too large
        with pytest.raises(ValueError, match="serves the two-pass form"):
            kernels.attention(*bad, **kw)
    with pytest.raises(ValueError, match="serves the two-pass form"):
        kernels.attention(q, k, v, scale=0.25, route=SHORT)
    with pytest.raises(ValueError, match="k/v shapes do not match"):
        kernels.attention(q, k, v[:, :, :6], **kw)
    odd = torch.zeros(2, 128, 8 * 16 + 4, dtype=torch.bfloat16)
    qo = odd[..., :128].reshape(2, 128, 8, 16).transpose(1, 2)
    with pytest.raises(ValueError, match="multiples of 16"):
        _geometry(qo, k, v)
    strided = torch.zeros(2, 8, 7, 32, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dim"):
        _geometry(q, strided, v)
    with pytest.raises(ValueError, match="route must be one of"):
        kernels.attention(q, k, v, scale=0.25, two_pass=True,
                          route="vls_attention_short")


CASES = {
    # name: (b, hq, hkv, sq, skv, causal, kv_len, bias)
    "mask_decoder": (2, 8, 8, 300, 7, False, None, False),
    "kv_len": (2, 4, 4, 200, 7, False, 5, False),
    "bias": (2, 4, 2, 130, 7, False, None, True),
    "causal_short_q_gqa": (1, 4, 2, 5, 7, True, None, False),
    "causal_long_q": (1, 2, 2, 70, 7, True, None, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_with_lse_matches_pallas(name):
    """flash_forward_plain (out, lse) against the Pallas
    `_flash_kernel_single` in interpret mode, through
    `_fa_core(save_lse=True)`: the forward of `flash_attention`'s
    custom_vjp with the logsumexp it saves for the backward.
    kv_len < Skv rides a mask bias on both sides (what the kernel's
    kv_len computes for every row that sees a key); a finite per-key
    bias; causal with Sq < Skv and Sq > Skv (rows that see no key are
    left out: the three versions give them three values, ROADMAP queue
    3)."""
    b, hq, hkv, sq, skv, causal, kv_len, with_bias = CASES[name]
    r = np.random.default_rng(5)
    q = r.standard_normal((b, hq, sq, 16)).astype(np.float32)
    k = r.standard_normal((b, hkv, skv, 16)).astype(np.float32)
    v = r.standard_normal((b, hkv, skv, 16)).astype(np.float32)
    bias = None
    if kv_len is not None:
        bias = np.where(np.arange(skv) < kv_len, 0.0,
                        tatt.MASK_VALUE).astype(np.float32)
        bias = np.broadcast_to(bias, (b, skv)).copy()
    if with_bias:
        bias = (2 * r.standard_normal((b, skv))).astype(np.float32)
        bias[1, 3] = tatt.MASK_VALUE
    scale = 0.25
    jb = None if bias is None else jnp.asarray(bias)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jout, jlse = jatt._fa_core(jq, jk, jv, jb, causal=causal, scale=scale,
                               block_q=256, block_k=512, interpret=True,
                               save_lse=True)
    out, lse = tatt.flash_forward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), causal=causal,
        scale=scale)
    rows = slice(max(0, sq - skv), None) if causal else slice(None)
    np.testing.assert_allclose(out.numpy()[:, :, rows],
                               np.asarray(jout)[:, :, rows], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy()[:, :, rows],
                               np.asarray(jlse)[:, :, rows], atol=ATOL,
                               rtol=0)
