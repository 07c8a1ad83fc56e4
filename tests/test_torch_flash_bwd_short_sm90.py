"""The CPU side of csrc/attention_short_bwd_sm90.cu (K6a + K6b in one pass
at head dim 16 over at most 64 keys: the mask decoder's image->token
attention in the train step): the route `kernels.attention_bwd` takes at
every main-path backward shape, the tensor-map geometry of the mask
decoder's transposed views and of the dO autograd hands
`_FlashAttention.backward`, the work units and the order in which their
dK / dV partials are added, the wrapper's refusals, the mask decoder's
backward reaching `kernels.attention_bwd`, and the plain backward
(`flash_backward_plain`, what the card holds the kernel against) against
the JAX package's Pallas backward in interpret mode at this geometry.
The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).

Tolerance of the plain-vs-Pallas comparison: fp32 on both sides, 2e-5
absolute on outputs and logsumexps, 1e-4 absolute on gradients (sums over
up to 4 x 130 rows in another order), as tests/test_torch_flash_bwd.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.config import VideoLlavaConfig
from video_llava_seg_torch.models.sam2 import mask_decoder as md
from video_llava_seg_torch.models.seg_head import make_sam2_cfg
from video_llava_seg_torch.ops import attention as tatt
from video_llava_seg_tpu.ops import attention as jatt

FWD_ATOL = 2e-5
GRAD_ATOL = 1e-4
SHORT = ("vls_attention_short_bwd_sm90",)
PAIR_CUDA_C = ("vls_attention_bwd_dq", "vls_attention_bwd_dkv")
PAIR_SM90 = ("vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90")


def _decoder_shape():
    """(heads, head dim, image queries, prompt tokens) of the mask
    decoder's image->token attention, and the train step's batch (seg
    frames x objects)."""
    cfg = VideoLlavaConfig()
    sc = make_sam2_cfg(cfg.seg)
    heads = sc.twoway_heads
    hd = sc.hidden_dim // sc.attention_downsample_rate // heads
    n_tok = int(sc.pred_obj_scores) + 1 + (sc.num_multimask_outputs + 1) + 1
    bt = cfg.seg.max_seg_frames * cfg.seg.max_objects
    return heads, hd, sc.image_embedding_size ** 2, n_tok, bt


def _backward_calls():
    """(name, d, Skv, Hkv, route wanted) of every flash backward on the
    train path, and the limits of the one-pass route."""
    lc = VideoLlavaConfig().llm
    heads, hd, _, n_tok, bt = _decoder_shape()
    return [("LLM layers", lc.head_dim, 5132, lc.num_kv_heads, PAIR_SM90),
            (f"mask decoder, batch {bt}", hd, n_tok, heads, SHORT),
            ("mask decoder, batch 8", hd, n_tok, heads, SHORT),
            ("65 keys", hd, 65, heads, PAIR_CUDA_C),
            ("64 keys, slot overflow", hd, 64, 17, PAIR_CUDA_C),
            ("head dim 32", 32, n_tok, heads, PAIR_CUDA_C)]


@pytest.mark.parametrize("call", _backward_calls(), ids=lambda c: c[0])
def test_route_at_every_main_path_backward_shape(call):
    """The mask decoder's backward (head dim 16, 7 keys, 8 heads; train
    batch 64 frame-objects, and 8) takes the one-pass entry wherever its
    forward took attention_short_sm90.cu; the LLM's head dim 128 takes
    attention_bwd_sm90.cu's pair; more than 64 keys, K/V past the
    resident slot and other head dims attention_bwd.cu's pair."""
    _, d, skv, hkv, want = call
    assert kernels.attention_bwd_entry(d, skv, hkv) == want
    fwd_short = kernels.attention_entry(d, True, skv, hkv) == \
        "vls_attention_short_sm90"
    assert fwd_short == (want == SHORT)
    assert all(e in kernels._SIGNATURES and e in kernels.ATTENTION_BWD_ROUTES
               for e in want)


class _Capture(torch.autograd.Function):
    """Stands in for _FlashAttention: returns a [B, H, S, D] view of a
    fresh [B, S, H, D] buffer, as kernels.attention does, and keeps the
    dout autograd hands its backward."""

    seen = []

    @staticmethod
    def forward(ctx, q):
        b, h, s, d = q.shape
        return torch.zeros(b, s, h, d, dtype=q.dtype).permute(0, 2, 1, 3)

    @staticmethod
    def backward(ctx, dout):
        _Capture.seen.append(dout)
        return torch.zeros(dout.shape, dtype=dout.dtype)


def _views(b, nq, n_tok, heads, hd):
    """q, k, v as mask_decoder._attn_apply builds them: [B, N, C] dense
    outputs reshaped to [B, N, H, D] and transposed to [B, H, N, D]."""
    c = heads * hd
    return tuple(torch.zeros(b, n, c, dtype=torch.bfloat16).reshape(
        b, n, heads, hd).transpose(1, 2) for n in (nq, n_tok, n_tok))


def _geometry(q, k, v, out, dout):
    return tuple(kernels._short_bwd_geometry(
        q.shape, q.stride(), k.shape, k.stride(), v.stride(), out.stride(),
        dout.stride(), q.element_size()))


@pytest.mark.parametrize("b,nq,n_tok", [(64, 4096, 7), (8, 4096, 7),
                                        (2, 300, 13), (1, 70, 33)])
def test_geometry_of_the_mask_decoder_views(b, nq, n_tok):
    """Five maps, dims (D, S, H, B) innermost first and the byte strides
    of S, H, B: q, the forward's output and the dO autograd hands back
    through `_attn_apply`'s head merge (`o.transpose(1, 2).reshape(B, N,
    C)` and out_proj) are [B, H, S, 16] views of [B, S, H, 16] buffers,
    read in place with 16-column x 64-row boxes; k and v with boxes of
    max(N, 16) keys of every head. A coordinate addresses t[b, h, s, c]
    through the strides."""
    heads, hd = 8, 16
    q, k, v = _views(b, nq, n_tok, heads, hd)
    _Capture.seen.clear()
    o = _Capture.apply(q.float().requires_grad_(True))
    w = torch.randn(heads * hd, 4)
    (o.transpose(1, 2).reshape(b, nq, heads * hd) @ w).sum().backward()
    dout = _Capture.seen[0].to(torch.bfloat16)
    assert not dout.is_contiguous()
    assert kernels._addressable(dout) is dout, "dO must not be copied"
    out = kernels._bshd(b, nq, heads, hd, q)
    g = _geometry(q, k, v, out, dout)
    assert len(g) == 55
    row = 2 * heads * hd
    n = max(kernels.short_sm90_key_tile(n_tok), 16)
    qmap = (hd, nq, heads, b, row, 2 * hd, row * nq, hd,
            kernels.SHORT_SM90_BQ, 1, 1)
    kmap = (hd, n_tok, heads, b, row, 2 * hd, row * n_tok, hd, n, heads, 1)
    assert g[:11] == g[33:44] == g[44:] == qmap
    assert g[11:22] == g[22:33] == kmap
    rng = np.random.default_rng(0)
    for t, gm in ((dout, g[44:]), (k, g[11:22])):
        for _ in range(10):
            c, si, hi, bi = (int(rng.integers(x)) for x in gm[:4])
            byte = 2 * c + si * gm[4] + hi * gm[5] + bi * gm[6]
            assert byte // 2 == (bi * t.stride(0) + hi * t.stride(1)
                                 + si * t.stride(2) + c)


@pytest.mark.parametrize("batch,hq,hkv,sq,slots,want", [
    (64, 8, 8, 4096, 396, 3),   # the train step on an H100 (132 SMs x 3)
    (64, 8, 8, 4096, 528, 1),
    (8, 8, 8, 4096, 396, 6),
    (3, 8, 2, 1000, 396, 16),   # GQA 4, a partial last q tile
    (75, 8, 8, 4096, 528, 5),   # more (b, h) than slots
    (2, 4, 4, 70, 132, 2),      # more slots than q tiles: one a chunk
    (1, 2, 1, 1, 8, 1)])
def test_units_blocks_and_partial_sums(batch, hq, hkv, sq, slots, want):
    """The schedule as a pure function: the chunk count leaves the
    busiest block the fewest q tiles; the chunks cover each batch row's q
    tiles once, in order; every (b, q head, q tile) is one item of one
    unit, and every unit runs on one block; the second launch adds every
    unit's partial exactly once, into the (b, kv head) its q head belongs
    to, chunk by chunk, each chunk's group of q heads in order."""
    chunks = kernels.short_bwd_sm90_chunks(batch, hq, sq, slots)
    assert chunks == want
    ntq = -(-sq // kernels.SHORT_SM90_BQ)
    grid = min(batch * hq * chunks, slots)
    units, blocks, sums = kernels.short_bwd_sm90_schedule(
        batch, hq, hkv, sq, chunks, grid)
    assert len(units) == batch * chunks * hq and len(blocks) == grid
    busiest = max(sum(units[u][4] - units[u][3] for u in us)
                  for us in blocks)
    ideal = -(-batch * hq * ntq // slots)
    assert busiest <= max(2 * ideal, ntq)
    assert sorted(u for us in blocks for u in us) == list(range(len(units)))
    seen = {}
    for u, (b, c, h, t0, t1) in enumerate(units):
        assert u == (b * chunks + c) * hq + h
        assert t0 < t1
        for t in range(t0, t1):
            assert (b, h, t) not in seen
            seen[b, h, t] = u
    assert len(seen) == batch * hq * ntq
    added = [u for key in sorted(sums) for u in sums[key]]
    assert sorted(added) == list(range(len(units)))
    group = hq // hkv
    for (b, hk), us in sums.items():
        got = [(units[u][1], units[u][2]) for u in us]
        assert all(units[u][0] == b for u in us)
        assert got == [(c, hk * group + g) for c in range(chunks)
                       for g in range(group)]


def test_blocks_and_shared_memory():
    """Three blocks an SM at the mask decoder's 8-key tile and 8 heads;
    every key tile and head count the route admits fits one block's
    shared memory (the C entry refuses a launch above 227 KB)."""
    assert kernels.short_bwd_sm90_blocks(8, 8) == 3
    for n in (8, 16, 32, 64):
        for hkv in range(1, 129):
            skv = n if n > 8 else 7
            if kernels.attention_bwd_entry(16, skv, hkv) != SHORT:
                continue
            smem = (1024 + kernels.SHORT_BWD_SM90_STAGES * 6144
                    + 4 * hkv * max(n, 16) * 32 + 512 * n
                    + (2 * kernels.SHORT_BWD_SM90_STAGES + 4) * 8)
            assert smem <= 232448, (n, hkv)
            assert 1 <= kernels.short_bwd_sm90_blocks(n, hkv) \
                <= kernels.SHORT_BWD_SM90_BLOCKS[n]


def _bwd_args(b=2, nq=128, n_tok=7, heads=8):
    q, k, v = _views(b, nq, n_tok, heads, 16)
    out = kernels._bshd(b, nq, heads, 16, q)
    lse = torch.zeros(b, heads, nq)
    return q, k, v, out, out, lse


def test_refusals():
    """What TMA cannot read (a row stride off 16 bytes, a strided last
    dim), mismatched shapes and a non-contiguous lse are refused before
    any launch; inputs the route and TMA accept reach the device check,
    which a CPU tensor fails."""
    q, k, v, out, dout, lse = _bwd_args()
    kw = dict(scale=0.25, causal=False)
    odd = torch.zeros(2, 128, 8 * 16 + 4, dtype=torch.bfloat16)
    qo = odd[..., :128].reshape(2, 128, 8, 16).transpose(1, 2)
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.attention_bwd(qo, k, v, out, dout, lse, **kw)
    strided = torch.zeros(2, 8, 7, 32, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dim"):
        kernels.attention_bwd(q, strided, v, out, dout, lse, **kw)
    with pytest.raises(ValueError, match="k/v shapes do not match"):
        kernels.attention_bwd(q, k, v[:, :, :6], out, dout, lse, **kw)
    with pytest.raises(ValueError, match="must have q's shape"):
        kernels.attention_bwd(q, k, v, out[:, :, :64], dout, lse, **kw)
    with pytest.raises(ValueError, match="lse must be"):
        kernels.attention_bwd(q, k, v, out, dout, lse.transpose(1, 2)
                              .contiguous().transpose(1, 2), **kw)
    with pytest.raises(ValueError, match="lse must be"):
        kernels.attention_bwd(q, k, v, out, dout, lse[:, :, :64], **kw)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kernels.attention_bwd(q, k, v, out, dout, lse, **kw)
    assert kernels.ATTENTION_BWD_LAUNCHES.snapshot()[SHORT[0]] == 0


def test_mask_decoder_backward_reaches_the_new_entry(monkeypatch):
    """`_attn_apply` at the real widths (256 channels, 8 heads of 16) with
    ops.attention's CUDA branch in place of its CPU one: the forward goes
    through `_FlashAttention` (kernels.attention stood in by the plain
    forward), and its backward hands kernels.attention_bwd the decoder's
    views on the one-pass route, counting one K6a and one K6b; the
    gradients equal autograd through the plain attention."""
    heads, hd, _, n_tok, _ = _decoder_shape()
    sc = make_sam2_cfg(VideoLlavaConfig().seg)
    g = torch.Generator().manual_seed(0)
    p = md._attn_init(g, sc.hidden_dim, sc.attention_downsample_rate,
                      torch.device("cpu"), torch.float32)
    seen = []

    def fwd(q, k, v, *, scale, causal, kv_bias, two_pass, with_lse, window):
        assert two_pass and with_lse and kv_bias is None and window == 0
        return tatt.flash_forward_plain(q, k, v, None, causal=causal,
                                        scale=scale)

    def bwd(q, k, v, out, dout, lse, *, scale, causal, kv_bias, window):
        assert window == 0
        seen.append(kernels.attention_bwd_entry(q.shape[-1], k.shape[2],
                                                k.shape[1]))
        # the maps of the same views in bf16, as the train step has them
        dout = kernels._addressable(dout)
        seen.append(tuple(kernels._short_bwd_geometry(
            q.shape, q.stride(), k.shape, k.stride(), v.stride(),
            out.stride(), dout.stride(), 2)))
        return tatt.flash_backward_plain(q, k, v, kv_bias, out, lse, dout,
                                         causal=causal, scale=scale)

    def cuda_branch(q, k, v, backend="auto", **kw):
        assert backend == "auto"
        return tatt._FlashAttention.apply(q, k, v, None, False,
                                          q.shape[-1] ** -0.5, True)

    monkeypatch.setattr(kernels, "attention", fwd)
    monkeypatch.setattr(kernels, "attention_bwd", bwd)
    img = torch.randn(2, 256, sc.hidden_dim, generator=g)
    tok = torch.randn(2, n_tok, sc.hidden_dim, generator=g)
    gy = torch.randn(2, 256, sc.hidden_dim, generator=g)
    grads = []
    for attn in (cuda_branch, tatt.attention):
        monkeypatch.setattr(md, "attention", attn)
        x = img.clone().requires_grad_(True)
        y = tok.clone().requires_grad_(True)
        before = kernels.LAUNCHES.snapshot()
        (md._attn_apply(p, x, y, y, heads) * gy).sum().backward()
        after = kernels.LAUNCHES.snapshot()
        grads.append((x.grad, y.grad))
        if attn is cuda_branch:
            assert [after[n] - before[n] for n in ("K6a", "K6b")] == [1, 1]
    route, geom = seen
    assert route == SHORT
    assert geom[4:7] == (2 * heads * hd, 2 * hd, 2 * heads * hd * 256)
    assert geom[48:51] == geom[4:7]   # dO read in place
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


CASES = {
    # name: (b, hq, hkv, sq, skv, causal, masked keys)
    "decoder_7_keys": (1, 4, 4, 200, 7, False, None),
    "keys_33_gqa2": (1, 4, 2, 130, 33, False, None),
    "causal_gqa2": (1, 4, 2, 5, 7, True, None),
    "bias_masked_gqa2": (2, 2, 1, 100, 7, False, (3, 5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_pallas(name):
    """flash_backward_plain against `_fa_bwd_impl` in interpret mode (K6a
    and K6b of the JAX package) on the Pallas forward's output and
    logsumexp (`_fa_core(save_lse=True)`, which the plain forward matches
    too): head dim 16 over 7 and 33 keys, GQA 1 and 2, causal with the
    diagonal at the sequence ends, a finite per-key bias with masked keys
    (their dK / dV exactly 0)."""
    b, hq, hkv, sq, skv, causal, masked = CASES[name]
    r = np.random.default_rng(7)
    q, do = (r.standard_normal((b, hq, sq, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (r.standard_normal((b, hkv, skv, 16)).astype(np.float32)
            for _ in range(2))
    bias = None
    if masked is not None:
        bias = (2 * r.standard_normal((b, skv))).astype(np.float32)
        bias[:, list(masked)] = tatt.MASK_VALUE
    scale = 0.25
    jb = None if bias is None else jnp.asarray(bias)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jout, jlse = jatt._fa_core(jq, jk, jv, jb, causal=causal, scale=scale,
                               block_q=256, block_k=512, interpret=True,
                               save_lse=True)
    t = [None if x is None else torch.from_numpy(x)
         for x in (q, k, v, do, bias)]
    out, lse = tatt.flash_forward_plain(t[0], t[1], t[2], t[4],
                                        causal=causal, scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_ATOL,
                               rtol=0)
    want = jatt._fa_bwd_impl(jq, jk, jv, jb, jout, jlse, jnp.asarray(do),
                             causal=causal, scale=scale, block_q=256,
                             block_k=512, interpret=True)
    got = tatt.flash_backward_plain(
        t[0], t[1], t[2], t[4], torch.from_numpy(np.array(jout)),
        torch.from_numpy(np.array(jlse)), t[3], causal=causal, scale=scale)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0)
    if masked is not None:
        for g_ in got[1:]:
            dead = g_.numpy()[:, :, list(masked)]
            assert not dead.any(), "masked keys got a gradient"
