"""The CPU side of csrc/attention_bwd_sm90.cu (K6a / K6b at head dim 128
on TMA and wgmma): the route `kernels.attention_bwd` takes by head dim
and key count, the tensor-map geometry the wrappers hand the C entries
for the operands as autograd gives them to `_FlashAttention.backward`,
the strides of the gradient buffers, the refusal of what TMA cannot read,
the build hash over the shared header, and the plain backward against the
JAX package's Pallas backward (interpret mode) at the LLM's head dim. The
kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.ops import attention as tatt
from video_llava_seg_tpu.ops import attention as jatt


@pytest.mark.parametrize("d", kernels.ATTENTION_HEAD_DIMS)
def test_attention_bwd_entry_route(d):
    """Head dim 128 (the LLM, 5,132 keys) goes to attention_bwd_sm90.cu's
    pair, with Mistral's window (4096) or MPT's per-head bias too; head
    dim 16 over the mask decoder's 7 keys to the one-pass
    attention_short_bwd_sm90.cu; every other head dim, and head dim 16
    over more than 64 keys, stays on attention_bwd.cu's pair, and refuses
    the window and the per-head bias."""
    pair = ("vls_attention_bwd_dq", "vls_attention_bwd_dkv")
    sm90 = ("vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90")
    want = (sm90 if d == 128
            else ("vls_attention_short_bwd_sm90",) if d == 16 else pair)
    skv = 5132 if d == 128 else 7
    assert kernels.attention_bwd_entry(d, skv, 8) == want
    assert all(name in kernels._SIGNATURES for name in want)
    for kw in (dict(window=4096), dict(head_bias=True)):
        if d == 128:
            assert kernels.attention_bwd_entry(d, 5132, 8, **kw) == sm90
        else:
            with pytest.raises(ValueError, match="head dim 128"):
                kernels.attention_bwd_entry(d, skv, 8, **kw)
    if d != 128:
        assert kernels.attention_bwd_entry(d, 65, 8) == pair


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


def _llm_qkv(b, s, hq, hkv, d, fused):
    """q, k, v as models/llama.py::_attn_block builds them: [B, S, H*D]
    denses (or column slices of one fused-qkv dense) viewed [B, S, H, D]
    and transposed."""
    width = (hq + 2 * hkv) * d
    qkv = torch.arange(b * s * width, dtype=torch.float32).reshape(
        b, s, width).to(torch.bfloat16)
    if fused:
        parts = (qkv[..., :hq * d], qkv[..., hq * d:(hq + hkv) * d],
                 qkv[..., (hq + hkv) * d:])
    else:
        parts = (qkv[..., :hq * d].contiguous(),
                 qkv[..., hq * d:(hq + hkv) * d].contiguous(),
                 qkv[..., (hq + hkv) * d:].contiguous())
    return tuple(t.reshape(b, s, -1, d).transpose(1, 2) for t in parts)


def _assert_addresses(t, g):
    """The geometry's strides address t[b, h, s, c] from t's base."""
    flat = t.untyped_storage()
    base = t.storage_offset() * t.element_size()
    rng = np.random.default_rng(0)
    for _ in range(20):
        c, si, hi, bi = (int(rng.integers(n)) for n in g[:4])
        byte = base + 2 * c + si * g[4] + hi * g[5] + bi * g[6]
        got = torch.tensor([], dtype=t.dtype).set_(flat, byte // 2, (1,))
        assert got.item() == t[bi, hi, si, c].item()


@pytest.mark.parametrize("fused", [False, True])
def test_tensor_maps_of_the_backward_operands(fused):
    """The four maps (q, k, v, dO) with the backward's 64 x 64 box, for
    the fused-qkv column slices (or separate denses) of the forward and
    the dO autograd hands back through the head merge
    (`o.transpose(1, 2).reshape(B, S, H * D)` and the output dense): dO
    is a [B, H, S, D] view of a [B, S, H, D] gradient, read in place."""
    b, s, hq, hkv, d = 2, 37, 4, 2, 128
    q, k, v = _llm_qkv(b, s, hq, hkv, d, fused)
    _Capture.seen.clear()
    o = _Capture.apply(q.float().requires_grad_(True))
    w = torch.randn(hq * d, 8)
    (o.transpose(1, 2).reshape(b, s, hq * d) @ w).sum().backward()
    dout = _Capture.seen[0].to(torch.bfloat16)
    assert not dout.is_contiguous()
    dout_t = kernels._addressable(dout)
    assert dout_t is dout, "dO must not be copied"
    geom = kernels.flash_bwd_sm90_geometry(q, k, v, dout_t)
    assert len(geom) == 44
    row = 2 * (hq + 2 * hkv) * d if fused else None
    for i, (t, h) in enumerate(zip((q, k, v, dout), (hq, hkv, hkv, hq))):
        g = geom[11 * i:11 * (i + 1)]
        assert g[:4] == (d, s, h, b)
        assert g[7:] == kernels.FLASH_SM90_BWD_BOX
        if i < 3:
            r = row if fused else 2 * h * d
            assert g[4:7] == (r, 2 * d, r * s)
        else:
            assert g[4:7] == (2 * hq * d, 2 * d, 2 * hq * d * s)
        _assert_addresses(t, g)


def test_gradient_buffers_as_the_wrappers_allocate():
    """dQ [B, Sq, Hq, D] and dK / dV [B, Skv, Hkv, D]: the (batch, head,
    sequence) strides the wrappers pass with the [B, H, S, D] view address
    each element of the contiguous buffer."""
    like = torch.zeros(1, dtype=torch.bfloat16)
    for bsz, s, h, d in ((1, 5132, 32, 128), (2, 37, 2, 128)):
        g = kernels._bshd(bsz, s, h, d, like)
        assert tuple(g.shape) == (bsz, h, s, d)
        assert kernels._strides3(g) == (s * h * d, d, h * d)
        assert g.permute(0, 2, 1, 3).is_contiguous()


def test_backward_refuses_what_tma_cannot_read():
    """A row stride that is no multiple of 16 bytes, a base off a 16-byte
    boundary and a strided last dim are refused before any launch; a dO
    that TMA cannot read (a zero stride from an expanded gradient, an odd
    stride) is copied once instead."""
    b, s, h, d = 1, 16, 2, 128
    good = torch.zeros(b, h, s, d, dtype=torch.bfloat16)
    odd = torch.zeros(b, s, h * d + 4, dtype=torch.bfloat16)
    q = odd[..., :h * d].reshape(b, s, h, d).transpose(1, 2)
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.flash_bwd_sm90_geometry(q, good, good, good)
    buf = torch.zeros(b, s, 3 * h * d + 8, dtype=torch.bfloat16)
    shifted = buf[..., 4:4 + h * d].reshape(b, s, h, d).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.flash_bwd_sm90_geometry(good, shifted, good, good)
    strided = torch.zeros(b, h, s, 2 * d, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dim"):
        kernels.flash_bwd_sm90_geometry(good, good, strided, good)
    for dout in (torch.ones(1, 1, 1, d, dtype=torch.bfloat16).expand(
            b, h, s, d), q):
        copied = kernels._addressable(dout)
        assert copied.is_contiguous() and torch.equal(copied, dout)
        kernels.flash_bwd_sm90_geometry(good, good, good, copied)


def test_source_hash_covers_shared_headers(tmp_path, monkeypatch):
    """An edit of a csrc/*.cuh header changes the build hash (so the
    library rebuilds), while only *.cu files are compiled."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    assert [p.name for p in kernels._sources()] == ["a.cu"]
    before = kernels.source_hash()
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert kernels.source_hash() != before


def test_plain_backward_matches_pallas_at_the_llm_head_dim():
    """`flash_backward_plain` (and the forward's lse) against the Pallas
    backward in interpret mode at head dim 128, GQA 4, ragged lengths
    over several 128-row tiles, causal with Sq < Skv (diagonal at the
    sequence ends). fp32 on both sides; 2e-5 on outputs and lse, 1e-4 on
    gradients (sums over up to 330 keys in another order)."""
    b, hq, hkv, sq, skv, d = 1, 4, 1, 200, 330, 128
    r = np.random.default_rng(3)
    q = r.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = r.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = r.standard_normal((b, hkv, skv, d)).astype(np.float32)
    do = r.standard_normal((b, hq, sq, d)).astype(np.float32)
    scale = d ** -0.5
    jout, jlse = jatt._fa_core(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), None, causal=True,
                               scale=scale, block_q=128, block_k=128,
                               interpret=True, save_lse=True)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, lse = tatt.flash_forward_plain(t[0], t[1], t[2], None, causal=True,
                                        scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5,
                               rtol=0)
    want = jatt._fa_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None, jout, jlse, jnp.asarray(do), causal=True,
                             scale=scale, block_q=128, block_k=128,
                             interpret=True)
    got = tatt.flash_backward_plain(
        t[0], t[1], t[2], None, torch.from_numpy(np.array(jout)),
        torch.from_numpy(np.array(jlse)), t[3], causal=True, scale=scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
