"""The CPU side of csrc/attention_sm90.cu (K2 at head dim 128 on TMA and
wgmma): the route `kernels.attention` takes by head dim and form, the
tensor-map geometry it hands the C entry for the views the LLM paths
build, and what the plain versions give a query row whose visible keys
are all masked by the per-key bias. The kernel itself runs only on the
card (tests/test_torch_kernels_cuda.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.ops.attention import (
    MASK_VALUE,
    attention_reference,
    flash_forward_plain,
)
from video_llava_seg_tpu.ops.attention import (
    attention_reference as jax_attention_reference,
)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("d", kernels.ATTENTION_HEAD_DIMS)
def test_attention_entry_route(d, two_pass):
    """The online form goes to attention_sm90.cu at head dim 128, and at
    head dims 64 / 80 / 96 over at least FLASH_SM90_MIN_KEYS keys (K1,
    K4, K8, the per-op Hiera blocks); the two-pass form (K3) at head dim
    16 over at most 64 keys (the mask decoder's 7) goes to
    attention_short_sm90.cu; every other call (head dims 16 / 32, fewer
    keys, K3 at other head dims or lengths) stays on attention.cu. Skv /
    Hkv: the mask decoder's, the towers', the LLM's prefill."""
    for skv, hkv in ((7, 8), (64, 8), (65, 8), (577, 16), (5196, 8)):
        if not two_pass and (d == 128 or (
                d in (64, 80, 96) and skv >= kernels.FLASH_SM90_MIN_KEYS)):
            want = "vls_flash_fwd_sm90"
        elif d == 16 and two_pass and skv <= 64:
            want = "vls_attention_short_sm90"
        else:
            want = "vls_attention_bf16"
        assert kernels.attention_entry(d, two_pass, skv, hkv) == want
        assert want in kernels._SIGNATURES


def _llm_views(b, s, hq, hkv, d, fused):
    """q, k, v as models/llama.py::_attn_block builds them: [B, S, H*D]
    denses (or column slices of one fused-qkv dense) reshaped to
    [B, S, H, D] and transposed to [B, H, S, D]."""
    if fused:
        qkv = torch.arange(b * s * (hq + 2 * hkv) * d,
                           dtype=torch.float32).reshape(
            b, s, (hq + 2 * hkv) * d).to(torch.bfloat16)
        q = qkv[..., :hq * d]
        k = qkv[..., hq * d:(hq + hkv) * d]
        v = qkv[..., (hq + hkv) * d:]
    else:
        q = torch.zeros(b, s, hq * d, dtype=torch.bfloat16)
        k = torch.zeros(b, s, hkv * d, dtype=torch.bfloat16)
        v = torch.zeros(b, s, hkv * d, dtype=torch.bfloat16)
    return (q.reshape(b, s, hq, d).transpose(1, 2),
            k.reshape(b, s, hkv, d).transpose(1, 2),
            v.reshape(b, s, hkv, d).transpose(1, 2))


@pytest.mark.parametrize("fused", [False, True])
def test_tensor_map_geometry_of_llm_views(fused):
    """dims (D, S, H, B) innermost first, the byte strides of S, H and B,
    and the kernel's box; a TMA coordinate (c, s, h, b) addresses
    t[b, h, s, c] through them."""
    b, s, hq, hkv, d = 2, 37, 4, 2, 128
    width = (hq + 2 * hkv) * d if fused else None
    for t, h in zip(_llm_views(b, s, hq, hkv, d, fused), (hq, hkv, hkv)):
        g = kernels.flash_sm90_tensor_map(t, "t")
        assert g[:4] == (d, s, h, b)
        row = 2 * (width if fused else h * d)
        assert g[4:7] == (row, 2 * d, row * s)
        assert g[7:] == kernels.FLASH_SM90_BOX
        # the strides address the view's elements from its base
        flat = t.untyped_storage()
        base = t.storage_offset() * 2
        rng = np.random.default_rng(0)
        for _ in range(20):
            c, si, hi, bi = (int(rng.integers(n)) for n in g[:4])
            byte = base + 2 * c + si * g[4] + hi * g[5] + bi * g[6]
            got = torch.tensor([], dtype=torch.bfloat16).set_(
                flat, byte // 2, (1,))
            assert got.item() == t[bi, hi, si, c].item()


def test_tensor_map_geometry_rejects_what_tma_cannot_read():
    """A row stride that is no multiple of 16 bytes, a base off a 16-byte
    boundary and a strided last dim are refused before any launch."""
    b, s, h, d = 1, 16, 2, 128
    odd = torch.zeros(b, s, h * d + 4, dtype=torch.bfloat16)
    q = odd[..., :h * d].reshape(b, s, h, d).transpose(1, 2)
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.flash_sm90_tensor_map(q, "q")
    buf = torch.zeros(b, s, 3 * h * d + 8, dtype=torch.bfloat16)
    shifted = buf[..., 4:4 + h * d].reshape(b, s, h, d).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.flash_sm90_tensor_map(shifted, "q")
    strided = torch.zeros(b, h, s, 2 * d, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dim"):
        kernels.flash_sm90_tensor_map(strided, "q")


def test_fully_masked_row_of_the_plain_versions():
    """A left-pad query row of a causal batch-2 prefill sees only keys
    the per-key bias masks: every score is the mask value (the dot product
    vanishes against 2.4e38) and stays finite. What each version gives it:
    - attention_reference, the CPU path of `attention`, and the JAX
      package's reference: softmax of equal scores, the mean of ALL V
      rows (the causal mask also writes the mask value);
    - flash_forward_plain: lse = the mask value (log(Skv) vanishes), so
      exp(s - lse) = 1 and O is the plain sum of all V rows;
    - the kernels (attention.cu, attention_sm90.cu): the mean of the V
      rows the causal diagonal lets the row see, with lse the mask value;
      the CUDA tests hold pad rows to that.
    Real rows agree across all of them."""
    rng = np.random.default_rng(1)
    b, h, s, d, pad = 2, 2, 24, 16, 7
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    kv_mask = np.ones((b, s), bool)
    kv_mask[1, :pad] = False
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tmask = torch.from_numpy(kv_mask)
    bias = torch.where(tmask, 0.0, MASK_VALUE).float()
    ref = attention_reference(tq, tk, tv, causal=True, kv_mask=tmask)
    jref = np.asarray(jax_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        kv_mask=jnp.asarray(kv_mask)))
    o, lse = flash_forward_plain(tq, tk, tv, bias, causal=True)
    np.testing.assert_allclose(ref.numpy(), jref, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    pads = slice(0, pad)
    torch.testing.assert_close(
        ref[1, :, pads], tv[1].mean(1, keepdim=True).expand(h, pad, d))
    torch.testing.assert_close(
        o[1, :, pads], tv[1].sum(1, keepdim=True).expand(h, pad, d))
    assert torch.equal(lse[1, :, pads],
                       torch.full((h, pad), MASK_VALUE, dtype=torch.float32))
    # the kernels' value: the mean of keys 0..i, distinct from both
    visible = tv[1].cumsum(1)[:, pads] / torch.arange(
        1, pad + 1, dtype=torch.float32)[None, :, None]
    assert (visible - ref[1, :, pads]).abs().max() > 0.1
    # real rows: the flash form equals the reference
    real = slice(pad, None)
    torch.testing.assert_close(o[1, :, real], ref[1, :, real], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(o[0], ref[0], rtol=1e-5, atol=1e-5)
    want_lse = torch.logsumexp(
        torch.einsum("hqd,hkd->hqk", tq[0], tk[0]) / math.sqrt(d)
        + torch.triu(torch.full((s, s), -math.inf), 1), -1)
    torch.testing.assert_close(lse[0], want_lse, rtol=1e-5, atol=1e-5)
