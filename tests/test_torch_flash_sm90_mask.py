"""K2 on the card with the Mistral / MPT masks: csrc/attention_sm90.cu at
head dim 128 with a sliding window (keys j > i + Skv - Sq - window only)
and with a bias per head and key (MPT's ALiBi as slope_h * j, the pad
mask folded in), against the plain twins in fp32 on the same bf16 inputs.

- The window at 1, 7, 64, 100, 4096 and past Skv; Sq < Skv (the diagonal
  at the sequence ends); GQA (4 q heads a kv head) and MHA; causal and
  not; with and without the left-pad bias. Output within BOUND of
  `flash_forward_plain(window=)` and of `attention_reference`, the
  logsumexp within LSE_BOUND; query rows that see no real key (all pad)
  are left out, as in tests/test_torch_kernels_cuda.py.
- ALiBi through `ops.attention.attention(alibi=True)` against
  `attention_reference(alibi=True)` (slope_h * (j - i)) at 8, 12 (the
  slopes' non-power-of-two branch) and 32 heads, with and without pad;
  and a random per-head bias through `kernels.attention` against
  `flash_forward_plain` (output and logsumexp).
- Each call takes vls_flash_fwd_sm90 (ATTENTION_LAUNCHES) and counts one
  K2; a window or a per-head bias at head dims 64 / 256 raises, and
  under autograd `attention` raises NotImplementedError.

BOUND 1e-2 relative to the largest output (chip_smoke.py's BOUNDS["K2"]:
bf16 P and output against fp32); LSE_BOUND 1e-5 absolute (both sum exp()
in fp32 over the same scores), ALiBi's natural-unit scores up to ~4e3
keep fp32 steps of ~2.4e-4, inside BOUND but not LSE_BOUND, so the ALiBi
logsumexp is held to 1e-3. No JAX here: run on the card with

    python -m pytest --noconftest tests/test_torch_flash_sm90_mask.py -q
"""

import math

import pytest
import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.ops.attention import (
    _pad_bias,
    alibi_key_bias,
    alibi_slopes,
    attention,
    attention_reference,
    flash_forward_plain,
)

pytestmark = pytest.mark.requires_cuda
BOUND = 1e-2
LSE_BOUND = 1e-5
ALIBI_LSE_BOUND = 1e-3
SM90 = "vls_flash_fwd_sm90"


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


def _inputs(seed, b, hq, hkv, sq, skv, pad, dev):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(b, hq, sq, 128), rnd(b, hkv, skv, 128), rnd(b, hkv, skv, 128)
    mask = None
    if pad:
        mask = torch.ones(b, skv, dtype=torch.bool, device=dev)
        mask[-1, :pad] = False
    return q, k, v, mask


def _real_rows(sq, skv, pad):
    """Query rows that see at least one real key under the causal mask:
    row i sees key i + Skv - Sq, real from `pad` on."""
    return slice(max(0, pad - (skv - sq)), None)


# (batch, q heads, kv heads, Sq, Skv, window, pad, causal)
WINDOW_CASES = [
    (1, 8, 2, 300, 300, 1, 0, True),
    (1, 8, 2, 300, 300, 7, 0, True),
    (2, 8, 2, 520, 520, 64, 17, True),
    (1, 8, 8, 700, 700, 100, 0, True),
    (2, 8, 8, 1100, 1100, 100, 37, True),
    (1, 8, 2, 5196, 5196, 4096, 0, True),
    (2, 4, 1, 4500, 4500, 4096, 300, True),
    (1, 8, 2, 800, 800, 5000, 0, True),
    (1, 8, 2, 200, 900, 100, 0, True),
    (2, 8, 2, 130, 1500, 300, 20, True),
    (1, 4, 2, 256, 384, 50, 0, False),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,window,pad,causal", WINDOW_CASES)
def test_flash_sm90_window(dev, b, hq, hkv, sq, skv, window, pad, causal):
    q, k, v, mask = _inputs(window + sq, b, hq, hkv, sq, skv, pad, dev)
    bias = _pad_bias(mask)
    scale = 1.0 / math.sqrt(128)
    before = kernels.ATTENTION_LAUNCHES.snapshot()[SM90]
    got, lse = kernels.attention(q, k, v, scale=scale, causal=causal,
                                 kv_bias=bias, window=window, with_lse=True)
    want, wlse = flash_forward_plain(q.float(), k.float(), v.float(), bias,
                                     causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernels.ATTENTION_LAUNCHES.snapshot()[SM90] == before + 1
    rows = _real_rows(sq, skv, pad) if causal else slice(None)
    assert torch.isfinite(got.float()).all()
    assert _rel(got[:, :, rows], want[:, :, rows]) <= BOUND
    assert (lse[:, :, rows] - wlse[:, :, rows]).abs().max().item() \
        <= LSE_BOUND * max(1.0, wlse[:, :, rows].abs().max().item())
    ref = attention_reference(q.float(), k.float(), v.float(), causal=causal,
                              window=window, kv_mask=mask)
    assert _rel(got[:, :, rows], ref[:, :, rows]) <= BOUND
    # the op: K2 counted once, the same kernel (no twin on the card)
    k2 = kernels.LAUNCHES.snapshot()["K2"]
    out = attention(q, k, v, causal=causal, kv_mask=mask, window=window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES.snapshot()["K2"] == k2 + 1
    assert torch.equal(out, got)


# (batch, heads, Sq, Skv, pad)
ALIBI_CASES = [
    (1, 8, 1100, 1100, 0),
    (2, 8, 700, 700, 17),
    (1, 32, 2048, 2048, 0),
    (2, 12, 600, 600, 30),
    (1, 8, 200, 900, 0),
    (1, 32, 5196, 5196, 0),
]


@pytest.mark.parametrize("b,h,sq,skv,pad", ALIBI_CASES)
def test_flash_sm90_alibi(dev, b, h, sq, skv, pad):
    q, k, v, mask = _inputs(h + sq, b, h, h, sq, skv, pad, dev)
    before = kernels.ATTENTION_LAUNCHES.snapshot()[SM90]
    k2 = kernels.LAUNCHES.snapshot()["K2"]
    got = attention(q, k, v, causal=True, kv_mask=mask, alibi=True)
    want = attention_reference(q.float(), k.float(), v.float(), causal=True,
                               kv_mask=mask, alibi=True)
    torch.cuda.synchronize()
    assert kernels.ATTENTION_LAUNCHES.snapshot()[SM90] == before + 1
    assert kernels.LAUNCHES.snapshot()["K2"] == k2 + 1
    rows = _real_rows(sq, skv, pad)
    assert torch.isfinite(got.float()).all()
    assert _rel(got[:, :, rows], want[:, :, rows]) <= BOUND
    # the kernel's own form: the key bias, with its logsumexp
    slopes = torch.from_numpy(alibi_slopes(h)).to(dev)
    bias = alibi_key_bias(slopes, skv, mask, batch=b)
    out, lse = kernels.attention(q, k, v, scale=1.0 / math.sqrt(128),
                                 causal=True, kv_bias=bias, with_lse=True)
    wout, wlse = flash_forward_plain(q.float(), k.float(), v.float(), bias,
                                     causal=True)
    assert torch.equal(out, got)
    assert _rel(out[:, :, rows], wout[:, :, rows]) <= BOUND
    assert (lse[:, :, rows] - wlse[:, :, rows]).abs().max().item() \
        <= ALIBI_LSE_BOUND


@pytest.mark.parametrize("window", [0, 33])
def test_flash_sm90_random_head_bias(dev, window):
    """A bias that varies by head and key (any values), with a window."""
    b, h, s = 2, 4, 700
    q, k, v, _ = _inputs(5, b, h, h, s, s, 0, dev)
    g = torch.Generator(device=dev).manual_seed(6)
    bias = torch.randn(b, h, s, generator=g, device=dev) * 3
    out, lse = kernels.attention(q, k, v, scale=1.0 / math.sqrt(128),
                                 causal=True, kv_bias=bias, with_lse=True,
                                 window=window)
    wout, wlse = flash_forward_plain(q.float(), k.float(), v.float(), bias,
                                     causal=True, window=window or None)
    torch.cuda.synchronize()
    assert _rel(out, wout) <= BOUND
    assert (lse - wlse).abs().max().item() <= LSE_BOUND * max(
        1.0, wlse.abs().max().item())


def test_window_and_alibi_refusals_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    for d in (64, 256):
        q = torch.randn(1, 4, 300, d, generator=g, device=dev).to(
            torch.bfloat16)
        for kw in (dict(window=8), dict(alibi=True)):
            with pytest.raises(ValueError, match="head dim 128"):
                attention(q, q, q, causal=True, **kw)
    q = torch.randn(1, 4, 300, 128, generator=g, device=dev).to(
        torch.bfloat16).requires_grad_()
    for kw in (dict(window=8), dict(alibi=True)):
        with pytest.raises(NotImplementedError, match="Mistral / MPT"):
            attention(q, q, q, causal=True, **kw)
