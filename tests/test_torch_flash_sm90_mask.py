"""K2 and K6a / K6b on the card with the Mistral / MPT masks:
csrc/attention_sm90.cu and csrc/attention_bwd_sm90.cu at head dim 128
with a sliding window (keys j > i + Skv - Sq - window only) and with a
bias per head and key (MPT's ALiBi as slope_h * j, the pad mask folded
in), against the plain twins in fp32 on the same bf16 inputs.

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
  K2; a window or a per-head bias at head dims 64 / 256 raises, under
  autograd too, and at head dim 128 autograd runs the pair.
- The backward (K6a / K6b) at every window case and every ALiBi case:
  dQ on the rows that see a real key, dK / dV within BWD_BOUND of
  `flash_backward_plain` on the kernel forward's output and logsumexp
  (relative to each gradient's largest element, or to 1 % of the
  largest of the three: at window 1 dQ and dK cancel to rounding noise)
  (dO zero on rows that see no real key, whose p the two define apart:
  ROADMAP queue 3); keys that no row sees get exactly zero dK / dV. The
  ALiBi cases also through `attention(alibi=True)`'s autograd against
  autograd of `attention_reference(alibi=True)` (slope_h * (j - i)).

BOUND 1e-2 relative to the largest output (chip_smoke.py's BOUNDS["K2"]:
bf16 P and output against fp32); LSE_BOUND 1e-5 absolute (both sum exp()
in fp32 over the same scores), ALiBi's natural-unit scores up to ~4e3
keep fp32 steps of ~2.4e-4, inside BOUND but not LSE_BOUND, so the ALiBi
logsumexp is held to 1e-3. BWD_BOUND 2e-2 (chip_smoke.py's BOUNDS["K6a"]
/ ["K6b"]: bf16 dS and P against fp32). No JAX here: run on the card with

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
    flash_backward_plain,
    flash_forward_plain,
)

pytestmark = pytest.mark.requires_cuda
BOUND = 1e-2
LSE_BOUND = 1e-5
ALIBI_LSE_BOUND = 1e-3
BWD_BOUND = 2e-2
BWD = ("vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90")
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
    """A window or ALiBi at head dims 64 / 256 raises, with and without
    autograd; at head dim 128 autograd takes K2 and the sm90 pair."""
    g = torch.Generator(device=dev).manual_seed(7)
    for d in (64, 256):
        q = torch.randn(1, 4, 300, d, generator=g, device=dev).to(
            torch.bfloat16)
        for kw in (dict(window=8), dict(alibi=True)):
            with pytest.raises(ValueError, match="head dim 128"):
                attention(q, q, q, causal=True, **kw)
            with pytest.raises(ValueError, match="head dim 128"):
                attention(q.requires_grad_(), q, q, causal=True, **kw)
            q = q.detach()
    q = torch.randn(1, 4, 300, 128, generator=g, device=dev).to(
        torch.bfloat16).requires_grad_()
    for kw in (dict(window=8), dict(alibi=True)):
        before = kernels.ATTENTION_BWD_LAUNCHES.snapshot()
        (grad,) = torch.autograd.grad(attention(q, q, q, causal=True, **kw),
                                      q, torch.ones_like(q))
        torch.cuda.synchronize()
        after = kernels.ATTENTION_BWD_LAUNCHES.snapshot()
        assert all(after[e] == before[e] + 1 for e in BWD)
        assert torch.isfinite(grad.float()).all()


def _bwd_check(q, k, v, bias, causal, window, real_rows, dev):
    """K2 with its logsumexp, then K6a / K6b, against the plain backward
    on the kernel forward's output and logsumexp: dQ on `real_rows`, dK /
    dV on every key (dO zero elsewhere), keys that no row sees exactly
    zero. Returns the kernel's (dq, dk, dv)."""
    g = torch.Generator(device=dev).manual_seed(q.shape[2] + 3)
    do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    seen = torch.zeros(q.shape[2], dtype=torch.bool, device=dev)
    seen[real_rows] = True
    do = do * seen[:, None]
    kw = dict(scale=1.0 / math.sqrt(128), causal=causal, kv_bias=bias,
              window=window)
    out, lse = kernels.attention(q, k, v, with_lse=True, **kw)
    before = kernels.ATTENTION_BWD_LAUNCHES.snapshot()
    got = kernels.attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    after = kernels.ATTENTION_BWD_LAUNCHES.snapshot()
    assert all(after[e] == before[e] + 1 for e in BWD)
    want = flash_backward_plain(q.float(), k.float(), v.float(), bias,
                                out.float(), lse, do.float(), causal=causal,
                                scale=kw["scale"], window=window or None)
    assert all(torch.isfinite(t.float()).all() for t in got)
    # each gradient against its largest element, or 1 % of the largest of
    # the three where that is larger: at window 1 a row's p is 1 on its own
    # key alone, and dQ / dK are sums that cancel to rounding noise
    rows = (slice(None), slice(None), real_rows)
    pairs = [(got[0][rows], want[0][rows]), (got[1], want[1]),
             (got[2], want[2])]
    top = max(w.abs().max().item() for _, w in pairs)
    for g, w in pairs:
        err = (g.float() - w).abs().max().item()
        assert err <= BWD_BOUND * max(w.abs().max().item(), 1e-2 * top)
    # keys outside every row's band (Sq < Skv, or no causal mask)
    sq, skv = q.shape[2], k.shape[2]
    rel = (torch.arange(skv, device=dev)[None]
           - torch.arange(sq, device=dev)[:, None] - (skv - sq))
    vis = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        vis &= rel <= 0
    if window:
        vis &= rel > -window
    dead = ~vis.any(0)
    for t in got[1:]:
        assert not t[:, :, dead].any()
    return got


@pytest.mark.parametrize("b,hq,hkv,sq,skv,window,pad,causal", WINDOW_CASES)
def test_flash_bwd_sm90_window(dev, b, hq, hkv, sq, skv, window, pad,
                               causal):
    q, k, v, mask = _inputs(window + sq, b, hq, hkv, sq, skv, pad, dev)
    rows = _real_rows(sq, skv, pad) if causal else slice(None)
    _bwd_check(q, k, v, _pad_bias(mask), causal, window, rows, dev)


@pytest.mark.parametrize("b,h,sq,skv,pad", ALIBI_CASES)
def test_flash_bwd_sm90_alibi(dev, b, h, sq, skv, pad):
    q, k, v, mask = _inputs(h + sq + 1, b, h, h, sq, skv, pad, dev)
    slopes = torch.from_numpy(alibi_slopes(h)).to(dev)
    rows = _real_rows(sq, skv, pad)
    dq, dk, dv = _bwd_check(q, k, v, alibi_key_bias(slopes, skv, mask,
                                                    batch=b),
                            True, 0, rows, dev)
    # the op's autograd (key form, bias saved for the backward) against
    # autograd of the reference's slope_h * (j - i) in fp32; dO is zero on
    # rows that see no real key
    g = torch.Generator(device=dev).manual_seed(sq + 3)
    do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    do[:, :, :rows.start] = 0
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(attention(*ins, causal=True, kv_mask=mask,
                                        alibi=True), ins, do)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(
        *ref, causal=True, kv_mask=mask, alibi=True), ref, do.float())
    assert torch.equal(got[0], dq) and torch.equal(got[1], dk)
    assert _rel(got[0][:, :, rows], want[0][:, :, rows]) <= BWD_BOUND
    assert _rel(got[1], want[1]) <= BWD_BOUND
    assert _rel(got[2], want[2]) <= BWD_BOUND


@pytest.mark.parametrize("window", [0, 33])
def test_flash_bwd_sm90_random_head_bias(dev, window):
    """A bias that varies by head and key (any values), with a window,
    GQA 2: the head stride moves the bias with each q head of K6b's
    group walk."""
    b, hq, hkv, s = 2, 4, 2, 700
    q, k, v, _ = _inputs(8, b, hq, hkv, s, s, 0, dev)
    g = torch.Generator(device=dev).manual_seed(9)
    bias = torch.randn(b, hq, s, generator=g, device=dev) * 3
    _bwd_check(q, k, v, bias, True, window, slice(None), dev)
