"""Training the Mistral and MPT families on the CPU, against the JAX
package: the flash backward's plain versions and its autograd Function
with Mistral's sliding window and MPT's ALiBi, and the tiny stage-3 QLoRA
step of each family.

- `flash_forward_plain` + `flash_backward_plain` with `window=` and with
  ALiBi as the per-head key bias `alibi_key_bias` (slope_h * j: the form
  K2 / K6a / K6b read on the card, whose logsumexp differs from the
  reference's by slope_h * i) against `jax.grad` of the JAX package's
  `attention_reference(window= | alibi=True)`: GQA 4 / 2, causal, the
  window shorter than the sequence, one masked key, Sq = Skv and Sq <
  Skv. fp32 on both sides, within GRAD_ATOL.
- `ops.attention._FlashAttention` with `kernels.attention` /
  `kernels.attention_bwd` replaced by those plain versions (what the
  wrappers launch on the card): the same gradients, the window and the
  bias handed from the forward to the backward.
- The route and the geometry of the backward's operands with a 3-D bias:
  `attention_bwd_entry` sends both forms to attention_bwd_sm90.cu at head
  dim 128 and refuses them elsewhere; the bias's (batch, head) strides the
  C entries take; the tensor maps as `_FlashAttention.backward` hands them
  over; a model of the two kernels' tile walks under the window.
- `make_train_step` of the port against the JAX package's for the tiny
  stage-3 QLoRA config with its LLM switched to Mistral (window 4, shorter
  than the spliced sequence) and to MPT (ALiBi, LayerNorm, erf-GELU MLP,
  tied head): two steps (the schedule gives update 0 a zero learning
  rate, so the second moves the weights), at
  tests/test_torch_train_step.py's tolerances (loss / grad_norm rel 2e-5,
  the parameter rule, the int8 base bit-identical).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_bwd_sm90 import _assert_addresses, _Capture, _llm_qkv
from test_torch_train_step import (
    CFG,
    LRS,
    check_metrics,
    check_params,
    make_batch,
)

from video_llava_seg_torch import bridge, kernels
from video_llava_seg_torch.config import OptimGroupLRs as TLRs
from video_llava_seg_torch.config import TrainConfig as TTrainConfig
from video_llava_seg_torch.models import llava as tllava
from video_llava_seg_torch.ops import attention as tatt
from video_llava_seg_torch.train import train_step as tts
from video_llava_seg_torch.train.optimizer import leaves_with_paths
from video_llava_seg_torch.train.trainer import step_generator
from video_llava_seg_tpu import config as jconfig
from video_llava_seg_tpu.ops import attention as jatt
from video_llava_seg_tpu.ops.quantization import quantize_tree
from video_llava_seg_tpu.train import lora as jlora
from video_llava_seg_tpu.train.train_step import (
    create_train_state,
    make_train_step,
)

# gradients of magnitude ~1-10 in fp32 on both sides, sums in another
# order (the key form's lse is ~slope * 40 larger than the reference's)
GRAD_ATOL = 2e-5
SM90_PAIR = ("vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90")

# the family switches of LlamaConfig.mistral_7b() / mpt_7b() on the tiny
# LLM (Mistral's window cut to 4 slots, shorter than the spliced sequence)
FAMILIES = {
    "mistral": dict(sliding_window=4, rope_theta=10000.0),
    "mpt": dict(use_rope=False, use_alibi=True, norm_type="layernorm",
                mlp_type="gelu", tie_word_embeddings=True, num_kv_heads=4),
}
WINDOW = 5


def _qkv(seed, b, hq, hkv, sq, skv, d=16):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(s).astype(np.float32) for s in (
        (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d)))


def _mask(b, skv):
    """One masked key (row 1, key 5): every query row still sees a key."""
    m = np.ones((b, skv), bool)
    m[1, 5] = False
    return m


def _jax_grads(q, k, v, do, m, **kw):
    def f(q_, k_, v_):
        o = jatt.attention_reference(q_, k_, v_, causal=True,
                                     kv_mask=jnp.asarray(m), **kw)
        return jnp.sum(o * jnp.asarray(do))

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _kernel_bias(form, m, hq, skv):
    """The bias K2 / K6a / K6b read: the pad bias, or ALiBi's key form."""
    tm = torch.from_numpy(m)
    if form == "alibi":
        slopes = torch.from_numpy(tatt.alibi_slopes(hq))
        return tatt.alibi_key_bias(slopes, skv, tm, batch=m.shape[0])
    return tatt._pad_bias(tm)


FORMS = [("window", 40, 40), ("window", 24, 40), ("alibi", 40, 40),
         ("alibi", 24, 40)]


@pytest.mark.parametrize("form,sq,skv", FORMS)
def test_plain_backward_matches_jax_grad(form, sq, skv):
    b, hq, hkv = 2, 4, 2
    q, k, v, do = _qkv(sq + skv, b, hq, hkv, sq, skv)
    m = _mask(b, skv)
    kw = dict(window=WINDOW) if form == "window" else dict(alibi=True)
    want = _jax_grads(q, k, v, do, m, **kw)
    bias = _kernel_bias(form, m, hq, skv)
    window = kw.get("window")
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, lse = tatt.flash_forward_plain(t[0], t[1], t[2], bias, causal=True,
                                        window=window)
    got = tatt.flash_backward_plain(t[0], t[1], t[2], bias, out, lse, t[3],
                                    causal=True, window=window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")
    # the window (or ALiBi) changes the gradients: the plain backward
    # without it is far from them
    wrong = tatt.flash_backward_plain(
        t[0], t[1], t[2], _kernel_bias("window", m, hq, skv), out, lse,
        t[3], causal=True)
    assert max(float(np.abs(g.numpy() - w).max())
               for g, w in zip(wrong, want)) > 100 * GRAD_ATOL


@pytest.mark.parametrize("form,sq,skv", FORMS)
def test_flash_function_over_the_plain_versions(form, sq, skv, monkeypatch):
    """`_FlashAttention` as the card runs it, its kernels replaced by their
    plain versions: the forward's window and bias reach the backward, and
    the key form's lse gives the reference's gradients."""
    calls = []

    def fake_attention(q, k, v, *, scale, causal, kv_bias, two_pass,
                       with_lse, window):
        calls.append(("fwd", window, kv_bias))
        assert with_lse and not two_pass
        return tatt.flash_forward_plain(q, k, v, kv_bias, causal=causal,
                                        scale=scale, window=window or None)

    def fake_bwd(q, k, v, out, dout, lse, *, scale, causal, kv_bias, window):
        calls.append(("bwd", window, kv_bias))
        return tatt.flash_backward_plain(q, k, v, kv_bias, out, lse, dout,
                                         causal=causal, scale=scale,
                                         window=window or None)

    monkeypatch.setattr(kernels, "attention", fake_attention)
    monkeypatch.setattr(kernels, "attention_bwd", fake_bwd)
    b, hq, hkv = 2, 4, 2
    q, k, v, do = _qkv(sq + skv + 1, b, hq, hkv, sq, skv)
    m = _mask(b, skv)
    kw = dict(window=WINDOW) if form == "window" else dict(alibi=True)
    want = _jax_grads(q, k, v, do, m, **kw)
    bias = _kernel_bias(form, m, hq, skv)
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = kernels.LAUNCHES.snapshot()
    out = tatt._FlashAttention.apply(*ins, bias, True, 16 ** -0.5, False,
                                     kw.get("window", 0))
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    after = kernels.LAUNCHES.snapshot()
    assert [c[:2] for c in calls] == [("fwd", kw.get("window", 0)),
                                      ("bwd", kw.get("window", 0))]
    assert calls[0][2] is bias and calls[1][2] is bias
    assert {n: after[n] - before[n] for n in ("K2", "K6a", "K6b")} == \
        {"K2": 1, "K6a": 1, "K6b": 1}
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")


# --------------------------------------------------------------------------
# the route and the operands on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", kernels.ATTENTION_HEAD_DIMS
                         + (kernels.FLASH_SM90_WIDE_HEAD_DIM,))
def test_family_backward_route(d):
    """Mistral's window and MPT's per-head bias at the train step's 5,132
    keys take attention_bwd_sm90.cu's pair at head dim 128 (GQA 8 and MHA
    32 kv heads) and raise at every other head dim."""
    for kw in (dict(window=4096), dict(head_bias=True),
               dict(window=4096, head_bias=True)):
        for hkv in (8, 32):
            if d == 128:
                assert kernels.attention_bwd_entry(d, 5132, hkv, **kw) \
                    == SM90_PAIR
            else:
                with pytest.raises(ValueError, match="head dim 128"):
                    kernels.attention_bwd_entry(d, 5132, hkv, **kw)


def _require_on_cpu(t, what, dtype=torch.bfloat16, contiguous=True):
    """`kernels._require` without its device check, for CPU stand-ins."""
    if t.dtype != dtype or (contiguous and not t.is_contiguous()):
        raise ValueError(f"{what}: not a contiguous {dtype}")


def test_bias_strides_and_refusals_of_the_backward(monkeypatch):
    """The (batch, head) element strides the C entries take: (Skv, 0) for
    the per-key bias, (Hq * Skv, Skv) for ALiBi's [B, Hq, Skv]; a per-head
    bias of the wrong shape, a window or a per-head bias on
    attention_bwd.cu's pair, and a negative window are refused before
    any launch; the entries' argument lists carry both. CPU stand-ins
    for the card's tensors."""
    monkeypatch.setattr(kernels, "_require", _require_on_cpu)
    b, hq, hkv, s, d = 2, 4, 2, 37, 128
    assert kernels._bias_strides(torch.zeros(b, s), b, hq, s) == (s, 0)
    assert kernels._bias_strides(torch.zeros(b, hq, s), b, hq, s) \
        == (hq * s, s)
    with pytest.raises(ValueError, match=r"\[B, Hq, Skv\]"):
        kernels._bias_strides(torch.zeros(b, hkv, s), b, hq, s)
    q = torch.zeros(b, hq, s, d, dtype=torch.bfloat16)
    k = torch.zeros(b, hkv, s, d, dtype=torch.bfloat16)
    lse = torch.zeros(b, hq, s)
    for entry in ("vls_attention_bwd_dq", "vls_attention_bwd_dkv"):
        for kw in (dict(window=8, kv_bias=None),
                   dict(window=0, kv_bias=torch.zeros(b, hq, s))):
            with pytest.raises(ValueError, match="neither"):
                kernels._bwd_common(entry, q, k, k, q, lse, kw["kv_bias"],
                                    kw["window"])
    for entry in SM90_PAIR:
        with pytest.raises(ValueError, match="window must be"):
            kernels._bwd_common(entry, q, k, k, q, lse, None, -1)
        shape, _, _, _, bias_s = kernels._bwd_common(
            entry, q, k, k, q, lse, torch.zeros(b, hq, s), 4096)
        assert shape == (b, hq, hkv, s, s, d) and bias_s == (hq * s, s)
        # pointers, (o / dq / dk, dv) strides, bias strides, scale,
        # causal, window, stream
        sig = kernels._SIGNATURES[entry]
        assert sig[-5:] == [kernels._L, kernels._F, kernels._I, kernels._I,
                            kernels._P]
        assert sig.count(kernels._L) == 8
    with pytest.raises(ValueError, match="window must be"):
        kernels.attention_bwd(q, k, k, q, q, lse, scale=1.0, causal=True,
                              window=-1)


@pytest.mark.parametrize("fused", [False, True])
def test_tensor_maps_with_a_head_bias(fused, monkeypatch):
    """The four maps (q, k, v, dO) of the backward for ALiBi's GQA-1 and
    Mistral's GQA-4 operands as the LLM block builds them, with the bias
    the forward saved ([B, Hq, Skv], contiguous): dO read in place through
    the head merge, every map addressing its tensor, and the bias row of
    (batch b, q head h) at b * Hq * Skv + h * Skv."""
    b, s, d = 2, 37, 128
    for hq, hkv in ((4, 4), (8, 2)):
        q, k, v = _llm_qkv(b, s, hq, hkv, d, fused)
        _Capture.seen.clear()
        o = _Capture.apply(q.float().requires_grad_(True))
        w = torch.randn(hq * d, 8)
        (o.transpose(1, 2).reshape(b, s, hq * d) @ w).sum().backward()
        dout = _Capture.seen[0].to(torch.bfloat16)
        assert kernels._addressable(dout) is dout
        monkeypatch.setattr(kernels, "_require", _require_on_cpu)
        geom = kernels.flash_bwd_sm90_geometry(q, k, v, dout)
        for i, (t, h) in enumerate(zip((q, k, v, dout),
                                       (hq, hkv, hkv, hq))):
            g = geom[11 * i:11 * (i + 1)]
            assert g[:4] == (d, s, h, b)
            assert g[7:] == kernels.FLASH_SM90_BWD_BOX
            _assert_addresses(t, g)
        slopes = torch.from_numpy(tatt.alibi_slopes(hq))
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[1, :3] = False
        bias = tatt.alibi_key_bias(slopes, s, mask, batch=b)
        sb, sh = kernels._bias_strides(bias, b, hq, s)
        assert (sb, sh) == (hq * s, s) and bias.is_contiguous()
        flat = bias.flatten()
        for bi in range(b):
            for h in range(hq):
                row = flat[bi * sb + h * sh:bi * sb + h * sh + s]
                assert torch.equal(row, bias[bi, h])


BN, BM = 64, 128


def _k6a_tiles(q0, sq, skv, causal, window):
    """Key tiles K6a's block of query rows [q0, q0 + 128) walks
    (flash_bwd_dq_sm90: t0 from the window, the end from the causal
    diagonal), and for each whether a warpgroup masks it (`edge`) or
    skips it."""
    off = skv - sq
    kv_end = min(skv, q0 + BM + off) if causal else skv
    t0 = max(0, q0 + off - window + 1) // BN if window else 0
    n = max(0, -(-kv_end // BN) - t0) if kv_end > 0 else 0
    out = {}
    for cw in range(2):
        qw0 = q0 + 64 * cw
        for t in range(t0, t0 + n):
            j0 = t * BN
            seen = (qw0 < sq and (not causal or j0 <= qw0 + 63 + off)
                    and (not window or j0 + BN - 1 > qw0 + off - window))
            edge = (j0 + BN > skv or (causal and j0 + BN - 1 > qw0 + off)
                    or (window and j0 <= qw0 + 63 + off - window))
            out[(cw, t)] = (seen, edge)
    return out


def _k6b_tiles(k0, sq, skv, causal, window):
    """Query tiles K6b's block of keys [k0, k0 + 64) walks
    (flash_bwd_dkv_sm90: t_first from the causal diagonal, t_end from the
    window), and for each whether it is masked."""
    off = skv - sq
    t_first = 0
    if causal:
        lo = k0 - off - (BN - 1)
        t_first = -(-lo // BN) if lo > 0 else 0
    t_end = -(-sq // BN)
    if window:
        hi = k0 + BN - 1 + window - off
        t_end = min(t_end, -(-hi // BN) if hi > 0 else 0)
    out = {}
    for t in range(t_first, t_end):
        q0 = t * BN
        out[t] = ((causal and k0 + 63 > q0 + off)
                  or (window and k0 <= q0 + 63 + off - window))
    return out


@pytest.mark.parametrize("sq,skv,causal,window", [
    (5132, 5132, True, 4096), (300, 300, True, 1), (300, 300, True, 7),
    (700, 700, True, 100), (800, 800, True, 5000), (200, 900, True, 100),
    (130, 1500, True, 300), (256, 384, False, 50), (520, 520, True, 64)])
def test_window_walks_cover_the_band(sq, skv, causal, window):
    """The two kernels' walks, modelled from attention_bwd_sm90.cu, against
    the visible pairs: every visible (query, key) pair lies in a tile that
    K6a walks and does not skip and in one that K6b walks; a tile either
    kernel leaves unmasked holds only visible pairs (keys past Skv and
    rows past Sq aside); at Mistral's 4096 over 5,132 tokens K6a walks
    fewer tiles than under the causal mask alone."""
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    rel = j - i - (skv - sq)
    vis = np.ones((sq, skv), bool)
    if causal:
        vis &= rel <= 0
    vis &= rel > -window
    walked = 0
    for q0 in range(0, sq, BM):
        tiles = _k6a_tiles(q0, sq, skv, causal, window)
        walked += len(tiles) // 2
        for cw in range(2):
            rows = slice(q0 + 64 * cw, min(q0 + 64 * cw + 64, sq))
            for t in range(-(-skv // BN)):
                block = vis[rows, t * BN:(t + 1) * BN]
                seen, edge = tiles.get((cw, t), (False, True))
                if block.any():
                    assert seen, (q0, cw, t)
                if seen and not edge:
                    assert block.all(), (q0, cw, t)
    for k0 in range(0, skv, BN):
        tiles = _k6b_tiles(k0, sq, skv, causal, window)
        for t in range(-(-sq // BN)):
            block = vis[t * BN:(t + 1) * BN, k0:k0 + BN]
            if block.any():
                assert t in tiles, (k0, t)
            if t in tiles and not tiles[t] and k0 + BN <= skv:
                assert block[:sq - t * BN].all(), (k0, t)
    if (sq, window) == (5132, 4096):
        causal_only = sum(len(_k6a_tiles(q0, sq, skv, True, 0)) // 2
                          for q0 in range(0, sq, BM))
        assert walked < causal_only


# --------------------------------------------------------------------------
# the tiny stage-3 QLoRA step of each family
# --------------------------------------------------------------------------

def _family_cfgs(fam):
    """(port config, JAX config): the tiny stage-3 config of
    test_torch_train_step.py with its LLM switched to the family."""
    jc = dataclasses.replace(
        jconfig.VideoLlavaConfig.tiny(), seg_token_idx=CFG.seg_token_idx,
        seg=jconfig.SegHeadConfig(**dataclasses.asdict(CFG.seg)))
    jc = dataclasses.replace(jc, llm=dataclasses.replace(jc.llm,
                                                         **FAMILIES[fam]))
    tc = dataclasses.replace(CFG, llm=dataclasses.replace(CFG.llm,
                                                          **FAMILIES[fam]))
    return tc, jc


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_family_qlora_train_step_matches_jax(fam):
    tc, jc = _family_cfgs(fam)
    params = bridge.to_numpy(tllava.init(tc, torch.Generator().manual_seed(
        5), "cpu", torch.float32))
    params["llm"] = quantize_tree(params["llm"], bits=8, min_size=0,
                                  train_mode=True)
    params["lora"] = jlora.init_lora(jax.random.PRNGKey(1), params, rank=4)
    batch = make_batch()
    seq = batch["gather_idx"].shape[1]
    if fam == "mistral":
        assert tc.llm.sliding_window < seq
    kw = dict(num_train_steps=10, warmup_ratio=0.1,
              gradient_accumulation_steps=1, gradient_checkpointing=False,
              bits=8, lora_enable=True, lora_rank=4)
    jt = jconfig.TrainConfig(lrs=jconfig.OptimGroupLRs(**LRS), **kw)
    tt = TTrainConfig(lrs=TLRs(**LRS), **kw)
    jstate, jtx = create_train_state(params, jt)
    jstep = make_train_step(jc, jt, jtx, donate=False)
    tstate, ttx = tts.create_train_state(bridge.from_jax(params), tt)
    tstep = tts.make_train_step(tc, tt, ttx)
    base = dict(leaves_with_paths(bridge.from_jax(params["llm"])))
    b_moved = []
    for i in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, tts.batch_to_device(batch, "cpu",
                                                       torch.float32),
                           step_generator(0, i))
        check_metrics(jm, tm)
        check_params(jstate.params, tstate.params, i)
        for path, t in leaves_with_paths(tstate.params["llm"]):
            assert torch.equal(t, base[path]), path
        b_moved.append(bool(tstate.params["lora"]["llm"]["layers"][0][
            "attn"]["wq"]["kernel_q"]["b"].any()))
    assert b_moved == [False, True]
