"""The port's attention (plain twin, what a CPU tensor runs) vs the JAX
package's Pallas flash kernel in interpret mode and its XLA
`attention_reference`, in both of the kernel's regimes: K2 (Skv > 1024,
causal, GQA, kv_bias, Sq != Skv) and K3 (Skv <= 1024, pad keys).
fp32 on both sides; tolerance 1e-5 abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch.ops import attention as tatt
from video_llava_seg_tpu.ops import attention as jatt

ATOL = 1e-5


def _qkv(seed, b, hq, hkv, sq, skv, d):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = r.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = r.standard_normal((b, hkv, skv, d)).astype(np.float32)
    return q, k, v


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("sq,skv,causal,masked", [
    (1100, 1100, True, False),    # LLM prefill: self, causal
    (300, 1090, True, True),      # cross lengths: diagonal at the ends
    (64, 1030, False, True),      # non-causal, per-key mask (kv_bias)
])
def test_k2_regime_matches_flash_and_reference(sq, skv, causal, masked):
    q, k, v = _qkv(0, 1, 2, 1, sq, skv, 16)
    kv_mask = None
    if masked:
        kv_mask = np.ones((1, skv), bool)
        kv_mask[:, :37] = False       # left padding
    want_ref = jatt.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_mask=None if kv_mask is None else jnp.asarray(kv_mask))
    kv_bias = (None if kv_mask is None
               else jnp.where(jnp.asarray(kv_mask), 0.0, jatt._MASK_VALUE))
    want_fa = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   interpret=True, kv_bias=kv_bias)
    got = tatt.attention(_t(q), _t(k), _t(v), causal=causal,
                         kv_mask=None if kv_mask is None
                         else torch.from_numpy(kv_mask)).numpy()
    rows = slice(None)
    if masked and causal:
        # query rows that see no valid key are garbage in every version
        rows = slice(max(0, 37 - (skv - sq)), None)
    np.testing.assert_allclose(got[:, :, rows], np.asarray(want_fa)[:, :, rows],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[:, :, rows],
                               np.asarray(want_ref)[:, :, rows],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (2, 8, 8, 300, 7, 16),        # mask-decoder image->token shape class
    (1, 4, 2, 260, 200, 32),      # GQA, pad keys past Skv % 128
])
def test_k3_regime_matches_flash_and_reference(b, hq, hkv, sq, skv, d):
    q, k, v = _qkv(1, b, hq, hkv, sq, skv, d)
    want_fa = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), interpret=True)
    want_ref = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    got = tatt.attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(want_fa), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=ATOL, rtol=0)


def test_reference_twin_decode_options():
    """kv_valid_len and q_positions (the cached-decode form)."""
    q, k, v = _qkv(2, 1, 4, 2, 1, 40, 16)
    qpos = np.asarray([29])
    want = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), kv_valid_len=30,
                                    causal=True, q_positions=jnp.asarray(qpos))
    got = tatt.attention_reference(_t(q), _t(k), _t(v), kv_valid_len=30,
                                   causal=True,
                                   q_positions=torch.from_numpy(qpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("kw", [{"window": 8}, {"alibi": True}])
def test_out_of_slice_variants_raise(kw):
    q, k, v = (torch.zeros(1, 1, 4, 16) for _ in range(3))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: sliding-window and ALiBi"):
        tatt.attention(q, k, v, **kw)
