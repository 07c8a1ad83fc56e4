"""The flash forward with its logsumexp and the flash backward (K6a /
K6b) as plain PyTorch, against the JAX package's Pallas kernels run in
interpret mode (`_fa_core(save_lse=True)`, `_fa_bwd_impl`) on the same
inputs; and the port's CPU autograd of `attention()` against `jax.grad`
of `flash_attention(interpret=True)`.

Cases: causal GQA with Sq == Skv; causal with Sq != Skv (diagonal at
the sequence ends); a per-key bias with masked keys (their dK / dV
exactly 0); the mask decoder's short Skv = 7 at D = 16; and the K2
(Skv > 1024) forward regime. fp32 on both sides; tolerance 2e-5 abs on
outputs and logsumexps, 1e-4 abs on gradients (sums over up to 1100
keys in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch.ops import attention as tatt
from video_llava_seg_tpu.ops import attention as jatt

FWD_ATOL = 2e-5
GRAD_ATOL = 1e-4

CASES = {
    # name: (b, hq, hkv, sq, skv, d, causal, masked)
    "causal_gqa": (1, 4, 2, 300, 300, 32, True, False),
    "causal_cross": (1, 2, 1, 100, 260, 16, True, False),
    "bias_masked": (2, 2, 2, 96, 150, 32, False, True),
    "short_kv": (3, 2, 2, 300, 7, 16, False, False),
}


def _inputs(seed, b, hq, hkv, sq, skv, d, masked):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = r.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = r.standard_normal((b, hkv, skv, d)).astype(np.float32)
    do = r.standard_normal((b, hq, sq, d)).astype(np.float32)
    kv_mask = None
    if masked:
        kv_mask = np.ones((b, skv), bool)
        kv_mask[0, 5:20] = False
        kv_mask[-1, :37] = False
    return q, k, v, do, kv_mask


def _bias(kv_mask):
    if kv_mask is None:
        return None
    return np.where(kv_mask, 0.0, float(tatt.MASK_VALUE)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_and_backward_match_pallas(name):
    b, hq, hkv, sq, skv, d, causal, masked = CASES[name]
    q, k, v, do, kv_mask = _inputs(0, b, hq, hkv, sq, skv, d, masked)
    bias = _bias(kv_mask)
    scale = 1.0 / np.sqrt(d)
    jbias = None if bias is None else jnp.asarray(bias)
    jout, jlse = jatt._fa_core(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jbias, causal=causal,
                               scale=scale, block_q=256, block_k=512,
                               interpret=True, save_lse=True)
    out, lse = tatt.flash_forward_plain(_t(q), _t(k), _t(v), _t(bias),
                                        causal=causal, scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_ATOL,
                               rtol=0)

    jdq, jdk, jdv = jatt._fa_bwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias, jout, jlse,
        jnp.asarray(do), causal=causal, scale=scale, block_q=256,
        block_k=512, interpret=True)
    dq, dk, dv = tatt.flash_backward_plain(
        _t(q), _t(k), _t(v), _t(bias), _t(jout), _t(jlse), _t(do),
        causal=causal, scale=scale)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL, rtol=0)
    if masked:
        dead = ~kv_mask
        for g in (dk, dv):
            gk = g.numpy().transpose(0, 2, 1, 3)[dead]
            assert gk.size and not gk.any(), "masked keys got a gradient"


def test_lse_in_the_multi_tile_regime():
    """Skv > 1024: the online-softmax (K2) form of `_fa_core`."""
    q, k, v, _, _ = _inputs(1, 1, 2, 1, 1100, 1100, 16, False)
    jout, jlse = jatt._fa_core(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), None, causal=True,
                               scale=0.25, block_q=256, block_k=512,
                               interpret=True, save_lse=True)
    out, lse = tatt.flash_forward_plain(_t(q), _t(k), _t(v), None,
                                        causal=True, scale=0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["causal_gqa", "causal_cross",
                                  "bias_masked"])
def test_cpu_autograd_matches_jax_grad(name):
    """What the CPU path trains with: autograd through the twin."""
    b, hq, hkv, sq, skv, d, causal, masked = CASES[name]
    q, k, v, do, kv_mask = _inputs(2, b, hq, hkv, sq, skv, d, masked)
    jmask = None if kv_mask is None else jnp.asarray(kv_mask)

    def f(q_, k_, v_):
        o = jatt.attention(q_, k_, v_, causal=causal, backend="pallas",
                           interpret=True, kv_mask=jmask)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    o = tatt.attention(tq, tk, tv, causal=causal, kv_mask=_t(kv_mask))
    (o * _t(do)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0)
