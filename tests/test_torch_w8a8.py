"""K8's module (`ops/vit_block.py`, the W8A8 branch, plain version on the
CPU) vs the JAX package's W8A8 ViT layer: the Pallas kernel
`_vit_layer_pallas_i8` in interpret mode and its XLA oracle
`vit_layer_xla` over the same quantized tree. Mirrors
tests/test_vit_block.py: d 128, kv 37 of 40, both activations, pad
tokens that do not leak; plus the routing of mixed / weight-only layers,
the forward-only guard and the exact int8 product.

Tolerance. fp32 throughout; the values agree to TOL (3e-5, the JAX
kernel test's own bound) except where a last-bit difference in fp32 sums
(another summation order; the TPU kernel folds the attention scale into
q where the oracle scales the scores) lands on an int8 rounding boundary
of a per-row activation quantization. Such a flip moves the dense
output of that token's row by one quantization step (row amax / 127
times a weight), which the token-local rest of the layer spreads over
that row only. A fault moves many rows, or moves an element by more
than that step: the test allows at most one token row in 50 (at least
one) outside TOL, each element within STEP_FACTOR quantization steps of
the layer's largest dense. Measured here: one row of 80 in the first
case, off by at most 9.5e-4 (0.17 of a step); none in the others; the
JAX kernel and its oracle agree to 7e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vit_block import make_layer

from video_llava_seg_torch import bridge
from video_llava_seg_torch.ops import int4 as tint4
from video_llava_seg_torch.ops import quantization as tquant
from video_llava_seg_torch.ops.vit_block import (
    layer_quant_kind,
    vit_layer,
    vit_layer_plain,
)
from video_llava_seg_tpu.ops import nn as jnn
from video_llava_seg_tpu.ops import quantization as jquant
from video_llava_seg_tpu.ops import vit_block as jvb

TOL = dict(atol=3e-5, rtol=3e-5)
STEP_FACTOR = 4.0


def _quant_layer(seed, d):
    return jquant.quantize_tree(make_layer(jax.random.PRNGKey(seed), d,
                                           d * 4),
                                bits=8, act_quant=True, min_size=0)


def _step(p, x):
    """One int8 quantization step of the largest dense input: row amax /
    127 (rows of unit-variance activations after LayerNorm are bounded by
    the input's max) times the largest dequantized weight."""
    w = max(float(np.abs(np.asarray(p[n]["kernel_qa"], np.float32)
                         * np.asarray(p[n]["kernel_scale"])).max())
            for n in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1",
                      "fc2"))
    return max(float(np.abs(x).max()), 4.0) / 127.0 * w


def _assert_close_up_to_flips(got, want, step):
    diff = np.abs(got - want)
    rows = (diff > TOL["atol"] + TOL["rtol"] * np.abs(want)).any(-1)
    assert rows.sum() <= max(1, rows.size // 50), \
        f"{rows.sum()} of {rows.size} token rows differ"
    assert diff.max() <= STEP_FACTOR * step + TOL["atol"], (diff.max(),
                                                            step)


@pytest.mark.parametrize("bt,sp,kv,d,heads,act", [
    (2, 40, 37, 128, 2, "quick_gelu"),    # CLIP-like, padded kv
    (3, 16, 16, 128, 4, "quick_gelu"),    # no padding, several frames
    (1, 24, 21, 128, 1, "gelu"),          # RADIO's erf-GELU
])
def test_w8a8_layer_matches_pallas_and_oracle(bt, sp, kv, d, heads, act):
    p = _quant_layer(9, d)
    assert jvb.layer_quant_kind(p) == "w8a8"
    x = np.random.default_rng(10).standard_normal((bt, sp, d)).astype(
        np.float32)
    act_f = jvb._xla_quick_gelu if act == "quick_gelu" else jnn.gelu
    want_xla = np.asarray(jvb.vit_layer_xla(
        p, jnp.asarray(x), num_heads=heads, eps=1e-5, kv_len=kv, act=act_f))
    want_pl = np.asarray(jvb.vit_layer(
        p, jnp.asarray(x), num_heads=heads, eps=1e-5, kv_len=kv, act=act,
        backend="pallas", interpret=True))
    tp = bridge.from_jax(p)
    assert layer_quant_kind(tp) == "w8a8"
    got = vit_layer(tp, torch.from_numpy(x), num_heads=heads, eps=1e-5,
                    kv_len=kv, act=act).numpy()
    step = _step(p, x)
    _assert_close_up_to_flips(got, want_pl, step)
    _assert_close_up_to_flips(got, want_xla, step)


def test_w8a8_pad_tokens_do_not_leak():
    d, heads, kv, sp = 128, 2, 21, 24
    p = bridge.from_jax(_quant_layer(13, d))
    r = np.random.default_rng(14)
    x = r.standard_normal((2, sp, d)).astype(np.float32)
    garbage = x.copy()
    garbage[:, kv:] = 100.0 * r.standard_normal((2, sp - kv, d))
    a = vit_layer(p, torch.from_numpy(x), num_heads=heads, eps=1e-5,
                  kv_len=kv)
    b = vit_layer(p, torch.from_numpy(garbage), num_heads=heads, eps=1e-5,
                  kv_len=kv)
    np.testing.assert_array_equal(a[:, :kv].numpy(), b[:, :kv].numpy())


@pytest.mark.parametrize("mix", ["weight_only", "mixed"])
def test_other_quantized_layers_route_to_plain(mix):
    """Weight-only and mixed layers run the plain layer through nn.dense,
    as the JAX package runs them in XLA."""
    d, heads, sp = 128, 2, 24
    p = jquant.quantize_tree(make_layer(jax.random.PRNGKey(11), d, d * 4),
                             bits=8, act_quant=mix == "mixed", min_size=0)
    if mix == "mixed":
        p = dict(p)
        p["fc2"] = make_layer(jax.random.PRNGKey(12), d, d * 4)["fc2"]
    assert jvb.layer_quant_kind(p) == "w8"
    x = np.random.default_rng(12).standard_normal((2, sp, d)).astype(
        np.float32)
    want = jvb.vit_layer(p, jnp.asarray(x), num_heads=heads, eps=1e-5,
                         kv_len=sp, backend="pallas", interpret=True)
    tp = bridge.from_jax(p)
    assert layer_quant_kind(tp) == "w8"
    got = vit_layer(tp, torch.from_numpy(x), num_heads=heads, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = vit_layer_plain(tp, torch.from_numpy(x), num_heads=heads,
                          eps=1e-5, kv_len=sp)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_w8a8_is_forward_only():
    p = bridge.from_jax(_quant_layer(15, 128))
    x = torch.randn(1, 8, 128, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        vit_layer(p, x, num_heads=2, eps=1e-5)
    with torch.no_grad():
        assert vit_layer(p, x, num_heads=2, eps=1e-5).shape == x.shape


def test_int_matmul_plain_is_exact():
    """int_matmul on the CPU (and the card's reference for gemm_s8) equals
    an int64 product, at sums past fp32's 2^24 exact range."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (7, 4096), generator=g, dtype=torch.int8)
    b = torch.full((4096, 12), 127, dtype=torch.int8)
    b[:, 1::2] = torch.randint(-128, 128, (4096, 6), generator=g,
                               dtype=torch.int8)
    a[0] = 127
    want = a.long() @ b.long()
    for fn in (tint4.int_matmul, tint4.int_matmul_plain):
        got = fn(a, b)
        assert got.dtype == torch.int32
        assert torch.equal(got.long(), want)
    assert int(want[0, 0]) == 4096 * 127 * 127


def test_quant_rows_bit_equal_to_jax():
    """The per-row quantization the K8 chain reproduces on the card is
    the JAX package's, bit for bit (scales and int8 values)."""
    x = np.random.default_rng(16).standard_normal((9, 40)).astype(
        np.float32) * np.linspace(0.1, 30.0, 9, dtype=np.float32)[:, None]
    x[3] = 0.0
    jq, js = jquant.quantize_activations_rowwise(jnp.asarray(x))
    tq, ts = tquant.quantize_activations_rowwise(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[3]) == 1.0
