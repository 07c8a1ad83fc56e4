"""The recompute Functions that make K1 (`vit_layer`) and K4
(`hiera_block`) differentiable on the card: forward through the kernel
chain, backward by recomputing the plain layer (the JAX package's
`_vl_bwd` / `_hb_bwd`). Driven on the CPU by passing the plain forward in
as the kernel (the test-only `kernel=` argument), their gradients equal
the plain layer's own autograd and `jax.grad` of the JAX entry, whose
custom_vjp runs the Pallas kernel in interpret mode. fp32; tolerance
1e-4 abs (the same sums in another order, through the JAX kernels'
3e-5 forward bound).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hiera_block import make_block
from test_torch_vit_block import make_layer

from video_llava_seg_torch import bridge
from video_llava_seg_torch.ops.hiera_block import (
    hiera_block,
    hiera_block_plain,
)
from video_llava_seg_torch.ops.vit_block import vit_layer, vit_layer_plain
from video_llava_seg_torch.train.optimizer import leaves_with_paths
from video_llava_seg_tpu.ops import vit_block as jvb
from video_llava_seg_tpu.ops.hiera_block import hiera_block as jhiera_block

ATOL = 1e-4


def _grads_port(fn, p, x, g):
    """(dx, {path: dleaf}) of sum(fn(p, x) * g) by autograd."""
    p = bridge.tree_map(lambda t: t.clone().requires_grad_(True), p)
    x = x.clone().requires_grad_(True)
    (fn(p, x) * g).sum().backward()
    return x.grad, {k: t.grad for k, t in leaves_with_paths(p)}


def _check(jfn, jp, x_np, g_np, port_kernel_fn, port_plain_fn):
    want = jax.grad(lambda p_, x_: jnp.sum(jfn(p_, x_) * jnp.asarray(g_np)),
                    argnums=(0, 1))(jp, jnp.asarray(x_np))
    want_dx = np.asarray(want[1])
    want_dp = dict(leaves_with_paths(bridge.to_numpy(bridge.from_jax(
        want[0]))))
    tp = bridge.from_jax(jp)
    x, g = torch.from_numpy(x_np), torch.from_numpy(g_np)
    for fn in (port_kernel_fn, port_plain_fn):
        dx, dp = _grads_port(fn, tp, x, g)
        np.testing.assert_allclose(dx.numpy(), want_dx, atol=ATOL, rtol=0)
        assert set(dp) == set(want_dp)
        for path, got in dp.items():
            np.testing.assert_allclose(got.numpy(), want_dp[path], atol=ATOL,
                                       rtol=0, err_msg=path)


def test_vit_layer_recompute_gradients():
    bt, sp, kv, d, heads = 2, 16, 13, 128, 2
    kw = dict(num_heads=heads, eps=1e-5, kv_len=kv, act="quick_gelu")
    jp = make_layer(jax.random.PRNGKey(0), d, d * 4)
    r = np.random.default_rng(1)
    x = r.standard_normal((bt, sp, d)).astype(np.float32)
    g = r.standard_normal((bt, sp, d)).astype(np.float32)
    plain = functools.partial(vit_layer_plain, **kw)
    _check(lambda p_, x_: jvb.vit_layer(p_, x_, backend="pallas",
                                        interpret=True, **kw),
           jp, x, g,
           lambda p_, x_: vit_layer(p_, x_, kernel=plain, **kw), plain)


@pytest.mark.parametrize("shape,heads,ws,ps,proj", [
    ((2, 16, 16, 64), 2, 8, 2, True),       # q-pool + dim-change shortcut
    ((2, 8, 8, 64), 2, 0, 1, False),        # global attention
])
def test_hiera_block_recompute_gradients(shape, heads, ws, ps, proj):
    din = shape[-1]
    dout = din * 2 if proj else din
    kw = dict(num_heads=heads, ws=ws, q_stride=(ps, ps) if ps > 1 else None,
              eps=1e-6)
    jp = make_block(jax.random.PRNGKey(0), din, dout, with_proj=proj)
    r = np.random.default_rng(2)
    x = r.standard_normal(shape).astype(np.float32)
    out_shape = (shape[0], shape[1] // ps, shape[2] // ps, dout)
    g = r.standard_normal(out_shape).astype(np.float32)
    plain = functools.partial(hiera_block_plain, **kw)
    _check(lambda p_, x_: jhiera_block(p_, x_, backend="pallas",
                                       interpret=True, **kw),
           jp, x, g,
           lambda p_, x_: hiera_block(p_, x_, kernel=plain, **kw), plain)


def test_master_weights_get_gradients_in_their_dtype():
    """bf16 activations over fp32 master weights (the card's training
    state): the recompute returns fp32 weight gradients equal to the plain
    layer's autograd, and a bf16 input gradient."""
    kw = dict(num_heads=2, eps=1e-5, kv_len=16, act="quick_gelu")
    p = bridge.from_jax(make_layer(jax.random.PRNGKey(3), 128, 256))
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.standard_normal((2, 16, 128)).astype(
        np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(r.standard_normal((2, 16, 128)).astype(
        np.float32)).to(torch.bfloat16)
    plain = functools.partial(vit_layer_plain, **kw)
    dx, dp = _grads_port(lambda p_, x_: vit_layer(p_, x_, kernel=plain,
                                                  **kw), p, x, g)
    want_dx, want_dp = _grads_port(plain, p, x, g)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, want_dx)
    for path, got in dp.items():
        assert got.dtype == torch.float32
        assert torch.equal(got, want_dp[path]), path


def test_no_graph_without_grad():
    """Outside autograd the kernel runs directly (the serving path)."""
    kw = dict(num_heads=2, eps=1e-5, kv_len=16, act="quick_gelu")
    p = bridge.from_jax(make_layer(jax.random.PRNGKey(5), 128, 256))
    x = torch.randn(1, 16, 128)
    calls = []

    def kernel(p_, x_):
        calls.append(1)
        return vit_layer_plain(p_, x_, **kw)

    with torch.no_grad():
        y = vit_layer(p, x, kernel=kernel, **kw)
    assert y.grad_fn is None and calls == [1]
