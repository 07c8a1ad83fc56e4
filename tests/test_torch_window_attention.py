"""K7's module (`ops/window_attention.py`, plain version on the CPU) vs
the JAX package's fused window attention (the Pallas `_win_kernel` in
interpret mode and its XLA oracle), and the port's per-op Hiera trunk
(`models/sam2/hiera.py` with `USE_FUSED_BLOCK = False`) vs the JAX
trunk under the same switch and on its partition-based window path.
Mirrors tests/test_window_attention.py: head dims 96 / 64 / 32, windows
8 / 4 / 7 / 14, the 2x2 q pool, and the non-divisible config whose maps
force the zero-pad + crop path; also Hiera-L's head dim 72 (ws 16 plain
and pooled) and Hiera-B+'s 56 (ws 14), and a head-dim-72 per-op trunk
whose global block pads its head dim as the card's path does. fp32;
tolerance 2e-5 for the op (the JAX kernel test's bound) and 2e-4 for
the trunk (the JAX test's fused-vs-legacy bound: six blocks of sums in
other orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import bridge
from video_llava_seg_torch.models.sam2 import hiera as thiera
from video_llava_seg_torch.models.sam2.config import HieraConfig as THiera
from video_llava_seg_torch.ops.attention import attention
from video_llava_seg_torch.ops.hiera_block import max_pool_2x2
from video_llava_seg_torch.ops.window_attention import (
    window_attention,
    window_attention_plain,
)
from video_llava_seg_tpu.models.sam2 import hiera as jhiera
from video_llava_seg_tpu.models.sam2.config import HieraConfig as JHiera
from video_llava_seg_tpu.ops.window_attention import (
    window_attention as jwindow_attention,
)

OP_TOL = dict(atol=2e-5, rtol=2e-5)
TRUNK_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("shape,heads,ws,ps", [
    ((2, 16, 16, 3 * 96), 1, 8, 1),     # stage-1-like: hd 96, 1 head
    ((1, 16, 24, 3 * 192), 2, 4, 1),    # stage-2-like: hd 96, 2 heads
    ((2, 14, 14, 3 * 64), 2, 7, 1),     # odd window side
    ((2, 16, 16, 3 * 96), 1, 8, 2),     # stage-1 transition: q pool
    ((1, 16, 24, 3 * 192), 2, 4, 2),    # stage-2 transition
    ((1, 28, 14, 3 * 64), 2, 14, 2),    # ws 14 pooled to 7
    ((1, 16, 16, 3 * 32), 1, 4, 1),     # hd 32
    ((1, 32, 16, 3 * 72), 1, 16, 1),    # Hiera-L: hd 72, ws 16
    ((1, 32, 32, 3 * 144), 2, 16, 2),   # Hiera-L's pooled ws 16
    ((1, 28, 14, 3 * 112), 2, 14, 1),   # Hiera-B+: hd 56, ws 14
])
def test_window_attention_matches_pallas_and_oracle(shape, heads, ws, ps):
    qkv = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    q_pool = (ps, ps) if ps > 1 else None
    want_xla = jwindow_attention(jnp.asarray(qkv), num_heads=heads, ws=ws,
                                 q_pool=q_pool, backend="xla")
    want_pl = jwindow_attention(jnp.asarray(qkv), num_heads=heads, ws=ws,
                                q_pool=q_pool, backend="pallas",
                                interpret=True)
    got = window_attention(torch.from_numpy(qkv), num_heads=heads, ws=ws,
                           q_pool=q_pool).numpy()
    assert got.shape == (shape[0], shape[1] // ps, shape[2] // ps,
                         shape[3] // 3)
    np.testing.assert_allclose(got, np.asarray(want_pl), **OP_TOL)
    np.testing.assert_allclose(got, np.asarray(want_xla), **OP_TOL)


def test_window_attention_contract():
    qkv = torch.zeros(1, 12, 12, 3 * 32)
    with pytest.raises(ValueError, match="divide"):
        window_attention(qkv, num_heads=1, ws=8)
    with pytest.raises(ValueError, match="q pool"):
        window_attention(qkv, num_heads=1, ws=3, q_pool=(2, 2))
    with pytest.raises(ValueError, match="square"):
        window_attention(qkv, num_heads=1, ws=4, q_pool=(2, 1))
    with pytest.raises(ValueError, match="heads"):
        window_attention(qkv, num_heads=3, ws=4)
    # a grad-recording CPU call is the plain version, differentiable
    t = torch.randn(1, 8, 8, 3 * 32, requires_grad=True)
    out = window_attention(t, num_heads=2, ws=4, q_pool=(2, 2))
    out.sum().backward()
    assert t.grad is not None and t.grad.shape == t.shape
    want = window_attention_plain(t.detach(), num_heads=2, ws=4,
                                  scale=1 / 4.0, ps=2)
    torch.testing.assert_close(out.detach(), want)


# the non-divisible trunk of tests/test_window_attention.py: a 72x72 map
# (288 input) gives ws 8 on 72 (pad 80), a q-pool at ws 8, ws 4 on 36, a
# q-pool at ws 4, a global block on 18x18 and the ws 14 q-pool on 18 (pad
# 28, crop to 9)
CFG = dict(embed_dim=32, num_heads=1, stages=(1, 2, 2, 1),
           global_att_blocks=(4,), window_pos_embed_bkg_spatial_size=(7, 7),
           window_spec=(8, 4, 14, 7))


@pytest.fixture(scope="module")
def trunk():
    """The port's seeded init, every bias and norm given some spread (the
    pad tokens must carry the qkv bias), as a torch and a JAX tree."""
    cfg = THiera(**CFG)
    tp = thiera.init(cfg, torch.Generator().manual_seed(0), "cpu",
                     torch.float32)
    r = np.random.default_rng(1)
    tree = bridge.to_numpy(tp)

    def spread(node, key=None):
        if isinstance(node, dict):
            return {k: spread(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [spread(v, key) for v in node]
        if key in ("bias", "pos_embed", "pos_embed_window"):
            return (node + 0.1 * r.standard_normal(node.shape)).astype(
                np.float32)
        if key == "scale":
            return (node * (1 + 0.1 * r.standard_normal(node.shape))
                    ).astype(np.float32)
        return node

    tree = spread(tree)
    x = r.standard_normal((1, 288, 288, 3)).astype(np.float32)
    return (bridge.from_jax(tree), jax.tree.map(jnp.asarray, tree), x)


@pytest.mark.parametrize("fused_block", [True, False])
def test_hiera_trunk_switches_match_jax(trunk, fused_block):
    """K4 on every block, or the per-op path (K7 on the windowed blocks);
    the JAX trunk runs the same path under its defaults otherwise."""
    tp, jp, x = trunk
    saved = [(m, m.USE_FUSED_BLOCK) for m in (thiera, jhiera)]
    try:
        for m in (thiera, jhiera):
            m.USE_FUSED_BLOCK = fused_block
        want = jhiera.apply(jp, JHiera(**CFG), jnp.asarray(x),
                            interpret=True)
        got = thiera.apply(tp, THiera(**CFG), torch.from_numpy(x))
    finally:
        for m, fb in saved:
            m.USE_FUSED_BLOCK = fb
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert [g.shape[1] for g in got] == [72, 36, 18, 9]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TRUNK_TOL)


def test_per_op_trunk_matches_jax_partition_path(trunk):
    """The port's per-op trunk (fused windows) against the JAX trunk's
    partition -> SDPA -> unpartition path, which the port does not keep."""
    tp, jp, x = trunk
    saved = (thiera.USE_FUSED_BLOCK, jhiera.USE_FUSED_BLOCK,
             jhiera.USE_FUSED_WINDOW_ATTN)
    try:
        thiera.USE_FUSED_BLOCK = jhiera.USE_FUSED_BLOCK = False
        jhiera.USE_FUSED_WINDOW_ATTN = False
        want = jhiera.apply(jp, JHiera(**CFG), jnp.asarray(x),
                            interpret=True)
        got = thiera.apply(tp, THiera(**CFG), torch.from_numpy(x))
    finally:
        (thiera.USE_FUSED_BLOCK, jhiera.USE_FUSED_BLOCK,
         jhiera.USE_FUSED_WINDOW_ATTN) = saved
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TRUNK_TOL)


# a head-dim-72 trunk (Hiera-L's head dim in every stage): ws 8 on 64^2,
# q-pools at ws 8 and ws 4, a ws 16 block on 16^2, a global block on 16^2
# (256 tokens: the kernel path, its head dim padded to 80) and the pooled
# ws 16 block
CFG72 = dict(embed_dim=72, num_heads=1, stages=(1, 1, 3, 1),
             global_att_blocks=(4,), window_pos_embed_bkg_spatial_size=(7, 7),
             window_spec=(8, 4, 16, 8))


def test_per_op_trunk_head_dim_72_matches_jax(monkeypatch):
    """The per-op trunk at head dim 72 against the JAX per-op trunk: the
    windowed blocks through K7 (ws 8, 4 and 16, plain and pooled), the
    global block's attention at head dim 72 zero-padded to 80 (the scale
    the true head dim's), as on the card."""
    cfg = THiera(**CFG72)
    tp = thiera.init(cfg, torch.Generator().manual_seed(3), "cpu",
                     torch.float32)
    r = np.random.default_rng(4)
    tree = bridge.to_numpy(tp)
    for blk in tree["blocks"]:
        for leaf in ("qkv", "proj_attn"):
            blk[leaf]["bias"] = (0.1 * r.standard_normal(
                blk[leaf]["bias"].shape)).astype(np.float32)
    x = r.standard_normal((1, 256, 256, 3)).astype(np.float32)
    head_dims = []

    def spy(q, k, v, **kw):
        head_dims.append((q.shape[-1], kw.get("backend")))
        return attention(q, k, v, **kw)

    monkeypatch.setattr(thiera, "attention", spy)
    saved = (thiera.USE_FUSED_BLOCK, jhiera.USE_FUSED_BLOCK)
    try:
        thiera.USE_FUSED_BLOCK = jhiera.USE_FUSED_BLOCK = False
        want = jhiera.apply(jax.tree.map(jnp.asarray, tree), JHiera(**CFG72),
                            jnp.asarray(x), interpret=True)
        got = thiera.apply(bridge.from_jax(tree), cfg, torch.from_numpy(x))
    finally:
        thiera.USE_FUSED_BLOCK, jhiera.USE_FUSED_BLOCK = saved
    assert head_dims == [(80, "auto")]
    assert [g.shape[1] for g in got] == [64, 32, 16, 8]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TRUNK_TOL)


@pytest.mark.parametrize("shape", [(2, 9, 11, 5), (1, 8, 8, 3)])
def test_partition_helpers_match_jax(shape):
    """The shortcut / q pool (odd edges dropped) against the JAX trunk's
    `_max_pool_2x2`; the configs agree field for field."""
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jpool = jhiera._max_pool_2x2(jnp.asarray(x), (2, 2))
    tpool = max_pool_2x2(torch.from_numpy(x))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    assert dataclasses.asdict(THiera(**CFG)) == dataclasses.asdict(
        JHiera(**CFG))
