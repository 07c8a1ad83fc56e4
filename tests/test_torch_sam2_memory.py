"""The port's SAM2 memory parts against the JAX package's on the CPU, at
`sam2-test-tiny` (fp32, seeded numpy inputs): axial RoPE (with repeated
key frequencies and unrotated pointer tokens), the memory encoder, memory
attention, the `base` functions of the video path (`forward_sam_heads`,
`use_mask_as_output`, `encode_new_memory`, the non-overlap constraint),
the valid-slots memory bank against the JAX predictor's fixed-slot bank
with its mask, and the routes this slice adds: memory attention's
kernel / plain dispatch, K2 at head dim 256, and the zero-padded head
dims 56 / 72 of the Hiera-B+ / L global blocks.

Trees: the port's seeded init as numpy (`bridge.to_numpy`), with the
memory encoder's ConvNeXt gammas drawn at scale 1 (the init's 1e-6 makes
the fuser nearly the identity) and memory attention's LayerNorm scales
spread by 10 %. JAX runs as its own tests run it here:
memory attention at these sizes (64 queries) takes its XLA twin, as the
port takes the plain twin. Tolerance TOL: fp32 sums in another order
through a few layers (measured below 1e-5 relative); the SAM heads and
the memory encoder, with more layers and larger sums, 1e-4. The JAX
functions run under jit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_llava_seg_torch import bridge, kernels
from video_llava_seg_torch.models.sam2 import base as tbase
from video_llava_seg_torch.models.sam2 import memory as tmem
from video_llava_seg_torch.models.sam2.config import sam2_config as tsam2
from video_llava_seg_torch.models.sam2.video_predictor import (
    SAM2VideoPredictor as TPredictor,
)
from video_llava_seg_torch.ops import attention as tatt
from video_llava_seg_torch.ops import hiera_block as thb
from video_llava_seg_torch.ops import rope as trope
from video_llava_seg_tpu.models.sam2 import base as jbase
from video_llava_seg_tpu.models.sam2 import memory as jmem
from video_llava_seg_tpu.models.sam2.config import sam2_config as jsam2
from video_llava_seg_tpu.models.sam2.video_predictor import (
    SAM2VideoPredictor as JPredictor,
)
from video_llava_seg_tpu.ops import rope as jrope
from video_llava_seg_tpu.ops.hiera_block import hiera_block_xla

TINY = "sam2-test-tiny"
TOL = dict(atol=1e-5, rtol=1e-5)
SM90 = "vls_flash_fwd_sm90"

# the JAX functions under jit (one XLA compile a shape, ~1-2 s here,
# where eager dispatch compiles every op apart: ~12 s for the SAM heads)
j_memory_encoder = jax.jit(jmem.memory_encoder_apply, static_argnums=1,
                           static_argnames="skip_mask_sigmoid")
j_memory_attention = jax.jit(jmem.memory_attention_apply, static_argnums=1,
                             static_argnames="num_obj_ptr_tokens")
j_sam_heads = jax.jit(jbase.forward_sam_heads, static_argnums=1,
                      static_argnames="multimask_output")
j_mask_as_output = jax.jit(jbase.use_mask_as_output, static_argnums=1)
j_encode_memory = jax.jit(jbase.encode_new_memory, static_argnums=1,
                          static_argnames="is_mask_from_pts")
j_hiera_block = jax.jit(hiera_block_xla, static_argnames=(
    "num_heads", "ws", "q_stride", "eps"))


def _r(seed):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module")
def trees():
    cfg = tsam2(TINY)
    tree = bridge.to_numpy(tbase.init(cfg, torch.Generator().manual_seed(0),
                                      "cpu", torch.float32))
    r = _r(0)
    for layer in tree["memory_encoder"]["fuser"]["layers"]:
        layer["gamma"] = r.standard_normal(layer["gamma"].shape).astype(
            np.float32)
    for layer in tree["memory_attention"]["layers"]:
        for n in ("norm1", "norm2", "norm3"):
            layer[n]["scale"] = (1 + 0.1 * r.standard_normal(
                layer[n]["scale"].shape)).astype(np.float32)
    return tree, bridge.from_jax(tree), cfg, jsam2(TINY)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("nk,repeat,exclude", [(64, False, 0),
                                               (3 * 64 + 8, True, 8),
                                               (8, True, 8)])
def test_axial_rope_matches_jax(nk, repeat, exclude):
    """Interleaved pairs, x frequencies then y, the key table tiled over
    stacked frames, trailing pointer tokens unrotated (exactly)."""
    r = _r(nk)
    q = r.standard_normal((2, 1, 64, 64)).astype(np.float32)
    k = r.standard_normal((2, 1, nk, 64)).astype(np.float32)
    jq, jk = jrope.apply_axial_rope(jnp.asarray(q), jnp.asarray(k), 8, 8,
                                    10000.0, repeat_freqs_k=repeat,
                                    num_k_exclude=exclude)
    tq, tk = trope.apply_axial_rope(torch.from_numpy(q), torch.from_numpy(k),
                                    8, 8, 10000.0, repeat_freqs_k=repeat,
                                    num_k_exclude=exclude)
    _close(tq, jq)
    _close(tk, jk)
    if exclude:
        np.testing.assert_array_equal(tk[..., -exclude:, :].numpy(),
                                      k[..., -exclude:, :])
    cos, sin = trope.axial_rope_cos_sin(64, 8, 8)
    jc, js = jrope.axial_rope_cos_sin(64, 8, 8)
    np.testing.assert_array_equal(cos, jc)
    np.testing.assert_array_equal(sin, js)
    with pytest.raises(ValueError, match="repeat_freqs_k"):
        trope.apply_axial_rope(torch.from_numpy(q), torch.zeros(1, 1, 70, 64),
                               8, 8)


@pytest.mark.parametrize("skip_sigmoid", [False, True])
def test_memory_encoder_matches_jax(trees, skip_sigmoid):
    tree, ttree, cfg, jcfg = trees
    r = _r(1)
    s = cfg.image_embedding_size
    pix = r.standard_normal((2, s, s, cfg.hidden_dim)).astype(np.float32)
    masks = 4 * r.standard_normal((2, 16 * s, 16 * s, 1)).astype(np.float32)
    jf, jpos = j_memory_encoder(
        tree["memory_encoder"], jcfg, jnp.asarray(pix), jnp.asarray(masks),
        skip_mask_sigmoid=skip_sigmoid)
    tf, tpos = tmem.memory_encoder_apply(
        ttree["memory_encoder"], cfg, torch.from_numpy(pix),
        torch.from_numpy(masks), skip_mask_sigmoid=skip_sigmoid)
    assert tf.shape == (2, s, s, cfg.mem_dim)
    _close(tf, jf, atol=1e-4, rtol=1e-4)
    _close(tpos, jpos)


@pytest.mark.parametrize("n_mem,n_ptr", [(1, 0), (3, 2), (7, 4)])
def test_memory_attention_matches_jax(trees, n_mem, n_ptr):
    """Self-attention over the frame's 64 tokens, cross-attention over
    n_mem stacked spatial memories and n_ptr pointers (4 tokens each, no
    RoPE), the ReLU FFN, positions on the keys only."""
    tree, ttree, cfg, jcfg = trees
    r = _r(n_mem + 10 * n_ptr)
    c, m, hw = cfg.hidden_dim, cfg.mem_dim, cfg.image_embedding_size ** 2
    nt = 4 * n_ptr
    curr = r.standard_normal((2, hw, c)).astype(np.float32)
    curr_pos = r.standard_normal((2, hw, c)).astype(np.float32)
    mem = r.standard_normal((2, n_mem * hw + nt, m)).astype(np.float32)
    mem_pos = r.standard_normal((2, n_mem * hw + nt, m)).astype(np.float32)
    want = j_memory_attention(
        tree["memory_attention"], jcfg, *map(jnp.asarray, (curr, mem,
                                                          curr_pos, mem_pos)),
        num_obj_ptr_tokens=nt)
    got = tmem.memory_attention_apply(
        ttree["memory_attention"], cfg, *map(torch.from_numpy,
                                             (curr, mem, curr_pos, mem_pos)),
        num_obj_ptr_tokens=nt)
    _close(got, want, atol=2e-5, rtol=2e-5)


def test_rope_attention_route():
    """The JAX package's dispatch, kept: the flash kernel (on the card K2,
    head dim 256 at full width) from 256 queries, the plain twin below.
    At full width every query set is a frame's 64 x 64 tokens."""
    assert tmem.rope_attention_backend(4096) == "auto"
    assert tmem.rope_attention_backend(256) == "auto"
    assert tmem.rope_attention_backend(255) == "plain"
    assert tmem.rope_attention_backend(64) == "plain"
    full = tsam2("large")
    assert full.memory_attention.d_model // full.memory_attention.num_heads \
        == 256
    assert full.memory_attention.rope_feat_size ** 2 == 4096


@pytest.mark.parametrize("skv,two_pass", [(4096, False),
                                          (7 * 4096 + 16 * 4, False),
                                          (4096 + 12, False), (1024, True),
                                          (9, True)])
def test_k2_head_dim_256_entry(skv, two_pass):
    """Head dim 256 (memory attention's self shape, the full bank's cross
    shape, a ragged bank, and the two-pass form a 32 x 32 grid would take)
    goes to attention_sm90.cu whatever the form or the key count; its
    K / V boxes are 64 rows, Q's 128; a per-key bias is refused (no kernel
    has it), and attention.cu keeps its head dims."""
    assert kernels.attention_entry(256, two_pass, skv, 1) == SM90
    with pytest.raises(ValueError, match="per-key bias"):
        kernels.attention_entry(256, False, skv, 1, bias=True)
    assert 256 not in kernels.ATTENTION_HEAD_DIMS
    assert 256 in kernels.FLASH_SM90_HEAD_DIMS
    q = torch.zeros(1, 4096, 1, 256, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(1, skv, 1, 256, dtype=torch.bfloat16).transpose(1, 2)
    g = kernels._forward_geometry(SM90, q.shape, q.stride(), k.shape,
                                  k.stride(), k.stride(), 2)
    assert len(g) == 33
    assert tuple(g[:11]) == (256, 4096, 1, 1, 512, 512, 512 * 4096,
                             64, 128, 1, 1)
    for i in (1, 2):
        assert tuple(g[11 * i:11 * i + 11]) == (256, skv, 1, 1, 512, 512,
                                                512 * skv, 64, 64, 1, 1)
    assert kernels.flash_sm90_kv_rows(256) == 64
    assert all(kernels.flash_sm90_kv_rows(d) == 128 for d in (64, 80, 96,
                                                             128))


def test_wide_head_dim_needs_the_card():
    """A CPU tensor at head dim 256 takes the plain twin through
    `ops.attention`; `kernels.attention` itself takes CUDA tensors only
    (no fallback)."""
    q = torch.zeros(1, 1, 16, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.attention(q, q, q, scale=1 / 16)
    out = tatt.attention(q.float(), q.float(), q.float())
    assert out.shape == q.shape


@pytest.mark.parametrize("multimask,points,mask", [(True, True, False),
                                                   (False, True, True),
                                                   (False, False, False),
                                                   (True, False, True)])
def test_forward_sam_heads_matches_jax(trees, multimask, points, mask):
    tree, ttree, cfg, jcfg = trees
    r = _r(int(multimask) + 2 * int(points) + 4 * int(mask))
    s = cfg.image_embedding_size
    feats = [r.standard_normal((2, s * f, s * f, c)).astype(np.float32)
             for f, c in ((4, cfg.hidden_dim // 8), (2, cfg.hidden_dim // 4),
                          (1, cfg.hidden_dim))]
    kw_j, kw_t = {}, {}
    if points:
        coords = r.uniform(0, cfg.image_size, (2, 2, 2)).astype(np.float32)
        labels = np.array([[1, 0], [1, 1]], np.int32)
        kw_j.update(point_coords=jnp.asarray(coords),
                    point_labels=jnp.asarray(labels))
        kw_t.update(point_coords=torch.from_numpy(coords),
                    point_labels=torch.from_numpy(labels))
    if mask:
        m = 4 * r.standard_normal((2, 4 * s, 4 * s, 1)).astype(np.float32)
        kw_j["mask_inputs"] = jnp.asarray(m)
        kw_t["mask_inputs"] = torch.from_numpy(m)
    want = j_sam_heads(
        tree, jcfg, jnp.asarray(feats[2]),
        high_res_features=[jnp.asarray(f) for f in feats[:2]],
        multimask_output=multimask, **kw_j)
    got = tbase.forward_sam_heads(
        ttree, cfg, torch.from_numpy(feats[2]),
        high_res_features=[torch.from_numpy(f) for f in feats[:2]],
        multimask_output=multimask, **kw_t)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, atol=1e-4, rtol=1e-4)


def test_use_mask_as_output_and_encode_memory_match_jax(trees):
    """A mask input becomes +-10 logits with a decoded pointer (an empty
    mask: score -10 and the no-object pointer); the memory encoder on the
    mask logits, with the no-object embedding where the score is <= 0,
    from points (binarized or not: the 2.1 flag is off) and not."""
    tree, ttree, cfg, jcfg = trees
    r = _r(5)
    s = cfg.image_embedding_size
    feats = [r.standard_normal((2, s * f, s * f, c)).astype(np.float32)
             for f, c in ((4, cfg.hidden_dim // 8), (2, cfg.hidden_dim // 4),
                          (1, cfg.hidden_dim))]
    m = (r.random((2, cfg.image_size, cfg.image_size, 1)) > 0.6).astype(
        np.float32)
    m[1] = 0.0
    want = j_mask_as_output(
        tree, jcfg, jnp.asarray(feats[2]), [jnp.asarray(f) for f in feats[:2]],
        jnp.asarray(m))
    got = tbase.use_mask_as_output(
        ttree, cfg, torch.from_numpy(feats[2]),
        [torch.from_numpy(f) for f in feats[:2]], torch.from_numpy(m))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got[6].numpy(), [[10.0], [-10.0]])
    high = 8 * r.standard_normal((2, 1, cfg.image_size, cfg.image_size)
                                 ).astype(np.float32)
    score = np.array([[3.0], [-2.0]], np.float32)
    for pts in (False, True):
        jf, jp = j_encode_memory(tree, jcfg, jnp.asarray(feats[2]),
                                         jnp.asarray(high),
                                         jnp.asarray(score),
                                         is_mask_from_pts=pts)
        tf, tp = tbase.encode_new_memory(ttree, cfg,
                                         torch.from_numpy(feats[2]),
                                         torch.from_numpy(high),
                                         torch.from_numpy(score),
                                         is_mask_from_pts=pts)
        _close(tf, jf, atol=1e-4, rtol=1e-4)
        _close(tp, jp)


def test_non_overlapping_constraints_match_jax():
    x = _r(6).standard_normal((3, 1, 8, 12)).astype(np.float32) * 20
    for n in (1, 3):
        _close(tbase.apply_non_overlapping_constraints(torch.from_numpy(
            x[:n])), jbase.apply_non_overlapping_constraints(
            jnp.asarray(x[:n])))


def _bank(cfg, r, b, spatial_tpos, ptr_tpos):
    s, m, c = cfg.image_embedding_size, cfg.mem_dim, cfg.hidden_dim
    spatial = [(r.standard_normal((b, s, s, m)).astype(np.float32), t)
               for t in spatial_tpos]
    ptrs = [(r.standard_normal((b, c)).astype(np.float32), t)
            for t in ptr_tpos]
    return spatial, ptrs


@pytest.mark.parametrize("spatial_tpos,ptr_tpos", [
    ((6,), ()),                              # the first tracked frame
    ((6, 5), (1, 0)),                        # a cond frame and one before
    ((6, 6, 5, 4, 3, 2, 1, 0), (0, 1, 2, 3)),  # a full bank, two cond
    ((6, 4, 2), (-3, 2, 1)),                 # gaps, a signed pointer
])
def test_valid_bank_equals_fixed_slot_bank(trees, spatial_tpos, ptr_tpos):
    """The port's bank of valid entries against the JAX predictor's
    fixed-slot bank (`_condition_on_memory`: 4 + num_maskmem - 1 = 10
    spatial slots, max_obj_ptrs_in_encoder = 4 pointer slots) holding the
    same entries and garbage in its masked slots: the same function up to
    the sums' order (TOL, ~1e-5 relative)."""
    tree, ttree, cfg, jcfg = trees
    r = _r(len(spatial_tpos) + 10 * len(ptr_tpos))
    b, s, c = 2, cfg.image_embedding_size, cfg.hidden_dim
    low = r.standard_normal((b, s, s, c)).astype(np.float32)
    spatial, ptrs = _bank(cfg, r, b, spatial_tpos, ptr_tpos)
    jp = JPredictor(tree, jcfg)
    n_slots, n_ptr = jp.num_slots, cfg.max_obj_ptrs_in_encoder
    junk = lambda shape: 1e3 * r.standard_normal(shape).astype(np.float32)
    mem = [f for f, _ in spatial] + [junk((b, s, s, cfg.mem_dim))
                                     for _ in range(n_slots - len(spatial))]
    slot_tpos = np.array([t for _, t in spatial]
                         + [3] * (n_slots - len(spatial)), np.int32)
    slot_valid = np.arange(n_slots) < len(spatial)
    pts = [p for p, _ in ptrs] + [junk((b, c)) for _ in range(n_ptr
                                                              - len(ptrs))]
    p_tpos = np.array([t for _, t in ptrs] + [2] * (n_ptr - len(ptrs)),
                      np.float32)
    p_valid = np.arange(n_ptr) < len(ptrs)
    want = jax.jit(jp._condition_on_memory)(
        jp.params, jnp.asarray(low),
        jnp.stack([jnp.asarray(f).reshape(b, s * s, -1) for f in mem], 1),
        jnp.asarray(slot_tpos), jnp.asarray(slot_valid),
        jnp.stack([jnp.asarray(p) for p in pts], 1), jnp.asarray(p_tpos),
        jnp.asarray(p_valid))
    tp = TPredictor(ttree, cfg, device="cpu")
    got = tp._condition_on_memory(
        torch.from_numpy(low),
        [(torch.from_numpy(f), t) for f, t in spatial],
        [(torch.from_numpy(p), t) for p, t in ptrs])
    _close(got, want, atol=2e-5, rtol=2e-5)


def test_every_memory_row_sees_a_key(trees, monkeypatch):
    """Over a session (two objects, prompts on frames 0 and 2, forward and
    reverse propagation), every attention of memory attention gets no
    mask and at least one key for every query row: the valid-slots bank
    is never empty on a memory-conditioned frame, so the fully masked row
    of the fixed-slot bank cannot arise. An empty bank is refused."""
    _, ttree, cfg, _ = trees
    seen = []
    plain = tmem.attention

    def attention(q, k, v, **kw):
        assert set(kw) == {"backend"}, kw
        seen.append(k.shape[2])
        return plain(q, k, v, **kw)

    monkeypatch.setattr(tmem, "attention", attention)
    tp = TPredictor(ttree, cfg, device="cpu")
    frames = _r(7).integers(0, 256, (6, 64, 80, 3), dtype=np.uint8)
    st = tp.init_state(frames)
    tp.add_new_points_or_box(st, 0, 1, points=[[30.0, 20.0]], labels=[1])
    tp.add_new_points_or_box(st, 2, 2, box=[10.0, 10.0, 60.0, 50.0])
    list(tp.propagate_in_video(st))
    list(tp.propagate_in_video(st, start_frame_idx=5, reverse=True))
    hw = cfg.image_embedding_size ** 2
    # 2 layers x (self + cross) a tracked frame: 4 + 4 frames tracked
    assert len(seen) == 2 * 2 * 8
    assert min(seen) >= hw and all(n >= 1 for n in seen)
    low = torch.zeros(1, 8, 8, cfg.hidden_dim)
    with pytest.raises(RuntimeError, match="at least one memory"):
        tp._condition_on_memory(low, [], [])


@pytest.mark.parametrize("hd,want", [(72, 80), (56, 64), (96, 96), (32, 32),
                                     (128, 128), (16, 16)])
def test_attention_head_dim_route(hd, want):
    """K4's global blocks at a head dim no kernel has (Hiera-B+'s 56,
    Hiera-L's 72) go zero-padded to the next attention_sm90.cu instance."""
    assert thb.attention_head_dim(hd) == want
    assert kernels.attention_entry(want, False, 4096, 16) == (
        SM90 if want in kernels.FLASH_SM90_HEAD_DIMS else
        "vls_attention_bf16")


@pytest.mark.parametrize("din,heads", [(144, 2), (112, 2)])
def test_padded_global_block_matches_jax(monkeypatch, din, heads):
    """A Hiera-L (head dim 72) / B+ (56) global block through K4's chain on
    fp32 CPU stand-ins: `attention` sees q, k and v zero-padded to 80 / 64
    with the scale of the true head dim, and the block equals the JAX
    package's `hiera_block_xla`."""
    import test_torch_window_sm90 as tw

    seen = []

    def attention(q, k, v, *, scale):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return tatt.attention_reference(q, k, v, scale=scale)

    monkeypatch.setattr(kernels, "gemm",
                        lambda a, b, bias=None, residual=None, scale=1.0,
                        act="none": kernels.gemm_plain(a, b, bias, residual,
                                                       scale, act))
    monkeypatch.setattr(kernels, "attention", attention)
    monkeypatch.setattr(kernels, "layernorm",
                        lambda x, g, b, eps: tbase.nn.layer_norm(
                            {"scale": g, "bias": b}, x, eps))
    g = _r(din)
    blk = tw._block(g, din, din)
    x = g.standard_normal((2, 8, 8, din)).astype(np.float32)
    got = thb._hiera_block_cuda(bridge.tree_map(torch.from_numpy, blk),
                                torch.from_numpy(x), num_heads=heads, ws=0,
                                ps=1, eps=1e-6)
    want = j_hiera_block(bridge.tree_map(jnp.asarray, blk), jnp.asarray(x),
                           num_heads=heads, ws=0, q_stride=None, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=5e-5)
    hd = din // heads
    pad = thb.attention_head_dim(hd)
    assert seen == [(pad, pad, pad, 1.0 / math.sqrt(hd))]


def test_hiera_large_trunk_launch_expectations():
    """SAM2.1-hiera-large per trunk through K4 (chip_smoke's launch
    checks): 48 blocks, the 3 global ones on attention_sm90.cu (head dim
    72 padded to 80), the 45 windowed ones on window_attention_sm90.cu
    (head dim 72; ws 16 in 33 of them), none on window_attention.cu, 3
    shortcut pools; Hiera-T's as before."""
    large, tiny = tsam2("large"), tsam2("tiny")
    old = "vls_window_attention"
    assert chip_smoke.trunk_sm90_blocks(large) == (48, 3)
    assert chip_smoke.trunk_window_launches(large) == {
        kernels.WINDOW_SM90_ENTRY: 45, old: 0}
    assert chip_smoke.trunk_pool_launches(large) == 3
    assert chip_smoke.trunk_sm90_blocks(tiny) == (12, 3)
    assert chip_smoke.trunk_window_launches(tiny) == {
        kernels.WINDOW_SM90_ENTRY: 9, old: 0}
