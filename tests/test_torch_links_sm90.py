"""The row streams of K1's and K4's chains: csrc/layernorm_sm90.cu (every
LayerNorm of K1 and K4) and csrc/pool_sm90.cu (K4's shortcut pool).

CPU: the routes (`kernels.layernorm_entry`, `kernels.maxpool_entry`) at
every main-path shape (`chip_smoke.link_cases`) and at refused ones; the
plans over random shapes (hypothesis): every row / output row covered
exactly once, every bulk copy a multiple of 16 bytes inside its stage,
the ring within the shared-memory budget of two blocks an SM, the grid
within the SMs' blocks; a model of each kernel's tiling (its copies and
lane groups, the statistics summed per lane and over the group's
shuffles) against the plain twins; the twins (`ops.nn.layer_norm`,
`ops.hiera_block.max_pool_2x2`) against the JAX package's `_ln_f32`,
`nn.layer_norm` (fp32, 1e-5) and Hiera's `_max_pool_2x2` (exact). JAX is
imported inside those tests only, so the card tests below run where JAX
is absent.

Card (`requires_cuda`, skipped here): each kernel against its plain twin
at the main-path shapes and at ragged ones (1 row, fewer rows than a
stage, a multiple of a stage plus one, an odd number of output rows).
LayerNorm within one bf16 step of each output element
(`chip_smoke.ln_bound`): the kernel and the twin compute the same fp32
value up to the sums' order and contractions (a few fp32 roundings), so
the two roundings to bf16 differ by at most one step, where the value
lies near a rounding boundary; an element near zero, a cancellation of
x_hat * gamma and beta, also carries those roundings of its terms, so
the bound adds 2^-20 of |x_hat * gamma| + |beta| (~8x a few fp32
roundings at that size). Pool bit-equal (a max rounds
nothing). Two calls bitwise identical, a CUDA-graph replay equal to the
eager call, the K1 / K4 chains on the new entries.
    python -m pytest --noconftest tests/test_torch_links_sm90.py -q
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from video_llava_seg_torch import kernels
from video_llava_seg_torch.config import VideoLlavaConfig
from video_llava_seg_torch.ops import nn as tnn
from video_llava_seg_torch.ops.hiera_block import max_pool_2x2

LN = kernels.LAYERNORM_SM90_ENTRY
POOL = kernels.MAXPOOL_SM90_ENTRY
# the dynamic shared memory an SM holds for two blocks (228 KB less 1 KB
# reserved a block)
SM_SMEM = 233472 - 2 * 1024


def _cfg():
    cfg = VideoLlavaConfig()
    return dataclasses.replace(cfg, seg_token_idx=cfg.llm.vocab_size - 1)


CASES = chip_smoke.link_cases(_cfg())
LN_SHAPES = [shape for k, _, shape, _ in CASES if k == "layernorm"]
POOL_SHAPES = [shape for k, _, shape, _ in CASES if k == "maxpool2x2"]


def test_link_cases_are_the_chains():
    """K1 at 1024 / 1280 columns over 32 x 577 tokens, K4 at 96 / 192 /
    384 / 768 (3 + 4 + 22 + 3 LayerNorms a trunk) and its three shortcut
    maps."""
    assert LN_SHAPES == [(18464, 1024), (18464, 1280), (524288, 96),
                         (131072, 192), (32768, 384), (8192, 768)]
    assert POOL_SHAPES == [(8, 256, 256, 192), (8, 128, 128, 384),
                           (8, 64, 64, 768)]
    trunk = {shape: n for k, p, shape, n in CASES if p.startswith("sam2")}
    assert [trunk[s] for s in LN_SHAPES[2:]] == [3, 4, 22, 3]
    assert [trunk[s] for s in POOL_SHAPES] == [1, 1, 1]


@pytest.mark.parametrize("shape", LN_SHAPES, ids=str)
def test_layernorm_entry_main_path(shape):
    assert kernels.layernorm_entry(*shape) == LN
    assert LN in kernels._SIGNATURES and LN in kernels.LAYERNORM_ROUTES


@pytest.mark.parametrize("shape", [(333, 100), (10, 1288), (7, 4096),
                                   (0, 96), (5, 12)], ids=str)
def test_layernorm_entry_refused(shape):
    """cols % 8, wider than 1280 or no rows: layernorm.cu."""
    assert kernels.layernorm_entry(*shape) == "vls_layernorm_bf16"
    assert kernels.layernorm_sm90_plan(*shape) is None


@pytest.mark.parametrize("shape", POOL_SHAPES, ids=str)
def test_maxpool_entry_main_path(shape):
    assert kernels.maxpool_entry(*shape) == POOL
    assert POOL in kernels._SIGNATURES and POOL in kernels.MAXPOOL_ROUTES


@pytest.mark.parametrize("shape", [(3, 14, 10, 12), (1, 4, 4, 4100),
                                   (2, 1, 8, 64), (0, 4, 4, 64)], ids=str)
def test_maxpool_entry_refused(shape):
    """c % 8, more than 512 vectors a pixel, or an empty output: pool.cu."""
    assert kernels.maxpool_entry(*shape) == "vls_maxpool2x2_bf16"
    assert kernels.maxpool_sm90_plan(*shape) is None


# the kernels' schedules as their producers and consumer lanes walk them
def layernorm_sm90_copies(plan, rows: int, cols: int):
    """The bulk copies of layernorm_sm90.cu under `plan`, block by block:
    [[(first row, rows, bytes), ...] for each block], in the order its
    producer issues them (tile b, b + grid, ...)."""
    out = []
    for b in range(plan.grid):
        out.append([(t * plan.tile_rows,
                     min(plan.tile_rows, rows - t * plan.tile_rows),
                     min(plan.tile_rows, rows - t * plan.tile_rows)
                     * cols * 2)
                    for t in range(b, plan.tiles, plan.grid)])
    return out


def layernorm_sm90_lanes(plan, cols: int):
    """Which consumer lane of layernorm_sm90.cu holds what of a tile:
    {(warp, lane): (row in the tile, [16-byte vectors of the row])}."""
    v = cols // 8
    rpw = 32 // plan.group
    return {(w, lane): (w * rpw + lane // plan.group,
                        [c for c in (j * plan.group + lane % plan.group
                                     for j in range(plan.vecs)) if c < v])
            for w in range(kernels.ROW_STREAM_WARPS) for lane in range(32)}


def maxpool_sm90_copies(plan, n: int, h: int, w: int, c: int):
    """The bulk copies and output runs of pool_sm90.cu under `plan`, block
    by block: [[(item, (input offset, bytes) of row 2oy, of row 2oy + 1,
    (output offset, bytes)), ...] for each block], offsets in bytes."""
    oh, ow = h // 2, w // 2
    out = []
    for b in range(plan.grid):
        mine = []
        for item in range(b, plan.items, plan.grid):
            r, ch = divmod(item, plan.chunks)
            ni, oy = divmod(r, oh)
            ox0 = ch * plan.cw
            ncol = min(plan.cw, ow - ox0)
            src = ((ni * h + 2 * oy) * w + 2 * ox0) * c * 2
            mine.append((item, (src, 4 * ncol * c),
                         (src + w * c * 2, 4 * ncol * c),
                         ((r * ow + ox0) * c * 2, 2 * ncol * c)))
        out.append(mine)
    return out


@pytest.mark.parametrize("shape,plan", [
    ((524288, 96), (4, 3, 64, 12288, 3, 8192, 132)),
    ((131072, 192), (8, 3, 32, 12288, 3, 4096, 132)),
    ((32768, 384), (16, 3, 16, 12288, 3, 2048, 264)),
    ((8192, 768), (32, 3, 8, 12288, 3, 1024, 264)),
    ((18464, 1024), (32, 4, 8, 16384, 3, 2308, 264)),
    ((18464, 1280), (32, 5, 8, 20480, 3, 2308, 264))], ids=str)
def test_layernorm_sm90_plan_main_path(shape, plan):
    """The lane groups, tiles and rings of the chains' widths: 3-5
    vectors a lane, 12-20 KB a stage, 3 stages; one block an SM on the
    long streams of Hiera's first two stages, two elsewhere."""
    got = kernels.layernorm_sm90_plan(*shape)
    assert tuple(got[:7]) == plan
    assert 2 * got.smem <= SM_SMEM


@pytest.mark.parametrize("shape,plan", [
    ((8, 256, 256, 192), (16, 8, 8192, 24576, 3, 132)),
    ((8, 128, 128, 384), (8, 8, 4096, 24576, 3, 132)),
    ((8, 64, 64, 768), (4, 8, 2048, 24576, 3, 264))], ids=str)
def test_maxpool_sm90_plan_main_path(shape, plan):
    got = kernels.maxpool_sm90_plan(*shape)
    assert tuple(got[:6]) == plan
    assert 2 * got.smem <= SM_SMEM


@settings(max_examples=60, deadline=None)
@given(rows=st.integers(1, 20000), v=st.integers(1, 160),
       sms=st.integers(1, 132))
def test_layernorm_sm90_plan_covers(rows, v, sms):
    """Every row in exactly one copy, in order within a block; each copy
    a multiple of 16 bytes within its stage; the ring within two blocks'
    shared memory an SM; the grid within sms x 2; every vector of a tile
    row in exactly one lane, at most 5 a lane."""
    cols = 8 * v
    plan = kernels.layernorm_sm90_plan(rows, cols, sms)
    assert plan is not None
    assert plan.stages == kernels.ROW_STREAM_STAGES
    assert plan.vecs <= kernels.LN_SM90_MAX_VECS
    assert 2 * plan.smem <= SM_SMEM
    assert 1 <= plan.grid <= min(plan.tiles, sms * kernels.ROW_STREAM_BLOCKS)
    seen = np.zeros(rows, np.int64)
    for copies in layernorm_sm90_copies(plan, rows, cols):
        for r0, n, nbytes in copies:
            assert nbytes % 16 == 0 and 0 < nbytes <= plan.stage_bytes
            assert nbytes == 2 * n * cols
            seen[r0:r0 + n] += 1
    assert (seen == 1).all()
    held = {}
    for (w, lane), (row, vecs) in layernorm_sm90_lanes(
            plan, cols).items():
        assert row < plan.tile_rows and len(vecs) <= plan.vecs
        held.setdefault(row, []).extend(vecs)
    assert sorted(held) == list(range(plan.tile_rows))
    assert all(sorted(c) == list(range(v)) for c in held.values())


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 3), h=st.integers(2, 90), w=st.integers(2, 90),
       cv=st.integers(1, 512), sms=st.integers(1, 132))
def test_maxpool_sm90_plan_covers(n, h, w, cv, sms):
    """Every output pixel in exactly one item; each item's two copies the
    two input rows of its windows, multiples of 16 bytes within half a
    stage; the output runs contiguous and whole; the ring within two
    blocks' shared memory an SM; the grid within sms x 2."""
    c = 8 * cv
    plan = kernels.maxpool_sm90_plan(n, h, w, c, sms)
    assert plan is not None
    oh, ow = h // 2, w // 2
    assert plan.stages == kernels.ROW_STREAM_STAGES
    assert plan.cw * c // 8 <= kernels.POOL_SM90_MAX_VECS
    assert 2 * plan.smem <= SM_SMEM
    assert 1 <= plan.grid <= min(plan.items, sms * kernels.ROW_STREAM_BLOCKS)
    seen = np.zeros(n * oh * ow, np.int64)
    row_bytes = w * c * 2
    for items in maxpool_sm90_copies(plan, n, h, w, c):
        for item, (s0, b0), (s1, b1), (o0, ob) in items:
            assert b0 == b1 and b0 % 16 == 0 and s0 % 16 == 0
            assert 0 < b0 <= plan.stage_bytes // 2 and ob == b0 // 2
            assert s1 - s0 == row_bytes and s1 + b1 <= n * h * row_bytes
            # row 2oy of image ni, from column 2 ox0
            img, rest = divmod(s0, h * row_bytes)
            y, x0 = divmod(rest, row_bytes)
            assert y % 2 == 0 and y // 2 < oh and x0 % (4 * c) == 0
            px = o0 // (2 * c)
            assert px == (img * oh + y // 2) * ow + x0 // (4 * c)
            seen[px:px + ob // (2 * c)] += 1
    assert (seen == 1).all()


def layernorm_model(x, gamma, beta, eps, plan):
    """layernorm_sm90.cu's arithmetic in fp32 over its tiling: each copy's
    rows, each row's vectors in the lanes `layernorm_sm90_lanes` gives,
    each lane's sum over its elements in order, then the group's xor
    shuffles; mean = sum / cols, the squared deviations the same way,
    rsqrt(var + eps), ((x - mean) * rstd) * gamma + beta, bf16."""
    rows, cols = x.shape
    v, g = cols // 8, plan.group
    vec = x.float().view(rows, v, 8)
    y = torch.full((rows, cols), float("nan"))
    # [row in tile] -> the lanes' vectors, padded to plan.vecs (-1: none)
    lanes = sorted(layernorm_sm90_lanes(plan, cols).items(),
                   key=lambda kv: (kv[1][0], kv[0][1] % g))
    idx = torch.full((plan.tile_rows, g, plan.vecs), -1)
    for (_, lane), (row, vecs) in lanes:
        idx[row, lane % g, :len(vecs)] = torch.tensor(vecs, dtype=torch.long)
    gam, bet = gamma.float().view(v, 8), beta.float().view(v, 8)
    for copies in layernorm_sm90_copies(plan, rows, cols):
        for r0, n, _ in copies:
            ix = idx[:n]
            have = (ix >= 0)[..., None].expand(n, g, plan.vecs, 8)
            vals = torch.where(have, vec[r0:r0 + n][
                torch.arange(n)[:, None, None], ix.clamp_min(0)],
                torch.zeros(()))
            flat = vals.reshape(n, g, -1)

            def lane_then_group(t):
                s = torch.zeros(n, g)
                for e in range(t.shape[-1]):
                    s = s + t[..., e]
                o = g // 2
                while o:
                    s = s + s[:, torch.arange(g) ^ o]
                    o //= 2
                return s

            mean = lane_then_group(flat) / torch.tensor(cols, dtype=torch.float32)
            d = torch.where(have.reshape(n, g, -1), flat - mean[..., None],
                            torch.zeros(()))
            var = lane_then_group(d * d) / torch.tensor(cols,
                                                        dtype=torch.float32)
            rstd = torch.rsqrt(var + eps)
            out = ((vals - mean[..., None, None]) * rstd[..., None, None]
                   * gam[ix.clamp_min(0)] + bet[ix.clamp_min(0)])
            rows_out = y[r0:r0 + n].view(n, v, 8)
            for li in range(g):
                for j in range(plan.vecs):
                    ok = ix[:, li, j] >= 0
                    rows_out[torch.arange(n)[ok], ix[ok, li, j]] = \
                        out[ok, li, j]
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("rows,cols,sms", [
    (1, 96, 132), (5, 96, 132), (64 * 7 + 1, 96, 3), (300, 192, 5),
    (97, 384, 2), (17, 768, 1), (9, 1024, 132), (33, 1280, 4),
    (70, 40, 3), (41, 8, 2)])
def test_layernorm_model_vs_twin(rows, cols, sms):
    """The kernel's tiling and summation order reproduce the plain twin
    within one bf16 step of every element (the card tests' bound)."""
    g = np.random.default_rng(rows * 7 + cols)
    x = torch.from_numpy(3 * g.standard_normal((rows, cols)) + 0.5).to(
        torch.bfloat16)
    p = {"scale": torch.from_numpy(g.standard_normal(cols)).to(
        torch.bfloat16),
         "bias": torch.from_numpy(g.standard_normal(cols)).to(torch.bfloat16)}
    plan = kernels.layernorm_sm90_plan(rows, cols, sms)
    got = layernorm_model(x, p["scale"], p["bias"], 1e-6, plan).float()
    want = tnn.layer_norm(p, x, 1e-6).float()
    assert not torch.isnan(got).any()
    bound = chip_smoke.ln_bound(x, p["scale"], p["bias"], 1e-6, want)
    assert ((got - want).abs() <= bound).all()


def maxpool_model(x, plan):
    """pool_sm90.cu over its items: the two copied row pieces of each, the
    max of each 2x2 window, written at the item's output run."""
    n, h, w, c = x.shape
    flat = x.reshape(-1)
    out = torch.full((n * (h // 2) * (w // 2) * c,), float("nan"),
                     dtype=x.dtype)
    for items in maxpool_sm90_copies(plan, n, h, w, c):
        for _, (s0, b0), (s1, _), (o0, ob) in items:
            r0 = flat[s0 // 2:(s0 + b0) // 2].view(-1, 2, c)
            r1 = flat[s1 // 2:(s1 + b0) // 2].view(-1, 2, c)
            m = torch.maximum(torch.maximum(r0[:, 0], r0[:, 1]),
                              torch.maximum(r1[:, 0], r1[:, 1]))
            out[o0 // 2:(o0 + ob) // 2] = m.reshape(-1)
    return out.view(n, h // 2, w // 2, c)


@pytest.mark.parametrize("shape,sms", [
    ((2, 6, 10, 192), 3), ((1, 7, 9, 24), 1), ((2, 34, 70, 384), 5),
    ((1, 2, 2, 768), 132), ((3, 16, 16, 4096), 2)], ids=str)
def test_maxpool_model_vs_twin(shape, sms):
    """The items' pieces and output runs rebuild the plain pool bit for
    bit, odd sides (VALID: the last row / column dropped) included."""
    g = np.random.default_rng(sum(shape))
    x = torch.from_numpy(g.standard_normal(shape)).to(torch.bfloat16)
    plan = kernels.maxpool_sm90_plan(*shape, sms)
    assert torch.equal(maxpool_model(x, plan), max_pool_2x2(x))


@pytest.mark.parametrize("cols", [96, 192, 384, 768, 1024, 1280])
def test_layer_norm_twin_vs_jax(cols):
    """`ops.nn.layer_norm` (the kernels' plain twin) against the JAX
    package's K4 LayerNorm (`_ln_f32`) and its `nn.layer_norm` (K1's XLA
    twin), fp32 inputs from a seed, within 1e-5."""
    import jax.numpy as jnp

    from video_llava_seg_tpu.ops import nn as jnn
    from video_llava_seg_tpu.ops.hiera_block import _ln_f32

    g = np.random.default_rng(cols)
    x = (2 * g.standard_normal((37, cols)) + 0.3).astype(np.float32)
    scale = (1 + 0.1 * g.standard_normal(cols)).astype(np.float32)
    bias = (0.1 * g.standard_normal(cols)).astype(np.float32)
    got = tnn.layer_norm({"scale": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)},
                         torch.from_numpy(x), 1e-6).numpy()
    want_k4 = np.asarray(_ln_f32(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), 1e-6))
    want_k1 = np.asarray(jnn.layer_norm(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x), 1e-6))
    np.testing.assert_allclose(got, want_k4, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_k1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 192), (1, 7, 9, 24),
                                   (3, 6, 10, 16)], ids=str)
def test_max_pool_twin_vs_jax(shape):
    """`ops.hiera_block.max_pool_2x2` (pool_sm90.cu's twin) against the
    JAX package's Hiera `_max_pool_2x2`, exactly, odd sides included."""
    import jax.numpy as jnp

    from video_llava_seg_tpu.models.sam2.hiera import _max_pool_2x2

    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    got = max_pool_2x2(torch.from_numpy(x)).numpy()
    want = np.asarray(_max_pool_2x2(jnp.asarray(x), (2, 2)))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_wrappers_name_their_routes():
    """A forced route must be one of the wrapper's entries."""
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="route"):
        kernels.layernorm(x, x[0], x[0], 1e-5, route="vls_nope")
    with pytest.raises(ValueError, match="route"):
        kernels.maxpool2x2(x.view(1, 2, 2, 8), route="vls_nope")
    assert set(kernels.LAYERNORM_LAUNCHES.snapshot()) == set(
        kernels.LAYERNORM_ROUTES)
    assert set(kernels.MAXPOOL_LAUNCHES.snapshot()) == set(
        kernels.MAXPOOL_ROUTES)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ln_inputs(rows, cols, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (3 * torch.randn((rows, cols), generator=g, device=dev)
         + 0.5).to(torch.bfloat16)
    gam = torch.randn(cols, generator=g, device=dev).to(torch.bfloat16)
    bet = torch.randn(cols, generator=g, device=dev).to(torch.bfloat16)
    return x, gam, bet


# the main-path widths at ragged row counts: one row, fewer rows than a
# stage, a multiple of a stage plus one, and the K1 / K4 shapes
LN_CARD = ([(1, 96), (5, 96), (64 * 37 + 1, 96), (33, 192), (16 * 5 + 1, 384),
            (3, 768), (8 * 11 + 1, 1024), (7, 1280), (8 * 2309 + 1, 1280),
            (70, 40)] + LN_SHAPES)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows,cols", LN_CARD, ids=str)
def test_layernorm_sm90_card(dev, rows, cols):
    x, gam, bet = _ln_inputs(rows, cols, dev, rows + cols)
    before = kernels.LAYERNORM_LAUNCHES.snapshot()
    got = kernels.layernorm(x, gam, bet, 1e-6)
    assert kernels.LAYERNORM_LAUNCHES.snapshot()[LN] == before[LN] + 1
    want = tnn.layer_norm({"scale": gam, "bias": bet}, x.float(), 1e-6)
    torch.cuda.synchronize()
    bound = chip_smoke.ln_bound(x, gam, bet, 1e-6, want)
    assert ((got.float() - want).abs() <= bound).all()
    assert torch.equal(kernels.layernorm(x, gam, bet, 1e-6), got)


POOL_CARD = ([(2, 6, 10, 192), (1, 7, 9, 24), (3, 2, 2, 768),
              (8, 130, 258, 192), (1, 5, 64, 4096)] + POOL_SHAPES)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", POOL_CARD, ids=str)
def test_maxpool_sm90_card(dev, shape):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    before = kernels.MAXPOOL_LAUNCHES.snapshot()
    got = kernels.maxpool2x2(x)
    assert kernels.MAXPOOL_LAUNCHES.snapshot()[POOL] == before[POOL] + 1
    assert torch.equal(got, max_pool_2x2(x))
    assert torch.equal(kernels.maxpool2x2(x), got)
    if shape[1] % 2 == 0 and shape[2] % 2 == 0:
        old = kernels.maxpool2x2(x, route="vls_maxpool2x2_bf16")
        assert torch.equal(old, got)


@pytest.mark.requires_cuda
def test_links_sm90_cuda_graph(dev):
    """Both kernels captured in a CUDA graph replay what they computed
    eagerly (no workspace, nothing to reset)."""
    x, gam, bet = _ln_inputs(4097, 384, dev, 3)
    m = torch.randn((2, 34, 66, 192), device=dev).to(torch.bfloat16)
    eager = (kernels.layernorm(x, gam, bet, 1e-6), kernels.maxpool2x2(m))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.layernorm(x, gam, bet, 1e-6)
        kernels.maxpool2x2(m)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (kernels.layernorm(x, gam, bet, 1e-6), kernels.maxpool2x2(m))
    for t in outs:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(outs[0], eager[0]) and torch.equal(outs[1], eager[1])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("proj", [False, True])
def test_chains_take_the_row_streams(dev, proj):
    """A K1 layer takes layernorm_sm90.cu twice; a K4 q-pool block twice
    and pool_sm90.cu once for its shortcut; none of the old entries."""
    from video_llava_seg_torch.models import vit
    from video_llava_seg_torch.ops.hiera_block import hiera_block
    from video_llava_seg_torch.ops.vit_block import vit_layer

    g = torch.Generator(device=dev).manual_seed(5)
    counts = (kernels.LAYERNORM_LAUNCHES, kernels.MAXPOOL_LAUNCHES)
    vc = dataclasses.replace(_cfg().vision, num_layers=1, hidden_size=128,
                             intermediate_size=256, num_heads=2)
    layer = vit.init(vc, g, dev, torch.bfloat16)["layers"][0]
    x = torch.randn((2, 50, 128), generator=g, device=dev).to(torch.bfloat16)
    before = [c.snapshot() for c in counts]
    vit_layer(layer, x, num_heads=2, eps=1e-5)
    after = [c.snapshot() for c in counts]
    assert after[0][LN] - before[0][LN] == 2
    assert after[0]["vls_layernorm_bf16"] == before[0]["vls_layernorm_bf16"]
    din, dout = 96, (192 if proj else 96)

    def dense(i, o):
        return {"kernel": (torch.randn((i, o), generator=g, device=dev)
                           / math.sqrt(i)).to(torch.bfloat16),
                "bias": torch.zeros(o, device=dev, dtype=torch.bfloat16)}

    def ln(d):
        return {"scale": torch.ones(d, device=dev, dtype=torch.bfloat16),
                "bias": torch.zeros(d, device=dev, dtype=torch.bfloat16)}

    blk = {"norm1": ln(din), "norm2": ln(dout), "qkv": dense(din, 3 * dout),
           "proj_attn": dense(dout, dout),
           "mlp": {"layers": [dense(dout, 4 * dout), dense(4 * dout, dout)]}}
    if proj:
        blk["proj"] = dense(din, dout)
    x = torch.randn((2, 16, 16, din), generator=g, device=dev).to(
        torch.bfloat16)
    before = [c.snapshot() for c in counts]
    hiera_block(blk, x, num_heads=1 if dout == 96 else 2, ws=8,
                q_stride=(2, 2))
    after = [c.snapshot() for c in counts]
    assert after[0][LN] - before[0][LN] == 2
    assert after[1][POOL] - before[1][POOL] == 1
    assert after[0]["vls_layernorm_bf16"] == before[0]["vls_layernorm_bf16"]
    assert after[1]["vls_maxpool2x2_bf16"] == before[1]["vls_maxpool2x2_bf16"]
