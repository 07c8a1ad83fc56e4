"""K8's row quantizers on Hopper: csrc/w8a8_rows_sm90.cu (`ln_quant_rows`,
`quant_rows` of every W8A8 ViT layer of CLIP-L and RADIO-H).

CPU: the route (`kernels.quant_rows_entry`) at every main-path shape
(`chip_smoke.w8a8_row_cases`) and at refused ones; the plan over random
shapes (hypothesis): every row covered exactly once, every bulk copy a
multiple of 16 bytes inside its stage, the ring within the shared memory
of the blocks an SM, the grid within the SMs' blocks, every vector of a
tile row in exactly one lane; a model of the kernel's tiling (its copies
and lane groups, the statistics summed per lane and over the group's
shuffles, the group amax, the codes by the rounding add) against the
plain twin (`kernels.quant_rows_plain`): bit-equal for `quant_rows`,
within the card criteria for `ln_quant_rows`, an all-zero row and a row
with one nonzero value among the rows; the rounding add against
clamp(round(y / s)) for every bf16 value y; the kernel's quotient (a
reciprocal a row, a Markstein correction, a power-of-two prescale)
against the IEEE quotient for every bf16 value at ~1,300 scales; the
twin of `ln_quant_rows`
against the JAX package's `_ln_f32(...).astype(bf16)` then
`_quant_rows_f32` (K8's own steps, vit_block.py:240-243). JAX is imported
inside that test only, so the card tests below run where JAX is absent.

Card (`requires_cuda`, skipped here): the kernel against its twin at the
main-path shapes and at ragged ones (1 row, fewer rows than a tile, a
multiple of a tile plus one), gamma / beta in bf16 and fp32: `quant_rows`
bit-equal (q and scale); `ln_quant_rows` within one int8 step, under
1e-3 of the elements differing, the scales within rtol 1e-2 (the norm
sums in another order, so a bf16 value may move by one step and its code
by one at a rounding boundary: tests/test_torch_kernels_cuda.py::
test_quant_rows_bit_exact's criteria); two calls bitwise identical; the
codes of every finite bf16 value at 2,000+ scales equal to the IEEE
division's; a CUDA-graph replay equal to the eager call; a W8A8 layer
taking the new entry four times.
    python -m pytest --noconftest tests/test_torch_w8a8_rows_sm90.py -q
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
from video_llava_seg_torch.ops.quantization import (
    quantize_activations_rowwise,
)

ENTRY = kernels.QUANT_ROWS_SM90_ENTRY
EPS = 1e-6


def _cfg():
    cfg = VideoLlavaConfig()
    return dataclasses.replace(cfg, seg_token_idx=cfg.llm.vocab_size - 1)


CASES = chip_smoke.w8a8_row_cases(_cfg())
MAIN = sorted({(fn == "ln_quant_rows", shape) for fn, _, shape, _ in CASES})


def test_row_cases_are_k8():
    """CLIP-L (1024 / 4096, 23 layers) and RADIO-H (1280 / 5120, 32
    layers) over 32 frames of 577 tokens: two ln_quant_rows and two
    quant_rows a layer."""
    assert [(fn, shape, n) for fn, _, shape, n in CASES] == [
        ("ln_quant_rows", (18464, 1024), 46),
        ("quant_rows", (18464, 1024), 23),
        ("quant_rows", (18464, 4096), 23),
        ("ln_quant_rows", (18464, 1280), 64),
        ("quant_rows", (18464, 1280), 32),
        ("quant_rows", (18464, 5120), 32)]


@pytest.mark.parametrize("ln,shape", MAIN, ids=str)
def test_quant_rows_entry_main_path(ln, shape):
    assert kernels.quant_rows_entry(*shape, ln) == ENTRY
    assert ENTRY in kernels._SIGNATURES and ENTRY in kernels.QUANT_ROWS_ROUTES


@pytest.mark.parametrize("ln,shape", [
    (False, (333, 100)), (True, (333, 100)), (True, (10, 1288)),
    (True, (18464, 4096)), (False, (7, 5128)), (False, (5, 6144)),
    (True, (0, 1024)), (False, (0, 1024))], ids=str)
def test_quant_rows_entry_refused(ln, shape):
    """cols % 8, wider than 1280 after a LayerNorm or 5120 without, or no
    rows: w8a8.cu."""
    assert kernels.quant_rows_entry(*shape, ln) == "vls_quant_rows"
    assert kernels.quant_rows_sm90_plan(*shape, ln) is None


@pytest.mark.parametrize("ln,shape,plan", [
    (True, (18464, 1024), (32, 4, 8, 16384, 3, 2308, 264)),
    (False, (18464, 1024), (32, 4, 8, 16384, 3, 2308, 264)),
    (True, (18464, 1280), (32, 5, 8, 20480, 3, 2308, 264)),
    (False, (18464, 1280), (32, 5, 8, 20480, 3, 2308, 264)),
    (False, (18464, 4096), (32, 16, 8, 65536, 3, 2308, 132)),
    (False, (18464, 5120), (32, 20, 8, 81920, 2, 2308, 132))], ids=str)
def test_quant_rows_sm90_plan_main_path(ln, shape, plan):
    """A row a warp at every main-path width; 4 / 5 vectors a lane and two
    blocks an SM at d, 16 / 20 raw vectors a lane and one block an SM at
    fc1's widths (64 / 80 KB stages: 3 fit a block at 4096, 2 at 5120)."""
    got = kernels.quant_rows_sm90_plan(*shape, ln)
    assert tuple(got[:7]) == plan
    blocks = -(-got.grid // kernels.H100_SMS)
    assert blocks * (got.smem + kernels.SMEM_RESERVED) <= kernels.SMEM_SM


# the kernel's schedule as its producer and consumer lanes walk it
def copies(plan, rows: int, cols: int):
    """The bulk copies of w8a8_rows_sm90.cu under `plan`, block by block:
    [[(first row, rows, bytes), ...] for each block], in the order its
    producer starts them (tile b, b + grid, ...)."""
    return [[(t * plan.tile_rows,
              min(plan.tile_rows, rows - t * plan.tile_rows),
              min(plan.tile_rows, rows - t * plan.tile_rows) * cols * 2)
             for t in range(b, plan.tiles, plan.grid)]
            for b in range(plan.grid)]


def lanes(plan, cols: int):
    """Which consumer lane holds what of a tile: {(warp, lane): (row in
    the tile, [16-byte vectors of the row])}."""
    v = cols // 8
    rpw = 32 // plan.group
    return {(w, lane): (w * rpw + lane // plan.group,
                        [c for c in (j * plan.group + lane % plan.group
                                     for j in range(plan.vecs)) if c < v])
            for w in range(kernels.ROW_STREAM_WARPS) for lane in range(32)}


@settings(max_examples=60, deadline=None)
@given(rows=st.integers(1, 20000), v=st.integers(1, 700), ln=st.booleans(),
       sms=st.integers(1, 132))
def test_quant_rows_sm90_plan_covers(rows, v, ln, sms):
    """Refused exactly past 5 vectors a lane after a LayerNorm and 20
    without; otherwise every row in exactly one copy, each copy a multiple
    of 16 bytes within its stage, the ring within the shared memory of the
    blocks an SM holds (and of one block), the grid within the SMs'
    blocks, every vector of a tile row in exactly one lane, at most vecs
    a lane, vecs an instance of the kernel."""
    cols = 8 * v
    plan = kernels.quant_rows_sm90_plan(rows, cols, ln, sms)
    group = next(g for g in (1, 2, 4, 8, 16, 32)
                 if -(-v // g) <= kernels.LN_SM90_LANE_VECS or g == 32)
    need = -(-v // group)
    limit = (kernels.QUANT_ROWS_SM90_LN_VECS if ln
             else kernels.QUANT_ROWS_SM90_MAX_VECS)
    if need > limit:
        assert plan is None
        return
    assert plan is not None and plan.group == group
    assert plan.vecs in kernels.QUANT_ROWS_SM90_VECS and plan.vecs >= need
    assert kernels.QUANT_ROWS_SM90_MIN_STAGES <= plan.stages \
        <= kernels.ROW_STREAM_STAGES
    assert plan.smem <= kernels.SMEM_BLOCK_MAX
    blocks = -(-plan.grid // sms)
    assert blocks <= kernels.ROW_STREAM_BLOCKS
    assert blocks * (plan.smem + kernels.SMEM_RESERVED) <= kernels.SMEM_SM
    assert 1 <= plan.grid <= plan.tiles
    seen = np.zeros(rows, np.int64)
    for block in copies(plan, rows, cols):
        for r0, n, nbytes in block:
            assert nbytes % 16 == 0 and 0 < nbytes <= plan.stage_bytes
            assert nbytes == 2 * n * cols
            seen[r0:r0 + n] += 1
    assert (seen == 1).all()
    held = {}
    for (_, _), (row, vecs) in lanes(plan, cols).items():
        assert row < plan.tile_rows and len(vecs) <= plan.vecs
        held.setdefault(row, []).extend(vecs)
    assert sorted(held) == list(range(plan.tile_rows))
    assert all(sorted(c) == list(range(v)) for c in held.values())


MAGIC = 12582912.0  # 1.5 x 2^23


def codes(y, s):
    """The kernel's codes: the clamped IEEE quotient plus 1.5 x 2^23 in
    fp32, the low byte of the sum as int8."""
    r = torch.clamp(y / s, -127.0, 127.0)
    bits = (r + torch.tensor(MAGIC)).view(torch.int32)
    return (bits & 0xFF).to(torch.uint8).view(torch.int8)


def quant_rows_model(x, gamma, beta, eps, plan):
    """w8a8_rows_sm90.cu's arithmetic in fp32 over its tiling: each copy's
    rows, each row's vectors in the lanes `lanes` gives; after a LayerNorm
    (gamma given) each lane's sum over its elements in order, then the
    group's xor shuffles, mean = sum / cols, the squared
    deviations by fused multiply-adds (fp64 products rounded once), rstd,
    ((x - mean) * rstd) * gamma + beta rounded to bf16; the group's amax,
    s = amax / 127 (1 for a zero row), the codes by the rounding add of
    the IEEE quotient (the kernel's Markstein quotient equals it:
    `test_fast_quotient_is_ieee`)."""
    rows, cols = x.shape
    v, g, nv = cols // 8, plan.group, plan.vecs
    vec = x.float().view(rows, v, 8)
    q = torch.zeros((rows, cols), dtype=torch.int8)
    scale = torch.full((rows, 1), float("nan"))
    idx = torch.full((plan.tile_rows, g, nv), -1)
    for (_, lane), (row, vecs) in lanes(plan, cols).items():
        idx[row, lane % g, :len(vecs)] = torch.tensor(vecs, dtype=torch.long)
    perm = [torch.arange(g) ^ o for o in
            (g >> k for k in range(1, g.bit_length())) if o]
    ln = gamma is not None
    if ln:
        gb = torch.stack([gamma.float().view(v, 8), beta.float().view(v, 8)])
    for block in copies(plan, rows, cols):
        for r0, n, _ in block:
            ix = idx[:n]
            have = (ix >= 0)[..., None].expand(n, g, nv, 8)
            vals = torch.where(have, vec[r0:r0 + n][
                torch.arange(n)[:, None, None], ix.clamp_min(0)],
                torch.zeros(()))
            y = vals
            if ln:
                s = torch.zeros(n, g)
                for j in range(nv):
                    for e in range(8):
                        s = s + vals[:, :, j, e]
                for pm in perm:
                    s = s + s[:, pm]
                mean = s / torch.tensor(cols, dtype=torch.float32)
                sq = torch.zeros(n, g)
                for j in range(nv):
                    ok = ix[:, :, j] >= 0
                    for e in range(8):
                        d = vals[:, :, j, e] - mean
                        fma = (d.double() * d.double() + sq.double()).float()
                        sq = torch.where(ok, fma, sq)
                for pm in perm:
                    sq = sq + sq[:, pm]
                rstd = torch.rsqrt(sq / torch.tensor(cols, dtype=torch.float32)
                                   + eps)
                gam = gb[0][ix.clamp_min(0)]
                bet = gb[1][ix.clamp_min(0)]
                y = ((vals - mean[..., None, None]) * rstd[..., None, None]
                     * gam + bet)
                y = torch.where(have, y.to(torch.bfloat16).float(),
                                torch.zeros(()))
            amax = y.abs().amax(dim=(2, 3))
            for pm in perm:
                amax = torch.maximum(amax, amax[:, pm])
            sc = torch.where(amax == 0, torch.ones_like(amax),
                             amax / torch.full_like(amax, 127.0))
            out = codes(y, sc[..., None, None])
            rows_q = q[r0:r0 + n].view(n, v, 8)
            for li in range(g):
                for j in range(nv):
                    ok = ix[:, li, j] >= 0
                    rows_q[torch.arange(n)[ok], ix[ok, li, j]] = out[ok, li, j]
            scale[r0:r0 + n, 0] = sc[:, 0]
    return q, scale


def _rows(rows, cols, seed):
    g = np.random.default_rng(seed)
    x = (3 * g.standard_normal((rows, cols)) + 0.5) * np.linspace(
        0.1, 4.0, rows)[:, None]
    x[0] = 0.0
    if rows > 1:
        x[1] = 0.0
        x[1, cols // 3] = -2.5
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("rows,cols,sms", [
    (1, 1024, 132), (5, 1280, 132), (8 * 7 + 1, 1024, 3), (17, 4096, 2),
    (9, 5120, 4), (33, 96, 3), (70, 40, 2), (12, 2048, 1)])
def test_quant_rows_model_vs_twin(rows, cols, sms):
    """The kernel's tiling and codes reproduce `quant_rows` bit for bit
    (q and scale), a zero row (scale 1, q 0) and a row of one nonzero
    value among them."""
    x = _rows(rows, cols, rows * 7 + cols)
    plan = kernels.quant_rows_sm90_plan(rows, cols, False, sms)
    q, s = quant_rows_model(x, None, None, 0.0, plan)
    wq, ws = quantize_activations_rowwise(x)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    assert float(s[0]) == 1.0 and not q[0].any()
    if rows > 1:
        assert int(q[1, cols // 3]) == -127 and int(q[1].abs().sum()) == 127


@pytest.mark.parametrize("gdt", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("rows,cols,sms", [
    (1, 1024, 132), (5, 1280, 132), (8 * 7 + 1, 1024, 3), (40, 1280, 2),
    (33, 96, 3), (70, 40, 2)])
def test_ln_quant_rows_model_vs_twin(rows, cols, sms, gdt):
    """After a LayerNorm, within the card criteria of the twin: at most
    one int8 step, under 1e-3 of the elements differing (at these sizes:
    at most one element in 1000, and one in a row of fewer), the scales
    within rtol 1e-2; the zero row and the one-value row included."""
    x = _rows(rows, cols, rows * 11 + cols)
    g = np.random.default_rng(cols)
    gam = torch.from_numpy(g.random(cols) + 0.5).to(gdt)
    bet = torch.from_numpy(0.1 * g.standard_normal(cols)).to(gdt)
    plan = kernels.quant_rows_sm90_plan(rows, cols, True, sms)
    q, s = quant_rows_model(x, gam, bet, EPS, plan)
    wq, ws = kernels.quant_rows_plain(x, gam, bet, EPS)
    diff = (q.int() - wq.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).sum().item() <= max(1, q.numel() // 1000)
    torch.testing.assert_close(s, ws, rtol=1e-2, atol=0)


@pytest.mark.parametrize("amax", [1.0, 0.0625, 3.7265625, 1e-30, 3e38,
                                  127.0, 0.5], ids=str)
def test_rounding_add_is_rint_for_every_bf16(amax):
    """The rounding add gives clamp(round(y / s), -127, 127) (half to
    even) for every finite bf16 value y at s = amax / 127 (and s = 1):
    what the kernel computes in place of rintf and the conversion."""
    y = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).float()
    y = y[torch.isfinite(y)]
    for s in (torch.tensor(amax) / torch.tensor(127.0), torch.tensor(1.0)):
        want = torch.clamp(torch.round(y / s), -127, 127).to(torch.int8)
        assert torch.equal(codes(y, s), want)


def prescale(s):
    """The kernel's power of two for a row of scale s (`divisor`): s 2^k
    within [2^-100, 2^120]."""
    return np.float32(2.0 ** 64 if s < 2.0 ** -100
                      else 2.0 ** -64 if s > 2.0 ** 120 else 1.0)


def fast_quotient(y, s):
    """The kernel's quotient y / s (numpy fp32 arrays, `code`): y' = y p2,
    s' = s p2, rc = RN(1 / s'), q0 = RN(y' rc), the residual RN(y' - s' q0)
    by one fma, then RN(q0 + e rc) by another. The fmas in fp64: s' q0 and
    e rc are exact there (two 24-bit significands), and so is y' - s' q0
    (it cancels to a few bits); q0 + e rc may round in fp64, and where
    that lands it on an fp32 midpoint the sum is redone exactly."""
    from fractions import Fraction

    p2 = prescale(s)
    y = y.astype(np.float32) * p2
    s = np.float32(s) * p2
    rc = np.float32(1.0) / s
    q0 = y * rc
    e = (y.astype(np.float64) - np.float64(s) * q0.astype(np.float64)
         ).astype(np.float32)
    t = q0.astype(np.float64) + e.astype(np.float64) * np.float64(rc)
    q = t.astype(np.float32)
    other = np.nextafter(q, np.where(t > q, np.float32(np.inf),
                                     np.float32(-np.inf)))
    mid = (t != q) & (t == (q.astype(np.float64) + other.astype(
        np.float64)) / 2)
    for i in np.flatnonzero(mid):
        exact = Fraction(float(q0[i])) + Fraction(float(e[i])) * Fraction(
            float(rc))
        lo, hi = sorted((q[i], other[i]))
        d_lo, d_hi = exact - Fraction(float(lo)), Fraction(float(hi)) - exact
        pick = lo if d_lo < d_hi or (d_lo == d_hi and not (
            lo.view(np.int32) & 1)) else hi
        q[i] = pick
    return q


FINITE_BF16 = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(
    torch.bfloat16).float().numpy()
FINITE_BF16 = FINITE_BF16[np.isfinite(FINITE_BF16)]


@pytest.mark.parametrize("m", [1.0, 1.0078125, 1.5, 1.9921875, 1.3359375])
def test_fast_quotient_is_ieee(m):
    """The kernel's quotient (`fast_quotient`) gives the IEEE quotient's
    codes for every finite bf16 value y with |y| <= amax (the values a
    row of that scale holds) at s = RN(amax / 127), amax = m x 2^k a bf16
    value, k from -133 (a subnormal amax) to 127 (the prescale's both
    ends among them). The quotients are equal where the residual is
    exact (|y 2^k'| >= 2^-103) and the quotient normal; elsewhere both
    are under 1/8 (code 0)."""
    one = torch.tensor(1.0)
    for k in range(-133, 128):
        amax = np.float32(float(torch.tensor(m * 2.0 ** k).to(torch.bfloat16)))
        if amax == 0 or not np.isfinite(amax):
            continue
        s = amax / np.float32(127.0)
        y = FINITE_BF16[np.abs(FINITE_BF16) <= amax]
        want = y / s
        got = fast_quotient(y, s)
        exact = (np.abs(y * prescale(s)) >= 2.0 ** -103) & (
            np.abs(want) >= 2.0 ** -126)
        assert np.array_equal(got[exact], want[exact]), (m, k)
        assert (np.abs(got[~exact]) < 0.125).all(), (m, k)
        assert (np.abs(want[~exact]) < 0.125).all(), (m, k)
        assert torch.equal(codes(torch.from_numpy(got), one),
                           codes(torch.from_numpy(want), one)), (m, k)


@pytest.mark.parametrize("cols", [1024, 1280])
def test_ln_quant_rows_twin_vs_jax(cols):
    """`kernels.quant_rows_plain` after a LayerNorm (the kernel's twin)
    against K8's steps in the JAX package: `_ln_f32(...).astype(bf16)`
    then `_quant_rows_f32`. The bf16 norms agree but for the sums' order;
    on the rows where they are equal, q and the scale are equal bit for
    bit; elsewhere q is within one step and the scale within rtol 1e-2."""
    import jax.numpy as jnp

    from video_llava_seg_tpu.ops.hiera_block import _ln_f32
    from video_llava_seg_tpu.ops.vit_block import _quant_rows_f32

    g = np.random.default_rng(cols)
    x = torch.from_numpy(2 * g.standard_normal((64, cols)) + 0.3).to(
        torch.bfloat16)
    gam = torch.from_numpy(g.random(cols) + 0.5).to(torch.bfloat16)
    bet = torch.from_numpy(0.1 * g.standard_normal(cols)).to(torch.bfloat16)
    q, s = kernels.quant_rows_plain(x, gam, bet, EPS)
    xf = jnp.asarray(x.float().numpy())
    xn = _ln_f32(xf, jnp.asarray(gam.float().numpy()),
                 jnp.asarray(bet.float().numpy()), EPS).astype(jnp.bfloat16)
    jq, js = _quant_rows_f32(xn.astype(jnp.float32))
    jq, js = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js))
    tn = tnn.layer_norm({"scale": gam, "bias": bet}, x, EPS).float()
    same = (tn == torch.from_numpy(np.array(xn.astype(
        jnp.float32)))).all(dim=1)
    assert same.float().mean() > 0.5
    assert torch.equal(q[same], jq[same]) and torch.equal(s[same], js[same])
    assert (q.int() - jq.int()).abs().max() <= 1
    torch.testing.assert_close(s, js, rtol=1e-2, atol=0)


def test_wrappers_name_their_routes():
    """A forced route must be one of the wrappers' entries; the counter
    has one count a C entry."""
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="route"):
        kernels.quant_rows(x, route="vls_nope")
    assert set(kernels.QUANT_ROWS_LAUNCHES.snapshot()) == set(
        kernels.QUANT_ROWS_ROUTES)
    assert kernels.QUANT_ROWS_ROUTES == ("vls_quant_rows", ENTRY)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(rows, cols, dev, seed, gdt=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (3 * torch.randn((rows, cols), generator=g, device=dev)
         + 0.5).to(torch.bfloat16)
    x[0] = 0
    gam = (torch.rand(cols, generator=g, device=dev) + 0.5).to(gdt)
    bet = (0.1 * torch.randn(cols, generator=g, device=dev)).to(gdt)
    return x, gam, bet


# the main-path widths at ragged row counts (one row, fewer rows than a
# tile of 8, a multiple of a tile plus one) and the K8 shapes
CARD = ([(1, 1024), (5, 1280), (8 * 37 + 1, 1280), (3, 4096),
         (8 * 11 + 1, 5120), (1, 5120), (70, 40), (33, 96)]
        + [shape for _, shape in MAIN])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("gdt", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("rows,cols", sorted(set(CARD)), ids=str)
def test_quant_rows_sm90_card(dev, rows, cols, gdt):
    x, gam, bet = _inputs(rows, cols, dev, rows + cols, gdt)
    before = kernels.QUANT_ROWS_LAUNCHES.snapshot()
    q, s = kernels.quant_rows(x)
    wq, ws = quantize_activations_rowwise(x)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    q2, s2 = kernels.quant_rows(x)
    assert torch.equal(q2, q) and torch.equal(s2, s)
    want = 2
    if kernels.quant_rows_sm90_plan(rows, cols, True) is not None:
        q, s = kernels.ln_quant_rows(x, gam, bet, EPS)
        chip_smoke.quant_rows_agree(
            "ln_quant_rows", "ln_quant_rows", (q, s),
            kernels.quant_rows_plain(x, gam, bet, EPS))
        q2, s2 = kernels.ln_quant_rows(x, gam, bet, EPS)
        assert torch.equal(q2, q) and torch.equal(s2, s)
        want += 2
    torch.cuda.synchronize()
    after = kernels.QUANT_ROWS_LAUNCHES.snapshot()
    assert after[ENTRY] - before[ENTRY] == want
    assert after["vls_quant_rows"] == before["vls_quant_rows"]


# the scales of the card test of the codes: amax = m x 2^k, m these
# mantissas (bf16), k from -133 (a subnormal amax) to 127
CODE_MANTISSAS = (1.0, 1.0078125, 1.25, 1.3359375, 1.5, 1.6640625, 1.75,
                  1.9921875)


@pytest.mark.requires_cuda
def test_codes_every_bf16_at_many_scales(dev):
    """The kernel's quotient (one reciprocal a row and a Markstein
    correction at scales in [2^-100, 2^120], __fdiv_rn elsewhere) gives
    the codes of the IEEE division (`quantize_activations_rowwise` on the
    card) for every finite bf16 value y with |y| <= amax, the values a
    row of that scale holds, at 2,000+ scales s = RN(amax / 127): rows of
    amax followed by those values, 4,095 a row, zero-padded."""
    allv = torch.arange(1 << 16, dtype=torch.int32, device=dev).to(
        torch.int16).view(torch.bfloat16)
    allv = allv[torch.isfinite(allv)]
    mag = allv.float().abs()
    cols = 4096
    blocks, seen = [], set()
    for m in CODE_MANTISSAS:
        for k in range(-133, 128):
            amax = torch.tensor(m * 2.0 ** k).to(torch.bfloat16)
            a = float(amax)
            if a == 0 or not math.isfinite(a) or a in seen:
                continue
            seen.add(a)
            y = allv[mag <= a]
            n = -(-y.numel() // (cols - 1))
            body = torch.zeros(n * (cols - 1), dtype=torch.bfloat16,
                               device=dev)
            body[:y.numel()] = y
            head = torch.full((n, 1), a, dtype=torch.bfloat16, device=dev)
            blocks.append(torch.cat([head, body.view(n, cols - 1)], dim=1))
    x = torch.cat(blocks)
    assert len(seen) > 2000
    q, s = kernels.quant_rows(x)
    wq, ws = quantize_activations_rowwise(x)
    assert torch.equal(s, ws)
    assert torch.equal(q, wq)


@pytest.mark.requires_cuda
def test_quant_rows_sm90_cuda_graph(dev):
    """Both forms captured in a CUDA graph replay what they computed
    eagerly (no workspace, nothing to reset)."""
    x, gam, bet = _inputs(4097, 1024, dev, 3)
    f = torch.randn((2049, 4096), device=dev).to(torch.bfloat16)

    def calls():
        return (*kernels.ln_quant_rows(x, gam, bet, EPS),
                *kernels.quant_rows(f))

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    for t in outs:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, eager))


@pytest.mark.requires_cuda
def test_w8a8_layer_takes_the_row_kernel(dev):
    """A W8A8 layer at CLIP-L's width takes w8a8_rows_sm90.cu four times
    (its LayerNorms' bf16 scale and bias as stored) and w8a8.cu's row
    quantizers never, within W8A8_BOUND of `vit_layer_plain`."""
    from video_llava_seg_torch.models import vit
    from video_llava_seg_torch.ops.quantization import quantize_tree
    from video_llava_seg_torch.ops.vit_block import vit_layer, vit_layer_plain

    g = torch.Generator(device=dev).manual_seed(5)
    vc = dataclasses.replace(_cfg().vision, num_layers=1)
    layer = quantize_tree(vit.init(vc, g, dev, torch.bfloat16)["layers"][0],
                          8, act_quant=True)
    assert layer["layer_norm1"]["scale"].dtype == torch.bfloat16
    x = torch.randn((2, 577, vc.hidden_size), generator=g,
                    device=dev).to(torch.bfloat16)
    kw = dict(num_heads=vc.num_heads, eps=vc.layernorm_eps, kv_len=577)
    before = kernels.QUANT_ROWS_LAUNCHES.snapshot()
    got = vit_layer(layer, x, **kw)
    after = kernels.QUANT_ROWS_LAUNCHES.snapshot()
    assert after[ENTRY] - before[ENTRY] == 4
    assert after["vls_quant_rows"] == before["vls_quant_rows"]
    want = vit_layer_plain(layer, x, **kw)
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel < chip_smoke.BOUNDS["K8"]
