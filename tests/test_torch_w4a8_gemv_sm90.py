"""The CPU side of csrc/w4a8_gemv_sm90.cu (K5 at <= 8 rows: every W4A8
dense of a decode step and the lm_head): the route `w4a8_matmul` takes by
shape, the plan (boxes of 64 packed rows by 256 columns; whole column
tiles dealt in rounds to one block an SM, or each tile's K split into
parts, a cluster of blocks; the ring's depth beside the activations in
shared memory), a CPU emulation of the kernel's split-K (integer partial
sums per unit, added in shuffled order) against the plain product and
the JAX package's Pallas kernel (interpret mode), and the tensor map of
the packed weights and its refusals. The kernel itself runs only on the
card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.ops import int4 as tint4
from video_llava_seg_tpu.ops import int4 as jint4

GEMV = "vls_w4a8_gemv_sm90"
BK, BN = kernels.W4A8_GEMV_BOX_K, kernels.W4A8_GEMV_BOX_N
# (in, out) of the fused Llama-3-8B denses of a decode step: wqkv, wo,
# w_gateup, w_down, the lm_head
LLAMA = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
         (4096, 128256)]

ROUTES = (
    # decode at batch 1 (--load_4bit) and 2 (--batch_queries 2), and rows
    # 3-8 on the same kernel
    [((r, i, o), GEMV) for r in (1, 2) for i, o in LLAMA]
    + [((r, 4096, 6144), GEMV) for r in range(3, 9)]
    + [((8, 14336, 4096), GEMV), ((8, 4096, 128256), GEMV),
       ((8, 16384, 4096), GEMV)]  # rows x in = 128 KiB, the limit
    + [
        ((8, 16416, 4096), "vls_w4a8"),   # rows x in past 128 KiB
        ((2, 131072, 256), "vls_w4a8"),
        ((2, 136, 100), "vls_w4a8"),      # in/2 = 68, out = 100
        ((2, 4096, 4100), "vls_w4a8"),    # out % 16 != 0
        ((2, 4104, 256), "vls_w4a8"),     # in/2 % 16 != 0
        ((1, 288, 48), GEMV),             # in/2 = 144: a K tail
        ((9, 4096, 6144), "vls_w4a8_sm90"),  # above 8 rows: the prefill
        ((300, 4096, 4100), "vls_w4a8"),
    ])


@pytest.mark.parametrize("shape,want", ROUTES,
                         ids=[f"{r}x{i}x{o}" for (r, i, o), _ in ROUTES])
def test_w4a8_gemv_entry_route(shape, want):
    """<= 8 rows: the new kernel where its plan takes the shape, w4a8.cu's
    GEMV elsewhere; above 8 rows unchanged."""
    rows, in_dim, out = shape
    assert kernels.w4a8_entry(rows, in_dim // 2, out) == want
    assert want in kernels._SIGNATURES and want in kernels.W4A8_ROUTES
    assert (kernels.w4a8_gemv_plan(rows, in_dim // 2, out) is not None) == (
        want == GEMV)


def test_w4a8_launch_counts_by_entry():
    """W4A8_LAUNCHES counts each C entry of W4A8_ROUTES, the new one
    included, and starts at zero."""
    assert kernels.W4A8_ROUTES == ("vls_w4a8", "vls_w4a8_sm90", GEMV)
    counts = kernels.LaunchCounts(kernels.W4A8_ROUTES)
    assert counts.snapshot() == dict.fromkeys(kernels.W4A8_ROUTES, 0)


def _cover(plan, half, out):
    """Per (packed row, column), how many units of the plan read it; per
    block, its boxes."""
    seen = np.zeros((half, out), np.int32)
    per_block = []
    for units in kernels.w4a8_gemv_units(plan):
        n = 0
        for tile, k0, k1 in units:
            assert 0 <= tile < plan.tiles and 0 <= k0 < k1 <= plan.k_boxes
            seen[k0 * BK:k1 * BK, tile * BN:(tile + 1) * BN] += 1
            n += k1 - k0
        per_block.append(n)
    return seen, per_block


# (tiles, K parts, blocks) on an H100: the layer denses split K in
# clusters of 4 or 6 (as many as the card holds at once) on 96 SMs, the
# wide ones take whole tiles, one block a tile or an SM
LLAMA_PLANS = [(24, 4, 96), (16, 6, 96), (112, 1, 112), (16, 6, 96),
               (501, 1, 132)]


@pytest.mark.parametrize("rows", [1, 2, 8])
@pytest.mark.parametrize("in_dim,out,plan_want",
                         [(i, o, p) for (i, o), p in zip(LLAMA, LLAMA_PLANS)])
def test_w4a8_gemv_plan_llama(rows, in_dim, out, plan_want):
    """At every Llama-3-8B width: at most one block an SM, a split grid's
    clusters all held at once, parts of one tile within a box of each other,
    every (packed row, column) read by exactly one unit, a ring of >= 4
    stages in shared memory beside the activations."""
    half = in_dim // 2
    plan = kernels.w4a8_gemv_plan(rows, half, out)
    assert plan.k_boxes == half // BK and plan.tiles == -(-out // BN)
    assert (plan.tiles, plan.parts, plan.grid) == plan_want
    assert plan.grid <= kernels.H100_SMS
    if plan.parts > 1:
        assert plan.tiles <= kernels.W4A8_GEMV_H100_SLOTS[plan.parts - 1]
    assert 1 <= plan.parts <= min(8, plan.k_boxes)
    assert kernels.W4A8_GEMV_MIN_STAGES <= plan.stages <= (
        kernels.W4A8_GEMV_MAX_STAGES)
    assert plan.smem == kernels.w4a8_gemv_smem(rows, in_dim, plan.stages)
    assert plan.smem <= kernels.SM90_SMEM_MAX
    if plan.stages < kernels.W4A8_GEMV_MAX_STAGES:
        assert kernels.w4a8_gemv_smem(rows, in_dim, plan.stages + 1) > (
            kernels.SM90_SMEM_MAX)
    seen, per_block = _cover(plan, half, out)
    assert (seen == 1).all()
    assert min(per_block) >= 1 and sum(per_block) == plan.k_boxes * (
        plan.tiles)
    if plan.parts > 1:
        assert max(per_block) - min(per_block) <= 1
    else:
        assert max(per_block) - min(per_block) <= plan.k_boxes


@pytest.mark.parametrize("rows,half,out,sms,parts", [(1, 144, 272, 132, 3),
                                                     (3, 144, 400, 7, 3),
                                                     (8, 2048, 16, 132, 8),
                                                     (2, 64, 4096, 5, 1),
                                                     (2, 1024, 256, 6, 6)])
def test_w4a8_gemv_plan_tails(rows, half, out, sms, parts):
    """Widths with a K tail (half % BK) and a column tail (out % BN),
    few SMs, few K boxes: parts within the K boxes and the SMs, and the
    units still cover every (packed row, column) exactly once."""
    plan = kernels.w4a8_gemv_plan(rows, half, out, sms)
    assert plan.parts == parts
    assert plan.grid == (plan.tiles * parts if parts > 1
                         else min(sms, plan.tiles))
    seen, per_block = _cover(plan, plan.k_boxes * BK, plan.tiles * BN)
    assert (seen == 1).all()
    assert min(per_block) >= 1


@pytest.mark.parametrize("slots,parts", [((132, 66, 39, 30, 22, 17, 15, 15),
                                           6),
                                          ((132, 66, 39, 30, 12, 8, 8, 8), 4),
                                          ((132, 8, 8, 8, 8, 8, 8, 8), 1)])
def test_w4a8_gemv_parts_follow_the_cards_clusters(slots, parts):
    """wo (16 column tiles): the most K parts whose 16 clusters the card
    holds at once, by the counts the wrapper asks the device for."""
    plan = kernels.w4a8_gemv_plan(2, 2048, 4096, slots=slots)
    assert plan.parts == parts and plan.grid == (16 * parts if parts > 1
                                                 else 16)


def test_w4a8_gemv_smem_layout():
    """The shared memory the kernel lays out: 128 bytes of alignment
    slack, the ring of 16 KB boxes, the activation rows plus one box of K
    rounded to 16 bytes, the [rows, BN] int32 sums, 2 stages + 1
    mbarriers; the deepest ring that fits, or no plan."""
    assert BK * BN == 16384
    assert kernels.w4a8_gemv_smem(2, 4096, 8) == (
        128 + 8 * 16384 + (2 * 4096 + BK) + 2 * BN * 4 + 17 * 8)
    assert kernels.w4a8_gemv_smem(1, 272, 4) == (
        128 + 4 * 16384 + -(-(272 + BK) // 16) * 16 + BN * 4 + 9 * 8)
    assert kernels.w4a8_gemv_plan(2, 2048, 4096).stages == 8
    assert kernels.w4a8_gemv_plan(8, 7168, 4096).stages == 6
    assert kernels.w4a8_gemv_plan(8, 8192, 4096).stages == 5
    assert kernels.w4a8_gemv_plan(8, 8208, 4096) is None
    for rows, half, out in [(0, 2048, 4096), (9, 2048, 4096),
                            (2, 2056, 4096), (2, 2048, 4104)]:
        assert kernels.w4a8_gemv_plan(rows, half, out) is None


def _inputs(rows, in_dim, out, seed):
    r = np.random.default_rng(seed)
    xq = r.integers(-127, 128, (rows, in_dim), dtype=np.int8)
    packed = r.integers(-128, 128, (in_dim // 2, out), dtype=np.int8)
    a_scale = (r.random((rows, 1)) * 0.05 + 1e-3).astype(np.float32)
    w_scale = (r.random(out) * 0.02 + 1e-4).astype(np.float32)
    return xq, a_scale, packed, w_scale


def emulate(xq, a_scale, packed, w_scale, out_dtype, plan, seed):
    """The kernel's arithmetic in PyTorch on the CPU: each unit's int32
    sums over its boxes with the nibble planes formed as 16 x their
    values, the units' partial sums added into int32 in a shuffled order,
    then the shift by 4 and the two fp32 multiplies, one cast."""
    half, out = packed.shape
    lo, hi = tint4.unpack_int4(packed)
    lo16, hi16 = lo.double() * 16, hi.double() * 16
    x = xq.double()
    parts = []
    for units in kernels.w4a8_gemv_units(plan):
        for tile, k0, k1 in units:
            r0, r1 = k0 * BK, min(k1 * BK, half)
            c0, c1 = tile * BN, min((tile + 1) * BN, out)
            part = (x[:, r0:r1] @ lo16[r0:r1, c0:c1]
                    + x[:, half + r0:half + r1] @ hi16[r0:r1, c0:c1])
            parts.append((c0, c1, part.to(torch.int32)))
    np.random.default_rng(seed).shuffle(parts)
    acc = torch.zeros((xq.shape[0], out), dtype=torch.int32)
    for c0, c1, part in parts:
        acc[:, c0:c1] += part
    return ((acc >> 4).float() * a_scale * w_scale).to(out_dtype)


@pytest.mark.parametrize("rows", list(range(1, 9)))
@pytest.mark.parametrize("half,out,sms", [(144, 272, 6), (64, 1008, 3),
                                          (400, 128, 4), (2048, 48, 132),
                                          (272, 1008, 3)])
def test_w4a8_gemv_emulation_bit_equal_to_plain(rows, half, out, sms):
    """K split into 2-8 parts (one column tile's parts add up; with a K
    tail the last part is shorter), or whole tiles dealt in rounds to few
    SMs, with K and column tails: the emulated kernel equals
    `w4a8_matmul_plain` bit for bit in bf16 and fp32."""
    plan = kernels.w4a8_gemv_plan(rows, half, out, sms)
    assert plan is not None
    assert plan.parts > 1 or plan.tiles > plan.grid
    t = [torch.from_numpy(a) for a in _inputs(rows, 2 * half, out,
                                              rows + half)]
    for dt in (torch.bfloat16, torch.float32):
        want = tint4.w4a8_matmul_plain(*t, dt)
        got = emulate(*t, dt, plan, seed=rows)
        assert torch.equal(got, want)


@pytest.mark.parametrize("rows,in_dim,out", [(1, 288, 272), (2, 544, 48)])
def test_w4a8_gemv_emulation_bit_equal_to_pallas(rows, in_dim, out):
    """At decode rows the emulated kernel equals the TPU kernel in
    interpret mode, bit for bit (fp32 out, as the lm_head)."""
    plan = kernels.w4a8_gemv_plan(rows, in_dim // 2, out, 6)
    assert plan.parts > 1
    xq, a_scale, packed, w_scale = _inputs(rows, in_dim, out, in_dim)
    got = emulate(*(torch.from_numpy(a) for a in (xq, a_scale, packed,
                                                  w_scale)),
                  torch.float32, plan, seed=0).numpy()
    pallas = jint4.w4a8_matmul(jnp.asarray(xq), jnp.asarray(a_scale),
                               jnp.asarray(packed), jnp.asarray(w_scale),
                               jnp.float32, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("in_dim,out", LLAMA + [(288, 48)])
def test_w4a8_gemv_tensor_map(in_dim, out):
    """The packed map: base offset 0, dims (out, in/2) innermost first,
    row stride out bytes, box (BN columns, BK packed rows); the byte it
    addresses at (column n, packed row k) is packed[k, n]."""
    half = in_dim // 2
    g = kernels.w4a8_gemv_sm90_geometry(half, out)
    assert g == (0, out, half, out, BN, BK)
    small = torch.arange(half * out, dtype=torch.int64).reshape(half, out)
    rng = np.random.default_rng(out)
    for _ in range(20):
        k, n = int(rng.integers(half)), int(rng.integers(out))
        assert small.reshape(-1)[g[0] + k * g[3] + n] == small[k, n]


@pytest.mark.parametrize("half,out", [(2056, 4096), (2048, 4104), (0, 128),
                                      (2048, 0)])
def test_w4a8_gemv_tensor_map_refuses(half, out):
    """What TMA or the activations' bulk copy cannot address raises: a
    row stride off 16 bytes (out % 16), a high plane off 16 bytes (in/2 %
    16), an empty weight."""
    with pytest.raises(ValueError, match="w4a8_gemv_sm90"):
        kernels.w4a8_gemv_sm90_geometry(half, out)


def test_w4a8_gemv_forced_route_refuses_other_shapes():
    """`route` cannot send a shape the kernel does not take to it: more
    than 8 rows, or widths TMA cannot address."""
    for rows, half, out in [(9, 2048, 4096), (2, 2056, 4096)]:
        with pytest.raises(ValueError, match="does not take"):
            kernels._gemv_args(rows, half, out, 0)
