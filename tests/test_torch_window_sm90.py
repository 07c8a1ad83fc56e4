"""The CPU side of csrc/window_attention_sm90.cu (K7 at head dims 56, 72
and 96 on TMA and wgmma, and the windowed attention of K4's chain): the
route (`kernels.window_entry`, which K4's chain follows too) at every
window kind of Hiera-T / S / B+ / L at 1024^2, the plan, the column boxes
and the four tensor maps the wrapper hands the C entry, the wrapper's
refusals, a model of the kernel's tiling (strips, query boxes, a head's
leading and tail box with TMA's zero fill past the head, the pooled tile,
pad keys, the block-diagonal mask of packed windows, the cropped output)
against `window_attention_plain`, and K4's chain on CPU stand-ins against
the JAX package's Hiera block at each kind. The kernel itself runs only
on the card (tests/test_torch_kernels_cuda.py, `-k window`).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_llava_seg_torch import bridge, kernels
from video_llava_seg_torch.models.sam2 import hiera
from video_llava_seg_torch.models.sam2.config import sam2_config
from video_llava_seg_torch.ops import hiera_block as thb
from video_llava_seg_torch.ops import nn as tnn
from video_llava_seg_torch.ops.attention import attention_reference
from video_llava_seg_torch.ops.window_attention import window_attention_plain
from video_llava_seg_tpu.ops.hiera_block import hiera_block_xla

SM90 = kernels.WINDOW_SM90_ENTRY
OLD = "vls_window_attention"
SEG_FRAMES = 8


def _window_kinds():
    """(variant, block, hd, ws, ps, side) of every windowed block kind of
    Hiera-T / S / B+ / L at 1024^2."""
    out = {}
    for variant in ("tiny", "small", "base_plus", "large"):
        hc = sam2_config(variant).hiera
        side = 1024 // hc.patch_stride
        pools = 0
        for i, (_, dout, nh, ws, pool) in enumerate(hiera.block_dims(hc)):
            if ws:
                out.setdefault((variant, dout // nh, ws, 1 + pool,
                                side >> pools), i)
            pools += bool(pool)
    return [(v, i, hd, ws, ps, side)
            for (v, hd, ws, ps, side), i in out.items()]


KINDS = _window_kinds()


@pytest.mark.parametrize("variant,block,hd,ws,ps,side", KINDS,
                         ids=[f"{k[0]}-{k[1]}-ws{k[3]}p{k[4]}" for k in KINDS])
def test_window_entry_route(variant, block, hd, ws, ps, side):
    """Every window kind of Hiera-T / S (head dim 96), Hiera-B+ (56) and
    Hiera-L (72, ws 16 among them) takes window_attention_sm90.cu, in the
    per-op trunk and in K4's chain: window_attention.cu serves none."""
    assert hd == {"tiny": 96, "small": 96, "base_plus": 56,
                  "large": 72}[variant]
    assert kernels.window_entry(hd, ws, ps) == SM90
    assert set(kernels.WINDOW_ROUTES) == {SM90, OLD}
    assert SM90 in kernels._SIGNATURES


# (ws, ps) -> (sw, qh, nqb): the plans of Hiera-S's seven window kinds
# (B+'s too) and Hiera-L's ws 16: one window a strip, four 64-row boxes
# of 4 window rows, all 256 keys in one box; pooled, the four boxes' 16
# pooled rows each make one tile
PLANS = {(8, 1): (8, 8, 1), (8, 2): (16, 4, 2), (4, 1): (16, 4, 1),
         (4, 2): (32, 2, 2), (14, 1): (14, 4, 4), (14, 2): (14, 4, 4),
         (7, 1): (7, 7, 1), (16, 1): (16, 4, 4), (16, 2): (16, 4, 4)}


@pytest.mark.parametrize("ws,ps", sorted(PLANS))
def test_window_sm90_plan(ws, ps):
    """Every query box holds at most 64 rows, a strip at most 256 keys
    (128 under the pool), packed strips are powers of two, the boxes
    cover the window rows, and the pooled rows of a unit fill one tile."""
    sw, qh, nqb = kernels.window_sm90_plan(ws, ps)
    assert (sw, qh, nqb) == PLANS[(ws, ps)]
    assert sw % ws == 0 and sw * qh <= kernels.WINDOW_SM90_ROWS
    assert sw * ws <= (kernels.WINDOW_SM90_MAX_KEYS if ps == 1
                       else kernels.WINDOW_SM90_POOL_KEYS
                       if sw > ws else kernels.WINDOW_SM90_MAX_KEYS)
    assert nqb * qh >= ws and (nqb - 1) * qh < ws
    if sw > ws:
        assert ws & (ws - 1) == 0 and sw & (sw - 1) == 0
    if ps == 2:
        assert qh % 2 == 0
        assert nqb * (qh // 2) * (sw // 2) <= kernels.WINDOW_SM90_ROWS


@pytest.mark.parametrize("ws,ps", [(16, 1), (16, 2), (7, 2), (2, 2),
                                   (0, 1), (8, 3), (18, 1), (32, 2)])
def test_window_sm90_plan_refusals(ws, ps):
    """Windows of more than 256 keys, pools that do not divide the window
    or leave no pooled tile, and bad arguments have no plan and stay on
    window_attention.cu; at head dim 96 so does ws 16, whose 256 keys
    pass its key tile (208)."""
    plan = kernels.window_sm90_plan(ws, ps)
    if ws == 16:
        assert plan[0] * ws > kernels.WINDOW_SM90_HEAD_KEYS[96]
        assert kernels.window_entry(72, ws, ps) == SM90
    else:
        assert plan is None
        for hd in kernels.WINDOW_SM90_HEAD_DIM:
            assert kernels.window_entry(hd, ws, ps) == OLD
    assert kernels.window_entry(96, ws, ps) == OLD


@pytest.mark.parametrize("hd", [48, 64, 80, 128])
def test_window_entry_other_head_dims(hd):
    """Head dims without an instance stay on window_attention.cu."""
    assert kernels.window_entry(hd, 8, 1) == OLD


@pytest.mark.parametrize("hd,boxes", [(96, (64, 32, 32)), (72, (64, 8, 16)),
                                      (56, (32, 24, 32))])
def test_window_sm90_boxes(hd, boxes):
    """A head's columns: a leading box of whole k16 steps and a tail box
    of the columns left, as wide as the next swizzle width (16 / 32 / 64
    columns), the columns past the head outside the tail map."""
    w0, t, tb = kernels.window_sm90_boxes(hd)
    assert (w0, t, tb) == boxes
    assert w0 + t == hd and t <= tb and (w0 + tb) % 16 == 0
    assert w0 in (32, 64) and tb in (16, 32, 64)


@pytest.mark.parametrize("ws,ps,hp,c", [(8, 2, 256, 192), (14, 1, 70, 384),
                                        (4, 2, 128, 384), (7, 1, 35, 768)])
def test_window_sm90_geometry(ws, ps, hp, c):
    """The four maps over qkv [8, hp, hp, 3C] at head dim 96: dims (a
    box's columns, 3 * heads, Wp, Hp, B), the byte strides of a head, a
    pixel, a map row and an image, and the k / v and q boxes of the plan
    in 64- and 32-column parts."""
    geom = list(kernels.window_sm90_geometry((SEG_FRAMES, hp, hp, 3 * c), ws,
                                             ps, 96))
    _check_geometry(geom, ws, ps, hp, c, 96)


def _check_geometry(geom, ws, ps, hp, c, hd):
    sw, qh, _ = kernels.window_sm90_plan(ws, ps)
    w0, t, tb = kernels.window_sm90_boxes(hd)
    assert len(geom) == 4 * 15
    strides = [2 * hd, 6 * c, 6 * c * hp, 6 * c * hp * hp]
    maps = [(0, w0, [w0, 1, sw, ws, 1]), (2 * w0, t, [tb, 1, sw, ws, 1]),
            (0, w0, [w0, 1, sw, qh, 1]), (2 * w0, t, [tb, 1, sw, qh, 1])]
    for i, (off, ext, box) in enumerate(maps):
        g = geom[15 * i:15 * (i + 1)]
        assert g[:2] == [off, ext] and off % 16 == 0
        assert g[2:6] == [3 * c // hd, hp, hp, SEG_FRAMES]
        assert g[6:10] == strides and all(s % 16 == 0 for s in g[6:10])
        assert g[10:] == box


# (ws, ps, hp, c, hd): Hiera-L's kinds (head dim 72, ws 16 plain and
# pooled) and Hiera-B+'s (56, ws 14 padded to 70 and pooled)
@pytest.mark.parametrize("ws,ps,hp,c,hd", [
    (8, 1, 256, 144, 72), (16, 1, 64, 576, 72), (16, 2, 64, 288, 72),
    (4, 2, 128, 144, 72), (14, 1, 70, 448, 56), (14, 2, 70, 224, 56),
    (8, 2, 256, 112, 56), (7, 1, 35, 896, 56)])
def test_window_sm90_geometry_head_dims(ws, ps, hp, c, hd):
    """The maps at head dims 72 and 56: the tail map starts past the
    leading box and ends at the head's last column."""
    geom = list(kernels.window_sm90_geometry((SEG_FRAMES, hp, hp, 3 * c), ws,
                                             ps, hd))
    _check_geometry(geom, ws, ps, hp, c, hd)


def test_window_sm90_geometry_refusals():
    with pytest.raises(ValueError, match="no plan"):
        kernels.window_sm90_geometry((1, 32, 32, 3 * 96), 32, 1, 96)
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.window_sm90_geometry((1, 1 << 16, 1 << 16, 3 * 72), 8, 1,
                                     72)
    with pytest.raises(ValueError, match="no column boxes"):
        kernels.window_sm90_geometry((1, 8, 8, 3 * 64), 8, 1, 64)
    with pytest.raises(ValueError, match="no q, k, v"):
        kernels.window_sm90_geometry((1, 8, 8, 3 * 80), 8, 1, 72)


@pytest.mark.parametrize("kw,match", [
    (dict(route="vls_nope"), "route"),
    (dict(route=SM90, heads=2), "serves head dims"),
    (dict(ws=16, shape=(1, 16, 16, 3 * 96)), "serves head dims"),
    (dict(out_hw=(9, 8)), "crop"),
    (dict(out_hw=(0, 8)), "crop"),
    (dict(ws=3), "must divide"),
    (dict(ps=3), "pool stride"),
    (dict(shape=(1, 8, 8, 3 * 96 + 1)), "qkv"),
    (dict(heads=5), "head dim"),
])
def test_window_attention_arguments_are_checked(kw, match):
    """The wrapper refuses what the C entries do not take before it looks
    at the device or the library."""
    shape = kw.pop("shape", (1, 8, 8, 3 * 96))
    route = kw.pop("route", SM90)
    heads, ws = kw.pop("heads", 1), kw.pop("ws", 8)
    ps = kw.pop("ps", 1)
    qkv = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        kernels.window_attention(qkv, num_heads=heads, ws=ws, scale=0.1,
                                 ps=ps, route=route, **kw)


def test_window_attention_cpu_tensor_is_refused():
    """A valid call on a CPU tensor reaches `_require` and raises: the
    wrapper never launches on the CPU (ops.window_attention runs the plain
    version there)."""
    qkv = torch.zeros((1, 8, 8, 3 * 96), dtype=torch.bfloat16)
    before = kernels.WINDOW_LAUNCHES.snapshot()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.window_attention(qkv, num_heads=1, ws=8, scale=0.1)
    assert kernels.WINDOW_LAUNCHES.snapshot() == before


def _key_tile(sw, ws, ps, hd):
    nk = sw * ws
    for n in (64 if ps == 1 else 128, kernels.WINDOW_SM90_HEAD_KEYS[hd]):
        if nk <= n:
            return n
    raise AssertionError(nk)


# key tiles up to this hold all of S at once; the 256-key tile takes two
# online halves of 128 keys
EXACT_KEYS = 208


def _online_halves(s, v):
    """The 256-key tile's softmax: two halves of 128 keys, the running row
    max and sum, O rescaled once; P unnormalized, rounded to the value
    dtype, O divided by the row sum at the end."""
    half = s.shape[-1] // 2
    m = torch.full(s.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(s.shape[:-1] + v.shape[-1:])
    for hf in range(2):
        sh = s[..., hf * half:(hf + 1) * half]
        mx = torch.maximum(m, sh.amax(dim=-1, keepdim=True))
        mu = torch.where(mx == float("-inf"), 0.0, mx)
        al = torch.exp(m - mu)
        e = torch.exp(sh - mu)
        l = l * al + e.sum(-1, keepdim=True)
        o = o * al + torch.einsum("bhij,bhjd->bhid", e.to(v.dtype).float(),
                                  v[:, :, hf * half:(hf + 1) * half].float())
        m = mx
    return (o / torch.where(l > 0, l, torch.inf)).to(v.dtype)


def sm90_model(qkv, *, num_heads, ws, scale, ps=1, out_hw=None):
    """window_attention_sm90.cu's tiling in PyTorch: units (image, window
    row, strip, head), a head's columns as its leading and tail boxes of
    5-D maps whose extents end at the head (TMA's zero fill in the tail
    box's columns past it: no other head's value is read), the k / v box
    of a strip padded with zero rows to the key tile, query boxes read
    past the map as TMA's zero fill (and past the window from the next
    window row), the 2x2 max of each staged box into one pooled tile, pad
    keys and other windows' keys masked, the softmax exact at key tiles
    up to 208 and in two online halves at 256 (`_online_halves`), P
    rounded to the value dtype, each row's head columns stored where the
    C entry stores them. Asserts that every output element of the crop is
    written once."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    sw, qh, nqb = kernels.window_sm90_plan(ws, ps)
    w0, t, tb = kernels.window_sm90_boxes(hd)
    nk, nkp = sw * ws, _key_tile(sw, ws, ps, hd)
    rows = kernels.WINDOW_SM90_ROWS
    packed, wsl = sw > ws, int(math.log2(ws)) if sw > ws else 0
    oh, ow = out_hw or (hp // ps, wp // ps)
    n_strips, n_wr = -(-wp // sw), hp // ws
    big = torch.zeros((b, n_wr * ws + nqb * qh, n_strips * sw, c3),
                      dtype=qkv.dtype)
    big[:, :hp, :wp] = qkv
    # the two maps: dims (w0 | t, 3 * heads, Wp, Hp, B); a box reads tb
    # columns of the tail map, the tb - t past its extent as zeros
    heads = big.view(*big.shape[:3], 3, num_heads, hd)
    lead, tail = heads[..., :w0], heads[..., w0:w0 + t]
    heads = torch.cat([lead, tail, tail.new_zeros(
        (*tail.shape[:-1], tb - t))], dim=-1)
    out = torch.zeros((b, oh, ow, c), dtype=qkv.dtype)
    written = torch.zeros((b, oh, ow), dtype=torch.int32)
    hq, ppb = sw // 2, (qh // 2) * (sw // 2)
    col = torch.arange(nkp)
    row = torch.arange(rows)
    for wr in range(n_wr):
        for st in range(n_strips):
            x0, y0 = st * sw, wr * ws

            def box(which, y, h_):
                # [b, h_, sw, heads, w0 + tb]
                x = heads[:, y:y + h_, x0:x0 + sw, which]
                return x.permute(0, 3, 1, 2, 4).reshape(b, num_heads,
                                                        h_ * sw, w0 + tb)

            k = torch.zeros((b, num_heads, nkp, w0 + tb), dtype=qkv.dtype)
            v = torch.zeros_like(k)
            k[:, :, :nk], v[:, :, :nk] = box(1, y0, ws), box(2, y0, ws)
            tiles = []
            if ps == 1:
                for tile in range(nqb):
                    q = torch.zeros((b, num_heads, rows, w0 + tb),
                                    dtype=qkv.dtype)
                    q[:, :, :sw * qh] = box(0, y0 + tile * qh, qh)
                    tiles.append((tile, q))
            else:
                q = torch.zeros((b, num_heads, rows, w0 + tb),
                                dtype=qkv.dtype)
                for j in range(nqb):
                    src = box(0, y0 + j * qh, qh).view(b, num_heads, qh // 2,
                                                       2, hq, 2, w0 + tb)
                    q[:, :, j * ppb:(j + 1) * ppb] = src.amax(
                        dim=(3, 5)).reshape(b, num_heads, ppb, w0 + tb)
                tiles.append((0, q))
            valid = (col < nk)[None, :].expand(rows, nkp)
            if packed:
                qw = ((row % hq) >> (wsl - 1)) if ps == 2 else \
                    ((row % sw) >> wsl)
                kw = (col % sw) >> wsl
                valid = valid & (qw[:, None] == kw[None, :])
            for tile, q in tiles:
                s = torch.einsum("bhid,bhjd->bhij", q.float(),
                                 k.float()) * scale
                s = s.masked_fill(~valid, float("-inf"))
                if nkp <= EXACT_KEYS:
                    m = s.amax(dim=-1, keepdim=True).clamp_min(-3e38)
                    e = torch.exp(s - m)
                    p = (e / e.sum(-1, keepdim=True).clamp_min(1e-38)).to(
                        v.dtype)
                    o = torch.einsum("bhij,bhjd->bhid", p.float(),
                                     v.float()).to(qkv.dtype)
                else:
                    o = _online_halves(s, v)
                for i in range(rows):
                    if ps == 2:
                        j, li = i // ppb, i % ppb
                        py = j * (qh // 2) + li // hq
                        ok = j < nqb and py < ws // 2
                        y, x = wr * (ws // 2) + py, st * hq + li % hq
                    else:
                        wy = tile * qh + i // sw
                        ok = i < sw * qh and wy < ws
                        y, x = wr * ws + wy, st * sw + i % sw
                    if ok and y < oh and x < ow:
                        out[:, y, x] = o[:, :, i, :hd].reshape(b, c)
                        written[:, y, x] += 1
    assert torch.all(written == 1)
    return out


# (b, hp, wp, heads, ws, ps): Hiera-S's kinds at tiny maps (head dim 96),
# maps a packed strip does not divide, and padded maps cropped back
MODEL_CASES = [
    (2, 16, 16, 1, 8, 1), (1, 16, 24, 2, 8, 2), (2, 8, 8, 2, 4, 1),
    (1, 8, 12, 2, 4, 1), (1, 8, 8, 4, 4, 2), (1, 8, 12, 1, 4, 2),
    (1, 28, 14, 2, 14, 1), (1, 14, 28, 2, 14, 2), (2, 14, 7, 1, 7, 1),
]


@pytest.mark.parametrize("b,hp,wp,heads,ws,ps", MODEL_CASES)
def test_sm90_tiling_model_matches_plain(b, hp, wp, heads, ws, ps):
    """The kernel's tiling computes `window_attention_plain` (fp32) and,
    with out_hw, its crop; every kept output written exactly once."""
    g = np.random.default_rng(hp * 100 + wp + ws)
    qkv = torch.from_numpy(g.standard_normal(
        (b, hp, wp, 3 * 96 * heads)).astype(np.float32))
    kw = dict(num_heads=heads, ws=ws, scale=96 ** -0.5, ps=ps)
    want = window_attention_plain(qkv, **kw)
    got = sm90_model(qkv, **kw)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    oh, ow = hp // ps - 1, wp // ps - 2
    got = sm90_model(qkv, **kw, out_hw=(oh, ow))
    torch.testing.assert_close(got, want[:, :oh, :ow], atol=2e-5, rtol=2e-5)


# (b, hp, wp, heads, ws, ps, hd): Hiera-L's ws 16 plain and pooled, its
# packed ws 4 and pooled ws 8 at head dim 72; Hiera-B+'s padded ws 14
# (plain and pooled), ws 7 and pooled ws 4 at 56
HEAD_DIM_CASES = [
    (1, 32, 16, 2, 16, 1, 72), (1, 16, 32, 2, 16, 2, 72),
    (1, 8, 12, 2, 4, 1, 72), (1, 16, 16, 1, 8, 2, 72),
    (1, 28, 14, 2, 14, 1, 56), (1, 14, 28, 2, 14, 2, 56),
    (2, 14, 7, 1, 7, 1, 56), (1, 8, 12, 2, 4, 2, 56),
]


@pytest.mark.parametrize("b,hp,wp,heads,ws,ps,hd", HEAD_DIM_CASES)
def test_sm90_tiling_model_head_dims(b, hp, wp, heads, ws, ps, hd):
    """At head dims 72 and 56 (a 16- / 32-column tail box over 8 / 24
    columns) the tiling computes `window_attention_plain` and its crop,
    with 256-key tiles at ws 16; a neighbouring head holding inf and NaN
    leaves the other heads' output as it was."""
    g = np.random.default_rng(hp * 100 + wp + ws + hd)
    qkv = torch.from_numpy(g.standard_normal(
        (b, hp, wp, 3 * hd * heads)).astype(np.float32))
    kw = dict(num_heads=heads, ws=ws, scale=hd ** -0.5, ps=ps)
    want = window_attention_plain(qkv, **kw)
    torch.testing.assert_close(sm90_model(qkv, **kw), want, atol=2e-5,
                               rtol=2e-5)
    oh, ow = hp // ps - 1, wp // ps - 2
    torch.testing.assert_close(sm90_model(qkv, **kw, out_hw=(oh, ow)),
                               want[:, :oh, :ow], atol=2e-5, rtol=2e-5)
    if heads > 1:
        bad = qkv.clone().view(b, hp, wp, 3, heads, hd)
        bad[..., 1, :] = float("nan")
        bad[..., 1, ::2] = float("inf")
        got = sm90_model(bad.view_as(qkv), **kw).view(
            *want.shape[:3], heads, hd)
        torch.testing.assert_close(
            got[..., 0, :], want.view(*want.shape[:3], heads, hd)[..., 0, :],
            atol=2e-5, rtol=2e-5)


@pytest.fixture
def chain_stand_ins(monkeypatch):
    """K4's kernels replaced by CPU versions in fp32: `window_attention`
    by the model of window_attention_sm90.cu's tiling; every call
    recorded by name."""
    calls = []

    def gemm(a, b, bias=None, residual=None, scale=1.0, act="none"):
        calls.append("gemm")
        return kernels.gemm_plain(a, b, bias, residual, scale, act)

    def attention(q, k, v, *, scale):
        calls.append("attention")
        return attention_reference(q, k, v, scale=scale)

    def window_attention(qkv, *, num_heads, ws, scale, ps=1, out_hw=None):
        assert qkv.is_contiguous()
        hd = qkv.shape[-1] // 3 // num_heads
        entry = kernels.window_entry(hd, ws, ps)
        calls.append(entry)
        kw = dict(num_heads=num_heads, ws=ws, scale=scale, ps=ps)
        if entry == SM90:
            return sm90_model(qkv, **kw, out_hw=out_hw)
        o = window_attention_plain(qkv, **kw)
        if out_hw is not None:
            o = o[:, :out_hw[0], :out_hw[1]].contiguous()
        return o

    def maxpool2x2(x):
        calls.append("maxpool2x2")
        return thb.max_pool_2x2(x)

    def layernorm(x, g, b, eps):
        calls.append("layernorm")
        return tnn.layer_norm({"scale": g, "bias": b}, x, eps)

    for name, fn in (("gemm", gemm), ("attention", attention),
                     ("window_attention", window_attention),
                     ("maxpool2x2", maxpool2x2), ("layernorm", layernorm)):
        monkeypatch.setattr(kernels, name, fn)
    return calls


def _block(g, din, dout):
    def dense(i, o):
        return {"kernel": (g.standard_normal((i, o)) / math.sqrt(i)).astype(
                    np.float32),
                "bias": (0.1 * g.standard_normal(o)).astype(np.float32)}

    def ln(d):
        return {"scale": (1 + 0.1 * g.standard_normal(d)).astype(np.float32),
                "bias": (0.1 * g.standard_normal(d)).astype(np.float32)}

    blk = {"norm1": ln(din), "norm2": ln(dout), "qkv": dense(din, 3 * dout),
           "proj_attn": dense(dout, dout),
           "mlp": {"layers": [dense(dout, 2 * dout), dense(2 * dout, dout)]}}
    if din != dout:
        blk["proj"] = dense(din, dout)
    return blk


# (din, dout, heads, ws, pool, h, w): head dim 96 at tiny maps: windowed,
# packed ws 4, q-pool (ws 8 and packed ws 4), padded ws 14 with and without
# the pool, padded ws 7, and a global block; Hiera-B+'s head dim 56 and
# Hiera-L's 72, plain, q-pool and padded, and Hiera-L's ws 16 plain and
# pooled
CHAIN_KINDS = [(96, 96, 1, 8, False, 16, 16), (192, 192, 2, 4, False, 8, 8),
               (96, 192, 2, 8, True, 16, 16), (192, 384, 4, 4, True, 8, 8),
               (96, 96, 1, 14, False, 16, 12), (96, 192, 2, 14, True, 16, 16),
               (96, 96, 1, 7, False, 10, 10), (96, 96, 1, 0, False, 8, 8),
               (56, 56, 1, 8, False, 16, 16), (72, 144, 2, 8, True, 16, 16),
               (112, 112, 2, 14, False, 16, 12),
               (72, 72, 1, 16, False, 16, 16),
               (144, 288, 4, 16, True, 32, 32)]


@pytest.mark.parametrize("din,dout,heads,ws,pool,h,w", CHAIN_KINDS)
def test_hiera_chain_window_wiring(chain_stand_ins, din, dout, heads, ws,
                                   pool, h, w):
    """K4's chain sends every windowed block's attention to one
    `window_attention` call on the padded qkv map with the crop, on the
    C entry `window_entry` names (no attention, no q pool.cu), and a
    global block's to `attention`; on fp32 stand-ins it equals the JAX
    package's `hiera_block_xla`."""
    g = np.random.default_rng(din + 7 * ws + h)
    blk = _block(g, din, dout)
    x = g.standard_normal((2, h, w, din)).astype(np.float32)
    ps = 2 if pool else 1
    got = thb._hiera_block_cuda(bridge.tree_map(torch.from_numpy, blk),
                                torch.from_numpy(x), num_heads=heads, ws=ws,
                                ps=ps, eps=1e-6)
    want = hiera_block_xla(
        bridge.tree_map(jnp.asarray, blk), jnp.asarray(x), num_heads=heads,
        ws=ws, q_stride=(2, 2) if pool else None, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=5e-5)
    entry = kernels.window_entry(dout // heads, ws, ps) if ws else None
    assert chain_stand_ins.count(entry or "attention") == 1
    assert chain_stand_ins.count("attention") == int(not ws)
    assert sum(chain_stand_ins.count(e) for e in (SM90, OLD)) == int(bool(ws))
    assert chain_stand_ins.count("maxpool2x2") == int(pool)
    assert chain_stand_ins.count("gemm") == 4 + (din != dout)


def test_trunk_launch_expectations():
    """SAM2.1-hiera-small per trunk through K4 (chip_smoke's launch
    checks): 16 blocks, the 13 windowed ones on window_attention_sm90.cu,
    the 3 global ones on attention_sm90.cu, pool.cu for the 3 shortcut
    pools only."""
    assert chip_smoke.trunk_sm90_blocks() == (16, 3)
    assert chip_smoke.trunk_window_launches() == {SM90: 13, OLD: 0}
    assert chip_smoke.trunk_pool_launches() == 3
