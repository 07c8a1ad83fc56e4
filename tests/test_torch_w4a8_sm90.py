"""The CPU side of csrc/w4a8_sm90.cu (K5's prefill tile on TMA and
wgmma): the route `w4a8_matmul` takes by shape, the three int8 tensor
maps the wrapper hands the C entry (the activations' low and high planes,
the packed weights), the refusal of what TMA cannot address, and the
plain product against the JAX package's Pallas kernel (interpret mode) at
widths that take the new route, with a K tail. The kernel itself runs
only on the card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.ops import int4 as tint4
from video_llava_seg_tpu.ops import int4 as jint4
from video_llava_seg_tpu.ops import quantization as jquant

# (rows, in, out) -> the C entry; the Llama-3-8B denses at decode (1-8
# rows: w4a8_gemv_sm90.cu) and at the batch-2 prefill (10,392 rows), the
# test widths of w4a8.cu
ROUTES = [
    ((1, 4096, 6144), "vls_w4a8_gemv_sm90"),
    ((2, 14336, 4096), "vls_w4a8_gemv_sm90"),
    ((8, 4096, 28672), "vls_w4a8_gemv_sm90"),
    ((2, 4096, 128256), "vls_w4a8_gemv_sm90"),
    ((9, 4096, 6144), "vls_w4a8_sm90"),
    ((10392, 4096, 6144), "vls_w4a8_sm90"),
    ((10392, 4096, 4096), "vls_w4a8_sm90"),
    ((10392, 4096, 28672), "vls_w4a8_sm90"),
    ((10392, 14336, 4096), "vls_w4a8_sm90"),
    ((300, 4160, 272), "vls_w4a8_sm90"),   # in/2 % 128 != 0: a K tail
    ((300, 256, 384), "vls_w4a8_sm90"),
    ((300, 136, 100), "vls_w4a8"),         # in/2 = 68, out = 100
    ((300, 4128, 256), "vls_w4a8_sm90"),   # in/2 = 2064 = 16 x 129
    ((300, 4096, 4100), "vls_w4a8"),       # out % 16 != 0
    ((300, 4104, 256), "vls_w4a8"),        # in/2 % 16 != 0
]


@pytest.mark.parametrize("shape,want", ROUTES,
                         ids=[f"{r}x{i}x{o}" for (r, i, o), _ in ROUTES])
def test_w4a8_entry_route(shape, want):
    """<= 8 rows: the decode kernel (w4a8_gemv_sm90.cu); above, the TMA +
    wgmma tile where in/2 and out are multiples of 16, w4a8.cu's mma.sync
    tile elsewhere."""
    rows, in_dim, out = shape
    assert kernels.w4a8_entry(rows, in_dim // 2, out) == want
    assert want in kernels._SIGNATURES and want in kernels.W4A8_ROUTES


def _geom(rows, in_dim, out):
    xq = torch.arange(rows * in_dim, dtype=torch.int32).remainder(251).sub(
        125).to(torch.int8).reshape(rows, in_dim)
    packed = torch.arange(in_dim // 2 * out, dtype=torch.int32).remainder(
        241).sub(120).to(torch.int8).reshape(in_dim // 2, out)
    return xq, packed, kernels.w4a8_sm90_geometry(xq, packed)


def _read(t, g, c0, c1):
    """The byte the map (offset, dims, stride, box) addresses at (inner c0,
    outer c1), read from t's storage."""
    off, d0, d1, stride = g[:4]
    assert 0 <= c0 < d0 and 0 <= c1 < d1
    flat = t.reshape(-1)
    return flat[off + c1 * stride + c0].item()


@pytest.mark.parametrize("rows,in_dim,out", [(10392 // 8, 4096, 6144 // 8),
                                             (300, 4160, 272)])
def test_w4a8_sm90_tensor_maps(rows, in_dim, out):
    """The low plane's map starts at xq, the high plane's at xq + in/2,
    both [in/2 x rows] over xq's row stride with the 128 x 128 box; the
    packed map is [out x in/2] over its row stride with the 128 x 128
    box. Every addressed byte is the one the plain product reads."""
    xq, packed, g = _geom(rows, in_dim, out)
    half = in_dim // 2
    assert len(g) == 18
    lo, hi, w = g[:6], g[6:12], g[12:]
    box_x = (kernels.W4A8_SM90_BOX_K, kernels.W4A8_SM90_BOX_ROWS)
    box_w = (kernels.W4A8_SM90_BOX_COLS, kernels.W4A8_SM90_BOX_K)
    assert lo == (0, half, rows, in_dim) + box_x
    assert hi == (half, half, rows, in_dim) + box_x
    assert w == (0, out, half, out) + box_w
    assert box_x == (128, 128) and box_w == (128, 128)
    rng = np.random.default_rng(rows)
    for _ in range(50):
        k, r, n = (int(rng.integers(x)) for x in (half, rows, out))
        assert _read(xq, lo, k, r) == xq[r, k].item()
        assert _read(xq, hi, k, r) == xq[r, half + k].item()
        assert _read(packed, w, n, k) == packed[k, n].item()


def test_w4a8_sm90_geometry_of_a_row_slice():
    """A block of rows of a larger activation tensor keeps its row stride
    (the map addresses through it, no copy)."""
    big = torch.zeros(64, 512, dtype=torch.int8)
    packed = torch.zeros(256, 128, dtype=torch.int8)
    xq = big[16:48]
    g = kernels.w4a8_sm90_geometry(xq, packed)
    assert g[:4] == (0, 256, 32, 512) and g[6:10] == (256, 256, 32, 512)


@pytest.mark.parametrize("case", ["half_not_16", "out_not_16",
                                  "misaligned_base", "column_slice",
                                  "row_stride", "in_mismatch"])
def test_w4a8_sm90_geometry_refuses(case):
    """What TMA cannot address raises instead of reaching the C entry: a
    high-plane base off 16 bytes (in/2 % 16), out % 16, a base off 16
    bytes, a view whose last dim is not contiguous or whose row stride is
    not a multiple of 16 bytes, and in != 2 x in/2."""
    xq = torch.zeros(32, 512, dtype=torch.int8)
    packed = torch.zeros(256, 128, dtype=torch.int8)
    if case == "half_not_16":
        xq, packed = torch.zeros(32, 272, dtype=torch.int8), \
            torch.zeros(136, 128, dtype=torch.int8)
    elif case == "out_not_16":
        packed = torch.zeros(256, 136, dtype=torch.int8)
    elif case == "misaligned_base":
        xq = torch.zeros(32 * 512 + 16, dtype=torch.int8)[8:8 + 32 * 512] \
            .reshape(32, 512)
    elif case == "column_slice":
        xq = torch.zeros(512, 32, dtype=torch.int8).t()
    elif case == "row_stride":
        xq = torch.zeros(32, 520, dtype=torch.int8)[:, :512]
    elif case == "in_mismatch":
        packed = torch.zeros(240, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="w4a8_sm90"):
        kernels.w4a8_sm90_geometry(xq, packed)


def test_w4a8_route_argument_is_checked():
    """`route` names a C entry of W4A8_ROUTES or raises before any launch."""
    xq = torch.zeros(16, 256, dtype=torch.int8)
    packed = torch.zeros(128, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="route"):
        kernels.w4a8_matmul(xq, torch.ones(16, 1), packed, torch.ones(64),
                            torch.bfloat16, route="cublas")


@pytest.mark.parametrize("rows,in_dim,out", [(9, 288, 48), (130, 256, 64)])
def test_w4a8_plain_bit_equal_to_pallas_on_the_tma_route(rows, in_dim, out):
    """At widths the new kernel takes (in/2 = 144 leaves a 16-row K tail
    past the 128-row box), the plain product the card is held to equals
    the TPU kernel in interpret mode, bit for bit."""
    assert kernels.w4a8_entry(rows, in_dim // 2, out) == "vls_w4a8_sm90"
    r = np.random.default_rng(rows)
    w = jnp.asarray(r.standard_normal((in_dim, out)) * 0.1, jnp.float32)
    q, scale = jquant.quantize_kernel(w, bits=4)
    packed = jint4.pack_int4(q)
    x = jnp.asarray(r.standard_normal((rows, in_dim)), jnp.float32)
    xq, a_s = jquant.quantize_activations_rowwise(x)
    t = [torch.from_numpy(np.array(a)) for a in (xq, a_s, packed, scale)]
    got = tint4.w4a8_matmul_plain(*t, torch.float32).numpy()
    pallas = jint4.w4a8_matmul(xq, a_s, packed, scale, jnp.float32,
                               interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
