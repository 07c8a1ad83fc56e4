"""The CPU side of csrc/w8a8_sm90.cu (gemm_s8 on TMA and wgmma: K8's six
denses and `int_matmul`): the route `gemm_s8` takes by shape, the two
int8 tensor maps the wrapper hands the C entry, the refusal of what TMA
cannot address, the checked `route` argument, and the plain `kernel_qa`
dense the card is held to against the JAX package's `nn.dense`, at
widths that take the new route, with an M tail and a K tail. The kernel
itself runs only on the card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.ops import nn as tnn
from video_llava_seg_torch.ops.int4 import gemm_s8_plain, int_matmul_plain
from video_llava_seg_tpu.ops import nn as jnn
from video_llava_seg_tpu.ops import quantization as jquant

# (M, K, N) -> the C entry. K8 at 32 frames x 577 tokens: CLIP-L/14-336
# (d 1024, mlp 4096) and RADIO-H/16-384 (d 1280, mlp 5120), q / k / v /
# out, fc1, fc2; the projector's two kernel_qa denses over 32 x 576 patch
# rows into Llama-3-8B's 4096; the unembedding's kernel_qa head at decode
# and prefill; then shapes TMA cannot address (K or N % 16), which stay on
# w8a8.cu, as do the CUDA tests' (1, 64, 4) and (300, 4100, 36)
ROUTES = [
    ((18464, 1024, 1024), "vls_gemm_s8_sm90"),
    ((18464, 1024, 4096), "vls_gemm_s8_sm90"),
    ((18464, 4096, 1024), "vls_gemm_s8_sm90"),
    ((18464, 1280, 1280), "vls_gemm_s8_sm90"),
    ((18464, 1280, 5120), "vls_gemm_s8_sm90"),
    ((18464, 5120, 1280), "vls_gemm_s8_sm90"),
    ((18432, 1024, 4096), "vls_gemm_s8_sm90"),
    ((18432, 1280, 4096), "vls_gemm_s8_sm90"),
    ((18432, 4096, 4096), "vls_gemm_s8_sm90"),
    ((2, 4096, 128256), "vls_gemm_s8_sm90"),
    ((5196, 4096, 128256), "vls_gemm_s8_sm90"),
    ((129, 1040, 272), "vls_gemm_s8_sm90"),  # K tail (16 x 65), N % 128
    ((1, 64, 4), "vls_gemm_s8"),
    ((300, 4100, 36), "vls_gemm_s8"),
    ((64, 1036, 256), "vls_gemm_s8"),        # K % 16 == 12
    ((64, 1024, 1000), "vls_gemm_s8"),       # N % 16 == 8
    ((0, 1024, 1024), "vls_gemm_s8"),        # nothing to launch
]


@pytest.mark.parametrize("shape,want", ROUTES,
                         ids=[f"{m}x{k}x{n}" for (m, k, n), _ in ROUTES])
def test_gemm_s8_entry_route(shape, want):
    """Every K8 and projector dense of both towers takes w8a8_sm90.cu (K
    and N multiples of 16); other widths stay on w8a8.cu."""
    assert kernels.gemm_s8_entry(*shape) == want
    assert want in kernels._SIGNATURES and want in kernels.GEMM_S8_ROUTES


def _operands(m, k, n):
    a = torch.arange(m * k, dtype=torch.int32).remainder(251).sub(
        125).to(torch.int8).reshape(m, k)
    b = torch.arange(k * n, dtype=torch.int32).remainder(241).sub(
        120).to(torch.int8).reshape(k, n)
    return a, b


def _read(t, g, c0, c1):
    """The byte the map (offset, dims, stride, box) addresses at (inner c0,
    outer c1), read from t's storage."""
    off, d0, d1, stride = g[:4]
    assert 0 <= c0 < d0 and 0 <= c1 < d1
    return t.reshape(-1)[off + c1 * stride + c0].item()


@pytest.mark.parametrize("m,k,n", [(18464 // 16, 1024, 4096 // 8),
                                   (129, 1040, 272)])
def test_gemm_s8_sm90_tensor_maps(m, k, n):
    """a's map is [K x M] over its row stride with the 128 x 128 box, b's
    [N x K] over its row stride with the 128 x 128 box; every addressed
    byte is the one the plain product reads."""
    a, b = _operands(m, k, n)
    g = kernels.gemm_s8_sm90_geometry(a, b)
    assert len(g) == 12
    ga, gb = g[:6], g[6:]
    box_a = (kernels.GEMM_S8_SM90_BOX_K, kernels.GEMM_S8_SM90_BOX_ROWS)
    box_b = (kernels.GEMM_S8_SM90_BOX_COLS, kernels.GEMM_S8_SM90_BOX_K)
    assert ga == (0, k, m, k) + box_a
    assert gb == (0, n, k, n) + box_b
    assert box_a == (128, 128) and box_b == (128, 128)
    rng = np.random.default_rng(m)
    for _ in range(50):
        r, kk, c = (int(rng.integers(x)) for x in (m, k, n))
        assert _read(a, ga, kk, r) == a[r, kk].item()
        assert _read(b, gb, c, kk) == b[kk, c].item()


def test_gemm_s8_sm90_geometry_of_a_row_slice():
    """A block of rows of a larger activation tensor keeps its row stride
    (the map addresses through it)."""
    big = torch.zeros(64, 512, dtype=torch.int8)
    b = torch.zeros(256, 128, dtype=torch.int8)
    g = kernels.gemm_s8_sm90_geometry(big[16:48, :256], b)
    assert g[:4] == (0, 256, 32, 512)


@pytest.mark.parametrize("case", ["k_not_16", "n_not_16", "misaligned_base",
                                  "column_slice", "row_stride",
                                  "k_mismatch"])
def test_gemm_s8_sm90_geometry_refuses(case):
    """What TMA cannot address raises instead of reaching the C entry: K
    or N not a multiple of 16, a base off 16 bytes, a view whose last dim
    is not contiguous or whose row stride is not a multiple of 16 bytes,
    and a K that differs between the operands."""
    a = torch.zeros(32, 256, dtype=torch.int8)
    b = torch.zeros(256, 128, dtype=torch.int8)
    if case == "k_not_16":
        a, b = (torch.zeros(32, 264, dtype=torch.int8)[:, :260],
                torch.zeros(260, 128, dtype=torch.int8))
    elif case == "n_not_16":
        b = torch.zeros(256, 136, dtype=torch.int8)
    elif case == "misaligned_base":
        a = torch.zeros(32 * 256 + 16, dtype=torch.int8)[8:8 + 32 * 256] \
            .reshape(32, 256)
    elif case == "column_slice":
        a = torch.zeros(256, 32, dtype=torch.int8).t()
    elif case == "row_stride":
        a = torch.zeros(32, 264, dtype=torch.int8)[:, :256]
    elif case == "k_mismatch":
        b = torch.zeros(240, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="gemm_s8_sm90"):
        kernels.gemm_s8_sm90_geometry(a, b)


def test_gemm_s8_route_argument_is_checked():
    """`route` names a C entry of GEMM_S8_ROUTES or raises before any
    launch."""
    a, b = _operands(16, 256, 64)
    with pytest.raises(ValueError, match="route"):
        kernels.gemm_s8(a, b, route="cublas")


def _jax_dense_case(rng, lead, k, n):
    w = jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k), jnp.float32)
    q, scale = jquant.quantize_kernel(w, bits=8)
    p = {"kernel_qa": q, "kernel_scale": scale,
         "bias": jnp.asarray(rng.standard_normal(n) * 0.1, jnp.bfloat16)}
    x = jnp.asarray(rng.standard_normal((*lead, k)), jnp.bfloat16)
    return p, x


@pytest.mark.parametrize("lead,k,n", [((2, 75), 1040, 272),
                                      ((1, 129), 256, 400)])
def test_kernel_qa_dense_plain_bit_equal_to_jax(lead, k, n):
    """At widths the new kernel takes (K = 1040 = 16 x 65 leaves a K tail
    past the 128-deep stage, 150 and 129 rows an M tail, N 272 / 400 a
    partial channel tile), the port's plain kernel_qa dense (`nn.dense`
    over `int_matmul_plain`, with bias), the product the card is held to,
    equals the JAX package's `nn.dense` bit for bit; so does
    `gemm_s8_plain` with the bias epilogue on the same int8 operands."""
    rows = int(np.prod(lead))
    assert kernels.gemm_s8_entry(rows, k, n) == "vls_gemm_s8_sm90"
    p, x = _jax_dense_case(np.random.default_rng(k), lead, k, n)
    want = np.asarray(jnn.dense(p, x).astype(jnp.float32))
    tp = {name: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16 if name == "bias" else torch.float32)
        for name, v in p.items()}
    tp["kernel_qa"] = torch.from_numpy(np.array(p["kernel_qa"]))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tnn.dense(tp, tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    xq, a_s = jquant.quantize_activations_rowwise(x)
    xq = torch.from_numpy(np.array(xq)).reshape(rows, k)
    a_s = torch.from_numpy(np.array(a_s)).reshape(rows, 1)
    y = gemm_s8_plain(xq, tp["kernel_qa"], a_s, tp["kernel_scale"],
                      bias=tp["bias"])
    np.testing.assert_array_equal(y.float().reshape(*lead, n).numpy(), want)


def test_gemm_s8_plain_epilogue_steps():
    """gemm_s8_plain's dense epilogue is nn.dense's product and bias,
    then each further step rounded to bf16: the q scale by the bf16 of
    the scale, the residual added last; int32 mode is the exact
    product."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-127, 128, (37, 96), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (96, 48), dtype=np.int8))
    a_s = torch.from_numpy(rng.random((37, 1), dtype=np.float32) * 1e-3)
    w_s = torch.from_numpy(rng.random(48, dtype=np.float32) * 1e-3)
    bias = torch.from_numpy(rng.standard_normal(48)).to(torch.bfloat16)
    res = torch.from_numpy(rng.standard_normal((37, 48))).to(torch.bfloat16)
    acc = int_matmul_plain(a, b)
    assert torch.equal(gemm_s8_plain(a, b), acc)
    dense = (acc.float() * a_s * w_s).to(torch.bfloat16) + bias
    assert torch.equal(gemm_s8_plain(a, b, a_s, w_s, bias=bias), dense)
    assert torch.equal(gemm_s8_plain(a, b, a_s, w_s, bias=bias, residual=res),
                       res + dense)
    scale = 80 ** -0.5
    assert torch.equal(gemm_s8_plain(a, b, a_s, w_s, bias=bias, scale=scale),
                       dense * torch.tensor(scale).to(torch.bfloat16))
