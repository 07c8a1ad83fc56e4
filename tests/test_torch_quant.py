"""The port's quantized serving pieces against the JAX package, on the CPU:
int4 packing, tree and activation quantization, the plain W4A8 product
(K5's plain version), nn.dense over the four kernel kinds, the int8-KV
attention twin, the fused qkv / gate-up layout and the four lm-head
kinds. Inputs come from seeded numpy or from JAX inits bridged leaf for
leaf. Integer work is held bit-equal; float work states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import bridge, kernels
from video_llava_seg_torch.models import llama as tllama
from video_llava_seg_torch.ops import attention as tattn
from video_llava_seg_torch.ops import int4 as tint4
from video_llava_seg_torch.ops import nn as tnn
from video_llava_seg_torch.ops import quantization as tquant
from video_llava_seg_tpu.config import LlamaConfig
from video_llava_seg_tpu.models import llama as jllama
from video_llava_seg_tpu.ops import attention as jattn
from video_llava_seg_tpu.ops import int4 as jint4
from video_llava_seg_tpu.ops import nn as jnn
from video_llava_seg_tpu.ops import quantization as jquant

# fp32 on both sides, sums in another order
TOL = dict(atol=1e-5, rtol=1e-5)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_trees_equal(got, want):
    """Same keys, same dtypes (bf16 read as fp32), bit-equal values."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        a = np.asarray(w[k])
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        b = g[k]
        b = (b.float() if b.dtype == torch.bfloat16 else b).numpy()
        assert b.dtype == a.dtype, (k, b.dtype, a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=k)


def test_pack_unpack_bit_equal():
    q = np.random.default_rng(0).integers(-7, 8, (64, 200)).astype(np.int8)
    jp = jint4.pack_int4(jnp.asarray(q))
    tp = tint4.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for got, want in zip(tint4.unpack_int4(tp), jint4.unpack_int4(jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lo, hi = tint4.unpack_int4(tp)
    np.testing.assert_array_equal(torch.cat([lo, hi]).numpy(), q)


@pytest.mark.parametrize("bits,act_quant", [(8, False), (8, True),
                                            (4, False), (4, True)])
def test_quantize_tree_bit_equal(bits, act_quant):
    """Same keys and bit-equal int8 leaves and fp32 scales; under 4-bit
    the odd-`in` kernel stays float, and kernels under min_size too."""
    r = np.random.default_rng(bits + act_quant)
    tree = {"embed_tokens": {"embedding": r.standard_normal((40, 16))},
            "a": {"kernel": r.standard_normal((64, 48)),
                  "bias": r.standard_normal(48)},
            "odd": {"kernel": r.standard_normal((33, 40))},
            "small": {"kernel": r.standard_normal((4, 4))},
            "zero": [{"kernel": np.zeros((16, 24))}]}
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    kw = dict(bits=bits, act_quant=act_quant, min_size=64)
    want = jquant.quantize_tree(tree, **kw)
    got = tquant.quantize_tree(bridge.from_jax(tree), **kw)
    assert_trees_equal(got, want)
    assert ("kernel" in got["odd"]) == (bits == 4 and act_quant)
    assert "kernel" in got["small"]


def test_quantize_tree_train_mode_is_training_slice():
    """train_mode came with the training slice: weight-only int8 with
    bf16 scales, bit-equal to the JAX package's; act_quant refused."""
    tree = {"kernel": jnp.asarray(np.random.default_rng(3).standard_normal(
        (16, 24)), jnp.float32)}
    want = jquant.quantize_tree(tree, train_mode=True, min_size=0)
    got = tquant.quantize_tree(bridge.from_jax(tree), train_mode=True,
                               min_size=0)
    assert got["kernel_scale"].dtype == torch.bfloat16
    assert_trees_equal(got, want)
    with pytest.raises(ValueError, match="train_mode"):
        tquant.quantize_tree({"kernel": torch.ones(4, 4)}, train_mode=True,
                             act_quant=True)


def test_quantize_activations_rowwise_bit_equal():
    x = np.random.default_rng(1).standard_normal((7, 96)).astype(np.float32)
    x[3] = 0.0  # the amax == 0 guard
    x[5] *= 1e-3
    jq, js = jquant.quantize_activations_rowwise(jnp.asarray(x))
    tq, ts = tquant.quantize_activations_rowwise(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tquant.quantized_nbytes({"q": tq, "s": ts}) == \
        jquant.quantized_nbytes({"q": jq, "s": js})


@pytest.mark.parametrize("rows", [1, 3, 8, 9, 300])
def test_w4a8_plain_bit_equal_to_pallas_and_xla(rows):
    """K5's plain version against the TPU kernel in interpret mode (as
    tests/test_int4.py runs it) and against the XLA unpack branch, in
    fp32 and bf16 output."""
    r = np.random.default_rng(rows)
    w = jnp.asarray(r.standard_normal((256, 384)) * 0.1, jnp.float32)
    q, scale = jquant.quantize_kernel(w, bits=4)
    packed = jint4.pack_int4(q)
    x = jnp.asarray(r.standard_normal((rows, 256)), jnp.float32)
    xq, a_s = jquant.quantize_activations_rowwise(x)
    lo, hi = jint4.unpack_int4(packed)
    acc = (jnp.dot(xq[:, :128], lo, preferred_element_type=jnp.int32)
           + jnp.dot(xq[:, 128:], hi, preferred_element_type=jnp.int32))
    t = [torch.from_numpy(np.array(a)) for a in (xq, a_s, packed, scale)]
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        got = tint4.w4a8_matmul_plain(*t, tdt).float().numpy()
        xla = (acc.astype(jnp.float32) * a_s * scale).astype(jdt)
        np.testing.assert_array_equal(got, np.asarray(xla, np.float32))
        if jdt == jnp.float32:
            pallas = jint4.w4a8_matmul(xq, a_s, packed, scale, jdt,
                                       interpret=True)
            np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("kind", ["kernel", "kernel_q", "kernel_qa",
                                  "kernel_q4a"])
@pytest.mark.parametrize("bias", [True, False])
def test_dense_all_kernel_kinds(kind, bias):
    """Integer kinds are exact up to the last fp32 rounding of the
    scales; the float kind sums in another order (1e-5)."""
    p = jnn.dense_init(jax.random.PRNGKey(0), 128, 256, bias=bias)
    if bias:
        p["bias"] = p["bias"] + 0.3
    if kind != "kernel":
        p = jquant.quantize_tree(p, bits=4 if kind == "kernel_q4a" else 8,
                                 act_quant=kind != "kernel_q", min_size=0)
        assert kind in p
    x = np.random.default_rng(2).standard_normal((3, 5, 128)).astype(
        np.float32)
    want = np.asarray(jnn.dense(p, jnp.asarray(x)))
    before = kernels.LAUNCHES.snapshot()
    got = tnn.dense(bridge.from_jax(p), torch.from_numpy(x)).numpy()
    assert kernels.LAUNCHES.snapshot() == before  # CPU: plain, no launch
    if kind in ("kernel_qa", "kernel_q4a"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_dense_bf16_weight_only_train_mode_branch():
    """A bf16 kernel_scale marks a train-mode tree: the product and the
    scale stay in the compute dtype, as in the JAX package."""
    p = jquant.quantize_tree(jnn.dense_init(jax.random.PRNGKey(1), 64, 128),
                             bits=8, min_size=0, train_mode=True)
    assert p["kernel_scale"].dtype == jnp.bfloat16
    x = np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32)
    want = np.asarray(jnn.dense(p, jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    tp = bridge.from_jax(p)
    assert tp["kernel_scale"].dtype == torch.bfloat16
    got = tnn.dense(tp, torch.from_numpy(x).to(torch.bfloat16)).float()
    # bf16 outputs; a one-ulp difference where fp32 sums round apart
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)


def test_w4a8_raw_wrapper_refuses_cpu_tensors():
    xq = torch.zeros(2, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.w4a8_matmul(xq, torch.ones(2, 1), xq.t().contiguous()[:8],
                            torch.ones(2), torch.bfloat16)


@pytest.mark.parametrize("half,out,want", [(2048, 6144, 8), (2048, 4096, 8),
                                           (2048, 28672, 5), (7168, 4096, 28),
                                           (2048, 128256, 2), (64, 256, 1)])
def test_w4a8_gemv_split_choice(half, out, want):
    """Decode splits K over blocks only where out has few column tiles,
    and never below 64 groups of 4 packed rows per block."""
    assert kernels.w4a8_splits(half, out) == want


@pytest.mark.parametrize("group", [1, 2])
def test_int8_kv_attention_twin(group):
    """k_scale folds into the scores after QK, v_scale into the weights
    before PV (rounded to q's dtype): fp32 (1e-5) and bf16 (2e-2)."""
    r = np.random.default_rng(4)
    b, hkv, sq, skv, d = 2, 2, 3, 11, 16
    q = r.standard_normal((b, hkv * group, sq, d)).astype(np.float32)
    k = r.integers(-127, 128, (b, hkv, skv, d)).astype(np.int8)
    v = r.integers(-127, 128, (b, hkv, skv, d)).astype(np.int8)
    ks = (r.random((b, hkv, skv)) * 0.02).astype(np.float32)
    vs = (r.random((b, hkv, skv)) * 0.02).astype(np.float32)
    mask = np.ones((b, skv), bool)
    mask[0, :4] = False
    for jdt, tdt, tol in ((jnp.float32, torch.float32, TOL),
                          (jnp.bfloat16, torch.bfloat16,
                           dict(atol=2e-2, rtol=2e-2))):
        want = jattn.attention_reference(
            jnp.asarray(q, jdt), jnp.asarray(k), jnp.asarray(v),
            kv_valid_len=9, kv_mask=jnp.asarray(mask),
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        got = tattn.attention_reference(
            torch.from_numpy(q).to(tdt), torch.from_numpy(k),
            torch.from_numpy(v), kv_valid_len=9,
            kv_mask=torch.from_numpy(mask), k_scale=torch.from_numpy(ks),
            v_scale=torch.from_numpy(vs))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def _tiny_llm(seed=0):
    cfg = LlamaConfig.tiny()
    return cfg, jllama.init(jax.random.PRNGKey(seed), cfg)


@pytest.mark.parametrize("bits,act_quant", [(None, False), (8, False),
                                            (4, True)])
def test_fuse_qkv_gateup_bitwise(bits, act_quant):
    """The fused layout gives the same tree as the JAX package's fusion;
    under W4A8 (integer sums) the unfused tree's logits and hidden states
    bit for bit, under float kernels within 1e-5 (a wider fp32 product
    may block its sums otherwise)."""
    cfg, p = _tiny_llm()
    if bits:
        p = jquant.quantize_tree(p, bits=bits, act_quant=act_quant,
                                 min_size=0)
    fused = tllama.fuse_qkv_gateup(bridge.from_jax(p))
    assert_trees_equal(fused, jllama.fuse_qkv_gateup(p))
    assert "wqkv" in fused["layers"][0]["attn"]
    assert "w_gateup" in fused["layers"][0]["mlp"]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 7, cfg.hidden_size)).astype(np.float32))
    outs = []
    for tree in (bridge.from_jax(p), fused):
        cache = tllama.init_kv_cache(cfg, 2, 9, "cpu", torch.float32)
        outs.append(tllama.prefill(tree, cfg, x, torch.arange(7), cache)[:2])
    for a, b in zip(*outs):
        if bits == 4:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("kind", ["kernel", "kernel_q", "kernel_qa",
                                  "kernel_q4a", "tied"])
def test_unembed_all_head_kinds(kind):
    cfg, p = _tiny_llm(1)
    if kind == "tied":
        import dataclasses

        cfg = dataclasses.replace(cfg, tie_word_embeddings=True)
        p = {k: v for k, v in p.items() if k != "lm_head"}
    elif kind != "kernel":
        p = dict(p)
        p["lm_head"] = jquant.quantize_tree(
            p["lm_head"], bits=4 if kind == "kernel_q4a" else 8,
            act_quant=kind != "kernel_q", min_size=0)
        assert kind in p["lm_head"]
    h = np.random.default_rng(6).standard_normal(
        (2, 3, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(jllama.unembed(p, cfg, jnp.asarray(h)))
    got = tllama.unembed(bridge.from_jax(p), cfg, torch.from_numpy(h))
    assert got.dtype == torch.float32
    if kind in ("kernel_qa", "kernel_q4a"):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_init_quantized_is_quantize_tree_of_init():
    """One layer at a time gives the tree quantize_tree gives for the
    whole float init over the same draws; the embedding stays float."""
    cfg = LlamaConfig.tiny()
    kw = dict(bits=4, act_quant=True, min_size=1024)
    got = tllama.init_quantized(cfg, torch.Generator().manual_seed(0), "cpu",
                                torch.float32, **kw)
    want = tquant.quantize_tree(
        tllama.init(cfg, torch.Generator().manual_seed(0), "cpu",
                    torch.float32), **kw)
    assert_trees_equal(got, bridge.to_numpy(want))
    assert "kernel_q4a" in got["layers"][0]["mlp"]["w_gate"]
    assert got["embed_tokens"]["embedding"].dtype == torch.float32


def test_bridge_keeps_quantized_leaves():
    """Casting a W4A8 tree to bf16 leaves the int8 kernels and the fp32
    scales alone (a bf16 kernel_scale would select the train-mode
    branch of nn.dense)."""
    cfg, p = _tiny_llm()
    p = jquant.quantize_tree(p, bits=4, act_quant=True, min_size=0)
    t = bridge.from_jax(p, dtype=torch.bfloat16)
    wq = t["layers"][0]["attn"]["wq"]
    assert wq["kernel_q4a"].dtype == torch.int8
    assert wq["kernel_scale"].dtype == torch.float32
    assert t["embed_tokens"]["embedding"].dtype == torch.bfloat16
    back = bridge.cast_tree(t, "cpu", torch.float32)
    assert back["layers"][0]["attn"]["wq"]["kernel_q4a"].dtype == torch.int8
    np.testing.assert_array_equal(
        back["layers"][0]["attn"]["wq"]["kernel_scale"].numpy(),
        np.asarray(p["layers"][0]["attn"]["wq"]["kernel_scale"]))
