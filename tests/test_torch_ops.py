"""PyTorch port (video_llava_seg_torch) vs the JAX package: the bridge,
the ops/ primitives, and the numpy / config copies the port carries so
that it runs without JAX. Inputs come from seeded numpy and go through
both packages; each assertion states its tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import bridge
from video_llava_seg_torch.ops import nn as tnn
from video_llava_seg_torch.ops import pooling as tpool
from video_llava_seg_torch.ops import resize as tresize
from video_llava_seg_torch.ops import rope as trope
from video_llava_seg_tpu.ops import nn as jnn
from video_llava_seg_tpu.ops import pooling as jpool
from video_llava_seg_tpu.ops import resize as jresize
from video_llava_seg_tpu.ops import rope as jrope

# fp32 on both sides; sums are taken in another order, so 1e-5 abs/rel
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_bridge_round_trip():
    tree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "b": [{"kernel": jnp.ones((3, 4), jnp.bfloat16)},
                  {"ids": jnp.arange(4, dtype=jnp.int32)}]}
    t = bridge.from_jax(tree)
    assert t["a"].dtype == torch.float32
    assert t["b"][0]["kernel"].dtype == torch.bfloat16
    assert t["b"][1]["ids"].dtype == torch.int32
    back = bridge.to_numpy(t)
    np.testing.assert_array_equal(back["a"], np.asarray(tree["a"]))
    np.testing.assert_array_equal(back["b"][0]["kernel"],
                                  np.ones((3, 4), np.float32))
    np.testing.assert_array_equal(back["b"][1]["ids"], np.arange(4))
    t16 = bridge.from_jax(tree, dtype=torch.bfloat16)
    assert t16["a"].dtype == torch.bfloat16
    assert t16["b"][1]["ids"].dtype == torch.int32


@pytest.mark.parametrize("bias", [True, False])
def test_dense(bias):
    p = jnn.dense_init(jax.random.PRNGKey(0), 24, 40, bias=bias)
    if bias:
        p["bias"] = p["bias"] + 0.3
    x = _rng().standard_normal((3, 5, 24)).astype(np.float32)
    want = jnn.dense(p, jnp.asarray(x))
    got = tnn.dense(bridge.from_jax(p), _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("key", ["lora"])
def test_dense_out_of_slice_kinds_raise(key):
    """The LoRA side branch was out of the serving slices and came with
    the training slice: it now computes dense(base) + ((x @ a) @ b) * s
    (tests/test_torch_train_parts.py holds it against the JAX package)."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(4, 2, generator=g), torch.randn(2, 4, generator=g)
    x, w = torch.randn(2, 4, generator=g), torch.randn(4, 4, generator=g)
    p = {"kernel": w, key: {"a": a, "b": b, "s": torch.tensor(8.0)}}
    torch.testing.assert_close(tnn.dense(p, x), x @ w + (x @ a @ b) * 8.0)


@pytest.mark.parametrize("fn", ["layer_norm", "rms_norm", "layer_norm_2d"])
def test_norms(fn):
    r = _rng(1)
    d = 48
    p = {"scale": r.standard_normal(d).astype(np.float32),
         "bias": r.standard_normal(d).astype(np.float32)}
    if fn == "rms_norm":
        del p["bias"]
    x = (3 * r.standard_normal((2, 7, d)) + 1).astype(np.float32)
    want = getattr(jnn, fn)(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = getattr(tnn, fn)(bridge.from_jax(p), _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("k,stride,padding", [
    (1, 1, "SAME"), (3, 1, "SAME"), (14, 14, "VALID"), (7, 4, [(3, 3)] * 2),
    (2, 2, "VALID")])
def test_conv2d(k, stride, padding):
    p = jnn.conv2d_init(jax.random.PRNGKey(2), 3, 8, (k, k))
    p["bias"] = p["bias"] + 0.1
    x = _rng(2).standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = jnn.conv2d(p, jnp.asarray(x), stride=(stride, stride),
                      padding=padding)
    got = tnn.conv2d(bridge.from_jax(p), _t(x), stride=(stride, stride),
                     padding=padding)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-5)


def test_conv_transpose2d():
    p = jnn.conv_transpose2d_init(jax.random.PRNGKey(3), 16, 4, (2, 2))
    p["bias"] = p["bias"] + 0.2
    x = _rng(3).standard_normal((2, 5, 6, 16)).astype(np.float32)
    want = jnn.conv_transpose2d(p, jnp.asarray(x), (2, 2))
    got = tnn.conv_transpose2d(bridge.from_jax(p), _t(x), (2, 2))
    assert got.shape == (2, 10, 12, 4)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_gelu_mlp_embedding():
    r = _rng(4)
    x = (3 * r.standard_normal((4, 9))).astype(np.float32)
    np.testing.assert_allclose(tnn.gelu(_t(x)).numpy(),
                               _np(jnn.gelu(jnp.asarray(x))), **TOL)
    p = jnn.mlp_init(jax.random.PRNGKey(4), [9, 16, 5])
    for sig in (False, True):
        want = jnn.mlp_apply(p, jnp.asarray(x), sigmoid_output=sig)
        got = tnn.mlp_apply(bridge.from_jax(p), _t(x), sigmoid_output=sig)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    e = jnn.embedding_init(jax.random.PRNGKey(5), 30, 8)
    ids = r.integers(0, 30, (2, 6))
    np.testing.assert_array_equal(
        tnn.embedding_lookup(bridge.from_jax(e), torch.from_numpy(ids)),
        np.asarray(jnn.embedding_lookup(e, jnp.asarray(ids))))


def test_rope_1d():
    r = _rng(5)
    pos = r.integers(0, 5000, (1, 11))
    x = r.standard_normal((1, 3, 11, 32)).astype(np.float32)
    jc, js = jrope.rope_1d_cos_sin(jnp.asarray(pos), 32, 500000.0)
    tc, ts = trope.rope_1d_cos_sin(torch.from_numpy(pos), 32, 500000.0)
    # angles up to ~5e3 rad: fp32 range reduction differs in the last ulps
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=2e-4)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=2e-4)
    want = jrope.apply_rope_1d(jnp.asarray(x), jc, js)
    got = trope.apply_rope_1d(_t(x), _t(jc), _t(js))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("hw,out", [((24, 24), (4, 4)), ((7, 9), (3, 2))])
def test_adaptive_avg_pool(hw, out):
    np.testing.assert_array_equal(tpool._adaptive_pool_matrix(hw[0], out[0]),
                                  jpool._adaptive_pool_matrix(hw[0], out[0]))
    x = _rng(6).standard_normal((2, 3, *hw, 5)).astype(np.float32)
    want = jpool.adaptive_avg_pool_2d(jnp.asarray(x), out)
    got = tpool.adaptive_avg_pool_2d(_t(x), out)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("method,size,ac,aa", [
    ("bilinear", (40, 21), False, False),   # seg postprocess / resize
    ("nearest", (16, 16), False, False),    # FPN top-down
    ("bicubic", (16, 16), False, False),    # Hiera background PE
    ("bicubic", (11, 13), True, False),     # CLIP PE resize
    ("bilinear", (5, 6), False, True),      # antialiased downscale
])
def test_interpolate(method, size, ac, aa):
    x = _rng(7).standard_normal((2, 8, 8, 3)).astype(np.float32)
    for n_in, n_out in ((8, size[0]), (8, size[1])):
        np.testing.assert_array_equal(
            tresize._resize_matrix(n_in, n_out, method, aa, ac),
            jresize._resize_matrix(n_in, n_out, method, aa, ac))
    want = jresize.interpolate(jnp.asarray(x), size, method, antialias=aa,
                               align_corners=ac)
    got = tresize.interpolate(_t(x), size, method, antialias=aa,
                              align_corners=ac)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    m = x[..., 0]
    np.testing.assert_allclose(
        tresize.interpolate_hw(_t(m), size, method).numpy(),
        _np(jresize.interpolate_hw(jnp.asarray(m), size, method)), **TOL)


# ---------------------------------------------------------------------------
# copies the port carries (it must run where the JAX package cannot)
# ---------------------------------------------------------------------------

def test_config_copies_match():
    from video_llava_seg_torch import config as tcfg
    from video_llava_seg_torch.models.sam2 import config as tsam
    from video_llava_seg_tpu import config as jcfg
    from video_llava_seg_tpu.models.sam2 import config as jsam

    assert (dataclasses.asdict(tcfg.VideoLlavaConfig())
            == dataclasses.asdict(jcfg.VideoLlavaConfig()))
    assert (dataclasses.asdict(tcfg.VideoLlavaConfig.tiny())
            == dataclasses.asdict(jcfg.VideoLlavaConfig.tiny()))
    assert tcfg.VideoLlavaConfig().tokens_per_slow_frame == 576
    for name in ("TrainConfig", "OptimGroupLRs", "DataConfig"):
        assert (dataclasses.asdict(getattr(tcfg, name)())
                == dataclasses.asdict(getattr(jcfg, name)()))
    for name in ("tiny", "small", "base_plus", "large", "sam2-test-tiny",
                 "sam2-hiera-small"):
        for size in (1024, 64):
            a = tsam.sam2_config(name, image_size=size)
            b = jsam.sam2_config(name, image_size=size)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.hiera.stage_ends == b.hiera.stage_ends
            assert a.hiera.q_pool_blocks == b.hiera.q_pool_blocks


def test_block_dims_match():
    from video_llava_seg_torch.models.sam2 import config as tsam
    from video_llava_seg_torch.models.sam2 import hiera as thiera
    from video_llava_seg_tpu.models.sam2 import hiera as jhiera

    for name in ("tiny", "small", "large"):
        cfg = tsam.sam2_config(name).hiera
        assert thiera.block_dims(cfg) == jhiera._block_dims(cfg)


class _Tok:
    bos_token_id = 1

    def __call__(self, text):
        class R:
            input_ids = [1] + [5 + (ord(c) % 300) for c in text]
        return R()


def test_prompt_and_tokenizer_copies_match():
    from video_llava_seg_torch import conversation as tconv
    from video_llava_seg_torch.config import VideoLlavaConfig
    from video_llava_seg_torch.inference import main as tmain
    from video_llava_seg_torch.mm_utils import tokenizer_image_token as tt
    from video_llava_seg_tpu import conversation as jconv
    from video_llava_seg_tpu.inference import main as jmain
    from video_llava_seg_tpu.mm_utils import tokenizer_image_token as jt

    cfg = VideoLlavaConfig()
    for name in jconv.conv_templates:
        assert tconv.conv_templates[name].copy().get_prompt() == \
            jconv.conv_templates[name].copy().get_prompt()
        for qs in (tmain.CAPTION_PROMPT, "\nthe dog Please output the "
                   "segmentation mask."):
            pt = tmain.build_prompt(cfg, qs, name)
            assert pt == jmain.build_prompt(cfg, qs, name)
            assert tt(pt, _Tok()) == jt(pt, _Tok())
        assert (tmain.keyword_stop_sequences(_Tok(), name)
                == jmain.keyword_stop_sequences(_Tok(), name))


@pytest.mark.parametrize("pad_side,lens", [("right", None),
                                           ("left", [30, 22])])
def test_splice_plan_copy_matches(pad_side, lens):
    from video_llava_seg_torch.config import VideoLlavaConfig
    from video_llava_seg_torch.models import llava as tllava
    from video_llava_seg_tpu.models import llava as jllava

    cfg = VideoLlavaConfig.tiny()
    n_img = len(jllava.visual_tokens_per_sample(cfg))
    assert tllava.visual_tokens_per_sample(cfg) == \
        jllava.visual_tokens_per_sample(cfg)
    r = _rng(8)
    ids = r.integers(1, 100, (2, 30))
    ids[:, 3:3 + n_img] = -200
    labels = r.integers(0, 100, (2, 30))
    kw = dict(labels=labels, pad_side=pad_side, pad_to=80,
              input_lens=None if lens is None else np.asarray(lens))
    a = tllava.build_splice_plan(ids, tllava.visual_tokens_per_sample(cfg),
                                 **kw)
    b = jllava.build_splice_plan(ids, jllava.visual_tokens_per_sample(cfg),
                                 **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


def test_resize_padding_params_copy_matches():
    from video_llava_seg_torch.vision_utils import (
        get_resize_padding_params as tf,
    )
    from video_llava_seg_tpu.vision_utils import (
        get_resize_padding_params as jf,
    )

    for h, w in ((480, 854), (720, 1280), (1000, 600), (64, 64)):
        for mode in ("center", "topleft"):
            assert tf(h, w, 1024, mode) == jf(h, w, 1024, mode)


def test_clip_preprocess_matches_pil():
    """Torch CLIP preprocessing vs the JAX package's PIL path. PIL resizes
    uint8 in fixed point (22-bit weights, rounding after each pass); the
    port rounds after each pass in float64, so a pixel may land one level
    away: tolerance 1 uint8 level, i.e. 1/255/std after normalisation."""
    from video_llava_seg_torch.inference.utils import (
        CLIP_IMAGE_STD,
        clip_preprocess_frames,
    )
    from video_llava_seg_tpu.data.vicas import (
        CLIP_IMAGE_MEAN,
        clip_preprocess_frames as pil_preprocess,
        expand2square_batch,
    )

    frames = _rng(9).integers(0, 256, (2, 48, 86, 3), dtype=np.uint8)
    fill = tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)
    for size in (56, 24, 100):
        want = pil_preprocess(expand2square_batch(frames, fill), size)
        got = clip_preprocess_frames(torch.from_numpy(frames), size).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1.0 / 255 / min(CLIP_IMAGE_STD) + 1e-6)


@pytest.mark.parametrize("hw,mode", [((48, 64), "topleft"),
                                     ((70, 50), "center")])
def test_seg_preprocess_matches_host_resize(hw, mode):
    """Torch seg-frame resize + pad vs the JAX package's resize_host path
    (both bilinear, align_corners=False); fp32 sums in another order:
    1e-5 abs."""
    from video_llava_seg_torch.inference.utils import preprocess_seg_inputs
    from video_llava_seg_tpu.inference.utils import (
        preprocess_seg_inputs as jpre,
    )

    frames = _rng(10).integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    want, wmeta = jpre(frames, {"orig_image_size": hw}, tgt_size=64,
                       pad_mode=mode)
    got, gmeta = preprocess_seg_inputs(torch.from_numpy(frames),
                                       {"orig_image_size": hw}, 64,
                                       pad_mode=mode)
    assert gmeta["padding"] == tuple(wmeta["padding"])
    assert gmeta["resized_image_size"] == tuple(wmeta["resized_image_size"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# kernel plumbing that a CPU can check
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_plain_and_count_no_launch():
    """On a CPU tensor each K1..K4, K7 and K8 wrapper (and int_matmul)
    runs its plain version and leaves the launch counters alone (they
    count kernel launches only)."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops.attention import attention
    from video_llava_seg_torch.ops.hiera_block import hiera_block
    from video_llava_seg_torch.ops.int4 import int_matmul
    from video_llava_seg_torch.ops.quantization import quantize_tree
    from video_llava_seg_torch.ops.vit_block import vit_layer
    from video_llava_seg_torch.ops.window_attention import window_attention

    before = kernels.LAUNCHES.snapshot()
    g = torch.Generator().manual_seed(0)
    d = 32
    vit_p = {n: tnn.dense_init(g, d, d, "cpu", torch.float32)
             for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    vit_p.update(layer_norm1=tnn.layer_norm_init(d, "cpu", torch.float32),
                 layer_norm2=tnn.layer_norm_init(d, "cpu", torch.float32),
                 fc1=tnn.dense_init(g, d, 2 * d, "cpu", torch.float32),
                 fc2=tnn.dense_init(g, 2 * d, d, "cpu", torch.float32))
    vit_layer(vit_p, torch.randn(2, 5, d), num_heads=2, eps=1e-5)
    q = torch.randn(1, 2, 1100, 16)
    attention(q, q, q, causal=True)
    attention(q[:, :, :9], q[:, :, :9], q[:, :, :9])
    blk = {"norm1": tnn.layer_norm_init(d, "cpu", torch.float32),
           "norm2": tnn.layer_norm_init(d, "cpu", torch.float32),
           "qkv": tnn.dense_init(g, d, 3 * d, "cpu", torch.float32),
           "proj_attn": tnn.dense_init(g, d, d, "cpu", torch.float32),
           "mlp": tnn.mlp_init(g, [d, 2 * d, d], "cpu", torch.float32)}
    hiera_block(blk, torch.randn(1, 8, 8, d), num_heads=1, ws=4)
    window_attention(torch.randn(1, 8, 8, 3 * d), num_heads=2, ws=4,
                     q_pool=(2, 2))
    vit_layer(quantize_tree(vit_p, 8, act_quant=True, min_size=0),
              torch.randn(2, 5, d), num_heads=2, eps=1e-5)
    int_matmul(torch.ones(3, 8, dtype=torch.int8),
               torch.ones(8, 4, dtype=torch.int8))
    assert kernels.LAUNCHES.snapshot() == before


@pytest.mark.parametrize("call", ["layernorm", "gemm", "attention",
                                  "maxpool2x2", "quant_rows",
                                  "ln_quant_rows", "gemm_s8",
                                  "window_attention"])
def test_raw_kernel_wrappers_refuse_cpu_tensors(call):
    """The raw CUDA wrappers check their inputs before touching the
    library: a CPU tensor is refused, never silently computed."""
    from video_llava_seg_torch import kernels

    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    q = torch.zeros(1, 1, 4, 16, dtype=torch.bfloat16)
    args = {"layernorm": ((x, x[0], x[0], 1e-5), {}),
            "gemm": ((x, x.t()), {}),
            "attention": ((q, q, q), {"scale": 1.0}),
            "maxpool2x2": ((x.view(1, 2, 2, 8),), {}),
            "quant_rows": ((x,), {}),
            "ln_quant_rows": ((x, x[0].float(), x[0].float(), 1e-5), {}),
            "gemm_s8": ((x.to(torch.int8), x.t().to(torch.int8)), {}),
            "window_attention": ((torch.zeros(1, 4, 4, 48,
                                              dtype=torch.bfloat16),),
                                 {"num_heads": 2, "ws": 4, "scale": 1.0})}
    a, kw = args[call]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, call)(*a, **kw)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from video_llava_seg_torch import kernels

    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(kernels, "_find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
    assert not (tmp_path / "build").exists()
    counts = kernels.LaunchCounts()
    counts.add("K2")
    assert counts.snapshot() == {"K1": 0, "K2": 1, "K3": 0, "K4": 0,
                                 "K5": 0, "K6a": 0, "K6b": 0, "K7": 0,
                                 "K8": 0}
    counts.reset()
    assert set(counts.snapshot().values()) == {0}
