"""The vision side of the port against the JAX package on the CPU: the
RADIO tower (input conditioner, patch bias, register token, no pre-norm,
erf-GELU, final norm), its converter (patch-size and grid
interpolation included), the S2 multi-scale wrapper, the position-table
resize, a W8A8 tower, `encode_video` over a RADIO tower, and a synthetic
reference checkpoint with a RADIO tower through both loaders and both
serving CLIs.

Trees: the RADIO weights come from the timm-shaped torch oracle of
tests/test_radio.py through each package's converter (leaf-equal, or
within 1e-6 where the bicubic resize runs as fp32 products in either
framework); CLIP-shaped trees from the port's seeded init as numpy.
Tolerance: fp32, 2e-5 for one tower (a few layers of sums in another
order), 1e-4 for the whole serving path (test_torch_slice.py's ATOL).
The W8A8 tower's per-row int8 rounding may flip where the last bits of
the fp32 sums differ: see W8A8_TOL."""

import dataclasses
import json
import os.path as osp
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_inference_cli import FakeTokenizer, _write_fixture
from test_radio import CFG as JRADIO, _RadioShaped
from test_torch_quant import assert_trees_equal
from test_torch_serving import _reference_state_dict

from video_llava_seg_torch import bridge
from video_llava_seg_torch import config as tconfig
from video_llava_seg_torch.convert import llava_torch as tconv
from video_llava_seg_torch.convert.radio import convert_radio
from video_llava_seg_torch.inference import main as tmain
from video_llava_seg_torch.models import llava as tllava
from video_llava_seg_torch.models import vit as tvit
from video_llava_seg_torch.ops import quantization as tquant
from video_llava_seg_tpu.config import (
    ProjectorConfig,
    SegHeadConfig,
    VideoLlavaConfig,
    VisionTowerConfig,
)
from video_llava_seg_tpu.convert import llava_torch as jconv
from video_llava_seg_tpu.convert.radio import convert_radio as jconvert
from video_llava_seg_tpu.inference import main as jmain
from video_llava_seg_tpu.models import llava as jllava
from video_llava_seg_tpu.models import vit as jvit
from video_llava_seg_tpu.ops import quantization as jquant
from video_llava_seg_tpu.ops.masks import decode_rle

TOL = dict(atol=2e-5, rtol=2e-5)
SERVE_ATOL = 1e-4
# W8A8 tower (3 layers, fp32): a last-bit difference at an int8 rounding
# boundary moves one row's dense output by a quantization step (~1e-3
# here), which attention carries to the frame's other tokens in the
# next layers; a fault moves the features by their own scale (~1).
# Measured here: one of the two frames off, max 1.0e-2 (features up to
# 3.5), mean 1.2e-3 over both; the other frame within 2.4e-6.
W8A8_TOL = dict(atol=3e-2, rtol=0)
W8A8_MEAN = 5e-3
TRADIO = tconfig.VisionTowerConfig(**dataclasses.asdict(JRADIO))


def _radio_sd(seed, **kw):
    torch.manual_seed(seed)
    return _RadioShaped(JRADIO, **kw).eval().radio_state_dict()


def _images(seed, n, size):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("src", [{}, {"src_patch": 8, "src_grid": 6}])
def test_convert_radio_matches_jax(src):
    sd = _radio_sd(1, **src)
    want = jconvert(sd, JRADIO)
    got = convert_radio({k: torch.from_numpy(v) for k, v in sd.items()},
                        TRADIO)
    if not src:
        assert_trees_equal(got, want)
        return
    # interpolated leaves: the same resize matrices, products in fp32
    g, w = bridge.to_numpy(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(g) == jax.tree.structure(w)
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    assert got["patch_embedding"]["kernel"].shape == (16, 16, 3, 48)
    assert got["position_embedding"].shape == (16, 48)


def test_convert_radio_refuses_other_register_counts():
    sd = _radio_sd(2)
    cfg = dataclasses.replace(TRADIO, num_register_tokens=2)
    with pytest.raises(ValueError, match="register"):
        convert_radio({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)


def test_radio_tower_matches_jax_and_timm_oracle():
    torch.manual_seed(0)
    ref = _RadioShaped(JRADIO).eval()
    sd = ref.radio_state_dict()
    tp = convert_radio({k: torch.from_numpy(v) for k, v in sd.items()},
                       TRADIO)
    jp = jconvert(sd, JRADIO)
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    got = tvit.apply(tp, TRADIO, torch.from_numpy(x)).numpy()
    want = np.asarray(jvit.apply(jp, JRADIO, jnp.asarray(x)))
    assert got.shape == (2, 16, 48)
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        oracle = ref(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, oracle, atol=2e-4, rtol=2e-4)


def test_radio_init_runs_like_the_jax_tree():
    """The port's RADIO init (patch bias, register token, identity
    conditioner) through both packages' apply, video-shaped input."""
    tp = tvit.init(TRADIO, torch.Generator().manual_seed(3), "cpu",
                   torch.float32)
    assert tp["patch_embedding"]["bias"].shape == (48,)
    assert tp["register_tokens"].shape == (1, 48)
    jp = jax.tree.map(jnp.asarray, bridge.to_numpy(tp))
    x = _images(4, 6, 64).reshape(2, 3, 64, 64, 3)
    got = tvit.apply(tp, TRADIO, torch.from_numpy(x)).numpy()
    want = np.asarray(jvit.apply(jp, JRADIO, jnp.asarray(x)))
    assert got.shape == (2, 3, 16, 48)
    np.testing.assert_allclose(got, want, **TOL)


S2 = VisionTowerConfig(name="tiny-s2", image_size=28, patch_size=14,
                       hidden_size=64, intermediate_size=128, num_layers=2,
                       num_heads=2, s2_scales=(28, 56))


def test_s2_matches_jax():
    tcfg = tconfig.VisionTowerConfig(**dataclasses.asdict(S2))
    tp = tvit.init(tcfg, torch.Generator().manual_seed(5), "cpu",
                   torch.float32)
    jp = jax.tree.map(jnp.asarray, bridge.to_numpy(tp))
    x = _images(6, 4, 56).reshape(2, 2, 56, 56, 3)
    got = tvit.apply_s2(tp, tcfg, torch.from_numpy(x)).numpy()
    want = np.asarray(jvit.apply_s2(jp, S2, jnp.asarray(x)))
    assert got.shape == (2, 2, 4, 128)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("radio", [False, True])
def test_resize_position_embedding_matches_jax(radio):
    native = JRADIO if radio else S2
    cfg = dataclasses.replace(native, image_size=native.image_size * 3 // 2)
    tcfg = tconfig.VisionTowerConfig(**dataclasses.asdict(cfg))
    tp = tvit.init(tconfig.VisionTowerConfig(**dataclasses.asdict(native)),
                   torch.Generator().manual_seed(7), "cpu", torch.float32)
    jp = jax.tree.map(jnp.asarray, bridge.to_numpy(tp))
    got = tvit.resize_position_embedding(tp, tcfg, native.image_size)
    want = jvit.resize_position_embedding(jp, cfg, native.image_size)
    n = cfg.num_patches + (0 if radio else 1)
    assert got["position_embedding"].shape == (n, cfg.hidden_size)
    np.testing.assert_allclose(got["position_embedding"].numpy(),
                               np.asarray(want["position_embedding"]),
                               atol=1e-6, rtol=1e-6)
    assert tvit.resize_position_embedding(tp, tcfg, cfg.image_size) is tp


def test_w8a8_tower_matches_jax():
    sd = _radio_sd(8)
    tp = tquant.quantize_tree(
        convert_radio({k: torch.from_numpy(v) for k, v in sd.items()},
                      TRADIO), 8, act_quant=True, min_size=0)
    jp = jquant.quantize_tree(jconvert(sd, JRADIO), 8, act_quant=True,
                              min_size=0)
    assert "kernel_qa" in tp["layers"][0]["fc1"]
    x = np.random.default_rng(9).random((2, 64, 64, 3)).astype(np.float32)
    got = tvit.apply(tp, TRADIO, torch.from_numpy(x)).numpy()
    want = np.asarray(jvit.apply(jp, JRADIO, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **W8A8_TOL)
    assert np.abs(got - want).mean() < W8A8_MEAN


def _radio_cfg():
    base = VideoLlavaConfig.tiny()
    cfg = dataclasses.replace(
        base, vision=JRADIO,
        projector=ProjectorConfig(mm_hidden_size=JRADIO.hidden_size,
                                  hidden_size=base.projector.hidden_size),
        seg=SegHeadConfig(seg_backbone="tiny", image_size=64,
                          max_seg_frames=4, max_objects=2),
        seg_token_idx=400)
    return cfg


def test_encode_video_radio_matches_jax():
    cfg = _radio_cfg()
    tp = tllava.init(cfg, torch.Generator().manual_seed(10), "cpu",
                     torch.float32)
    sub = {k: tp[k] for k in ("vision_tower", "mm_projector")}
    jp = jax.tree.map(jnp.asarray, bridge.to_numpy(sub))
    video = _images(11, 4, 64).reshape(1, 4, 64, 64, 3)
    ts, tf = tllava.encode_video(sub, cfg, torch.from_numpy(video))
    js, jf = jllava.encode_video(jp, cfg, jnp.asarray(video))
    assert ts.shape == (1, cfg.num_slow_frames, 16, 128)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)


@pytest.fixture(scope="module")
def radio_ckpt(tmp_path_factory):
    """A synthetic reference checkpoint with a RADIO tower (safetensors)
    and a config.json holding the package's config tree."""
    from safetensors.numpy import save_file

    cfg = _radio_cfg()
    tp = tllava.init(cfg, torch.Generator().manual_seed(12), "cpu",
                     torch.float32)
    # the CLIP-keyed writer needs a CLIP tower: write one, then swap its
    # keys for the RADIO tower's
    clip = VideoLlavaConfig.tiny().vision
    tp["vision_tower"] = tvit.init(
        tconfig.VisionTowerConfig(**dataclasses.asdict(clip)),
        torch.Generator().manual_seed(13), "cpu", torch.float32)
    sd = {k: v for k, v in _reference_state_dict(
        bridge.to_numpy(tp), cfg).items()
        if not k.startswith("model.vision_tower.")}
    vt = "model.vision_tower.vision_tower."
    sd.update({vt + k: np.ascontiguousarray(v, np.float32)
               for k, v in _radio_sd(14).items()})
    root = tmp_path_factory.mktemp("radio_ckpt")
    save_file(sd, str(root / "model.safetensors"))
    raw = dataclasses.asdict(cfg)
    raw.pop("dtype")
    with open(root / "config.json", "w") as fh:
        json.dump(raw, fh)
    return cfg, str(root)


def test_radio_checkpoint_loads_like_jax(radio_ckpt):
    cfg, path = radio_ckpt
    want = jconv.load_llava_weights(path, cfg)
    got = tconv.load_llava_weights(path, cfg)
    assert_trees_equal(got, want)
    assert "register_tokens" in got["vision_tower"]
    params, tcfg, tok = tmain.load_model(path, device="cpu",
                                         dtype=torch.float32)
    assert tok is None
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.vision.is_radio and tcfg.vision.num_register_tokens == 1
    assert_trees_equal(params, want)


def _args(out_dir):
    return types.SimpleNamespace(
        model_path="unused", gt_dir=None, output_dir=out_dir,
        num_chunks=1, chunk_idx=0, overwrite=False, print_captions=False,
        dataset_version="v1.0", dataset_split="val", skip_seg=False,
        skip_captions=False, max_new_tokens=4, temperature=0.0,
        top_p=None, num_beams=1, conv_template="llava_llama_3",
        seg_pad_mode="topleft")


def test_radio_cli_matches_jax_cli(radio_ckpt, tmp_path, monkeypatch):
    """The loaded RADIO checkpoint served by both CLIs on the synthetic
    ViCaS fixture: the same caption, masks of the same sizes agreeing on
    at least 0.99 of their pixels (logits within SERVE_ATOL may flip a
    pixel at 0)."""
    cfg, path = radio_ckpt
    jparams = jax.tree.map(jnp.asarray, jconv.load_llava_weights(path, cfg))
    tparams, tcfg, _ = tmain.load_model(path, device="cpu",
                                        dtype=torch.float32)
    monkeypatch.setenv("VIDEONET_DATASETS_DIR", str(tmp_path))
    _write_fixture(str(tmp_path))
    jdir, tdir = str(tmp_path / "out_jax"), str(tmp_path / "out_torch")
    jmain.run_inference(_args(jdir), model=(jparams, cfg, FakeTokenizer()))
    tmain.run_inference(_args(tdir), model=(tparams, tcfg, FakeTokenizer()))
    with open(osp.join(jdir, "000007.json")) as fh:
        want = json.load(fh)
    with open(osp.join(tdir, "000007.json")) as fh:
        got = json.load(fh)
    assert got["pred_caption"] == want["pred_caption"]
    assert len(got["pred_lgvis_masks"][0]) == len(want["pred_lgvis_masks"][0])
    for g, w in zip(got["pred_lgvis_masks"][0], want["pred_lgvis_masks"][0]):
        assert g["filename"] == w["filename"]
        for gr, wr in zip(g["mask_rles"], w["mask_rles"]):
            assert gr["size"] == wr["size"]
            assert (decode_rle(gr) == decode_rle(wr)).mean() >= 0.99
