"""The port's own copies of the JAX package's host I/O (`paths.py`, the
mp4 path of `data/video_io.py`, `inference/video_fetcher.py`, the RLE
encoder of `ops/masks.py`) pinned to their originals on the same inputs,
and a fresh interpreter in which importing JAX fails running every port
module, the quantized, batched `run_inference` on the synthetic ViCaS
fixture and train -> serve -> score without loading JAX or the JAX
package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from test_inference_cli import _write_fixture

from video_llava_seg_torch import paths as tpaths
from video_llava_seg_torch.data import video_io as tvio
from video_llava_seg_torch.inference import video_fetcher as tfetch
from video_llava_seg_torch.ops import masks as tmasks
from video_llava_seg_tpu import paths as jpaths
from video_llava_seg_tpu.data import video_io as jvio
from video_llava_seg_tpu.inference import video_fetcher as jfetch
from video_llava_seg_tpu.ops import masks as jmasks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def vicas(tmp_path, monkeypatch):
    monkeypatch.setenv("VIDEONET_DATASETS_DIR", str(tmp_path))
    _write_fixture(str(tmp_path))
    return tmp_path


def test_paths_copy_matches(monkeypatch, tmp_path):
    jp, tp = jpaths.Paths, tpaths.Paths
    monkeypatch.delenv("VIDEONET_DATASETS_DIR", raising=False)
    assert tp.datasets_dir() == jp.datasets_dir()
    monkeypatch.setenv("VIDEONET_DATASETS_DIR", str(tmp_path))
    monkeypatch.setenv("VIDEONET_MODELS_DIR", str(tmp_path / "zoo"))
    for name in ("models_dir", "datasets_dir", "vicas_dir",
                 "vicas_videos_dir", "vicas_video_frames_dir", "webvid_dir",
                 "panda70m_dir"):
        assert getattr(tp, name)() == getattr(jp, name)(), name
    for version in ("v0.1", "v1.0"):
        assert tp.vicas_annotations_dir(version) == \
            jp.vicas_annotations_dir(version)
        for split in ("train", "val", "test"):
            assert tp.vicas_split_json(split, version) == \
                jp.vicas_split_json(split, version)


def test_video_io_copy_matches(vicas):
    mp4 = str(vicas / "ViCaS" / "videos" / "vid7.mp4")
    with open(mp4, "rb") as fh:
        data = fh.read()
    for total, n in ((0, 4), (4, 4), (9, 3), (100, 32)):
        np.testing.assert_array_equal(tvio.sample_frame_indices(total, n),
                                      jvio.sample_frame_indices(total, n))
    for src in (mp4, data):
        for n in (2, 4, 6):
            np.testing.assert_array_equal(tvio.load_video_uniform(src, n),
                                          jvio.load_video_uniform(src, n))
    got = tvio.load_video_uniform(data, 3, return_timestamps=True)
    want = jvio.load_video_uniform(data, 3, return_timestamps=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_video_fetcher_copy_matches(vicas):
    with open(vicas / "ViCaS" / "annotations" / "v1.0" / "000007.json") as fh:
        content = json.load(fh)
    t, j = tfetch.VideoAndFrameFetcher(), jfetch.VideoAndFrameFetcher()
    assert t.get_video("vid7.mp4") == j.get_video("vid7.mp4")
    for max_seg in (-1, 2):
        tf, tm = t.get_frames(content, max_seg_frames=max_seg)
        jf, jm = j.get_frames(content, max_seg_frames=max_seg)
        np.testing.assert_array_equal(tf, jf)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_array_equal(np.asarray(tm[k]),
                                          np.asarray(jm[k]))


def test_encode_rle_copy_matches():
    r = np.random.default_rng(0)
    masks = [np.zeros((5, 7), np.uint8), np.ones((4, 3), np.uint8),
             (r.random((33, 47)) > 0.5).astype(np.uint8),
             (r.random((64, 20)) > 0.97).astype(np.uint8)]
    masks[0][0, 0] = 1  # a run of ones first
    for m in masks:
        got = tmasks.encode_rle(m)
        assert got == jmasks.encode_rle(m)
        np.testing.assert_array_equal(jmasks.decode_rle(got), m)


_SCRIPT = r"""
import dataclasses, importlib, json, os, pkgutil, shutil, sys, types
for name in ("jax", "jaxlib", "transformers", "tokenizers", "regex"):
    sys.modules[name] = None  # importing these fails from here on
import torch
import video_llava_seg_torch as pkg
mods = [m for _, m, _ in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from test_inference_cli import FakeTokenizer
from video_llava_seg_torch.config import SegHeadConfig, VideoLlavaConfig
from video_llava_seg_torch.inference import main
from video_llava_seg_torch.models import llava
from video_llava_seg_torch.ops.quantization import quantize_tree

cfg = dataclasses.replace(
    VideoLlavaConfig.tiny(), seg_token_idx=400,
    seg=SegHeadConfig(seg_backbone="tiny", image_size=64, max_seg_frames=4,
                      max_objects=2))
params = llava.init(cfg, torch.Generator().manual_seed(0), "cpu",
                    torch.float32)
params["llm"] = quantize_tree(params["llm"], 4, act_quant=True, min_size=0)
out_dir = sys.argv[1]
args = types.SimpleNamespace(
    model_path="unused", gt_dir=None, output_dir=out_dir, num_chunks=1,
    chunk_idx=0, overwrite=False, print_captions=False,
    dataset_version="v1.0", dataset_split="val", skip_seg=False,
    skip_captions=False, max_new_tokens=3, temperature=0.0, top_p=None,
    num_beams=1, conv_template="llava_llama_3", seg_pad_mode="topleft",
    kv_cache_int8=True, fuse_qkv=True, batch_queries=2)
main.run_inference(args, model=(params, cfg, FakeTokenizer()))
with open(os.path.join(out_dir, "000007.json")) as fh:
    pred = json.load(fh)
assert pred["pred_caption"], pred
assert len(pred["pred_lgvis_masks"][0]) == 4, pred
from video_llava_seg_torch.train import train as train_cli
state = train_cli.main([
    "--stage", "stage3", "--tiny", "--synthetic", "--bits", "8",
    "--lora_enable", "--device", "cpu", "--num_train_steps", "2",
    "--save_steps", "2", "--gradient_accumulation_steps", "1",
    "--output_dir", os.path.join(out_dir, "train")])
assert state.step == 2
assert os.path.exists(os.path.join(out_dir, "train",
                                   "training_complete.flag"))
serve = types.SimpleNamespace(**{
    **vars(args), "model_path": os.path.join(out_dir, "train",
                                             "checkpoint-2"),
    "output_dir": os.path.join(out_dir, "served"), "kv_cache_int8": False,
    "fuse_qkv": False, "batch_queries": 1, "num_beams": 2, "skip_seg": True,
    "load_4bit": True, "device": "cpu"})
main.run_inference(serve, tokenizer=FakeTokenizer())
from video_llava_seg_torch.inference import eval as vieval
from video_llava_seg_torch.paths import Paths
gt_dir = str(Paths.vicas_annotations_dir("v1.0"))
scores = [vieval.evaluate_dirs(d, gt_dir) for d in (out_dir, serve.output_dir)]
assert [s["num_referrals"] for s in scores] == [1, 1], scores
assert 0.0 <= scores[0]["mean_iou"] <= 1.0 and scores[1]["mean_iou"] == 0.0
from video_llava_seg_torch.models.sam2.build import (
    build_sam2_image_predictor,
)
import numpy as np
predictor = build_sam2_image_predictor("sam2-test-tiny", device="cpu")
predictor.set_image(np.zeros((40, 60, 3), np.uint8))
masks, ious, low_res = predictor.predict(box=np.array([5.0, 5.0, 50.0, 30.0]))
assert masks.shape == (3, 40, 60) and ious.shape == (3,), masks.shape
from video_llava_seg_torch.models.sam2.build import (
    build_sam2_video_predictor,
)
video = build_sam2_video_predictor("sam2-test-tiny", device="cpu")
state = video.init_state(np.zeros((3, 40, 60, 3), np.uint8))
video.add_new_points_or_box(state, 0, 1, points=[[20.0, 10.0]], labels=[1])
tracked = [(f, m.shape) for f, _, m in video.propagate_in_video(state)]
assert tracked == [(i, (1, 1, 40, 60)) for i in range(3)], tracked
tok_dir = sys.argv[2]
state = train_cli.main([
    "--stage", "stage3", "--tiny", "--dataset", "vicas", "--tokenizer",
    tok_dir, "--bits", "8", "--lora_enable", "--device", "cpu",
    "--num_train_steps", "2", "--save_steps", "2",
    "--gradient_accumulation_steps", "1", "--output_dir",
    os.path.join(out_dir, "train_data")])
assert state.step == 2
ckpt = os.path.join(out_dir, "train_data", "checkpoint-2")
for f in ("tokenizer.json", "tokenizer_config.json"):
    shutil.copy(os.path.join(tok_dir, f), ckpt)
_, _, loaded_tok = main.load_model(ckpt, device="cpu")
assert type(loaded_tok).__module__ == "video_llava_seg_torch.tokenizer"
main.run_inference(types.SimpleNamespace(**{
    **vars(serve), "model_path": ckpt, "num_beams": 1, "load_4bit": False,
    "output_dir": os.path.join(out_dir, "served_data")}))
with open(os.path.join(out_dir, "served_data", "000007.json")) as fh:
    assert isinstance(json.load(fh)["pred_caption"], str)
loaded = sorted(k for k, v in sys.modules.items() if v is not None and (
    k in ("jax", "jaxlib", "transformers", "tokenizers", "regex")
    or k.startswith(("jax.", "jaxlib.", "video_llava_seg_tpu",
                     "transformers.", "tokenizers."))))
assert not loaded, loaded
print(len(mods))
"""


def test_port_serves_without_jax(vicas):
    """Every port module imports (the train/ modules included), the
    quantized batched CLI runs end to end, the training CLI takes two
    tiny stage-3 QLoRA steps, the serving CLI serves their checkpoint
    with --load_4bit --num_beams 2 and `inference.eval` scores both
    outputs, the SAM2 image predictor sets an image and
    predicts and the SAM2 video predictor tracks a point over three frames
    on the CPU; then the training CLI takes two steps from the ViCaS
    fixture through the port's tokenizer and `run_inference` serves their
    checkpoint with the tokenizer `load_model` reads from it; all in an
    interpreter where JAX, transformers, tokenizers and regex cannot be
    imported, and afterwards none of them (nor video_llava_seg_tpu) is
    loaded."""
    from test_torch_tokenizer import write_llama3

    vicas_dir = vicas / "ViCaS"
    ann = vicas_dir / "annotations" / "v1.0" / "000007.json"
    content = json.loads(ann.read_text())
    content["reworded_en_captions"] = ["a reworded caption"]
    for version in ("v1.0", "v0.1"):  # the training CLI reads v0.1
        for sub in ("annotations", "splits"):
            os.makedirs(vicas_dir / sub / version, exist_ok=True)
        (vicas_dir / "annotations" / version / "000007.json").write_text(
            json.dumps(content))
        (vicas_dir / "splits" / version / "train.json").write_text("[7]")
    tok_dir = write_llama3(str(vicas / "tokenizer"), vocab_size=400)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    res = subprocess.run([sys.executable, "-c", _SCRIPT,
                          str(vicas / "out"), tok_dir], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.strip().splitlines()[-1]) >= 30
