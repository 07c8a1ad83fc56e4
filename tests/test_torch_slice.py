"""The whole serving slice on the tiny config, port vs JAX package, on the
same weights (JAX init -> bridge.from_jax) and the same seeded inputs:
greedy tokens exactly equal, captured hidden states and seg-head mask
logits within 1e-4 abs (fp32, sums in another order through ~20 layers),
and `run_inference` of both packages on the synthetic ViCaS fixture
writing the same caption and the same mask JSON schema."""

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

from video_llava_seg_torch import bridge
from video_llava_seg_torch.inference import main as tmain
from video_llava_seg_torch.models import llava as tllava
from video_llava_seg_tpu.config import SegHeadConfig, VideoLlavaConfig
from video_llava_seg_tpu.inference import main as jmain
from video_llava_seg_tpu.inference.utils import preprocess_seg_inputs
from video_llava_seg_tpu.models import llava as jllava
from video_llava_seg_tpu.mm_utils import tokenizer_image_token

ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    cfg = VideoLlavaConfig.tiny()
    cfg = dataclasses.replace(
        cfg, seg=SegHeadConfig(seg_backbone="tiny", image_size=64,
                               max_seg_frames=4, max_objects=2),
        seg_token_idx=400)
    params = jllava.init(jax.random.PRNGKey(0), cfg)
    return params, bridge.from_jax(params), cfg


def _inputs(cfg, qs):
    tok = FakeTokenizer()
    prompt = jmain.build_prompt(cfg, qs, "llava_llama_3")
    ids = np.asarray(tokenizer_image_token(prompt, tok))[None]
    r = np.random.default_rng(0)
    video = r.standard_normal(
        (1, cfg.num_frames, cfg.vision.image_size, cfg.vision.image_size, 3)
    ).astype(np.float32)
    return ids, video


def test_generate_and_seg_head_match(model):
    jparams, tparams, cfg = model
    ids, video = _inputs(cfg, "\nthe bright region Please output the "
                              "segmentation mask.")
    eos = (2,)
    jt, jh, jn = jllava.generate(jparams, cfg, ids, jnp.asarray(video),
                                 max_new_tokens=6, eos_token_ids=eos)
    tt, th, tn = tllava.generate(tparams, cfg, ids, torch.from_numpy(video),
                                 max_new_tokens=6, eos_token_ids=eos)
    assert tn == int(jn)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                               rtol=0)

    frames = np.random.default_rng(1).integers(0, 256, (3, 40, 56, 3),
                                               dtype=np.uint8)
    seg, meta = preprocess_seg_inputs(frames, {"orig_image_size": (40, 56)},
                                      tgt_size=64, normalize=False)
    want = jllava.forward_seg_head_inference(jparams, cfg, jt, jh, int(jn),
                                             [seg], [meta])
    got = tllava.forward_seg_head_inference(tparams, cfg, tt, th, tn,
                                            [torch.from_numpy(seg)], [meta])
    assert got[0].shape == (1, 3, 40, 56)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL, rtol=0)


def test_seg_token_selection_and_fallback():
    hidden = torch.arange(12, dtype=torch.float32).reshape(1, 4, 3)
    tokens = torch.tensor([[5, 400, 7, 400]])
    got = tllava.extract_seg_hidden(tokens, hidden, 400, 4)
    np.testing.assert_array_equal(got.numpy(), hidden[0, [1, 3]].numpy())
    # no [SEG] emitted: index 0 stands in (the reference's fallback)
    got = tllava.extract_seg_hidden(torch.tensor([[5, 6, 7, 8]]), hidden,
                                    400, 3, fallback_first=True)
    np.testing.assert_array_equal(got.numpy(), hidden[0, :1].numpy())


def _args(out_dir):
    return types.SimpleNamespace(
        model_path="unused", gt_dir=None, output_dir=out_dir,
        num_chunks=1, chunk_idx=0, overwrite=False, print_captions=False,
        dataset_version="v1.0", dataset_split="val", skip_seg=False,
        skip_captions=False, max_new_tokens=4, temperature=0.0,
        top_p=None, num_beams=1, conv_template="llava_llama_3",
        seg_pad_mode="topleft")


def test_run_inference_matches_jax_cli(model, tmp_path, monkeypatch):
    jparams, tparams, cfg = model
    monkeypatch.setenv("VIDEONET_DATASETS_DIR", str(tmp_path))
    _write_fixture(str(tmp_path))
    jdir, tdir = str(tmp_path / "out_jax"), str(tmp_path / "out_torch")
    jmain.run_inference(_args(jdir), model=(jparams, cfg, FakeTokenizer()))
    tmain.run_inference(_args(tdir), model=(tparams, cfg, FakeTokenizer()))
    with open(osp.join(jdir, "000007.json")) as fh:
        want = json.load(fh)
    with open(osp.join(tdir, "000007.json")) as fh:
        got = json.load(fh)
    assert got["video_id"] == want["video_id"] == 7
    assert got["pred_caption"] == want["pred_caption"]
    assert len(got["pred_lgvis_masks"]) == len(want["pred_lgvis_masks"]) == 1
    for g, w in zip(got["pred_lgvis_masks"][0], want["pred_lgvis_masks"][0]):
        assert set(g) == set(w) == {"filename", "mask_rles"}
        assert g["filename"] == w["filename"]
        assert [r["size"] for r in g["mask_rles"]] == \
            [r["size"] for r in w["mask_rles"]]

    # resume: the output exists, so a second run writes nothing
    mtime = osp.getmtime(osp.join(tdir, "000007.json"))
    tmain.run_inference(_args(tdir), model=(tparams, cfg, FakeTokenizer()))
    assert osp.getmtime(osp.join(tdir, "000007.json")) == mtime


@pytest.mark.parametrize("flag,value", [
    ("temperature", 0.7), ("num_beams", 3), ("model_parallel", 2)])
def test_run_inference_refuses_out_of_slice_flags(flag, value, tmp_path):
    args = _args(str(tmp_path))
    setattr(args, flag, value)
    want = {"temperature": "sampling and beams",
            "num_beams": "sampling and beams",
            "model_parallel": "parallelism"}[flag]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1: {want}"):
        tmain.run_inference(args, model=None)
