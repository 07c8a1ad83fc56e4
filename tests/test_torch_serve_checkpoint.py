"""Train -> serve -> score in the port on the CPU: a tiny stage-3 QLoRA
run of the training CLI writes `checkpoint-2/state.pt`, which
`run_inference(model_path=...)` serves (LoRA merged, the --load_8bit /
--load_4bit gates, beams) to the JSON of serving `merge_into(params,
lora)` in memory; the port's `merge_into` against the JAX package's on
the same tree; and the port's `inference/eval.py` against the JAX
module on JSONs made from a seed."""

import copy
import json
import os
import os.path as osp
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_inference_cli import FakeTokenizer, _write_fixture

from video_llava_seg_torch import bridge
from video_llava_seg_torch.inference import eval as teval
from video_llava_seg_torch.inference import main as tmain
from video_llava_seg_torch.ops import masks as tmasks
from video_llava_seg_torch.ops.quantization import quantize_tree
from video_llava_seg_torch.train import lora as tlora
from video_llava_seg_torch.train import train as train_cli
from video_llava_seg_tpu.inference import eval as jeval
from video_llava_seg_tpu.train import lora as jlora


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    train_cli.main(["--stage", "stage3", "--tiny", "--synthetic", "--bits",
                    "8", "--lora_enable", "--device", "cpu",
                    "--num_train_steps", "2", "--save_steps", "2",
                    "--gradient_accumulation_steps", "1",
                    "--output_dir", str(out)])
    return str(out / "checkpoint-2")


def _args(out_dir, model_path, **kw):
    # the tiny training config has no seg head: captions only
    a = types.SimpleNamespace(
        model_path=model_path, gt_dir=None, output_dir=out_dir,
        num_chunks=1, chunk_idx=0, overwrite=False, print_captions=False,
        dataset_version="v1.0", dataset_split="val", skip_seg=True,
        skip_captions=False, max_new_tokens=4, temperature=0.0,
        top_p=None, num_beams=2, conv_template="llava_llama_3",
        seg_pad_mode="topleft", device="cpu")
    for k, v in kw.items():
        setattr(a, k, v)
    return a


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_checkpoint_serves_as_its_merged_tree(checkpoint, bits, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("VIDEONET_DATASETS_DIR", str(tmp_path))
    _write_fixture(str(tmp_path))
    flags = {8: {"load_8bit": True}, 4: {"load_4bit": True}}.get(bits, {})
    got_dir, want_dir = str(tmp_path / "ckpt"), str(tmp_path / "mem")
    tmain.run_inference(_args(got_dir, checkpoint, **flags),
                        tokenizer=FakeTokenizer())

    saved = torch.load(osp.join(checkpoint, "state.pt"), weights_only=True)
    params = dict(saved["params"])
    adapters = params.pop("lora")
    # the second step moved b (the first runs at lr 0), so the merge
    # changes the float kernels
    wq = adapters["llm"]["layers"][0]["attn"]["wq"]["kernel"]
    assert wq["b"].abs().max() > 0
    merged = tlora.merge_into(params, adapters)
    if bits:
        merged["llm"] = quantize_tree(merged["llm"], bits,
                                      act_quant=bits == 4)
    loaded, cfg, _ = tmain.load_model(checkpoint, device="cpu",
                                      dtype=torch.float32)
    assert "lora" not in loaded
    kernel = loaded["llm"]["layers"][0]["attn"]["wq"]["kernel"]
    assert torch.equal(kernel, merged["llm"]["layers"][0]["attn"]["wq"][
        "kernel"])
    assert not torch.equal(kernel, params["llm"]["layers"][0]["attn"]["wq"][
        "kernel"])
    tmain.run_inference(_args(want_dir, "unused"),
                        model=(merged, cfg, FakeTokenizer()))
    with open(osp.join(got_dir, "000007.json")) as fh:
        got = json.load(fh)
    with open(osp.join(want_dir, "000007.json")) as fh:
        want = json.load(fh)
    assert got == want and got["pred_caption"]


def test_merge_into_matches_jax():
    """Float kernels absorb the delta; a quantized (QLoRA) kernel keeps
    the adapter attached with its scale alpha / r."""
    g = torch.Generator().manual_seed(0)
    dense = lambda i, o: {"kernel": torch.randn(i, o, generator=g)}
    params = {"llm": {"layers": [{"attn": {"wq": dense(16, 8),
                                           "wo": dense(8, 16)},
                                  "mlp": {"w_down": dense(8, 16)}}]},
              "mm_projector": {"layers": [dense(4, 4)]}}
    params["llm"]["layers"][0]["mlp"]["w_down"] = quantize_tree(
        params["llm"]["layers"][0]["mlp"]["w_down"], 8, min_size=0,
        train_mode=True)
    # b starts at zero: move every adapter leaf so each delta is non-zero
    adapters = bridge.tree_map(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=g),
        tlora.init_lora(g, params, 4))
    got = bridge.to_numpy(tlora.merge_into(params, adapters))
    want = jax.tree.map(np.asarray, jlora.merge_into(
        jax.tree.map(jnp.asarray, bridge.to_numpy(params)),
        jax.tree.map(jnp.asarray, bridge.to_numpy(adapters))))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=1e-6,
                                   rtol=1e-6)
    attached = got["llm"]["layers"][0]["mlp"]["w_down"]
    assert set(attached) == {"kernel_q", "kernel_scale", "lora"}
    assert float(attached["lora"]["s"]) == 16.0 / 4


def test_prepare_params_serves_a_training_tree():
    """A training state's tree (trainable leaves requiring grad, a `lora`
    subtree): merged as `merge_into` does, cast, and detached, so that
    serving it records no autograd graph."""
    g = torch.Generator().manual_seed(1)
    params = {"llm": {"layers": [{"attn": {"wq": {
        "kernel": torch.randn(8, 8, generator=g)}}}]},
        "mm_projector": {"layers": [{"kernel": torch.randn(
            4, 4, generator=g, requires_grad=True)}]}}
    adapters = bridge.tree_map(lambda t: t.requires_grad_(True),
                               tlora.init_lora(g, params, 2))
    adapters["llm"]["layers"][0]["attn"]["wq"]["kernel"]["b"].data += 1.0
    got = tmain.prepare_params(dict(params, lora=adapters), None, "cpu",
                               torch.bfloat16)
    want = tlora.merge_into(params, adapters)
    assert "lora" not in got
    leaves = []
    bridge.tree_map(leaves.append, got)
    assert not any(t.requires_grad for t in leaves)
    assert torch.equal(got["llm"]["layers"][0]["attn"]["wq"]["kernel"],
                       want["llm"]["layers"][0]["attn"]["wq"]["kernel"].to(
                           torch.bfloat16))


def _rle(mask):
    r = tmasks.encode_rle(mask.astype(np.uint8))
    r["counts"] = r["counts"].decode("utf-8")
    return r


def _eval_jsons(seed=0, hw=(24, 32)):
    """Two videos' ground truth (2 referrals over 3 frames, tracks 1 and
    2) and predictions: random masks, an empty prediction (no masks on a
    frame), a frame the ground truth lacks, a frame the prediction lacks,
    and a video with its second referral missing."""
    r = np.random.default_rng(seed)
    gts, preds = [], []
    for vid in (3, 11):
        segs = [{"filename": f"{t:05d}.jpg", "track_ids": [1, 2],
                 "mask_rles": [_rle(r.random(hw) > 0.6),
                               _rle(r.random(hw) > 0.8)]}
                for t in range(3)]
        gts.append({"video_id": vid, "segmentations": segs,
                    "object_referrals": [{"prompt": "a", "track_ids": [1]},
                                         {"prompt": "b",
                                          "track_ids": [1, 2]}]})
        ref0 = [{"filename": "00000.jpg",
                 "mask_rles": [_rle(r.random(hw) > 0.5)]},
                {"filename": "00001.jpg", "mask_rles": []},
                {"filename": "00007.jpg",
                 "mask_rles": [_rle(r.random(hw) > 0.5)]}]
        ref1 = [{"filename": f"{t:05d}.jpg",
                 "mask_rles": [_rle(r.random(hw) > 0.7),
                               _rle(r.random(hw) > 0.9)]} for t in (0, 2)]
        preds.append({"video_id": vid, "pred_object_referral_masks":
                      [ref0, ref1] if vid == 3 else [ref0]})
    return gts, preds


def test_eval_matches_jax(tmp_path):
    gts, preds = _eval_jsons()
    for gt, pred in zip(gts, preds):
        for i, ref in enumerate(pred["pred_object_referral_masks"]):
            tids = gt["object_referrals"][i]["track_ids"]
            assert teval.referral_iou(ref, gt, tids) == \
                jeval.referral_iou(ref, gt, tids)
        assert teval.evaluate_video(pred, gt) == \
            jeval.evaluate_video(pred, gt)
        # the serving CLI's key: the port reads it, as the harness's
        cli = {"video_id": pred["video_id"],
               "pred_lgvis_masks": pred["pred_object_referral_masks"]}
        assert teval.evaluate_video(cli, gt) == \
            jeval.evaluate_video(pred, gt)
    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    os.makedirs(gt_dir)
    os.makedirs(pred_dir)
    for gt, pred in zip(gts, preds):
        with open(gt_dir / f"{gt['video_id']:06d}.json", "w") as fh:
            json.dump(gt, fh)
        with open(pred_dir / f"{pred['video_id']:06d}.json", "w") as fh:
            json.dump(copy.deepcopy(pred), fh)
    got = teval.evaluate_dirs(str(pred_dir), str(gt_dir))
    assert got == jeval.evaluate_dirs(str(pred_dir), str(gt_dir))
    assert got["num_videos"] == 2 and got["num_referrals"] == 4
    assert 0.0 < got["mean_iou"] < 1.0
