"""The port's training data path (`video_llava_seg_torch/data/`) against
the JAX package's on the same inputs: supervised preprocessing for the
five templates (a toy tokenizer, and trained BPE tokenizers through the
port's tokenizer vs transformers), the mask-containing crops, the
length-grouped sampler, ViCaS and caption-dataset items on the synthetic
fixtures, the collated batch, the prefetcher on the CPU device, the
vocab-size refusal, the attention routes at the fixture's bucketed
lengths, and the training CLI from the ViCaS fixture.

Tolerances: the clip within one uint8 level after normalisation (1/255 /
min std: the port emulates PIL's bicubic in float, PIL runs fixed
point); the seg frames within 1e-5 (fp32 resizes summed in another
order); everything else exact."""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import os.path as osp
import random
import shutil

import numpy as np
import pytest
import torch

from tests.test_caption_dataset import webvid_env  # noqa: F401 (fixture)
from tests.test_preprocess import ToyTokenizer
from tests.test_torch_tokenizer import (
    write_llama3,
    write_mpt,
    write_sentencepiece,
)
from tests.test_vicas_dataset import vicas_train_env  # noqa: F401 (fixture)

CLIP_STD_MIN = 0.26130258
CLIP_ATOL = 1.0 / 255 / CLIP_STD_MIN + 1e-6
SEG_ATOL = 1e-5
VISION_TOKENS = ["<sf_vid_separator>", "<vid_seg>"]
TEMPLATES = ("llava_llama_3", "v1", "llava_llama_2", "mpt", "plain")
FAMILIES = ("llama3", "sp_metaspace", "sp_prepend", "mpt")


@pytest.fixture(scope="module")
def bpe_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("bpe")
    return {
        "llama3": write_llama3(str(root / "llama3"), vocab_size=400),
        "llama3_wide": write_llama3(str(root / "llama3_wide"),
                                    vocab_size=600),
        "sp_metaspace": write_sentencepiece(str(root / "spm"), legacy=False),
        "sp_prepend": write_sentencepiece(str(root / "spp"), legacy=True),
        "mpt": write_mpt(str(root / "mpt")),
    }


def tokenizer_pair(path):
    """(transformers', the port's) tokenizer of `path`, both with the
    vision tokens added as the trainer adds them."""
    from transformers import AutoTokenizer

    from video_llava_seg_torch.tokenizer import Tokenizer

    hf, port = AutoTokenizer.from_pretrained(path), \
        Tokenizer.from_pretrained(path)
    for tok in (hf, port):
        tok.add_tokens(VISION_TOKENS, special_tokens=True)
    return hf, port


def _conversations(template):
    caption = [{"from": "human", "value": "<video>\nDescribe the video."},
               {"from": "gpt", "value": "A dog runs across the field ."}]
    if template == "plain":
        return [caption]
    referral = [
        {"from": "human", "value": "<video>\nthe red car on the left "
                                   "Please output the segmentation mask."},
        {"from": "gpt", "value": "<vid_seg><vid_seg>"},
        {"from": "human", "value": "And the person?"},
        {"from": "gpt", "value": "It is walking while it's raining."}]
    return [caption, referral]


def _preprocess_both(template, jtok, ttok):
    from video_llava_seg_torch.data import preprocess as tpre
    from video_llava_seg_tpu.data import preprocess as jpre

    for conv in _conversations(template):
        out = []
        for mod, tok in ((jpre, jtok), (tpre, ttok)):
            args = mod.PreprocessArgs(num_frames=4, num_slow_frames=2)
            sources = mod.preprocess_multimodal([copy.deepcopy(conv)], args)
            out.append(mod.preprocess(sources, tok, has_image=True,
                                      template=template))
        for key in ("input_ids", "labels"):
            for w, g in zip(out[0][key], out[1][key]):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("template", TEMPLATES)
def test_preprocess_matches_jax_toy_tokenizer(template):
    bos = template != "mpt"
    _preprocess_both(template, ToyTokenizer(add_bos=bos),
                     ToyTokenizer(add_bos=bos))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("template", TEMPLATES)
def test_preprocess_matches_jax_bpe(bpe_dirs, family, template):
    """The JAX package's preprocessing on transformers' tokenizer vs the
    port's on the port's tokenizer, same trained BPE files: ids and
    labels (the label spans, their +-1 corrections and the mismatch rule
    read the tokenizer's splits and `legacy`)."""
    _preprocess_both(template, *tokenizer_pair(bpe_dirs[family]))


def test_augment_crops_match_jax():
    from video_llava_seg_torch.data import augment as taug
    from video_llava_seg_tpu.data import augment as jaug

    r = np.random.default_rng(5)
    masks = np.zeros((3, 5, 40, 60), bool)
    masks[0, :, 10:20, 30:45] = True
    masks[1, 2, 30:38, 2:9] = True
    masks[2] = r.random((5, 40, 60)) > 0.97
    merged = masks.any(1)
    np.testing.assert_array_equal(taug.mask_to_bbox(merged),
                                  jaug.mask_to_bbox(merged))
    jr, tr = random.Random(11), random.Random(11)
    for m in masks:
        for dims in ((30, 45), (20, 20), (39, 59)):
            assert (taug.compute_mask_containing_image_crop(m.any(0), dims,
                                                            rng=tr)
                    == jaug.compute_mask_containing_image_crop(
                        m.any(0), dims, rng=jr))
            assert (taug.compute_mask_containing_video_crop(
                m, dims, min_crop_mask_coverage=0.5, num_tries=3, rng=tr)
                == jaug.compute_mask_containing_video_crop(
                    m, dims, min_crop_mask_coverage=0.5, num_tries=3,
                    rng=jr))
    assert jr.random() == tr.random()
    with pytest.raises(ValueError):
        taug.mask_to_bbox(np.zeros((1, 4, 4), bool))


def test_sampler_orders_match_jax():
    from video_llava_seg_torch.data import sampler as ts
    from video_llava_seg_tpu.data import sampler as js

    rng = np.random.RandomState(0)
    lengths = rng.randint(1, 100, 64).tolist()
    mixed = ([int(x) for x in rng.randint(1, 50, 29)]
             + [-int(x) for x in rng.randint(1, 50, 35)])
    assert ts.split_to_even_chunks(list(range(64)), lengths, 4) == \
        js.split_to_even_chunks(list(range(64)), lengths, 4)
    for fn in ("get_length_grouped_indices",
               "get_modality_length_grouped_indices"):
        for lens in (lengths, mixed):
            if fn == "get_length_grouped_indices" and lens is mixed:
                continue
            assert getattr(ts, fn)(lens, 4, 2, np.random.RandomState(3)) == \
                getattr(js, fn)(lens, 4, 2, np.random.RandomState(3))
    for modality in (False, True):
        t = ts.LengthGroupedSampler(2, 1, mixed if modality else lengths,
                                    seed=7, group_by_modality=modality)
        j = js.LengthGroupedSampler(2, 1, mixed if modality else lengths,
                                    seed=7, group_by_modality=modality)
        for _ in range(2):  # a second epoch continues the same draws
            assert list(t) == list(j)
        assert len(t) == len(j)


def _data_args(pkg, **over):
    import importlib

    DataConfig = importlib.import_module(f"{pkg}.config").DataConfig
    kw = dict(vicas_version="v1.0", num_frames=4, num_slow_frames=2,
              max_seg_frames=4, seg_image_size=64, pad_mode="topleft")
    kw.update(over)
    return DataConfig(**kw)


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in ("input_ids", "labels"):
        np.testing.assert_array_equal(got[key], want[key])
    assert tuple(got["image_size"]) == tuple(want["image_size"])
    assert got["image"].shape == want["image"].shape
    np.testing.assert_allclose(got["image"], want["image"], rtol=0,
                               atol=CLIP_ATOL)
    if "seg_frames" in want:
        np.testing.assert_allclose(got["seg_frames"], want["seg_frames"],
                                   rtol=0, atol=SEG_ATOL)
        if want["seg_masks"] is None:
            assert got["seg_masks"] is None
        else:
            np.testing.assert_array_equal(got["seg_masks"],
                                          want["seg_masks"])
        assert sorted(got["seg_meta"]) == sorted(want["seg_meta"])
        for k, v in want["seg_meta"].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got["seg_meta"][k], v)
            else:
                assert got["seg_meta"][k] == v, k


def test_vicas_items_match_jax(vicas_train_env, bpe_dirs):  # noqa: F811
    from video_llava_seg_torch.data.vicas import ViCaSDataset as TDS
    from video_llava_seg_tpu.data.vicas import ViCaSDataset as JDS

    hf, port = tokenizer_pair(bpe_dirs["llama3"])
    jds = JDS(hf, _data_args("video_llava_seg_tpu"), vision_image_size=56)
    tds = TDS(port, _data_args("video_llava_seg_torch"),
              vision_image_size=56)
    assert [s[1:] for s in tds.samples] == [s[1:] for s in jds.samples]
    kinds = [s[1] for s in tds.samples]
    assert kinds.count("caption") == 2 and kinds.count("mask") == 2
    for i in range(len(jds)):
        _assert_items_equal(tds[i], jds[i])
    assert tds.rng.random() == jds.rng.random()


def test_caption_items_match_jax(webvid_env, bpe_dirs):  # noqa: F811
    from video_llava_seg_torch.data.caption_datasets import (
        VideoCaptionDataset as TDS,
    )
    from video_llava_seg_tpu.data.caption_datasets import (
        VideoCaptionDataset as JDS,
    )

    hf, port = tokenizer_pair(bpe_dirs["llama3"])
    jds = JDS(hf, _data_args("video_llava_seg_tpu", dataset="captions"),
              vision_image_size=56)
    tds = TDS(port, _data_args("video_llava_seg_torch", dataset="captions"),
              vision_image_size=56)
    assert tds.json_paths == jds.json_paths and len(tds) == 2
    for i in range(len(jds)):
        _assert_items_equal(tds[i], jds[i])
    assert TDS.parse_json({"video_id": 9, "caption": "x"}) == \
        JDS.parse_json({"video_id": 9, "caption": "x"})


def _seg_cfgs(seg_token_idx):
    from video_llava_seg_torch import config as tc
    from video_llava_seg_tpu import config as jc

    return [dataclasses.replace(
        c.VideoLlavaConfig.tiny(), seg_token_idx=seg_token_idx,
        seg=c.SegHeadConfig(seg_backbone="tiny", image_size=64,
                            max_seg_frames=4, max_objects=2))
        for c in (jc, tc)]


def _collated_pair(bpe_dirs, family="llama3"):
    from video_llava_seg_torch.data.collate import (
        make_supervised_data_module as tmake,
    )
    from video_llava_seg_tpu.data.collate import (
        make_supervised_data_module as jmake,
    )

    hf, port = tokenizer_pair(bpe_dirs[family])
    jcfg, tcfg = _seg_cfgs(port.convert_tokens_to_ids("<vid_seg>"))
    out = []
    for make, tok, cfg, pkg in ((jmake, hf, jcfg, "video_llava_seg_tpu"),
                                (tmake, port, tcfg,
                                 "video_llava_seg_torch")):
        module = make(tok, cfg, _data_args(pkg))
        ds, collate = module["train_dataset"], module["data_collator"]
        mask = [i for i, s in enumerate(ds.samples) if s[1] == "mask"][0]
        out.append(collate([ds[0], ds[mask]]))
    return out, tcfg


def test_collated_batch_matches_jax(vicas_train_env, bpe_dirs):  # noqa: F811
    (want, got), cfg = _collated_pair(bpe_dirs)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key == "video":
            np.testing.assert_allclose(g, w, rtol=0, atol=CLIP_ATOL)
        elif key == "seg_frames":
            np.testing.assert_allclose(g, w, rtol=0, atol=SEG_ATOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    length = got["gather_idx"].shape[1]
    assert length % 128 == 0 or length == cfg.tokenizer_model_max_length
    assert got["has_masks"].tolist() == [False, True]
    assert got["seg_valid"].tolist() == [[False, False], [True, False]]
    pos = got["seg_token_pos"][1, 0]
    assert got["labels"][1, pos + 1] == cfg.seg_token_idx


def test_right_padding_needs_no_key_mask(vicas_train_env, bpe_dirs):  # noqa: F811
    """The collated batch is right-padded: every pad position carries an
    IGNORE_INDEX label and the step takes no key mask (`attn_mask` is
    collated and unused), so no query row is fully masked; the loss is
    the same without `attn_mask` and finite."""
    from video_llava_seg_torch.constants import IGNORE_INDEX
    from video_llava_seg_torch.models import llava
    from video_llava_seg_torch.train.train_step import (
        batch_to_device,
        compute_loss,
    )

    (_, batch), cfg = _collated_pair(bpe_dirs)
    lens = batch["attn_mask"].sum(1)
    for row, n in enumerate(lens):
        assert (batch["labels"][row, n:] == IGNORE_INDEX).all()
        assert batch["attn_mask"][row, :n].all()
    params = llava.init(cfg, torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    losses = []
    for b in (batch, {k: v for k, v in batch.items() if k != "attn_mask"}):
        with torch.no_grad():
            loss, m = compute_loss(params, cfg,
                                   batch_to_device(b, "cpu", torch.float32),
                                   torch.Generator().manual_seed(1))
        losses.append(float(loss))
        assert int(m["num_text_tokens"]) == int(
            (batch["labels"][:, 1:] != IGNORE_INDEX).sum())
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_prefetcher_order_dtypes_and_errors():
    from video_llava_seg_torch.data.prefetch import prefetch_to_device
    from video_llava_seg_torch.train.train_step import batch_to_device

    batches = [{"x": np.full((2, 2), i, np.int32),
                "v": np.full((1, 3), i / 3, np.float32),
                "m": np.array([True, i % 2 == 0])} for i in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(out) == 5
    for b, got in zip(batches, out):
        want = batch_to_device(b, "cpu", torch.float32)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                                 want[k])
    bf16 = next(prefetch_to_device(iter(batches), "cpu",
                                   dtype=torch.bfloat16))
    assert bf16["v"].dtype == torch.bfloat16 and bf16["x"].dtype == \
        torch.int64

    def bad():
        yield batches[0]
        raise RuntimeError("boom")

    it = prefetch_to_device(bad(), "cpu", size=1)
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    doubled = prefetch_to_device(iter(batches[:2]), "cpu",
                                 transform=lambda b: {"x": b["x"] * 2})
    assert [int(b["x"][0, 0]) for b in doubled] == [0, 2]
    assert len(doubled.waits) == 2


def test_prefetcher_stress_and_close():
    """More prefetch threads than cores, each consumed by its own thread,
    under a short switch interval: every consumer sees its batches in
    order; close() stops a thread that is still ahead, within a
    timeout."""
    import concurrent.futures
    import sys

    from video_llava_seg_torch.data.prefetch import prefetch_to_device

    def consume(k):
        it = prefetch_to_device(({"x": np.array([k, i])} for i in range(40)),
                                "cpu", size=2)
        return [tuple(b["x"].tolist()) for b in it]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        n = 2 * (os.cpu_count() or 4)
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            outs = list(pool.map(consume, range(n), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert outs == [[(k, i) for i in range(40)] for k in range(n)]

    endless = prefetch_to_device(({"x": np.array([i])} for i in
                                  iter(int, 1)), "cpu", size=2)
    assert int(next(endless)["x"][0]) == 0
    endless.close(timeout=30)
    assert not endless._thread.is_alive()
    with pytest.raises(StopIteration):
        next(endless)


def test_added_ids_past_the_vocab_are_refused(bpe_dirs):
    """<vid_seg> gets the id after the largest added one (128256 for a
    real Llama-3 tokenizer, past its 128256 embeddings): refused, since
    neither package resizes the embedding."""
    from video_llava_seg_torch.config import SegHeadConfig, VideoLlavaConfig
    from video_llava_seg_torch.tokenizer import Tokenizer
    from video_llava_seg_torch.train.train import initialize_vision_tokenizer

    cfg = dataclasses.replace(VideoLlavaConfig.tiny(),
                              seg=SegHeadConfig(seg_backbone="tiny"))
    wide = Tokenizer.from_pretrained(bpe_dirs["llama3_wide"])
    with pytest.raises(ValueError, match="outside the LLM's 512"):
        initialize_vision_tokenizer(wide, cfg)
    fits = Tokenizer.from_pretrained(bpe_dirs["llama3"])
    out = initialize_vision_tokenizer(fits, cfg)
    assert out.seg_token_idx == fits.convert_tokens_to_ids("<vid_seg>") \
        < cfg.llm.vocab_size
    assert out.sf_separator_token_idx == fits.convert_tokens_to_ids(
        "<sf_vid_separator>")


def test_attention_routes_at_the_bucketed_lengths(vicas_train_env,  # noqa: F811
                                                  bpe_dirs):
    """The full-width model's collated lengths of the fixture's caption
    and referral items (32 frames: 5,120 visual tokens, right-padded to a
    multiple of 128): K2 and K6a / K6b at head dim 128 take
    attention_sm90.cu / attention_bwd_sm90.cu, and TMA can address the
    LLM's q / k / v views there."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.config import SegHeadConfig, VideoLlavaConfig
    from video_llava_seg_torch.data.collate import DataCollator
    from video_llava_seg_torch.data.vicas import ViCaSDataset
    from video_llava_seg_torch.tokenizer import Tokenizer

    tok = Tokenizer.from_pretrained(bpe_dirs["llama3"])
    tok.add_tokens(VISION_TOKENS, special_tokens=True)
    cfg = dataclasses.replace(
        VideoLlavaConfig(), seg_token_idx=tok.convert_tokens_to_ids(
            "<vid_seg>"), seg=SegHeadConfig(image_size=64, max_seg_frames=4))
    args = _data_args("video_llava_seg_torch", num_frames=32,
                      num_slow_frames=8)
    ds = ViCaSDataset(tok, args, vision_image_size=28)
    collate = DataCollator(cfg, args)
    lc = cfg.llm
    seen = set()
    for i in (0, [s[1] for s in ds.samples].index("mask")):
        n = collate([ds[i]])["gather_idx"].shape[1]
        seen.add(n)
        assert n % 128 == 0 and 5120 < n <= cfg.tokenizer_model_max_length
        hkv, hq, d = lc.num_kv_heads, lc.num_heads, 128
        assert kernels.attention_entry(d, False, n, hkv) == \
            "vls_flash_fwd_sm90"
        assert kernels.attention_bwd_entry(d, n, hkv) == (
            "vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90")
        width = (hq + 2 * hkv) * d
        for h, what in ((hq, "q"), (hkv, "k"), (hkv, "v")):
            stride = (n * width, d, width, 1)
            for box in (kernels.FLASH_SM90_BOX, kernels.FLASH_SM90_BWD_BOX):
                dims = kernels._tensor_map_dims((1, h, n, d), stride, 2,
                                                what, box)
                assert dims[:4] == (d, n, h, 1)
    assert seen


def _v01_layout(root):
    """The CLI reads DataConfig's default ViCaS version, v0.1."""
    vicas = osp.join(str(root), "ViCaS")
    for sub in ("annotations", "splits"):
        shutil.copytree(osp.join(vicas, sub, "v1.0"),
                        osp.join(vicas, sub, "v0.1"))


def test_training_cli_from_the_vicas_fixture(vicas_train_env,  # noqa: F811
                                             bpe_dirs, tmp_path):
    """`train.main --stage stage3 --dataset vicas --tokenizer <dir>
    --tiny --device cpu`: two QLoRA steps on the ViCaS fixture's captions
    (the tiny model has no seg head), finite losses, a checkpoint; then
    `load_model` reads the port's tokenizer from a checkpoint holding its
    tokenizer.json."""
    from video_llava_seg_torch.inference.main import load_model
    from video_llava_seg_torch.tokenizer import Tokenizer
    from video_llava_seg_torch.train import train as cli

    _v01_layout(vicas_train_env)
    out = str(tmp_path / "run")
    state = cli.main(["--stage", "stage3", "--tiny", "--dataset", "vicas",
                      "--tokenizer", bpe_dirs["llama3"], "--bits", "8",
                      "--lora_enable", "--device", "cpu",
                      "--num_train_steps", "2", "--save_steps", "2",
                      "--gradient_accumulation_steps", "1",
                      "--output_dir", out])
    assert state.step == 2
    with open(osp.join(out, "train_log.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["num_text_tokens"] > 0
               for r in rows)
    ckpt = osp.join(out, "checkpoint-2")
    for f in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(osp.join(bpe_dirs["llama3"], f), ckpt)
    _, cfg, tok = load_model(ckpt, device="cpu", dtype=torch.float32)
    assert isinstance(tok, Tokenizer) and cfg.llm.vocab_size == 512
    assert tok.decode(tok("a dog runs").input_ids,
                      skip_special_tokens=True) == "a dog runs"
    with pytest.raises(SystemExit, match="not a local directory"):
        cli.main(["--stage", "stage3", "--tiny", "--device", "cpu",
                  "--tokenizer", "meta-llama/Meta-Llama-3-8B-Instruct",
                  "--output_dir", out])
    os.remove(osp.join(ckpt, "tokenizer.json"))
    with open(osp.join(ckpt, "tokenizer.model"), "wb") as fh:
        fh.write(b"\x0a\x00")
    with pytest.raises(OSError, match="tokenizer.model"):
        load_model(ckpt, device="cpu", dtype=torch.float32)
