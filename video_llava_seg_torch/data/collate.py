"""Batch collation and the data-module factory (port of
`video_llava_seg_torch/data/collate.py`, pinned to it by
`tests/test_torch_data.py`; the reference's data_parsing.py).

The ragged per-sample items become ONE batch of fixed shapes: sequences
right-padded to a length bucketed to 128 (capped at the model's token
budget), seg frames / objects padded to (max_seg_frames, max_objects)
with validity flags, and the multimodal splice planned into gather
indices (`models/llava.build_splice_plan`). Right padding is safe for
the train step: the pad positions carry IGNORE_INDEX labels and the step
takes no key mask (`attn_mask` is collated but unused), so every query
row sees at least its own key."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from video_llava_seg_torch.config import DataConfig, VideoLlavaConfig
from video_llava_seg_torch.constants import IGNORE_INDEX
from video_llava_seg_torch.models import llava


def _bucket_len(n: int, bucket: int = 128) -> int:
    return ((n + bucket - 1) // bucket) * bucket


class DataCollator:
    def __init__(self, cfg: VideoLlavaConfig, data_args: DataConfig,
                 pad_token_id: int = 0, seq_bucket: int = 128):
        self.cfg = cfg
        self.data_args = data_args
        self.pad_token_id = pad_token_id
        self.seq_bucket = seq_bucket

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = len(instances)
        tpi = llava.visual_tokens_per_sample(cfg)

        max_ids = max(len(i["input_ids"]) for i in instances)
        ids = np.full((b, max_ids), self.pad_token_id, np.int64)
        labels = np.full((b, max_ids), IGNORE_INDEX, np.int64)
        for bi, inst in enumerate(instances):
            n = len(inst["input_ids"])
            ids[bi, :n] = inst["input_ids"]
            labels[bi, :n] = inst["labels"]

        spliced_len = max_ids - len(tpi) + sum(tpi)
        pad_to = min(_bucket_len(spliced_len, self.seq_bucket),
                     cfg.tokenizer_model_max_length)
        plan = llava.build_splice_plan(
            ids, tpi, labels, max_length=cfg.tokenizer_model_max_length,
            pad_to=pad_to)

        batch = {
            "video": np.stack([i["image"] for i in instances]),
            "text_ids": plan.text_ids,
            "gather_idx": plan.gather_idx,
            "position_ids": plan.position_ids,
            "labels": plan.labels,
            "attn_mask": plan.attn_mask,
        }

        if any("seg_frames" in i for i in instances):
            assert cfg.seg is not None
            t_cap = cfg.seg.max_seg_frames
            n_cap = cfg.seg.max_objects
            s = cfg.seg.image_size
            seg_frames = np.zeros((b, t_cap, s, s, 3), np.float32)
            seg_masks = np.zeros((b, n_cap, t_cap, s, s), bool)
            seg_valid = np.zeros((b, n_cap), bool)
            seg_frame_valid = np.zeros((b, t_cap), bool)
            seg_padding = np.zeros((b, 4), np.int32)
            seg_token_pos = np.zeros((b, n_cap), np.int32)
            has_masks = np.zeros((b,), bool)
            for bi, inst in enumerate(instances):
                frames = inst.get("seg_frames")
                meta = inst.get("seg_meta", {})
                if frames is None:
                    continue
                t = min(frames.shape[0], t_cap)
                seg_frames[bi, :t] = frames[:t]
                seg_frame_valid[bi, :t] = True
                pl, pr, pt, pb = meta.get("padding", (0, 0, 0, 0))
                seg_padding[bi] = (pl, pr, pt, pb)
                m = inst.get("seg_masks")
                if m is not None:
                    n = min(m.shape[0], n_cap)
                    nh, nw = m.shape[-2:]
                    # place the (unpadded) GT into the padded canvas at the
                    # frame offset so it aligns pixel-exactly with the
                    # padded prediction
                    seg_masks[bi, :n, :t, pt:pt + nh, pl:pl + nw] = \
                        m[:n, :t]
                    # positions of [SEG]-producing hidden states: labels ==
                    # seg_token_idx shifted by -1 (llava_llama.py:232-235).
                    # If sequence truncation cut off [SEG] labels, only the
                    # surviving objects stay valid — otherwise truncated
                    # objects would train against hidden state 0.
                    pos = np.flatnonzero(
                        plan.labels[bi] == cfg.seg_token_idx) - 1
                    n = min(n, len(pos))
                    seg_token_pos[bi, :min(len(pos), n_cap)] = \
                        pos[:n_cap]
                    seg_valid[bi, :n] = True
                    has_masks[bi] = n > 0
            batch.update({
                "seg_frames": seg_frames, "seg_masks": seg_masks,
                "seg_valid": seg_valid, "seg_frame_valid": seg_frame_valid,
                "seg_padding": seg_padding, "seg_token_pos": seg_token_pos,
                "has_masks": has_masks,
            })
            # NOTE: per-sample seg_meta dicts stay host-side (the loss needs
            # only seg_padding); a non-array leaf would break the jitted
            # step and device prefetch
        return batch


def make_supervised_data_module(tokenizer, cfg: VideoLlavaConfig,
                                data_args: DataConfig,
                                subsample_factor: int = 1,
                                **readers) -> Dict:
    """Dataset factory (data_parsing.py:73-100 parity). readers: the
    datasets' decoder arguments (`read_clip`, and `read_frame` for
    ViCaS), where the defaults (OpenCV, PIL) are not to be used. A model
    without a seg head takes the ViCaS captions only (`exclude_seg`; the
    collator refuses seg payloads for it)."""
    if data_args.dataset == "vicas":
        from video_llava_seg_torch.data.vicas import ViCaSDataset
        dataset = ViCaSDataset(tokenizer, data_args,
                               vision_image_size=cfg.vision.image_size,
                               exclude_seg=cfg.seg is None, **readers)
    elif data_args.dataset in ("caption", "webvid", "panda70m"):
        from video_llava_seg_torch.data.caption_datasets import (
            VideoCaptionDataset,
        )
        readers.pop("read_frame", None)
        dataset = VideoCaptionDataset(tokenizer, data_args,
                                      vision_image_size=cfg.vision.image_size,
                                      **readers)
    else:
        raise ValueError(f"unknown dataset: {data_args.dataset}")
    if subsample_factor > 1:
        keep = list(range(0, len(dataset), subsample_factor))
        dataset.filter_indices(keep)
    collator = DataCollator(cfg, data_args,
                            pad_token_id=tokenizer.pad_token_id or 0)
    return {"train_dataset": dataset, "eval_dataset": None,
            "data_collator": collator}
