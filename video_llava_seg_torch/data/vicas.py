"""ViCaS dataset: video captioning and LG-VIS referral samples (port of
`video_llava_seg_tpu/data/vicas.py`, pinned to it by
`tests/test_torch_data.py`; the reference's llava/train/vicas_dataset.py).

Per-video JSON annotations give two sample kinds, 'caption' (with its
reworded variants) and 'mask' (one per object referral; the referrals
resampled up to the caption count); GT frames and their COCO-RLE masks
capped at max_seg_frames; a mask-containing random crop; the seg frames
resized to the seg head's size (bilinear, align_corners=False, no
antialias) and padded, the masks resized, thresholded at 0.5 and left
unpadded; the clip CLIP-preprocessed (PIL bicubic, emulated by
`inference.utils.clip_preprocess_frames`); the slow-fast <video>
expansion; three tries on a failing sample. The resizes run on CPU
tensors in the loader's thread; the items are numpy, as the JAX
package's.

The two decoders are arguments: `read_clip` (default
`video_io.load_video_uniform`, OpenCV for an mp4) takes the clip file's
bytes, the frame count and `return_timestamps`; `read_frame` (default PIL)
takes a GT frame's path and returns uint8 [H, W, 3]. Neither library is
on the machine with the card, which reads .npy files through them.
"""

from __future__ import annotations

import json
import os.path as osp
import random
from glob import glob
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from video_llava_seg_torch.config import DataConfig
from video_llava_seg_torch.constants import DEFAULT_VIDEO_TOKEN, VIDEO_SEG_TOKEN
from video_llava_seg_torch.data import video_io
from video_llava_seg_torch.data.augment import (
    compute_mask_containing_video_crop,
)
from video_llava_seg_torch.data.preprocess import (
    PreprocessArgs,
    preprocess,
    preprocess_multimodal,
)
from video_llava_seg_torch.ops.masks import decode_rle
from video_llava_seg_torch.paths import Paths

PROMPT_LIST = [
    "Describe what is happening in the video in detail. Talk about the "
    "events, the main objects/actors and also briefly describe the "
    "background scene.",
    "Provide a detailed description of the video, focusing on the events, "
    "key participants or objects, and the background setting.",
    "Explain in detail what is occurring in the video, including the main "
    "actions, important figures or items, and the surrounding environment.",
    "Give a thorough account of the video, describing the events, the "
    "central actors or objects, and the scene in the background",
    "Describe the video comprehensively, covering the actions taking "
    "place, the primary subjects or objects involved, and the background "
    "setting.",
]


def read_frame_pil(path: str) -> np.ndarray:
    """A GT frame as RGB uint8 [H, W, 3] (PIL, imported here)."""
    from PIL import Image

    return np.array(Image.open(path).convert("RGB"))


def clip_video(video: np.ndarray, image_size: int
               ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """uint8 [T, H, W, 3] -> (CLIP-normalised fp32 [T, S, S, 3], the
    squared frame size): pad to square with the CLIP mean, PIL bicubic
    resize, rescale, normalise (`inference.utils.clip_preprocess_frames`
    on CPU tensors)."""
    from video_llava_seg_torch.inference.utils import clip_preprocess_frames

    side = max(video.shape[1:3])
    out = clip_preprocess_frames(torch.from_numpy(np.ascontiguousarray(
        video)), image_size)
    return out.numpy(), (side, side)


class ViCaSDataset:
    prompt_list = PROMPT_LIST

    def __init__(self, tokenizer, data_args: DataConfig,
                 vision_image_size: int = 336,
                 exclude_captions: bool = False, exclude_seg: bool = False,
                 use_text_prompt: bool = True, split: str = "train",
                 seed: int = 0,
                 read_clip: Callable = video_io.load_video_uniform,
                 read_frame: Callable[[str], np.ndarray] = read_frame_pil):
        self.tokenizer = tokenizer
        self.data_args = data_args
        self.vision_image_size = vision_image_size
        self.exclude_seg = exclude_seg
        self.use_text_prompt = use_text_prompt
        self.read_clip = read_clip
        self.read_frame = read_frame
        self.rng = random.Random(seed)
        self.n_epochs = 1
        self.video_dir = Paths.vicas_videos_dir()
        self.video_frames_dir = Paths.vicas_video_frames_dir()

        with open(Paths.vicas_split_json(split, data_args.vicas_version)) as fh:
            split_video_ids = json.load(fh)
        json_files = sorted(glob(osp.join(
            str(Paths.vicas_annotations_dir(data_args.vicas_version)),
            "*.json")))
        samples_caption: List[Tuple] = []
        samples_referral: List[Tuple] = []
        assert not (exclude_captions and exclude_seg)
        for f in json_files:
            with open(f) as fh:
                content = json.load(fh)
            if content["video_id"] not in split_video_ids:
                continue
            if not exclude_captions:
                n_rew = len(content["reworded_en_captions"])
                samples_caption.append((f, "caption", -1))
                samples_caption.extend((f, "caption", j) for j in range(n_rew))
            if not exclude_seg:
                for i in range(len(content["object_referrals"])):
                    samples_referral.append((f, "mask", i))
        if samples_referral and len(samples_referral) < len(samples_caption):
            pad = self.rng.choices(
                samples_referral,
                k=len(samples_caption) - len(samples_referral))
            samples_referral.extend(pad)
        self.samples = samples_caption + samples_referral

    def set_num_epochs(self, n: int):
        self.n_epochs = n

    def filter_indices(self, keep: List[int]):
        self.samples = [self.samples[i] for i in keep]

    def __len__(self):
        return int(len(self.samples) * self.n_epochs)

    @property
    def modality_lengths(self):
        return [1] * len(self)

    # ------------------------------------------------------------------

    def get_video_bytes(self, content) -> bytes:
        path = osp.join(str(self.video_dir), content["filename"])
        with open(path, "rb") as fh:
            return fh.read()

    def get_seg_frames_and_masks(self, content,
                                 track_ids: Optional[List[int]]):
        """GT frames (+ per-track RLE masks) capped at max_seg_frames."""
        frames, masks_seq, filenames, frame_idx = [], [], [], []
        meta: Dict[str, Any] = {}
        for t, segs_t in enumerate(content["segmentations"]):
            if not segs_t["is_gt"]:
                continue
            path = osp.join(str(self.video_frames_dir),
                            f"{content['video_id']:06d}", segs_t["filename"])
            image = self.read_frame(path)
            h, w = image.shape[:2]
            meta["orig_image_size"] = (h, w)
            frames.append(image)
            filenames.append(segs_t["filename"])
            frame_idx.append(t)
            if track_ids is not None:
                masks_t = [np.zeros((h, w), np.uint8)
                           for _ in range(len(track_ids))]
                for tid, rle in zip(segs_t["track_ids"], segs_t["mask_rles"]):
                    if tid not in track_ids:
                        continue
                    masks_t[track_ids.index(tid)] = decode_rle(rle)
                masks_seq.append(np.stack(masks_t))
        frames = np.stack(frames)                       # [T, H, W, 3]
        timestamps = (np.asarray(frame_idx, np.float32)
                      / max(len(content["segmentations"]) - 1, 1))
        masks = (np.stack(masks_seq, axis=1).astype(bool)
                 if track_ids is not None else None)    # [N, T, H, W]
        if frames.shape[0] > self.data_args.max_seg_frames:
            keep = np.linspace(0, frames.shape[0] - 1,
                               self.data_args.max_seg_frames).round().astype(
                int)
            frames = frames[keep]
            timestamps = timestamps[keep]
            filenames = [filenames[i] for i in keep]
            if masks is not None:
                masks = masks[:, keep]
        meta.update({"video_id": content["video_id"], "filenames": filenames,
                     "timestamps": timestamps, "track_ids": track_ids})
        return frames, masks, meta

    def augment_sample(self, frames, masks, meta, crop_factor=0.75):
        """Mask-containing random crop."""
        h, w = frames.shape[1:3]
        ch, cw = int(h * crop_factor), int(w * crop_factor)
        merged = np.any(masks, axis=0)  # [T, H, W]
        try:
            ret = compute_mask_containing_video_crop(merged, (ch, cw),
                                                     rng=self.rng)
        except Exception as exc:
            print(f"Error in dataset augmentation: {exc}")
            ret = None
        if ret is None:
            meta.update({"crop_topleft": (0, 0), "orig_image_size": (h, w),
                         "precrop_image_size": (h, w)})
        else:
            x1, y1 = ret
            frames = frames[:, y1:y1 + ch, x1:x1 + cw]
            masks = masks[:, :, y1:y1 + ch, x1:x1 + cw]
            meta["precrop_image_size"] = meta.pop("orig_image_size")
            meta.update({"crop_topleft": (y1, x1),
                         "orig_image_size": (ch, cw)})
        return frames, masks, meta

    def preprocess_seg_inputs(self, frames, masks, meta):
        """Resize the long side to the seg size and pad (frames, NHWC in
        [0, 1]); the masks resized bilinear > 0.5 but NOT padded (the
        loss runs at the pre-pad size)."""
        from video_llava_seg_torch.inference.utils import (
            preprocess_seg_inputs,
        )
        from video_llava_seg_torch.ops.resize import interpolate_hw

        x, out = preprocess_seg_inputs(
            torch.from_numpy(np.ascontiguousarray(frames)), meta,
            self.data_args.seg_image_size, pad_mode=self.data_args.pad_mode)
        meta.update(out)
        nh, nw = meta["resized_image_size"]
        m = None
        if masks is not None:
            m = (interpolate_hw(torch.from_numpy(masks.astype(np.float32)),
                                (nh, nw), "bilinear") > 0.5).numpy()
        return x.numpy(), m, meta

    # ------------------------------------------------------------------

    def __getitem__(self, index):
        for _ in range(3):
            try:
                return self.parse_sample(index)
            except Exception as e:
                print(f"Error processing sample {index}: {e}")
                index = self.rng.randint(0, len(self) - 1)
        raise RuntimeError("Failed to parse sample after 3 tries")

    def parse_sample(self, index):
        index = index % len(self.samples)
        json_path, sample_type, sub_index = self.samples[index]
        with open(json_path) as fh:
            content = json.load(fh)
        caption = content["caption_parsed_en_gpt"]

        if sample_type == "caption":
            if sub_index >= 0:
                caption = content["reworded_en_captions"][sub_index]
            prompt = self.rng.choice(self.prompt_list)
            conversation = [
                {"from": "human", "value": DEFAULT_VIDEO_TOKEN + (
                    "\n" + prompt if self.use_text_prompt else "")},
                {"from": "gpt", "value": caption},
            ]
            track_ids = None
        else:
            referral = content["object_referrals"][sub_index]
            track_ids = referral["track_ids"]
            conversation = [
                {"from": "human",
                 "value": f"{DEFAULT_VIDEO_TOKEN}\n{referral['prompt']} "
                          "Please output the segmentation mask."},
                {"from": "gpt", "value": VIDEO_SEG_TOKEN * len(track_ids)},
            ]

        seg_frames, seg_masks, seg_meta = self.get_seg_frames_and_masks(
            content, track_ids)

        video_bytes = self.get_video_bytes(content)
        video, timestamps = self.read_clip(
            video_bytes, self.data_args.num_frames, return_timestamps=True)
        seg_meta["llm_timestamps"] = timestamps
        video, image_size = clip_video(video, self.vision_image_size)

        if seg_masks is not None:
            seg_frames, seg_masks, seg_meta = self.augment_sample(
                seg_frames, seg_masks, seg_meta,
                crop_factor=self.data_args.crop_factor)
        seg_frames, seg_masks, seg_meta = self.preprocess_seg_inputs(
            seg_frames, seg_masks, seg_meta)

        pargs = PreprocessArgs(num_frames=self.data_args.num_frames,
                               num_slow_frames=self.data_args.num_slow_frames,
                               conv_template=self.data_args.conv_template)
        sources = preprocess_multimodal([conversation], pargs)
        data = preprocess(sources, self.tokenizer, has_image=True,
                          template=self.data_args.conv_template)
        seg_meta["sub_index"] = sub_index

        out = {
            "input_ids": data["input_ids"][0],
            "labels": data["labels"][0],
            "image": video,
            "image_size": image_size,
        }
        if not self.exclude_seg:
            out["seg_frames"] = seg_frames
            out["seg_masks"] = seg_masks
            out["seg_meta"] = seg_meta
        return out
