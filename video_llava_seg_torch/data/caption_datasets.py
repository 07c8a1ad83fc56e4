"""Caption pretraining datasets: WebVid10M + Panda70M (port of
`video_llava_seg_tpu/data/caption_datasets.py`, pinned to it by
`tests/test_torch_data.py`; the reference's llava/train/video_datasets.py).

A walk over the shard directories of (json, mp4) pairs, 11 prompt
templates, a retry on a corrupt sample, the square pad + CLIP
preprocessing and the slow-fast <video> expansion. The clip decoder is an
argument, `read_clip`, as in `data/vicas.py`."""

from __future__ import annotations

import json
import os
import os.path as osp
import random
from collections import defaultdict
from typing import Callable, List

from video_llava_seg_torch.config import DataConfig
from video_llava_seg_torch.constants import DEFAULT_VIDEO_TOKEN
from video_llava_seg_torch.data import video_io
from video_llava_seg_torch.data.preprocess import (
    PreprocessArgs,
    preprocess,
    preprocess_multimodal,
)
from video_llava_seg_torch.data.vicas import clip_video
from video_llava_seg_torch.paths import Paths


class VideoCaptionDataset:
    prompt_list = [
        "Describe what is happening in the video in a few sentences.",
        "Summarize the events occurring in the video in a few sentences.",
        "Provide a brief description of the actions taking place in this "
        "video.",
        "Explain what is happening in the video scene by scene.",
        "Describe the main activities shown in this video clip.",
        "Give an overview of the key events happening in the video.",
        "Write a short narrative of the events depicted in the video.",
        "Detail the sequence of actions occurring in this video.",
        "Capture the essence of the video by describing the actions shown.",
        "Narrate the key moments of the video in a few lines.",
        "Please faithfully summarize the video in a few sentences",
    ]

    def __init__(self, tokenizer, data_args: DataConfig,
                 vision_image_size: int = 336, use_text_prompt: bool = True,
                 seed: int = 0,
                 read_clip: Callable = video_io.load_video_uniform):
        self.tokenizer = tokenizer
        self.data_args = data_args
        self.vision_image_size = vision_image_size
        self.use_text_prompt = use_text_prompt
        self.read_clip = read_clip
        self.rng = random.Random(seed)
        self.dataset_paths = {
            "WebVid10M": str(Paths.webvid_dir()),
            "Panda70M": str(Paths.panda70m_dir()),
        }
        self.json_paths: List = []
        for name, path in self.dataset_paths.items():
            if not osp.isdir(path):
                continue
            shard_dirs = sorted(x for x in os.listdir(path)
                                if osp.isdir(osp.join(path, x)))
            for d in shard_dirs:
                self.json_paths.extend(
                    (name, osp.join(d, x))
                    for x in sorted(os.listdir(osp.join(path, d)))
                    if x.endswith(".json"))
        counts = defaultdict(int)
        for n, _ in self.json_paths:
            counts[n] += 1
        print(f"Caption dataset video count: {dict(counts)}")

    def filter_indices(self, keep: List[int]):
        self.json_paths = [self.json_paths[i] for i in keep]

    def __len__(self):
        return len(self.json_paths)

    @property
    def modality_lengths(self):
        return [1] * len(self)

    @staticmethod
    def parse_json(content):
        caption = content["caption"]
        if "video_id" in content:       # Panda70M
            video_id = content["video_id"]
        elif "videoid" in content:      # WebVid10M
            video_id = content["videoid"]
        else:
            raise ValueError("Neither 'videoid' nor 'video_id' in JSON")
        return caption, video_id, content.get("matching_score", 1.0)

    def __getitem__(self, index):
        video_id = None
        try:
            name, relpath = self.json_paths[index]
            json_path = osp.join(self.dataset_paths[name], relpath)
            with open(json_path) as fh:
                content = json.load(fh)
            caption, video_id, _ = self.parse_json(content)
            with open(json_path.replace(".json", ".mp4"), "rb") as fh:
                video_bytes = fh.read()

            prompt = self.rng.choice(self.prompt_list)
            conversation = [
                {"from": "human", "value": DEFAULT_VIDEO_TOKEN + (
                    "\n" + prompt if self.use_text_prompt else "")},
                {"from": "gpt", "value": caption},
            ]
            video = self.read_clip(video_bytes, self.data_args.num_frames)
            video, image_size = clip_video(video, self.vision_image_size)

            pargs = PreprocessArgs(
                num_frames=self.data_args.num_frames,
                num_slow_frames=self.data_args.num_slow_frames,
                conv_template=self.data_args.conv_template)
            sources = preprocess_multimodal([conversation], pargs)
            data = preprocess(sources, self.tokenizer, has_image=True,
                              template=self.data_args.conv_template)
            return {"input_ids": data["input_ids"][0],
                    "labels": data["labels"][0],
                    "image": video, "image_size": image_size}
        except Exception as e:
            print(f"Error processing video ID {video_id}: {e}")
            return self[self.rng.randint(0, len(self) - 1)]
