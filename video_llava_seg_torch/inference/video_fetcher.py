"""Video and ground-truth frame fetching for ViCaS inference (copy of
`video_llava_seg_tpu/inference/video_fetcher.py`, pinned to it by
`tests/test_torch_host_io.py`). PIL is imported where frames are read."""

from __future__ import annotations

import os.path as osp
from typing import Any, Dict, Tuple

import numpy as np

from video_llava_seg_torch.paths import Paths


class VideoAndFrameFetcher:
    def __init__(self, args=None):
        self.video_dir = str(Paths.vicas_videos_dir())
        self.video_frames_dir = str(Paths.vicas_video_frames_dir())

    def get_video(self, filename: str) -> bytes:
        path = osp.join(self.video_dir, filename)
        if not osp.exists(path):
            raise FileNotFoundError(f"Video not found at {path}")
        with open(path, "rb") as fh:
            return fh.read()

    def get_frames(self, json_content: Dict[str, Any],
                   max_seg_frames: int = -1,
                   gt_only: bool = True) -> Tuple[np.ndarray, Dict]:
        """Returns (frames uint8 [T, H, W, 3], meta)."""
        from PIL import Image

        frames, filenames, frame_idx = [], [], []
        meta: Dict[str, Any] = {}
        for t, segs_t in enumerate(json_content["segmentations"]):
            if gt_only and not segs_t["is_gt"]:
                continue
            path = osp.join(self.video_frames_dir,
                            f"{json_content['video_id']:06d}",
                            segs_t["filename"])
            if not osp.exists(path):
                raise FileNotFoundError(f"Video frame not found: {path}")
            image = np.array(Image.open(path).convert("RGB"))
            meta["orig_image_size"] = image.shape[:2]
            frames.append(image)
            filenames.append(segs_t["filename"])
            frame_idx.append(t)
        frames = np.stack(frames)
        timestamps = (np.asarray(frame_idx, np.float32)
                      / max(len(json_content["segmentations"]) - 1, 1))
        if 0 < max_seg_frames < frames.shape[0]:
            keep = np.linspace(0, frames.shape[0] - 1,
                               max_seg_frames).round().astype(int)
            frames = frames[keep]
            filenames = [filenames[i] for i in keep]
            timestamps = timestamps[keep]
        meta.update({"video_id": json_content["video_id"],
                     "filenames": filenames, "timestamps": timestamps})
        return frames, meta
