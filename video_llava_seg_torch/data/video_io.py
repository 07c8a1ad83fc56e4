"""Uniform frame sampling from an mp4 (copy of the mp4 path of
`video_llava_seg_tpu/data/video_io.py`, pinned to it by
`tests/test_torch_host_io.py`).

Decoding uses OpenCV, imported where it is used (`_cv2()`), so importing
this module needs no cv2; the frames-level serving entry points need no
decoding at all.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Union

import numpy as np


def _cv2():
    import cv2
    return cv2


def read_video_frames_cv2(path_or_bytes: Union[str, bytes],
                          indices: Optional[np.ndarray] = None):
    """Decode frames from an mp4 (path or raw bytes) as RGB uint8 arrays.

    Returns (frames [T, H, W, 3], total_frames, fps)."""
    cv2 = _cv2()
    tmp = None
    path = path_or_bytes
    if isinstance(path_or_bytes, bytes):
        tmp = tempfile.NamedTemporaryFile(suffix=".mp4", delete=False)
        tmp.write(path_or_bytes)
        tmp.flush()
        path = tmp.name
    try:
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path!r}")
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frames = []
        if indices is None:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        else:
            want = set(int(i) for i in indices)
            hi = max(want) if want else -1
            i = 0
            got = {}
            while i <= hi:
                ok, frame = cap.read()
                if not ok:
                    break
                if i in want:
                    got[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                i += 1
            frames = [got[int(i)] for i in indices if int(i) in got]
        cap.release()
        return (np.stack(frames) if frames
                else np.zeros((0, 0, 0, 3), np.uint8)), total, fps
    finally:
        if tmp is not None:
            tmp.close()
            os.unlink(tmp.name)


def sample_frame_indices(total_frames: int, num_frames: int) -> np.ndarray:
    """Uniform linspace sampling of `num_frames` of `total_frames`."""
    if total_frames <= 0:
        return np.zeros((0,), np.int64)
    return np.linspace(0, total_frames - 1,
                       num_frames).round().astype(np.int64)


def load_video_uniform(path_or_bytes, num_frames: int,
                       return_timestamps: bool = False):
    """Decode `num_frames` uniformly sampled RGB frames from an mp4."""
    cv2 = _cv2()
    tmp = None
    path = path_or_bytes
    if isinstance(path_or_bytes, bytes):
        tmp = tempfile.NamedTemporaryFile(suffix=".mp4", delete=False)
        tmp.write(path_or_bytes)
        tmp.flush()
        path = tmp.name
    try:
        cap = cv2.VideoCapture(path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        idx = sample_frame_indices(total, num_frames)
        frames, total, fps = read_video_frames_cv2(path, idx)
        if return_timestamps:
            ts = idx.astype(np.float64) / max(total - 1, 1)
            return frames, ts
        return frames
    finally:
        if tmp is not None:
            tmp.close()
            os.unlink(tmp.name)
