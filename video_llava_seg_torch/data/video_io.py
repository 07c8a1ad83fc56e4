"""Video frame loading (port of `video_llava_seg_tpu/data/video_io.py`):
uniform frame sampling from an mp4 (a copy pinned to the JAX package's
by `tests/test_torch_host_io.py`), and the SAM2 video predictor's frame
loader (`load_video_frames`, `AsyncFrameLoader`; the reference's
sam2/utils/misc.py:92-309).

Decoding uses OpenCV (mp4) and PIL (JPEG folders), imported where they
are used, so importing this module needs neither; a [T, H, W, 3] uint8
ndarray needs no decoding at all, and the machine with the card has
neither library. The predictor's frames are resized as PIL's
`Image.resize((S, S))` does (`ops.resize.pil_resize`, on the frames'
device), then scaled by 1/255 and normalised with the ImageNet mean and
std.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from video_llava_seg_torch.ops.resize import pil_resize

IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)


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


# ---------------------------------------------------------------------------
# SAM2 video predictor frames
# ---------------------------------------------------------------------------

def _missing(what: str, exc: ImportError) -> ImportError:
    return ImportError(f"{what} needs {exc.name}, which is not installed; "
                       "pass the frames as a [T, H, W, 3] uint8 ndarray")


def load_frames_from_jpg_dir(dir_path: str):
    """'<idx>.jpg' frames of a folder (the reference's misc.py:219+), RGB
    uint8 at their size: (list of [H, W, 3], height, width)."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise _missing("a JPEG folder", exc) from None
    names = [p for p in os.listdir(dir_path)
             if os.path.splitext(p)[-1].lower() in (".jpg", ".jpeg", ".png")]
    names.sort(key=lambda p: int(os.path.splitext(p)[0]))
    if not names:
        raise RuntimeError(f"no images found in {dir_path}")
    frames = [np.asarray(Image.open(os.path.join(dir_path, n)).convert(
        "RGB")) for n in names]
    return frames, frames[0].shape[0], frames[0].shape[1]


def load_raw_frames(video_path) -> Tuple[List[np.ndarray], int, int]:
    """An mp4 (path or bytes), a JPEG folder or a [T, H, W, 3] uint8
    ndarray as raw uint8 frames: (frames, video height, video width)."""
    if isinstance(video_path, np.ndarray):
        frames = list(video_path)
    elif isinstance(video_path, bytes) or (
            isinstance(video_path, str)
            and os.path.splitext(video_path)[-1].lower() == ".mp4"):
        try:
            arr, _, _ = read_video_frames_cv2(video_path)
        except ImportError as exc:
            raise _missing("an mp4", exc) from None
        frames = list(arr)
    elif isinstance(video_path, str) and os.path.isdir(video_path):
        return load_frames_from_jpg_dir(video_path)
    else:
        raise NotImplementedError(
            "Only MP4, JPEG folder, or ndarray inputs are supported")
    return frames, frames[0].shape[0], frames[0].shape[1]


def normalize_frames(frames: torch.Tensor, image_size: int) -> torch.Tensor:
    """uint8 [T, H, W, 3] on any device -> fp32 [T, S, S, 3]: PIL's bicubic
    resize to S x S, / 255, ImageNet mean / std."""
    x = pil_resize(frames, (image_size, image_size))
    mean = torch.tensor(IMG_MEAN, device=x.device)
    std = torch.tensor(IMG_STD, device=x.device)
    return (x / 255.0 - mean) / std


def load_video_frames(video_path, image_size: int, device="cuda"):
    """The SAM2 video predictor's loader: (frames fp32 [T, S, S, 3] on
    `device`, video height, video width). The raw frames go to the device
    once, as uint8, and are resized and normalised there."""
    frames, h, w = load_raw_frames(video_path)
    raw = torch.from_numpy(np.stack(frames)).to(device)
    return normalize_frames(raw, image_size), h, w


class AsyncFrameLoader:
    """Frames normalised in a background thread (the reference's
    misc.py:92-168 AsyncVideoFrameLoader): frame 0 synchronously, so the
    sizes are known, the rest in a daemon thread on the CPU; indexing
    waits for the frame it asks for. Frames stay on the host, fp32 [S, S,
    3], and go to the device when the predictor reads them."""

    def __init__(self, video_path, image_size: int):
        raw, self.video_height, self.video_width = load_raw_frames(
            video_path)
        self.image_size = image_size
        self._frames = [None] * len(raw)
        self._frames[0] = self._one(raw[0])
        self._exception = None
        self._done = threading.Event()

        def worker():
            try:
                for i in range(1, len(raw)):
                    self._frames[i] = self._one(raw[i])
            except Exception as exc:   # surfaced on the next access
                self._exception = exc
            finally:
                self._done.set()

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _one(self, frame: np.ndarray) -> torch.Tensor:
        return normalize_frames(torch.from_numpy(frame)[None],
                                self.image_size)[0]

    @property
    def shape(self):
        return (len(self._frames), self.image_size, self.image_size, 3)

    def __len__(self):
        return len(self._frames)

    def __getitem__(self, index):
        while self._frames[index] is None:
            if self._exception is not None:
                raise RuntimeError("async frame loading failed") \
                    from self._exception
            self._done.wait(0.01)
        return self._frames[index]
