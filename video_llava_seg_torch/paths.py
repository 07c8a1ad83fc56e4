"""Environment-driven dataset paths (copy of `video_llava_seg_tpu/paths.py`,
pinned to it by `tests/test_torch_host_io.py`).

Dataset roots come from environment variables with a repo-relative
fallback:
  VIDEONET_MODELS_DIR   — pretrained model zoo root
  VIDEONET_DATASETS_DIR — dataset root (default: <repo>/datasets)
"""

import os
from pathlib import Path


class Paths:
    """Static accessors for dataset and model directories."""

    @staticmethod
    def _repo_root() -> Path:
        return Path(__file__).resolve().parent.parent

    @staticmethod
    def models_dir() -> Path:
        d = os.environ.get("VIDEONET_MODELS_DIR")
        if d is None:
            raise EnvironmentError("Required environment variable "
                                   "'VIDEONET_MODELS_DIR' is not set")
        return Path(d)

    @staticmethod
    def datasets_dir() -> Path:
        d = os.environ.get("VIDEONET_DATASETS_DIR")
        if d is not None:
            return Path(d)
        return Paths._repo_root() / "datasets"

    # ---------------- ViCaS ----------------
    @staticmethod
    def vicas_dir() -> Path:
        return Paths.datasets_dir() / "ViCaS"

    @staticmethod
    def vicas_videos_dir() -> Path:
        return Paths.vicas_dir() / "videos"

    @staticmethod
    def vicas_annotations_dir(version: str = "v0.1") -> Path:
        return Paths.vicas_dir() / "annotations" / version

    @staticmethod
    def vicas_split_json(split: str, version: str = "v0.1") -> Path:
        if split not in ("train", "val", "test"):
            raise ValueError(f"bad split: {split}")
        return Paths.vicas_dir() / "splits" / version / f"{split}.json"

    @staticmethod
    def vicas_video_frames_dir() -> Path:
        return Paths.vicas_dir() / "video_frames"

    # ---------------- caption pretraining corpora ----------------
    @staticmethod
    def webvid_dir() -> Path:
        return Paths.datasets_dir() / "WebVid10M"

    @staticmethod
    def panda70m_dir() -> Path:
        return Paths.datasets_dir() / "Panda70M"

    @staticmethod
    def require(p: Path, what: str) -> Path:
        if not p.exists():
            raise FileNotFoundError(f"{what} not found at {p}")
        return p
