"""Prediction / ground-truth mask overlays (port of
`video_llava_seg_tpu/inference/visualization.py`, the reference's
`llava/inference/visualization.py`).

    python -m video_llava_seg_torch.inference.visualization \
        --pred_dir <prediction jsons> [--gt_dir ...] [--output_dir ...]

writes, for each video and referral, side-by-side prediction | ground
truth overlays of the referral's frames and a language.txt with the
prompt and captions. Images are BGR throughout (cv2's order): the frames
are flipped from RGB once, and the colour map is applied as it is.

Differences from the JAX module, each pinned by
`tests/test_torch_visualization.py`:
- numpy only: `_mask_border` computes the border that cv2's dilate minus
  erode draws (a t x t box anchored at (t // 2, t // 2); out-of-image
  pixels count as below every value for the dilate and above it for the
  erode), where the JAX module calls cv2 (its numpy fallback, taken
  only without cv2, draws a (2t + 1)-pixel box over a zero-padded mask,
  so a mask touching an image edge gets a border along it);
- a prediction's referrals are read under `pred_object_referral_masks`
  or, where that key is missing, under `pred_lgvis_masks`, the key both
  CLIs write (as `inference/eval.py` reads them);
- `main` pairs each referral's images with that referral's own frame
  names; the JAX `main` pairs them with the first names of the list
  `viz_pred_and_gt_masks` builds across all referrals, so a referral
  after the first takes the first's names where their frames differ.
  `viz_pred_and_gt_masks` itself returns what the JAX function returns;
- `main` takes the frame fetcher and the image writer as arguments. The
  CLI reads frames with `inference/video_fetcher.VideoAndFrameFetcher`
  (PIL) and writes with cv2 or else PIL; with neither it raises.
"""

from __future__ import annotations

import copy
import json
import os
import os.path as osp
from argparse import ArgumentParser
from glob import glob
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from video_llava_seg_torch.inference.eval import PRED_KEYS
from video_llava_seg_torch.ops.masks import decode_rle


def create_color_map(n: int = 256) -> np.ndarray:
    """PASCAL-VOC-style deterministic label colormap [n, 3] uint8 (the
    bit-shuffle construction of the vicas package)."""

    def bit(v, i):
        return (v >> i) & 1

    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bit(c, 0) << (7 - j)
            g |= bit(c, 1) << (7 - j)
            b |= bit(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def annotate_image_instance(image: np.ndarray, mask: np.ndarray, color,
                            mask_border: int = 3,
                            mask_opacity: float = 0.4) -> np.ndarray:
    """Alpha-blend `mask` onto `image` with a solid border.

    image: [H, W, 3] uint8; mask: [H, W] {0, 1}; color: (3,) 0-255."""
    out = image.astype(np.float32)
    m = mask.astype(bool)
    color = np.asarray(color, np.float32)
    out[m] = (1.0 - mask_opacity) * out[m] + mask_opacity * color
    if mask_border > 0:
        border = _mask_border(mask.astype(np.uint8), mask_border)
        out[border.astype(bool)] = color
    return out.astype(np.uint8)


def _mask_border(mask: np.ndarray, thickness: int) -> np.ndarray:
    """cv2.dilate(mask, k) - cv2.erode(mask, k) for k = ones(t, t), in
    numpy: output pixel (i, j) takes the max / min over rows i - t // 2 ..
    i + t - 1 - t // 2 and the same columns; pixels off the image are
    left out of both (padded with the dtype's least value for the max,
    its largest for the min). mask: [H, W] uint8."""
    t = thickness
    a = t // 2
    h, w = mask.shape
    pad = ((a, t - 1 - a), (a, t - 1 - a))
    info = np.iinfo(mask.dtype)
    lo = np.pad(mask, pad, constant_values=info.min)
    hi = np.pad(mask, pad, constant_values=info.max)
    dil = np.full_like(mask, info.min)
    ero = np.full_like(mask, info.max)
    for dy in range(t):
        for dx in range(t):
            np.maximum(dil, lo[dy:dy + h, dx:dx + w], out=dil)
            np.minimum(ero, hi[dy:dy + h, dx:dx + w], out=ero)
    return dil - ero


def _decode(rle: Dict) -> np.ndarray:
    rle = copy.deepcopy(rle)
    if isinstance(rle["counts"], str):
        rle["counts"] = rle["counts"].encode("utf-8")
    return decode_rle(rle).astype(np.uint8)


def _pred_referrals(pred_content: Dict) -> List[List[Dict]]:
    """A prediction's per-referral frames, under the first key of
    `eval.PRED_KEYS` it has."""
    key = next((k for k in PRED_KEYS if k in pred_content), PRED_KEYS[0])
    return pred_content[key]


def _referral_images(pred_frames: List[Dict], gt_seg: Dict, track_ids,
                     frames_by_name: Dict[str, np.ndarray], cmap
                     ) -> Tuple[List[np.ndarray], List[str]]:
    """One referral's (pred | GT) overlays and frame names, in its
    predicted frames' order."""
    images, names = [], []
    for pred_t in pred_frames:
        fname = pred_t["filename"]
        image_pred = np.copy(frames_by_name[fname])
        image_gt = np.copy(frames_by_name[fname])
        names.append(fname)
        gt_t = gt_seg[fname]
        for track_id in track_ids:
            if track_id not in gt_t["track_ids"]:
                print(f"ERROR: {track_id} not found in seg list")
                continue
            idx = gt_t["track_ids"].index(track_id)
            mask = _decode(gt_t["mask_rles"][idx])
            image_gt = annotate_image_instance(
                image_gt, mask, color=cmap[track_id % 256])
        for j, rle in enumerate(pred_t["mask_rles"], 1):
            image_pred = annotate_image_instance(image_pred, _decode(rle),
                                                 color=cmap[j])
        h, w = image_pred.shape[:2]
        axis = 1 if h > w else 0
        images.append(np.concatenate((image_pred, image_gt), axis))
    return images, names


def _all_referrals(pred_content: Dict, gt_content: Dict,
                   frames_by_name: Dict[str, np.ndarray]):
    video_id = pred_content["video_id"]
    if gt_content["video_id"] != video_id:
        raise ValueError(f"prediction of video {video_id} against the "
                         f"ground truth of video {gt_content['video_id']}")
    preds = _pred_referrals(pred_content)
    if len(gt_content["object_referrals"]) != len(preds):
        raise ValueError(f"video {video_id}: {len(preds)} predicted "
                         f"referrals, {len(gt_content['object_referrals'])} "
                         "in the ground truth")
    cmap = create_color_map().tolist()
    gt_seg = {s["filename"]: s for s in gt_content["segmentations"]}
    return [_referral_images(p, gt_seg, ref["track_ids"], frames_by_name,
                             cmap)
            for p, ref in zip(preds, gt_content["object_referrals"])]


def viz_pred_and_gt_masks(pred_content: Dict, gt_content: Dict,
                          frames_by_name: Dict[str, np.ndarray]
                          ) -> Tuple[List[List[np.ndarray]], List[str]]:
    """Per-referral, per-frame side-by-side (pred | GT) overlays, and the
    frame names of every referral in turn in one list (the JAX
    function's return values). frames_by_name: filename -> [H, W, 3]
    uint8."""
    per_referral = _all_referrals(pred_content, gt_content, frames_by_name)
    return ([images for images, _ in per_referral],
            [n for _, names in per_referral for n in names])


def default_writer() -> Callable[[str, np.ndarray], None]:
    """An image writer (path, BGR uint8 [H, W, 3]): cv2.imwrite where cv2
    imports, else PIL's (the image flipped to RGB); a RuntimeError naming
    `main`'s `writer` argument where neither does."""
    try:
        import cv2

        return lambda path, img: cv2.imwrite(path, img)
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            "visualization.main: neither cv2 nor PIL imports, so no image "
            "writer can be built; pass writer=(path, BGR uint8 image) -> "
            "None") from None
    return lambda path, img: Image.fromarray(
        np.ascontiguousarray(img[..., ::-1])).save(path)


def main(args=None, fetcher=None,
         writer: Optional[Callable[[str, np.ndarray], None]] = None):
    """The CLI. fetcher: an object with `get_frames(gt_content) -> (RGB
    frames [T, H, W, 3], {"filenames": [...]})` (default: the ViCaS
    `VideoAndFrameFetcher`); writer: (path, BGR uint8 image) -> None
    (default: `default_writer()`)."""
    from video_llava_seg_torch.paths import Paths

    parser = ArgumentParser()
    parser.add_argument("--pred_dir", "-i", required=True)
    parser.add_argument("--gt_dir", required=False)
    parser.add_argument("--output_dir", "-o", required=False)
    parser.add_argument("--dataset_version", default="0.3")
    a = parser.parse_args(args)
    out_dir = a.output_dir or a.pred_dir + "_viz"
    gt_dir = a.gt_dir or str(Paths.vicas_annotations_dir(a.dataset_version))
    if fetcher is None:
        from video_llava_seg_torch.inference.video_fetcher import (
            VideoAndFrameFetcher,
        )

        fetcher = VideoAndFrameFetcher(a)
    write = writer or default_writer()

    for f in sorted(glob(osp.join(a.pred_dir, "*.json"))):
        with open(f) as fh:
            pred = json.load(fh)
        vid = pred["video_id"]
        gt_jsons = glob(osp.join(gt_dir, f"{vid:06d}*.json"))
        if len(gt_jsons) != 1:
            raise FileNotFoundError(f"video {vid}: {len(gt_jsons)} ground "
                                    f"truth files in {gt_dir}: {gt_jsons}")
        with open(gt_jsons[0]) as fh:
            gt = json.load(fh)
        frames, meta = fetcher.get_frames(gt)
        # RGB [T, H, W, 3] -> BGR, the writer's order
        frames_by_name = {n: fr[..., ::-1]
                          for n, fr in zip(meta["filenames"], frames)}
        for i, (images, names) in enumerate(
                _all_referrals(pred, gt, frames_by_name)):
            d = osp.join(out_dir, f"{vid:06d}", f"referral_{i}")
            os.makedirs(d, exist_ok=True)
            for fname, img in zip(names, images):
                write(osp.join(d, fname), img)
            with open(osp.join(d, "language.txt"), "w") as fh:
                fh.write("Prompt: "
                         + gt["object_referrals"][i]["prompt"] + "\n")
                fh.write("Caption: " + gt["caption_raw_en"] + "\n")
                fh.write("Caption (GPT): "
                         + gt.get("caption_raw_en_gpt", "") + "\n")


if __name__ == "__main__":
    main()
