"""LG-VIS mask evaluation over prediction / ground-truth JSONs (copy of
`video_llava_seg_tpu/inference/eval.py` over the port's own RLE decoder,
`ops/masks.decode_rle`; numpy only).

Per-referral spatio-temporal mask IoU (the J / region-similarity measure
averaged over annotated frames) between the serving CLI's prediction
JSONs and ViCaS ground-truth JSONs. A local subset for checking, not
the official ViCaS harness (no caption metrics).

One difference from the JAX module: a prediction's masks are read under
`pred_object_referral_masks` (the ViCaS harness's key, which the JAX
module reads) or, where that key is missing, under `pred_lgvis_masks`
(the key both serving CLIs write). The JAX module scores a CLI JSON as
0 for every referral; on JSONs with the harness's key the two agree.

    python -m video_llava_seg_torch.inference.eval \\
        --pred_dir <pred jsons> --gt_dir <vicas annotation jsons>

prints per-video and mean IoU as one JSON object.
"""

from __future__ import annotations

import copy
import json
import os.path as osp
from argparse import ArgumentParser
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from video_llava_seg_torch.ops.masks import decode_rle

PRED_KEYS = ("pred_object_referral_masks", "pred_lgvis_masks")


def _decode(rle: Dict) -> np.ndarray:
    rle = copy.deepcopy(rle)
    if isinstance(rle["counts"], str):
        rle["counts"] = rle["counts"].encode("utf-8")
    return decode_rle(rle).astype(bool)


def _union_masks(rles: List[Dict]) -> Optional[np.ndarray]:
    out = None
    for r in rles:
        m = _decode(r)
        out = m if out is None else (out | m)
    return out


def referral_iou(pred_frames: List[Dict], gt_content: Dict,
                 track_ids: List[int]) -> float:
    """Mean per-frame IoU of the union-of-objects mask for one referral.

    pred_frames: [{filename, mask_rles}] (prediction schema);
    gt_content: the ViCaS GT json (segmentations: [{filename, track_ids,
    mask_rles}])."""
    gt_seg = {s["filename"]: s for s in gt_content["segmentations"]}
    ious = []
    for pf in pred_frames:
        gt_t = gt_seg.get(pf["filename"])
        if gt_t is None:
            continue
        gt_rles = [r for tid, r in zip(gt_t["track_ids"], gt_t["mask_rles"])
                   if tid in track_ids]
        gt = _union_masks(gt_rles)
        pred = _union_masks(pf["mask_rles"])
        if gt is None and (pred is None or not pred.any()):
            ious.append(1.0)
            continue
        if gt is None or pred is None:
            ious.append(0.0)
            continue
        inter = float(np.logical_and(gt, pred).sum())
        union = float(np.logical_or(gt, pred).sum())
        ious.append(inter / union if union > 0 else 1.0)
    return float(np.mean(ious)) if ious else 0.0


def evaluate_video(pred_content: Dict, gt_content: Dict) -> List[float]:
    """Per-referral IoUs for one video."""
    refs = gt_content["object_referrals"]
    key = next((k for k in PRED_KEYS if k in pred_content), PRED_KEYS[0])
    preds = pred_content.get(key, [])
    out = []
    for i, ref in enumerate(refs):
        if i >= len(preds):
            out.append(0.0)
            continue
        out.append(referral_iou(preds[i], gt_content, ref["track_ids"]))
    return out


def evaluate_dirs(pred_dir: str, gt_dir: str) -> Dict:
    per_video = {}
    all_ious = []
    for f in sorted(glob(osp.join(pred_dir, "*.json"))):
        with open(f) as fh:
            pred = json.load(fh)
        vid = pred["video_id"]
        gt_files = glob(osp.join(gt_dir, f"{vid:06d}*.json"))
        if not gt_files:
            continue
        with open(gt_files[0]) as fh:
            gt = json.load(fh)
        ious = evaluate_video(pred, gt)
        per_video[vid] = float(np.mean(ious)) if ious else 0.0
        all_ious.extend(ious)
    return {
        "num_videos": len(per_video),
        "num_referrals": len(all_ious),
        "mean_iou": float(np.mean(all_ious)) if all_ious else 0.0,
        "per_video_iou": per_video,
    }


def main(args=None):
    p = ArgumentParser()
    p.add_argument("--pred_dir", "-i", required=True)
    p.add_argument("--gt_dir", required=True)
    a = p.parse_args(args)
    print(json.dumps(evaluate_dirs(a.pred_dir, a.gt_dir), indent=2))


if __name__ == "__main__":
    main()
