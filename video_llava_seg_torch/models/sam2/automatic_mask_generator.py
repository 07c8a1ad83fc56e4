"""SAM2AutomaticMaskGenerator: whole-image mask generation (port of
`video_llava_seg_tpu/models/sam2/automatic_mask_generator.py`; the
reference's sam2/automatic_mask_generator.py:36-454): point grids,
crops, IoU and stability filters, NMS, RLE outputs, optional m2m
refinement, small-region post-processing.

A point batch decodes in one mask-decoder call over the image embedding
expanded (not copied) across the batch; on the card its image->token
attention is one K3 launch per two-way block. Each batch's [N, 3, H, W]
fp32 masks come back to the host, as in the JAX package, for the numpy
filters. `generate(image, timings=)` adds the seconds of its stages
(`timing.stage`: set_image, decode, transfer) to a dict."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from video_llava_seg_torch.models.sam2 import amg as amg_utils
from video_llava_seg_torch.models.sam2.amg import (
    MaskData,
    area_from_rle,
    batch_iterator,
    batched_mask_to_box,
    batched_nms,
    box_area,
    box_xyxy_to_xywh,
    build_all_layer_point_grids,
    calculate_stability_score,
    coco_encode_rle,
    generate_crop_boxes,
    is_box_near_crop_edge,
    mask_to_rle,
    rle_to_mask,
    uncrop_boxes_xyxy,
    uncrop_masks,
    uncrop_points,
)
from video_llava_seg_torch.models.sam2.image_predictor import (
    SAM2ImagePredictor,
)
from video_llava_seg_torch.timing import stage


class SAM2AutomaticMaskGenerator:
    def __init__(self, model, points_per_side: Optional[int] = 32,
                 points_per_batch: int = 64, pred_iou_thresh: float = 0.8,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 mask_threshold: float = 0.0, box_nms_thresh: float = 0.7,
                 crop_n_layers: int = 0, crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 point_grids: Optional[List[np.ndarray]] = None,
                 min_mask_region_area: int = 0,
                 output_mode: str = "binary_mask", use_m2m: bool = False,
                 multimask_output: bool = True, device="cuda"):
        """model: a (params, cfg) tuple (a predictor is built on `device`)
        or an existing SAM2ImagePredictor."""
        if (points_per_side is None) == (point_grids is None):
            raise ValueError("Exactly one of points_per_side or point_grid "
                             "must be provided.")
        if points_per_side is not None:
            self.point_grids = build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        else:
            self.point_grids = point_grids
        if output_mode not in ("binary_mask", "uncompressed_rle",
                               "coco_rle"):
            raise ValueError(f"unknown output_mode {output_mode!r}")

        if isinstance(model, SAM2ImagePredictor):
            self.predictor = model
        else:
            params, cfg = model
            self.predictor = SAM2ImagePredictor(
                params, cfg, max_hole_area=min_mask_region_area,
                max_sprinkle_area=min_mask_region_area, device=device)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.crop_n_points_downscale_factor = crop_n_points_downscale_factor
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.use_m2m = use_m2m
        self.multimask_output = multimask_output
        self._timings: Optional[Dict[str, float]] = None

    @classmethod
    def from_pretrained(cls, model_id: str, checkpoint: Optional[str] = None,
                        **kwargs):
        from video_llava_seg_torch.models.sam2.build import build_sam2

        return cls(build_sam2(model_id, checkpoint,
                              device=kwargs.get("device", "cuda")), **kwargs)

    # ------------------------------------------------------------------

    def generate(self, image: np.ndarray,
                 timings: Optional[Dict[str, float]] = None
                 ) -> List[Dict[str, Any]]:
        """image: [H, W, 3] uint8 RGB -> list of mask records
        (automatic_mask_generator.py:170-223 schema)."""
        self._timings = timings
        mask_data = self._generate_masks(image)
        if self.output_mode == "coco_rle":
            mask_data["segmentations"] = [coco_encode_rle(r)
                                          for r in mask_data["rles"]]
        elif self.output_mode == "binary_mask":
            mask_data["segmentations"] = [rle_to_mask(r)
                                          for r in mask_data["rles"]]
        else:
            mask_data["segmentations"] = mask_data["rles"]

        anns = []
        for idx in range(len(mask_data["segmentations"])):
            anns.append({
                "segmentation": mask_data["segmentations"][idx],
                "area": area_from_rle(mask_data["rles"][idx]),
                "bbox": box_xyxy_to_xywh(mask_data["boxes"][idx]).tolist(),
                "predicted_iou": float(mask_data["iou_preds"][idx]),
                "point_coords": [mask_data["points"][idx].tolist()],
                "stability_score": float(mask_data["stability_score"][idx]),
                "crop_box": box_xyxy_to_xywh(
                    mask_data["crop_boxes"][idx]).tolist(),
            })
        return anns

    def _generate_masks(self, image: np.ndarray) -> MaskData:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio)
        data = MaskData()
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            data.cat(self._process_crop(image, crop_box, layer_idx,
                                        orig_size))
        if len(crop_boxes) > 1:
            scores = 1.0 / box_area(np.asarray(data["crop_boxes"],
                                               np.float32))
            keep = batched_nms(np.asarray(data["boxes"], np.float32), scores,
                               self.crop_nms_thresh)
            data.filter(keep)
        if self.min_mask_region_area > 0:
            data = self.postprocess_small_regions(
                data, self.min_mask_region_area, self.box_nms_thresh)
        return data

    def _process_crop(self, image, crop_box, crop_layer_idx,
                      orig_size) -> MaskData:
        x0, y0, x1, y1 = crop_box
        cropped = image[y0:y1, x0:x1]
        cropped_size = cropped.shape[:2]
        with stage(self._timings, "set_image", self.predictor.device):
            self.predictor.set_image(cropped)
        points_scale = np.array(cropped_size)[None, ::-1]
        points_for_image = self.point_grids[crop_layer_idx] * points_scale

        data = MaskData()
        for (points,) in batch_iterator(self.points_per_batch,
                                        points_for_image):
            data.cat(self._process_batch(points, cropped_size, crop_box,
                                         orig_size, normalize=True))
        self.predictor.reset_predictor()

        keep = batched_nms(np.asarray(data["boxes"], np.float32),
                           np.asarray(data["iou_preds"], np.float32),
                           self.box_nms_thresh)
        data.filter(keep)
        data["boxes"] = uncrop_boxes_xyxy(data["boxes"], crop_box)
        data["points"] = uncrop_points(data["points"], crop_box)
        # [n, 4] also when no mask of the crop survived (the JAX package
        # builds a 1-D empty array there, which the crops' concatenation
        # then refuses)
        data["crop_boxes"] = np.array([crop_box] * len(data["rles"]),
                                      np.float32).reshape(-1, 4)
        return data

    @torch.inference_mode()
    def _decode_points(self, coords_model_frame: np.ndarray,
                       mask_input: Optional[np.ndarray] = None,
                       multimask: bool = True):
        """Batched point decode: N points -> N (masks, ious, low_res)."""
        pred = self.predictor
        dev = pred.device
        n = coords_model_frame.shape[0]
        with stage(self._timings, "decode", dev):
            # each point is its own prompt set: the point, then the pad
            coords = np.zeros((n, 2, 2), np.float32)
            coords[:, 0] = coords_model_frame
            labels = np.full((n, 2), -1, np.int32)
            labels[:, 0] = 1
            feats = pred._features
            image_embed = feats["image_embed"][-1:].expand(
                n, *feats["image_embed"].shape[1:])
            high_res = [f[-1:].expand(n, *f.shape[1:])
                        for f in feats["high_res_feats"]]
            m = None
            if mask_input is not None:
                m = torch.as_tensor(mask_input.transpose(0, 2, 3, 1).copy(),
                                    device=dev)
            low_res, ious = pred._decode(
                image_embed, high_res, torch.as_tensor(coords, device=dev),
                torch.as_tensor(labels, device=dev), m, multimask)
            masks = pred._transforms.postprocess_masks(low_res,
                                                       pred._orig_hw[-1])
        with stage(self._timings, "transfer", dev):
            out = (masks.cpu().numpy(), ious.cpu().numpy(),
                   low_res.cpu().numpy())
        return out

    def _process_batch(self, points, im_size, crop_box, orig_size,
                       normalize=False) -> MaskData:
        orig_h, orig_w = orig_size
        pred = self.predictor
        in_points = pred._transforms.transform_coords(
            np.asarray(points, np.float32), normalize=normalize,
            orig_hw=im_size)
        masks, iou_preds, low_res_masks = self._decode_points(
            in_points, multimask=self.multimask_output)
        m = masks.shape[1]
        data = MaskData(
            masks=masks.reshape(-1, *masks.shape[2:]),
            iou_preds=iou_preds.reshape(-1),
            points=np.repeat(np.asarray(points, np.float32), m, axis=0),
            low_res_masks=low_res_masks.reshape(-1,
                                                *low_res_masks.shape[2:]),
        )

        if not self.use_m2m:
            if self.pred_iou_thresh > 0.0:
                data.filter(data["iou_preds"] > self.pred_iou_thresh)
            data["stability_score"] = calculate_stability_score(
                data["masks"], self.mask_threshold,
                self.stability_score_offset)
            if self.stability_score_thresh > 0.0:
                data.filter(data["stability_score"]
                            >= self.stability_score_thresh)
        else:
            in_pts = pred._transforms.transform_coords(
                data["points"], normalize=normalize, orig_hw=im_size)
            masks2, ious2, _ = self._decode_points(
                in_pts, mask_input=data["low_res_masks"][:, None],
                multimask=False)
            data["masks"] = masks2[:, 0]
            data["iou_preds"] = ious2[:, 0]
            if self.pred_iou_thresh > 0.0:
                data.filter(data["iou_preds"] > self.pred_iou_thresh)
            data["stability_score"] = calculate_stability_score(
                data["masks"], self.mask_threshold,
                self.stability_score_offset)
            if self.stability_score_thresh > 0.0:
                data.filter(data["stability_score"]
                            >= self.stability_score_thresh)

        data["masks"] = data["masks"] > self.mask_threshold
        data["boxes"] = batched_mask_to_box(data["masks"])
        keep = ~is_box_near_crop_edge(data["boxes"], crop_box,
                                      [0, 0, orig_w, orig_h])
        if not np.all(keep):
            data.filter(keep)
        data["masks"] = uncrop_masks(data["masks"], crop_box, orig_h, orig_w)
        data["rles"] = [mask_to_rle(m) for m in data["masks"]]
        del data["masks"]
        return data

    @staticmethod
    def postprocess_small_regions(mask_data: MaskData, min_area: int,
                                  nms_thresh: float) -> MaskData:
        """amg postprocess (automatic_mask_generator.py:387-436)."""
        if len(mask_data["rles"]) == 0:
            return mask_data
        new_masks, scores = [], []
        for rle in mask_data["rles"]:
            mask = rle_to_mask(rle)
            mask, changed = amg_utils.remove_small_regions(mask, min_area,
                                                           "holes")
            unchanged = not changed
            mask, changed = amg_utils.remove_small_regions(mask, min_area,
                                                           "islands")
            unchanged = unchanged and not changed
            new_masks.append(mask)
            scores.append(float(unchanged))
        masks = np.stack(new_masks)
        boxes = batched_mask_to_box(masks)
        keep = batched_nms(boxes.astype(np.float32),
                           np.asarray(scores, np.float32), nms_thresh)
        for i in keep:
            if scores[i] == 0.0:
                mask_data["rles"][i] = mask_to_rle(masks[i])
                mask_data["boxes"][i] = boxes[i]
        mask_data.filter(keep)
        return mask_data
