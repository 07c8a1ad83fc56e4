"""SAM2ImagePredictor (port of
`video_llava_seg_tpu/models/sam2/image_predictor.py`; the reference's
sam2/sam2_image_predictor.py:85-438): `set_image` / `set_image_batch`
encode once, `predict` / `predict_batch` embed prompts and run only the
mask decoder on the cached features.

On the card (the default) the model runs in bf16: the Hiera trunk
through K4's chain, the mask decoder's image->token attention through
K3. On the CPU (`device="cpu"`) it runs in fp32 through the kernels'
plain versions. Prompts keep the reference's single (-1) pad point and
are not padded further: every extra token would take part in the
attention."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from video_llava_seg_torch import bridge
from video_llava_seg_torch.models.sam2 import base, mask_decoder, prompt_encoder
from video_llava_seg_torch.models.sam2.build import default_dtype
from video_llava_seg_torch.models.sam2.transforms import SAM2Transforms


class SAM2ImagePredictor:
    def __init__(self, params, cfg, mask_threshold: float = 0.0,
                 max_hole_area: float = 0.0, max_sprinkle_area: float = 0.0,
                 device="cuda", compute_dtype: Optional[torch.dtype] = None):
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype or default_dtype(self.device)
        self.params = bridge.cast_tree(params, self.device,
                                       self.compute_dtype)
        self.cfg = cfg
        self.mask_threshold = mask_threshold
        self._transforms = SAM2Transforms(
            resolution=cfg.image_size, mask_threshold=mask_threshold,
            max_hole_area=max_hole_area, max_sprinkle_area=max_sprinkle_area)
        self.reset_predictor()

    @classmethod
    def from_pretrained(cls, model_id: str, checkpoint: Optional[str] = None,
                        **kwargs) -> "SAM2ImagePredictor":
        from video_llava_seg_torch.models.sam2.build import build_sam2

        params, cfg = build_sam2(model_id, checkpoint,
                                 device=kwargs.get("device", "cuda"))
        return cls(params, cfg, **kwargs)

    # ------------------------------------------------------------------
    def _encode(self, images: torch.Tensor):
        """images [B, H, W, 3] on the device: raw uint8 frames of any size
        (scaled, resized and normalised here) or normalised floats at the
        model's resolution."""
        res = self.cfg.image_size
        if images.shape[1:3] != (res, res) or images.dtype == torch.uint8:
            images = self._transforms._prep(images)
        out = base.forward_image(self.params, self.cfg,
                                 images.to(self.compute_dtype))
        feats, _, _ = base.prepare_backbone_features(self.cfg, out)
        if self.cfg.directly_add_no_mem_embed:
            low = feats[-1]
            feats = feats[:-1] + [low + self.params["no_mem_embed"].reshape(
                1, 1, 1, -1).to(low.dtype)]
        return {"image_embed": feats[-1], "high_res_feats": feats[:-1]}

    @torch.inference_mode()
    def set_image(self, image) -> None:
        """image: uint8 [H, W, 3] RGB (numpy or PIL)."""
        self.reset_predictor()
        if hasattr(image, "convert") and not isinstance(image, np.ndarray):
            image = image.convert("RGB")
        image = np.asarray(image)
        self._orig_hw = [tuple(image.shape[:2])]
        self._features = self._encode(
            torch.as_tensor(image, device=self.device)[None])
        self._is_image_set = True

    @torch.inference_mode()
    def set_image_batch(self, image_list: List[np.ndarray]) -> None:
        self.reset_predictor()
        self._orig_hw = [tuple(im.shape[:2]) for im in image_list]
        self._features = self._encode(
            self._transforms.forward_batch(image_list, self.device))
        self._is_image_set = True
        self._is_batch = True

    # ------------------------------------------------------------------
    def _decode(self, image_embed, high_res_feats, coords, labels,
                mask_input: Optional[torch.Tensor],
                multimask_output: bool):
        """Prompt encoder + mask decoder. coords [B, P, 2] and labels [B, P]
        in the model frame; mask_input [B, 4h, 4w, 1] logits or None.
        Returns fp32 (low-res mask logits [B, M, 4h, 4w], ious [B, M])."""
        cfg, dt = self.cfg, self.compute_dtype
        pe = self.params["prompt_encoder"]
        sparse, dense = prompt_encoder.apply(
            pe, cfg, coords, labels,
            masks=None if mask_input is None else mask_input.to(dt))
        image_pe = prompt_encoder.get_dense_pe(pe, cfg, self.device)
        low_res, ious, _, _ = mask_decoder.apply(
            self.params["mask_decoder"], cfg, image_embed, image_pe,
            sparse.to(dt), dense.to(dt), multimask_output=multimask_output,
            high_res_features=list(high_res_feats))
        return low_res.float(), ious.float()

    def _prep_prompts(self, point_coords, point_labels, box, mask_input,
                      normalize_coords, img_idx: int):
        orig_hw = self._orig_hw[img_idx]
        pts, lbl = [], []
        if box is not None:
            b = self._transforms.transform_boxes(
                np.asarray(box, np.float32), normalize_coords, orig_hw)
            pts.append(b.reshape(-1, 2))
            lbl.append(np.asarray([2, 3], np.int32))
        if point_coords is not None:
            if point_labels is None:
                raise ValueError("point_labels must accompany point_coords")
            c = self._transforms.transform_coords(
                np.asarray(point_coords, np.float32), normalize_coords,
                orig_hw)
            pts.append(c.reshape(-1, 2))
            lbl.append(np.asarray(point_labels, np.int32).reshape(-1))
        # the reference's pad point (boxes become points here, so always)
        pts.append(np.zeros((1, 2), np.float32))
        lbl.append(np.asarray([-1], np.int32))
        coords = torch.as_tensor(np.concatenate(pts)[None], device=self.device)
        labels = torch.as_tensor(np.concatenate(lbl)[None],
                                 device=self.device)
        m = None
        if mask_input is not None:
            m = np.asarray(mask_input, np.float32)
            if m.ndim == 3:
                m = m[None]
            m = torch.as_tensor(m.transpose(0, 2, 3, 1).copy(),
                                device=self.device)  # NCHW -> NHWC
        return coords, labels, m

    def predict(self, point_coords=None, point_labels=None, box=None,
                mask_input=None, multimask_output: bool = True,
                return_logits: bool = False, normalize_coords: bool = True):
        """Returns (masks [M, H, W] (bool, or fp32 logits with
        return_logits), ious [M], low-res logits [M, 4h, 4w] clipped to
        +-32) as numpy arrays (sam2_image_predictor.py:237-303)."""
        if not self._is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) "
                               "before mask prediction.")
        return self._predict_idx(point_coords, point_labels, box, mask_input,
                                 multimask_output, return_logits,
                                 normalize_coords, img_idx=-1)

    @torch.inference_mode()
    def _predict_idx(self, point_coords, point_labels, box, mask_input,
                     multimask_output, return_logits, normalize_coords,
                     img_idx: int):
        coords, labels, m = self._prep_prompts(
            point_coords, point_labels, box, mask_input, normalize_coords,
            img_idx)
        i = img_idx % len(self._orig_hw)
        low_res, ious = self._decode(
            self._features["image_embed"][i:i + 1],
            [f[i:i + 1] for f in self._features["high_res_feats"]],
            coords, labels, m, multimask_output)
        masks = self._transforms.postprocess_masks(low_res,
                                                   self._orig_hw[img_idx])
        if not return_logits:
            masks = masks > self.mask_threshold
        return (masks[0].cpu().numpy(), ious[0].cpu().numpy(),
                torch.clamp(low_res[0], -32.0, 32.0).cpu().numpy())

    def predict_batch(self, point_coords_batch=None, point_labels_batch=None,
                      box_batch=None, mask_input_batch=None,
                      multimask_output: bool = True,
                      return_logits: bool = False,
                      normalize_coords: bool = True):
        """Per-image prompts against a batch set with set_image_batch."""
        if not self._is_batch:
            raise RuntimeError("predict_batch requires set_image_batch")

        def get(lst, i):
            return None if lst is None else lst[i]

        all_masks, all_ious, all_low = [], [], []
        for i in range(len(self._orig_hw)):
            m, io, lo = self._predict_idx(
                get(point_coords_batch, i), get(point_labels_batch, i),
                get(box_batch, i), get(mask_input_batch, i),
                multimask_output, return_logits, normalize_coords, img_idx=i)
            all_masks.append(m)
            all_ious.append(io)
            all_low.append(lo)
        return all_masks, all_ious, all_low

    def get_image_embedding(self) -> torch.Tensor:
        if not self._is_image_set:
            raise RuntimeError("set_image must be called first")
        return self._features["image_embed"]

    def reset_predictor(self) -> None:
        self._is_image_set = False
        self._features = None
        self._orig_hw: List[Tuple[int, int]] = []
        self._is_batch = False
