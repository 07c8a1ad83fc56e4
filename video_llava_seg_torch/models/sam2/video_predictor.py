"""SAM2VideoPredictor: streaming multi-object video segmentation (port of
`video_llava_seg_tpu/models/sam2/video_predictor.py`; the reference's
sam2/sam2_video_predictor.py).

The public API and the session state follow the JAX package's (and so
the reference's) interaction semantics: conditioning vs non-conditioning
frames, temporary outputs consolidated across objects, per-object views
of the batched outputs. Propagation is a per-frame eager loop; image
features are encoded in chunks of frames (one batched trunk a chunk,
`precompute_image_features`). Yielded masks stay on the device.

The memory bank holds only valid entries. For a frame it takes the JAX
package's selection: the conditioning frames `_select_closest_cond_frames`
keeps (all of them by default), the num_maskmem - 1 previous frames at
memory_temporal_stride_for_eval (those found among the non-conditioning
outputs or the unselected conditioning ones), and the object pointers of
the selected conditioning frames (only the past ones with
only_obj_ptrs_in_the_past_for_eval) and of up to max_obj_ptrs_in_encoder
- 1 frames before it, with signed temporal positions. The JAX package
lays these out in a fixed-slot bank (the conditioning slots growing in
powers of two) and masks the empty slots inside attention; a masked key
adds exp(MASK_VALUE - max) = 0 exactly to every softmax sum, and RoPE
rotates a memory token by its place in its frame's grid, so a bank of
only the valid slots computes the same function (up to the order of the
sums), with no per-key mask and no fully masked query row: a frame
conditioned on memory always has at least one memory. That is the
reference's variable-length memory list (sam2_base.py:497-674).

On the card (the default) the model runs in bf16: the trunk through
K4's chain, memory attention through K2 at head dim 256, the mask
decoder's image->token attention through K3. On the CPU (`device="cpu"`)
it runs fp32 plain versions. Spatial memories are stored in bf16, as the
JAX package and the reference store them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from video_llava_seg_torch import bridge
from video_llava_seg_torch.data.video_io import (
    AsyncFrameLoader,
    load_video_frames,
)
from video_llava_seg_torch.models.sam2 import base, memory
from video_llava_seg_torch.models.sam2.build import default_dtype
from video_llava_seg_torch.models.sam2.position_encoding import (
    sine_pos_embed_1d,
    sine_pos_embed_on,
)
from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.connected_components import (
    fill_holes_and_sprinkles,
)
from video_llava_seg_torch.ops.resize import interpolate_hw

NO_OBJ_SCORE = base.NO_OBJ_SCORE
COND, NON_COND = "cond_frame_outputs", "non_cond_frame_outputs"


class SAM2VideoPredictor:
    def __init__(self, params, cfg, fill_hole_area: float = 0.0,
                 non_overlap_masks: bool = False,
                 clear_non_cond_mem_around_input: bool = False,
                 clear_non_cond_mem_for_multi_obj: bool = False,
                 add_all_frames_to_correct_as_cond: bool = False,
                 device="cuda", compute_dtype: Optional[torch.dtype] = None):
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype or default_dtype(self.device)
        self.params = bridge.cast_tree(params, self.device,
                                       self.compute_dtype)
        self.cfg = cfg
        self.fill_hole_area = fill_hole_area
        self.non_overlap_masks = non_overlap_masks
        self.clear_non_cond_mem_around_input = clear_non_cond_mem_around_input
        self.clear_non_cond_mem_for_multi_obj = \
            clear_non_cond_mem_for_multi_obj
        self.add_all_frames_to_correct_as_cond = \
            add_all_frames_to_correct_as_cond
        self.image_size = cfg.image_size
        self.hidden_dim = cfg.hidden_dim

    @classmethod
    def from_pretrained(cls, model_id: str, checkpoint: Optional[str] = None,
                        **kwargs) -> "SAM2VideoPredictor":
        """`build.build_sam2_video_predictor`: the video predictor's
        post-processing defaults (build_sam.py:88-102: fill_hole_area
        8)."""
        from video_llava_seg_torch.models.sam2.build import (
            build_sam2_video_predictor,
        )

        return build_sam2_video_predictor(model_id, checkpoint, **kwargs)

    # ------------------------------------------------------------------
    # per-frame compute
    # ------------------------------------------------------------------

    def _encode(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images [B, S, S, 3] normalised -> the three feature levels
        (NHWC, high -> low resolution)."""
        out = base.forward_image(self.params, self.cfg,
                                 images.to(self.device, self.compute_dtype))
        feats, _, _ = base.prepare_backbone_features(self.cfg, out)
        return tuple(feats)

    def _track(self, feats, coords, labels, prev_mask, bank, *,
               multimask: bool, run_mem_encoder: bool, is_pts: bool):
        """One frame for B objects (batched along dim 0): memory
        conditioning (bank = (spatial, pointers) from `_assemble_memory`;
        None on an initial conditioning frame: no_mem_embed added), the
        SAM heads and, with run_mem_encoder, the memory encoder on the
        conditioned features. Returns (low-res masks, high-res masks, obj
        pointers, object scores, conditioned features, memory features
        in bf16 or None)."""
        cfg, p = self.cfg, self.params
        low = feats[-1]
        if bank is None:
            pix = low + p["no_mem_embed"].reshape(1, 1, 1, -1)
        else:
            pix = self._condition_on_memory(low, *bank)
        outs = base.forward_sam_heads(
            p, cfg, pix, point_coords=coords, point_labels=labels,
            mask_inputs=prev_mask, high_res_features=list(feats[:-1]),
            multimask_output=multimask)
        _, _, _, low_res, high_res, obj_ptr, score = outs
        maskmem = None
        if run_mem_encoder and cfg.num_maskmem > 0:
            maskmem = base.encode_new_memory(
                p, cfg, pix, high_res, score,
                is_mask_from_pts=is_pts)[0].to(torch.bfloat16)
        return low_res, high_res, obj_ptr, score, pix, maskmem

    def _condition_on_memory(self, low, spatial, ptrs):
        """Memory attention of the frame's features low [B, h, w, C] over
        the bank's valid entries: spatial, a list of (maskmem_features
        [B, h, w, mem_dim], temporal index into maskmem_tpos_enc); ptrs, a
        list of (obj_ptr [B, C], signed temporal distance). Each pointer
        splits into C / mem_dim tokens, which RoPE leaves unrotated
        (_prepare_memory_conditioned_features, sam2_base.py:497-674)."""
        cfg, p = self.cfg, self.params
        if not spatial and not ptrs:
            raise RuntimeError("a frame conditioned on memory needs at least "
                               "one memory")
        b, h, w, c = low.shape
        hw, mem_dim, dev, dt = h * w, cfg.mem_dim, low.device, low.dtype
        curr = low.reshape(b, hw, c)
        curr_pos = sine_pos_embed_on(h, w, cfg.fpn.pos_num_feats, 10000,
                                     dev, dt).reshape(1, hw, c).expand(
            b, hw, c)
        grid = sine_pos_embed_on(h, w, cfg.memory_encoder.pos_num_feats,
                                 10000, dev, dt).reshape(1, hw, mem_dim)
        tpos_enc = p["maskmem_tpos_enc"][:, 0, 0]          # [maskmem, mem]
        mem = [f.reshape(b, hw, mem_dim).to(dt) for f, _ in spatial]
        mem_pos = [(grid + tpos_enc[t]).expand(b, hw, mem_dim)
                   for _, t in spatial]
        n_ptr_tokens = 0
        if ptrs:
            ratio = c // mem_dim
            tokens = torch.stack([ptr.to(dt) for ptr, _ in ptrs], dim=1)
            n_ptr_tokens = len(ptrs) * ratio
            mem.append(tokens.reshape(b, n_ptr_tokens, mem_dim))
            if cfg.add_tpos_enc_to_obj_ptrs:
                t_diff_max = max(cfg.max_obj_ptrs_in_encoder - 1, 1)
                tpos = torch.tensor([t for _, t in ptrs],
                                    dtype=torch.float32, device=dev)
                tpos_dim = (cfg.hidden_dim if cfg.proj_tpos_enc_in_obj_ptrs
                            else mem_dim)
                obj_pos = sine_pos_embed_1d(tpos / t_diff_max,
                                            tpos_dim).to(dt)
                if cfg.proj_tpos_enc_in_obj_ptrs:
                    obj_pos = nn.dense(p["obj_ptr_tpos_proj"], obj_pos)
            else:
                obj_pos = torch.zeros((len(ptrs), mem_dim), device=dev,
                                      dtype=dt)
            mem_pos.append(obj_pos.repeat_interleave(ratio, dim=0)[None]
                           .expand(b, n_ptr_tokens, mem_dim))
        out = memory.memory_attention_apply(
            p["memory_attention"], cfg, curr, torch.cat(mem, dim=1),
            curr_pos, torch.cat(mem_pos, dim=1),
            num_obj_ptr_tokens=n_ptr_tokens)
        return out.reshape(b, h, w, c)

    def _fill_holes(self, masks: torch.Tensor) -> torch.Tensor:
        """fill_hole_area on low-res logits [B, M, h, w]; a filled hole
        takes 0.1, the reference's small positive value (misc.py:326)."""
        flat = masks.reshape(-1, *masks.shape[2:])
        out = fill_holes_and_sprinkles(flat, 0.0,
                                       max_hole_area=self.fill_hole_area)
        out = torch.where((flat <= 0.0) & (out > 0.0), 0.1, out)
        return out.reshape(masks.shape)

    # ------------------------------------------------------------------
    # session state
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def init_state(self, video_path, offload_video_to_cpu: bool = False,
                   offload_state_to_cpu: bool = False,
                   async_loading_frames: bool = False) -> Dict:
        """Load the frames and build a fresh inference state
        (sam2_video_predictor.py:43-111). video_path: an mp4, a JPEG
        folder or a [T, H, W, 3] uint8 ndarray. Frames live on the device
        in the compute dtype, or on the host with offload_video_to_cpu /
        async_loading_frames (moved a frame at a time)."""
        state: Dict = {}
        if async_loading_frames:
            loader = AsyncFrameLoader(video_path, self.image_size)
            state["images"] = loader
            h, w = loader.video_height, loader.video_width
        else:
            images, h, w = load_video_frames(
                video_path, self.image_size,
                device="cpu" if offload_video_to_cpu else self.device)
            state["images"] = (images if offload_video_to_cpu
                               else images.to(self.compute_dtype))
        state["num_frames"] = len(state["images"])
        state["video_height"], state["video_width"] = h, w
        state["point_inputs_per_obj"] = {}
        state["mask_inputs_per_obj"] = {}
        state["cached_features"] = {}
        state["obj_id_to_idx"] = OrderedDict()
        state["obj_idx_to_id"] = OrderedDict()
        state["obj_ids"] = []
        state["output_dict"] = {COND: {}, NON_COND: {}}
        state["output_dict_per_obj"] = {}
        state["temp_output_dict_per_obj"] = {}
        state["consolidated_frame_inds"] = {COND: set(), NON_COND: set()}
        state["tracking_has_started"] = False
        state["frames_already_tracked"] = {}
        self._get_image_feature(state, 0, 1)
        return state

    def reset_state(self, state) -> None:
        self._reset_tracking_results(state)
        state["obj_id_to_idx"].clear()
        state["obj_idx_to_id"].clear()
        state["obj_ids"] = []
        state["point_inputs_per_obj"].clear()
        state["mask_inputs_per_obj"].clear()
        state["output_dict_per_obj"].clear()
        state["temp_output_dict_per_obj"].clear()

    def _reset_tracking_results(self, state) -> None:
        for v in state["point_inputs_per_obj"].values():
            v.clear()
        for v in state["mask_inputs_per_obj"].values():
            v.clear()
        for d in (list(state["output_dict_per_obj"].values())
                  + list(state["temp_output_dict_per_obj"].values())
                  + [state["output_dict"]]):
            d[COND].clear()
            d[NON_COND].clear()
        state["consolidated_frame_inds"][COND].clear()
        state["consolidated_frame_inds"][NON_COND].clear()
        state["tracking_has_started"] = False
        state["frames_already_tracked"].clear()

    def _obj_id_to_idx(self, state, obj_id) -> int:
        obj_idx = state["obj_id_to_idx"].get(obj_id)
        if obj_idx is not None:
            return obj_idx
        if state["tracking_has_started"]:
            raise RuntimeError(
                f"Cannot add new object id {obj_id} after tracking starts. "
                f"All existing object ids: {state['obj_ids']}. "
                "Please call 'reset_state' to restart from scratch.")
        obj_idx = len(state["obj_id_to_idx"])
        state["obj_id_to_idx"][obj_id] = obj_idx
        state["obj_idx_to_id"][obj_idx] = obj_id
        state["obj_ids"] = list(state["obj_id_to_idx"])
        state["point_inputs_per_obj"][obj_idx] = {}
        state["mask_inputs_per_obj"][obj_idx] = {}
        state["output_dict_per_obj"][obj_idx] = {COND: {}, NON_COND: {}}
        state["temp_output_dict_per_obj"][obj_idx] = {COND: {}, NON_COND: {}}
        return obj_idx

    def _get_obj_num(self, state) -> int:
        return len(state["obj_idx_to_id"])

    def _get_image_feature(self, state, frame_idx: int, batch_size: int):
        """Per-frame feature cache (the reference keeps one frame,
        :879-910; `precompute_image_features` fills it for a whole
        clip), broadcast to batch_size objects."""
        feats = state["cached_features"].get(frame_idx)
        if feats is None:
            feats = self._encode(state["images"][frame_idx][None])
            if not state.get("features_precomputed"):
                state["cached_features"] = {}
            state["cached_features"][frame_idx] = feats
        if batch_size > 1:
            feats = tuple(f.expand(batch_size, *f.shape[1:]) for f in feats)
        return feats

    @torch.inference_mode()
    def precompute_image_features(self, state, chunk_size: int = 8) -> None:
        """Encode every frame not cached yet, chunk_size frames a batched
        trunk: frames have no cross-frame dependency, and one trunk over
        a chunk launches each block's kernels once."""
        imgs, cache = state["images"], state["cached_features"]
        todo = [i for i in range(state["num_frames"]) if i not in cache]
        for s in range(0, len(todo), chunk_size):
            idxs = todo[s:s + chunk_size]
            if isinstance(imgs, torch.Tensor):
                batch = imgs[torch.as_tensor(idxs, device=imgs.device)]
            else:
                batch = torch.stack([imgs[i] for i in idxs])
            feats = self._encode(batch)
            for j, fi in enumerate(idxs):
                cache[fi] = tuple(f[j:j + 1] for f in feats)
        state["features_precomputed"] = True

    # ------------------------------------------------------------------
    # the memory bank
    # ------------------------------------------------------------------

    @staticmethod
    def _select_closest_cond_frames(frame_idx, cond_outputs, limit):
        """select_closest_cond_frames (sam2_utils.py:19-61): up to `limit`
        conditioning frames, the closest before and after frame_idx
        first. Returns (selected, unselected) dicts."""
        if limit == -1 or len(cond_outputs) <= limit:
            return dict(cond_outputs), {}
        if limit < 2:
            raise ValueError("max_cond_frames_in_attn must be -1 or >= 2")
        selected = {}
        before = max((t for t in cond_outputs if t < frame_idx), default=None)
        if before is not None:
            selected[before] = cond_outputs[before]
        after = min((t for t in cond_outputs if t >= frame_idx), default=None)
        if after is not None:
            selected[after] = cond_outputs[after]
        rest = sorted((t for t in cond_outputs if t not in selected),
                      key=lambda x: abs(x - frame_idx))[:limit - len(selected)]
        selected.update((t, cond_outputs[t]) for t in rest)
        unselected = {t: v for t, v in cond_outputs.items()
                      if t not in selected}
        return selected, unselected

    def _assemble_memory(self, state, output_dict, frame_idx: int,
                         track_in_reverse: bool):
        """The bank of frame frame_idx: (spatial, pointers) as
        `_condition_on_memory` takes them, valid entries only, in the JAX
        package's slot order (conditioning frames, then previous frames
        t_pos 1..num_maskmem - 1; conditioning pointers, then previous
        frames' pointers)."""
        cfg = self.cfg
        cond_outputs = output_dict[COND]
        limit = (len(cond_outputs) if cfg.max_cond_frames_in_attn == -1
                 else cfg.max_cond_frames_in_attn)
        selected, unselected = self._select_closest_cond_frames(
            frame_idx, cond_outputs, limit)

        # conditioning frames at t_pos 0, then previous frames at t_pos
        # 1..num_maskmem - 1 with temporal stride r (sam2_base:522-568)
        t_pos_and_prevs = [(0, out) for out in selected.values()]
        stride = max(cfg.memory_temporal_stride_for_eval, 1)
        for t_pos in range(1, cfg.num_maskmem):
            t_rel = cfg.num_maskmem - t_pos
            if t_rel == 1:
                prev = frame_idx + 1 if track_in_reverse else frame_idx - 1
            elif not track_in_reverse:
                prev = ((frame_idx - 2) // stride) * stride
                prev = prev - (t_rel - 2) * stride
            else:
                prev = -(-(frame_idx + 2) // stride) * stride
                prev = prev + (t_rel - 2) * stride
            out = output_dict[NON_COND].get(prev)
            if out is None:
                out = unselected.get(prev)
            t_pos_and_prevs.append((t_pos, out))
        spatial = [(out["maskmem_features"], cfg.num_maskmem - t_pos - 1)
                   for t_pos, out in t_pos_and_prevs if out is not None]

        ptrs = []
        if cfg.use_obj_ptrs_in_encoder:
            max_ptrs = min(state["num_frames"], cfg.max_obj_ptrs_in_encoder)
            sign = -1 if track_in_reverse else 1
            if cfg.only_obj_ptrs_in_the_past_for_eval:
                ptr_cond = {t: out for t, out in selected.items()
                            if (t >= frame_idx if track_in_reverse
                                else t <= frame_idx)}
            else:
                ptr_cond = selected
            ptrs = [(out["obj_ptr"],
                     (frame_idx - t) * sign
                     if cfg.use_signed_tpos_enc_to_obj_ptrs
                     else abs(frame_idx - t))
                    for t, out in ptr_cond.items()]
            for t_diff in range(1, max_ptrs):
                t = (frame_idx + t_diff if track_in_reverse
                     else frame_idx - t_diff)
                if t < 0 or t >= state["num_frames"]:
                    break
                out = output_dict[NON_COND].get(t, unselected.get(t))
                if out is not None:
                    ptrs.append((out["obj_ptr"], t_diff))
            ptrs = ptrs[:cfg.max_obj_ptrs_in_encoder]
        return spatial, ptrs

    # ------------------------------------------------------------------
    # one frame
    # ------------------------------------------------------------------

    def _use_multimask(self, is_init_cond_frame: bool, point_inputs) -> bool:
        cfg = self.cfg
        num_pts = (0 if point_inputs is None
                   else point_inputs["point_labels"].shape[1])
        return (cfg.multimask_output_in_sam
                and (is_init_cond_frame or cfg.multimask_output_for_tracking)
                and (cfg.multimask_min_pt_num <= num_pts
                     <= cfg.multimask_max_pt_num))

    def _run_single_frame_inference(self, state, output_dict, frame_idx,
                                    batch_size, is_init_cond_frame,
                                    point_inputs, mask_inputs, reverse,
                                    run_mem_encoder,
                                    prev_sam_mask_logits=None):
        """The reference's :912-978: one frame's outputs (a dict) and its
        low-res masks."""
        cfg, dev = self.cfg, self.device
        feats = self._get_image_feature(state, frame_idx, batch_size)
        if point_inputs is not None and mask_inputs is not None:
            raise ValueError("points and a mask on one frame")
        maskmem = None
        if mask_inputs is not None and cfg.use_mask_input_as_output_without_sam:
            outs = base.use_mask_as_output(self.params, cfg, feats[-1],
                                           list(feats[:-1]), mask_inputs)
            low_res, high_res, obj_ptr, score = outs[3:]
            pix = feats[-1]
        else:
            bank = (None if is_init_cond_frame else self._assemble_memory(
                state, output_dict, frame_idx, reverse))
            coords = labels = prev_mask = None
            if point_inputs is not None:
                coords = torch.as_tensor(point_inputs["point_coords"],
                                         device=dev)
                labels = torch.as_tensor(point_inputs["point_labels"],
                                         device=dev)
            if prev_sam_mask_logits is not None:
                prev_mask = prev_sam_mask_logits.permute(0, 2, 3, 1)
            low_res, high_res, obj_ptr, score, pix, maskmem = self._track(
                feats, coords, labels, prev_mask, bank,
                multimask=self._use_multimask(is_init_cond_frame,
                                              point_inputs),
                run_mem_encoder=run_mem_encoder,
                is_pts=point_inputs is not None)
        if self.fill_hole_area > 0:
            low_res = self._fill_holes(low_res)
        current_out = {"maskmem_features": None, "maskmem_pos_enc": None,
                       "pred_masks": low_res, "obj_ptr": obj_ptr,
                       "object_score_logits": score}
        if run_mem_encoder and cfg.num_maskmem > 0:
            if maskmem is None:  # mask-as-output: encode it here
                maskmem = base.encode_new_memory(
                    self.params, cfg, pix, high_res, score,
                    is_mask_from_pts=point_inputs is not None)[0].to(
                    torch.bfloat16)
            current_out["maskmem_features"] = maskmem
        return current_out, low_res

    def _run_memory_encoder(self, state, frame_idx, batch_size,
                            high_res_masks, object_score_logits,
                            is_mask_from_pts):
        feats = self._get_image_feature(state, frame_idx, batch_size)
        return base.encode_new_memory(
            self.params, self.cfg, feats[-1], high_res_masks,
            object_score_logits, is_mask_from_pts=is_mask_from_pts)[0].to(
            torch.bfloat16)

    def _get_empty_mask_ptr(self, state, frame_idx):
        """The pointer of an empty mask (the reference's :556-590)."""
        feats = self._get_image_feature(state, frame_idx, 1)
        mask = torch.zeros((1, self.image_size, self.image_size, 1),
                           device=self.device)
        return base.use_mask_as_output(self.params, self.cfg, feats[-1],
                                       list(feats[:-1]), mask)[5]

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _prompt_frame(self, state, frame_idx):
        """(is_init_cond_frame, reverse, is_cond, storage key) of a prompt
        on frame_idx."""
        is_init = frame_idx not in state["frames_already_tracked"]
        reverse = (False if is_init else
                   state["frames_already_tracked"][frame_idx]["reverse"])
        is_cond = is_init or self.add_all_frames_to_correct_as_cond
        return is_init, reverse, is_cond, COND if is_cond else NON_COND

    def _prompt_output(self, state, frame_idx, is_cond):
        consolidated = self._consolidate_temp_output_across_obj(
            state, frame_idx, is_cond=is_cond, run_mem_encoder=False,
            consolidate_at_video_res=True)
        return (frame_idx, state["obj_ids"],
                self._video_res(state, consolidated["pred_masks_video_res"]))

    @torch.inference_mode()
    def add_new_points_or_box(self, state, frame_idx, obj_id, points=None,
                              labels=None, clear_old_points=True,
                              normalize_coords=True, box=None):
        """The reference's :173-314. Returns (frame_idx, obj_ids,
        video-resolution mask logits [B, 1, H, W] on the device)."""
        obj_idx = self._obj_id_to_idx(state, obj_id)
        point_inputs_per_frame = state["point_inputs_per_obj"][obj_idx]
        if (points is not None) != (labels is not None):
            raise ValueError("points and labels must be provided together")
        if points is None and box is None:
            raise ValueError(
                "at least one of points or box must be provided as input")
        points = (np.zeros((0, 2), np.float32) if points is None
                  else np.asarray(points, np.float32))
        labels = (np.zeros((0,), np.int32) if labels is None
                  else np.asarray(labels, np.int32))
        if points.ndim == 2:
            points = points[None]
        if labels.ndim == 1:
            labels = labels[None]
        if box is not None:
            if not clear_old_points:
                raise ValueError(
                    "cannot add box without clearing old points")
            box = np.asarray(box, np.float32).reshape(1, 2, 2)
            points = np.concatenate([box, points], axis=1)
            labels = np.concatenate([np.asarray([[2, 3]], np.int32), labels],
                                    axis=1)
        if normalize_coords:
            points = points / np.asarray(
                [state["video_width"], state["video_height"]], np.float32)
        points = points * self.image_size
        if not clear_old_points:
            old = point_inputs_per_frame.get(frame_idx)
            if old is not None:
                points = np.concatenate([old["point_coords"], points], axis=1)
                labels = np.concatenate([old["point_labels"], labels], axis=1)
        point_inputs = {"point_coords": points, "point_labels": labels}
        point_inputs_per_frame[frame_idx] = point_inputs
        state["mask_inputs_per_obj"][obj_idx].pop(frame_idx, None)

        is_init, reverse, is_cond, key = self._prompt_frame(state, frame_idx)
        obj_output_dict = state["output_dict_per_obj"][obj_idx]
        obj_temp = state["temp_output_dict_per_obj"][obj_idx]
        prev_out = obj_temp[key].get(frame_idx)
        if prev_out is None:
            prev_out = obj_output_dict[COND].get(frame_idx)
        if prev_out is None:
            prev_out = obj_output_dict[NON_COND].get(frame_idx)
        prev_logits = None
        if prev_out is not None and prev_out["pred_masks"] is not None:
            prev_logits = prev_out["pred_masks"].to(self.device).clamp(
                -32.0, 32.0)
        current_out, _ = self._run_single_frame_inference(
            state, obj_output_dict, frame_idx, 1, is_init, point_inputs,
            None, reverse, run_mem_encoder=False,
            prev_sam_mask_logits=prev_logits)
        obj_temp[key][frame_idx] = current_out
        return self._prompt_output(state, frame_idx, is_cond)

    add_new_points = add_new_points_or_box

    @torch.inference_mode()
    def add_new_mask(self, state, frame_idx, obj_id, mask):
        """The reference's :321-402. mask: [H, W] bool / float."""
        obj_idx = self._obj_id_to_idx(state, obj_id)
        mask = torch.as_tensor(np.asarray(mask), device=self.device)
        if mask.dim() != 2:
            raise ValueError("add_new_mask takes one [H, W] mask")
        mask_f = mask.float()[None]                          # [1, H, W]
        s = self.image_size
        if tuple(mask_f.shape[1:]) != (s, s):
            mask_f = (interpolate_hw(mask_f, (s, s), "bilinear",
                                     antialias=True) >= 0.5).float()
        mask_inputs = mask_f[..., None]
        state["mask_inputs_per_obj"][obj_idx][frame_idx] = mask_inputs
        state["point_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        is_init, reverse, is_cond, key = self._prompt_frame(state, frame_idx)
        current_out, _ = self._run_single_frame_inference(
            state, state["output_dict_per_obj"][obj_idx], frame_idx, 1,
            is_init, None, mask_inputs, reverse, run_mem_encoder=False)
        state["temp_output_dict_per_obj"][obj_idx][key][frame_idx] = \
            current_out
        return self._prompt_output(state, frame_idx, is_cond)

    def _video_res(self, state, masks: torch.Tensor) -> torch.Tensor:
        """Mask logits resized to the video's resolution (the reference's
        :1000-1016), non-overlapping if so set; on the device."""
        hw = (state["video_height"], state["video_width"])
        if tuple(masks.shape[-2:]) != hw:
            masks = interpolate_hw(masks.float(), hw, "bilinear")
        if self.non_overlap_masks:
            masks = base.apply_non_overlapping_constraints(masks)
        return masks

    def _consolidate_temp_output_across_obj(self, state, frame_idx, is_cond,
                                            run_mem_encoder,
                                            consolidate_at_video_res=False):
        """The reference's :426-554: every object's output on frame_idx
        (temporary first, then stored) in one batched output; a missing
        object holds NO_OBJ_SCORE logits (and, with run_mem_encoder, the
        pointer of an empty mask)."""
        batch_size = self._get_obj_num(state)
        key = COND if is_cond else NON_COND
        if consolidate_at_video_res:
            if run_mem_encoder:
                raise ValueError("memory encoding needs the low-res masks")
            ch, cw = state["video_height"], state["video_width"]
            mask_key = "pred_masks_video_res"
        else:
            ch = cw = self.image_size // 4
            mask_key = "pred_masks"
        dev, dt = self.device, self.compute_dtype
        consolidated = {
            "maskmem_features": None, "maskmem_pos_enc": None,
            mask_key: torch.full((batch_size, 1, ch, cw), NO_OBJ_SCORE,
                                 device=dev),
            "obj_ptr": torch.full((batch_size, self.hidden_dim),
                                  NO_OBJ_SCORE, device=dev, dtype=dt),
            "object_score_logits": torch.full((batch_size, 1), 10.0,
                                              device=dev),
        }
        empty_mask_ptr = None
        for obj_idx in range(batch_size):
            out = state["temp_output_dict_per_obj"][obj_idx][key].get(
                frame_idx)
            obj_out_dict = state["output_dict_per_obj"][obj_idx]
            if out is None:
                out = obj_out_dict[COND].get(frame_idx)
            if out is None:
                out = obj_out_dict[NON_COND].get(frame_idx)
            if out is None:
                if run_mem_encoder:
                    if empty_mask_ptr is None:
                        empty_mask_ptr = self._get_empty_mask_ptr(state,
                                                                  frame_idx)
                    consolidated["obj_ptr"][obj_idx:obj_idx + 1] = \
                        empty_mask_ptr
                continue
            obj_mask = out["pred_masks"].float()
            if tuple(obj_mask.shape[-2:]) != (ch, cw):
                obj_mask = interpolate_hw(obj_mask, (ch, cw), "bilinear")
            consolidated[mask_key][obj_idx:obj_idx + 1] = obj_mask
            consolidated["obj_ptr"][obj_idx:obj_idx + 1] = out["obj_ptr"]
            consolidated["object_score_logits"][obj_idx:obj_idx + 1] = \
                out["object_score_logits"]
        if run_mem_encoder:
            high_res = interpolate_hw(consolidated["pred_masks"],
                                      (self.image_size, self.image_size),
                                      "bilinear")
            if self.cfg.non_overlap_masks_for_mem_enc:
                high_res = base.apply_non_overlapping_constraints(high_res)
            consolidated["maskmem_features"] = self._run_memory_encoder(
                state, frame_idx, batch_size, high_res,
                consolidated["object_score_logits"], is_mask_from_pts=True)
        return consolidated

    @torch.inference_mode()
    def propagate_in_video_preflight(self, state):
        """The reference's :592-660: consolidate the prompts' temporary
        outputs into the session's outputs, with their memories."""
        state["tracking_has_started"] = True
        batch_size = self._get_obj_num(state)
        temp_per_obj = state["temp_output_dict_per_obj"]
        output_dict = state["output_dict"]
        consolidated_inds = state["consolidated_frame_inds"]
        clear = self._clears_memory(batch_size)
        for is_cond in (False, True):
            key = COND if is_cond else NON_COND
            temp_frame_inds = set()
            for obj_temp in temp_per_obj.values():
                temp_frame_inds.update(obj_temp[key].keys())
            consolidated_inds[key].update(temp_frame_inds)
            for frame_idx in temp_frame_inds:
                consolidated = self._consolidate_temp_output_across_obj(
                    state, frame_idx, is_cond=is_cond, run_mem_encoder=True)
                output_dict[key][frame_idx] = consolidated
                self._add_output_per_object(state, frame_idx, consolidated,
                                            key)
                if clear:
                    self._clear_non_cond_mem_around_input(state, frame_idx)
            for obj_temp in temp_per_obj.values():
                obj_temp[key].clear()
        for frame_idx in output_dict[COND]:
            output_dict[NON_COND].pop(frame_idx, None)
        for obj_out in state["output_dict_per_obj"].values():
            for frame_idx in obj_out[COND]:
                obj_out[NON_COND].pop(frame_idx, None)
        for frame_idx in consolidated_inds[COND]:
            if frame_idx not in output_dict[COND]:
                raise RuntimeError(f"frame {frame_idx} lost its output")
            consolidated_inds[NON_COND].discard(frame_idx)

    def _clears_memory(self, batch_size: int) -> bool:
        return (self.clear_non_cond_mem_around_input
                and (self.clear_non_cond_mem_for_multi_obj
                     or batch_size <= 1))

    @torch.inference_mode()
    def propagate_in_video(self, state, start_frame_idx=None,
                           max_frame_num_to_track=None, reverse=False,
                           precompute_chunk: int = 8):
        """The reference's :662-745: yields (frame_idx, obj_ids,
        video-resolution mask logits [B, 1, H, W]) frame by frame, the
        masks on the device. precompute_chunk > 0 encodes the clip's
        frames up front in chunks of that many (0: one frame at a time,
        as the reference does)."""
        self.propagate_in_video_preflight(state)
        if precompute_chunk:
            self.precompute_image_features(state, precompute_chunk)
        output_dict = state["output_dict"]
        consolidated_inds = state["consolidated_frame_inds"]
        obj_ids = state["obj_ids"]
        num_frames = state["num_frames"]
        batch_size = self._get_obj_num(state)
        if len(output_dict[COND]) == 0:
            raise RuntimeError("No points are provided; please add points "
                               "first")
        clear = self._clears_memory(batch_size)
        if start_frame_idx is None:
            start_frame_idx = min(output_dict[COND])
        if max_frame_num_to_track is None:
            max_frame_num_to_track = num_frames
        if reverse:
            end_frame_idx = max(start_frame_idx - max_frame_num_to_track, 0)
            order = (range(start_frame_idx, end_frame_idx - 1, -1)
                     if start_frame_idx > 0 else [])
        else:
            end_frame_idx = min(start_frame_idx + max_frame_num_to_track,
                                num_frames - 1)
            order = range(start_frame_idx, end_frame_idx + 1)
        for frame_idx in order:
            if frame_idx in consolidated_inds[COND]:
                key = COND
                current_out = output_dict[key][frame_idx]
                pred_masks = current_out["pred_masks"]
                if clear:
                    self._clear_non_cond_mem_around_input(state, frame_idx)
            elif frame_idx in consolidated_inds[NON_COND]:
                key = NON_COND
                current_out = output_dict[key][frame_idx]
                pred_masks = current_out["pred_masks"]
            else:
                key = NON_COND
                current_out, pred_masks = self._run_single_frame_inference(
                    state, output_dict, frame_idx, batch_size,
                    is_init_cond_frame=False, point_inputs=None,
                    mask_inputs=None, reverse=reverse, run_mem_encoder=True)
                output_dict[key][frame_idx] = current_out
            self._add_output_per_object(state, frame_idx, current_out, key)
            state["frames_already_tracked"][frame_idx] = {"reverse": reverse}
            yield frame_idx, obj_ids, self._video_res(state, pred_masks)

    def _add_output_per_object(self, state, frame_idx, current_out, key):
        """Per-object views (slices) of a batched output."""
        maskmem = current_out["maskmem_features"]
        for obj_idx, obj_out_dict in state["output_dict_per_obj"].items():
            sl = slice(obj_idx, obj_idx + 1)
            obj_out_dict[key][frame_idx] = {
                "maskmem_features": (None if maskmem is None
                                     else maskmem[sl]),
                "maskmem_pos_enc": None,
                "pred_masks": current_out["pred_masks"][sl],
                "obj_ptr": current_out["obj_ptr"][sl],
                "object_score_logits":
                    current_out["object_score_logits"][sl],
            }

    @torch.inference_mode()
    def clear_all_prompts_in_frame(self, state, frame_idx, obj_id,
                                   need_output=True):
        """The reference's :776-846, as the JAX package simplifies its
        re-consolidation."""
        obj_idx = self._obj_id_to_idx(state, obj_id)
        state["point_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        state["mask_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        temp = state["temp_output_dict_per_obj"][obj_idx]
        temp[COND].pop(frame_idx, None)
        temp[NON_COND].pop(frame_idx, None)
        batch_size = self._get_obj_num(state)
        frame_has_input = any(
            frame_idx in state["point_inputs_per_obj"][i]
            or frame_idx in state["mask_inputs_per_obj"][i]
            for i in range(batch_size))
        if not frame_has_input:
            output_dict = state["output_dict"]
            state["consolidated_frame_inds"][COND].discard(frame_idx)
            state["consolidated_frame_inds"][NON_COND].discard(frame_idx)
            out = output_dict[COND].pop(frame_idx, None)
            if out is not None:
                output_dict[NON_COND][frame_idx] = out
            for obj_out in state["output_dict_per_obj"].values():
                o = obj_out[COND].pop(frame_idx, None)
                if o is not None:
                    obj_out[NON_COND][frame_idx] = o
        if not need_output:
            return None
        is_cond = any(frame_idx in obj_temp[COND] for obj_temp in
                      state["temp_output_dict_per_obj"].values())
        return self._prompt_output(state, frame_idx, is_cond)

    @torch.inference_mode()
    def remove_object(self, state, obj_id, strict=False, need_output=True):
        """The reference's :1041-1153, as the JAX package slices the
        batched outputs. Returns (obj_ids, updated frame indices)."""
        old_obj_idx = state["obj_id_to_idx"].get(obj_id)
        updated_frames: List[int] = []
        if old_obj_idx is None:
            if strict:
                raise RuntimeError(
                    f"Cannot remove object id {obj_id} as it doesn't exist.")
            return state["obj_ids"], updated_frames
        if len(state["obj_id_to_idx"]) == 1:
            self.reset_state(state)
            return state["obj_ids"], updated_frames
        obj_input_frames = set(state["point_inputs_per_obj"][old_obj_idx]) \
            | set(state["mask_inputs_per_obj"][old_obj_idx])
        for frame_idx in obj_input_frames:
            self.clear_all_prompts_in_frame(state, frame_idx, obj_id,
                                            need_output=False)
        remain = [i for i in range(len(state["obj_id_to_idx"]))
                  if i != old_obj_idx]
        old_to_new = {old: new for new, old in enumerate(remain)}

        def remap(container):
            return {old_to_new[k]: v for k, v in container.items()
                    if k in old_to_new}

        state["obj_id_to_idx"] = OrderedDict(
            (state["obj_idx_to_id"][old], new)
            for old, new in old_to_new.items())
        state["obj_idx_to_id"] = OrderedDict(
            (new, oid) for oid, new in state["obj_id_to_idx"].items())
        state["obj_ids"] = list(state["obj_id_to_idx"])
        for name in ("point_inputs_per_obj", "mask_inputs_per_obj",
                     "output_dict_per_obj", "temp_output_dict_per_obj"):
            state[name] = remap(state[name])
        keep = torch.as_tensor(sorted(old_to_new), device=self.device)
        for frame_outs in (state["output_dict"][COND],
                           state["output_dict"][NON_COND]):
            for frame_idx, out in frame_outs.items():
                for k in ("maskmem_features", "pred_masks", "obj_ptr",
                          "object_score_logits"):
                    if out.get(k) is not None:
                        out[k] = out[k][keep]
                updated_frames.append(frame_idx)
        return state["obj_ids"], sorted(set(updated_frames))

    def _clear_non_cond_mem_around_input(self, state, frame_idx):
        """The reference's :1155+: drop the non-conditioning memories
        within stride x num_maskmem frames of frame_idx."""
        r = self.cfg.memory_temporal_stride_for_eval
        for t in range(frame_idx - r * self.cfg.num_maskmem,
                       frame_idx + r * self.cfg.num_maskmem + 1):
            state["output_dict"][NON_COND].pop(t, None)
            for obj_out in state["output_dict_per_obj"].values():
                obj_out[NON_COND].pop(t, None)
