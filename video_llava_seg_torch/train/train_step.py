"""The training step (port of `video_llava_seg_tpu/train/train_step.py`):
caption CE plus the [SEG] mask loss, backward, trainable-only gradient
norm, optimizer update.

The JAX step is one jitted pure function over an immutable state; the
port updates the parameters in place (`torch.optim`) and returns the
state with its step advanced. A LoRA run merges the adapters into the
base tree each step (`lora.merge`); the quantized base carries no
gradient and stays bit-identical.

Over a data-parallel group (`parallel/fsdp.DataParallel`) each rank
runs its rows of the global batch: the counts that normalize the losses
(the CE's valid tokens, the batch-global mask count) are summed over
the group first, so each rank's loss is its share of the JAX step's
global loss and the gradients sum. With FSDP the LLM's layers are
gathered one at a time inside their blocks and the rest of the tree
once a step. The matcher's point draws come from one generator a sample
(`trainer.RowGenerators`), so a row draws the same on any rank.

On a data x model mesh the step runs, forward and backward, inside the
rank's tensor-parallel context (`DataParallel.tensor_parallel`): the LLM
at its shard (local heads, its MLP and vocabulary columns), the tower,
projector and seg head whole. The model ranks of a row run the same rows
and compute the same loss; the counts are summed over 'data' only.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from video_llava_seg_torch.models import llava
from video_llava_seg_torch.models import seg_head as seg_head_mod
from video_llava_seg_torch.ops.resize import interpolate_hw
from video_llava_seg_torch.timing import stage
from video_llava_seg_torch.train import losses
from video_llava_seg_torch.train.optimizer import (
    Optimizer,
    build_optimizer,
    global_norm,
)


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Optimizer


def create_train_state(params, tcfg):
    """(state, optimizer); the optimizer marks which leaves take grads."""
    tx = build_optimizer(tcfg, params)
    return TrainState(0, params, tx), tx


def batch_to_device(batch: Dict[str, Any], device,
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on `device`: float arrays (video,
    seg frames) in `dtype`, integer arrays as int64, bools as bools."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if t.is_floating_point():
            t = t.to(dtype)
        elif t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device)
    return out


def _pixel_mask(pad, img: int, device):
    ys = torch.arange(img, device=device)
    xs = torch.arange(img, device=device)
    pl, pr, pt, pb = (int(x) for x in pad)
    return (((ys[:, None] >= pt) & (ys[:, None] < img - pb))
            & ((xs[None, :] >= pl) & (xs[None, :] < img - pr)))


def compute_loss(params, cfg, batch: Dict[str, torch.Tensor],
                 generator, remat: bool = False,
                 dice_w=None, ce_w=None,
                 timings: Optional[Dict[str, float]] = None,
                 dp=None, layer_hook=None):
    """Caption CE + optional mask loss for a spliced batch.

    batch keys: video [B, T, H, W, 3], text_ids, gather_idx,
    position_ids, labels; with a seg head also seg_frames [B, Ts, H, W, 3]
    in [0, 1], seg_masks [B, N, Ts, h, w] bool, seg_valid [B, N],
    seg_frame_valid [B, Ts], seg_padding [B, 4], seg_token_pos [B, N]
    (position of each [SEG]'s hidden state) and has_masks [B] (a
    caption-only sample takes the dummy path). generator: the point
    sampling of the Hungarian matcher, one torch.Generator for the batch
    or a callable giving row i's. dp: the data-parallel group
    (`parallel/fsdp.DataParallel`): the loss is then this rank's share of
    the global loss, the metrics the group's. layer_hook: the LLM's
    per-layer gather (`llama.forward`). Returns (loss, metrics)."""
    dev = batch["video"].device
    _, hidden = llava.forward(params, cfg, batch["video"], batch,
                              remat=remat, return_logits=False,
                              timings=timings, layer_hook=layer_hook)
    with stage(timings, "loss_text", dev):
        num_global = None
        if dp is not None:
            num_global = dp.all_sum([(batch["labels"][:, 1:]
                                      != losses.IGNORE_INDEX).sum()
                                     .float()])[0]
        loss_text, num_tok = losses.text_ce_loss_fused(
            params["llm"], cfg.llm, hidden, batch["labels"],
            count=num_global)
    metrics = {"loss_text": loss_text, "num_text_tokens": num_tok}
    total = loss_text

    if "seg_frames" in batch and cfg.seg is not None:
        sam2_cfg = seg_head_mod.make_sam2_cfg(cfg.seg)
        b, ts = batch["seg_frames"].shape[:2]
        img = sam2_cfg.image_size
        with stage(timings, "seg", dev):
            # one flat [B * Ts] Hiera pass and one batched mask decode
            feats, high_res = seg_head_mod.encode_video_frames(
                params["seg_head"], sam2_cfg,
                batch["seg_frames"].reshape(b * ts,
                                            *batch["seg_frames"].shape[2:]))
            feats = feats.reshape(b, ts, *feats.shape[1:])
            high_res = [h.reshape(b, ts, *h.shape[1:]) for h in high_res]
            pos = batch["seg_token_pos"].clamp(min=0).long()
            # one-hot rows pick the [SEG] states: a product, whose backward
            # adds the rows that pick one state (padded slots at 0, objects
            # of one [SEG]) in a fixed order, where gather's backward adds
            # them by atomics on the card, in an order of its own each run
            pick = torch.nn.functional.one_hot(pos, hidden.shape[1])
            seg_tokens = torch.matmul(pick.to(hidden.dtype), hidden)
            low = seg_head_mod.decode_masks_batched(
                params["seg_head"], cfg.seg, sam2_cfg, feats, high_res,
                seg_tokens)                      # [B, N, Q, Ts, s/4, s/4]
        with stage(timings, "loss_mask", dev):
            # the loss is taken at the padded model resolution with the
            # padding masked out of every term; the max over an object's
            # Q queries comes after the upsample (max does not commute
            # with the bilinear resize)
            pred = interpolate_hw(low.float(), (img, img),
                                  "bilinear").amax(dim=2)
            valid = (batch["seg_valid"][:, :, None]
                     & batch["seg_frame_valid"][:, None, :])  # [B, N, Ts]
            n_valid = batch["seg_valid"].float().sum(1)
            dsum, csum, nmask, iou, ntr = [], [], [], [], []
            for i in range(b):
                if bool(batch["has_masks"][i]):
                    out = losses.mask_loss(
                        pred[i], batch["seg_masks"][i], valid_mask=valid[i],
                        generator=(generator(i) if callable(generator)
                                   else generator), dummy=False,
                        pixel_mask=_pixel_mask(batch["seg_padding"][i], img,
                                               dev),
                        dice_weight=dice_w, ce_weight=ce_w)
                    nmask.append(out["num_masks"])
                    iou.append(out["mask_ious"].sum())
                    ntr.append(n_valid[i])
                else:
                    out = losses.mask_loss(pred[i], batch["seg_masks"][i],
                                           valid_mask=valid[i], dummy=True,
                                           align=False)
                dsum.append(out["dice_sum"])
                csum.append(out["ce_sum"])
            zero = pred.new_zeros(())
            # batch-global normalisation: summed dice / BCE over the
            # batch's masks, divided once by their total count
            num_total = torch.stack(nmask).sum() if nmask else zero
            if dp is not None:
                num_total = dp.all_sum([num_total.detach()])[0]
            loss_dice = torch.stack(dsum).sum() / (num_total + 1e-8)
            loss_ce = torch.stack(csum).sum() / (num_total + 1e-8)
            dw = losses.DICE_WEIGHT if dice_w is None else dice_w
            cw = losses.CE_WEIGHT if ce_w is None else ce_w
            loss_mask = loss_dice * dw + loss_ce * cw
        total = total + loss_mask
        metrics.update({
            "loss_mask": loss_mask, "loss_mask_dice": loss_dice,
            "loss_mask_ce": loss_ce,
            "mask_iou_sum": torch.stack(iou).sum() if iou else zero,
            "num_object_tracks": torch.stack(ntr).sum() if ntr else zero,
        })
    metrics["loss"] = total
    if dp is not None:
        # the group's metrics: the losses' shares and the sums add up
        keys = [k for k in metrics if k != "num_text_tokens"]
        summed = dp.all_sum([metrics[k].detach().float() for k in keys])
        metrics = {**dict(zip(keys, summed)),
                   "num_text_tokens": num_global.to(torch.int32)}
    return total, metrics


def make_train_step(cfg, tcfg, tx: Optimizer,
                    timings: Optional[Dict[str, float]] = None, dp=None):
    """step_fn(state, batch, generator) -> (state, metrics): LoRA merge,
    forward, backward, the trainable gradients' global norm, update,
    step + 1. Metrics are detached tensors. timings: optional dict that
    collects per-stage seconds (synchronising at each stage). dp: the
    data-parallel group (`parallel/fsdp.DataParallel`, its tree already
    sharded; with a 'model' axis, tensor-parallel too): the gradients are
    summed over 'data', the partial ones over 'model', and the norm is
    the global one."""
    norm_fn = global_norm if dp is None else dp.grad_norm_fn(tx.paths)
    tx.norm_fn = norm_fn

    def loss_of(params, batch, generator):
        p, hook = params, None
        lora = p.get("lora") if tcfg.lora_enable else None
        if dp is not None and dp.fsdp:
            base = {k: v for k, v in p.items() if k != "lora"}
            p = dp.gather_tree(base, skip=("llm/layers/",))
            hook = dp.layer_hook(lora, tcfg.lora_alpha)
        elif lora is not None:
            from video_llava_seg_torch.train import lora as lora_mod

            base = {k: v for k, v in p.items() if k != "lora"}
            p = lora_mod.merge(base, lora, tcfg.lora_alpha)
        return compute_loss(p, cfg, batch, generator,
                            remat=tcfg.gradient_checkpointing,
                            dice_w=tcfg.mask_dice_weight,
                            ce_w=tcfg.mask_ce_weight, timings=timings,
                            dp=dp, layer_hook=hook)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                generator):
        dev = batch["video"].device
        tx.zero_grad()
        # the backward too: a checkpointed LLM block recomputes inside it
        with contextlib.nullcontext() if dp is None else dp.tensor_parallel():
            loss, metrics = loss_of(state.params, batch, generator)
            with stage(timings, "backward", dev):
                loss.backward()
        with stage(timings, "optimizer", dev):
            if dp is not None:
                dp.reduce_grads(tx.paths, tx.params)
            metrics["grad_norm"] = norm_fn(tx.grads())
            tx.step()
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return state._replace(step=state.step + 1), metrics

    return step_fn
