"""Training losses: masked text CE, dice / BCE mask losses with IoU
logging, and Hungarian matching (port of
`video_llava_seg_tpu/train/losses.py`).

Parity targets as in the JAX package: the reference's mask_loss.py
(scaled dice with scale=1000, sigmoid BCE, weights dice=1.0 ce=2.0,
per-mask IoU, a zero-multiplied dummy path) and hungarian_matcher.py
(point-sampled BCE + dice cost).

Point sampling draws from an explicit `torch.Generator` (the JAX package
uses `jax.random.choice`, whose bits the port cannot reproduce); the
assignment is solved exactly by enumerating the permutations for up to 8
objects (ties go to the first permutation, as `argmin` does) and by
scipy's `linear_sum_assignment` above that.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from video_llava_seg_torch.constants import IGNORE_INDEX
from video_llava_seg_torch.models import llama

DICE_WEIGHT = 1.0
CE_WEIGHT = 2.0
MATCHER_NUM_POINTS = 12544


# ---------------------------------------------------------------------------
# text loss
# ---------------------------------------------------------------------------

def text_ce_loss(logits, labels):
    """Shifted causal LM loss with IGNORE_INDEX masking. logits
    [B, S, V]; labels [B, S]. Returns (loss, num_tokens)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    n = valid.sum().clamp(min=1)
    return nll.sum() / n, valid.sum()


def _chunk_nll(llm_params, llm_cfg, hc, yc, mc):
    logits = llama.unembed(llm_params, llm_cfg, hc).float()   # [chunk, V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc[:, None])[:, 0]
    return ((lse - gold) * mc).sum()


def text_ce_loss_fused(llm_params, llm_cfg, hidden, labels, chunk: int = 512):
    """Chunked fused lm-head + CE, equal to `text_ce_loss(unembed(hidden),
    labels)` without the full fp32 [S, V] logits: each chunk of `chunk`
    tokens is unembedded under `torch.utils.checkpoint`, so one chunk's
    logits live forward and one backward (recomputed from the hidden
    state). hidden [B, S, D] post-norm; labels [B, S]."""
    b, s, d = hidden.shape
    h = hidden[:, :-1].reshape(b * (s - 1), d)
    y = labels[:, 1:].reshape(b * (s - 1))
    valid = y != IGNORE_INDEX
    y_safe = torch.where(valid, y, torch.zeros_like(y)).long()
    mf = valid.float()
    total = hidden.new_zeros((), dtype=torch.float32)
    fn = functools.partial(_chunk_nll, llm_params, llm_cfg)
    for i in range(0, h.shape[0], chunk):
        sl = slice(i, i + chunk)
        total = total + checkpoint(fn, h[sl], y_safe[sl], mf[sl],
                                   use_reentrant=False)
    count = mf.sum()
    return total / count.clamp(min=1.0), count.to(torch.int32)


# ---------------------------------------------------------------------------
# mask losses (mask_loss.py parity)
# ---------------------------------------------------------------------------

def dice_loss_per_mask(inputs, targets, scale: float = 1000.0,
                       eps: float = 1e-6, pixel_mask=None):
    """inputs [M, H, W] logits; targets [M, H, W] in {0, 1} -> [M].
    pixel_mask: optional bool [H, W] restricting the loss to the unpadded
    region."""
    p = torch.sigmoid(inputs.float())
    t = targets.float()
    if pixel_mask is not None:
        pm = pixel_mask.float()[None]
        p = p * pm
        t = t * pm
    p = p.reshape(p.shape[0], -1)
    t = t.reshape(t.shape[0], -1)
    numerator = 2.0 * (p / scale * t).sum(-1)
    denominator = (p / scale).sum(-1) + (t / scale).sum(-1)
    return 1.0 - (numerator + eps) / (denominator + eps)


def sigmoid_ce_loss_per_mask(inputs, targets, pixel_mask=None):
    x = inputs.float()
    t = targets.float()
    # binary_cross_entropy_with_logits, written as the JAX package does
    loss = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    if pixel_mask is None:
        return loss.reshape(loss.shape[0], -1).mean(1)
    pm = pixel_mask.float()[None]
    return (loss * pm).sum((1, 2)) / pm.sum().clamp(min=1.0)


def dice_loss(inputs, targets, num_masks, scale: float = 1000.0,
              eps: float = 1e-6):
    return dice_loss_per_mask(inputs, targets, scale, eps).sum() / (
        num_masks + 1e-8)


def sigmoid_ce_loss(inputs, targets, num_masks):
    return sigmoid_ce_loss_per_mask(inputs, targets).sum() / (
        num_masks + 1e-8)


def mask_iou(pred_masks, gt_masks, pixel_mask=None):
    """[N, T, H, W] logits vs bool -> [N] IoU (compute_iou parity)."""
    p = pred_masks > 0.0
    g = gt_masks.bool()
    if pixel_mask is not None:
        p = p & pixel_mask[None, None]
        g = g & pixel_mask[None, None]
    p = p.reshape(p.shape[0], -1)
    g = g.reshape(g.shape[0], -1)
    inter = (p & g).float().sum(1)
    union = (p | g).float().sum(1)
    return inter / union.clamp(min=1e-4)


# ---------------------------------------------------------------------------
# Hungarian matching (hungarian_matcher.py parity)
# ---------------------------------------------------------------------------

def _pairwise_dice_cost(p, t):
    """p [N, K] sigmoid probs; t [M, K]. Returns [N, M]."""
    numerator = 2.0 * torch.einsum("nk,mk->nm", p, t)
    denom = p.sum(-1)[:, None] + t.sum(-1)[None, :]
    return 1.0 - (numerator + 1.0) / (denom + 1.0)


def _pairwise_bce_cost(logits, t):
    """Mean over points of BCE(pred_n, gt_m)."""
    x = logits
    soft = torch.log1p(torch.exp(-x.abs()))
    pos = torch.clamp(x, min=0) - x + soft          # BCE(t=1)
    neg = torch.clamp(x, min=0) + soft              # BCE(t=0)
    k = x.shape[-1]
    return (torch.einsum("nk,mk->nm", pos, t)
            + torch.einsum("nk,mk->nm", neg, 1.0 - t)) / k


# exact assignment by permutation enumeration up to this many objects
# (8! = 40320 candidate sums); scipy above
ENUM_MAX_N = 8


@functools.lru_cache(maxsize=ENUM_MAX_N)
def _permutations(n: int) -> torch.Tensor:
    # built outside inference mode: a cached inference tensor would reach
    # every later call, autograd-recorded ones too
    with torch.inference_mode(False):
        return torch.tensor(list(itertools.permutations(range(n))),
                            dtype=torch.long)


def solve_assignment(cost: torch.Tensor):
    """Linear sum assignment of a square cost [N, N] ->
    (row idx, col idx) int64 on the CPU."""
    n = cost.shape[0]
    cost = cost.detach().float().cpu()
    if n <= ENUM_MAX_N:
        perms = _permutations(n)
        totals = cost[torch.arange(n)[None, :], perms].sum(1)
        return torch.arange(n), perms[torch.argmin(totals)]
    from scipy.optimize import linear_sum_assignment

    r, c = linear_sum_assignment(cost.double().numpy())
    return torch.from_numpy(r).long(), torch.from_numpy(c).long()


def hungarian_match(pred_masks, gt_masks, generator: torch.Generator,
                    num_points: int = MATCHER_NUM_POINTS, obj_valid=None):
    """Match N predicted mask tracks to N GT tracks by a point-sampled
    BCE + dice cost over the flattened T*H*W volume (shared random
    points, drawn from `generator`). obj_valid: optional bool [N] of real
    (non-padded) slots; valid predictions then match only valid GTs and
    padded slots pair off among themselves at zero cost. Returns
    (pred_idx, gt_idx) int64 of length N on the masks' device."""
    n = pred_masks.shape[0]
    with torch.no_grad():
        flat_p = pred_masks.reshape(n, -1).float()
        flat_g = gt_masks.reshape(n, -1).float()
        total = flat_p.shape[1]
        if num_points >= total:
            sp, sg = flat_p, flat_g
        else:
            idx = torch.randperm(total, generator=generator,
                                 device=generator.device)[:num_points]
            idx = idx.to(flat_p.device)
            sp, sg = flat_p[:, idx], flat_g[:, idx]
        cost = (_pairwise_bce_cost(sp, sg)
                + _pairwise_dice_cost(torch.sigmoid(sp), sg))
        if obj_valid is not None:
            v = obj_valid.bool()
            cross = v[:, None] != v[None, :]
            both_invalid = ~v[:, None] & ~v[None, :]
            cost = torch.where(cross, torch.full_like(cost, 1e9),
                               torch.where(both_invalid,
                                           torch.zeros_like(cost), cost))
    rows, cols = solve_assignment(cost)
    return rows.to(pred_masks.device), cols.to(pred_masks.device)


def mask_loss(pred_masks, gt_masks, valid_mask=None,
              generator: Optional[torch.Generator] = None,
              dummy: bool = False, align: bool = True, pixel_mask=None,
              dice_weight=None, ce_weight=None):
    """MaskLoss for one video (mask_loss.py:20-65 semantics).

    pred_masks [N, T, H, W] logits; gt_masks [N, T, H, W] bool;
    valid_mask: optional bool [N] or [N, T] of real object / frame slots;
    pixel_mask: optional bool [H, W] of the unpadded region; dummy=True
    takes the zero-multiplied path (a caption-only sample still touches
    the seg head's graph). dice_sum / ce_sum are the unnormalised sums a
    batched caller divides once by the batch-global mask count."""
    n = pred_masks.shape[0]
    if align and n > 1 and not dummy:
        if generator is None:
            raise ValueError("mask_loss: matching needs a generator")
        ov = None
        if valid_mask is not None:
            ov = valid_mask if valid_mask.dim() == 1 else valid_mask.any(1)
        pi, gi = hungarian_match(pred_masks, gt_masks, generator,
                                 obj_valid=ov)
        pred_masks = pred_masks[pi]
        gt_masks = gt_masks[gi]
        if valid_mask is not None:
            valid_mask = valid_mask[gi]

    ious = mask_iou(pred_masks, gt_masks, pixel_mask)
    p = pred_masks.reshape(-1, *pred_masks.shape[2:])
    g = gt_masks.reshape(-1, *gt_masks.shape[2:])
    ld_pm = dice_loss_per_mask(p, g, pixel_mask=pixel_mask)
    lc_pm = sigmoid_ce_loss_per_mask(p, g, pixel_mask=pixel_mask)
    if valid_mask is not None:
        if valid_mask.dim() == 1:
            vm = valid_mask.repeat_interleave(pred_masks.shape[1])
        else:
            vm = valid_mask.reshape(-1)
        vm = vm.float()
        ld_pm = ld_pm * vm
        lc_pm = lc_pm * vm
        num_masks = vm.sum()
        obj_valid = valid_mask if valid_mask.dim() == 1 else valid_mask.any(1)
        ious = torch.where(obj_valid, ious, torch.zeros_like(ious))
    else:
        num_masks = torch.tensor(float(p.shape[0]), device=p.device)

    if dummy:
        zero = p.sum() * 0.0
        return {"loss_mask_dice": zero, "loss_mask_ce": zero,
                "loss_mask": zero, "mask_ious": ious * 0.0,
                "num_masks": torch.zeros((), device=p.device),
                "dice_sum": zero, "ce_sum": zero}
    ld = ld_pm.sum() / (num_masks + 1e-8)
    lc = lc_pm.sum() / (num_masks + 1e-8)
    dw = DICE_WEIGHT if dice_weight is None else dice_weight
    cw = CE_WEIGHT if ce_weight is None else ce_weight
    return {"loss_mask_dice": ld, "loss_mask_ce": lc,
            "loss_mask": ld * dw + lc * cw,
            "mask_ious": ious, "num_masks": num_masks,
            "dice_sum": ld_pm.sum(), "ce_sum": lc_pm.sum()}

