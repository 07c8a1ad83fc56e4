"""Connected components by min-label propagation (port of
`video_llava_seg_tpu/ops/connected_components.py`).

8-connectivity labels of binary masks and per-pixel component areas,
for SAM2's hole filling / sprinkle removal (the reference's
sam2/utils/transforms.py:76-118, sam2/utils/misc.py:312-338). Every
foreground pixel starts with its flat index + 1; a sweep takes the
minimum over the 8-neighbourhood, hops each label through the pixel it
names (pointer jumping), and does both again. The JAX package loops
until a sweep changes nothing or `max_iters` sweeps ran.

The JAX package runs this in XLA, not Pallas, so the port has no kernel
for it: the same torch code runs on the tensor's device. To keep the
host from waiting on the device after every sweep, the port runs sweeps
in chunks of CHECK_EVERY and tests for the fixpoint once a chunk (on
the chunk's last sweep). A sweep at the fixpoint changes nothing, so the
sweeps a chunk runs past it leave the labels as the JAX loop leaves
them; no chunk runs past `max_iters` sweeps in total.
"""

from __future__ import annotations

import torch

# sweeps between two fixpoint tests (each one waits on the device)
CHECK_EVERY = 8


def _min_neighbor(labels: torch.Tensor, big: int) -> torch.Tensor:
    """Min over the 8-neighbourhood (labels padded with `big` outside)."""
    n, h, w = labels.shape
    p = torch.full((n, h + 2, w + 2), big, dtype=labels.dtype,
                   device=labels.device)
    p[:, 1:-1, 1:-1] = labels
    best = labels
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                best = torch.minimum(
                    best, p[:, 1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx])
    return best


def _jump(labels: torch.Tensor) -> torch.Tensor:
    """Pointer jumping: a label is a flat pixel index + 1; hop to that
    pixel's current label."""
    n, h, w = labels.shape
    flat = labels.reshape(n, h * w)
    idx = torch.clamp(flat - 1, 0, h * w - 1).long()
    hopped = torch.gather(flat, 1, idx)
    hopped = torch.where(flat <= h * w, hopped, flat)
    return torch.minimum(flat, hopped).reshape(n, h, w)


def _sweep(labels, mask, big):
    nxt = torch.where(mask, torch.minimum(labels, _min_neighbor(labels, big)),
                      big)
    nxt = torch.where(mask, _jump(nxt), big)
    nxt = torch.where(mask, torch.minimum(nxt, _min_neighbor(nxt, big)), big)
    return torch.where(mask, _jump(nxt), big)


def connected_components(mask: torch.Tensor, max_iters: int = 256):
    """Label the 8-connected components of binary masks [N, H, W].

    Returns (labels, areas), int32 [N, H, W]: 0 on background; a
    component's id is the flat index of its minimum pixel + 1; areas give
    each foreground pixel its component's pixel count."""
    mask = mask.bool()
    n, h, w = mask.shape
    big = h * w + 2
    flat = torch.arange(1, h * w + 1, dtype=torch.int32,
                        device=mask.device).reshape(1, h, w)
    labels = torch.where(mask, flat, big)
    it = 0
    while it < max_iters:
        chunk = min(CHECK_EVERY, max_iters - it)
        for _ in range(chunk - 1):
            labels = _sweep(labels, mask, big)
        prev = labels
        labels = _sweep(labels, mask, big)
        it += chunk
        if not bool((labels != prev).any()):
            break
    labels = torch.where(mask, labels, 0).to(torch.int32)
    # per-pixel areas: one bincount over all images, image i's ids offset
    # by i * (h * w + 1)
    offset = (torch.arange(n, device=mask.device) * (h * w + 1)).reshape(
        n, 1, 1)
    ids = (labels.long() + offset).reshape(-1)
    counts = torch.bincount(ids, minlength=n * (h * w + 1))
    areas = torch.where(labels > 0, counts[ids].reshape(n, h, w), 0)
    return labels, areas.to(torch.int32)


def fill_holes_and_sprinkles(mask_logits: torch.Tensor,
                             mask_threshold: float = 0.0,
                             max_hole_area: float = 0.0,
                             max_sprinkle_area: float = 0.0,
                             max_iters: int = 256) -> torch.Tensor:
    """SAM2 mask clean-up (the reference's sam2/utils/transforms.py:86-104)
    on [N, H, W] logits: background components of at most max_hole_area
    pixels become mask_threshold + 10 (holes filled), then foreground
    components of at most max_sprinkle_area become mask_threshold - 10
    (sprinkles removed)."""
    out = mask_logits
    if max_hole_area > 0:
        labels, areas = connected_components(out <= mask_threshold,
                                             max_iters)
        is_hole = (labels > 0) & (areas <= max_hole_area)
        out = torch.where(is_hole, mask_threshold + 10.0, out)
    if max_sprinkle_area > 0:
        labels, areas = connected_components(out > mask_threshold,
                                             max_iters)
        is_sprinkle = (labels > 0) & (areas <= max_sprinkle_area)
        out = torch.where(is_sprinkle, mask_threshold - 10.0, out)
    return out
