"""Optimizer: per-component learning rates, decay / no-decay split, one
global clip and gradient accumulation (port of
`video_llava_seg_tpu/train/optimizer.py`).

The JAX package builds an optax chain (clip_by_global_norm ->
multi_transform of one adamw per {component} x {decay, no-decay}, frozen
components set_to_zero, optionally inside MultiSteps). The port keeps the
same labels and masks path for path and runs `torch.optim.AdamW` with one
param group per trainable label. Frozen leaves get no group, no state and
`requires_grad=False`, so autograd computes no weight gradient for them
(what the JAX step's zeroing of frozen gradients lets XLA dead-code).

Semantics kept from optax, step for step:
- the learning rate of update n (n = 0, 1, ...) is schedule(n): the
  warmup starts at 0, so the first update leaves the weights unchanged;
- clipping scales by max_norm / norm only when norm >= max_norm (no eps);
- accumulation over k micro-steps averages the gradients (optax's running
  mean) and updates on every k-th call; other calls change nothing.
optax's and torch's AdamW order the bias correction and the decoupled
decay differently: equal in exact arithmetic, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch


def leaves_with_paths(tree: Any, path: Tuple[str, ...] = ()
                      ) -> List[Tuple[str, torch.Tensor]]:
    """(path 'a/b/0/kernel', leaf) in tree order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves_with_paths(v, path + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, path + (str(i),))
        return out
    return [("/".join(path), tree)]


def _map_with_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_paths(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def component_of(path: str) -> str:
    if path.startswith("lora"):
        return "lora"
    if path.startswith("seg_head/image_encoder"):
        return "seg_encoder"
    if path.startswith("seg_head"):
        return "seg_decoder"
    if path.startswith("vision_tower"):
        return "vision_tower"
    if path.startswith("mm_projector"):
        return "projector"
    return "llm"


def _no_decay(path: str, leaf) -> bool:
    """Norms, biases and other 1-D leaves skip weight decay."""
    return leaf.dim() <= 1 or "norm" in path or "bias" in path


def param_labels(params):
    return _map_with_paths(
        lambda p, leaf: f"{component_of(p)}/"
                        f"{'nd' if _no_decay(p, leaf) else 'wd'}", params)


def frozen_components(cfg) -> Dict[str, bool]:
    """Components that take no updates (freeze policy; LoRA freezes the
    base LLM)."""
    return {
        "llm": cfg.freeze_llm or cfg.lora_enable,
        "vision_tower": cfg.freeze_vision_tower,
        "projector": cfg.freeze_projector,
        "seg_encoder": cfg.freeze_seg_encoder,
        "seg_decoder": cfg.freeze_seg_decoder,
        "lora": not cfg.lora_enable,
    }


def trainable_mask(cfg, params):
    """Per-leaf bool tree: True where the optimizer updates. Integer
    (quantized) leaves are never trainable."""
    frozen = frozen_components(cfg)
    return _map_with_paths(
        lambda p, leaf: leaf.is_floating_point()
        and not frozen[component_of(p)], params)


def make_schedule(cfg, peak: float) -> Callable[[int], float]:
    """optax's warmup_cosine_decay_schedule(0, peak, warmup, n) or the
    HF 'linear' join, as functions of the update count."""
    n = cfg.num_train_steps
    if n <= 1:
        return lambda count: peak
    warmup = max(1, int(cfg.warmup_ratio * n))
    # keep decay_steps positive on tiny runs (warmup must be < total)
    warmup = min(warmup, max(1, n - 1))
    rest = n - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        c = min(count - warmup, rest)
        if cfg.lr_schedule == "cosine":
            return peak * 0.5 * (1.0 + math.cos(math.pi * c / rest))
        return peak * (1.0 - c / rest)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over tensors, in fp32."""
    sq = [t.float().square().sum() for t in tensors]
    if not sq:
        return torch.zeros(())
    return torch.sqrt(torch.stack(sq).sum())


class Optimizer:
    """AdamW over the trainable leaves of a param tree, with optax's
    schedule, clip and MultiSteps semantics (see the module docstring).
    `step()` consumes the `.grad` of every trainable leaf."""

    def __init__(self, cfg, params):
        self.cfg = cfg
        lrs = {"llm": cfg.lrs.llm, "vision_tower": cfg.lrs.vision_tower,
               "projector": cfg.lrs.projector,
               "seg_encoder": cfg.lrs.seg_encoder,
               "seg_decoder": cfg.lrs.seg_decoder, "lora": cfg.lrs.lora}
        frozen = frozen_components(cfg)
        groups: Dict[str, List[Tuple[str, torch.Tensor]]] = {}
        for path, leaf in leaves_with_paths(params):
            comp = component_of(path)
            train = leaf.is_floating_point() and not frozen[comp]
            if leaf.is_floating_point():
                leaf.requires_grad_(train)
            if train:
                label = f"{comp}/{'nd' if _no_decay(path, leaf) else 'wd'}"
                groups.setdefault(label, []).append((path, leaf))
        # trainable leaves in group order, and their paths
        self.paths = [p for g in groups.values() for p, _ in g]
        self.params = [t for g in groups.values() for _, t in g]
        param_groups = []
        self.schedules = []
        for label, g in groups.items():
            comp, kind = label.split("/")
            param_groups.append({
                "params": [t for _, t in g], "lr": 0.0, "label": label,
                "weight_decay": cfg.lrs.weight_decay if kind == "wd" else 0.0})
            self.schedules.append(make_schedule(cfg, lrs[comp]))
        self.adamw = (torch.optim.AdamW(param_groups, betas=(cfg.adam_b1,
                                                             cfg.adam_b2),
                                        eps=cfg.adam_eps)
                      if param_groups else None)
        self.k = max(1, cfg.gradient_accumulation_steps)
        self.mini_step = 0
        self.updates = 0
        self.acc = ([torch.zeros_like(t) for t in self.params]
                    if self.k > 1 else None)

    def zero_grad(self):
        for t in self.params:
            t.grad = None

    def grads(self) -> List[torch.Tensor]:
        return [t.grad if t.grad is not None else torch.zeros_like(t)
                for t in self.params]

    @torch.no_grad()
    def step(self):
        """One micro-step: accumulate, or clip and update."""
        grads = self.grads()
        if self.k > 1:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.k
            if self.mini_step:
                self.zero_grad()
                return
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        norm = global_norm(grads)
        if norm >= self.cfg.max_grad_norm:
            grads = [g / norm.to(g.dtype) * self.cfg.max_grad_norm
                     for g in grads]
        for t, g in zip(self.params, grads):
            t.grad = g
        if self.adamw is not None:
            for group, sched in zip(self.adamw.param_groups, self.schedules):
                group["lr"] = sched(self.updates)
            self.adamw.step()
        self.updates += 1
        self.zero_grad()

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict() if self.adamw else None,
                "mini_step": self.mini_step, "updates": self.updates,
                "acc": self.acc, "paths": self.paths}

    def load_state_dict(self, sd: Dict[str, Any]):
        if sd["paths"] != self.paths:
            raise ValueError("optimizer state is for other trainable leaves")
        if self.adamw is not None:
            self.adamw.load_state_dict(sd["adamw"])
        self.mini_step, self.updates = sd["mini_step"], sd["updates"]
        if self.acc is not None:
            for a, s in zip(self.acc, sd["acc"]):
                a.copy_(s)


def build_optimizer(cfg, params) -> Optimizer:
    return Optimizer(cfg, params)
