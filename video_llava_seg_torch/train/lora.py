"""LoRA adapters as a parallel parameter tree over dense kernels (port of
`video_llava_seg_tpu/train/lora.py`).

The adapter tree mirrors the matched kernel paths, each leaf {"a":
[in, r], "b": [r, out]} (b zero, so the adapter starts as the identity).
`merge` gives the effective parameters each step: a float kernel becomes
base + (alpha / r) a @ b with the base detached; a quantized (QLoRA)
kernel cannot absorb the delta, so the adapter is attached to its dense
dict as {"a", "b", "s"} and `ops.nn.dense` adds ((x @ a) @ b) * s.
`merge_into` bakes the adapters in for export (peft's merge_and_unload).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

# LLM projections eligible for LoRA (the reference targets every Linear of
# the LLM except lm_head): wq/wk/wv/wo = q/k/v/o_proj, w_gate/w_up/w_down
_DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_QV_ONLY_TARGETS = ("wq", "wv")

# quantized kernel leaves (ops/quantization.py, ops/int4.py)
_QKEYS = ("kernel_q", "kernel_qa", "kernel_q4a")


def target_names(qv_proj_only: bool = False) -> Tuple[str, ...]:
    """find_all_linear_names parity (reference train.py:125-141)."""
    return _QV_ONLY_TARGETS if qv_proj_only else _DEFAULT_TARGETS


def _kernel_dims(key: str, leaf) -> Tuple[int, int]:
    """(in_dim, out_dim) of a dense kernel leaf, packed int4 included."""
    if key == "kernel_q4a":                  # nibble-packed [in/2, out]
        return 2 * leaf.shape[0], leaf.shape[1]
    return leaf.shape[0], leaf.shape[1]


def _walk(tree: Any, fn, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            r = _walk(v, fn, path + (str(k),))
            if r is not None:
                out[k] = r
        return out or None
    if isinstance(tree, (list, tuple)):
        out = [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
        return list(out) if any(r is not None for r in out) else None
    return fn(path, tree)


def init_lora(g: torch.Generator, params: Dict, rank: int = 64,
              targets: Optional[Tuple[str, ...]] = None,
              subtree: str = "llm", dtype=torch.float32) -> Dict:
    """Adapters for every matched `{target}/kernel` (or quantized kernel)
    leaf under `subtree`, on that leaf's device: a ~ N(0, 1/rank) drawn
    from `g` in tree order, b = 0."""
    targets = targets or _DEFAULT_TARGETS

    def make(path, leaf):
        if (len(path) < 3 or path[0] != subtree
                or path[-1] not in ("kernel",) + _QKEYS
                or path[-2] not in targets or leaf.dim() != 2):
            return None
        in_dim, out_dim = _kernel_dims(path[-1], leaf)
        a = torch.randn((in_dim, rank), generator=g, device=g.device,
                        dtype=torch.float32) / math.sqrt(rank)
        return {"a": a.to(leaf.device, dtype),
                "b": torch.zeros((rank, out_dim), device=leaf.device,
                                 dtype=dtype)}

    out = _walk(params, make)
    if out is None:
        raise ValueError(f"no LoRA targets matched under '{subtree}'")
    return out


def _is_adapter(x) -> bool:
    return isinstance(x, dict) and set(x) == {"a", "b"}


def merge(params: Dict, lora_params: Optional[Dict], alpha: float = 16.0,
          rank: Optional[int] = None, stop_base_gradient: bool = True):
    """Effective params: base + (alpha / r) a @ b on matched float
    kernels, the adapter attached to quantized ones. With
    stop_base_gradient (training) gradients reach only a and b."""
    if lora_params is None:
        return params

    def go(base, lora):
        if lora is None:
            return base
        if _is_adapter(lora):
            kernel = base.detach() if stop_base_gradient else base
            r = rank if rank is not None else lora["a"].shape[1]
            delta = torch.matmul(lora["a"], lora["b"]) * (alpha / r)
            return kernel + delta.to(kernel.dtype)
        if isinstance(base, dict):
            qkeys = [k for k in _QKEYS
                     if k in base and isinstance(lora, dict)
                     and _is_adapter(lora.get(k))]
            if qkeys:
                (k,) = qkeys
                ad = lora[k]
                r = rank if rank is not None else ad["a"].shape[1]
                out = dict(base)
                if stop_base_gradient:
                    out["kernel_scale"] = out["kernel_scale"].detach()
                out["lora"] = {"a": ad["a"], "b": ad["b"],
                               "s": torch.tensor(alpha / r,
                                                 dtype=torch.float32,
                                                 device=ad["a"].device)}
                return out
            return {k: (go(v, lora.get(k)) if isinstance(lora, dict) else v)
                    for k, v in base.items()}
        if isinstance(base, (list, tuple)):
            return [go(v, lora[i] if lora is not None and lora[i] is not None
                       else None)
                    for i, v in enumerate(base)]
        return base

    return go(params, lora_params)


def merge_into(params: Dict, lora_params: Optional[Dict],
               alpha: float = 16.0) -> Dict:
    """Bake the adapters into the base tree (merge_and_unload), for
    export and inference; quantized kernels keep their adapters attached,
    which `nn.dense` applies, so the tree is self-contained."""
    with torch.no_grad():
        return merge(params, lora_params, alpha, stop_base_gradient=False)
