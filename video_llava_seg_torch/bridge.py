"""Carry parameter trees between the JAX package and the port.

Both packages use the same tree layout (same keys, dense kernels
`[in, out]`, conv kernels HWIO), so a tree converts leaf by leaf.
`from_jax` accepts any tree of array-likes (jax arrays or numpy arrays)
and never imports JAX itself.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _map_with_keys(fn, tree, key=None):
    """fn(leaf, key of its innermost dict) over a tree of dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_keys(fn, v, key) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_map_with_keys(fn, v, key) for v in tree)
    return fn(tree, key)


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a tree of dicts, lists and tuples."""
    return _map_with_keys(lambda t, _: fn(t), tree)


# leaves a quantized tree or KV cache keeps in fp32 whatever the compute
# dtype: `nn.dense` reads a bf16 `kernel_scale` as a train-mode tree and
# would take another branch
KEEP_FP32 = ("kernel_scale", "k_scale", "v_scale")


def cast_tree(tree: Any, device, dtype: Optional[torch.dtype] = None) -> Any:
    """Move every leaf to `device`; cast floating leaves to `dtype` when
    it is given, except the scales named in KEEP_FP32. Integer leaves
    (quantized kernels) keep their type."""
    def leaf(t, key):
        if (dtype is not None and t.is_floating_point()
                and key not in KEEP_FP32):
            return t.to(device, dtype)
        return t.to(device)
    return _map_with_keys(leaf, tree)


def from_jax(tree: Any, device="cpu",
             dtype: Optional[torch.dtype] = None) -> Any:
    """Tree of arrays -> tree of tensors on `device`. Floating leaves are
    cast to `dtype` when it is given, except the fp32 scales of quantized
    trees (KEEP_FP32); integer leaves keep their type."""
    def leaf(x):
        a = np.array(x, copy=True)
        bf16 = a.dtype.name == "bfloat16"  # ml_dtypes: no torch mapping
        t = torch.from_numpy(a.astype(np.float32) if bf16 else a)
        return t.to(torch.bfloat16) if bf16 else t
    return cast_tree(tree_map(leaf, tree), device, dtype)


def to_numpy(tree: Any) -> Any:
    """Tree of tensors -> tree of numpy arrays (fp32 for bf16 leaves)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)
