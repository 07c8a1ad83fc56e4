"""Gradients of a fused forward kernel by recompute through its plain
version: the port's counterpart of the JAX package's `custom_vjp`s of
the ViT layer (`vit_block.py::_vl_bwd`) and the Hiera block
(`hiera_block.py::_hb_bwd`), which have no backward kernel either.

The forward launches the kernel chain and saves only the input and the
weights; the backward rebuilds the layer through its plain version under
autograd and returns the vector-Jacobian product. Weights may be fp32
masters while the kernels take bf16: the kernel function casts them for
its launch, the plain recompute casts them as `nn.dense` does, and the
gradients come back in each leaf's own dtype.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def flatten(tree: Any) -> Tuple[List[torch.Tensor], Any]:
    """Leaves of a tree of dicts and lists, and the spec to rebuild it."""
    if isinstance(tree, dict):
        leaves, specs = [], {}
        for key, val in tree.items():
            sub, specs[key] = flatten(val)
            leaves += sub
        return leaves, ("dict", specs)
    if isinstance(tree, list):
        leaves, specs = [], []
        for val in tree:
            sub, spec = flatten(val)
            leaves += sub
            specs.append(spec)
        return leaves, ("list", specs)
    return [tree], None


def unflatten(spec: Any, leaves) -> Any:
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return next(it)
        kind, sub = sp
        if kind == "dict":
            return {k: build(v) for k, v in sub.items()}
        return [build(v) for v in sub]

    return build(spec)


class _Recompute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, kernel_fn, plain_fn, spec, x, *leaves):
        ctx.plain_fn, ctx.spec = plain_fn, spec
        ctx.save_for_backward(x, *leaves)
        return kernel_fn(unflatten(spec, leaves), x)

    @staticmethod
    def backward(ctx, grad):
        x, *leaves = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip([x, *leaves], needs)]
            out = ctx.plain_fn(unflatten(ctx.spec, inputs[1:]), inputs[0])
            wrt = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
        grads = [next(got) if n else None for n in needs]
        return (None, None, None, *grads)


def needs_grad(p: Any, x: torch.Tensor) -> bool:
    """Whether autograd records a call on (p, x)."""
    if not torch.is_grad_enabled():
        return False
    leaves, _ = flatten(p)
    return x.requires_grad or any(t.requires_grad for t in leaves)


def recompute(kernel_fn: Callable, plain_fn: Callable, p: Any,
              x: torch.Tensor) -> torch.Tensor:
    """kernel_fn(p, x) forward; backward = VJP of plain_fn(p, x)."""
    leaves, spec = flatten(p)
    return _Recompute.apply(kernel_fn, plain_fn, spec, x, *leaves)
