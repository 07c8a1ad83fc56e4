"""Data-parallel and FSDP training over the mesh's 'data' group, with
or without tensor parallelism over its 'model' group.

`DataParallel` is what the train step and the trainer ask of the mesh.
On a dp x mp mesh its 'data' group is the dp ranks of the rank's model
column (rank = d * mp + m: the ranks with its m); the mp ranks of a data
row hold the same rows and run the LLM split over their 'model' group
(`parallel/tensor_parallel.py`, entered by `tensor_parallel()`):

- the rank's rows of a global batch (`rows`), the batch being
  `per_device_batch_size x dp` as in the JAX CLI;
- sums over the group of the counts that normalize the losses, and of
  the metrics (`all_sum`);
- with `fsdp`, parameters and Adam state sharded at rest by the JAX
  rule (`mesh._partition_spec_for`: the largest divisible dim over
  'data'). A leaf is gathered where it is used, through `_Gather`: one
  all-gather a dtype forward for the leaves gathered together, one
  reduce-scatter (sum) of their gradients backward.
  The LLM gathers one layer at a time inside its block
  (`layer_hook`, run again when a checkpointed block recomputes); the
  towers, projector, seg head, embedding and head gather whole, once a
  step (`gather_tree`);
- `reduce_grads` sums the gradients of the leaves held whole over
  'data' (every leaf without fsdp: one all-reduce a dtype over a flat
  bucket), then the partial gradients over 'model' (`partial`);
- `grad_norm` sums the squares of the shards over the axes that split
  them, each replicated leaf counted once;
- `full_state` / `local_state`: the checkpoint a single process writes
  (global rank 0 writes it) and its cut back into the shards.

Partial gradients. `copy_to_model` sums over 'model' the gradient of
every activation that enters a column-parallel dense, so a leaf held
whole over 'model' (the towers, projector, seg head, norms) gets the
same full gradient on every model rank and is not summed again. A whole
leaf that meets a split one inside one dense gets only its rank's part:
a column-parallel LoRA's `a` (x^T (dy_r b_r^T) over the rank's columns)
and a row-parallel LoRA's `b` ((x_r a_r)^T dy over the rank's rows).
Those, and only those, are summed over 'model'.

Each rank's loss is its share of the global-batch loss (its sums over
the global counts of its data group), so the gradient of the global
loss is the sum of the data ranks' gradients: the reductions sum, they
do not average. The counts and metrics are summed over 'data' only: the
model ranks of a row hold the same rows.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from video_llava_seg_torch.parallel import collectives
from video_llava_seg_torch.parallel.mesh import (
    Mesh,
    Spec,
    gather_leaves,
    local_leaf,
    param_specs,
    shard_params,
)
from video_llava_seg_torch.train.optimizer import _map_with_paths


def _reduce_scatter_flat(grads, shapes, dims, group, n):
    """The group's sum of each full gradient, cut to this rank's shard,
    through one reduce-scatter of the ranks' blocks laid end to end."""
    blocks = torch.stack([torch.cat([
        g.narrow(d, r * shp[d], shp[d]).reshape(-1)
        for g, shp, d in zip(grads, shapes, dims)]) for r in range(n)])
    mine = collectives.reduce_scatter(blocks, group).reshape(-1)
    out, off = [], 0
    for shp in shapes:
        k = math.prod(shp)
        out.append(mine[off:off + k].view(shp))
        off += k
    return out


class _Gather(torch.autograd.Function):
    """Shards -> their full leaves (one all-gather); backward, the full
    gradients' sum over the group -> the shards' gradients (one
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, group, n, dims, *shards):
        ctx.group, ctx.n, ctx.dims = group, n, dims
        ctx.shapes = [tuple(s.shape) for s in shards]
        ctx.like = shards[0].new_empty(())
        return tuple(collectives.all_gather_flat(shards, dims, group))

    @staticmethod
    def backward(ctx, *grads):
        # an output no loss reached has no gradient: zeros of its shape
        grads = [ctx.like.new_zeros(shp[:d] + (ctx.n * shp[d],)
                                    + shp[d + 1:]) if g is None else g
                 for g, shp, d in zip(grads, ctx.shapes, ctx.dims)]
        return (None, None, None) + tuple(_reduce_scatter_flat(
            grads, ctx.shapes, ctx.dims, ctx.group, ctx.n))


def _dim(spec: Spec, axis: str) -> Optional[int]:
    return next((i for i, a in enumerate(spec) if a == axis), None)


class DataParallel:
    """The data axis of `mesh` (see the module docstring)."""

    def __init__(self, mesh: Mesh, fsdp: bool = False):
        self.mesh, self.fsdp = mesh, fsdp
        self.axis, self.model_axis = mesh.axis_names
        self.group = mesh.groups[self.axis]
        self.size = mesh.shape[self.axis]
        self.rank = mesh.coords[self.axis]
        self.model_group = mesh.groups[self.model_axis]
        self.model_size = mesh.shape[self.model_axis]
        self.model_rank = mesh.coords[self.model_axis]
        self.specs: Dict[str, Spec] = {}
        self.partial: Tuple[str, ...] = ()

    @property
    def main(self) -> bool:
        """Global rank 0: the rank that logs and writes."""
        return self.mesh.rank == 0

    def tensor_parallel(self):
        """The context the LLM runs in over this rank's 'model' group (no
        group at mp 1)."""
        from video_llava_seg_torch.parallel.tensor_parallel import (
            tensor_parallel,
        )
        return tensor_parallel(self.model_group, self.model_rank,
                               self.model_size)

    # -- layout --------------------------------------------------------
    def shard(self, params):
        """This rank's tree of a full one (the same tree on a 1 x 1 mesh
        or at dp x 1 without fsdp)."""
        self.specs = param_specs(params, self.mesh, self.fsdp)
        # an adapter's factor held whole beside a split one
        self.partial = tuple(
            p for p, spec in self.specs.items()
            if p.startswith("lora/") and p[-2:] in ("/a", "/b")
            and _dim(spec, self.model_axis) is None
            and _dim(self.specs.get(p[:-1] + ("b" if p[-1] == "a" else "a"),
                                    ()), self.model_axis) is not None)
        return shard_params(params, self.mesh, self.fsdp, self.specs)

    def dim(self, path: str) -> Optional[int]:
        spec = self.specs.get(path)
        return None if spec is None else _dim(spec, self.axis)

    def model_dim(self, path: str) -> Optional[int]:
        spec = self.specs.get(path)
        return None if spec is None else _dim(spec, self.model_axis)

    def rows(self, batch: Dict[str, Any], n: int) -> Dict[str, Any]:
        """Rows [r n, (r + 1) n) of every array of a global batch."""
        lo = self.rank * n
        return {k: v[lo:lo + n] for k, v in batch.items()}

    # -- forward -------------------------------------------------------
    def gather(self, items: List[Tuple[torch.Tensor, int]]
               ) -> List[torch.Tensor]:
        """The full tensors of (shard, dim) pairs: one collective for each
        dtype and for leaves with and without gradients (`_Gather`)."""
        out: List[Optional[torch.Tensor]] = [None] * len(items)
        groups: Dict[Any, List[int]] = {}
        for i, (t, _) in enumerate(items):
            groups.setdefault((t.dtype, t.requires_grad), []).append(i)
        for (_, grad), idx in groups.items():
            shards = [items[i][0] for i in idx]
            dims = [items[i][1] for i in idx]
            if grad and torch.is_grad_enabled():
                full = _Gather.apply(self.group, self.size, dims, *shards)
            else:
                with torch.no_grad():
                    full = collectives.all_gather_flat(
                        [s.detach() for s in shards], dims, self.group)
            for i, f in zip(idx, full):
                out[i] = f
        return out

    def gather_tree(self, tree, prefix: str = "", skip: Tuple[str, ...] = ()):
        """A local subtree at `prefix` with its sharded leaves full (one
        `gather`); leaves under the path prefixes in `skip` stay local."""
        base = tuple(prefix.split("/")) if prefix else ()
        found: List[Tuple[str, torch.Tensor]] = []

        def collect(path, t):
            if (torch.is_tensor(t) and self.dim(path) is not None
                    and not path.startswith(skip)):
                found.append((path, t))

        _map_with_paths(collect, tree, base)
        if self.size == 1 or not found:
            return tree
        full = dict(zip((p for p, _ in found),
                        self.gather([(t, self.dim(p)) for p, t in found])))
        return _map_with_paths(lambda p, t: full.get(p, t), tree, base)

    def layer_hook(self, lora: Optional[Dict], alpha: float):
        """(li, local layer) -> the full layer, its LoRA adapters gathered
        with it and merged (`train.lora.merge`), for `llama.forward`."""
        from video_llava_seg_torch.train import lora as lora_mod

        def hook(li: int, layer):
            if lora is None:
                return self.gather_tree(layer, f"llm/layers/{li}")
            both = self.gather_tree(
                {"llm": {"layers": {str(li): layer}},
                 "lora": {"llm": {"layers": {str(li):
                                             lora["llm"]["layers"][li]}}}})
            return lora_mod.merge(both["llm"]["layers"][str(li)],
                                  both["lora"]["llm"]["layers"][str(li)],
                                  alpha)
        return hook

    # -- backward ------------------------------------------------------
    def all_sum(self, tensors: List[torch.Tensor], model: bool = False
                ) -> List[torch.Tensor]:
        """Each tensor summed over the 'data' group (over 'model' with
        `model`; one flat all-reduce a dtype); the inputs are left as
        they are."""
        group, size = ((self.model_group, self.model_size) if model
                       else (self.group, self.size))
        if size == 1:
            return list(tensors)
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            collectives.all_reduce(flat, "sum", group)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].view_as(tensors[i])
                off += n
        return out

    @torch.no_grad()
    def reduce_grads(self, paths: List[str], params: List[torch.Tensor]):
        """Sum over 'data' the gradients of the trainable leaves held
        whole there (a gathered shard's gradient was summed by its
        reduce-scatter), then over 'model' the partial ones
        (`sum_partial`)."""
        idx = [i for i, p in enumerate(paths) if self.dim(p) is None]
        for i in idx:
            if params[i].grad is None:
                params[i].grad = torch.zeros_like(params[i])
        summed = self.all_sum([params[i].grad for i in idx])
        for i, g in zip(idx, summed):
            params[i].grad = g
        self.sum_partial(paths, params)

    @torch.no_grad()
    def sum_partial(self, paths: List[str], params: List[torch.Tensor]):
        """Sum over 'model' the gradients of the leaves in `partial` (a
        split dense's whole LoRA factor)."""
        idx = [i for i, p in enumerate(paths) if p in self.partial]
        summed = self.all_sum([params[i].grad for i in idx], model=True)
        for i, g in zip(idx, summed):
            params[i].grad = g

    def grad_norm_fn(self, paths: List[str]):
        """global_norm over the full gradients: the squares of each
        shard summed over the axes that split it ('data', then 'model'),
        each leaf replicated over an axis counted once, then added in
        leaf order (on a 1 x 1 mesh exactly `optimizer.global_norm`)."""
        axes = [(False, [i for i, p in enumerate(paths)
                         if self.dim(p) is not None]),
                (True, [i for i, p in enumerate(paths)
                        if self.model_dim(p) is not None])]

        def norm(grads: List[torch.Tensor]) -> torch.Tensor:
            if not grads:
                return torch.zeros(())
            sq = [g.float().square().sum() for g in grads]
            for model, idx in axes:
                if idx and (self.model_size if model else self.size) > 1:
                    red = self.all_sum([torch.stack([sq[i] for i in idx])],
                                       model=model)[0]
                    for j, i in enumerate(idx):
                        sq[i] = red[j]
            return torch.sqrt(torch.stack(sq).sum())
        return norm

    # -- checkpoints ---------------------------------------------------
    def _local(self, path: str, t):
        return local_leaf(path, t, self.mesh, self.specs)

    @torch.no_grad()
    def full_params(self, params):
        """The full tree of the rank's one (collectives: every rank)."""
        return self.full_state(params, None)[0]

    @torch.no_grad()
    def full_state(self, params, opt_sd: Optional[Dict[str, Any]]):
        """(full params, full optimizer state dict): what one process
        would save. Every rank calls it (one gather a dtype)."""
        items: List[Tuple[str, Any]] = []
        _map_with_paths(lambda p, t: items.append((p, t)), params)
        n_params = len(items)
        sd = dict(opt_sd or {})
        adamw, acc = sd.get("adamw"), sd.get("acc")
        keys = []
        if adamw is not None:
            for i, st in adamw["state"].items():
                for k, v in st.items():
                    keys.append((i, k))
                    items.append((sd["paths"][i], v))
        if acc is not None:
            items += list(zip(sd["paths"], acc))
        out = gather_leaves([(p, v.detach() if torch.is_tensor(v) else v)
                             for p, v in items], self.mesh, self.specs)
        it = iter(out[:n_params])
        full = _map_with_paths(lambda p, t: next(it), params)
        if adamw is not None:
            state = {i: dict(st) for i, st in adamw["state"].items()}
            for (i, k), v in zip(keys, out[n_params:]):
                state[i][k] = v
            sd["adamw"] = {**adamw, "state": state}
        if acc is not None:
            sd["acc"] = out[n_params + len(keys):]
        return full, sd

    def local_state(self, full_params, opt_sd: Dict[str, Any]):
        """The inverse of `full_state`: this rank's slices."""
        local = _map_with_paths(self._local, full_params)
        paths = opt_sd["paths"]
        sd = dict(opt_sd)
        if opt_sd.get("adamw") is not None:
            adamw = dict(opt_sd["adamw"])
            adamw["state"] = {
                i: {k: self._local(paths[i], v) for k, v in st.items()}
                for i, st in opt_sd["adamw"]["state"].items()}
            sd["adamw"] = adamw
        if opt_sd.get("acc") is not None:
            sd["acc"] = [self._local(p, a)
                         for p, a in zip(paths, opt_sd["acc"])]
        return local, sd

