"""A ('data', 'model') layout of ranks and the parameter layouts over it
(port of `video_llava_seg_tpu/parallel/mesh.py`).

`create_mesh` lays the world's ranks out as a data x model grid with the
JAX package's checks and makes one process group per row and column.
`_partition_spec_for` is the JAX package's rule, copied: which dim of
each parameter a mesh axis splits. JAX hands the rule to GSPMD; the port
turns it into each rank's own tree:

- `shard_params(params, mesh, fsdp)` -> this rank's local tree, and
  `gather_params(local, mesh, specs)` -> the full tree again (every rank
  takes part in the collectives; `gather_leaves` gathers a list of
  leaves, as `fsdp.DataParallel` does for a checkpoint's parameters and
  optimizer state);
- over 'data' (FSDP) every leaf on its own: the rule's dim is cut into
  `dp` blocks, the rank keeps its block (the packed int4 rows too: the
  gather restores the packed tensor as it was);
- over 'model' (tensor parallelism, serving and training) the LLM
  only, a dense dict at a time, since its scales and bias follow its
  weight: a column-parallel weight (the rule's last dim) takes its
  scale, bias and LoRA `b` columns with it; a row-parallel one (dim -2:
  `wo`, `w_down`) keeps the whole per-column scale and its bias (added
  once after the sum) and its LoRA `a` is cut by rows; its packed int4
  rows are unpacked, cut and packed again into the rank's own "halves"
  layout (`ops/int4.py`: byte row i holds rows i and i + in/2, so a
  block of packed rows is not a block of input rows). In a whole
  model's tree the towers, projector and seg head stay whole;
- on a data x model mesh both: the 'model' block first, then (with
  fsdp) the rule's FSDP part over 'data' on the largest dim left whole.

One layout differs from the rule: `lm_head`. The rule splits its dim 0,
the hidden dim of the [in, out] kernel (its docstring says vocab). The
port splits the vocabulary instead (column-parallel, then an all-gather
of the logits), for serving and for training alike: each rank's logits
are then exactly the one-device columns, with no partial sums and no
activation scale to agree on, the gather moves half the bytes of a sum,
and a gathered checkpoint is the one tree whatever the mesh.

Not ported: `maybe_constrain`, `maybe_constrain_grad`, `with_sharding`
and `named_sharding` (hints to the GSPMD partitioner and workarounds
for it).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from video_llava_seg_torch.parallel import collectives
from video_llava_seg_torch.train.optimizer import _map_with_paths

DATA_AXIS, MODEL_AXIS = "data", "model"
Spec = Tuple[Optional[str], ...]


class Mesh(NamedTuple):
    """dp x mp ranks, rank = d * mp + m. `groups` holds this rank's
    process group along each axis (None in a layout-only mesh and for an
    axis of size 1)."""
    shape: Dict[str, int]
    axis_names: Tuple[str, str]
    rank: int
    groups: Dict[str, Any]

    @property
    def coords(self) -> Dict[str, int]:
        mp = self.shape[self.axis_names[1]]
        return {self.axis_names[0]: self.rank // mp,
                self.axis_names[1]: self.rank % mp}


def mesh_layout(dp: int, mp: int, rank: int = 0,
                axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)
                ) -> Mesh:
    """A mesh without process groups (the rules' shapes, tests)."""
    return Mesh({axis_names[0]: dp, axis_names[1]: mp}, axis_names, rank,
                {axis_names[0]: None, axis_names[1]: None})


def create_mesh(cfg=None, world: Optional[int] = None,
                rank: Optional[int] = None) -> Mesh:
    """The ('data', 'model') mesh of the world's ranks (MeshConfig:
    data_parallel -1 takes every rank model_parallel does not). Every
    rank calls it: each axis group is created collectively."""
    from video_llava_seg_torch.config import MeshConfig

    cfg = cfg or MeshConfig()
    n = collectives.world_size() if world is None else world
    rk = collectives.process_index() if rank is None else rank
    mp = max(1, cfg.model_parallel)
    if n % mp != 0:
        raise ValueError(f"{n} ranks not divisible by model_parallel={mp}")
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"data_parallel({dp}) * model_parallel({mp}) != {n}")
    names = (cfg.data_axis, cfg.model_axis)
    groups: Dict[str, Any] = {names[0]: None, names[1]: None}
    if n > 1 and collectives.is_initialized():
        for d in range(dp):
            ranks = [d * mp + m for m in range(mp)]
            g = dist.new_group(ranks) if mp > 1 else None
            if rk in ranks:
                groups[names[1]] = g
        for m in range(mp):
            ranks = [d * mp + m for d in range(dp)]
            g = dist.new_group(ranks) if dp > 1 else None
            if rk in ranks:
                groups[names[0]] = g
    return Mesh({names[0]: dp, names[1]: mp}, names, rk, groups)


# ---------------------------------------------------------------------------
# Parameter partitioning rule (the JAX package's, copied)
# ---------------------------------------------------------------------------

def _partition_spec_for(path: str, shape: Sequence[int], mesh: Mesh,
                        fsdp: bool) -> Spec:
    """Heuristic TP/FSDP spec from a parameter's path and shape.

    Tensor-parallel rules (megatron-style) for the LLM:
      - attention qkv / mlp up+gate:   shard output dim over 'model'
      - attention out / mlp down:      shard input dim over 'model'
      - embeddings / lm_head:          shard dim 0 over 'model'
    Everything else is replicated over 'model'. With fsdp=True the largest
    remaining dim additionally shards over 'data' (ZeRO-3 equivalent)."""
    model_ax = mesh.axis_names[-1]
    data_ax = mesh.axis_names[0]
    mp = mesh.shape[model_ax]
    ndim = len(shape)
    spec: List[Optional[str]] = [None] * ndim

    def divisible(dim_idx: int, size: int) -> bool:
        return 0 <= dim_idx < ndim and shape[dim_idx] % size == 0

    if mp > 1 and ndim >= 2:
        parts = path.split("/")
        col_markers = ("wq", "wk", "wv", "w_gate", "w_up", "q_proj", "k_proj",
                       "v_proj", "gate_proj", "up_proj")
        row_markers = ("wo", "w_down", "o_proj", "down_proj")
        # exact component match: "patch_embedding" must not hit the vocab
        # rule
        vocab_markers = ("embed_tokens", "lm_head", "embedding")
        if any(m in path for m in col_markers) and divisible(ndim - 1, mp):
            spec[ndim - 1] = model_ax
        elif any(m in path for m in row_markers) and divisible(ndim - 2, mp):
            spec[ndim - 2] = model_ax
        elif (ndim == 2 and any(m in parts for m in vocab_markers)
                and divisible(0, mp)):
            spec[0] = model_ax

    if fsdp:
        return _with_data_axis(tuple(spec), shape, mesh)
    return tuple(spec)


def _with_data_axis(spec: Spec, shape: Sequence[int], mesh: Mesh) -> Spec:
    """The rule's FSDP part: the largest dim `spec` leaves unsplit that
    'data' divides goes over 'data' (small >2-D tensors stay whole)."""
    data_ax = mesh.axis_names[0]
    dp = mesh.shape[data_ax]
    ndim = len(shape)
    out = list(spec)
    size = 1
    for s in shape:
        size *= s
    # conv kernels and other small >2-D tensors stay replicated
    if dp > 1 and (ndim <= 2 or size >= (1 << 22)):
        # shard the largest still-unsharded dim over data
        order = sorted(range(ndim), key=lambda i: -shape[i])
        for i in order:
            if out[i] is None and shape[i] % dp == 0 and shape[i] >= dp:
                out[i] = data_ax
                break
    return tuple(out)


# ---------------------------------------------------------------------------
# The port's layouts: this rank's tree and back
# ---------------------------------------------------------------------------

_WEIGHT_KEYS = ("kernel", "kernel_q", "kernel_qa", "kernel_q4a")


def _weight_key(d: dict) -> Optional[str]:
    # a dense dict's weight (in the `lora` subtree the key holds an adapter)
    return next((k for k in _WEIGHT_KEYS
                 if k in d and torch.is_tensor(d[k])), None)


def _dense_split(path: str, in_dim: int, out_dim: int, mesh: Mesh
                 ) -> Tuple[bool, bool]:
    """(column-parallel, row-parallel) of the dense whose weight is at
    `path`, by the rule."""
    ax = mesh.axis_names[1]
    spec = _partition_spec_for(path, (in_dim, out_dim), mesh, False)
    return spec[-1] == ax, spec[-2] == ax


def model_specs(params, mesh: Mesh, prefix: Tuple[str, ...] = ()
                ) -> Dict[str, Spec]:
    """path -> spec over 'model' of every leaf (the rule's, a dense dict
    at a time; `lm_head` vocab-split). An adapter of the training tree's
    `lora` subtree ({a, b} at its kernel's path) splits with its dense:
    a column-parallel dense's `b` by columns, a row-parallel one's `a` by
    rows; the other factor stays whole."""
    ax = mesh.axis_names[1]
    out: Dict[str, Spec] = {}

    def go(tree, path):
        if isinstance(tree, dict) and set(tree) == {"a", "b"}:
            p = "/".join(path)
            col, row = _dense_split(p, tree["a"].shape[0],
                                    tree["b"].shape[-1], mesh)
            out[p + "/a"] = (ax, None) if row else (None, None)
            out[p + "/b"] = (None, ax) if col else (None, None)
            return
        if isinstance(tree, dict):
            wk = _weight_key(tree)
            if wk is not None:
                w = tree[wk]
                wpath = "/".join(path + (wk,))
                spec = _partition_spec_for(wpath, tuple(w.shape), mesh, False)
                if "lm_head" in path and w.shape[-1] % mesh.shape[ax] == 0:
                    spec = (None, ax)
                col = spec[-1] == ax
                row = len(spec) >= 2 and spec[-2] == ax
                for k, v in tree.items():
                    p = "/".join(path + (k,))
                    if k == wk:
                        out[p] = (None, ax) if col else spec
                    elif k in ("kernel_scale", "bias"):
                        out[p] = (ax,) if col else (None,)
                    elif k == "lora":
                        out[p + "/a"] = (ax, None) if row else (None, None)
                        out[p + "/b"] = (None, ax) if col else (None, None)
                        if "s" in v:
                            out[p + "/s"] = ()
                    else:
                        go(v, path + (k,))
                return
            for k, v in tree.items():
                go(v, path + (str(k),))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                go(v, path + (str(i),))
        else:
            p = "/".join(path)
            out[p] = _partition_spec_for(p, tuple(tree.shape), mesh, False)

    go(params, prefix)
    return out


def param_specs(params, mesh: Mesh, fsdp: bool = False) -> Dict[str, Spec]:
    """path -> spec of every leaf. Over 'model' `model_specs` cuts first;
    then, with fsdp, the rule's FSDP part puts the largest dim left whole
    that 'data' divides over 'data', so a leaf can be split on both axes.
    Without a 'model' axis this is the rule leaf by leaf."""
    mp = mesh.shape[mesh.axis_names[1]]
    model: Dict[str, Spec] = {}
    if mp > 1 and "llm" in params:
        # a whole model's tree: the LLM and its adapters split, the
        # towers, projector and seg head whole on every model rank
        model = model_specs(params["llm"], mesh, ("llm",))
        lora = (params.get("lora") or {}).get("llm")
        if lora is not None:
            model.update(model_specs(lora, mesh, ("lora", "llm")))
    elif mp > 1:
        model = model_specs(params, mesh)
    specs: Dict[str, Spec] = {}

    def f(path, leaf):
        if not (torch.is_tensor(leaf) and leaf.dim()):
            specs[path] = ()
        elif mp == 1:
            specs[path] = _partition_spec_for(path, tuple(leaf.shape), mesh,
                                              fsdp)
        else:
            spec = model.get(path, (None,) * leaf.dim())
            specs[path] = (_with_data_axis(spec, tuple(leaf.shape), mesh)
                           if fsdp else spec)
    _map_with_paths(f, params)
    return specs


def _halves_rows(packed: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Input rows [lo, hi) of a "halves"-packed [in/2, out] kernel, packed
    again into their own halves layout."""
    from video_llava_seg_torch.ops.int4 import pack_int4, unpack_int4

    low, high = unpack_int4(packed)
    return pack_int4(torch.cat([low, high], 0)[lo:hi])


def _splits(path: str, t, mesh: Mesh, specs: Dict[str, Spec]
            ) -> List[Tuple[int, str]]:
    """The (dim, axis) pairs that split leaf `t` at `path`, 'model' first
    (its cut is taken first, its gather last); none for a non-tensor, a
    scalar such as Adam's count, or a leaf no axis splits. Optimizer
    state keyed by its parameter's path follows the parameter's spec."""
    spec = specs.get(path)
    if not torch.is_tensor(t) or spec is None or len(spec) != t.dim():
        return []
    order = {mesh.axis_names[1]: 0, mesh.axis_names[0]: 1}
    return sorted(((d, ax) for d, ax in enumerate(spec) if ax is not None),
                  key=lambda s: order[s[1]])


def _int4_rows(path: str, dim: int, ax: str, mesh: Mesh) -> bool:
    # a row-parallel packed int4 kernel: split by input rows, not bytes
    return (ax == mesh.axis_names[1] and path.endswith("kernel_q4a")
            and dim == 0)


def local_leaf(path: str, t, mesh: Mesh, specs: Dict[str, Spec]):
    """This rank's block of a full leaf (a copy), or the leaf itself
    where no axis splits it: its 'model' block, then that block's 'data'
    block."""
    splits = _splits(path, t, mesh, specs)
    if not splits:
        return t
    for dim, ax in splits:
        n, r = mesh.shape[ax], mesh.coords[ax]
        if _int4_rows(path, dim, ax, mesh):
            full = 2 * t.shape[0]
            t = _halves_rows(t, r * full // n, (r + 1) * full // n)
        else:
            size = t.shape[dim] // n
            t = t.narrow(dim, r * size, size)
    return t.clone()


def shard_params(params, mesh: Mesh, fsdp: bool = False,
                 specs: Optional[Dict[str, Spec]] = None):
    """This rank's local tree of a full tree (`param_specs`). Leaves that
    no axis splits are the full tree's own tensors."""
    specs = specs if specs is not None else param_specs(params, mesh, fsdp)
    return _map_with_paths(lambda p, t: local_leaf(p, t, mesh, specs),
                           params)


def gather_leaves(items: List[Tuple[str, Any]], mesh: Mesh,
                  specs: Dict[str, Spec]) -> List[Any]:
    """(path, local value) pairs -> their full values, in order: over
    'data', then over 'model', one all-gather for each dtype, the blocks
    laid end to end (`collectives.all_gather_flat`); a row-parallel int4
    kernel gathers its unpacked rows and is packed again. Every rank
    calls it with the same paths."""
    from video_llava_seg_torch.ops.int4 import pack_int4, unpack_int4

    out = [v for _, v in items]
    for ax in mesh.axis_names:
        todo: Dict[Any, List[Tuple[int, torch.Tensor, int, bool]]] = {}
        for i, (p, _) in enumerate(items):
            split = [s for s in _splits(p, out[i], mesh, specs)
                     if s[1] == ax]
            if not split:
                continue
            (dim, _), = split
            rows = _int4_rows(p, dim, ax, mesh)
            t = torch.cat(unpack_int4(out[i]), 0) if rows else out[i]
            todo.setdefault(t.dtype, []).append((i, t, dim, rows))
        for entries in todo.values():
            full = collectives.all_gather_flat([e[1] for e in entries],
                                               [e[2] for e in entries],
                                               mesh.groups[ax])
            for (i, _, _, rows), f in zip(entries, full):
                out[i] = pack_int4(f) if rows else f
    return out


def gather_params(local, mesh: Mesh, specs: Dict[str, Spec]):
    """The full tree of a local one (the inverse of `shard_params`)."""
    items: List[Tuple[str, Any]] = []
    _map_with_paths(lambda p, t: items.append((p, t)), local)
    full = iter(gather_leaves(items, mesh, specs))
    return _map_with_paths(lambda p, t: next(full), local)
