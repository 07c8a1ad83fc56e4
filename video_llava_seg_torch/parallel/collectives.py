"""Process-group helpers (port of `video_llava_seg_tpu/parallel/
collectives.py`): rank gating, a barrier, object gathers, a dict reduce
for logging, the bring-up, and the tensor collectives the rest of
`parallel/` runs on; among them, as autograd Functions over the 'model'
group, the three a tensor-parallel LLM needs where GSPMD inserts them in
the JAX package (`copy_to_model`, `reduce_from_model`,
`gather_from_model`).

A single process needs no process group: every helper then acts on the
one process (`world_size() == 1`), as the JAX package's do at
`process_count() == 1`.

The tensor collectives take any backend. NCCL runs each as its own
collective. Gloo (the CPU tests, and two ranks sharing one card, which
NCCL refuses) is driven through the ops it has on CUDA tensors too:
`all_reduce` and the list form of `all_gather`. So under gloo
`all_gather_dim` gathers into a list and concatenates, and
`reduce_scatter` is an all-reduce followed by the rank's block: the same
sum at each rank, and the same bits, since every rank adds the same
partials in the same order. (The NCCL forms, `all_gather_into_tensor`
and `reduce_scatter_tensor`, need a card a rank.) `ring_shift` (the ring
attention's K / V rotation) is one `batch_isend_irecv` under NCCL; gloo's
send / recv read and write the tensors' memory as host memory, so under
gloo each hop of a CUDA tensor is staged through a host copy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def process_index(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def print_once(*args, **kwargs) -> None:
    """Print on the main process only."""
    if is_main_process():
        print(*args, **kwargs)


def synchronize() -> None:
    """A barrier over every process; a no-op for one."""
    if world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """A barrier, then leave the process group (a CLI's last step): a
    rank that exits with its gloo group alive can abort in the group's
    teardown ("terminate called without an active exception") while its
    peer still closes the connection."""
    if is_initialized():
        synchronize()
        dist.destroy_process_group()


def all_gather_objects(obj) -> List:
    """Every process's picklable `obj`, in rank order."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def reduce_dict(d: Dict[str, float], average: bool = True
                ) -> Dict[str, float]:
    """Sum (or mean) a dict of scalars over the processes, in float64 on
    the host (for logging)."""
    if world_size() == 1:
        return dict(d)
    keys = sorted(d)
    vec = np.asarray([float(d[k]) for k in keys], np.float64)
    total = np.sum(np.asarray(all_gather_objects(vec)), axis=0)
    if average:
        total = total / world_size()
    return {k: float(v) for k, v in zip(keys, total)}


def initialize_distributed(backend: str = "nccl", device=None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> torch.device:
    """Join the default process group and return this rank's device.

    rank / world size / address come from the arguments or, where they
    are None, from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT). A world of one process joins no group.

    device: "cuda" (each rank takes cuda:LOCAL_RANK), an explicit
    "cuda:i" (ranks told to share a card, as two gloo ranks on one card
    are), or "cpu". A rank whose card does not exist raises: it never
    moves to the CPU and never takes another rank's card."""
    ws = int(world_size if world_size is not None
             else os.environ.get("WORLD_SIZE", 1))
    rk = int(rank if rank is not None else os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", rk))
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rk}: device {dev} asked for, but "
                               "this process sees no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", local)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rk}: {dev} does not exist ({torch.cuda.device_count()}"
                " visible); give one card a rank, or name the card the "
                "ranks share")
        torch.cuda.set_device(dev)
    if ws > 1 and not is_initialized():
        if init_method is None:
            addr = os.environ.get("MASTER_ADDR", "localhost")
            port = os.environ.get("MASTER_PORT", "29500")
            init_method = f"tcp://{addr}:{port}"
        kw = {}
        if backend == "nccl" and dev.type == "cuda":
            kw["device_id"] = dev
        dist.init_process_group(backend, init_method=init_method,
                                world_size=ws, rank=rk, **kw)
    return dev


def _gloo(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def all_reduce(t: torch.Tensor, op: str = "sum", group=None
               ) -> torch.Tensor:
    """In place over the group ("sum" or "max"); returns t."""
    if world_size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)
    return t


def all_gather_dim(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in rank order."""
    n = world_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    if _gloo(group) or dim != 0:
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def all_gather_flat(shards: List[torch.Tensor], dims: List[int],
                    group=None) -> List[torch.Tensor]:
    """Each shard's full tensor along its dim, through one all-gather of
    the shards laid end to end (one dtype)."""
    n = world_size(group)
    if n == 1:
        return list(shards)
    flat = torch.cat([s.reshape(-1) for s in shards])
    every = all_gather_dim(flat, 0, group).view(n, -1)
    out, off = [], 0
    for s, d in zip(shards, dims):
        k = s.numel()
        out.append(torch.cat([every[r, off:off + k].view(s.shape)
                              for r in range(n)], dim=d))
        off += k
    return out


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's 1 / n block along dim 0 of the group's sum of t."""
    n = world_size(group)
    if n == 1:
        return t
    size = t.shape[0] // n
    if _gloo(group):
        s = t.contiguous().clone()
        dist.all_reduce(s, group=group)
        return s[process_index(group) * size:][:size].contiguous()
    out = t.new_empty((size,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def ring_shift(tensors: List[torch.Tensor], group=None
               ) -> List[torch.Tensor]:
    """Send each tensor to the group's next rank (rank + 1) and return
    what the previous rank (rank - 1) sent, in order: new tensors of the
    same shapes, dtypes and devices. One rank returns the tensors."""
    n = world_size(group)
    if n == 1:
        return list(tensors)
    r = process_index(group)
    nxt, prv = ((r + 1) % n, (r - 1) % n)
    if group is not None:
        nxt = dist.get_global_rank(group, nxt)
        prv = dist.get_global_rank(group, prv)
    host = _gloo(group)
    sends = [(t.to("cpu") if host else t).contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, nxt, group, tag=i)
            for i, t in enumerate(sends)]
           + [dist.P2POp(dist.irecv, t, prv, group, tag=i)
              for i, t in enumerate(recvs)])
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [t.to(src.device) for t, src in zip(recvs, tensors)]


# ---------------------------------------------------------------------------
# The collectives GSPMD inserts around a tensor-parallel dense, as autograd
# Functions over the 'model' group (Megatron's f / g and the logits gather)
# ---------------------------------------------------------------------------

def _sum_fp32(t: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of t, added in fp32, in t's dtype (a new tensor)."""
    out = t.to(torch.float32, copy=True)
    all_reduce(out, "sum", group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return None, _sum_fp32(grad, ctx.group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t):
        return _sum_fp32(t, group)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t):
        ctx.group, ctx.n = group, t.shape[-1]
        return all_gather_dim(t, t.dim() - 1, group)

    @staticmethod
    def backward(ctx, grad):
        r = process_index(ctx.group)
        return None, grad.narrow(-1, r * ctx.n, ctx.n).contiguous()


def copy_to_model(t: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward, the gradient summed over the group (the
    input of a column-parallel dense: each rank's columns give a part of
    its gradient)."""
    return _CopyToModel.apply(group, t)


def reduce_from_model(t: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of t (added in fp32) forward; identity backward (a
    row-parallel dense's partial products, the vocabulary-split lookup)."""
    return _ReduceFromModel.apply(group, t)


def gather_from_model(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' last-dim blocks concatenated forward; backward, this
    rank's block of the gradient (the vocabulary-split logits)."""
    return _GatherFromModel.apply(group, t)
