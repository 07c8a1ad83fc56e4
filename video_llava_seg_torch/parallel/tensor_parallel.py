"""Tensor parallelism of the LLM, Megatron-style, over the mesh's 'model'
group: serving, and the training forward and backward.

The rank's tree comes from `mesh.shard_params` (column-parallel wq / wk /
wv / w_gate / w_up and the vocabulary-split lm_head; row-parallel wo /
w_down; the vocabulary-split embedding). `models/llama.py` asks
`current()` for the group it runs in (None: one device) and then:

- reshapes q / k / v to its local heads (`local_heads`), keeps only
  those heads' K/V in its cache, and takes the ALiBi slopes of its
  global heads (`alibi_slopes`), never those of its local head count;
- sums each row-parallel dense over the group (`row_parallel_dense`);
- looks tokens up in its rows of the embedding (`embed`) and gathers
  the logits of its vocabulary columns (`gather_logits`);
- passes the input of its column-parallel denses (wq / wk / wv, w_gate /
  w_up, the head) through `column_input`.

The sums and gathers are the autograd Functions of `collectives`
(`copy_to_model`, `reduce_from_model`, `gather_from_model`), so the
training step runs the same code: a column-parallel input's gradient is
summed over the group, a row-parallel output's and the lookup's pass
through, and the logits' gradient is cut back to the rank's columns.
LoRA on a split dense splits with it: a column-parallel dense's `a` is
whole and its `b` cut by columns, a row-parallel dense's `a` cut by rows
and its `b` whole (`mesh.model_specs`); the whole factor of each gets
only its rank's part of its gradient (`fsdp.DataParallel.partial`).

Every rank then holds the same logits, bit for bit (an all-gather
copies), so greedy, beam and stop decisions agree without a broadcast,
and a sampling generator seeded alike on every rank draws alike.

Row-parallel sums, by kernel kind:
- int8 activations (W8A8, W4A8): the row's absmax is first reduced
  (MAX) over the group, so each rank quantizes its slice with the
  one-device scale; then the integer products are summed and scaled
  once. W8A8 sums `int_matmul`'s int32. K5 scales in its epilogue, so it
  runs with unit scales and fp32 output: its sums are integers below
  2^24 (checked), exact in fp32, and the sum over the group is exact
  too. Both give the one-device output bit for bit.
- float: each rank's partial product in the activations' dtype with
  fp32 accumulation, written out in fp32 without rounding (on the card
  `torch.mm(..., out_dtype=float32)`: no fp32 copy of the weights),
  summed in fp32 and rounded once to the activations' dtype, as one
  device rounds its product once (in another summation order).
- weight-only int8: fp32 partial products, as `nn.dense` computes the
  one-device product, summed in fp32 and rounded once.
Under autograd (training) the float and weight-only int8 forms run their
fp32 partial products as plain differentiable matmuls (the card's
`out_dtype` product is serving's); the W8A8 / W4A8 sums raise there: the
JAX package trains neither (their rounding of the activations has no
gradient).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from video_llava_seg_torch.parallel import collectives


class TensorParallel(NamedTuple):
    group: object
    rank: int
    size: int


_CURRENT: Optional[TensorParallel] = None


def current() -> Optional[TensorParallel]:
    """The tensor-parallel group the LLM runs in, or None."""
    return _CURRENT


@contextlib.contextmanager
def tensor_parallel(group, rank: int, size: int):
    """Run the LLM calls inside over `group` (its rank, its size)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = TensorParallel(group, rank, size) if size > 1 else None
    try:
        yield _CURRENT
    finally:
        _CURRENT = prev


def check_divisible(cfg, tp: int) -> None:
    """tp must divide the query and KV heads, the MLP width and the
    vocab (`create_mesh`'s checks, for the model's own dims)."""
    dims = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
            "intermediate_size": cfg.intermediate_size,
            "vocab_size": cfg.vocab_size}
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise ValueError(f"model_parallel={tp} must divide {bad}")


def local_heads(cfg):
    """(query heads, KV heads) of this rank."""
    tp = current()
    n = tp.size if tp else 1
    return cfg.num_heads // n, cfg.num_kv_heads // n


def alibi_slopes(cfg, device):
    """This rank's ALiBi slopes: those of its global query heads
    [r Hq / tp, (r + 1) Hq / tp); True (the kernel computes them) on one
    device."""
    tp = current()
    if tp is None:
        return True
    from video_llava_seg_torch.ops.attention import _alibi_slopes_on

    hq = cfg.num_heads // tp.size
    return _alibi_slopes_on(cfg.num_heads, device)[tp.rank * hq:
                                                   (tp.rank + 1) * hq]


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Lookup in a vocabulary-split table (this rank's rows), summed over
    the group: one rank contributes each row, the others add zeros."""
    tp = current()
    n = table.shape[0]
    lo = tp.rank * n
    mine = (ids >= lo) & (ids < lo + n)
    local = torch.where(mine, ids - lo, torch.zeros_like(ids))
    # summed in fp32 (exact: one row and zeros), whatever the table's type
    out = table[local].float() * mine[..., None]
    return collectives.reduce_from_model(out, tp.group).to(table.dtype)


def gather_logits(logits: torch.Tensor) -> torch.Tensor:
    """[..., V / tp] -> [..., V], the ranks' columns in rank order."""
    return collectives.gather_from_model(logits, current().group)


def column_input(x: torch.Tensor) -> torch.Tensor:
    """x as the input of this rank's column-parallel denses: the same
    tensor forward, its gradient summed over the group backward; x itself
    on one device."""
    tp = current()
    return x if tp is None else collectives.copy_to_model(x, tp.group)


def _matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w unrounded in fp32: on the card a bf16 / fp16 product
    accumulated and written out in fp32; elsewhere (and for fp32 inputs)
    the fp32 product."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x, w, out_dtype=torch.float32)
    return torch.matmul(x.float(), w.float())


# |int8| x |int4| x in must stay below 2^24 for K5's fp32 sums to be exact
_INT_EXACT = 1 << 24


def row_parallel_dense(p, x: torch.Tensor) -> torch.Tensor:
    """`nn.dense` of a row-parallel dense (this rank's input rows) on
    this rank's slice of x [..., in / tp], summed over the group; a
    bias is added once, after the sum."""
    from video_llava_seg_torch.ops import int4
    from video_llava_seg_torch.ops.quantization import (
        quantize_activations_rowwise,
    )

    tp = current()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    lora = p.get("lora")
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, p.get("kernel"),
                                  *(lora[k] for k in ("a", "b") if lora))
        if t is not None)
    if "kernel_qa" in p or "kernel_q4a" in p:
        if grad:
            raise ValueError(
                "row-parallel W8A8 / W4A8 denses are serving-only: under "
                "autograd train a float or weight-only int8 (--bits 8) base")
        amax = collectives.all_reduce(
            x2.float().abs().amax(dim=-1, keepdim=True), "max", tp.group)
        xq, scale = quantize_activations_rowwise(x2, amax)
        if "kernel_qa" in p:
            acc = int4.int_matmul(xq, p["kernel_qa"])
        else:
            in_dim = 2 * p["kernel_q4a"].shape[0] * tp.size
            if in_dim * 127 * 7 >= _INT_EXACT:
                raise ValueError(f"row-parallel W4A8 at in={in_dim}: K5's "
                                 "fp32 sums would not be exact")
            acc = int4.w4a8_integer_product(xq, p["kernel_q4a"])
        acc = collectives.all_reduce(acc, "sum", tp.group)
        y = (acc.float() * scale * p["kernel_scale"]).to(x.dtype)
    else:
        if "kernel_q" in p:
            # the per-column scale commutes with the sum over the rows
            y = (torch.matmul(x2.float(), p["kernel_q"].float())
                 * p["kernel_scale"].float())
        elif grad:
            y = torch.matmul(x2.float(), p["kernel"].to(x.dtype).float())
        else:
            y = _matmul_fp32(x2, p["kernel"].to(x.dtype))
        if lora is not None:
            y = y + torch.matmul(torch.matmul(x2, lora["a"].to(x.dtype)),
                                 lora["b"].to(x.dtype)).float() * lora["s"]
        y = collectives.reduce_from_model(y, tp.group).to(x.dtype)
    y = y.reshape(*lead, -1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y
