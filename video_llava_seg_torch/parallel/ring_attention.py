"""Ring attention: context parallelism over a group of ranks along one
'seq' axis (port of `video_llava_seg_tpu/parallel/ring_attention.py`).

Each rank holds a contiguous S/P slice of the sequence. Its queries stay;
the K / V shards travel around the ring (rank r sends to r + 1), and at
step t rank `idx` holds the shard of rank (idx - t) % P. Every step's
block attention is merged into the rank's running output by the blocks'
logsumexp, so the result is the softmax over the whole sequence.

- A block is one call of the flash forward with its logsumexp: on a CUDA
  tensor `kernels.attention(..., with_lse=True)` (K2; at head dim 128
  `csrc/attention_sm90.cu`), causal for the diagonal block (t = 0),
  non-causal for a block of an earlier rank; a later rank's block is
  not launched under causal attention (every entry masked: its share is
  exactly zero). On a CPU tensor `ops.attention.flash_forward_plain`.
  The blocks merge in fp32 (`_merge`): lse = logaddexp(lse, lse_b),
  o = o exp(lse_old - lse) + o_b exp(lse_b - lse); the output is
  rounded to the input's dtype once, after the last block.
- The backward (`_RingAttention`, the counterpart of differentiating
  the JAX package's `lax.scan` + `ppermute`) runs the ring again: each
  block's dQ / dK / dV from `kernels.attention_bwd` (K6a then K6b; on
  the CPU `flash_backward_plain`) given the merged output O and its lse,
  so delta = rowsum(dO O) is the whole row's and the blocks' products
  sum to the gradient. dQ adds up in fp32 on its rank; dK / dV add up in
  fp32 and travel with their K / V shard, and one last hop brings them
  to the shard's rank.
- The rotation is `collectives.ring_shift`: P - 1 hops of K / V forward
  (the JAX loop's last `ppermute` moves data nobody reads), P - 1 hops
  of K / V / dK / dV and one of dK / dV backward.

`cp_forward` is the context-parallel Llama forward (prefill or a
training forward): every rank runs the layers on its slice with ring
attention, the final norm on its slice, then gathers the hidden state
in sequence order and computes the logits of the whole sequence, so
every rank returns the one device's `(logits, hidden)`. Gradients: the
gather's backward takes the rank's slice, the slicing's backward
gathers the input's gradient whole, so the leaves used outside the
layers (the embedding that makes `inputs_embeds`, `lm_head`) get their
whole gradient on every rank; the layers' and the final norm's leaves
get the part of the rank's own tokens, which `reduce_grads` sums over
the group once.

The JAX function drops ALiBi, the sliding window and any key mask;
`cp_forward` refuses a config with ALiBi or a window shorter than the
sequence, and a tree with fused q / k / v denses.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from video_llava_seg_torch import kernels
from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.attention import (
    MASK_VALUE,
    flash_backward_plain,
    flash_forward_plain,
)
from video_llava_seg_torch.ops.rope import apply_rope_1d
from video_llava_seg_torch.parallel import collectives

SEQ_AXIS = "seq"
# the leaves cp_forward applies to each rank's own tokens: their
# gradients are partial sums, added over the group by `reduce_grads`
PARTIAL_PREFIXES = ("layers/", "norm/")


def create_seq_mesh(n_devices: Optional[int] = None, axis: str = SEQ_AXIS):
    """The first n_devices ranks of the world (all by default) as one
    group along `axis`: a 1 x n `parallel.mesh.Mesh` whose second axis is
    `axis`; `mesh.groups[axis]` is the group to pass to the functions
    below (None for one rank). Every rank of the world calls it (process
    groups are created collectively)."""
    from video_llava_seg_torch.config import MeshConfig
    from video_llava_seg_torch.parallel.mesh import create_mesh

    world = collectives.world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world or (n == 1 and world > 1):
        # one rank of many would get the group None, which the functions
        # read as the default group
        raise ValueError(f"create_seq_mesh: {n} ranks asked for, the world "
                         f"has {world}")
    return create_mesh(MeshConfig(data_parallel=1, model_parallel=n,
                                  model_axis=axis), world=n)


def _block_attn(q, k, v, mask):
    """One ring step's block, unnormalized (the JAX package's
    `_block_attn`, the plain reference of the merge): q [B, Hq, Sq, D],
    k / v [B, Hkv, Skv, D], mask bool [Sq, Skv] (True = attend). Returns
    (o_num fp32 [B, Hq, Sq, D], m fp32 [B, Hq, Sq], l fp32 [B, Hq, Sq]):
    the numerator, row max and row sum; a row with no visible key has
    m = -inf, l = 0 and o_num = 0."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, group * sq, d).float()
    s = torch.matmul(qg, k.float().transpose(-1, -2)) * scale
    s = s.reshape(b, hq, sq, -1)
    s = torch.where(mask[None, None], s, MASK_VALUE)
    m = s.amax(dim=-1)
    dead = m <= MASK_VALUE * 0.5
    m_safe = torch.where(dead, 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask[None, None], p, 0.0)
    l = p.sum(dim=-1)
    pg = p.reshape(b, hkv, group * sq, -1)
    o = torch.matmul(pg, v.float()).reshape(b, hq, sq, d)
    return o, torch.where(dead, float("-inf"), m), l


def _block_forward(q, k, v, causal: bool, scale: float):
    """(out, lse fp32) of one block: K2 on the card, the plain twin on the
    CPU."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, None, causal=causal, scale=scale)
    kernels.LAUNCHES.add("K2")
    return kernels.attention(q, k, v, scale=scale, causal=causal,
                             with_lse=True)


def _block_backward(q, k, v, out, dout, lse, causal: bool, scale: float):
    """(dq, dk, dv) of one block from the merged output and lse: K6a +
    K6b on the card, the plain twin on the CPU."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, None, out, lse, dout,
                                    causal=causal, scale=scale)
    kernels.LAUNCHES.add("K6a")
    kernels.LAUNCHES.add("K6b")
    return kernels.attention_bwd(q, k, v, out, dout, lse, scale=scale,
                                 causal=causal)


def _merge(o, lse, o_b, lse_b):
    """The running (o fp32, lse) merged with a block's (o_b, lse_b)."""
    if o is None:
        return o_b.float(), lse_b
    new = torch.logaddexp(lse, lse_b)
    o = (o * torch.exp(lse - new)[..., None]
         + o_b.float() * torch.exp(lse_b - new)[..., None])
    return o, new


def _launched(causal: bool, idx: int, src: int) -> bool:
    """Whether rank idx computes the block of rank src's keys: always,
    except a later rank's under causal attention."""
    return not causal or src <= idx


def _ring_forward(q, k, v, group, causal: bool, scale: float):
    n, idx = collectives.world_size(group), collectives.process_index(group)
    o = lse = None
    for t in range(n):
        if t:
            k, v = collectives.ring_shift([k, v], group)
        src = (idx - t) % n
        if _launched(causal, idx, src):
            o, lse = _merge(o, lse, *_block_forward(
                q, k, v, causal and t == 0, scale))
    return o.to(q.dtype), lse.contiguous()


def _ring_backward(q, k, v, out, lse, dout, group, causal: bool,
                   scale: float):
    n, idx = collectives.world_size(group), collectives.process_index(group)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for t in range(n):
        if t:
            k, v, dk, dv = collectives.ring_shift([k, v, dk, dv], group)
        src = (idx - t) % n
        if _launched(causal, idx, src):
            dq_b, dk_b, dv_b = _block_backward(q, k, v, out, dout, lse,
                                               causal and t == 0, scale)
            dq += dq_b
            dk += dk_b
            dv += dv_b
    # the shard held last is the next rank's: its sums go home
    dk, dv = collectives.ring_shift([dk, dv], group)
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        out, lse = _ring_forward(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, dout.contiguous(),
                                    ctx.group, ctx.causal, ctx.scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention_local(q, k, v, *, group=None, causal: bool = True):
    """Softmax attention over the whole sequence from this rank's shard:
    q [B, Hq, S_loc, D], k / v [B, Hkv, S_loc, D], the rank's contiguous
    slice (in group rank order) of [B, H, S, D] tensors. Returns the
    rank's rows [B, Hq, S_loc, D] of the one device's attention, in q's
    dtype; differentiable. Every rank of `group` (None: the default
    group) calls it with the same shapes."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq ({q.shape[1]}) must be a multiple of Hkv "
                         f"({k.shape[1]})")
    return _RingAttention.apply(q, k, v, group, causal,
                                1.0 / math.sqrt(q.shape[-1]))


class _SliceSeq(torch.autograd.Function):
    """This rank's slice along dim 1; backward, the group's slices of the
    gradient gathered whole."""

    @staticmethod
    def forward(ctx, x, group):
        n = collectives.world_size(group)
        size = x.shape[1] // n
        ctx.group = group
        return x.narrow(1, collectives.process_index(group) * size,
                        size).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return collectives.all_gather_dim(grad.contiguous(), 1,
                                          ctx.group), None


class _GatherSeq(torch.autograd.Function):
    """The group's slices concatenated along dim 1 in rank order;
    backward, this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.size = group, x.shape[1]
        return collectives.all_gather_dim(x.contiguous(), 1, group)

    @staticmethod
    def backward(ctx, grad):
        r = collectives.process_index(ctx.group)
        return grad.narrow(1, r * ctx.size, ctx.size).contiguous(), None


def check_cp_config(cfg, seq_len: int, params) -> None:
    """ValueError for what `cp_forward` cannot run as `llama.forward`
    does: ALiBi, a sliding window shorter than the sequence (the ring
    takes neither), fused q / k / v denses."""
    if cfg.use_alibi:
        raise ValueError("cp_forward: ALiBi (MPT) is not taken by the ring's "
                         "blocks")
    if cfg.sliding_window is not None and cfg.sliding_window < seq_len:
        raise ValueError(f"cp_forward: a sliding window of "
                         f"{cfg.sliding_window} < {seq_len} tokens (Mistral) "
                         "is not taken by the ring's blocks")
    if any("wqkv" in layer["attn"] for layer in params["layers"]):
        raise ValueError("cp_forward: fused q / k / v denses (wqkv); run it "
                         "on the unfused tree")


def _cp_block(layer, cfg, x, cos, sin, group):
    from video_llava_seg_torch.models import llama

    h = llama._norm(layer["input_layernorm"], cfg, x)
    b, s, _ = h.shape
    attn = layer["attn"]
    q = nn.dense(attn["wq"], h).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = nn.dense(attn["wk"], h).reshape(b, s, cfg.num_kv_heads,
                                        cfg.head_dim)
    v = nn.dense(attn["wv"], h).reshape(b, s, cfg.num_kv_heads,
                                        cfg.head_dim)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if cfg.use_rope:
        q = apply_rope_1d(q, cos, sin)
        k = apply_rope_1d(k, cos, sin)
    o = ring_attention_local(q, k, v, group=group, causal=True)
    x = x + nn.dense(attn["wo"], o.transpose(1, 2).reshape(b, s, -1))
    h = llama._norm(layer["post_attention_layernorm"], cfg, x)
    return x + llama._mlp_block(layer, cfg, h)


def cp_forward(params, cfg, inputs_embeds, position_ids, group=None, *,
               return_logits: bool = True):
    """Context-parallel Llama forward over the ranks of `group` (None: the
    default group): inputs_embeds [B, S, D], S divisible by the group's
    size, the same on every rank; position_ids [S] or [B, S] (global
    positions). Returns every rank the one device's (logits fp32
    [B, S, V] or None, post-norm hidden [B, S, D]), as `llama.forward`
    (no key mask, no remat). W4A8 / W8A8 trees run their denses through
    `nn.dense` as `llama.forward` does. Differentiable: see the module's
    docstring for which leaves' gradients `reduce_grads` sums."""
    from video_llava_seg_torch.models import llama

    b, s, _ = inputs_embeds.shape
    n = collectives.world_size(group)
    if s % n:
        raise ValueError(f"cp_forward: {s} tokens do not split over {n} "
                         "ranks")
    check_cp_config(cfg, s, params)
    if position_ids.dim() == 1:
        position_ids = position_ids[None]
    size = s // n
    r = collectives.process_index(group)
    cos, sin = llama._rope(cfg, position_ids[:, r * size:(r + 1) * size])
    x = _SliceSeq.apply(inputs_embeds, group)
    for layer in params["layers"]:
        x = _cp_block(layer, cfg, x, cos, sin, group)
    hidden = _GatherSeq.apply(llama._norm(params["norm"], cfg, x), group)
    if not return_logits:
        return None, hidden
    return llama.unembed(params, cfg, hidden), hidden


def reduce_grads(grads: Dict[str, torch.Tensor], group=None
                 ) -> Dict[str, torch.Tensor]:
    """Gradients of a loss of `cp_forward`'s outputs (the same loss on
    every rank), by leaf path ('layers/0/attn/wq/kernel', ...), made
    whole: those of the leaves under PARTIAL_PREFIXES summed over the
    group in fp32 (each rank holds its own tokens' part), the others
    (lm_head, the embedding) as they are (whole on every rank)."""
    return {p: (collectives._sum_fp32(g, group)
                if p.startswith(PARTIAL_PREFIXES) else g)
            for p, g in grads.items()}
