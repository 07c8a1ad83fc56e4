"""Llama-3-shaped decoder LLM, serving path (port of
`video_llava_seg_tpu/models/llama.py`).

RMSNorm, SwiGLU, GQA, 1-D RoPE, a preallocated KV cache (bf16, or int8
with per-position fp32 scales), left-padded ragged batches, a greedy or
sampled decode loop and an HF-exact beam search, each keeping the
post-norm hidden state of every emitted token (the [SEG] hidden states
the seg head reads).

The config's family switches, as the JAX package has them: Mistral
(`sliding_window`: each query sees the last `window` slots) and MPT
(`use_alibi` without RoPE, LayerNorm with a bias, a plain erf-GELU MLP
with no gate, the head tied to the embedding). Positions are cache slots,
left-pad slots included: RoPE and ALiBi see only slot differences, and a
window counts slots, as in the JAX package.

Denses go through `ops.nn.dense`, so a quantized tree
(`init_quantized`, or `ops.quantization.quantize_tree` of a float one)
runs its W4A8 products through K5 on the card. Prefill attention goes
through `ops.attention.attention` (on the card the K2 flash kernel, with
a per-key bias under left padding, the window as a bound on the keys,
ALiBi as a per-head key bias). Decode attention stays the plain twin, as
in the JAX package (no Pallas kernel there); with the int8 cache it
reads the int8 K/V and folds the scales in exactly.

`forward` is the training forward (no cache): each block optionally
under `torch.utils.checkpoint` (gradient checkpointing), which runs the
block's attention kernel (K2) a second time in the backward.

Sampling (`greedy_generate` with temperature > 0) cannot reproduce
`jax.random` bit for bit. Its contract: the same generator seed gives
the same tokens; the kept set of a step is the JAX package's
(`nucleus_filter`, pinned to `_select_token` by the CPU tests); and
top_p -> 0 gives the greedy tokens.

Tensor parallelism (`parallel/tensor_parallel.py`): inside its context
each rank holds its shard of the tree (`parallel/mesh.shard_params`):
its query / KV heads, its MLP columns, its vocabulary rows and columns.
The blocks reshape to the local heads, cache only the local KV heads,
take their global heads' ALiBi slopes, pass the column-parallel denses'
input through `column_input`, sum `wo` and `w_down` over the group, and
the logits are gathered whole on every rank, so every decision below is
the same on every rank. `forward` (training) runs the same blocks: RoPE
and the key mask are the one device's (they index positions, not heads),
and the flash kernels run at the local heads, forward and backward; a
checkpointed block reruns its sums in the recompute, on every rank in
the same order.

Out of the slice: training the Mistral / MPT families on the card (the
flash backward takes neither the window nor ALiBi: `attention` raises
NotImplementedError under autograd there). `stack_layers`, a TPU
compile-time workaround, is not ported.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.attention import attention, attention_reference
from video_llava_seg_torch.ops.rope import apply_rope_1d, rope_1d_cos_sin
from video_llava_seg_torch.parallel import tensor_parallel as tp_mod
from video_llava_seg_torch.timing import stage


def _norm_init(cfg, device, dtype):
    if cfg.norm_type == "layernorm":
        return nn.layer_norm_init(cfg.hidden_size, device, dtype)
    return nn.rms_norm_init(cfg.hidden_size, device, dtype)


def _norm(p, cfg, x):
    if cfg.norm_type == "layernorm":
        return nn.layer_norm(p, x, cfg.rms_norm_eps)
    return nn.rms_norm(p, x, cfg.rms_norm_eps)


def init_layer(cfg, g, device, dtype):
    d = cfg.hidden_size
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    q_dim = cfg.num_heads * cfg.head_dim
    # drawn in this order: attention, then the MLP (gate, up, down)
    attn = {
        "wq": nn.dense_init(g, d, q_dim, device, dtype, bias=False),
        "wk": nn.dense_init(g, d, kv_dim, device, dtype, bias=False),
        "wv": nn.dense_init(g, d, kv_dim, device, dtype, bias=False),
        "wo": nn.dense_init(g, q_dim, d, device, dtype, bias=False),
    }
    mlp = {}
    if cfg.mlp_type == "swiglu":
        mlp["w_gate"] = nn.dense_init(g, d, cfg.intermediate_size, device,
                                      dtype, bias=False)
    mlp["w_up"] = nn.dense_init(g, d, cfg.intermediate_size, device, dtype,
                                bias=False)
    mlp["w_down"] = nn.dense_init(g, cfg.intermediate_size, d, device,
                                  dtype, bias=False)
    return {
        "input_layernorm": _norm_init(cfg, device, dtype),
        "attn": attn,
        "post_attention_layernorm": _norm_init(cfg, device, dtype),
        "mlp": mlp,
    }


def init(cfg, g: torch.Generator, device, dtype):
    d = cfg.hidden_size
    p = {
        "embed_tokens": nn.embedding_init(g, cfg.vocab_size, d, device,
                                          dtype),
        "layers": [init_layer(cfg, g, device, dtype)
                   for _ in range(cfg.num_layers)],
        "norm": _norm_init(cfg, device, dtype),
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = nn.dense_init(g, d, cfg.vocab_size, device, dtype,
                                     bias=False)
    return p


def init_quantized(cfg, g: torch.Generator, device, dtype=torch.bfloat16,
                   bits: int = 8, min_size: int = 1 << 16,
                   act_quant: bool = False, train_mode: bool = False):
    """Initialise straight into quantized form, one layer at a time, so the
    peak is the quantized tree plus one float layer (an 8B LLM in bf16 is
    ~16 GB; as W4A8 ~4 GB of packed weights plus the bf16 embedding).
    Same tree as `quantize_tree(init(...))` over the same draws.
    train_mode: the QLoRA base (weight-only, bf16 scales)."""
    from video_llava_seg_torch.ops.quantization import quantize_tree

    d = cfg.hidden_size

    def q(tree):
        return quantize_tree(tree, bits=bits, min_size=min_size,
                             act_quant=act_quant, train_mode=train_mode)

    p = {
        "embed_tokens": nn.embedding_init(g, cfg.vocab_size, d, device,
                                          dtype),
        "layers": [q(init_layer(cfg, g, device, dtype))
                   for _ in range(cfg.num_layers)],
        "norm": _norm_init(cfg, device, dtype),
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = q(nn.dense_init(g, d, cfg.vocab_size, device, dtype,
                                       bias=False))
    return p


def _concat_denses(denses):
    """Concatenate dense param dicts along the output axis, or None when
    the group cannot be fused exactly (mixed kinds, LoRA, biases)."""
    kinds = [k for k in ("kernel", "kernel_q", "kernel_qa", "kernel_q4a")
             for d in denses if k in d]
    kind = kinds[0] if kinds else None
    if (kind is None or len(kinds) != len(denses)
            or any(kind not in d for d in denses)
            or any("lora" in d or "bias" in d for d in denses)):
        return None
    out = {kind: torch.cat([d[kind] for d in denses], dim=-1)}
    if kind != "kernel":
        out["kernel_scale"] = torch.cat([d["kernel_scale"] for d in denses],
                                        dim=-1)
    return out


def fuse_qkv_gateup(params):
    """Serving layout: each layer's wq|wk|wv become one 'wqkv' dense and
    w_gate|w_up one 'w_gateup'. Exact: per-output-channel weight scales
    and per-row activation scales keep every output column independent of
    the others, so the fused product equals the separate ones bit for
    bit; it makes 4 dense launches per layer instead of 7 and quantizes
    each block input once. An MPT layer (no gate) fuses its qkv only."""
    def fuse_layer(layer):
        layer = dict(layer)
        attn = layer["attn"]
        if "wq" in attn:
            fused = _concat_denses([attn["wq"], attn["wk"], attn["wv"]])
            if fused is not None:
                attn = {k: v for k, v in attn.items()
                        if k not in ("wq", "wk", "wv")}
                attn["wqkv"] = fused
                layer["attn"] = attn
        mlp = layer["mlp"]
        if "w_gate" in mlp:
            fused = _concat_denses([mlp["w_gate"], mlp["w_up"]])
            if fused is not None:
                mlp = {k: v for k, v in mlp.items()
                       if k not in ("w_gate", "w_up")}
                mlp["w_gateup"] = fused
                layer["mlp"] = mlp
        return layer

    p = dict(params)
    p["layers"] = [fuse_layer(layer) for layer in params["layers"]]
    return p


def embed(params, ids):
    if tp_mod.current() is not None:
        return tp_mod.embed(params["embed_tokens"]["embedding"], ids)
    return nn.embedding_lookup(params["embed_tokens"], ids)


def unembed(params, cfg, h):
    """fp32 logits [..., V] for the four head kinds of the JAX package.
    A tied head (MPT) is a plain product with the embedding table, in the
    hidden dtype (bf16 on the card) and then widened, as the JAX package
    leaves it to XLA. Under tensor parallelism each rank computes its
    vocabulary columns and the logits are gathered."""
    if tp_mod.current() is None:
        return _unembed_local(params, cfg, h)
    return tp_mod.gather_logits(_unembed_local(params, cfg,
                                               tp_mod.column_input(h)))


def _unembed_local(params, cfg, h):
    if cfg.tie_word_embeddings:
        w = params["embed_tokens"]["embedding"].to(h.dtype).t()
        return torch.matmul(h, w).float()
    head = params["lm_head"]
    if "kernel_q4a" in head:
        # W4A8 on an fp32 hidden state: K5 with fp32 output on the card
        from video_llava_seg_torch.ops.int4 import w4a8_dense

        return w4a8_dense(head, h.float())
    if "kernel_qa" in head:
        from video_llava_seg_torch.ops.int4 import int_matmul
        from video_llava_seg_torch.ops.quantization import (
            quantize_activations_rowwise,
        )

        hq, a_scale = quantize_activations_rowwise(h)
        acc = int_matmul(hq.reshape(-1, hq.shape[-1]), head["kernel_qa"])
        return (acc.reshape(*h.shape[:-1], -1).float() * a_scale
                * head["kernel_scale"])
    if "kernel_q" in head:
        y = torch.matmul(h.float(), head["kernel_q"].float())
        return y * head["kernel_scale"]
    # a float head: on the card the product runs in the hidden dtype
    # (bf16) and is then widened
    return torch.matmul(h, head["kernel"].to(h.dtype)).float()


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, Hkv, max_len, hd], bf16 or int8
    v: torch.Tensor
    length: int
    # int8 cache: per-(layer, batch, head, slot) fp32 scales
    # [L, B, Hkv, max_len, 1]; None for a float cache
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_kv_cache(cfg, batch: int, max_len: int, device,
                  dtype=torch.bfloat16,
                  quantized: Optional[bool] = None) -> KVCache:
    # a tensor-parallel rank caches its own KV heads only
    shape = (cfg.num_layers, batch, tp_mod.local_heads(cfg)[1], max_len,
             cfg.head_dim)
    if quantized is None:
        quantized = cfg.kv_cache_int8
    if quantized:
        sshape = shape[:-1] + (1,)
        return KVCache(torch.zeros(shape, device=device, dtype=torch.int8),
                       torch.zeros(shape, device=device, dtype=torch.int8),
                       0, torch.ones(sshape, device=device),
                       torch.ones(sshape, device=device))
    return KVCache(torch.zeros(shape, device=device, dtype=dtype),
                   torch.zeros(shape, device=device, dtype=dtype), 0)


def _quant_kv(x):
    """Symmetric int8 per (batch, head, position) over head_dim.
    x [B, H, S, D] -> (int8, fp32 [B, H, S, 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _store_kv(cache: KVCache, li: int, pos: int, k, v):
    """Write s new tokens' K/V at slots [pos, pos + s) IN PLACE (the JAX
    package returns an updated cache; the port mutates the preallocated
    one). An int8 cache stores them quantized per position."""
    s = k.shape[2]
    if cache.k_scale is not None:
        k, ks = _quant_kv(k)
        v, vs = _quant_kv(v)
        cache.k_scale[li, :, :, pos:pos + s] = ks
        cache.v_scale[li, :, :, pos:pos + s] = vs
    cache.k[li, :, :, pos:pos + s] = k
    cache.v[li, :, :, pos:pos + s] = v


def _attn_block(layer, cfg, x, cos, sin, *, cache: Optional[KVCache],
                li: int, pos: int, causal: bool, kv_mask=None,
                kv_start=None):
    """Attention for s new tokens at cache slots [pos, pos + s).

    Prefill (pos == 0) attends over the new tokens in the compute dtype
    (flash kernel on the card) and only stores them, quantized under the
    int8 cache; with cache=None (training) nothing is stored. Decode
    reads the cache prefix [0, pos + s) through the plain twin, its
    queries at slots pos.. for the window and ALiBi; kv_start [B] masks
    each row's left-pad slots. cos / sin: None without RoPE (MPT)."""
    b, s, _ = x.shape
    hq, hkv = tp_mod.local_heads(cfg)
    x = tp_mod.column_input(x)
    if "wqkv" in layer["attn"]:
        q_dim = hq * cfg.head_dim
        kv_dim = hkv * cfg.head_dim
        qkv = nn.dense(layer["attn"]["wqkv"], x)
        q = qkv[..., :q_dim]
        k = qkv[..., q_dim:q_dim + kv_dim]
        v = qkv[..., q_dim + kv_dim:]
    else:
        q = nn.dense(layer["attn"]["wq"], x)
        k = nn.dense(layer["attn"]["wk"], x)
        v = nn.dense(layer["attn"]["wv"], x)
    q = q.reshape(b, s, hq, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, s, hkv, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, s, hkv, cfg.head_dim).transpose(1, 2)
    if cfg.use_rope:
        q = apply_rope_1d(q, cos, sin)
        k = apply_rope_1d(k, cos, sin)
    if cache is not None:
        _store_kv(cache, li, pos, k, v)
    fam = dict(window=cfg.sliding_window,
               alibi=cfg.use_alibi and tp_mod.alibi_slopes(cfg, x.device))
    if pos == 0:
        o = attention(q, k.to(q.dtype), v.to(q.dtype), causal=causal,
                      kv_mask=kv_mask, **fam)
    else:
        # slots past the valid prefix would get exactly zero weight
        valid = pos + s
        dec_mask = None
        if kv_start is not None:
            dec_mask = (torch.arange(valid, device=x.device)[None, :]
                        >= kv_start[:, None])
        ck = cache.k[li, :, :, :valid]
        cv = cache.v[li, :, :, :valid]
        if cfg.sliding_window is not None or cfg.use_alibi:
            fam["q_positions"] = torch.arange(pos, valid, device=x.device)
        if cache.k_scale is not None:
            o = attention_reference(
                q, ck, cv, kv_mask=dec_mask,
                k_scale=cache.k_scale[li, :, :, :valid, 0],
                v_scale=cache.v_scale[li, :, :, :valid, 0], **fam)
        else:
            o = attention_reference(q, ck.to(q.dtype), cv.to(q.dtype),
                                    kv_mask=dec_mask, **fam)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return _row_dense(layer["attn"]["wo"], o)


def _row_dense(p, x):
    """`wo` / `w_down`: summed over the tensor-parallel group, if any."""
    if tp_mod.current() is not None:
        return tp_mod.row_parallel_dense(p, x)
    return nn.dense(p, x)


def _mlp_block(layer, cfg, x):
    x = tp_mod.column_input(x)
    if cfg.mlp_type == "gelu":
        return _row_dense(layer["mlp"]["w_down"],
                          nn.gelu(nn.dense(layer["mlp"]["w_up"], x)))
    if "w_gateup" in layer["mlp"]:
        gu = nn.dense(layer["mlp"]["w_gateup"], x)
        half = gu.shape[-1] // 2
        g, u = gu[..., :half], gu[..., half:]
    else:
        g = nn.dense(layer["mlp"]["w_gate"], x)
        u = nn.dense(layer["mlp"]["w_up"], x)
    return _row_dense(layer["mlp"]["w_down"],
                      torch.nn.functional.silu(g) * u)


def _block(layer, cfg, x, cos, sin, cache: Optional[KVCache], li: int,
           pos: int, causal: bool, kv_mask=None, kv_start=None):
    h = _norm(layer["input_layernorm"], cfg, x)
    x = x + _attn_block(layer, cfg, h, cos, sin, cache=cache, li=li,
                        pos=pos, causal=causal, kv_mask=kv_mask,
                        kv_start=kv_start)
    h = _norm(layer["post_attention_layernorm"], cfg, x)
    return x + _mlp_block(layer, cfg, h)


def _layers(params, cfg, x, cos, sin, cache: KVCache, pos: int,
            causal: bool, kv_mask=None, kv_start=None):
    for li, layer in enumerate(params["layers"]):
        x = _block(layer, cfg, x, cos, sin, cache, li, pos, causal, kv_mask,
                   kv_start)
    return _norm(params["norm"], cfg, x)


def _rope(cfg, position_ids):
    """The RoPE tables (cos, sin) of position_ids [B, S] or [S], or
    (None, None) for a family without RoPE (MPT)."""
    if not cfg.use_rope:
        return None, None
    if position_ids.dim() == 1:
        position_ids = position_ids[None]
    return rope_1d_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)


def _hooked_block(hook, index, layer, *args, **kw):
    return _block(hook(index, layer), *args, **kw)


def forward(params, cfg, inputs_embeds, position_ids, attn_mask=None,
            remat: bool = False, return_logits: bool = True,
            layer_hook=None):
    """Full forward without a cache (training).

    inputs_embeds [B, S, D]; position_ids [B, S] or [S]; attn_mask:
    optional bool [B, S], False keys masked (right padding may omit it).
    remat: run each block under `torch.utils.checkpoint` (gradient
    checkpointing: only block inputs are kept, the block recomputes in the
    backward). return_logits=False skips the unembed (the train step's
    chunked fused lm-head + CE never builds the [S, V] logits).
    layer_hook: optional (layer index, layer) -> the layer the block runs
    (FSDP's gather, `parallel/fsdp.py`), called inside the checkpointed
    block, so a recomputed block calls it again.
    Returns (logits fp32 [B, S, V] or None, post-norm hidden [B, S, D])."""
    cos, sin = _rope(cfg, position_ids)
    x = inputs_embeds
    kw = dict(cache=None, li=0, pos=0, causal=True, kv_mask=attn_mask)
    for li, layer in enumerate(params["layers"]):
        fn = (_block if layer_hook is None
              else functools.partial(_hooked_block, layer_hook, li))
        if remat:
            x = checkpoint(fn, layer, cfg, x, cos, sin,
                           use_reentrant=False, **kw)
        else:
            x = fn(layer, cfg, x, cos, sin, **kw)
    x = _norm(params["norm"], cfg, x)
    if not return_logits:
        return None, x
    return unembed(params, cfg, x), x


def prefill(params, cfg, inputs_embeds, position_ids, cache: KVCache,
            kv_mask=None, last_logit_only: bool = False):
    """Fill cache slots [0, S). kv_mask: optional bool [B, S], False keys
    masked (left-padded ragged batches). Returns (logits fp32
    [B, S or 1, V], hidden [B, S, D], cache)."""
    cos, sin = _rope(cfg, position_ids)
    s = inputs_embeds.shape[1]
    x = _layers(params, cfg, inputs_embeds, cos, sin, cache, 0, True,
                kv_mask)
    logits = unembed(params, cfg, x[:, -1:] if last_logit_only else x)
    return logits, x, cache._replace(length=s)


def decode_step(params, cfg, token_embeds, cache: KVCache, kv_start=None):
    """One decode step, token_embeds [B, 1, D] at slot cache.length.
    kv_start: optional [B] — slots below it hold left-pad K/V and are
    masked (RoPE keeps slot indices: only position differences enter the
    scores). Returns (logits [B, 1, V], hidden [B, 1, D], cache)."""
    cos, sin = _rope(cfg, torch.tensor([[cache.length]],
                                       device=token_embeds.device))
    x = _layers(params, cfg, token_embeds, cos, sin, cache, cache.length,
                False, kv_start=kv_start)
    logits = unembed(params, cfg, x)
    return logits, x, cache._replace(length=cache.length + 1)


def nucleus_filter(logits, temperature: float, top_p=None):
    """[B, V] logits -> fp32 logits / temperature with every token outside
    the nucleus at -inf (the JAX package's `_select_token` filter, HF
    TopPLogitsWarper semantics). A token is kept iff the probability mass
    strictly before it, in descending order, is < top_p; a token whose
    logit ties the smallest kept one is kept too (`scaled >= thresh`), and
    the most probable token always survives. top_p None keeps all."""
    scaled = logits.float() / torch.full((), float(temperature),
                                         device=logits.device)
    if top_p is None:
        return scaled
    srt = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    inf = torch.full((), float("inf"), device=logits.device)
    thresh = torch.where(keep, srt, inf).amin(dim=-1, keepdim=True)
    return torch.where(scaled >= thresh, scaled, -inf)


def select_token(logits, temperature: float = 0.0, top_p=None,
                 generator: Optional[torch.Generator] = None):
    """Next token of each [B, V] logits row: the argmax at temperature 0,
    else a draw from softmax(`nucleus_filter(...)`) by Gumbel-max over
    `torch.rand` of `generator` (on the logits' device)."""
    if not temperature:
        return torch.argmax(logits, dim=-1)
    scaled = nucleus_filter(logits, temperature, top_p)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)


def _stop_hits(tokens, i: int, stop_sequences, max_new_tokens: int):
    """Rows of tokens [N, max_new] whose emitted tokens [0, i] end with a
    stop sequence (the reference's KeywordsStoppingCriteria)."""
    hit = torch.zeros(tokens.shape[0], dtype=torch.bool,
                      device=tokens.device)
    for seq in stop_sequences:
        ln = len(seq)
        if ln == 0 or ln > max_new_tokens or i + 1 < ln:
            continue
        tail = tokens[:, i + 1 - ln:i + 1]
        hit = hit | (tail == torch.tensor(seq, device=tokens.device)).all(1)
    return hit


def greedy_generate(params, cfg, inputs_embeds, max_new_tokens: int,
                    eos_token_ids: Tuple[int, ...] = (),
                    stop_sequences: Tuple[Tuple[int, ...], ...] = (),
                    temperature: float = 0.0, pad_lens=None, top_p=None,
                    generator: Optional[torch.Generator] = None,
                    timings: Optional[Dict[str, float]] = None,
                    info: Optional[Dict] = None):
    """Greedy (or sampled) decode with the JAX package's loop semantics.

    temperature 0 is the argmax; > 0 samples each step from
    softmax(logits / temperature) filtered to the top_p nucleus
    (`select_token`), drawing from `generator`, which is then required
    (a ValueError without it, as the JAX package without an rng key).

    pad_lens: optional [B] left-pad counts of a ragged batch (row b's
    prompt fills slots [pad_lens[b], S)): pad keys are masked in prefill
    and decode, and every row's last prompt token sits at S - 1.

    info: optional dict, filled with "steps" (decode steps run) and
    "logprob" ([B] sum of the model's log-probabilities of each row's
    emitted tokens, eos included).

    Returns (tokens [B, max_new] int64 (eos-padded after a row stops),
    hidden [B, max_new, D] (hidden[:, j] produced token j),
    n_generated int)."""
    if temperature and generator is None:
        raise ValueError("temperature > 0 requires a generator")
    b, s, d = inputs_embeds.shape
    dev = inputs_embeds.device
    cache = init_kv_cache(cfg, b, s + max_new_tokens, dev,
                          dtype=inputs_embeds.dtype)
    pos = torch.arange(s, device=dev)[None]
    kv_mask = kv_start = None
    if pad_lens is not None:
        kv_start = torch.as_tensor(pad_lens, device=dev).long()
        kv_mask = pos >= kv_start[:, None]

    def pick(logits):
        return select_token(logits, temperature, top_p, generator)

    with stage(timings, "prefill", dev):
        logits, hidden, cache = prefill(params, cfg, inputs_embeds, pos,
                                        cache, kv_mask=kv_mask,
                                        last_logit_only=True)
        tok = pick(logits[:, -1])
    eos = torch.tensor(list(eos_token_ids), device=dev, dtype=torch.long)
    pad_id = int(eos_token_ids[0]) if eos_token_ids else 0
    tokens = torch.zeros((b, max_new_tokens), device=dev, dtype=torch.long)
    hiddens = torch.zeros((b, max_new_tokens + 1, d), device=dev,
                          dtype=inputs_embeds.dtype)
    hiddens[:, 0] = hidden[:, -1]
    done = torch.zeros(b, device=dev, dtype=torch.bool)
    logprob = torch.zeros(b, device=dev)
    i = 0
    with stage(timings, "decode", dev):
        while i < max_new_tokens and not bool(done.all()):
            # emit token i, decode it, pick token i + 1
            tok = torch.where(done, torch.full_like(tok, pad_id), tok)
            tokens[:, i] = tok
            if info is not None:
                lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
                logprob += torch.where(done, 0.0,
                                       lp.gather(1, tok[:, None])[:, 0])
            emb = embed(params, tok[:, None]).to(inputs_embeds.dtype)
            logits, h, cache = decode_step(params, cfg, emb, cache,
                                           kv_start=kv_start)
            hiddens[:, i + 1] = h[:, 0]
            nxt = pick(logits[:, -1])
            done = (done | torch.isin(tok, eos)
                    | _stop_hits(tokens, i, stop_sequences, max_new_tokens))
            tok = nxt
            i += 1
    if info is not None:
        info.update(steps=i, logprob=logprob.tolist())
    return tokens, hiddens[:, :max_new_tokens], i


def _tile_beams(x, k: int):
    """A cache array [L, 1, ...] tiled to [L, k, ...] (beam expansion)."""
    return x.expand(-1, k, *x.shape[2:]).contiguous() if x is not None \
        else None


def _reorder_gen_slots(x, parents, prompt_len: int, length: int):
    """Permute the beam axis of a cache array [L, K, H, max_len, hd(|1)]
    IN PLACE over the generated slots written so far, [prompt_len,
    length). The prefix is written once by the shared prefill, so every
    beam's prefix holds the same bytes and is never copied; slots from
    `length` on are written before they are read. The rows are gathered
    into a new tensor first, so the write does not read its own output."""
    if x is None or length <= prompt_len:
        return
    gen = x[:, :, :, prompt_len:length].index_select(1, parents)
    x[:, :, :, prompt_len:length] = gen


def _top(x, n: int):
    """The n largest of a 1-D x and their indices, ties to the lower
    index (`jax.lax.top_k`'s order; `torch.topk` promises none)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:n], idx[:n]


def beam_generate(params, cfg, inputs_embeds, max_new_tokens: int,
                  eos_token_ids: Tuple[int, ...] = (), num_beams: int = 1,
                  length_penalty: float = 1.0,
                  stop_sequences: Tuple[Tuple[int, ...], ...] = (),
                  timings: Optional[Dict[str, float]] = None,
                  info: Optional[Dict] = None):
    """Beam search at batch 1, the JAX package's `beam_generate` step for
    step (HF's `_beam_search` with early_stopping=False, do_sample=False):

    - each step expands max(2, 1 + n_eos) * K candidates over the K x V
      accumulated log-probs;
    - candidates that hit a stopping criterion (eos, max length, a
      keyword stop sequence) are offered to a fixed K-slot finished pool
      at sum_logprobs / gen_len ** length_penalty under HF's top-K rank
      mask, and the pool keeps its best K;
    - the live set continues with the best K unfinished candidates
      (finished ones demoted by -1e9);
    - the loop ends on HF's early-stop heuristic or when every candidate
      hit a stopping criterion; pool slot 0 is returned.

    Every selection is a stable descending sort, so ties go to the lower
    index as under `jax.lax.top_k`. The KV cache (float, or int8 with
    its scales) is tiled to K beams once after the prefill; each step
    reorders only its generated slots in place (`_reorder_gen_slots`).
    On the card the K-row decode denses of a W4A8 tree run K5's decode
    entry (`w4a8_gemv_sm90.cu`, up to 8 rows).

    info: optional dict, filled with "steps" (decode steps run) and
    "score" (the returned hypothesis's length-penalised score).

    Returns (tokens [1, max_new], hidden [1, max_new, D] of the winning
    beam (hidden[:, j] produced token j), n_generated int), the contract
    of `greedy_generate` at batch 1."""
    b, s, d = inputs_embeds.shape
    if b != 1:
        raise ValueError("beam search serves one prompt at a time")
    k = num_beams
    n_eos = len(eos_token_ids)
    kk = max(2, 1 + n_eos) * k              # HF beams_to_keep
    dev = inputs_embeds.device
    top_mask = torch.arange(kk, device=dev) < k
    neg = torch.full((), -1e9, device=dev)  # HF's demotion constant
    big_l = max_new_tokens
    vocab = cfg.vocab_size
    cache = init_kv_cache(cfg, 1, s + big_l, dev, dtype=inputs_embeds.dtype)
    pos = torch.arange(s, device=dev)[None]
    with stage(timings, "prefill", dev):
        logits, hidden, cache = prefill(params, cfg, inputs_embeds, pos,
                                        cache, last_logit_only=True)
        lp = torch.log_softmax(logits[0, -1].float(), dim=-1)
        lp = lp[None].expand(k, -1)
        cache = KVCache(_tile_beams(cache.k, k), _tile_beams(cache.v, k),
                        cache.length, _tile_beams(cache.k_scale, k),
                        _tile_beams(cache.v_scale, k))
    eos = torch.tensor(list(eos_token_ids), device=dev, dtype=torch.long)

    run_scores = torch.full((k,), -1e9, device=dev)
    run_scores[0] = 0.0
    run_tokens = torch.zeros((k, big_l), device=dev, dtype=torch.long)
    hiddens = torch.zeros((k, big_l + 1, d), device=dev,
                          dtype=inputs_embeds.dtype)
    hiddens[:, 0] = hidden[0, -1]
    fin_scores = torch.full((k,), -1e9, device=dev)
    fin_tokens = torch.zeros_like(run_tokens)
    fin_lens = torch.zeros((k,), device=dev, dtype=torch.long)
    is_fin = torch.zeros((k,), device=dev, dtype=torch.bool)
    fin_hidden = torch.zeros_like(hiddens)
    unsat = torch.ones((), device=dev, dtype=torch.bool)
    i, cont = 0, True
    with stage(timings, "decode", dev):
        while i < big_l and cont:
            acc = run_scores[:, None] + lp[:, :vocab]          # [K, V]
            t_scores, flat = _top(acc.reshape(-1), kk)
            parents = torch.div(flat, vocab, rounding_mode="floor")
            toks = flat % vocab
            cand_tokens = run_tokens.index_select(0, parents)
            cand_tokens[:, i] = toks
            cand_hidden = hiddens.index_select(0, parents)

            # stopping criteria per candidate: eos, max length, stops
            hits = (torch.isin(toks, eos) | (i + 1 >= big_l)
                    | _stop_hits(cand_tokens, i, stop_sequences, big_l))

            # live set for the next step: best K unfinished candidates
            new_run_scores, sel = _top(t_scores + hits.float() * neg, k)
            sel_parents = parents[sel]
            next_toks = toks[sel]
            run_tokens = cand_tokens[sel]
            new_hiddens = cand_hidden[sel]
            with torch.profiler.record_function("beam/reorder"):
                for x in cache[:2] + cache[3:]:
                    _reorder_gen_slots(x, sel_parents, s, cache.length)

            # finished pool: merge (pool, length-penalised candidates)
            denom = torch.full((), i + 1.0, device=dev) ** length_penalty
            lp_fin = t_scores / denom + (~unsat).float() * neg
            offered = hits & top_mask
            lp_fin = lp_fin + (~offered).float() * neg
            fin_scores, mi = _top(torch.cat([fin_scores, lp_fin]), k)
            fin_tokens = torch.cat([fin_tokens, cand_tokens])[mi]
            fin_lens = torch.cat([fin_lens, torch.full(
                (kk,), i + 1, device=dev, dtype=torch.long)])[mi]
            is_fin = torch.cat([is_fin, offered])[mi]
            fin_hidden = torch.cat([fin_hidden, cand_hidden])[mi]

            # decode the selected live beams for the next step's log-probs
            emb = embed(params, next_toks[:, None]).to(inputs_embeds.dtype)
            logits, h, cache = decode_step(params, cfg, emb, cache)
            new_hiddens[:, i + 1] = h[:, 0]
            hiddens = new_hiddens
            lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
            run_scores = new_run_scores

            # HF's early-stop heuristic (early_stopping=False): once the
            # pool is full, stop when the best live sum at this length
            # cannot beat the worst pooled score
            best_possible = new_run_scores[0] / denom
            worst = torch.where(is_fin, fin_scores.min(), neg)
            unsat = unsat & (best_possible > worst).any()
            cont = bool(unsat & ~hits.all())
            i += 1
    if info is not None:
        info.update(steps=i, score=float(fin_scores[0]))
    return fin_tokens[:1], fin_hidden[:1, :big_l], int(fin_lens[0])
