"""Llama-3-shaped decoder LLM, greedy serving path (port of
`video_llava_seg_tpu/models/llama.py`).

RMSNorm, SwiGLU, GQA, 1-D RoPE, a preallocated KV cache (bf16, or int8
with per-position fp32 scales), left-padded ragged batches, and a greedy
decode loop that keeps the post-norm hidden state of every emitted token
(the [SEG] hidden states the seg head reads).

Denses go through `ops.nn.dense`, so a quantized tree
(`init_quantized`, or `ops.quantization.quantize_tree` of a float one)
runs its W4A8 products through K5 on the card. Prefill attention goes
through `ops.attention.attention` (on the card the K2 flash kernel, with
a per-key bias under left padding). Decode attention stays the plain
twin, as in the JAX package (no Pallas kernel there); with the int8
cache it reads the int8 K/V and folds the scales in exactly.

`forward` is the training forward (no cache): each block optionally
under `torch.utils.checkpoint` (gradient checkpointing), which runs the
block's attention kernel (K2) a second time in the backward.

Out of the slice (raise NotImplementedError naming the ROADMAP feature):
sampling and beam search, the MPT / Mistral switches. `stack_layers`, a
TPU compile-time workaround, is not ported.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.attention import attention, attention_reference
from video_llava_seg_torch.ops.rope import apply_rope_1d, rope_1d_cos_sin
from video_llava_seg_torch.timing import stage


def _check_cfg(cfg):
    if (cfg.use_alibi or cfg.sliding_window is not None or not cfg.use_rope
            or cfg.norm_type != "rmsnorm" or cfg.mlp_type != "swiglu"):
        raise NotImplementedError("ROADMAP queue 1: the Mistral and MPT "
                                  "families")


def init_layer(cfg, g, device, dtype):
    d = cfg.hidden_size
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    q_dim = cfg.num_heads * cfg.head_dim
    return {
        "input_layernorm": nn.rms_norm_init(d, device, dtype),
        "attn": {
            "wq": nn.dense_init(g, d, q_dim, device, dtype, bias=False),
            "wk": nn.dense_init(g, d, kv_dim, device, dtype, bias=False),
            "wv": nn.dense_init(g, d, kv_dim, device, dtype, bias=False),
            "wo": nn.dense_init(g, q_dim, d, device, dtype, bias=False),
        },
        "post_attention_layernorm": nn.rms_norm_init(d, device, dtype),
        "mlp": {
            "w_gate": nn.dense_init(g, d, cfg.intermediate_size, device,
                                    dtype, bias=False),
            "w_up": nn.dense_init(g, d, cfg.intermediate_size, device, dtype,
                                  bias=False),
            "w_down": nn.dense_init(g, cfg.intermediate_size, d, device,
                                    dtype, bias=False),
        },
    }


def init(cfg, g: torch.Generator, device, dtype):
    _check_cfg(cfg)
    d = cfg.hidden_size
    p = {
        "embed_tokens": nn.embedding_init(g, cfg.vocab_size, d, device,
                                          dtype),
        "layers": [init_layer(cfg, g, device, dtype)
                   for _ in range(cfg.num_layers)],
        "norm": nn.rms_norm_init(d, device, dtype),
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

    _check_cfg(cfg)
    d = cfg.hidden_size

    def q(tree):
        return quantize_tree(tree, bits=bits, min_size=min_size,
                             act_quant=act_quant, train_mode=train_mode)

    p = {
        "embed_tokens": nn.embedding_init(g, cfg.vocab_size, d, device,
                                          dtype),
        "layers": [q(init_layer(cfg, g, device, dtype))
                   for _ in range(cfg.num_layers)],
        "norm": nn.rms_norm_init(d, device, dtype),
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
    each block input once."""
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
    return nn.embedding_lookup(params["embed_tokens"], ids)


def unembed(params, cfg, h):
    """fp32 logits [..., V] for the four head kinds of the JAX package."""
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
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
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
    reads the cache prefix [0, pos + s) through the plain twin; kv_start
    [B] masks each row's left-pad slots."""
    b, s, _ = x.shape
    if "wqkv" in layer["attn"]:
        q_dim = cfg.num_heads * cfg.head_dim
        kv_dim = cfg.num_kv_heads * cfg.head_dim
        qkv = nn.dense(layer["attn"]["wqkv"], x)
        q = qkv[..., :q_dim]
        k = qkv[..., q_dim:q_dim + kv_dim]
        v = qkv[..., q_dim + kv_dim:]
    else:
        q = nn.dense(layer["attn"]["wq"], x)
        k = nn.dense(layer["attn"]["wk"], x)
        v = nn.dense(layer["attn"]["wv"], x)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    q = apply_rope_1d(q, cos, sin)
    k = apply_rope_1d(k, cos, sin)
    if cache is not None:
        _store_kv(cache, li, pos, k, v)
    if pos == 0:
        o = attention(q, k.to(q.dtype), v.to(q.dtype), causal=causal,
                      kv_mask=kv_mask)
    else:
        # slots past the valid prefix would get exactly zero weight
        valid = pos + s
        dec_mask = None
        if kv_start is not None:
            dec_mask = (torch.arange(valid, device=x.device)[None, :]
                        >= kv_start[:, None])
        ck = cache.k[li, :, :, :valid]
        cv = cache.v[li, :, :, :valid]
        if cache.k_scale is not None:
            o = attention_reference(
                q, ck, cv, kv_mask=dec_mask,
                k_scale=cache.k_scale[li, :, :, :valid, 0],
                v_scale=cache.v_scale[li, :, :, :valid, 0])
        else:
            o = attention_reference(q, ck.to(q.dtype), cv.to(q.dtype),
                                    kv_mask=dec_mask)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return nn.dense(layer["attn"]["wo"], o)


def _mlp_block(layer, x):
    if "w_gateup" in layer["mlp"]:
        gu = nn.dense(layer["mlp"]["w_gateup"], x)
        half = gu.shape[-1] // 2
        g, u = gu[..., :half], gu[..., half:]
    else:
        g = nn.dense(layer["mlp"]["w_gate"], x)
        u = nn.dense(layer["mlp"]["w_up"], x)
    return nn.dense(layer["mlp"]["w_down"], torch.nn.functional.silu(g) * u)


def _block(layer, cfg, x, cos, sin, cache: Optional[KVCache], li: int,
           pos: int, causal: bool, kv_mask=None, kv_start=None):
    h = nn.rms_norm(layer["input_layernorm"], x, cfg.rms_norm_eps)
    x = x + _attn_block(layer, cfg, h, cos, sin, cache=cache, li=li,
                        pos=pos, causal=causal, kv_mask=kv_mask,
                        kv_start=kv_start)
    h = nn.rms_norm(layer["post_attention_layernorm"], x, cfg.rms_norm_eps)
    return x + _mlp_block(layer, h)


def _layers(params, cfg, x, cos, sin, cache: KVCache, pos: int,
            causal: bool, kv_mask=None, kv_start=None):
    for li, layer in enumerate(params["layers"]):
        x = _block(layer, cfg, x, cos, sin, cache, li, pos, causal, kv_mask,
                   kv_start)
    return nn.rms_norm(params["norm"], x, cfg.rms_norm_eps)


def forward(params, cfg, inputs_embeds, position_ids, attn_mask=None,
            remat: bool = False, return_logits: bool = True):
    """Full forward without a cache (training).

    inputs_embeds [B, S, D]; position_ids [B, S] or [S]; attn_mask:
    optional bool [B, S], False keys masked (right padding may omit it).
    remat: run each block under `torch.utils.checkpoint` (gradient
    checkpointing: only block inputs are kept, the block recomputes in the
    backward). return_logits=False skips the unembed (the train step's
    chunked fused lm-head + CE never builds the [S, V] logits).
    Returns (logits fp32 [B, S, V] or None, post-norm hidden [B, S, D])."""
    _check_cfg(cfg)
    if position_ids.dim() == 1:
        position_ids = position_ids[None]
    cos, sin = rope_1d_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
    x = inputs_embeds
    kw = dict(cache=None, li=0, pos=0, causal=True, kv_mask=attn_mask)
    for layer in params["layers"]:
        if remat:
            x = checkpoint(_block, layer, cfg, x, cos, sin,
                           use_reentrant=False, **kw)
        else:
            x = _block(layer, cfg, x, cos, sin, **kw)
    x = nn.rms_norm(params["norm"], x, cfg.rms_norm_eps)
    if not return_logits:
        return None, x
    return unembed(params, cfg, x), x


def prefill(params, cfg, inputs_embeds, position_ids, cache: KVCache,
            kv_mask=None, last_logit_only: bool = False):
    """Fill cache slots [0, S). kv_mask: optional bool [B, S], False keys
    masked (left-padded ragged batches). Returns (logits fp32
    [B, S or 1, V], hidden [B, S, D], cache)."""
    _check_cfg(cfg)
    if position_ids.dim() == 1:
        position_ids = position_ids[None]
    cos, sin = rope_1d_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
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
    pos = torch.tensor([[cache.length]], device=token_embeds.device)
    cos, sin = rope_1d_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    x = _layers(params, cfg, token_embeds, cos, sin, cache, cache.length,
                False, kv_start=kv_start)
    logits = unembed(params, cfg, x)
    return logits, x, cache._replace(length=cache.length + 1)


def greedy_generate(params, cfg, inputs_embeds, max_new_tokens: int,
                    eos_token_ids: Tuple[int, ...] = (),
                    stop_sequences: Tuple[Tuple[int, ...], ...] = (),
                    temperature: float = 0.0, pad_lens=None,
                    timings: Optional[Dict[str, float]] = None):
    """Greedy decode with the JAX package's loop semantics.

    pad_lens: optional [B] left-pad counts of a ragged batch (row b's
    prompt fills slots [pad_lens[b], S)): pad keys are masked in prefill
    and decode, and every row's last prompt token sits at S - 1.

    Returns (tokens [B, max_new] int64 (eos-padded after a row stops),
    hidden [B, max_new, D] (hidden[:, j] produced token j),
    n_generated int)."""
    if temperature:
        raise NotImplementedError("ROADMAP queue 1: sampling and beams")
    b, s, d = inputs_embeds.shape
    dev = inputs_embeds.device
    cache = init_kv_cache(cfg, b, s + max_new_tokens, dev,
                          dtype=inputs_embeds.dtype)
    pos = torch.arange(s, device=dev)[None]
    kv_mask = kv_start = None
    if pad_lens is not None:
        kv_start = torch.as_tensor(pad_lens, device=dev).long()
        kv_mask = pos >= kv_start[:, None]
    with stage(timings, "prefill", dev):
        logits, hidden, cache = prefill(params, cfg, inputs_embeds, pos,
                                        cache, kv_mask=kv_mask,
                                        last_logit_only=True)
        tok = torch.argmax(logits[:, -1], dim=-1)
    eos = torch.tensor(list(eos_token_ids), device=dev, dtype=torch.long)
    pad_id = int(eos_token_ids[0]) if eos_token_ids else 0
    tokens = torch.zeros((b, max_new_tokens), device=dev, dtype=torch.long)
    hiddens = torch.zeros((b, max_new_tokens + 1, d), device=dev,
                          dtype=inputs_embeds.dtype)
    hiddens[:, 0] = hidden[:, -1]
    done = torch.zeros(b, device=dev, dtype=torch.bool)
    i = 0
    with stage(timings, "decode", dev):
        while i < max_new_tokens and not bool(done.all()):
            # emit token i, decode it, pick token i + 1
            tok = torch.where(done, torch.full_like(tok, pad_id), tok)
            tokens[:, i] = tok
            emb = embed(params, tok[:, None]).to(inputs_embeds.dtype)
            logits, h, cache = decode_step(params, cfg, emb, cache,
                                           kv_start=kv_start)
            hiddens[:, i + 1] = h[:, 0]
            nxt = torch.argmax(logits[:, -1], dim=-1)
            done = done | torch.isin(tok, eos)
            for seq in stop_sequences:
                ln = len(seq)
                if ln == 0 or ln > max_new_tokens or i + 1 < ln:
                    continue
                tail = tokens[:, i + 1 - ln:i + 1]
                done = done | (tail == torch.tensor(seq, device=dev)).all(1)
            tok = nxt
            i += 1
    return tokens, hiddens[:, :max_new_tokens], i
