"""Two-way transformer + mask decoder (port of
`video_llava_seg_tpu/models/sam2/mask_decoder.py`), NHWC.

Image->token attention (4096 image queries against the ~7 prompt tokens)
goes through `ops.attention.attention` (on the card the K3 kernel); every
other attention here has a short query set and stays the plain twin, as
`backend="xla"` does in the JAX package. Denses are plain matmuls.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.attention import attention

_LN_EPS = 1e-5  # torch nn.LayerNorm default (two-way transformer)


def _attn_init(g, embed_dim, downsample_rate, device, dtype):
    internal = embed_dim // downsample_rate
    return {
        "q_proj": nn.dense_init(g, embed_dim, internal, device, dtype),
        "k_proj": nn.dense_init(g, embed_dim, internal, device, dtype),
        "v_proj": nn.dense_init(g, embed_dim, internal, device, dtype),
        "out_proj": nn.dense_init(g, internal, embed_dim, device, dtype),
    }


def _attn_apply(p, q, k, v, num_heads: int):
    """q/k/v: [B, N, C] -> [B, Nq, C]."""
    q = nn.dense(p["q_proj"], q)
    k = nn.dense(p["k_proj"], k)
    v = nn.dense(p["v_proj"], v)
    b, nq, c = q.shape
    hd = c // num_heads
    qh = q.reshape(b, nq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], num_heads, hd).transpose(1, 2)
    o = attention(qh, kh, vh, backend="auto" if nq >= 256 else "plain")
    o = o.transpose(1, 2).reshape(b, nq, c)
    return nn.dense(p["out_proj"], o)


def _twoway_block_init(g, cfg, device, dtype):
    d = cfg.hidden_dim
    rate = cfg.attention_downsample_rate
    return {
        "self_attn": _attn_init(g, d, 1, device, dtype),
        "norm1": nn.layer_norm_init(d, device, dtype),
        "cross_attn_t2i": _attn_init(g, d, rate, device, dtype),
        "norm2": nn.layer_norm_init(d, device, dtype),
        "mlp": nn.mlp_init(g, [d, cfg.twoway_mlp_dim, d], device, dtype),
        "norm3": nn.layer_norm_init(d, device, dtype),
        "norm4": nn.layer_norm_init(d, device, dtype),
        "cross_attn_i2t": _attn_init(g, d, rate, device, dtype),
    }


def twoway_init(g, cfg, device, dtype):
    return {
        "layers": [_twoway_block_init(g, cfg, device, dtype)
                   for _ in range(cfg.twoway_depth)],
        "final_attn": _attn_init(g, cfg.hidden_dim,
                                 cfg.attention_downsample_rate, device,
                                 dtype),
        "norm_final": nn.layer_norm_init(cfg.hidden_dim, device, dtype),
    }


def twoway_apply(params, cfg, image_embedding, image_pe, point_embedding):
    """image_embedding/image_pe: [B, N_img, C]; point_embedding [B, Np, C].
    Returns (queries, keys)."""
    heads = cfg.twoway_heads
    queries, keys = point_embedding, image_embedding
    for i, blk in enumerate(params["layers"]):
        if i == 0:
            # skip_first_layer_pe: the attention output replaces queries
            queries = _attn_apply(blk["self_attn"], queries, queries,
                                  queries, heads)
        else:
            q = queries + point_embedding
            queries = queries + _attn_apply(blk["self_attn"], q, q, queries,
                                            heads)
        queries = nn.layer_norm(blk["norm1"], queries, _LN_EPS)

        q = queries + point_embedding
        k = keys + image_pe
        queries = queries + _attn_apply(blk["cross_attn_t2i"], q, k, keys,
                                        heads)
        queries = nn.layer_norm(blk["norm2"], queries, _LN_EPS)

        queries = queries + nn.mlp_apply(blk["mlp"], queries)
        queries = nn.layer_norm(blk["norm3"], queries, _LN_EPS)

        q = queries + point_embedding
        k = keys + image_pe
        keys = keys + _attn_apply(blk["cross_attn_i2t"], k, q, queries,
                                  heads)
        keys = nn.layer_norm(blk["norm4"], keys, _LN_EPS)

    q = queries + point_embedding
    k = keys + image_pe
    queries = queries + _attn_apply(params["final_attn"], q, k, keys, heads)
    queries = nn.layer_norm(params["norm_final"], queries, _LN_EPS)
    return queries, keys


def init(cfg, g, device, dtype):
    d = cfg.hidden_dim
    num_mask_tokens = cfg.num_multimask_outputs + 1
    p = {
        "transformer": twoway_init(g, cfg, device, dtype),
        "iou_token": nn.trunc_normal(g, (1, d), 1.0, device, dtype),
        "mask_tokens": nn.trunc_normal(g, (num_mask_tokens, d), 1.0, device,
                                       dtype),
        "output_upscaling": {
            "dc1": nn.conv_transpose2d_init(g, d, d // 4, (2, 2), device,
                                            dtype),
            "ln": nn.layer_norm_init(d // 4, device, dtype),
            "dc2": nn.conv_transpose2d_init(g, d // 4, d // 8, (2, 2),
                                            device, dtype),
        },
        "output_hypernetworks_mlps": [
            nn.mlp_init(g, [d, d, d // 8], device, dtype)
            for _ in range(num_mask_tokens)],
        "iou_prediction_head": nn.mlp_init(
            g, [d] + [cfg.iou_head_hidden_dim] * (cfg.iou_head_depth - 1)
            + [num_mask_tokens], device, dtype),
    }
    if cfg.use_high_res_features_in_sam:
        p["conv_s0"] = nn.conv2d_init(g, d, d // 8, (1, 1), device, dtype)
        p["conv_s1"] = nn.conv2d_init(g, d, d // 4, (1, 1), device, dtype)
    if cfg.pred_obj_scores:
        p["obj_score_token"] = nn.trunc_normal(g, (1, d), 1.0, device, dtype)
        if cfg.pred_obj_scores_mlp:
            p["pred_obj_score_head"] = nn.mlp_init(g, [d, d, 1], device,
                                                   dtype)
        else:
            p["pred_obj_score_head"] = nn.dense_init(g, d, 1, device, dtype)
    return p


def predict_masks(params, cfg, image_embeddings, image_pe, sparse_prompt,
                  dense_prompt, high_res_features: Optional[List] = None):
    """image_embeddings/dense_prompt: [B, H, W, C]; image_pe [H, W, C];
    sparse_prompt [B, Np, C]. Returns (masks [B, M, 4H, 4W], iou [B, M],
    mask_tokens_out [B, M, C], object_score_logits [B, 1])."""
    b = sparse_prompt.shape[0]
    num_mask_tokens = cfg.num_multimask_outputs + 1
    tok_list = [params["iou_token"], params["mask_tokens"]]
    s = 0
    if cfg.pred_obj_scores:
        tok_list = [params["obj_score_token"]] + tok_list
        s = 1
    output_tokens = torch.cat(tok_list, dim=0)
    output_tokens = output_tokens[None].expand(b, *output_tokens.shape)
    tokens = torch.cat([output_tokens.to(sparse_prompt.dtype),
                        sparse_prompt], dim=1)

    src = image_embeddings + dense_prompt
    h, w, c = src.shape[1], src.shape[2], src.shape[3]
    src_seq = src.reshape(b, h * w, c)
    pe_seq = image_pe.reshape(1, h * w, c).expand(b, h * w, c).to(
        src_seq.dtype)

    hs, src_out = twoway_apply(params["transformer"], cfg, src_seq, pe_seq,
                               tokens)
    iou_token_out = hs[:, s]
    mask_tokens_out = hs[:, s + 1: s + 1 + num_mask_tokens]

    src_img = src_out.reshape(b, h, w, c)
    up = params["output_upscaling"]
    x = nn.conv_transpose2d(up["dc1"], src_img, (2, 2))
    if cfg.use_high_res_features_in_sam:
        feat_s0, feat_s1 = high_res_features
        x = x + feat_s1
    x = nn.gelu(nn.layer_norm(up["ln"], x, 1e-6))
    x = nn.conv_transpose2d(up["dc2"], x, (2, 2))
    if cfg.use_high_res_features_in_sam:
        x = x + feat_s0
    upscaled = nn.gelu(x)

    hyper_in = torch.stack(
        [nn.mlp_apply(mlp, mask_tokens_out[:, i])
         for i, mlp in enumerate(params["output_hypernetworks_mlps"])],
        dim=1)
    masks = torch.einsum("bmc,bhwc->bmhw", hyper_in.float(),
                         upscaled.float()).to(upscaled.dtype)

    iou_pred = nn.mlp_apply(params["iou_prediction_head"], iou_token_out,
                            sigmoid_output=cfg.iou_prediction_use_sigmoid)
    if cfg.pred_obj_scores:
        if cfg.pred_obj_scores_mlp:
            obj = nn.mlp_apply(params["pred_obj_score_head"], hs[:, 0])
        else:
            obj = nn.dense(params["pred_obj_score_head"], hs[:, 0])
    else:
        obj = 10.0 * torch.ones((b, 1), dtype=iou_pred.dtype,
                                device=iou_pred.device)
    return masks, iou_pred, mask_tokens_out, obj


def _stability_scores(mask_logits: torch.Tensor, delta: float):
    flat = mask_logits.reshape(*mask_logits.shape[:-2], -1)
    area_i = (flat > delta).sum(-1).float()
    area_u = (flat > -delta).sum(-1).float()
    return torch.where(area_u > 0, area_i / area_u,
                       torch.ones_like(area_u))


def dynamic_multimask_via_stability(cfg, all_masks, all_ious):
    """Fall back from the single-mask token to the best multimask output
    where the single mask is unstable (the reference's
    mask_decoder.py:247-301)."""
    multimask, multi_iou = all_masks[:, 1:], all_ious[:, 1:]
    best = torch.argmax(multi_iou, dim=-1)
    bi = torch.arange(all_masks.shape[0], device=all_masks.device)
    best_masks = multimask[bi, best][:, None]
    best_ious = multi_iou[bi, best][:, None]
    single_mask, single_iou = all_masks[:, 0:1], all_ious[:, 0:1]
    stab = _stability_scores(single_mask,
                             cfg.dynamic_multimask_stability_delta)
    is_stable = stab >= cfg.dynamic_multimask_stability_thresh
    masks = torch.where(is_stable[..., None, None], single_mask, best_masks)
    ious = torch.where(is_stable, single_iou, best_ious)
    return masks, ious


def apply(params, cfg, image_embeddings, image_pe, sparse_prompt,
          dense_prompt, multimask_output: bool,
          high_res_features: Optional[List] = None,
          use_dynamic_stability: bool = False):
    """Returns (masks, iou_pred, sam_tokens_out, object_score_logits);
    multimask_output selects tokens 1..3, else token 0 (or, with
    use_dynamic_stability, the best of 1..3 where token 0 is unstable)."""
    masks, iou_pred, mask_tokens_out, obj = predict_masks(
        params, cfg, image_embeddings, image_pe, sparse_prompt, dense_prompt,
        high_res_features)
    if multimask_output:
        out_masks, out_iou = masks[:, 1:], iou_pred[:, 1:]
    elif use_dynamic_stability:
        out_masks, out_iou = dynamic_multimask_via_stability(cfg, masks,
                                                             iou_pred)
    else:
        out_masks, out_iou = masks[:, 0:1], iou_pred[:, 0:1]
    if multimask_output and cfg.use_multimask_token_for_obj_ptr:
        sam_tokens_out = mask_tokens_out[:, 1:]
    else:
        sam_tokens_out = mask_tokens_out[:, 0:1]
    return out_masks, out_iou, sam_tokens_out, obj
