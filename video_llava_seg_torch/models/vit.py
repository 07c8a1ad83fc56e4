"""ViT vision towers, CLIP- and RADIO-shaped, and the S2 multi-scale
wrapper (port of `video_llava_seg_tpu/models/vit.py`).

Every encoder layer runs through `ops.vit_block.vit_layer`: K1 on the
card for a float tower, K8 for a W8A8 one (`quantize_tree(bits=8,
act_quant=True)`). CLIP: CLS token, pre-LayerNorm, quick_gelu, the
`select_layer` tap before the final norm. RADIO (the published
training scripts' `--vision_tower nvidia/RADIO`, ViT-H/16): the input
conditioner's normalisation, a patch embedder with a bias, register
tokens joined after the position add, no pre-norm, erf-GELU, the final
LayerNorm, the register tokens dropped from the 'patch' features. The
JAX package pads tokens to a multiple of 8 for Mosaic; the port does not:
577 tokens go to the kernels as they are.
"""

from __future__ import annotations

import torch

from video_llava_seg_torch.ops import nn
from video_llava_seg_torch.ops.resize import interpolate
from video_llava_seg_torch.ops.vit_block import vit_layer


def init(cfg, g: torch.Generator, device, dtype):
    d = cfg.hidden_size
    num_pos = cfg.num_patches + (1 if cfg.use_cls_token else 0)
    p = {
        # RADIO's ViTPatchLinear has a bias (convert/radio.py), CLIP's
        # patch conv none
        "patch_embedding": nn.conv2d_init(
            g, 3, d, (cfg.patch_size, cfg.patch_size), device, dtype,
            bias=cfg.is_radio),
        "position_embedding": nn.trunc_normal(g, (num_pos, d), 0.02, device,
                                              dtype),
        "pre_layrnorm": nn.layer_norm_init(d, device, dtype),
        "layers": [],
    }
    if cfg.use_cls_token:
        p["class_embedding"] = nn.trunc_normal(g, (d,), 0.02, device, dtype)
    if cfg.num_register_tokens > 0:
        p["register_tokens"] = nn.trunc_normal(
            g, (cfg.num_register_tokens, d), 0.02, device, dtype)
    if cfg.is_radio:
        # identity until a converter loads the checkpoint's statistics
        p["input_conditioner"] = {
            "mean": torch.zeros(3, device=device, dtype=dtype),
            "std": torch.ones(3, device=device, dtype=dtype)}
    for _ in range(cfg.num_layers):
        p["layers"].append({
            "layer_norm1": nn.layer_norm_init(d, device, dtype),
            "q_proj": nn.dense_init(g, d, d, device, dtype),
            "k_proj": nn.dense_init(g, d, d, device, dtype),
            "v_proj": nn.dense_init(g, d, d, device, dtype),
            "out_proj": nn.dense_init(g, d, d, device, dtype),
            "layer_norm2": nn.layer_norm_init(d, device, dtype),
            "fc1": nn.dense_init(g, d, cfg.intermediate_size, device, dtype),
            "fc2": nn.dense_init(g, cfg.intermediate_size, d, device, dtype),
        })
    p["post_layernorm"] = nn.layer_norm_init(d, device, dtype)
    return p


def resize_position_embedding(params, cfg, native_size: int):
    """Bicubic align_corners=True resize of the position table's spatial
    grid when cfg.image_size differs from the checkpoint's native size
    (the CLS row, if any, is kept). Returns updated params."""
    if cfg.image_size == native_size:
        return params
    pe = params["position_embedding"]
    n_old = native_size // cfg.patch_size
    n_new = cfg.num_patches_per_side
    cls_embed, spatial = (pe[:1], pe[1:]) if cfg.use_cls_token else (None,
                                                                     pe)
    spatial = interpolate(spatial.reshape(n_old, n_old, -1), (n_new, n_new),
                          "bicubic", align_corners=True)
    spatial = spatial.reshape(n_new * n_new, -1)
    out = dict(params)
    out["position_embedding"] = (torch.cat([cls_embed, spatial], dim=0)
                                 if cls_embed is not None else spatial)
    return out


def num_layers_run(cfg) -> int:
    """Layers before the `select_layer` tap (hidden_states[0] = embeds)."""
    n = (cfg.num_layers + cfg.select_layer + 1 if cfg.select_layer < 0
         else cfg.select_layer)
    return max(0, min(n, cfg.num_layers))


def apply(params, cfg, images: torch.Tensor) -> torch.Tensor:
    """images: [B, H, W, 3] or [B, T, H, W, 3], normalised.

    Returns the `select_layer` features, CLS (and RADIO's register
    tokens) dropped for 'patch': [B(, T), N_patches, hidden]."""
    video = images.dim() == 5
    if video:
        b, t = images.shape[:2]
        images = images.reshape(b * t, *images.shape[2:])
    if cfg.is_radio and "input_conditioner" in params:
        cond = params["input_conditioner"]
        images = ((images - cond["mean"].to(images.dtype))
                  / cond["std"].to(images.dtype))
    x = nn.conv2d(params["patch_embedding"], images,
                  stride=(cfg.patch_size, cfg.patch_size), padding="VALID")
    bt, gh, gw, d = x.shape
    x = x.reshape(bt, gh * gw, d)
    if cfg.use_cls_token:
        cls_tok = params["class_embedding"].to(x.dtype).reshape(1, 1, d)
        x = torch.cat([cls_tok.expand(bt, 1, d), x], dim=1)
    x = x + params["position_embedding"][None].to(x.dtype)
    n_reg = cfg.num_register_tokens
    if n_reg > 0:
        # RADIO's cls / register tokens join AFTER the position add
        # (ViTPatchGenerator: position embeddings are the patches' only)
        reg = params["register_tokens"][None].to(x.dtype)
        x = torch.cat([reg.expand(bt, n_reg, d), x], dim=1)
    if not cfg.is_radio:
        x = nn.layer_norm(params["pre_layrnorm"], x, cfg.layernorm_eps)
    act = "gelu" if cfg.is_radio else "quick_gelu"
    n_tok = x.shape[1]
    for layer in params["layers"][:num_layers_run(cfg)]:
        x = vit_layer(layer, x, num_heads=cfg.num_heads,
                      eps=cfg.layernorm_eps, kv_len=n_tok, act=act)
    if cfg.final_norm:
        # RADIO's spatial features are final-normed (timm forward_features)
        x = nn.layer_norm(params["post_layernorm"], x, cfg.layernorm_eps)
    if cfg.select_feature == "patch" and cfg.use_cls_token:
        x = x[:, 1:]
    elif cfg.select_feature not in ("patch", "cls_patch"):
        raise ValueError(f"Unexpected select feature: {cfg.select_feature}")
    if n_reg > 0 and cfg.select_feature == "patch":
        x = x[:, n_reg:]
    if video:
        x = x.reshape(b, t, *x.shape[1:])
    return x


def apply_s2(params, cfg, images: torch.Tensor) -> torch.Tensor:
    """S2 multi-scale forward (the reference's CLIPVisionTowerS2; the
    algorithm of `multiscale_forward`).

    images: [B(, T), S, S, 3] at the LARGEST scale. For each scale s
    (ascending, the smallest is the split size s0): resize to s (bicubic),
    split into (s/s0)^2 crops of s0, batch them through the tower,
    reassemble the crop grid, area-average it back to the base grid, and
    concatenate the scales' channels in ascending order. Returns [B(, T),
    (s0/patch)^2, hidden * n_scales]; 'patch' features only, since crops
    have no joint CLS."""
    if not cfg.s2_scales:
        raise ValueError("apply_s2 requires cfg.s2_scales")
    if cfg.select_feature != "patch":
        raise ValueError("S2 merges patch grids only (select_feature "
                         "'patch')")
    scales = sorted(cfg.s2_scales)
    s0 = scales[0]
    video = images.dim() == 5
    if video:
        b, t = images.shape[:2]
        images = images.reshape(b * t, *images.shape[2:])
    n = images.shape[0]
    g0 = s0 // cfg.patch_size
    outs = []
    for s in scales:
        x = images
        if x.shape[1] != s:
            x = interpolate(x, (s, s), "bicubic")
        k = s // s0
        if k > 1:
            x = x.reshape(n, k, s0, k, s0, 3).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(n * k * k, s0, s0, 3)
        feats = apply(params, cfg, x)                  # [n*k*k, g0*g0, C]
        c = feats.shape[-1]
        feats = feats.reshape(n, k, k, g0, g0, c).permute(0, 1, 3, 2, 4, 5)
        feats = feats.reshape(n, k * g0, k * g0, c)
        if k > 1:
            feats = feats.reshape(n, g0, k, g0, k, c).mean(dim=(2, 4))
        outs.append(feats)
    out = torch.cat(outs, dim=-1).reshape(n, g0 * g0, -1)
    if video:
        out = out.reshape(b, t, *out.shape[1:])
    return out
