"""Full Video-LLaVA-Seg torch checkpoint -> the port's parameter tree
(port of `video_llava_seg_tpu/convert/llava_torch.py`).

Reads every `*.safetensors` shard (the port's own reader) or else every
`pytorch_model*.bin` shard (`torch.load(weights_only=True)`, widened to
fp32 as the JAX package does), pads the vocabulary with the mean
embedding, and converts the reference's HF key layout:
model.layers.* (LLM), model.vision_tower.vision_tower.* (CLIP's
vision_model.* or RADIO's radio_model.*), model.mm_projector.*,
model.seg_head.*. Leaves stay on the CPU in the
stored dtype; `inference.main.load_model` moves them to the card.
"""

from __future__ import annotations

import glob
import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch

from video_llava_seg_torch.convert.safetensors_io import read_safetensors


def load_torch_shards(model_dir: str) -> Dict[str, torch.Tensor]:
    """Read all *.safetensors (or pytorch_model*.bin) shards."""
    sd: Dict[str, torch.Tensor] = {}
    st_files = sorted(glob.glob(osp.join(model_dir, "*.safetensors")))
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(f))
        return sd
    bin_files = sorted(glob.glob(osp.join(model_dir, "pytorch_model*.bin")))
    if not bin_files:
        raise FileNotFoundError(f"no checkpoint shards in {model_dir}")
    for f in bin_files:
        part = torch.load(f, map_location="cpu", weights_only=True)
        sd.update({k: v.float() for k, v in part.items()})
    return sd


def _pad_vocab(weight: torch.Tensor, target: int) -> torch.Tensor:
    """Pad new vocab rows with the mean embedding (numpy's fp32 mean, as
    the JAX package takes it)."""
    cur = weight.shape[0]
    if cur >= target:
        return weight[:target]
    mean = weight.float().numpy().mean(axis=0, keepdims=True)
    pad = torch.from_numpy(np.repeat(mean, target - cur, axis=0))
    return torch.cat([weight, pad.to(weight.dtype)], dim=0)


def convert_llava_state_dict(sd: Dict[str, torch.Tensor], cfg,
                             params: Optional[dict] = None,
                             sam2_no_mem_embed=None) -> dict:
    """Convert a full reference state dict; components missing from the
    checkpoint come from `params` (e.g. no seg head at stage 2 -> 3).

    sam2_no_mem_embed: the SAM2 backbone checkpoint's no_mem_embed, which
    a saved reference checkpoint with a seg head does not hold."""
    from video_llava_seg_torch.convert.hf_clip import convert_clip_vision
    from video_llava_seg_torch.convert.hf_llama import convert_llama
    from video_llava_seg_torch.models import projector as proj_mod
    from video_llava_seg_torch.models import seg_head as seg_mod

    out = dict(params) if params is not None else {}

    llm_sd = {k: v for k, v in sd.items()
              if k.startswith(("model.layers", "model.embed_tokens",
                               "model.norm", "lm_head"))}
    if llm_sd:
        for key in ("model.embed_tokens.weight", "lm_head.weight"):
            if key in llm_sd:
                llm_sd[key] = _pad_vocab(llm_sd[key], cfg.llm.vocab_size)
        out["llm"] = convert_llama(llm_sd, cfg.llm)

    vt_base = "model.vision_tower.vision_tower."
    if any(k.startswith(vt_base + "vision_model.") for k in sd):
        vt_sd = {k[len(vt_base):]: v for k, v in sd.items()
                 if k.startswith(vt_base + "vision_model.")}
        out["vision_tower"] = convert_clip_vision(vt_sd,
                                                  cfg.vision.num_layers)
    elif any(k.startswith(vt_base + "radio_model.") for k in sd):
        from video_llava_seg_torch.convert.radio import convert_radio

        vt_sd = {k[len(vt_base):]: v for k, v in sd.items()
                 if k.startswith(vt_base + "radio_model.")}
        out["vision_tower"] = convert_radio(vt_sd, cfg.vision)

    if any(k.startswith("model.mm_projector.") for k in sd):
        proj_sd = {k[len("model.mm_projector."):]: v for k, v in sd.items()
                   if k.startswith("model.mm_projector.")}
        out["mm_projector"] = proj_mod.convert_torch(proj_sd, cfg.projector)

    if cfg.seg is not None and any(k.startswith("model.seg_head.")
                                   for k in sd):
        seg_sd = {k[len("model.seg_head."):]: v for k, v in sd.items()
                  if k.startswith("model.seg_head.")}
        out["seg_head"] = seg_mod.convert_torch(
            seg_sd, cfg.seg, seg_mod.make_sam2_cfg(cfg.seg),
            no_mem_embed=sam2_no_mem_embed)
    return out


def load_llava_weights(model_dir: str, cfg, params: Optional[dict] = None,
                       sam2_ckpt: Optional[str] = None) -> dict:
    """sam2_ckpt: the SAM2 backbone .pt checkpoint, which supplies the
    seg head's no_mem_embed."""
    no_mem = None
    if sam2_ckpt is not None:
        ck = torch.load(sam2_ckpt, map_location="cpu", weights_only=True)
        no_mem = ck.get("model", ck)["no_mem_embed"].float()
    return convert_llava_state_dict(load_torch_shards(model_dir), cfg,
                                    params, sam2_no_mem_embed=no_mem)
