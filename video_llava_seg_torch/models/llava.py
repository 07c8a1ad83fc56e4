"""Video-LLaVA-Seg multimodal glue, serving path (port of
`video_llava_seg_tpu/models/llava.py`).

vision tower -> projector -> slow/fast token split -> host-planned splice
-> one gather into the LLM embeddings -> greedy, sampled or beam generate
-> [SEG] hidden states -> SAM2 seg head.

`build_splice_plan` and `visual_tokens_per_sample` are numpy copies of
the JAX package's (which cannot be imported without JAX); a CPU test
holds them equal to the originals.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from video_llava_seg_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from video_llava_seg_torch.models import llama, projector, seg_head, vit
from video_llava_seg_torch.ops.pooling import adaptive_avg_pool_2d
from video_llava_seg_torch.timing import stage


def init(cfg, g: torch.Generator, device, dtype):
    p = {
        "llm": llama.init(cfg.llm, g, device, dtype),
        "vision_tower": vit.init(cfg.vision, g, device, dtype),
        "mm_projector": projector.init(cfg.projector, g, device, dtype),
    }
    if cfg.seg is not None:
        p["seg_head"] = seg_head.init(cfg.seg, cfg.llm.hidden_size, g,
                                      device, dtype)
    return p


# ---------------------------------------------------------------------------
# video encoding: slow/fast token scheme
# ---------------------------------------------------------------------------

def encode_video(params, cfg, video: torch.Tensor):
    """video [B, T, H, W, 3] normalised -> (slow [B, Ts, N, D],
    fast [B, T, p*p, D] or None). An S2 tower (`cfg.vision.s2_scales`)
    takes the video at its largest scale."""
    tower = vit.apply_s2 if cfg.vision.s2_enabled else vit.apply
    feats = tower(params["vision_tower"], cfg.vision, video)
    feats = projector.apply(params["mm_projector"], feats)
    t = feats.shape[1]
    if cfg.num_slow_frames == cfg.num_frames:
        return feats, None
    frame_ids = np.linspace(0, t - 1, cfg.num_slow_frames).astype(np.int32)
    slow = feats[:, torch.from_numpy(frame_ids).long().to(feats.device)]
    side = int(round(np.sqrt(feats.shape[2])))
    grid = feats.reshape(*feats.shape[:2], side, side, feats.shape[-1])
    fast = adaptive_avg_pool_2d(grid, (cfg.fast_pool_size,
                                       cfg.fast_pool_size))
    fast = fast.reshape(*feats.shape[:2], cfg.fast_pool_size ** 2,
                        feats.shape[-1])
    return slow, fast


def visual_tokens_per_sample(cfg) -> List[int]:
    """Token count per <image> sentinel: slow frames then fast frames."""
    if cfg.num_slow_frames != cfg.num_frames:
        return ([cfg.tokens_per_slow_frame] * cfg.num_slow_frames
                + [cfg.tokens_per_fast_frame] * cfg.num_frames)
    return [cfg.tokens_per_slow_frame] * cfg.num_frames


def flatten_visual_features(slow, fast):
    """[B, Ts, N, D] + [B, T, n, D] -> [B, Nvis, D] in splice order."""
    b = slow.shape[0]
    parts = [slow.reshape(b, -1, slow.shape[-1])]
    if fast is not None:
        parts.append(fast.reshape(b, -1, fast.shape[-1]))
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# splice planning (host numpy) + device assembly
# ---------------------------------------------------------------------------

class SplicePlan(NamedTuple):
    text_ids: np.ndarray      # [B, S_text] sentinel-free ids (0 at sentinels)
    gather_idx: np.ndarray    # [B, L] index into concat(text, visual)
    is_visual: np.ndarray     # [B, L] bool
    labels: np.ndarray        # [B, L] (IGNORE at visual + pad positions)
    attn_mask: np.ndarray     # [B, L] bool
    position_ids: np.ndarray  # [B, L]
    seq_lens: np.ndarray      # [B]


def build_splice_plan(input_ids: np.ndarray,
                      tokens_per_image: List[int],
                      labels: Optional[np.ndarray] = None,
                      max_length: Optional[int] = None,
                      pad_to: Optional[int] = None,
                      pad_side: str = "right",
                      input_lens: Optional[np.ndarray] = None) -> SplicePlan:
    """Plan the multimodal splice for a padded batch (numpy copy of the
    JAX package's planner; see its docstring for the contract)."""
    b, s = input_ids.shape
    rows = []
    for bi in range(b):
        row_len = s if input_lens is None else int(input_lens[bi])
        ids = input_ids[bi, :row_len]
        lbl = (labels[bi, :row_len] if labels is not None
               else np.full_like(ids, IGNORE_INDEX))
        img_pos = np.flatnonzero(ids == IMAGE_TOKEN_INDEX)
        gather, vis, lab = [], [], []
        vis_off = 0
        prev = 0
        for n_img, pos in enumerate(img_pos):
            for j in range(prev, pos):
                gather.append(j)
                vis.append(False)
                lab.append(lbl[j])
            count = tokens_per_image[n_img]
            for j in range(count):
                gather.append(s + vis_off + j)
                vis.append(True)
                lab.append(IGNORE_INDEX)
            vis_off += count
            prev = pos + 1
        for j in range(prev, row_len):
            gather.append(j)
            vis.append(False)
            lab.append(lbl[j])
        if len(img_pos) not in (0, len(tokens_per_image)):
            raise ValueError(f"expected 0 or {len(tokens_per_image)} image "
                             f"sentinels, got {len(img_pos)}")
        rows.append((np.asarray(gather, np.int32),
                     np.asarray(vis, bool), np.asarray(lab, np.int64)))

    lens = np.asarray([len(r[0]) for r in rows])
    max_len = int(lens.max())
    if max_length is not None and max_len > max_length:
        max_len = max_length
    if pad_to is not None:
        max_len = max(max_len, pad_to)

    gather_idx = np.zeros((b, max_len), np.int32)
    is_visual = np.zeros((b, max_len), bool)
    out_labels = np.full((b, max_len), IGNORE_INDEX, np.int64)
    attn = np.zeros((b, max_len), bool)
    position_ids = np.zeros((b, max_len), np.int32)
    seq_lens = np.zeros((b,), np.int32)
    if pad_side not in ("right", "left"):
        raise ValueError(pad_side)
    for bi, (g, v, l) in enumerate(rows):
        n = min(len(g), max_len)
        sl = slice(max_len - n, None) if pad_side == "left" else slice(0, n)
        gather_idx[bi, sl] = g[:n]
        is_visual[bi, sl] = v[:n]
        out_labels[bi, sl] = l[:n]
        attn[bi, sl] = True
        position_ids[bi, sl] = np.arange(n)
        seq_lens[bi] = n

    text_ids = np.where(input_ids == IMAGE_TOKEN_INDEX, 0, input_ids)
    text_ids = np.where(text_ids < 0, 0, text_ids)
    return SplicePlan(text_ids.astype(np.int32), gather_idx, is_visual,
                      out_labels, attn, position_ids, seq_lens)


def assemble_embeds(params, text_ids: torch.Tensor, gather_idx: torch.Tensor,
                    visual_flat: torch.Tensor) -> torch.Tensor:
    """One gather from concat(text_embeds, visual): [B, L, D]."""
    text_embeds = llama.embed(params["llm"], text_ids)
    source = torch.cat([text_embeds, visual_flat.to(text_embeds.dtype)],
                       dim=1)
    idx = gather_idx.long()[..., None].expand(-1, -1, source.shape[-1])
    return torch.gather(source, 1, idx)


# ---------------------------------------------------------------------------
# forward (training), generate and the seg head
# ---------------------------------------------------------------------------

def forward(params, cfg, video: torch.Tensor, plan: Dict,
            remat: bool = False, return_logits: bool = True,
            timings: Optional[Dict[str, float]] = None, layer_hook=None):
    """Training forward on a spliced batch. video [B, T, H, W, 3]; plan:
    tensors of `build_splice_plan` on the video's device (text_ids,
    gather_idx, position_ids). remat: gradient checkpointing on the LLM
    blocks; layer_hook: `llama.forward`'s (FSDP's per-layer gather).
    Returns (logits fp32 | None, post-norm hidden [B, L, D])."""
    dev = video.device
    with stage(timings, "vision", dev):
        slow, fast = encode_video(params, cfg, video)
        visual = flatten_visual_features(slow, fast)
        # the LLM computes in the video's dtype (bf16 on the card, under
        # fp32 masters); a no-op where the embedding has that dtype
        embeds = assemble_embeds(params, plan["text_ids"].long(),
                                 plan["gather_idx"], visual).to(video.dtype)
    with stage(timings, "llm_forward", dev):
        return llama.forward(params["llm"], cfg.llm, embeds,
                             plan["position_ids"], remat=remat,
                             return_logits=return_logits,
                             layer_hook=layer_hook)


def embed_prompts(params, cfg, input_ids: np.ndarray, video: torch.Tensor,
                  pad_side: str = "right",
                  input_lens: Optional[np.ndarray] = None,
                  timings: Optional[Dict[str, float]] = None):
    """The LLM's input: splice plan, video encode and one gather.
    Returns (embeds [B, L, D], left-pad counts [B] numpy or None)."""
    plan = build_splice_plan(np.asarray(input_ids),
                             visual_tokens_per_sample(cfg),
                             max_length=cfg.tokenizer_model_max_length,
                             pad_side=pad_side, input_lens=input_lens)
    dev = video.device
    b = plan.text_ids.shape[0]
    with stage(timings, "vision", dev):
        slow, fast = encode_video(params, cfg, video)
        visual = flatten_visual_features(slow, fast)
        if visual.shape[0] == 1 and b > 1:
            visual = visual.expand(b, *visual.shape[1:])
        embeds = assemble_embeds(
            params, torch.from_numpy(plan.text_ids).long().to(dev),
            torch.from_numpy(plan.gather_idx).to(dev), visual)
    pad_lens = None
    if pad_side == "left":
        pad_lens = plan.gather_idx.shape[1] - plan.seq_lens
    return embeds, pad_lens


def generate(params, cfg, input_ids: np.ndarray, video: torch.Tensor,
             max_new_tokens: int = 256,
             eos_token_ids: Tuple[int, ...] = (),
             stop_sequences: Tuple[Tuple[int, ...], ...] = (),
             pad_side: str = "right",
             input_lens: Optional[np.ndarray] = None,
             temperature: float = 0.0, top_p=None,
             generator: Optional[torch.Generator] = None,
             num_beams: int = 1, length_penalty: float = 1.0,
             timings: Optional[Dict[str, float]] = None):
    """Caption generation, batch-native: greedy by default, sampled at
    temperature > 0 (top_p nucleus, draws from `generator`: see
    `llama.greedy_generate`), beam search at num_beams > 1
    (`llama.beam_generate`, batch 1 only; sampling and beams are
    exclusive, a ValueError either way, as in the JAX package).

    input_ids: [B, S] numpy with IMAGE_TOKEN_INDEX sentinels; ragged
    prompts give their lengths in `input_lens` and batch with
    pad_side='left' (pad keys masked in prefill and decode, rows stop
    one by one). video: [B, T, H, W, 3] normalised on the model's device,
    or [1, T, H, W, 3] with B > 1 prompts: the clip is then encoded once
    and its visual tokens serve every row (several queries about one
    clip, --batch_queries).
    Returns (tokens [B, max_new], hidden [B, max_new, D], n_generated)."""
    if num_beams > 1:
        if temperature:
            raise ValueError("beam search and sampling are exclusive "
                             "(HF beam-sample is not supported)")
        if np.asarray(input_ids).shape[0] != 1:
            raise ValueError("beam search serves one prompt at a time")
    embeds, pad_lens = embed_prompts(params, cfg, input_ids, video,
                                     pad_side, input_lens, timings)
    kw = dict(max_new_tokens=max_new_tokens,
              eos_token_ids=tuple(eos_token_ids),
              stop_sequences=tuple(stop_sequences), timings=timings)
    if num_beams > 1:
        return llama.beam_generate(params["llm"], cfg.llm, embeds,
                                   num_beams=num_beams,
                                   length_penalty=length_penalty, **kw)
    return llama.greedy_generate(params["llm"], cfg.llm, embeds,
                                 pad_lens=pad_lens, temperature=temperature,
                                 top_p=top_p, generator=generator, **kw)


def extract_seg_hidden(tokens, hidden, seg_token_idx: int, n_generated: int,
                       fallback_first: bool = False) -> torch.Tensor:
    """Hidden states at the positions that emitted [SEG] -> [N_seg, D].

    fallback_first: with no [SEG] emitted, treat the token at index 0 as
    the seg token (the reference's inference behaviour), so a referral
    query always yields a mask."""
    toks = tokens[0, :n_generated]
    hid = hidden[0, :n_generated]
    sel = toks == seg_token_idx
    if fallback_first and not bool(sel.any()) and n_generated > 0:
        print(f"WARN: No seg token found in output. Assuming that token at "
              f"index 0 with ID {int(toks[0])} is the seg token")
        sel = torch.zeros_like(sel)
        sel[0] = True
    return hid[sel]


def forward_seg_head_inference(params, cfg, tokens, hidden,
                               n_generated: int,
                               seg_frames: List[torch.Tensor],
                               seg_meta: List[Dict[str, Any]],
                               timings: Optional[Dict[str, float]] = None):
    """Seg head on the [SEG] hidden states. seg_frames: list of
    [T, H, W, 3] in [0, 1]. Returns a list of [N, T, H', W'] mask logits,
    or None when nothing was generated."""
    seg_hidden = extract_seg_hidden(tokens, hidden, cfg.seg_token_idx,
                                    n_generated, fallback_first=True)
    if seg_hidden.shape[0] == 0:
        return None
    sam2_cfg = seg_head.make_sam2_cfg(cfg.seg)
    return seg_head.forward(params["seg_head"], cfg.seg, sam2_cfg,
                            seg_frames, [seg_hidden], seg_meta,
                            resize_to_original_dims=True, timings=timings)
