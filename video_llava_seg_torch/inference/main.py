"""ViCaS caption + referral-mask serving (port of
`video_llava_seg_tpu/inference/main.py`).

Same flags, same resume-by-output-JSON behaviour and the same output
schema {video_id, pred_caption, pred_lgvis_masks: [[{filename,
mask_rles}]]} as the JAX CLI:

    python -m video_llava_seg_torch.inference.main -i <checkpoint dir> \
        -o <out dir> [--load_4bit | --load_8bit] [--kv_cache_int8] \
        [--fuse_qkv] [--batch_queries N] [--temperature T [--top_p P] |
        --num_beams K] [--device cuda|cpu]

Greedy by default; --temperature > 0 samples (nucleus --top_p), one
generator a video seeded from its video_id, so a resumed run reproduces
its samples; --num_beams > 1 runs HF-exact beam search, one query at a
time. `inference/eval.py` scores the output JSONs.

Entry points:
- `get_model_output_frames`: one query over one clip, uint8 frames in,
  caption text and [N, T, H, W] mask logits out, everything on the
  model's device;
- `get_model_output_batched`: several queries about one clip in one
  ragged left-padded generate (--batch_queries; the clip is encoded
  once);
- `get_model_output`: decodes the mp4, then `get_model_output_frames`;
- `load_model`: a checkpoint directory -> (params, cfg, tokenizer) on
  the card (or the device the caller asks for): a reference torch
  checkpoint, or a `checkpoint-<step>/` of the port's trainer
  (`state.pt`, its LoRA adapters merged); `prepare_params` does the
  merge, the --load_8bit / --load_4bit gates (the LLM only) and the cast
  for a params dict already in memory.

mp4 / JPEG decoding, the dataset paths and the RLE codec are the port's
own copies (`data/video_io.py`, `inference/video_fetcher.py`,
`paths.py`, `ops/masks.py`), imported where they are used, so the
frames-level entry points need none of them.

A checkpoint with a RADIO tower (`radio_model.*` keys) serves like a CLIP
one when its `config.json` holds the package's config tree with the
RADIO vision config (`VisionTowerConfig.radio()`: is_radio, one register
token, final norm) and a projector of `mm_hidden_size` 1280.

Tensor-parallel serving over N cards, one process a card, the tower,
projector and seg head replicated on every rank and the LLM split
Megatron-style (`parallel/tensor_parallel.py`):

    torchrun --nproc_per_node N -m video_llava_seg_torch.inference.main \
        -i <checkpoint dir> -o <out dir> --model_parallel N [--load_4bit]

Every rank chooses the same tokens; rank 0 alone prints and writes the
JSONs. `--dist_backend gloo --device cuda:0` lets ranks share one card
(NCCL refuses that). --fuse_qkv is refused with N > 1, as in the JAX CLI.

Refused with NotImplementedError: orbax checkpoints (the JAX package's
format; the machine with the card has no JAX).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import os.path as osp
from glob import glob
from typing import Any, Dict, Optional

import numpy as np
import torch

from video_llava_seg_torch import conversation as conversation_lib
from video_llava_seg_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    SLOW_FAST_SEPARATOR_TOKEN,
)
from video_llava_seg_torch.inference.utils import (
    clip_preprocess_frames,
    preprocess_seg_inputs,
)
from video_llava_seg_torch.mm_utils import tokenizer_image_token
from video_llava_seg_torch.models import llava
from video_llava_seg_torch.paths import Paths
from video_llava_seg_torch.timing import stage

CAPTION_PROMPT = ("\nDescribe what is happening in the video in detail. "
                  "Talk about the events, the main objects/actors and also "
                  "briefly describe the background scene.")


def split_list(lst, n):
    chunk = math.ceil(len(lst) / n)
    return [lst[i:i + chunk] for i in range(0, len(lst), chunk)]


def get_chunk(lst, n, k):
    chunks = split_list(lst, n)
    return chunks[k] if k < len(chunks) else []


def get_video_list(gt_dir, version, split, output_dir, overwrite, chunk_idx,
                   num_chunks):
    with open(Paths.vicas_split_json(split, version)) as fh:
        split_ids = json.load(fh)
    split_ids = set(get_chunk(sorted(split_ids), num_chunks, chunk_idx))
    completed = {int(osp.split(f)[-1].replace(".json", ""))
                 for f in glob(osp.join(output_dir, "*.json"))}
    ret = []
    for f in sorted(glob(osp.join(gt_dir, "*.json"))):
        vid = int(osp.split(f)[-1].replace(".json", ""))
        if vid not in split_ids:
            continue
        split_ids.remove(vid)
        if vid in completed and not overwrite:
            continue
        ret.append(f)
    if split_ids:
        raise FileNotFoundError(
            f"No JSON file found for videos: {sorted(split_ids)}")
    return ret


def prepare_params(params, load_bits: Optional[int] = None, device="cuda",
                   dtype=torch.bfloat16):
    """A params dict made ready to serve, in the JAX package's
    `load_model` order: its `lora` subtree popped and merged
    (`train.lora.merge_into`: float kernels absorb the delta, a QLoRA
    int8 base keeps its adapters attached, which `nn.dense` applies);
    load_bits 8 / 4 quantizing the LLM (`quantize_tree` leaves quantized
    kernels as they are); then every float leaf but the fp32 scales cast
    to `dtype` on `device`. Every leaf is detached first, so a training
    state's trainable leaves serve without autograd recording (and
    keeping) the activations. The caller's dict is left as it is."""
    from video_llava_seg_torch.bridge import cast_tree, tree_map
    from video_llava_seg_torch.ops.quantization import quantize_tree
    from video_llava_seg_torch.train.lora import merge_into

    params = tree_map(torch.Tensor.detach, params)
    adapters = params.pop("lora", None)
    if adapters is not None:
        params = merge_into(params, adapters)
    if load_bits is not None:
        params["llm"] = quantize_tree(params["llm"], load_bits,
                                      act_quant=load_bits == 4)
    return cast_tree(params, device, dtype)


def load_model(model_path: str, cfg=None, load_bits: Optional[int] = None,
               device="cuda", dtype=torch.bfloat16):
    """(params, cfg, tokenizer) from a checkpoint directory: a
    `checkpoint-<step>/` of the port's trainer (`state.pt`, read with
    `weights_only=True`, and the config.json beside it), or a reference
    torch checkpoint (*.safetensors or pytorch_model*.bin, plus
    config.json). Then `prepare_params`.

    load_bits 8 stores the LLM's dense kernels as weight-only int8, 4 as
    W4A8 (packed int4, int8 activations, K5 on the card); the tower, the
    projector and the seg head stay float, as in the JAX package. The
    tokenizer is the port's own (`tokenizer.py`, no `transformers`) read
    from the directory's tokenizer.json on any device, None where the
    directory holds none (the port's trainer writes none into its
    checkpoints); a directory with only a SentencePiece tokenizer.model is
    refused."""
    from video_llava_seg_torch.config import (
        LlamaConfig,
        ProjectorConfig,
        SegHeadConfig,
        VideoLlavaConfig,
        VisionTowerConfig,
    )
    from video_llava_seg_torch.convert.llava_torch import load_llava_weights
    from video_llava_seg_torch.train.trainer import STATE_FILE

    cfg_path = osp.join(model_path, "config.json")
    if cfg is None and osp.exists(cfg_path):
        with open(cfg_path) as fh:
            raw = json.load(fh)
        if "llm" in raw:  # the packages' own config tree
            cfg = VideoLlavaConfig(
                llm=LlamaConfig(**raw["llm"]),
                vision=VisionTowerConfig(**{
                    **raw["vision"],
                    "s2_scales": tuple(raw["vision"].get("s2_scales", ()))}),
                projector=ProjectorConfig(**raw["projector"]),
                seg=SegHeadConfig(**raw["seg"]) if raw.get("seg") else None,
                **{k: v for k, v in raw.items()
                   if k not in ("llm", "vision", "projector", "seg",
                                "dtype")})
    cfg = cfg or VideoLlavaConfig()

    tokenizer = None
    if any(osp.isfile(osp.join(model_path, f))
           for f in ("tokenizer.json", "tokenizer.model")):
        # a tokenizer.model alone (SentencePiece) is refused with a message
        from video_llava_seg_torch.tokenizer import Tokenizer

        tokenizer = Tokenizer.from_pretrained(model_path)

    state_path = osp.join(model_path, STATE_FILE)
    if osp.exists(state_path):
        params = torch.load(state_path, map_location="cpu",
                            weights_only=True)["params"]
    elif osp.isdir(osp.join(model_path, "state")):
        raise NotImplementedError(
            "orbax checkpoints (the JAX package's format; the machine with "
            "the card has no JAX): serve a checkpoint of the port's trainer "
            f"({STATE_FILE}) or a reference torch checkpoint")
    else:
        params = load_llava_weights(model_path, cfg)
    return prepare_params(params, load_bits, device, dtype), cfg, tokenizer


def build_prompt(cfg, qs: str, conv_template_name: str,
                 use_sf_separator: bool = False) -> str:
    """Video token layout + conversation wrap."""
    if cfg.num_slow_frames == cfg.num_frames:
        vid_tokens = DEFAULT_IMAGE_TOKEN * cfg.num_frames
    else:
        sep = SLOW_FAST_SEPARATOR_TOKEN if use_sf_separator else ""
        vid_tokens = (DEFAULT_IMAGE_TOKEN * cfg.num_slow_frames + sep
                      + DEFAULT_IMAGE_TOKEN * cfg.num_frames)
    conv = conversation_lib.conv_templates[conv_template_name].copy()
    conv.append_message(conv.roles[0], vid_tokens + qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def keyword_stop_sequences(tokenizer, conv_template_name: str):
    """Tokenized stop strings of the template (the reference's
    KeywordsStoppingCriteria, checked on the emitted tokens)."""
    conv = conversation_lib.conv_templates[conv_template_name]
    stop_str = (conv.sep2 if conv.sep_style
                == conversation_lib.SeparatorStyle.TWO else conv.sep)
    if not stop_str:
        return ()
    ids = list(tokenizer(stop_str).input_ids)
    bos = getattr(tokenizer, "bos_token_id", None)
    if bos is not None and ids and ids[0] == bos:
        ids = ids[1:]
    return (tuple(ids),) if ids else ()


def _param_device_dtype(params):
    emb = params["llm"]["embed_tokens"]["embedding"]
    return emb.device, emb.dtype


def get_model_output_frames(params, cfg, tokenizer, frames_u8, qs: str,
                            conv_template_name: str, max_new_tokens: int,
                            seg_frames_u8=None,
                            seg_meta: Optional[Dict[str, Any]] = None,
                            eos_token_ids=(), stop_sequences=(),
                            seg_pad_mode: str = "topleft",
                            temperature: float = 0.0, top_p=None,
                            generator: Optional[torch.Generator] = None,
                            num_beams: int = 1,
                            timings: Optional[Dict[str, float]] = None):
    """One query over one clip.

    frames_u8: uint8 [T, H, W, 3] (numpy or tensor) sampled video frames;
    seg_frames_u8: uint8 [T', H', W', 3] frames to segment (None: caption
    only), with seg_meta holding at least `orig_image_size`.
    temperature / top_p / generator (sampling) and num_beams (beam
    search) go to `llava.generate`.
    Returns (text, mask logits fp32 numpy [N, T', H', W'] or None)."""
    device, dtype = _param_device_dtype(params)
    with stage(timings, "preprocess", device):
        frames = torch.as_tensor(np.asarray(frames_u8)).to(device)
        video = clip_preprocess_frames(frames, cfg.vision.image_size)
        video = video[None].to(dtype)
    prompt = build_prompt(cfg, qs, conv_template_name)
    input_ids = np.asarray(tokenizer_image_token(prompt, tokenizer))[None]
    tokens, hidden, n = llava.generate(
        params, cfg, input_ids, video, max_new_tokens=max_new_tokens,
        eos_token_ids=tuple(eos_token_ids),
        stop_sequences=tuple(stop_sequences), temperature=temperature,
        top_p=top_p, generator=generator, num_beams=num_beams,
        timings=timings)
    out_ids = tokens[0, :n].cpu().numpy()
    text = tokenizer.decode(out_ids, skip_special_tokens=True).strip()

    pred_mask_logits = None
    if seg_frames_u8 is not None:
        with stage(timings, "seg_preprocess", device):
            seg_frames, meta = preprocess_seg_inputs(
                torch.as_tensor(np.asarray(seg_frames_u8)).to(device),
                seg_meta, tgt_size=cfg.seg.image_size if cfg.seg else 1024,
                pad_mode=seg_pad_mode)
        outs = llava.forward_seg_head_inference(
            params, cfg, tokens, hidden, n, [seg_frames.to(dtype)], [meta],
            timings=timings)
        if outs is not None:
            pred_mask_logits = outs[0].float().cpu().numpy()
    return text, pred_mask_logits


def get_model_output(params, cfg, tokenizer, video_bytes, qs: str,
                     conv_template_name: str, max_new_tokens: int, **kwargs):
    """Decode `cfg.num_frames` frames of the mp4, then
    `get_model_output_frames`."""
    from video_llava_seg_torch.data import video_io

    frames = video_io.load_video_uniform(video_bytes, cfg.num_frames)
    return get_model_output_frames(params, cfg, tokenizer, frames, qs,
                                   conv_template_name, max_new_tokens,
                                   **kwargs)


def batch_prompt_ids(cfg, tokenizer, qss, conv_template_name: str):
    """Token ids of several prompts, right-padded with 0 into one
    [B, S] array, and their lengths (`generate` left-pads the spliced
    rows from these)."""
    rows = [np.asarray(tokenizer_image_token(
        build_prompt(cfg, qs, conv_template_name), tokenizer)) for qs in qss]
    lens = np.asarray([len(r) for r in rows])
    ids = np.zeros((len(rows), int(lens.max())), rows[0].dtype)
    for r, row in enumerate(rows):
        ids[r, :len(row)] = row
    return ids, lens


def get_model_output_batched(params, cfg, tokenizer, frames_u8, queries,
                             conv_template_name: str, max_new_tokens: int,
                             seg_frames_u8=None,
                             seg_meta: Optional[Dict[str, Any]] = None,
                             eos_token_ids=(), stop_sequences=(),
                             seg_pad_mode: str = "topleft",
                             temperature: float = 0.0, top_p=None,
                             generator: Optional[torch.Generator] = None,
                             num_beams: int = 1,
                             timings: Optional[Dict[str, float]] = None):
    """Several queries about ONE clip in one ragged, left-padded generate
    (--batch_queries): the clip is preprocessed and encoded once, its
    visual tokens serve every row, rows stop one by one.

    frames_u8: uint8 [T, H, W, 3]; queries: list of (qs, wants_seg);
    seg_frames_u8 / seg_meta and the sampling / beam arguments as in
    `get_model_output_frames` (beams take one query).
    Returns a list of (text, mask logits fp32 numpy [N, T', H', W'] or
    None), one per query."""
    device, dtype = _param_device_dtype(params)
    with stage(timings, "preprocess", device):
        frames = torch.as_tensor(np.asarray(frames_u8)).to(device)
        video = clip_preprocess_frames(frames, cfg.vision.image_size)
        video = video[None].to(dtype)
    ids, lens = batch_prompt_ids(cfg, tokenizer, [qs for qs, _ in queries],
                                 conv_template_name)
    tokens, hidden, n = llava.generate(
        params, cfg, ids, video, max_new_tokens=max_new_tokens,
        eos_token_ids=tuple(eos_token_ids),
        stop_sequences=tuple(stop_sequences), pad_side="left",
        input_lens=lens, temperature=temperature, top_p=top_p,
        generator=generator, num_beams=num_beams, timings=timings)
    out_ids = tokens[:, :n].cpu().numpy()

    seg_frames = meta = None
    if seg_frames_u8 is not None and any(w for _, w in queries):
        with stage(timings, "seg_preprocess", device):
            seg_frames, meta = preprocess_seg_inputs(
                torch.as_tensor(np.asarray(seg_frames_u8)).to(device),
                seg_meta, tgt_size=cfg.seg.image_size if cfg.seg else 1024,
                pad_mode=seg_pad_mode)
    outs = []
    for r, (_, wants_seg) in enumerate(queries):
        text = tokenizer.decode(out_ids[r], skip_special_tokens=True).strip()
        logits = None
        if wants_seg and seg_frames is not None:
            o = llava.forward_seg_head_inference(
                params, cfg, tokens[r:r + 1], hidden[r:r + 1], n,
                [seg_frames.to(dtype)], [meta], timings=timings)
            if o is not None:
                logits = o[0].float().cpu().numpy()
        outs.append((text, logits))
    return outs


def model_parallel_setup(args, mp: int):
    """Join the process group of `mp` ranks (torchrun's environment) and
    return this rank's device and its mesh ('data' 1 x 'model' mp)."""
    from video_llava_seg_torch.config import MeshConfig
    from video_llava_seg_torch.parallel import collectives
    from video_llava_seg_torch.parallel.mesh import create_mesh

    device = getattr(args, "device", None) or "cuda"
    backend = getattr(args, "dist_backend", None) or (
        "gloo" if torch.device(device).type == "cpu" else "nccl")
    dev = collectives.initialize_distributed(backend, device)
    if collectives.world_size() != mp:
        raise SystemExit(f"--model_parallel {mp} needs {mp} ranks (launch "
                         f"with torchrun --nproc_per_node {mp}); this run "
                         f"has {collectives.world_size()}")
    return dev, create_mesh(MeshConfig(data_parallel=1, model_parallel=mp))


def _absorb(pred, content, seg_meta, idx, text, logits, print_captions):
    """Write one query's answer into the video's prediction dict."""
    from video_llava_seg_torch.ops.masks import encode_rle

    if idx == -1:
        pred["pred_caption"] = text
        if print_captions:
            print(f"Video {content['video_id']}\nPred Caption: {text}\n"
                  f"GT Caption: {content['caption_parsed_en_gpt']}"
                  "\n----------")
    elif logits is not None:
        masks = (logits > 0.0).astype(np.uint8)
        for t in range(masks.shape[1]):
            rles = []
            for track in masks:
                rle = encode_rle(track[t])
                rle["counts"] = rle["counts"].decode("utf-8")
                rles.append(rle)
            pred["pred_lgvis_masks"][idx].append({
                "filename": seg_meta["filenames"][t],
                "mask_rles": rles,
            })


def run_inference(args, model=None, tokenizer=None, fetcher=None):
    """ViCaS inference loop.

    model: (params, cfg, tokenizer) already on the serving device;
    without it the checkpoint at args.model_path is loaded (`load_model`)
    onto `args.device` (default the card, in bf16; "cpu" runs the plain
    versions in fp32). tokenizer: replaces the model's (the one
    `load_model` reads from the checkpoint's tokenizer.json; a checkpoint
    of the port's trainer carries none). fetcher: the source of each clip
    and its ground-truth frames (default `VideoAndFrameFetcher(args)`,
    which decodes with OpenCV and PIL)."""
    nb = int(getattr(args, "num_beams", 1) or 1)
    temp = float(getattr(args, "temperature", 0.0) or 0.0)
    bq = max(1, int(getattr(args, "batch_queries", 1) or 1))
    if nb > 1 and temp > 0.0:
        raise SystemExit("--num_beams > 1 with --temperature > 0 (beam "
                         "sampling) is not supported; pick one")
    if nb > 1 and bq > 1:
        raise SystemExit("--num_beams > 1 serves one prompt at a time; "
                         "drop --batch_queries")
    mp = int(getattr(args, "model_parallel", 1) or 1)
    if mp > 1 and getattr(args, "fuse_qkv", False):
        raise SystemExit("--fuse_qkv is single-chip serving only: the "
                         "TP shard rules target the unfused wq/wk/wv "
                         "names (parallel/mesh.py)")
    mesh = None
    if mp > 1:
        device, mesh = model_parallel_setup(args, mp)
    if model is not None:
        params, cfg, loaded_tok = model
    else:
        if mesh is None:
            device = torch.device(getattr(args, "device", None) or "cuda")
        params, cfg, loaded_tok = load_model(
            args.model_path,
            load_bits=8 if getattr(args, "load_8bit", False)
            else 4 if getattr(args, "load_4bit", False) else None,
            device=device, dtype=torch.bfloat16 if device.type == "cuda"
            else torch.float32)
    tokenizer = tokenizer if tokenizer is not None else loaded_tok
    if getattr(args, "kv_cache_int8", False):
        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, kv_cache_int8=True))
    if getattr(args, "fuse_qkv", False):
        from video_llava_seg_torch.models.llama import fuse_qkv_gateup

        params = dict(params)
        params["llm"] = fuse_qkv_gateup(params["llm"])
    if mesh is None:
        return _serve(args, params, cfg, tokenizer, fetcher)
    from video_llava_seg_torch.parallel.mesh import shard_params
    from video_llava_seg_torch.parallel.tensor_parallel import (
        check_divisible,
        tensor_parallel,
    )

    # the LLM split, the rest replicated (the JAX CLI's layout)
    check_divisible(cfg.llm, mp)
    params = dict(params)
    params["llm"] = shard_params(params["llm"], mesh)
    with tensor_parallel(mesh.groups["model"], mesh.coords["model"], mp):
        return _serve(args, params, cfg, tokenizer, fetcher,
                      main_rank=mesh.rank == 0)


def _serve(args, params, cfg, tokenizer, fetcher, main_rank: bool = True):
    """The loop over the videos of `run_inference`; only the main rank
    prints and writes."""
    from video_llava_seg_torch.data import video_io
    from video_llava_seg_torch.inference.video_fetcher import (
        VideoAndFrameFetcher,
    )

    nb = int(getattr(args, "num_beams", 1) or 1)
    temp = float(getattr(args, "temperature", 0.0) or 0.0)
    bq = max(1, int(getattr(args, "batch_queries", 1) or 1))
    device = _param_device_dtype(params)[0]
    say = print if main_rank else (lambda *a, **k: None)

    fetcher = fetcher or VideoAndFrameFetcher(args)
    gt_dir = args.gt_dir or str(Paths.vicas_annotations_dir(
        args.dataset_version))
    output_dir = args.output_dir or osp.join(
        args.model_path,
        f"inference/ViCaS/pred_{args.dataset_version}_{args.dataset_split}")
    os.makedirs(output_dir, exist_ok=True)
    say(f"Output directory: {output_dir}")

    gt_json_list = get_video_list(gt_dir, args.dataset_version,
                                  args.dataset_split, output_dir,
                                  args.overwrite, args.chunk_idx,
                                  args.num_chunks)
    if not gt_json_list:
        say("No videos to process")
        return

    eos_ids = []
    for tok in ("<|eot_id|>", "<|end_of_text|>", "</s>"):
        try:
            tid = tokenizer.convert_tokens_to_ids(tok)
            if tid is not None and tid >= 0:
                eos_ids.append(tid)
        except Exception:
            pass

    conv_template_name = args.conv_template
    try:
        stop_seqs = keyword_stop_sequences(tokenizer, conv_template_name)
    except Exception:
        stop_seqs = ()
    for json_path in gt_json_list:
        with open(json_path) as fh:
            content = json.load(fh)
        video_id = content["video_id"]
        output_path = osp.join(output_dir, f"{video_id:06d}.json")
        if osp.exists(output_path) and not args.overwrite:
            continue

        video_bytes = fetcher.get_video(content["filename"])
        raw_frames, seg_meta = fetcher.get_frames(content, gt_only=True)
        pred = {"video_id": video_id,
                "pred_lgvis_masks": [[] for _ in
                                     content["object_referrals"]],
                "pred_caption": None}
        sub_indices = ([] if args.skip_captions else [-1]) + (
            [] if args.skip_seg
            else list(range(len(content["object_referrals"]))))

        def query_of(idx):
            if idx == -1:
                return CAPTION_PROMPT, False
            ref = content["object_referrals"][idx]
            return (f"\n{ref['prompt']} Please output the segmentation "
                    "mask."), True

        # sampling mirrors the reference CLI's gate (do_sample iff
        # temperature > 0); the generator is seeded per video, so a
        # resumed run reproduces the same samples
        sample_kwargs = {}
        if temp > 0.0:
            sample_kwargs = {
                "temperature": temp, "top_p": getattr(args, "top_p", None),
                "generator": torch.Generator(device=device).manual_seed(
                    video_id)}
        elif nb > 1:
            sample_kwargs = {"num_beams": nb}
        if bq > 1:
            # one ragged left-padded generate per bq of the video's
            # queries; the clip decodes and encodes once per group
            frames = video_io.load_video_uniform(video_bytes, cfg.num_frames)
            for g in range(0, len(sub_indices), bq):
                group = sub_indices[g:g + bq]
                outs = get_model_output_batched(
                    params, cfg, tokenizer, frames,
                    [query_of(i) for i in group], conv_template_name,
                    args.max_new_tokens, seg_frames_u8=raw_frames,
                    seg_meta=seg_meta, eos_token_ids=eos_ids,
                    stop_sequences=stop_seqs, seg_pad_mode=args.seg_pad_mode,
                    **sample_kwargs)
                for idx, (text, logits) in zip(group, outs):
                    _absorb(pred, content, seg_meta, idx, text, logits,
                            args.print_captions and main_rank)
        else:
            for idx in sub_indices:
                qs, wants_seg = query_of(idx)
                kwargs = ({"seg_frames_u8": raw_frames, "seg_meta": seg_meta,
                           "seg_pad_mode": args.seg_pad_mode}
                          if wants_seg else {})
                text, logits = get_model_output(
                    params, cfg, tokenizer, video_bytes, qs,
                    conv_template_name, args.max_new_tokens,
                    eos_token_ids=eos_ids, stop_sequences=stop_seqs,
                    **kwargs, **sample_kwargs)
                _absorb(pred, content, seg_meta, idx, text, logits,
                        args.print_captions and main_rank)
        if main_rank:
            with open(output_path, "w") as fh:
                json.dump(pred, fh)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", "-i", required=True)
    p.add_argument("--gt_dir", required=False)
    p.add_argument("--output_dir", "-o", required=False)
    p.add_argument("--num_chunks", type=int, default=1)
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--print_captions", action="store_true")
    p.add_argument("--dataset_version", default="v1.0")
    p.add_argument("--dataset_split", default="val")
    p.add_argument("--skip_seg", action="store_true")
    p.add_argument("--skip_captions", action="store_true")
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--conv_template", default="llava_llama_3")
    p.add_argument("--seg_pad_mode", default="topleft")
    p.add_argument("--load_8bit", action="store_true")
    p.add_argument("--load_4bit", action="store_true")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--fuse_qkv", action="store_true")
    p.add_argument("--kv_cache_int8", action="store_true")
    p.add_argument("--batch_queries", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda: under torchrun "
                        "cuda:LOCAL_RANK; cpu for tests)")
    p.add_argument("--dist_backend", default=None,
                   help="process-group backend with --model_parallel > 1 "
                        "(default nccl on the card, gloo on the CPU)")
    return p.parse_args(argv)


if __name__ == "__main__":
    from video_llava_seg_torch.parallel.collectives import shutdown

    run_inference(parse_args())
    shutdown()
