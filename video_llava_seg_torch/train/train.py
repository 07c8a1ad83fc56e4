"""Training entry point (port of `video_llava_seg_tpu/train/train.py`).

    python -m video_llava_seg_torch.train.train --stage stage3 --synthetic \\
        --bits 8 --lora_enable [--tiny] [--device cuda|cpu] ...

    python -m video_llava_seg_torch.train.train --stage stage3 \
        --dataset vicas --tokenizer <local dir with tokenizer.json> ...

Same flags, stage presets and LLM-family presets as the JAX CLI, plus
`--device` (default `cuda`; the tests pass `cpu`). The dataset path is
the JAX CLI's: `data/collate.make_supervised_data_module`, the
length-grouped sampler (or a seeded permutation), then a prefetcher that
stays two batches ahead on `--device` (`data/prefetch.py`: pinned
memory, copies on a side CUDA stream). `--tokenizer` is a local
directory read by the port's own tokenizer (`tokenizer.py`); a family
preset's hub id is refused, nothing is downloaded. Decoding an mp4 / the
GT JPEGs needs OpenCV / PIL on the host; `train()` and `main()` take
other decoders as `readers`.

Data parallel and FSDP, under torchrun (one process a card):

    torchrun --nproc_per_node N -m video_llava_seg_torch.train.train \
        --stage stage3 --synthetic --bits 8 --lora_enable [--fsdp] ...

The global batch is `per_device_batch_size` x N; each rank collates,
prefetches and runs its own rows, and its gradients are summed over the
ranks (`parallel/fsdp.py`); `--fsdp` shards the parameters and the Adam
state at rest. `--dist_backend gloo --device cuda:0` lets ranks share
one card (NCCL refuses that).

Tensor-parallel training, on a data x model mesh of N = dp x mp ranks:

    torchrun --nproc_per_node N -m video_llava_seg_torch.train.train \
        --model_parallel MP [--fsdp] ...

The mp ranks of a data row (rank = d * mp + m) run the same rows
(`per_device_batch_size` x dp in the global batch) with the LLM split
over them (`parallel/tensor_parallel.py`: local heads, MLP and vocabulary
columns; LoRA split with its dense), the tower, projector and seg head
whole; `--fsdp` cuts each leaf's 'model' block over 'data' as well. MP
must divide the LLM's query and KV heads, MLP width and vocabulary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from video_llava_seg_torch.bridge import cast_tree
from video_llava_seg_torch.config import (
    DataConfig,
    MeshConfig,
    OptimGroupLRs,
    TrainConfig,
    VideoLlavaConfig,
    to_json,
)
from video_llava_seg_torch.constants import (
    IMAGE_TOKEN_INDEX,
    SLOW_FAST_SEPARATOR_TOKEN,
    VIDEO_SEG_TOKEN,
)
from video_llava_seg_torch.models import llama, llava
from video_llava_seg_torch.train.train_step import (
    batch_to_device,
    create_train_state,
    make_train_step,
)
from video_llava_seg_torch.train.trainer import (
    save_projector_only,
    train_loop,
)


def initialize_vision_tokenizer(tokenizer, cfg, with_seg: bool = True):
    """Add the special tokens and capture their ids. Returns the updated
    cfg (seg / slow-fast separator token ids).

    Raises ValueError where an added id falls outside the LLM's
    embedding (`cfg.llm.vocab_size`): neither package resizes it (the
    reference does), and on the card an out-of-range id would trip a
    device-side assert in the embedding gather and the loss."""
    added = []
    if cfg.num_slow_frames != cfg.num_frames:
        added.append(SLOW_FAST_SEPARATOR_TOKEN)
    if with_seg and cfg.seg is not None:
        added.append(VIDEO_SEG_TOKEN)
    if added:
        tokenizer.add_tokens(added, special_tokens=True)
    updates = {}
    if cfg.num_slow_frames != cfg.num_frames:
        updates["sf_separator_token_idx"] = tokenizer.convert_tokens_to_ids(
            SLOW_FAST_SEPARATOR_TOKEN)
    if with_seg and cfg.seg is not None:
        updates["seg_token_idx"] = tokenizer.convert_tokens_to_ids(
            VIDEO_SEG_TOKEN)
    for name, tid in updates.items():
        if tid is None or not 0 <= tid < cfg.llm.vocab_size:
            raise ValueError(
                f"initialize_vision_tokenizer: {name} = {tid} lies outside "
                f"the LLM's {cfg.llm.vocab_size} embeddings (the tokenizer "
                f"holds {len(tokenizer)} tokens); the embedding is not "
                "resized, so give a tokenizer whose added tokens fit")
    return dataclasses.replace(cfg, **updates)


#: config fields that must agree across training stages (hard error), and
#: fields that only warn
_CONSISTENCY_ASSERT = ("vision.name", "vision.image_size",
                       "projector.projector_type",
                       "projector.mm_hidden_size", "llm.hidden_size",
                       "num_frames", "num_slow_frames")
_CONSISTENCY_WARN = ("seg_token_idx", "tokenizer_model_max_length")


def _cfg_get(cfg, dotted: str):
    obj = cfg
    for part in dotted.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def verify_config_consistency(cfg, restore_dir: str):
    """Raise / warn where the restored stage's config.json differs from
    the current config. No-op without a config.json or for a torch/HF
    config (its keys do not map one to one)."""
    path = osp.join(restore_dir, "config.json")
    if not osp.exists(path):
        return
    with open(path) as fh:
        raw = json.load(fh)
    if "llm" not in raw:
        return

    def raw_get(dotted):
        obj = raw
        for part in dotted.split("."):
            if not isinstance(obj, dict) or part not in obj:
                return None
            obj = obj[part]
        return obj

    for key in _CONSISTENCY_ASSERT:
        want, got = raw_get(key), _cfg_get(cfg, key)
        if want is not None and got is not None and want != got:
            raise ValueError(
                f"config mismatch vs restored stage: {key}: "
                f"checkpoint={want} current={got}")
    for key in _CONSISTENCY_WARN:
        want, got = raw_get(key), _cfg_get(cfg, key)
        if want is not None and got is not None and want != got:
            print(f"WARN: config field {key} differs from restored stage: "
                  f"checkpoint={want} current={got}")


def synthetic_batches(cfg, batch_size: int,
                      seed: int = 0) -> Iterator[Dict]:
    """Random numpy batches with the collator's schema (the JAX package's
    draws, in the same order)."""
    rng = np.random.RandomState(seed)
    tpi = llava.visual_tokens_per_sample(cfg)
    while True:
        ids = np.concatenate([
            rng.randint(5, 100, (batch_size, 4)),
            np.full((batch_size, len(tpi)), IMAGE_TOKEN_INDEX),
            rng.randint(5, 100, (batch_size, 8)),
        ], axis=1)
        labels = np.where(ids == IMAGE_TOKEN_INDEX, -100, ids)
        if cfg.seg is not None and cfg.seg_token_idx > 0:
            labels[:, -2] = cfg.seg_token_idx
            ids[:, -2] = cfg.seg_token_idx
        plan = llava.build_splice_plan(ids, tpi, labels)
        s = cfg.vision.image_size
        batch = {
            "video": rng.rand(batch_size, cfg.num_frames, s, s,
                              3).astype(np.float32),
            "text_ids": plan.text_ids,
            "gather_idx": plan.gather_idx,
            "position_ids": plan.position_ids,
            "labels": plan.labels,
        }
        if cfg.seg is not None:
            from video_llava_seg_torch.models import seg_head as shm

            ss = shm.make_sam2_cfg(cfg.seg).image_size
            t_cap, n_cap = cfg.seg.max_seg_frames, cfg.seg.max_objects
            batch.update({
                "seg_frames": rng.rand(batch_size, t_cap, ss, ss,
                                       3).astype(np.float32),
                "seg_masks": rng.rand(batch_size, n_cap, t_cap, ss,
                                      ss) > 0.7,
                "seg_valid": np.ones((batch_size, n_cap), bool),
                "seg_frame_valid": np.ones((batch_size, t_cap), bool),
                "seg_padding": np.zeros((batch_size, 4), np.int32),
                "seg_token_pos": np.full((batch_size, n_cap),
                                         plan.seq_lens[0] - 3, np.int32),
                "has_masks": np.ones((batch_size,), bool),
            })
        yield batch


def init_params(cfg, tcfg, device, restore_weights: Optional[str] = None):
    """The training state's parameters on `device`.

    On the CPU every leaf is fp32, as the JAX CLI's `train()` has it. On
    the card the state follows the JAX package's one-chip QLoRA
    measurement instead: with `bits` the LLM is built by
    `llama.init_quantized(bits=8, train_mode=True)` (int8 kernels, bf16
    scales, a bf16 embedding and norms); every other leaf (tower,
    projector, seg head, LoRA, and a float LLM) is an fp32 master, cast
    to bf16 at use, and the video and seg frames come in bf16, so every
    kernel sees bf16. (The JAX CLI keeps fp32 parameters, whose fp32
    embedding makes the LLM run fp32 activations; the port's kernels
    take bf16, and bf16 parameters would round away the tower's and seg
    encoder's ~2e-6 updates.)"""
    from video_llava_seg_torch.ops.quantization import quantize_tree

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(tcfg.seed)
    on_card = dev.type == "cuda"
    if tcfg.bits:
        if not (tcfg.freeze_llm or tcfg.lora_enable):
            raise ValueError("bits requires freeze_llm or lora_enable "
                             "(the quantized base cannot take grads)")
        if tcfg.bits != 8:
            raise ValueError("training supports weight-only int8 only "
                             "(int4 / W8A8 activation rounding has zero "
                             "gradient; those paths are serving-only)")
    if on_card and tcfg.bits and not restore_weights:
        from video_llava_seg_torch.models import projector, seg_head, vit

        params = {
            "llm": llama.init_quantized(cfg.llm, g, dev, torch.bfloat16,
                                        bits=8, train_mode=True),
            "vision_tower": vit.init(cfg.vision, g, dev, torch.float32),
            "mm_projector": projector.init(cfg.projector, g, dev,
                                           torch.float32)}
        if cfg.seg is not None:
            params["seg_head"] = seg_head.init(cfg.seg, cfg.llm.hidden_size,
                                               g, dev, torch.float32)
    else:
        params = llava.init(cfg, g, dev, torch.float32)
        if restore_weights:
            from video_llava_seg_torch.convert.llava_torch import (
                load_llava_weights,
            )
            verify_config_consistency(cfg, restore_weights)
            params = cast_tree(load_llava_weights(restore_weights, cfg,
                                                  params), dev,
                               torch.float32)
        if tcfg.bits:
            params["llm"] = quantize_tree(params["llm"], bits=8,
                                          train_mode=True)
            if on_card:
                params["llm"] = cast_tree(params["llm"], dev, torch.bfloat16)
    if tcfg.lora_enable:
        from video_llava_seg_torch.train import lora as lora_mod

        params["lora"] = lora_mod.init_lora(
            torch.Generator(device=dev).manual_seed(tcfg.seed + 1), params,
            tcfg.lora_rank, lora_mod.target_names(tcfg.lora_qv_proj_only))
    return params


def data_batches(dataset, collator, tcfg, dp_size: int = 1,
                 dp_rank: int = 0) -> Iterator[Dict]:
    """Collated batches for ever: length-grouped (modality mode) where the
    dataset gives `modality_lengths`, else a seeded permutation (the JAX
    CLI's order). The global batch is per_device_batch_size x dp_size
    indices, the same on every rank; rank dp_rank collates its rows
    [r b, (r + 1) b), padded to their own longest."""
    from video_llava_seg_torch.data.sampler import LengthGroupedSampler

    b = tcfg.per_device_batch_size
    bsz = b * dp_size

    def mine(idx):
        return collator([dataset[int(k)]
                         for k in idx[dp_rank * b:(dp_rank + 1) * b]])

    lengths = getattr(dataset, "modality_lengths", None)
    if callable(lengths):
        lengths = lengths()
    if lengths is not None:
        sampler = LengthGroupedSampler(b, dp_size, list(lengths),
                                       seed=tcfg.seed, group_by_modality=True)
        while True:
            buf = []
            for k in sampler:
                buf.append(k)
                if len(buf) == bsz:
                    yield mine(buf)
                    buf = []
    else:
        order = np.random.RandomState(tcfg.seed).permutation(len(dataset))
        i = 0
        while True:
            idx = [order[(i + j) % len(dataset)] for j in range(bsz)]
            i += bsz
            yield mine(idx)


def train(cfg, tcfg, data_args: Optional[DataConfig] = None,
          tokenizer=None, restore_weights: Optional[str] = None,
          synthetic: bool = False, device="cuda",
          readers: Optional[Dict] = None,
          dist_backend: Optional[str] = None):
    """Build the state (`init_params`), the optimizer and the step, then
    run `trainer.train_loop`. Returns the final state.

    Differs from the JAX CLI's `train()` in the state's precision on the
    card: the JAX CLI keeps every parameter in fp32 (its fp32 embedding
    makes the LLM compute in fp32); on the card the port builds the int8
    base with bf16 scales and embedding, keeps fp32 masters for every
    trainable leaf and feeds bf16 frames, so the kernels see bf16 (see
    `init_params`). On the CPU both run fp32 and agree closely.

    Without `synthetic` the batches come from `data_args`' dataset,
    tokenized by `tokenizer` (`make_supervised_data_module`;
    `data_batches`), prefetched onto `device` two ahead. readers: the
    datasets' decoders (`read_clip`, `read_frame`) where OpenCV / PIL are
    not to be used.

    Under torchrun (WORLD_SIZE > 1, or a process group the caller
    joined), or with tcfg.mesh.fsdp or model_parallel > 1, the ranks
    form a data x model mesh (`parallel/fsdp.DataParallel`, backend
    `dist_backend`: NCCL on the card by default, gloo on the CPU); each
    data row of tcfg.mesh.model_parallel ranks runs its rows of the
    global batch of per_device_batch_size x (ranks / model_parallel)."""
    from video_llava_seg_torch.parallel import collectives
    from video_llava_seg_torch.parallel.tensor_parallel import (
        check_divisible,
    )

    mp = tcfg.mesh.model_parallel
    if mp > 1:
        check_divisible(cfg.llm, mp)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: --device cuda but no CUDA device")
    dp = None
    if (tcfg.mesh.fsdp or mp > 1 or collectives.is_initialized()
            or int(os.environ.get("WORLD_SIZE", 1)) > 1):
        from video_llava_seg_torch.parallel.fsdp import DataParallel
        from video_llava_seg_torch.parallel.mesh import create_mesh

        dev = collectives.initialize_distributed(
            dist_backend or ("nccl" if dev.type == "cuda" else "gloo"), dev)
        dp = DataParallel(create_mesh(tcfg.mesh), fsdp=tcfg.mesh.fsdp)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if dev.type == "cuda":
        # a resumed run repeats an uninterrupted one bit for bit only if
        # the convolutions' backward runs deterministic algorithms
        torch.backends.cudnn.deterministic = True
    b = tcfg.per_device_batch_size
    if synthetic:
        data_iter = synthetic_batches(cfg, b * (dp.size if dp else 1),
                                      seed=tcfg.seed)
        prepare = lambda x: batch_to_device(  # noqa: E731
            dp.rows(x, b) if dp else x, dev, dtype)
    else:
        from video_llava_seg_torch.data.collate import (
            make_supervised_data_module,
        )
        from video_llava_seg_torch.data.prefetch import prefetch_to_device

        module = make_supervised_data_module(tokenizer, cfg, data_args,
                                             **(readers or {}))
        data_iter = prefetch_to_device(
            data_batches(module["train_dataset"], module["data_collator"],
                         tcfg, dp.size if dp else 1, dp.rank if dp else 0),
            dev, size=2, dtype=dtype)
        prepare = None
    try:
        params = init_params(cfg, tcfg, dev, restore_weights)
        if dp is not None:
            params = dp.shard(params)
        state, tx = create_train_state(params, tcfg)
        step_fn = make_train_step(cfg, tcfg, tx, dp=dp)
        state = train_loop(state, step_fn, data_iter, tcfg, to_json(cfg),
                           prepare=prepare, dp=dp)
    finally:
        if not synthetic:
            data_iter.close()
    if tcfg.save_projector_only:
        params = state.params if dp is None else dp.full_params(state.params)
        if dp is None or dp.main:
            save_projector_only(tcfg.output_dir, params)
    return state


#: stage presets of the reference launch scripts
#: (scripts/train/llama3/stage{1,2,3}*.sh): dataset, freezes, LRs
STAGE_PRESETS = {
    "stage1": dict(dataset="captions", freeze_llm=True,
                   freeze_vision_tower=True, lrs=dict(projector=1e-3),
                   with_seg=False, save_projector_only=True),
    "stage2": dict(dataset="captions", lrs=dict(llm=2e-5, vision_tower=2e-6,
                                                projector=2e-5),
                   with_seg=False),
    "stage3": dict(dataset="vicas", lrs=dict(llm=2e-5, vision_tower=2e-6,
                                             projector=2e-5,
                                             seg_encoder=2e-6,
                                             seg_decoder=2e-5),
                   with_seg=True),
}

#: LLM family presets (the reference's llama3/ and vicuna/ scripts)
_LLM_FAMILIES = {
    "llama3_8b": dict(tokenizer="meta-llama/Meta-Llama-3-8B-Instruct",
                      conv_template="llava_llama_3", model_max_length=6144),
    "vicuna_7b": dict(tokenizer="lmsys/vicuna-7b-v1.5",
                      conv_template="v1", model_max_length=5824),
}


def build_configs(args):
    """(cfg, tcfg, data_args) from the parsed flags, as the JAX CLI."""
    preset = STAGE_PRESETS.get(args.stage, {})
    with_seg = preset.get("with_seg", True)
    cfg = VideoLlavaConfig.tiny() if args.tiny else VideoLlavaConfig()
    fam = _LLM_FAMILIES[args.llm]
    if not args.tiny and args.llm != "llama3_8b":
        from video_llava_seg_torch.config import LlamaConfig

        cfg = dataclasses.replace(
            cfg, llm=getattr(LlamaConfig, args.llm)(),
            tokenizer_model_max_length=fam["model_max_length"])
    conv_template = args.conv_template or fam["conv_template"]
    if args.model_max_length is not None and not args.tiny:
        cfg = dataclasses.replace(
            cfg, tokenizer_model_max_length=args.model_max_length,
            llm=dataclasses.replace(cfg.llm,
                                    max_seq_len=args.model_max_length))
    if not with_seg and cfg.seg is not None:
        cfg = dataclasses.replace(cfg, seg=None)

    lr_over = dict(preset.get("lrs", {}))
    if args.learning_rate is not None:
        lr_over.update(llm=args.learning_rate, projector=args.learning_rate,
                       seg_decoder=args.learning_rate,
                       lora=args.learning_rate)
    if args.vision_tower_lr is not None:
        lr_over.update(vision_tower=args.vision_tower_lr,
                       seg_encoder=args.vision_tower_lr)
    tcfg = TrainConfig(
        output_dir=args.output_dir, num_train_steps=args.num_train_steps,
        per_device_batch_size=args.per_device_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        save_steps=args.save_steps,
        freeze_llm=preset.get("freeze_llm", False),
        freeze_vision_tower=preset.get("freeze_vision_tower", False),
        save_projector_only=preset.get("save_projector_only", False),
        bits=args.bits,
        lora_enable=args.lora_enable, lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        lrs=OptimGroupLRs(**lr_over),
        mesh=MeshConfig(model_parallel=args.model_parallel,
                        fsdp=args.fsdp))
    # the clip and seg-frame layout follow the model (the JAX CLI keeps
    # DataConfig's full-width defaults, which --tiny cannot take)
    seg_layout = ({} if cfg.seg is None else dict(
        seg_image_size=cfg.seg.image_size,
        max_seg_frames=cfg.seg.max_seg_frames))
    data_args = DataConfig(
        dataset=args.dataset or preset.get("dataset", "vicas"),
        conv_template=conv_template, num_frames=cfg.num_frames,
        num_slow_frames=cfg.num_slow_frames, **seg_layout)
    return cfg, tcfg, data_args


def main(argv=None, readers: Optional[Dict] = None):
    """The CLI. readers: the datasets' decoders, as `train`'s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=sorted(STAGE_PRESETS), default=None,
                    help="training stage preset (reference scripts parity)")
    ap.add_argument("--output_dir", default="output")
    ap.add_argument("--num_train_steps", type=int, default=1000)
    ap.add_argument("--per_device_batch_size", type=int, default=1)
    ap.add_argument("--gradient_accumulation_steps", type=int, default=4)
    ap.add_argument("--model_parallel", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--restore_weights", default=None)
    ap.add_argument("--save_steps", type=int, default=2000)
    ap.add_argument("--bits", type=int, default=None, choices=(8,),
                    help="k-bit training: weight-only int8 LLM base "
                         "(QLoRA with --lora_enable; reference --bits)")
    ap.add_argument("--lora_enable", action="store_true")
    ap.add_argument("--lora_rank", type=int, default=64)
    ap.add_argument("--lora_alpha", type=float, default=16.0)
    ap.add_argument("--learning_rate", type=float, default=None,
                    help="override the LLM/projector peak LR")
    ap.add_argument("--vision_tower_lr", type=float, default=None)
    ap.add_argument("--tokenizer", default=None,
                    help="local directory holding the tokenizer.json "
                         "(required without --synthetic; hub ids are not "
                         "fetched)")
    ap.add_argument("--llm", default="llama3_8b",
                    choices=("llama3_8b", "vicuna_7b"),
                    help="LLM family preset (reference llama3/ and vicuna/ "
                         "script families)")
    ap.add_argument("--conv_template", default=None,
                    help="supervised-preprocess template; defaults per "
                         "--llm (llava_llama_3 / v1)")
    ap.add_argument("--model_max_length", type=int, default=None,
                    help="token budget override (reference: 6144 llama3, "
                         "5824 vicuna)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda: under torchrun "
                         "cuda:LOCAL_RANK; cpu for tests)")
    ap.add_argument("--dist_backend", default=None,
                    help="process-group backend under torchrun (default "
                         "nccl on the card, gloo on the CPU)")
    args = ap.parse_args(argv)
    cfg, tcfg, data_args = build_configs(args)
    tokenizer = None
    if not args.synthetic:
        from video_llava_seg_torch.tokenizer import Tokenizer

        path = args.tokenizer or _LLM_FAMILIES[args.llm]["tokenizer"]
        if not osp.isdir(path):
            raise SystemExit(
                f"--tokenizer {path!r} is not a local directory: give the "
                "directory holding the checkpoint's tokenizer.json (the "
                f"--llm {args.llm} preset names the hub id "
                f"{_LLM_FAMILIES[args.llm]['tokenizer']!r}; nothing is "
                "downloaded)")
        tokenizer = Tokenizer.from_pretrained(path)
        cfg = initialize_vision_tokenizer(
            tokenizer, cfg, with_seg=STAGE_PRESETS.get(args.stage, {}).get(
                "with_seg", True))
    return train(cfg, tcfg, data_args, tokenizer,
                 restore_weights=args.restore_weights,
                 synthetic=args.synthetic, device=args.device,
                 readers=readers, dist_backend=args.dist_backend)


if __name__ == "__main__":
    from video_llava_seg_torch.parallel.collectives import shutdown

    main()
    shutdown()
