#!/usr/bin/env python3
"""Where the PyTorch port's serving and training time goes, on one
NVIDIA GPU.

    python3 scripts/profile_torch_slice.py [--w4a8 | --train] [--rounds 2]
        [--max_new_tokens 32] [--out DIR]

Builds the full-width model with seeded random weights (as chip_smoke.py
does) and serves `--rounds` rounds of (caption query, referral query):
by default the bf16 tree, one query after the other through
`get_model_output_frames`; with `--w4a8` the quantized batched path (W4A8
LLM with fused qkv / gate-up, int8 KV cache), both queries in one
`get_model_output_batched` call. Reports, for the last round:
per-stage seconds; then one more round under `torch.profiler` with the
device time by kernel name (top 30), the device-busy share of the
profiled window, and (with `--out`) a JSON summary in DIR. (A chrome
trace of a whole round is too large to keep.)

With `--train` it builds the full-width stage-3 QLoRA train state as
chip_smoke.py's train phase does (Llama-3-8B int8 base + fp32 LoRA r=64,
fp32 CLIP-L tower, projector and SAM2.1-hiera-small seg head) and runs
`--rounds` train steps over `synthetic_batches`, then profiles two more
steady steps: per-stage seconds (vision, llm_forward, loss_text, seg,
loss_mask, backward, optimizer), device time by kernel and per stage.

The first round pays one-time costs (cuBLAS/cuDNN heuristics, allocator
growth, the optimizer's state); the later rounds are the steady state.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (tokenizer stand-in and inputs)
from video_llava_seg_torch.config import VideoLlavaConfig  # noqa: E402
from video_llava_seg_torch.inference import main as serve  # noqa: E402
from video_llava_seg_torch.models import llava  # noqa: E402


def serve_round(params, cfg, tok, frames, seg, meta, max_new_tokens,
                batched=False):
    eos = [tok.convert_tokens_to_ids("<|eot_id|>")]
    stops = serve.keyword_stop_sequences(tok, "llava_llama_3")
    queries = (("caption", serve.CAPTION_PROMPT, False),
               ("referral", chip_smoke.REFERRAL, True))
    if batched:
        timings = {}
        t0 = time.perf_counter()
        serve.get_model_output_batched(
            params, cfg, tok, frames, [(qs, w) for _, qs, w in queries],
            "llava_llama_3", max_new_tokens, seg_frames_u8=seg,
            seg_meta=meta, eos_token_ids=eos, stop_sequences=stops,
            timings=timings)
        torch.cuda.synchronize()
        return [("caption+referral", time.perf_counter() - t0, timings)]
    out = []
    for name, qs, wants_seg in queries:
        kw = {"seg_frames_u8": seg, "seg_meta": meta} if wants_seg else {}
        timings = {}
        t0 = time.perf_counter()
        serve.get_model_output_frames(
            params, cfg, tok, frames, qs, "llava_llama_3", max_new_tokens,
            eos_token_ids=eos, stop_sequences=stops, timings=timings, **kw)
        torch.cuda.synchronize()
        out.append((name, time.perf_counter() - t0, timings))
    return out


def train_rounds(cfg, seed, dev):
    """A closure running one full-width train step per call:
    -> (seconds, stage seconds)."""
    from video_llava_seg_torch.train.train import (
        init_params,
        synthetic_batches,
    )
    from video_llava_seg_torch.train.train_step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )
    from video_llava_seg_torch.train.trainer import step_generator

    tcfg = chip_smoke.train_tcfg(seed=seed)
    state, tx = create_train_state(init_params(cfg, tcfg, dev), tcfg)
    timings = {}
    step_fn = make_train_step(cfg, tcfg, tx, timings=timings)
    data = synthetic_batches(cfg, 1, seed=seed)
    box = {"state": state, "step": 0}

    def one():
        batch = batch_to_device(next(data), dev, torch.bfloat16)
        timings.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box["state"], _ = step_fn(box["state"], batch,
                                  step_generator(seed, box["step"]))
        torch.cuda.synchronize()
        box["step"] += 1
        return [("train step", time.perf_counter() - t0, dict(timings))]

    return one


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--max_new_tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for summary.json (optional)")
    ap.add_argument("--w4a8", action="store_true",
                    help="the quantized batched path instead of bf16")
    ap.add_argument("--train", action="store_true",
                    help="the stage-3 QLoRA train step instead of serving")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(VideoLlavaConfig(),
                              seg_token_idx=VideoLlavaConfig().llm.vocab_size
                              - 1)
    if args.train:
        one_round = train_rounds(cfg, args.seed, dev)
        path, profiled_rounds = "train_step", 2
    else:
        if args.w4a8:
            params, cfg = chip_smoke.build_quant_params(cfg, args.seed, dev)
        else:
            params = llava.init(cfg, torch.Generator(device=dev).manual_seed(
                args.seed), dev, torch.bfloat16)
        tok = chip_smoke.SmokeTokenizer(cfg.llm.vocab_size)
        frames, seg, meta = chip_smoke._smoke_inputs(
            args.seed, cfg.num_frames, (480, 854), cfg.seg.max_seg_frames)

        def one_round():
            return serve_round(params, cfg, tok, frames, seg, meta,
                               args.max_new_tokens, args.w4a8)
        path = "w4a8_batched" if args.w4a8 else "bf16"
        profiled_rounds = 1

    rounds = []
    for r in range(args.rounds):
        round_s = 0.0
        for name, total, timings in one_round():
            stages = ", ".join(f"{k} {v:.4f}" for k, v in timings.items())
            print(f"round {r} {name}: {total:.4f} s ({stages})", flush=True)
            rounds.append({"round": r, "name": name, "seconds": total,
                           "stages": timings})
            # the timed calls only (a train round's batch generation and
            # host-to-device copy stay outside)
            round_s += total

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled_rounds):
            one_round()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    round_s *= profiled_rounds
    events = prof.key_averages()
    # device time of the kernels and copies (the "stage/" ranges appear on
    # the device timeline too, spanning idle gaps: leave them out)
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith("stage/"))
    # the profiler slows the host, not the device: the busy share is the
    # device time over the last unprofiled round's timed calls
    print(f"profiled {profiled_rounds} round(s): wall {wall:.4f} s with the "
          f"profiler on; device busy {dev_us / 1e6:.4f} s = "
          f"{dev_us / 1e6 / round_s:.3f} of {profiled_rounds} x the last "
          f"unprofiled round ({round_s:.4f} s)", flush=True)
    # per stage: device time of the kernels that ran inside the stage's
    # range on the device timeline (kernels launched through ctypes have
    # no parent torch op, so host-side attribution would miss them)
    cuda = torch.autograd.DeviceType.CUDA
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type != cuda:
            continue
        tr = (e.time_range.start, e.time_range.end)
        (spans if e.name.startswith("stage/") else kernels).append(
            (e.name, *tr))
    kernels.sort(key=lambda k: k[1])
    per_stage = {}
    inside = set()
    for name, s0, s1 in spans:
        hit = [i for i, (_, k0, _) in enumerate(kernels) if s0 <= k0 < s1]
        inside.update(hit)
        busy = sum(kernels[i][2] - kernels[i][1] for i in hit)
        span, tot = per_stage.get(name, (0.0, 0.0))
        per_stage[name] = (span + s1 - s0, tot + busy)
    # autograd runs the backward's ops on its own thread, whose launches
    # fall outside the main thread's "stage/backward" range: a train
    # step's kernels outside every stage range are its backward
    outside = sum(k1 - k0 for i, (_, k0, k1) in enumerate(kernels)
                  if i not in inside)
    per_stage["outside every stage range"] = (0.0, outside)
    for name, (span, busy) in sorted(per_stage.items(),
                                     key=lambda kv: -kv[1][1]):
        print(f"  {name}: kernels {busy / 1e6:.4f} s of device time in a "
              f"{span / 1e6:.4f} s device span (profiler on)", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=70), flush=True)
    if args.out is None:
        return
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump({"card": smi, "path": path, "rounds": rounds,
                   "profiled_rounds": profiled_rounds,
                   "profiled_wall_s": wall,
                   "unprofiled_rounds_s": round_s,
                   "device_busy_s": dev_us / 1e6,
                   "stage_device_s": {k: v[1] / 1e6
                                      for k, v in per_stage.items()},
                   "kernels_device_s": {
                       e.key: e.self_device_time_total / 1e6
                       for e in sorted(events, key=lambda e:
                                       -e.self_device_time_total)[:30]}},
                  fh)


if __name__ == "__main__":
    main()
