#!/usr/bin/env python3
"""Time one tree's flash-attention forward at head dims 64 / 80 / 96 /
128 and the end-to-end stages it sits in, on one NVIDIA GPU. Run it on
two trees in turns (parent, change, change, parent) to compare them in
one call on one card.

    python3 scripts/time_attention_paths.py [--root DIR] [--seed N]
        [--attention_only | --train] [--out FILE]

--root: a checkout of the repository (default: the one holding this
script) whose `chip_smoke.py` and `video_llava_seg_torch` are imported,
so the same measurement runs on each tree's own code. Prints one JSON
object (also written to --out):
- "attention": `kernels.attention` on the C entry the tree's
  `attention_entry` picks, in ms over 10 launches back to back
  (chip_smoke's `cuda_ms`), at K1's / K8's attention link of CLIP-L
  ([32, 16, 577, 64]) and RADIO-H ([32, 16, 577, 80]), the Hiera trunk's
  global block ([8, 4, 4096, 96]) and K2's Llama-3-8B causal prefill
  ([1, 32, 5196, 128], and [1, 32, 5132, 128] with the logsumexp, the
  train step's);
- "w8a8_encode": chip_smoke's phase 12, the W8A8 and bf16 encodes of
  CLIP-L and RADIO-H (median / min / max of 7 interleaved rounds);
- "trunk": phase 13, the per-op and the K4 Hiera trunk over 8 frames;
- "serving": phase 3, the bf16 caption and referral queries' seconds by
  stage.
--attention_only stops after "attention". --train replaces the
end-to-end stages with the train step's:
- "flash_bwd": the mask decoder's flash backward at the train shape (q
  [64, 8, 4096, 16] as [B, S, H, D] views, 7 keys) through the tree's
  own `_FlashAttention.backward`, on the kernel forward's output and
  logsumexp, in ms over 10 launches back to back and by device time (a
  CUDA graph of the 10, chip_smoke's `graph_ms`);
- "train": phase 8, three stage-3 QLoRA train steps at full width
  (steady seconds of steps 2-3, stage seconds, peak memory).
Each phase asserts its own launch counts, as chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path


def attention_times(cs, dev):
    """{shape: {"entry", "ms"}} of the tree's kernels.attention."""
    import torch

    from video_llava_seg_torch import kernels

    g = torch.Generator(device=dev).manual_seed(0)
    cases = {
        # name: (b, sq, skv, hq, hkv, d, causal, kv_len, with_lse)
        "clip_l_link": (32, 577, 577, 16, 16, 64, False, 577, False),
        "radio_h_link": (32, 577, 577, 16, 16, 80, False, 577, False),
        "trunk_global": (8, 4096, 4096, 4, 4, 96, False, -1, False),
        "llm_prefill": (1, 5196, 5196, 32, 8, 128, True, -1, False),
        "llm_train_lse": (1, 5132, 5132, 32, 8, 128, True, -1, True),
    }
    out = {}
    for name, (b, sq, skv, hq, hkv, d, causal, kv_len, lse) in cases.items():
        # [B, S, H, D] buffers viewed [B, H, S, D], as the chains build them
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2)
                   for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))

        def run():
            return kernels.attention(q, k, v, scale=d ** -0.5, causal=causal,
                                     kv_len=kv_len, with_lse=lse)

        out[name] = {"shape": [b, hq, sq, d], "kv": [b, hkv, skv, d],
                     "entry": kernels.attention_entry(d, False, skv, hkv),
                     "ms": cs.cuda_ms(run, train=10)}
        del q, k, v
        torch.cuda.empty_cache()
    return out


def flash_bwd_times(cs, dev):
    """The mask decoder's flash backward at the train shape through the
    tree's `_FlashAttention.backward` (whatever kernels it launches)."""
    import types

    import torch

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops import attention as tatt

    g = torch.Generator(device=dev).manual_seed(1)
    b, s, skv, h, d = 64, 4096, 7, 8, 16
    q, do = (torch.randn((b, s, h, d), generator=g, device=dev)
             .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    k, v = (torch.randn((b, skv, h, d), generator=g, device=dev)
            .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    out, lse = kernels.attention(q, k, v, scale=d ** -0.5, two_pass=True,
                                 with_lse=True)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, None, out, lse),
                                causal=False, scale=d ** -0.5)

    def run():
        return tatt._FlashAttention.backward(ctx, do)

    return {"shape": [b, h, s, d], "kv": [b, h, skv, d],
            "ms": cs.cuda_ms(run, train=10), "device_ms": cs.graph_ms(run)}


def _end_to_end(cs, cfg, seed, dev):
    """chip_smoke's phases 12, 13 and 3 on the tree's code."""
    return {"w8a8_encode": cs.phase_w8a8_encode(cfg, seed, dev)[1],
            "trunk": cs.phase_hiera_per_op(cfg, seed, dev)[1],
            "serving": cs.phase_slice(cfg, seed, 32, dev)[1]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attention_only", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import video_llava_seg_torch
    from video_llava_seg_torch.config import VideoLlavaConfig

    for mod in (cs, video_llava_seg_torch):
        if root not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} imported from {mod.__file__}, "
                             f"not from {root}")
    smi = cs.phase_environment()
    cs.phase_build()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        VideoLlavaConfig(), seg_token_idx=VideoLlavaConfig().llm.vocab_size
        - 1)
    result = {"root": str(root), "card": smi,
              "attention": attention_times(cs, dev)}
    if args.train:
        result["flash_bwd"] = flash_bwd_times(cs, dev)
        result["train"] = cs.phase_train_slice(cfg, args.seed, dev)[1]
    elif not args.attention_only:
        result.update(_end_to_end(cs, cfg, args.seed, dev))
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
