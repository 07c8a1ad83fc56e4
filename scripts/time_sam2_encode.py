#!/usr/bin/env python3
"""Time one tree's SAM2 image encode on one NVIDIA GPU: the seg head's
`seg_encode` stage (`seg_head.encode_video_frames`: the
SAM2.1-hiera-small trunk through K4 and the FPN neck over 8 frames at
1024^2, random bf16 weights from the seed) and the neck alone on that
trunk's pyramid. Run it on two trees in turns (parent, change, change,
parent) to compare them in one call on one card.

    python3 scripts/time_sam2_encode.py [--root DIR] [--seed N] [--out FILE]

--root: a checkout of the repository (default: the one holding this
script) whose `chip_smoke.py` and `video_llava_seg_torch` are imported.
Seconds by the host's clock around calls that end in
`torch.cuda.synchronize()` (chip_smoke's `wall_seconds`: median / min /
max of 7 interleaved rounds, after one warm-up call each), so host work
inside a stage (a host-to-device copy, the wrappers' Python) counts.
Prints one JSON object (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

OWN_ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(OWN_ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import video_llava_seg_torch
    from video_llava_seg_torch.config import VideoLlavaConfig
    from video_llava_seg_torch.models import seg_head
    from video_llava_seg_torch.models.sam2 import hiera, image_encoder

    for mod in (cs, video_llava_seg_torch):
        if root not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} imported from {mod.__file__}, "
                             f"not from {root}")
    smi = cs.phase_environment()
    cs.phase_build()
    dev = torch.device("cuda")
    cfg = VideoLlavaConfig()
    sc = seg_head.make_sam2_cfg(cfg.seg)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = seg_head.init(cfg.seg, cfg.llm.hidden_size, g, dev,
                           torch.bfloat16)
    # the serving path's seg frames: [T, H, W, 3] in [0, 1], bf16
    frames = torch.rand((cfg.seg.max_seg_frames, sc.image_size,
                         sc.image_size, 3), generator=g,
                        device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        pyramid = hiera.apply(params["image_encoder"]["trunk"], sc.hiera,
                              frames)
        calls = [lambda: seg_head.encode_video_frames(params, sc, frames),
                 lambda: image_encoder.apply_neck(params["image_encoder"],
                                                  sc, pyramid)]
        for call in calls:
            call()
        t_encode, t_neck = cs.wall_seconds(calls)
    result = {"root": str(root), "card": smi,
              "frames": list(frames.shape), "seg_encode_s": t_encode,
              "neck_s": t_neck}
    print(f"[sam2-encode] {root.name}: seg_encode {cs.fmt_wall(t_encode)}, "
          f"neck {cs.fmt_wall(t_neck)} on {smi}", flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
