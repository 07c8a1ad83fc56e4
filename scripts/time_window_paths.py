#!/usr/bin/env python3
"""Time one tree's windowed attention (K7) at every window kind of the
SAM2.1 trunks and the SAM2.1-hiera-large video session it serves, on one
NVIDIA GPU. Run it on two trees in turns (parent, change, change,
parent) to compare them in one call on one card.

    python3 scripts/time_window_paths.py [--root DIR] [--seed N]
        [--frames N] [--variants V ...] [--no_session] [--out FILE]

--root: a checkout of the repository (default: the one holding this
script) whose `chip_smoke.py` and `video_llava_seg_torch` are imported,
so the same measurement runs on each tree's own code. Prints one JSON
object (also written to --out):
- "k7": for SAM2.1-hiera-small (head dim 96), -base-plus (56) and -large
  (72) (or the --variants named), `kernels.window_attention` at every
  window kind of the trunk at 1024^2 over --frames frames (the map
  padded to whole windows, as the per-op trunk hands it to K7) on the C
  entry the tree's `window_entry`
  picks: ms over 10 launches back to back (chip_smoke's `cuda_ms`),
  device ms (a CUDA graph of the 10, `graph_ms`), the byte bound, the
  relative error against `window_attention_plain` in fp32, and the sums
  over a trunk's blocks;
- "session": chip_smoke's phase 18 video session at SAM2.1-hiera-large
  (16 frames of 480 x 854, one point, `propagate_in_video`): frames/s of
  the warm propagation by the host clock (best of 2), and from a
  torch.profiler trace of one more session the device busy time and
  the ten kernels with the most device time (summed by name).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

VARIANTS = ("small", "base_plus", "large")


def k7_times(cs, dev, variant, frames, seed):
    """{kinds: [...], per_trunk: {...}} of the tree's K7 at every window
    kind of SAM2.1-`variant`."""
    import torch

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.models.sam2 import hiera
    from video_llava_seg_torch.models.sam2.config import sam2_config
    from video_llava_seg_torch.ops.window_attention import (
        window_attention_plain,
    )

    sc = sam2_config(variant)
    dims = hiera.block_dims(sc.hiera)
    side = sc.image_size // sc.hiera.patch_stride
    kinds = {}
    for i, (_, dout, nh, ws, pool) in enumerate(dims):
        hw = side // (2 ** sum(1 for j in range(i) if dims[j][4]))
        if ws:
            kinds.setdefault((ws, pool, hw), [i, -(-hw // ws) * ws, dout, nh,
                                              0])[4] += 1
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for (ws, pool, hw), (i, hp, dout, nh, blocks) in sorted(
            kinds.items(), key=lambda kv: kv[1][0]):
        qkv = torch.randn((frames, hp, hp, 3 * dout), generator=g,
                          device=dev).to(torch.bfloat16)
        ps = 2 if pool else 1
        hd = dout // nh
        kw = dict(num_heads=nh, ws=ws, scale=hd ** -0.5, ps=ps)
        entry = kernels.window_entry(hd, ws, ps)

        def run():
            return kernels.window_attention(qkv, **kw)

        want = window_attention_plain(qkv.float(), **kw)
        rel = ((run().float() - want).abs().max()
               / want.abs().max()).item()
        del want
        out_bytes = frames * (hp // ps) ** 2 * dout * 2
        bound, _ = cs.bound_of(qkv.numel() * 2 + out_bytes, 0, cs.PEAK_BF16)
        ms = cs.cuda_ms(run, train=10)
        dev_ms = cs.graph_ms(run)
        rows.append({"block": i, "blocks": blocks, "ws": ws, "pooled": pool,
                     "map": hw, "padded": hp, "heads": nh, "head_dim": hd,
                     "entry": entry, "ms": ms, "device_ms": dev_ms,
                     "bound_ms": bound, "rel_err": rel})
        print(f"[k7] {sc.name} block {i} (x{blocks}) ws{ws}"
              f"{' q-pool' if pool else ''} on {hw}^2 hd{hd} {entry}: "
              f"{ms:.4f} ms, device {dev_ms:.4f} ({bound / dev_ms:.3f} of "
              f"the bound {bound:.4f}), rel err {rel:.2e}", flush=True)
        del qkv
        torch.cuda.empty_cache()
    per_trunk = {k: sum(r[k] * r["blocks"] for r in rows)
                 for k in ("ms", "device_ms", "bound_ms")}
    return {"frames": frames, "kinds": rows, "per_trunk": per_trunk}


def session(cs, dev, seed, smi):
    """Phase 18's Hiera-L session: warm frames/s, device busy time and the
    kernels with the most device time."""
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from video_llava_seg_torch.models.sam2.build import (
        build_sam2_video_predictor,
    )

    pred = build_sam2_video_predictor("large", seed=seed, device=dev)
    cs.raise_obj_score(pred.params)
    h, w = cs.SAM2_VIDEO_HW
    n = cs.SAM2_VIDEO_FRAMES
    frames = np.random.default_rng(seed + 18).integers(
        0, 256, (n, h, w, 3), dtype=np.uint8)
    point = [0.5 * w, 0.5 * h]
    cs._video_session(pred, frames, point)
    props = []
    for _ in range(2):
        _, prop_s = cs._video_session(pred, frames, point)
        props.append(prop_s)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs._video_session(pred, frames, point)
        cs.sync()
    traced_s = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not e.key.startswith("Activity Buffer")):
            by_name[e.key[:70]] = (by_name.get(e.key[:70], 0.0)
                                   + e.self_device_time_total / 1e3)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {"frames": n, "frames_per_s": n / min(props),
           "propagate_s": min(props), "device_busy_ms": busy,
           "device_busy_ms_per_frame": busy / n, "traced_session_s": traced_s,
           "top_kernels_ms": top, "card": smi}
    print(f"[session] {json.dumps(out)}", flush=True)
    del pred
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--no_session", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import video_llava_seg_torch

    for mod in (cs, video_llava_seg_torch):
        if root not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} imported from {mod.__file__}, "
                             f"not from {root}")
    smi = cs.phase_environment()
    cs.phase_build()
    dev = torch.device("cuda")
    out = {"root": str(root), "card": smi,
           "k7": {v: k7_times(cs, dev, v, args.frames, args.seed)
                  for v in args.variants}}
    if not args.no_session:
        out["session"] = session(cs, dev, args.seed, smi)
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
