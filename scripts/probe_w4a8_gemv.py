#!/usr/bin/env python3
"""Variants of K5's decode kernel (csrc/w4a8_gemv_sm90.cu) by device time
on one NVIDIA GPU: the box shape, the ring's depth and the split of K.

    python3 scripts/probe_w4a8_gemv.py [--boxes 128x128,64x256]
        [--stages 8] [--parts plan|all] [--rows 2] [--out DIR]

Each variant is the source as it stands with its BK x BN constants and
its ring's cap (MAX_STAGES) replaced (BK packed rows by BN <= 256
columns a box), built with nvcc for sm_90a into its own library under
kernels/_build/probe/ and called through its C entry with the plan of
`kernels.w4a8_gemv_plan(..., box_k=BK, box_n=BN)` and the deepest ring
up to the cap that fits: with the planned K parts a column tile (a
cluster of that many blocks) and with half and twice as many, or with
1-8 (`--parts all`). Per Llama-3-8B decode dense (fused wqkv, wo,
w_gateup, w_down, the lm_head in fp32) and a one-box floor (256 x 128):
the output is held bit-equal to `w4a8_matmul_plain`, then timed by a CUDA
graph over weight copies past 4x the L2 (`chip_smoke.graph_seq_ms`),
beside the kernel as built by `kernels` and w4a8.cu's GEMV
(`route="vls_w4a8"`), all in one process; for those two, also the host's
cost of an eager call. The clusters the card holds at once
(`vls_w4a8_gemv_sm90_clusters`) are printed first. One line per (dense,
variant); with --out, probe.json in DIR.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (graph timing, the denses, the bound)
from video_llava_seg_torch import kernels  # noqa: E402
from video_llava_seg_torch.config import VideoLlavaConfig  # noqa: E402
from video_llava_seg_torch.ops.int4 import w4a8_matmul_plain  # noqa: E402

ENTRY = "vls_w4a8_gemv_sm90"


def build_variants(boxes, caps):
    """{(BK, BN, cap): ctypes library} from the source with BK / BN /
    MAX_STAGES replaced, one nvcc process each, all started together (a
    library built before from the same source is reused)."""
    src = (kernels.CSRC / "w4a8_gemv_sm90.cu").read_text()
    out_dir = kernels.BUILD_ROOT / "probe" / kernels.source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._find_nvcc()
    procs = {}
    for (bk, bn), cap in ((b, c) for b in boxes for c in caps):
        text = src
        for name, v in (("BK", bk), ("BN", bn), ("MAX_STAGES", cap)):
            text = re.sub(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {v};", text, count=1)
        tag = f"{bk}x{bn}_{cap}"
        cu = out_dir / f"gemv_{tag}.cu"
        lib = out_dir / f"libgemv_{tag}.so"
        if lib.exists() and (out_dir / f"gemv_{tag}.log").exists():
            procs[(bk, bn, cap)] = (lib, None)
            continue
        cu.write_text(text)
        procs[(bk, bn, cap)] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (path, proc) in procs.items():
        log_path = path.with_name(path.name[3:-3] + ".log")
        if proc is None:
            log = log_path.read_text()
        else:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on variant {key}:\n{log}")
            log_path.write_text(log)
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                  log)})
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[probe] built {key[0]}x{key[1]}, <= {key[2]} stages: "
              f"registers {regs[0]}-"
              f"{regs[-1]}, spill stores {max(map(int, spills))} bytes",
              flush=True)
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, ENTRY)
        fn.argtypes = kernels._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        libs[key] = lib
    return libs


def ring(rows, in_dim, bk, bn, cap):
    """The deepest ring up to `cap` stages that fits beside the
    activations."""
    stages = cap
    while kernels.w4a8_gemv_smem(rows, in_dim, stages, bk,
                                 bn) > kernels.SM90_SMEM_MAX:
        stages -= 1
    return stages


def variant_call(lib, bk, bn, cap, xq, a_scale, packed, w_scale, out_dtype,
                 parts):
    """One call of a variant's C entry: its plan with `parts` K parts a
    column tile and the deepest ring up to `cap`, a y of out_dtype."""
    rows, in_dim = xq.shape
    half, out = packed.shape
    sms = kernels._sm_count(xq.device.index)
    plan = kernels.w4a8_gemv_plan(rows, half, out, sms, bk, bn)
    geom = (ctypes.c_longlong * 6)(*kernels.w4a8_gemv_sm90_geometry(
        half, out, bk, bn))
    grid = plan.tiles * parts if parts > 1 else min(sms, plan.tiles)
    y = torch.empty((rows, out), device=xq.device, dtype=out_dtype)
    code = getattr(lib, ENTRY)(
        xq.data_ptr(), a_scale.data_ptr(), packed.data_ptr(),
        w_scale.data_ptr(), y.data_ptr(), ctypes.cast(geom, ctypes.c_void_p),
        rows, half, out, int(out_dtype == torch.float32), parts, grid,
        ring(rows, in_dim, bk, bn, cap), kernels._stream())
    kernels._check_code(f"probe {bk}x{bn}", code)
    return y


def host_us(fn, n: int = 400):
    """(enqueue, enqueue + run) microseconds a call of `fn` over n eager
    calls back to back: where the host's cost of a call exceeds the
    device's, the first is the host's cost."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e6, (t2 - t0) / n * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--boxes", default="128x128,64x256")
    ap.add_argument("--stages", default="8")
    ap.add_argument("--parts", default="plan",
                    help="'plan': the plan's K parts, half and twice as "
                         "many; 'all': 1-8")
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_w4a8_gemv: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[probe] card: {smi}", flush=True)
    dev = torch.device("cuda")
    kernels.LIBRARY.get()
    boxes = [tuple(int(v) for v in b.split("x"))
             for b in args.boxes.split(",")]
    libs = build_variants(boxes, [int(c) for c in args.stages.split(",")])
    lib0 = kernels.LIBRARY.get()
    slots = {p: lib0.vls_w4a8_gemv_sm90_clusters(
        p, kernels.SM90_SMEM_MAX // 2 + 1024) for p in range(1, 9)}
    print(f"[probe] clusters of p blocks (one an SM) the card holds at "
          f"once: {slots}", flush=True)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = args.rows
    denses = chip_smoke.k5_denses(VideoLlavaConfig().llm) + [
        ("floor", 256, 128)]
    results = []
    for name, in_dim, out in denses:
        dt = torch.float32 if name == "lm_head" else torch.bfloat16
        half = in_dim // 2
        copies = max(2, math.ceil(4 * chip_smoke.L2_BYTES / (half * out)))
        xq = torch.randint(-127, 128, (rows, in_dim), generator=g,
                           device=dev, dtype=torch.int8)
        a_scale = torch.rand(rows, 1, generator=g, device=dev) + 1e-3
        w_scale = torch.rand(out, generator=g, device=dev) + 1e-3
        packed = [torch.randint(-128, 128, (half, out), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(copies)]
        want = w4a8_matmul_plain(xq, a_scale, packed[0], w_scale, dt)
        nbytes = (rows * in_dim + rows * 4 + half * out + 4 * out
                  + rows * out * (4 if dt == torch.float32 else 2))
        bound = nbytes / chip_smoke.HBM_BYTES_S * 1e3
        runs = {"kernels": lambda p: kernels.w4a8_matmul(
                    xq, a_scale, p, w_scale, dt),
                "w4a8.cu": lambda p: kernels.w4a8_matmul(
                    xq, a_scale, p, w_scale, dt, route="vls_w4a8")}
        sms = kernels._sm_count(torch.cuda.current_device())
        for (bk, bn, cap), lib in libs.items():
            plan = kernels.w4a8_gemv_plan(rows, half, out, sms, bk, bn)
            tries = (range(1, 9) if args.parts == "all" else
                     (plan.parts // 2, plan.parts, 2 * plan.parts))
            for parts in tries:
                if not (1 <= parts <= min(8, plan.k_boxes)
                        and (parts == 1 or plan.tiles * parts <= 2 * sms)):
                    continue
                label = (f"{bk}x{bn} <= {cap} stages "
                         f"({ring(rows, in_dim, bk, bn, cap)}) parts {parts}")
                runs[label] = (
                    lambda p, lib=lib, bk=bk, bn=bn, cap=cap, n=parts:
                    variant_call(lib, bk, bn, cap, xq, a_scale, p, w_scale,
                                 dt, n))
        for label, run in runs.items():
            exact = all(torch.equal(run(packed[0]), want) for _ in range(2))
            ms = chip_smoke.graph_seq_ms([lambda p=p: run(p)
                                          for p in packed])
            results.append({"dense": name, "shape": [rows, in_dim, out],
                            "variant": label, "device_ms": ms,
                            "bound_ms": bound, "exact": exact})
            print(f"[probe] {name} [{rows}, {in_dim}] x [{in_dim}, {out}] "
                  f"{label}: {ms:.4f} ms by device time over {copies} "
                  f"copies ({bound / ms:.3f} of the {bound:.4f} ms bound), "
                  f"{'bit-equal' if exact else 'NOT BIT-EQUAL'}", flush=True)
            if not exact:
                raise AssertionError(f"{name} {label}: not bit-equal")
            if label in ("kernels", "w4a8.cu"):
                enq, total = host_us(lambda: run(packed[0]))
                results[-1].update(host_enqueue_us=enq, host_total_us=total)
                print(f"[probe] {name} {label}: eager calls back to back: "
                      f"{enq:.1f} us a call to enqueue, {total:.1f} us a "
                      f"call in all", flush=True)
        del packed, want
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "probe.json"), "w") as f:
            json.dump({"card": smi, "rows": rows, "results": results}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
