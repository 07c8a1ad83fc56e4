#!/usr/bin/env python3
"""Variants of the row streams (csrc/layernorm_sm90.cu, csrc/pool_sm90.cu)
by device time on one NVIDIA GPU, at every main-path shape of K1's and
K4's chains (`chip_smoke.link_cases`).

    python3 scripts/probe_row_streams.py [--warps 4,8] [--out FILE]

Per shape, in one `chip_smoke.rotated_device_ms` round (a CUDA graph over
input copies past 4x the L2, all variants timed in turns):
- the kernel as `kernels` plans it, and its C entry with other plans
  (one or two blocks an SM, rings of 3 / 4 / 6 / 8 stages (those that
  fit two blocks an SM), for each --warps value, the source with its consumer warps (`WARPS`)
  replaced, built with nvcc for sm_90a into its own library under
  kernels/_build/probe/ (tiles of WARPS x 32 / G rows);
- the old kernel (layernorm.cu / pool.cu, forced by `route`);
- for the LayerNorm, `y.copy_(x)` into a preallocated y: one PyTorch
  call that reads and writes the same bytes, the yardstick of what a
  read + write stream of that size reaches on the card.
Every variant's output is first held bit-equal to the planned kernel's
(layernorm.cu's sums run in another order: chip_smoke holds it).
One line per (shape, variant) with its share of the byte bound; with
--out, the rows as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (shapes, rotated timing, the bound)
from video_llava_seg_torch import kernels  # noqa: E402
from video_llava_seg_torch.config import VideoLlavaConfig  # noqa: E402

_SIG = {"vls_layernorm_sm90": kernels._SIGNATURES["vls_layernorm_sm90"],
        "vls_maxpool2x2_sm90": kernels._SIGNATURES["vls_maxpool2x2_sm90"]}


def build_warps(warps):
    """{consumer warps: ctypes library of both row streams} for each value,
    one nvcc process each, all started together."""
    out_dir = kernels.BUILD_ROOT / "probe" / kernels.source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._find_nvcc()
    procs = {}
    for w in warps:
        lib = out_dir / f"row_streams_w{w}.so"
        if lib.exists():
            procs[w] = (lib, None)
            continue
        srcs = []
        for name in ("layernorm_sm90.cu", "pool_sm90.cu"):
            text = (kernels.CSRC / name).read_text()
            text, n = re.subn(r"constexpr int WARPS = \d+;",
                              f"constexpr int WARPS = {w};", text)
            assert n == 1, name
            src = out_dir / f"w{w}_{name}"
            src.write_text(text)
            srcs.append(str(src))
        procs[w] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC),
             "-o", str(lib), *srcs], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for w, (lib, proc) in procs.items():
        if proc is not None:
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed at WARPS={w}:\n{log}")
            for line in log.splitlines():
                if re.search(r"Used \d+ registers|spill stores", line):
                    print(f"[build] WARPS={w}: {line.strip()}", flush=True)
        cdll = ctypes.CDLL(str(lib))
        for name, argtypes in _SIG.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[w] = cdll
    return libs


def ln_variant(lib, warps, group, stages, grid):
    """A call of `lib`'s LayerNorm entry with this plan."""
    def run(x, gam, bet):
        y = torch.empty_like(x)
        rows, cols = x.shape
        code = lib.vls_layernorm_sm90(
            x.data_ptr(), gam.data_ptr(), bet.data_ptr(), y.data_ptr(), rows,
            cols, 1e-6, group, stages, grid, kernels._stream())
        kernels._check_code(f"layernorm WARPS={warps}", code)
        return y
    return run


def pool_variant(lib, warps, cw, stages, grid):
    def run(x):
        n, h, w, c = x.shape
        y = torch.empty((n, h // 2, w // 2, c), device=x.device,
                        dtype=x.dtype)
        code = lib.vls_maxpool2x2_sm90(x.data_ptr(), y.data_ptr(), n, h, w,
                                       c, cw, stages, grid,
                                       kernels._stream())
        kernels._check_code(f"maxpool2x2 WARPS={warps}", code)
        return y
    return run


def ring_stages(stage_bytes):
    """Rings of 3, 4, 6 and 8 stages, as deep as two blocks' shared memory
    an SM allows."""
    return [s for s in (3, 4, 6, 8)
            if s <= kernels.ROW_STREAM_MAX_STAGES
            and 2 * (s * stage_bytes + 6144) <= 233472 - 2048]


def ln_variants(libs, rows, cols, sms):
    """{name: fn(x, gamma, beta)} of the LayerNorm plans to time."""
    plan = kernels.layernorm_sm90_plan(rows, cols, sms)
    out = {}
    for w, lib in libs.items():
        stage = w * (32 // plan.group) * cols * 2
        tiles = -(-rows // (w * (32 // plan.group)))
        for bps in (1, 2):
            for st in ring_stages(stage):
                grid = min(tiles, sms * bps)
                out[f"W{w} {bps}/SM {st}st"] = ln_variant(lib, w, plan.group,
                                                         st, grid)
    return out


def pool_variants(libs, shape, sms):
    """{name: fn(x)} of the pool plans to time: an item's output columns
    scaled with the consumer warps (at most 2 x 32 x WARPS vectors)."""
    n, h, w_, c = shape
    plan = kernels.maxpool_sm90_plan(*shape, sms)
    out = {}
    for w, lib in libs.items():
        cw = max(1, plan.cw * w // kernels.ROW_STREAM_WARPS)
        items = n * (h // 2) * -(-(w_ // 2) // cw)
        for bps in (1, 2):
            for st in ring_stages(8 * cw * c):
                out[f"W{w} {bps}/SM {st}st"] = pool_variant(
                    lib, w, cw, st, min(items, sms * bps))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warps", default="4,8")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    smi = chip_smoke.phase_environment()
    chip_smoke.phase_build()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = build_warps([int(w) for w in args.warps.split(",")])
    cfg = VideoLlavaConfig()
    cfg = dataclasses.replace(cfg, seg_token_idx=cfg.llm.vocab_size - 1)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    rows_out = []
    for kernel, path, shape, launches in chip_smoke.link_cases(cfg):
        x0 = torch.randn(shape, generator=g, device=dev).to(bf)
        if kernel == "layernorm":
            cols = shape[1]
            gam = torch.randn(cols, generator=g, device=dev).to(bf)
            bet = torch.randn(cols, generator=g, device=dev).to(bf)
            want = kernels.layernorm(x0, gam, bet, 1e-6)
            runs = {name: (lambda x, fn=fn: fn(x, gam, bet))
                    for name, fn in ln_variants(libs, *shape, sms).items()}
            runs["planned"] = lambda x: kernels.layernorm(x, gam, bet, 1e-6)
            runs["layernorm.cu"] = lambda x: kernels.layernorm(
                x, gam, bet, 1e-6, route="vls_layernorm_bf16")
            nbytes = 2 * chip_smoke._nbytes(x0) + 4 * cols
        else:
            want = kernels.maxpool2x2(x0)
            runs = dict(pool_variants(libs, shape, sms))
            runs["planned"] = kernels.maxpool2x2
            runs["pool.cu"] = lambda x: kernels.maxpool2x2(
                x, route="vls_maxpool2x2_bf16")
            nbytes = chip_smoke._nbytes(x0) + chip_smoke._nbytes(want)
        for name, fn in runs.items():
            # layernorm.cu sums in another order (chip_smoke holds it)
            if name != "layernorm.cu" and not torch.equal(fn(x0), want):
                raise AssertionError(f"{kernel} {shape} {name}: differs "
                                     "from the planned kernel")
        if kernel == "layernorm":
            sink = torch.empty_like(x0)
            runs["copy_ (yardstick)"] = lambda x: sink.copy_(x)
        del x0, want

        def inputs(shape=shape):
            return torch.randn(shape, generator=g, device=dev).to(bf),

        dev_ms = chip_smoke.rotated_device_ms(runs, inputs)
        bound = chip_smoke.bound_of(nbytes, 0, chip_smoke.PEAK_BF16)[0]
        for name, ms in sorted(dev_ms.items(), key=lambda kv: kv[1]):
            rows_out.append({"kernel": kernel, "shape": list(shape),
                             "variant": name, "device_ms": ms,
                             "bound_ms": bound})
            print(f"[probe] {kernel} {list(shape)} {name}: {ms:.4f} ms "
                  f"({bound / ms:.3f} of the {bound:.4f} ms bound)",
                  flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows_out}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
