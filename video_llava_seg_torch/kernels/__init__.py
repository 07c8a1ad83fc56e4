"""Build, load and launch the port's hand-written CUDA kernels.

The sources in `video_llava_seg_torch/csrc/*.cu` compile with `nvcc` for
`sm_90a` (one nvcc process per source, all started together, then one
link) into one shared library with a plain C interface, bound here with
ctypes. The library builds at first use into `kernels/_build/<hash>/`,
keyed by a hash of the flags, the sources and the headers they share
(`csrc/*.cuh`), so an edited source or header rebuilds and an unchanged
tree loads at once. Nothing here runs, imports `triton` or
looks for a compiler at import time: the CPU tests import this module.

Each raw wrapper checks device, dtype, shape, contiguity and alignment,
allocates its output with `torch.empty`, launches on the current stream
and raises if the C entry reports an error (`cudaGetLastError`).

`LAUNCHES` counts the TPU-kernel counterparts (K1..K8) the main paths
go through: each op-level wrapper (`ops.vit_block.vit_layer` for K1 and
K8, `ops.attention.attention` and its backward, `ops.hiera_block.
hiera_block`, `ops.int4.w4a8_dense`, `ops.window_attention.
window_attention` for K7) adds one where it launches its CUDA
composition, and nowhere else. `ops.int4.int_matmul` launches
`gemm_s8` for XLA's int8 product, which is no TPU kernel: it counts
nothing there. `GEMM_S8_LAUNCHES` counts every `gemm_s8` launch by the
C entry it took (`gemm_s8_entry`), inside K8 and out;
`ATTENTION_LAUNCHES` every `attention` launch by its C entry
(`attention_entry`); `ATTENTION_BWD_LAUNCHES` every flash-backward
launch by its C entry (`attention_bwd_entry`); `GEMM_BF16_LAUNCHES` every
`gemm` launch (the bf16 denses of K1 and K4) by its C entry
(`gemm_bf16_entry`); `WINDOW_LAUNCHES` every `window_attention` launch
(K7's, and the windowed attention of K4's chain) by its C entry
(`window_entry`); `LAYERNORM_LAUNCHES` every `layernorm` launch (the
LayerNorms of K1 and K4) by its C entry (`layernorm_entry`:
`vls_layernorm_sm90`, `vls_layernorm_bf16`); `MAXPOOL_LAUNCHES` every
`maxpool2x2` launch (K4's shortcut pool) by its C entry
(`maxpool_entry`: `vls_maxpool2x2_sm90`, `vls_maxpool2x2_bf16`);
`W4A8_LAUNCHES` every `w4a8_matmul` launch (K5's) by its C entry
(`w4a8_entry`); `QUANT_ROWS_LAUNCHES` every `quant_rows` /
`ln_quant_rows` launch (K8's row quantizers) by its C entry
(`quant_rows_entry`: `vls_quant_rows_sm90`, `vls_quant_rows`).
"""

from __future__ import annotations

import array
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libvls_kernels.so"

# C entry points: name -> argtypes (every pointer and the stream as
# c_void_p, so ctypes never narrows an address to 32 bits)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "vls_layernorm_bf16": [_P, _P, _P, _P, _L, _I, _F, _P],
    "vls_layernorm_sm90": [_P] * 4 + [_L, _I, _F, _I, _I, _I, _P],
    "vls_gemm_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "vls_gemm_bf16_sm90": [_P] * 6 + [_I] * 3 + [_F, _I, _P],
    "vls_attention_bf16": [_P] * 6 + [_L] * 13 + [_I] * 7
                          + [_F, _I, _I, _P],
    "vls_flash_fwd_sm90": [_P] * 7 + [_L] * 5 + [_I] * 3 + [_F, _P],
    "vls_attention_short_sm90": [_P] * 7 + [_L] * 4 + [_I, _I, _F, _P],
    "vls_attention_bwd_dq": [_P] * 9 + [_L] * 19 + [_I] * 6 + [_F, _I, _P],
    "vls_attention_bwd_dkv": [_P] * 9 + [_L] * 19 + [_I] * 6 + [_F, _I, _P],
    "vls_flash_bwd_dq_sm90": [_P] * 10 + [_L] * 8 + [_F, _I, _I, _P],
    "vls_flash_bwd_dkv_sm90": [_P] * 10 + [_L] * 8 + [_F, _I, _I, _P],
    "vls_attention_short_bwd_sm90": [_P] * 12 + [_L] * 10
                                    + [_I, _I, _F, _P],
    "vls_maxpool2x2_bf16": [_P, _P, _L, _I, _I, _I, _P],
    "vls_maxpool2x2_sm90": [_P, _P] + [_I] * 7 + [_P],
    "vls_w4a8": [_P] * 6 + [_I] * 5 + [_P],
    "vls_w4a8_sm90": [_P] * 6 + [_I] * 4 + [_P],
    "vls_w4a8_gemv_sm90": [_P] * 6 + [_I] * 7 + [_P],
    "vls_w4a8_gemv_sm90_clusters": [_I, _I],
    "vls_quant_rows": [_P] * 5 + [_L, _I, _F, _I, _P],
    "vls_quant_rows_sm90": [_P] * 5 + [_L, _I, _F] + [_I] * 6 + [_P],
    "vls_gemm_s8": [_P] * 7 + [_I] * 5 + [_F, _P],
    "vls_gemm_s8_sm90": [_P] * 8 + [_I] * 5 + [_F, _P],
    "vls_window_attention": [_P, _P] + [_I] * 7 + [_F, _P],
    "vls_window_attention_sm90": [_P] * 3 + [_I] * 12 + [_F, _P],
}

ACTS = {"none": 0, "quick_gelu": 1, "gelu": 2}
# attention.cu's head dims (attention_sm90.cu adds FLASH_SM90_WIDE_HEAD_DIM)
ATTENTION_HEAD_DIMS = (16, 32, 64, 80, 96, 128)
# attention_sm90.cu: the online form at these head dims, over at least
# FLASH_SM90_MIN_KEYS keys below head dim 128. The threshold was measured
# when K4's windowed blocks ran through `attention` (on an H100 it beat
# attention.cu at every window kind of the trunk, 16-196 keys; fewer keys
# were not measured and stay on attention.cu). Those blocks now take
# `window_attention`, so no main-path call comes near it: the towers' link
# has 577 keys and K4's global blocks the whole stage-3 map's (4096 at
# 1024^2);
# the per-key bias only at FLASH_SM90_HEAD_DIM (the LLM's, also the head
# dim of attention_bwd_sm90.cu), and there only a sliding window (a lower
# bound on each query's keys: Mistral) and a bias that varies by head as
# well as by key (ALiBi's slope_h * j: MPT), in either form and over any
# number of keys, for attention.cu has neither. Its leading TMA box is 64
# bf16 columns (one 128-byte swizzle row) by 128 rows of one head of one batch row, in
# the order of the tensor map's dims (D, S, H, B); at head dims 80 / 96 a
# second map's box holds the 16 / 32 columns left (32- / 64-byte
# swizzle). Head dim 256 (SAM2's memory attention: one head of 256) has
# no instance anywhere else, so attention_sm90.cu serves every call there
# without a bias, in either form and over any number of keys; its K and
# V boxes are FLASH_SM90_WIDE_KV_ROWS rows (a 128-row tile's registers
# would not fit beside a 256-column O).
FLASH_SM90_HEAD_DIMS = (64, 80, 96, 128, 256)
FLASH_SM90_HEAD_DIM = 128
FLASH_SM90_WIDE_HEAD_DIM = 256
FLASH_SM90_WIDE_KV_ROWS = 64
FLASH_SM90_MIN_KEYS = 16
FLASH_SM90_BOX = (64, 128, 1, 1)
# attention_short_sm90.cu: the two-pass form (K3) at head dim 16 with all
# keys in one wgmma N tile (Skv <= 64, rounded up to 8, 16, 32 or 64). Q
# streams as boxes of the 16 columns (32 bytes, the 32-byte swizzle) by
# 64 rows of one head; K and V of all kv heads of a batch row stay
# resident in one of two slots (K N rows, V max(N, 16) rows a head), which
# must fit SHORT_SM90_KV_SLOT_MAX bytes
SHORT_SM90_HEAD_DIM = 16
SHORT_SM90_MAX_KEYS = 64
SHORT_SM90_BQ = 64
SHORT_SM90_KV_SLOT_MAX = 64 * 1024
# attention_bwd_sm90.cu (K6a / K6b at the same head dim) walks 64-row
# tiles and loads every operand as boxes of 64 columns by 64 rows
FLASH_SM90_BWD_BOX = (64, 64, 1, 1)
# attention_short_bwd_sm90.cu (K6a + K6b in one pass where the forward
# took attention_short_sm90.cu): Q, O and dO stream as the forward's q
# boxes (16 columns by SHORT_SM90_BQ rows of one head), STAGES items a
# ring; K and V of all kv heads of a batch row stay resident as boxes of
# max(N, 16) keys a head, in one of two slots. Work units (batch row,
# chunk of its q tiles, q head) each leave a [2, N, 16] fp32 partial of
# dK / dV in a workspace, which a second launch adds per (batch row, kv
# head). Blocks an SM: SHORT_BWD_SM90_BLOCKS by the key tile N (the
# instances' launch bounds), fewer where shared memory runs out.
SHORT_BWD_SM90_ENTRY = "vls_attention_short_bwd_sm90"
SHORT_BWD_SM90_STAGES = 2
SHORT_BWD_SM90_BLOCKS = {8: 3, 16: 3, 32: 2, 64: 1}
# w4a8: the int32 sums hold 16 x the true sum (see csrc/w4a8.cu), which
# stays below 2^31 for in <= 2^17
W4A8_MAX_IN = 1 << 17
W4A8_GEMV_MAX_ROWS = 8
# w4a8_sm90.cu (the prefill tile): each stage is a TMA box of 128 packed
# rows (128 columns of each activation plane) by 128 activation rows, and
# one of 128 packed rows by 128 output channels; TMA needs 16-byte-aligned
# bases (in/2 for the high plane) and byte strides in multiples of 16
W4A8_SM90_BOX_K = 128
W4A8_SM90_BOX_ROWS = 128
W4A8_SM90_BOX_COLS = 128
W4A8_SM90_ALIGN = 16
# w4a8_gemv_sm90.cu (the decode product, <= 8 rows): boxes of 64 packed
# rows by 256 output columns (16 KB; 256-byte rows: scripts/
# probe_w4a8_gemv.py measured them ahead of 128 x 128 and 32 x 512 boxes
# on an H100) stream by TMA through a ring of 4-8 stages, as many as fit
# in a block's shared memory beside the activation rows (rows x in bytes,
# at most W4A8_GEMV_X_MAX); a column tile's K split into at most
# W4A8_GEMV_MAX_PARTS parts, a cluster of that many blocks, as many parts
# as let all of the tiles' clusters run at once (a second wave ran ~1.4x
# slower in the same probe). W4A8_GEMV_H100_SLOTS[p - 1]: clusters of p
# blocks, one an SM, an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters: 132 SMs in GPCs of 16-18); the
# wrapper asks the device it runs on (`_cluster_slots`)
W4A8_GEMV_ENTRY = "vls_w4a8_gemv_sm90"
W4A8_GEMV_BOX_K = 64
W4A8_GEMV_BOX_N = 256
W4A8_GEMV_MIN_STAGES = 4
W4A8_GEMV_MAX_STAGES = 8
W4A8_GEMV_MAX_PARTS = 8
W4A8_GEMV_H100_SLOTS = (132, 66, 39, 30, 22, 17, 15, 15)
W4A8_GEMV_X_MAX = 128 << 10
# the dynamic shared memory a Hopper block can use
SM90_SMEM_MAX = 232448
H100_SMS = 132
# w8a8_sm90.cu (gemm_s8 on TMA + wgmma): each stage is a TMA box of 128
# activation rows by 128 columns of K, and one of 128 rows of K by 128
# output channels; TMA needs 16-byte-aligned bases and byte strides in
# multiples of 16 (K and N multiples of 16)
GEMM_S8_SM90_BOX_K = 128
GEMM_S8_SM90_BOX_ROWS = 128
GEMM_S8_SM90_BOX_COLS = 128
GEMM_S8_SM90_ALIGN = 16
# gemm_bf16_sm90.cu (the bf16 denses on TMA + wgmma): 128 x 128 output
# tiles; each stage is a TMA box of 128 rows of A by 64 columns of K and
# two boxes of 64 rows of K by 64 columns of B (one 128-byte swizzle row
# each); the residual arrives and the output leaves as boxes of 64 rows
# by 64 columns. TMA needs 16-byte-aligned bases and row strides (K and N
# multiples of 8)
GEMM_BF16_SM90_BOX_K = 64
GEMM_BF16_SM90_BOX_ROWS = 128
GEMM_BF16_SM90_BOX_COLS = 64
GEMM_BF16_SM90_OUT_ROWS = 64
GEMM_BF16_SM90_ALIGN = 8
# aim the decode GEMV at ~8 blocks per SM of an H100 (132 SMs)
W4A8_GEMV_TARGET_BLOCKS = 132 * 8
# window_attention.cu: all of a window's keys sit in shared memory
WINDOW_MAX_KEYS = 256
WINDOW_MAX_HEAD_DIM = 128
# window_attention_sm90.cu (K7 on TMA + wgmma) at head dims 56, 72 and 96:
# a work unit is a strip of sw pixels of one window row (nw = sw / ws
# windows side by side) of one head; its k and v are each one TMA box
# (cols, 1, sw, ws, 1) of 5-D maps over qkv (dims: a head's columns, q / k
# / v head, Wp, Hp, B), its queries nqb boxes (cols, 1, sw, qh, 1) of at
# most WINDOW_SM90_ROWS rows (one query tile each, or with the q pool one
# pooled tile together). A head's columns are a leading box and a tail
# box (`window_sm90_boxes`). All of a strip's keys sit in one wgmma N tile
# of 64 or WINDOW_SM90_HEAD_KEYS[hd] keys (128 or as many with the q
# pool): plans take at most WINDOW_SM90_MAX_KEYS. Several windows share a
# strip (a block-diagonal mask keeps them apart) where a window's queries
# would leave a tile mostly empty: up to WINDOW_SM90_ROWS keys a strip
# without the q pool, 128 with it (power-of-two windows only).
WINDOW_SM90_ENTRY = "vls_window_attention_sm90"
WINDOW_SM90_HEAD_DIM = (56, 72, 96)
WINDOW_SM90_ROWS = 64
WINDOW_SM90_MAX_KEYS = 256
# the largest key tile of each head dim's instances: 256 (Hiera-L's ws
# 16) at 72; at 96 two 256-key slots and the pooled tiles do not fit in
# shared memory beside the q ring
WINDOW_SM90_HEAD_KEYS = {56: 208, 72: 256, 96: 208}
WINDOW_SM90_POOL_KEYS = 128
# layernorm_sm90.cu and pool_sm90.cu (the row streams of K1's and K4's
# LayerNorms and of K4's shortcut pool): a persistent grid, each block one
# producer thread keeping 1-D bulk copies of whole work items in flight
# through a ring of ROW_STREAM_STAGES stages (the C entries take up to
# ROW_STREAM_MAX_STAGES) and 8 consumer warps; ROW_STREAM_BLOCKS blocks
# an SM, one where each block would take ROW_STREAM_LONG items or more.
# On an H100 deeper rings, and two blocks an SM on long streams, ran
# slower (scripts/probe_row_streams.py). LayerNorm: a row is held by a
# group of G lanes (the least power of two up to 32 that leaves each lane
# at most LN_SM90_LANE_VECS 16-byte vectors of it), each lane at most
# LN_SM90_MAX_VECS vectors (cols <= 1280), a stage one tile of 8 x 32 / G
# rows. Pool: an item is one output row times a chunk of CW output
# columns (CW the largest power of two with both input row pieces within
# POOL_SM90_STAGE bytes), at most 512 16-byte output vectors
LAYERNORM_SM90_ENTRY = "vls_layernorm_sm90"
MAXPOOL_SM90_ENTRY = "vls_maxpool2x2_sm90"
ROW_STREAM_WARPS = 8
ROW_STREAM_BLOCKS = 2
ROW_STREAM_LONG = 12
ROW_STREAM_STAGES = 3
ROW_STREAM_MAX_STAGES = 8
ROW_STREAM_BARS = 128
LN_SM90_LANE_VECS = 4
LN_SM90_MAX_VECS = 5
POOL_SM90_STAGE = 24 << 10
POOL_SM90_MAX_VECS = 2 * 32 * ROW_STREAM_WARPS
# w8a8_rows_sm90.cu (K8's row quantizers, `ln_quant_rows` / `quant_rows`)
# on the same row stream: lane groups as LayerNorm's, the row held in
# registers as raw bf16, at most QUANT_ROWS_SM90_LN_VECS 16-byte vectors
# a lane after a LayerNorm (cols <= 1280), QUANT_ROWS_SM90_MAX_VECS
# without (cols <= 5120: fc1's output), rounded up to an instance of
# QUANT_ROWS_SM90_VECS. A ring of ROW_STREAM_STAGES stages where it fits
# one block's shared memory, else 2 (80 KB stages at 5120 columns); two
# blocks an SM where two such rings fit, one elsewhere
QUANT_ROWS_SM90_ENTRY = "vls_quant_rows_sm90"
QUANT_ROWS_SM90_LN_VECS = 5
QUANT_ROWS_SM90_MAX_VECS = 20
QUANT_ROWS_SM90_VECS = (4, 5, 16, 20)
QUANT_ROWS_SM90_MIN_STAGES = 2
# dynamic shared memory: one block's most, and an SM's for its blocks
# (228 KB less 1 KB reserved a block)
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024


class LaunchCounts:
    """Per-kernel launch counters of the K1..K8 wrappers (or of the names
    given)."""

    NAMES = ("K1", "K2", "K3", "K4", "K5", "K6a", "K6b", "K7", "K8")

    def __init__(self, names=NAMES):
        self.counts: Dict[str, int] = {n: 0 for n in names}

    def add(self, name: str):
        self.counts[name] += 1

    def reset(self):
        for n in self.counts:
            self.counts[n] = 0

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counts)


LAUNCHES = LaunchCounts()
# kernels.attention's launches by C entry: K1, K2, K3, K4 and K8 all
# reach it, so the TPU-kernel counts do not tell the routes apart
ATTENTION_ROUTES = ("vls_attention_bf16", "vls_flash_fwd_sm90",
                    "vls_attention_short_sm90")
ATTENTION_LAUNCHES = LaunchCounts(ATTENTION_ROUTES)
# gemm_s8's launches by C entry: K8 counts its layers, and the int32
# mode (int_matmul) is no TPU kernel, so neither tells the routes apart
GEMM_S8_ROUTES = ("vls_gemm_s8", "vls_gemm_s8_sm90")
GEMM_S8_LAUNCHES = LaunchCounts(GEMM_S8_ROUTES)
# kernels.gemm's launches by C entry: K1 and K4 both reach it and count
# their layers, not their denses
GEMM_BF16_ROUTES = ("vls_gemm_bf16", "vls_gemm_bf16_sm90")
GEMM_BF16_LAUNCHES = LaunchCounts(GEMM_BF16_ROUTES)
# the flash backward's launches by C entry: K6a / K6b count calls, and
# at head dim 16 over few keys one entry serves both
ATTENTION_BWD_ROUTES = ("vls_attention_bwd_dq", "vls_attention_bwd_dkv",
                        "vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90",
                        SHORT_BWD_SM90_ENTRY)
ATTENTION_BWD_LAUNCHES = LaunchCounts(ATTENTION_BWD_ROUTES)
# window_attention's launches by C entry: K7 counts the per-op trunk's
# calls, and K4's chain calls it too
WINDOW_ROUTES = ("vls_window_attention", WINDOW_SM90_ENTRY)
WINDOW_LAUNCHES = LaunchCounts(WINDOW_ROUTES)
# w4a8_matmul's launches by C entry: K5 counts w4a8_dense's calls, and
# three C entries serve them (decode, prefill, other widths)
W4A8_ROUTES = ("vls_w4a8", "vls_w4a8_sm90", W4A8_GEMV_ENTRY)
W4A8_LAUNCHES = LaunchCounts(W4A8_ROUTES)
# layernorm's launches by C entry: K1 and K4 count their layers, two
# LayerNorms each
LAYERNORM_ROUTES = ("vls_layernorm_bf16", LAYERNORM_SM90_ENTRY)
LAYERNORM_LAUNCHES = LaunchCounts(LAYERNORM_ROUTES)
# maxpool2x2's launches by C entry: K4's shortcut pooling (and its q
# pooling where the chain keeps its attention stage)
MAXPOOL_ROUTES = ("vls_maxpool2x2_bf16", MAXPOOL_SM90_ENTRY)
MAXPOOL_LAUNCHES = LaunchCounts(MAXPOOL_ROUTES)
# quant_rows' and ln_quant_rows' launches by C entry: K8 counts its
# layers, four row quantizers each
QUANT_ROWS_ROUTES = ("vls_quant_rows", QUANT_ROWS_SM90_ENTRY)
QUANT_ROWS_LAUNCHES = LaunchCounts(QUANT_ROWS_ROUTES)


class _Library:
    """The built shared library; `get()` builds and loads it once."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.build_seconds: float = 0.0
        self.build_log: str = ""

    def get(self) -> ctypes.CDLL:
        if self.lib is None:
            self.path, self.build_seconds, self.build_log = build()
            lib = ctypes.CDLL(str(self.path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self.lib = lib
        return self.lib


LIBRARY = _Library()


def _sources():
    """The translation units, one nvcc process each."""
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def build():
    """Compile csrc/*.cu into one .so (once per source hash).

    Returns (library path, seconds spent compiling, compiler output)."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        return lib_path, 0.0, log_path.read_text() if log_path.exists() \
            else ""
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp_dir, src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, proc in procs:
            out = proc.communicate()[0]
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = os.path.join(tmp_dir, LIB_NAME)
        res = subprocess.run([nvcc, "-shared", "-o", tmp_lib, *objs],
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{log}")
        os.replace(tmp_lib, lib_path)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    return lib_path, seconds, log


def _check_code(name: str, code: int):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def _stream():
    """The current CUDA stream's handle (what `torch.cuda.current_stream()
    .cuda_stream` gives, without building a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _ptr(t: Optional[torch.Tensor]):
    """t's address, or None (NULL) for no tensor, as a c_void_p argument
    takes it."""
    return None if t is None else t.data_ptr()


def _require(t: torch.Tensor, what: str, dtype=torch.bfloat16,
             contiguous: bool = True):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data must be 16-byte aligned")


class LayerNormPlan(NamedTuple):
    """layernorm_sm90.cu's launch: G lanes a row, `vecs` 16-byte vectors a
    lane, `tile_rows` rows a stage (one bulk copy), `stages` stages of
    `stage_bytes`, `tiles` tiles over the rows, `grid` persistent blocks
    of `smem` bytes of dynamic shared memory."""
    group: int
    vecs: int
    tile_rows: int
    stage_bytes: int
    stages: int
    tiles: int
    grid: int
    smem: int


def _row_stream_grid(items: int, sms: int) -> int:
    """A row stream's persistent blocks over `items` work items: two an
    SM, one an SM on a long stream (ROW_STREAM_LONG items a block or more
    at two)."""
    long = items >= ROW_STREAM_LONG * ROW_STREAM_BLOCKS * sms
    return min(items, sms * (1 if long else ROW_STREAM_BLOCKS))


@functools.lru_cache(maxsize=256)
def layernorm_sm90_plan(rows: int, cols: int, sms: int = H100_SMS):
    """layernorm_sm90.cu's geometry for a [rows, cols] LayerNorm, or None
    where it does not take the shape (no rows, cols % 8, more than
    LN_SM90_MAX_VECS vectors a lane: cols > 1280). Pure; cached per shape,
    as `_forward_geometry`."""
    if rows <= 0 or cols <= 0 or cols % 8:
        return None
    v = cols // 8
    group = 1
    while group < 32 and -(-v // group) > LN_SM90_LANE_VECS:
        group *= 2
    vecs = -(-v // group)
    if vecs > LN_SM90_MAX_VECS:
        return None
    tile_rows = ROW_STREAM_WARPS * (32 // group)
    stage_bytes = tile_rows * cols * 2
    tiles = -(-rows // tile_rows)
    smem = (128 + ROW_STREAM_BARS + (4 * cols + 127) // 128 * 128
            + ROW_STREAM_STAGES * stage_bytes)
    return LayerNormPlan(group, vecs, tile_rows, stage_bytes,
                         ROW_STREAM_STAGES, tiles,
                         _row_stream_grid(tiles, sms), smem)


def layernorm_entry(rows: int, cols: int) -> str:
    """The C entry that serves `layernorm` on a [rows, cols] input:
    layernorm_sm90.cu where `layernorm_sm90_plan` takes the shape (cols %
    8 == 0, cols <= 1280: every LayerNorm of K1 and K4), layernorm.cu
    otherwise."""
    if layernorm_sm90_plan(rows, cols) is not None:
        return LAYERNORM_SM90_ENTRY
    return "vls_layernorm_bf16"


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float, route: Optional[str] = None) -> torch.Tensor:
    """LayerNorm over the last dim of a contiguous bf16 tensor (the
    plain version is `ops.nn.layer_norm`). The shape chooses the kernel
    (`layernorm_entry`); `route` names a C entry of LAYERNORM_ROUTES
    instead, for the tests and for timing layernorm.cu."""
    if route is not None and route not in LAYERNORM_ROUTES:
        raise ValueError(f"layernorm: route must be one of "
                         f"{LAYERNORM_ROUTES}, got {route!r}")
    for t, what in ((x, "x"), (gamma, "gamma"), (beta, "beta")):
        _require(t, f"layernorm {what}")
    cols = x.shape[-1]
    if gamma.numel() != cols or beta.numel() != cols:
        raise ValueError("layernorm: gamma/beta must match the last dim")
    y = torch.empty_like(x)
    rows = x.numel() // cols if cols else 0
    entry = route or layernorm_entry(rows, cols)
    if entry == LAYERNORM_SM90_ENTRY:
        plan = layernorm_sm90_plan(rows, cols, _sm_count(x.device.index))
        if plan is None:
            raise ValueError(f"layernorm: {LAYERNORM_SM90_ENTRY} does not "
                             f"take [{rows}, {cols}]")
        code = LIBRARY.get().vls_layernorm_sm90(
            _ptr(x), _ptr(gamma), _ptr(beta), _ptr(y), rows, cols,
            float(eps), plan.group, plan.stages, plan.grid, _stream())
    else:
        code = LIBRARY.get().vls_layernorm_bf16(
            _ptr(x), _ptr(gamma), _ptr(beta), _ptr(y), rows, cols,
            float(eps), _stream())
    _check_code("layernorm", code)
    LAYERNORM_LAUNCHES.add(entry)
    return y


_GEMM_ACTS = {"none": lambda y: y,
              "quick_gelu": lambda y: y * torch.sigmoid(1.702 * y),
              "gelu": torch.nn.functional.gelu}


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None, scale: float = 1.0,
               act: str = "none") -> torch.Tensor:
    """`gemm`'s plain version: act((a @ b + bias) * scale) + residual in
    fp32 sums (quick_gelu x sigmoid(1.702 x), gelu the exact erf form),
    rounded once to a's dtype. The CPU tests, and on the card chip_smoke
    and the CUDA tests, hold the kernels to it."""
    y = a.float() @ b.float()
    if bias is not None:
        y = y + bias.float()
    y = _GEMM_ACTS[act](y * scale)
    if residual is not None:
        y = y + residual.float()
    return y.to(a.dtype)


def gemm_bf16_entry(m: int, k: int, n: int) -> str:
    """The C entry that serves `gemm` at [m, k] x [k, n]: the TMA + wgmma
    kernel of csrc/gemm_bf16_sm90.cu wherever TMA can address the
    operands (k and n multiples of 8, which `gemm` requires of every
    call), csrc/gemm_bf16.cu for a call with no rows (nothing to
    launch)."""
    if (m > 0 and k > 0 and k % GEMM_BF16_SM90_ALIGN == 0
            and n % GEMM_BF16_SM90_ALIGN == 0):
        return "vls_gemm_bf16_sm90"
    return "vls_gemm_bf16"


def gemm_bf16_sm90_geometry(a: torch.Tensor, b: torch.Tensor,
                            c: torch.Tensor,
                            residual: Optional[torch.Tensor] = None):
    """The four bf16 tensor maps that csrc/gemm_bf16_sm90.cu encodes, 24
    int64: for a [M, K], b [K, N], the output c [M, N] and the residual
    [M, N] (c's map again where there is none, which the kernel never
    reads), each (byte offset of the map's base, dims (inner, outer) in
    elements, the outer byte stride, box (inner, outer)). TMA needs a
    contiguous inner dim, a 16-byte-aligned base and outer byte strides in
    multiples of 16."""
    ops = ((a, "a"), (b, "b"), (c, "c"),
           (c if residual is None else residual, "residual"))
    for t, what in ops:
        if t.dim() != 2 or t.stride(1) != 1 or t.dtype != torch.bfloat16:
            raise ValueError(f"gemm_bf16_sm90 {what}: expected a 2-D bf16 "
                             "tensor with a contiguous last dim")
        if t.data_ptr() % 16 or t.stride(0) % GEMM_BF16_SM90_ALIGN:
            raise ValueError(f"gemm_bf16_sm90 {what}: TMA needs a 16-byte-"
                             "aligned base and a row stride in multiples of "
                             f"16 bytes, got stride {t.stride(0)}")
    m, k = a.shape
    n = b.shape[1]
    if (b.shape[0] != k or tuple(c.shape) != (m, n)
            or tuple(ops[3][0].shape) != (m, n)):
        raise ValueError(f"gemm_bf16_sm90: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} and the "
                         f"residual {tuple(ops[3][0].shape)} do not match")
    if k % GEMM_BF16_SM90_ALIGN or n % GEMM_BF16_SM90_ALIGN:
        raise ValueError(f"gemm_bf16_sm90: TMA needs K and N in multiples of "
                         f"{GEMM_BF16_SM90_ALIGN}, got K={k}, N={n}")
    out_box = (GEMM_BF16_SM90_BOX_COLS, GEMM_BF16_SM90_OUT_ROWS)
    return ((0, k, m, 2 * a.stride(0), GEMM_BF16_SM90_BOX_K,
             GEMM_BF16_SM90_BOX_ROWS)
            + (0, n, k, 2 * b.stride(0), GEMM_BF16_SM90_BOX_COLS,
               GEMM_BF16_SM90_BOX_K)
            + (0, n, m, 2 * c.stride(0)) + out_box
            + (0, n, m, 2 * ops[3][0].stride(0)) + out_box)


def gemm(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None, scale: float = 1.0,
         act: str = "none", route: Optional[str] = None) -> torch.Tensor:
    """act((a @ b + bias) * scale) + residual, a [M, K], b [K, N], bf16.

    The shape chooses the kernel (`gemm_bf16_entry`); `route` names a C
    entry of GEMM_BF16_ROUTES instead, for the tests and for timing
    gemm_bf16.cu beside the kernel that took its calls."""
    if route is not None and route not in GEMM_BF16_ROUTES:
        raise ValueError(f"gemm: route must be one of {GEMM_BF16_ROUTES}, "
                         f"got {route!r}")
    _require(a, "gemm a")
    _require(b, "gemm b")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"gemm: K ({k}) and N ({n}) must be multiples of 8")
    if bias is not None:
        _require(bias, "gemm bias")
        if bias.numel() != n:
            raise ValueError("gemm: bias must have N elements")
    if residual is not None:
        _require(residual, "gemm residual")
        if tuple(residual.shape) != (m, n):
            raise ValueError("gemm: residual must be [M, N]")
    c = torch.empty((m, n), device=a.device, dtype=a.dtype)
    entry = route or gemm_bf16_entry(m, k, n)
    if entry == "vls_gemm_bf16_sm90":
        geom = (ctypes.c_longlong * 24)(
            *gemm_bf16_sm90_geometry(a, b, c, residual))
        code = LIBRARY.get().vls_gemm_bf16_sm90(
            _ptr(a), _ptr(b), _ptr(bias), _ptr(residual), _ptr(c),
            ctypes.cast(geom, ctypes.c_void_p), m, n, k, float(scale),
            ACTS[act], _stream())
    else:
        code = LIBRARY.get().vls_gemm_bf16(
            _ptr(a), _ptr(b), _ptr(bias), _ptr(residual), _ptr(c), m, n, k,
            float(scale), ACTS[act], _stream())
    _check_code("gemm", code)
    GEMM_BF16_LAUNCHES.add(entry)
    return c


def _strides_bhs(t: torch.Tensor, what: str):
    """(batch, head, seq) element strides of a [B, H, S, D] view whose last
    dim is contiguous and whose rows are 16-byte aligned."""
    _require(t, what, contiguous=False)
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{what}: expected [B, H, S, D] with a contiguous "
                         "last dim")
    sb, sh, ss = t.stride(0), t.stride(1), t.stride(2)
    if any(s % 8 for s in (sb, sh, ss)):
        raise ValueError(f"{what}: strides must be multiples of 8 elements")
    return sb, sh, ss


def _check_qkv(q, k, v):
    bsz, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in ATTENTION_HEAD_DIMS and d != FLASH_SM90_WIDE_HEAD_DIM:
        raise ValueError(f"attention: head_dim {d} not in "
                         f"{ATTENTION_HEAD_DIMS + (FLASH_SM90_WIDE_HEAD_DIM,)}")
    if k.shape != (bsz, hkv, skv, d) or v.shape != k.shape:
        raise ValueError("attention: k/v shapes do not match")
    if hq % hkv:
        raise ValueError("attention: Hq must be a multiple of Hkv")
    return bsz, hq, hkv, sq, skv, d


def _bias_stride(kv_bias, bsz, skv):
    if kv_bias is None:
        return 0
    _require(kv_bias, "kv_bias", dtype=torch.float32)
    if tuple(kv_bias.shape) != (bsz, skv):
        raise ValueError("attention: kv_bias must be [B, Skv]")
    return skv


def _bias_strides(kv_bias, bsz, hq, skv):
    """(batch, head) element strides of the forward's bias: a contiguous
    fp32 [B, Skv] (per key; head stride 0) or [B, Hq, Skv] (per head and
    key)."""
    if kv_bias is not None and kv_bias.dim() == 3:
        _require(kv_bias, "kv_bias", dtype=torch.float32)
        if tuple(kv_bias.shape) != (bsz, hq, skv):
            raise ValueError("attention: a per-head kv_bias must be "
                             "[B, Hq, Skv]")
        return hq * skv, skv
    return _bias_stride(kv_bias, bsz, skv), 0


def _bshd(bsz, s, h, d, like):
    """A [B, H, S, D] view of a fresh contiguous [B, S, H, D] buffer."""
    return torch.empty_strided((bsz, h, s, d), (s * h * d, d, h * d, 1),
                               device=like.device, dtype=like.dtype)


def short_sm90_key_tile(skv: int) -> int:
    """The score tile's width in attention_short_sm90.cu: Skv rounded up
    to 8, 16, 32 or 64 keys."""
    n = 8
    while n < skv:
        n *= 2
    return n


def attention_entry(d: int, two_pass: bool, skv: int, hkv: int,
                    bias: bool = False, window: int = 0,
                    head_bias: bool = False) -> str:
    """The C entry that serves `attention` at head dim d over skv keys and
    hkv kv heads (`bias`: with a per-key bias; `window` > 0: a sliding
    window; `head_bias`: a bias per head and key, ALiBi's): the TMA +
    wgmma kernel of csrc/attention_sm90.cu for every call with a window
    or a per-head bias, which only its head-dim-128 instances take (a
    ValueError at any other head dim), whatever the form and the key
    count; the TMA + wgmma kernel of
    csrc/attention_sm90.cu for the online form at head dim 128 (the LLM),
    and at head dims 64 / 80 / 96 without a bias over at least
    FLASH_SM90_MIN_KEYS keys (the towers' attention link, the Hiera
    trunk's global blocks); csrc/attention_short_sm90.cu for the two-pass
    form (K3) at head dim 16 where all keys fit one wgmma N tile (skv <=
    64) and a batch row's K/V fit a resident slot (the SAM2 mask decoder's
    image->token attention); csrc/attention.cu for every other call (head
    dims 16 and 32, a bias below head dim 128, fewer keys, the two-pass
    form elsewhere). At head dim 256 (SAM2's memory attention)
    attention_sm90.cu serves every call without a bias, and a bias is
    refused: no kernel has that instance."""
    if window or head_bias:
        if d != FLASH_SM90_HEAD_DIM:
            raise ValueError("attention: a sliding window or a per-head "
                             f"bias only at head dim {FLASH_SM90_HEAD_DIM} "
                             f"(attention_sm90.cu), not {d}")
        return "vls_flash_fwd_sm90"
    if d == FLASH_SM90_WIDE_HEAD_DIM:
        if bias:
            raise ValueError("attention: no kernel takes a per-key bias at "
                             f"head dim {d}")
        return "vls_flash_fwd_sm90"
    if not two_pass and d == FLASH_SM90_HEAD_DIM:
        return "vls_flash_fwd_sm90"
    if (not two_pass and not bias and d in FLASH_SM90_HEAD_DIMS
            and skv >= FLASH_SM90_MIN_KEYS):
        return "vls_flash_fwd_sm90"
    if (two_pass and d == SHORT_SM90_HEAD_DIM
            and 0 < skv <= SHORT_SM90_MAX_KEYS and hkv > 0):
        n = short_sm90_key_tile(skv)
        if hkv * (n + max(n, 16)) * 2 * d <= SHORT_SM90_KV_SLOT_MAX:
            return "vls_attention_short_sm90"
    return "vls_attention_bf16"


def flash_sm90_tensor_map(t: torch.Tensor, what: str,
                          box=FLASH_SM90_BOX):
    """The TMA tensor-map geometry of a [B, H, S, D] bf16 view for
    csrc/attention_sm90.cu, attention_bwd_sm90.cu and
    attention_short_sm90.cu, which only encode it: dims (D, S, H, B)
    innermost first, the byte strides of S, H and B, and the box (the
    forward's FLASH_SM90_BOX, the backward's FLASH_SM90_BWD_BOX,
    attention_short_sm90.cu's own). TMA needs a contiguous last dim, byte
    strides in multiples of 16 and a 16-byte-aligned base."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data must be 16-byte aligned")
    return _tensor_map_dims(t.shape, t.stride(), t.element_size(), what,
                            box)


def _tensor_map_dims(shape, stride, es: int, what: str, box):
    """`flash_sm90_tensor_map` from a view's shape, element strides and
    element size."""
    if len(stride) != 4 or stride[3] != 1:
        raise ValueError(f"{what}: expected [B, H, S, D] with a contiguous "
                         "last dim")
    s0, s1, s2 = stride[2] * es, stride[1] * es, stride[0] * es
    if (min(s0, s1, s2) <= 0 or (s0 | s1 | s2) % 16
            or max(s0, s1, s2) >= 1 << 40):
        raise ValueError(f"{what}: TMA needs byte strides that are positive "
                         f"multiples of 16 below 2^40, got {(s0, s1, s2)}")
    b, h, s, d = shape
    return (d, s, h, b, s0, s1, s2) + tuple(box)


def flash_sm90_kv_rows(d: int) -> int:
    """The rows of attention_sm90.cu's K / V tiles (and boxes) at head dim
    d: FLASH_SM90_WIDE_KV_ROWS at FLASH_SM90_WIDE_HEAD_DIM, else the
    Q tile's FLASH_SM90_BOX[1]."""
    return (FLASH_SM90_WIDE_KV_ROWS if d == FLASH_SM90_WIDE_HEAD_DIM
            else FLASH_SM90_BOX[1])


def flash_sm90_boxes(d: int, rows: int = FLASH_SM90_BOX[1]):
    """attention_sm90.cu's TMA boxes of `rows` rows at head dim d: the
    leading box FLASH_SM90_BOX's columns and, where d is no multiple of
    its width, the remainder box of the columns left; None where there
    is none."""
    lead = (FLASH_SM90_BOX[0], rows) + FLASH_SM90_BOX[2:]
    rem = d % FLASH_SM90_BOX[0]
    return lead, ((rem,) + lead[1:] if rem else None)


@functools.lru_cache(maxsize=256)
def _forward_geometry(entry, q_shape, q_stride, k_shape, k_stride, v_stride,
                      es):
    """The int64 geometry array of the sm90 forward entry `entry`: the q,
    k and v tensor maps, each as `flash_sm90_tensor_map` gives it, for
    [B, H, S, D] views of these shapes and element strides (element size
    es). attention_sm90.cu's boxes are `flash_sm90_boxes(D)`'s leading
    box for q and `flash_sm90_boxes(D, flash_sm90_kv_rows(D))`'s for k
    and v, then, where there is one, the q, k and v maps of the
    remainder box (3 x 11 int64 more);
    attention_short_sm90.cu's are 16 columns by SHORT_SM90_BQ rows of one
    head for q, the N keys of every kv head of one batch row for k (N =
    `short_sm90_key_tile(Skv)`), max(N, 16) keys for v (TMA zero-fills
    rows past Skv). Built once per shape: at the mask decoder's sizes the
    host's cost of a call is more than the kernel's device time. The C
    entries only read it."""
    if entry == "vls_flash_fwd_sm90":
        d = q_shape[3]
        lead, rem = flash_sm90_boxes(d)
        kv_lead, kv_rem = flash_sm90_boxes(d, flash_sm90_kv_rows(d))
        boxes = (lead, kv_lead, kv_lead) + ((rem, kv_rem, kv_rem)
                                           if rem else ())
    else:
        d, hkv, skv = q_shape[3], k_shape[1], k_shape[2]
        n = short_sm90_key_tile(skv)
        boxes = ((d, SHORT_SM90_BQ, 1, 1), (d, n, hkv, 1),
                 (d, max(n, 16), hkv, 1))
    geom = ()
    for i, box in enumerate(boxes):
        shape, stride, what = ((q_shape, q_stride, "q"),
                               (k_shape, k_stride, "k"),
                               (k_shape, v_stride, "v"))[i % 3]
        geom += _tensor_map_dims(shape, stride, es, what, box)
    return array.array("q", geom)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = False, kv_len: int = -1,
              kv_bias: Optional[torch.Tensor] = None,
              two_pass: bool = False, with_lse: bool = False,
              window: int = 0, route: Optional[str] = None):
    """Flash attention over strided [B, H, S, D] bf16 views.

    Returns [B, Hq, Sq, D] as a view of a contiguous [B, Sq, Hq, D]
    buffer (so the caller's merge of heads into channels is free), and
    with `with_lse` also the per-row logsumexp, fp32 [B, Hq, Sq] (0 for a
    row with no visible key). kv_bias: fp32 [B, Skv] additive per-key
    bias, [B, Hq, Skv] per head and key (ALiBi), or None. window > 0:
    query i (at key slot i + Skv - Sq) sees only keys j > i + Skv - Sq -
    window (Mistral's sliding window). The head dim, the form, the shapes
    and these options choose the kernel (`attention_entry`); `route`
    names a C entry of ATTENTION_ROUTES instead, for the tests and for
    timing attention.cu beside the kernels that took its calls."""
    if route is not None and route not in ATTENTION_ROUTES:
        raise ValueError(f"attention: route must be one of "
                         f"{ATTENTION_ROUTES}, got {route!r}")
    if window < 0:
        raise ValueError(f"attention: window must be >= 0, got {window}")
    bsz, hq, hkv, sq, skv, d = _check_qkv(q, k, v)
    head_bias = kv_bias is not None and kv_bias.dim() == 3
    entry = route or attention_entry(d, two_pass, skv, hkv,
                                     bias=kv_bias is not None,
                                     window=window, head_bias=head_bias)
    if (window or head_bias) and entry != "vls_flash_fwd_sm90":
        raise ValueError(f"attention: {entry} takes neither a sliding "
                         "window nor a per-head bias")
    if entry == "vls_flash_fwd_sm90" and (
            (two_pass and d != FLASH_SM90_WIDE_HEAD_DIM
             and not (window or head_bias))
            or d not in FLASH_SM90_HEAD_DIMS
            or (kv_bias is not None and d != FLASH_SM90_HEAD_DIM)
            or ((window or head_bias) and d != FLASH_SM90_HEAD_DIM)):
        raise ValueError("attention: vls_flash_fwd_sm90 serves the online "
                         f"form at head dims {FLASH_SM90_HEAD_DIMS} (both "
                         f"forms at {FLASH_SM90_WIDE_HEAD_DIM}), with a "
                         f"per-key bias at {FLASH_SM90_HEAD_DIM} (a window "
                         "or a per-head bias there too)")
    if entry == "vls_attention_short_sm90" and (
            not two_pass or entry != attention_entry(d, True, skv, hkv)):
        raise ValueError(f"attention: {entry} serves the two-pass form at "
                         f"head dim {SHORT_SM90_HEAD_DIM} over up to "
                         f"{SHORT_SM90_MAX_KEYS} keys")
    bias_sb, bias_sh = _bias_strides(kv_bias, bsz, hq, skv)
    o = _bshd(bsz, sq, hq, d, q)
    os_ = (o.stride(0), o.stride(1), o.stride(2))
    lse = (torch.empty((bsz, hq, sq), device=q.device, dtype=torch.float32)
           if with_lse else None)
    if kv_len < 0:
        kv_len = skv
    if entry == "vls_attention_bf16":
        qs, ks, vs = (_strides_bhs(q, "q"), _strides_bhs(k, "k"),
                      _strides_bhs(v, "v"))
        code = LIBRARY.get().vls_attention_bf16(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(kv_bias), _ptr(lse),
            *qs, *ks, *vs, *os_, bias_sb, bsz, hq, hkv, sq, skv, d, kv_len,
            float(scale), int(causal), int(two_pass), _stream())
    else:
        for t, what in ((q, "q"), (k, "k"), (v, "v")):
            _require(t, what, contiguous=False)
        # the tensor maps check the strides TMA needs
        geom = _forward_geometry(entry, q.shape, q.stride(), k.shape,
                                 k.stride(), v.stride(), q.element_size())
        args = (_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(kv_bias), _ptr(lse),
                geom.buffer_info()[0], *os_, bias_sb)
        if entry == "vls_flash_fwd_sm90":
            code = LIBRARY.get().vls_flash_fwd_sm90(
                *args, bias_sh, kv_len, window, int(causal), float(scale),
                _stream())
        else:
            code = LIBRARY.get().vls_attention_short_sm90(
                *args, kv_len, int(causal), float(scale), _stream())
    _check_code("attention", code)
    ATTENTION_LAUNCHES.add(entry)
    return (o, lse) if with_lse else o


def _addressable(t: torch.Tensor) -> torch.Tensor:
    """t as a [B, H, S, D] view the kernels (and TMA) can address:
    contiguous last dim, positive strides in multiples of 8 elements,
    16-byte aligned; copied once into a contiguous tensor when it is not
    one."""
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(s % 8 or s <= 0 for s in t.stride()[:3])):
        t = t.contiguous()
    return t


def _bhs_operand(t: torch.Tensor, what: str):
    t = _addressable(t)
    return t, _strides_bhs(t, what)


def _bwd_pair(d: int):
    """The C entries (dQ, dK/dV) of the two-kernel backward at head dim d:
    csrc/attention_bwd_sm90.cu at head dim 128, csrc/attention_bwd.cu at
    every other."""
    if d == FLASH_SM90_HEAD_DIM:
        return "vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90"
    return "vls_attention_bwd_dq", "vls_attention_bwd_dkv"


def attention_bwd_entry(d: int, skv: int, hkv: int, window: int = 0,
                        head_bias: bool = False):
    """The C entries that serve `attention_bwd` at head dim d over skv
    keys and hkv kv heads, in launch order: the one-pass kernel of
    csrc/attention_short_bwd_sm90.cu wherever the forward took
    attention_short_sm90.cu (head dim 16, skv <= 64, a batch row's K/V
    within the resident slot: the SAM2 mask decoder's image->token
    attention); the TMA + wgmma pair of csrc/attention_bwd_sm90.cu (dQ,
    then dK/dV) at head dim 128 (the LLM's), the only pair that takes a
    sliding window (`window` > 0, Mistral) or a per-head bias
    (`head_bias`, MPT's ALiBi): either at another head dim is a
    ValueError; csrc/attention_bwd.cu's pair for every other call."""
    if window or head_bias:
        if d != FLASH_SM90_HEAD_DIM:
            raise ValueError("attention_bwd: a sliding window or a per-head "
                             f"bias only at head dim {FLASH_SM90_HEAD_DIM} "
                             f"(attention_bwd_sm90.cu), not {d}")
        return _bwd_pair(d)
    if attention_entry(d, True, skv, hkv) == "vls_attention_short_sm90":
        return (SHORT_BWD_SM90_ENTRY,)
    return _bwd_pair(d)


@functools.lru_cache(maxsize=256)
def short_bwd_sm90_blocks(n: int, hkv: int) -> int:
    """Blocks an SM of attention_short_bwd_sm90.cu at key tile n and hkv
    kv heads: its launch bounds' count, fewer where the shared memory (a
    1 KB alignment pad, the ring of Q / O / dO boxes, two K/V slots, the
    four consumer warps' dK / dV sums, the barriers; 228 KB an SM, 1 KB
    reserved a block) does not hold them. The C entry sizes its grid the
    same way."""
    smem = (1024 + SHORT_BWD_SM90_STAGES * 3 * SHORT_SM90_BQ * 32
            + 2 * 2 * hkv * max(n, 16) * 32 + 4 * 2 * 16 * n * 4
            + (2 * SHORT_BWD_SM90_STAGES + 4) * 8)
    return max(1, min(SHORT_BWD_SM90_BLOCKS[n], 233472 // (smem + 1024)))


@functools.lru_cache(maxsize=256)
def short_bwd_sm90_chunks(batch: int, hq: int, sq: int, slots: int) -> int:
    """How many chunks attention_short_bwd_sm90.cu cuts each batch row's
    64-row q tiles into: the count whose work units (batch row, chunk, q
    head), dealt to min(units, slots) blocks in turn, give the busiest
    block the least work, counting a unit's own cost (its K/V load and
    its partial) as one q tile more; the fewest chunks among equals."""
    ntq = -(-sq // SHORT_SM90_BQ)
    best = None
    for chunks in range(1, max(ntq, 1) + 1):
        units = batch * hq * chunks
        rounds = -(-units // max(min(units, slots), 1))
        cost = rounds * (-(-ntq // chunks) + 1)
        if best is None or cost < best[0]:
            best = (cost, chunks)
    return best[1]


def short_bwd_sm90_schedule(batch: int, hq: int, hkv: int, sq: int,
                            chunks: int, grid: int):
    """attention_short_bwd_sm90.cu's work and reduction, as a pure
    function: (units, blocks, sums). units[u] = (b, chunk, h, first q
    tile, end q tile) for the unit whose [2, N, 16] partial is ws[u] (h
    fastest); blocks[i] = the units block i of `grid` runs, in order (u =
    i, i + grid, ...); sums[(b, hk)] = the units whose partials the second
    launch adds into dK / dV of batch row b, kv head hk, in its order
    (chunk, then the group's q heads)."""
    ntq = -(-sq // SHORT_SM90_BQ)
    group = hq // hkv
    units = [(b, c, h, c * ntq // chunks, (c + 1) * ntq // chunks)
             for b in range(batch) for c in range(chunks) for h in range(hq)]
    blocks = [list(range(i, len(units), grid)) for i in range(grid)]
    sums = {(b, hk): [(b * chunks + c) * hq + hk * group + g
                      for c in range(chunks) for g in range(group)]
            for b in range(batch) for hk in range(hkv)}
    return units, blocks, sums


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _short_bwd_geometry(q_shape, q_stride, k_shape, k_stride, v_stride,
                        o_stride, do_stride, es):
    """The int64 geometry array of attention_short_bwd_sm90.cu: the q, k,
    v, o and dO tensor maps, each as `flash_sm90_tensor_map` gives it for
    [B, H, S, D] views of these shapes and element strides (o and dO have
    q's shape): q, o and dO with attention_short_sm90.cu's q box (16
    columns by SHORT_SM90_BQ rows of one head), k and v with the N keys
    of every kv head of one batch row, at least 16 (N =
    `short_sm90_key_tile(Skv)`; TMA zero-fills rows past Skv). Built
    once per shape, as `_forward_geometry`."""
    d, hkv, skv = q_shape[3], k_shape[1], k_shape[2]
    qbox = (d, SHORT_SM90_BQ, 1, 1)
    kbox = (d, max(short_sm90_key_tile(skv), 16), hkv, 1)
    geom = ()
    for shape, stride, what, box in (
            (q_shape, q_stride, "q", qbox), (k_shape, k_stride, "k", kbox),
            (k_shape, v_stride, "v", kbox), (q_shape, o_stride, "out", qbox),
            (q_shape, do_stride, "dout", qbox)):
        geom += _tensor_map_dims(shape, stride, es, what, box)
    return array.array("q", geom)


def attention_bwd(q, k, v, out, dout, lse, *, scale: float, causal: bool,
                  kv_bias: Optional[torch.Tensor] = None, window: int = 0):
    """K6a + K6b: (dq, dk, dv) of `attention` from its output and
    logsumexp. q/k/v/out/dout: [B, H, S, D] bf16 views (out and dout are
    copied once if their strides do not fit); lse fp32 [B, Hq, Sq]
    contiguous; kv_bias fp32 [B, Skv] per key, [B, Hq, Skv] per head and
    key (ALiBi in the forward's key form, which its lse belongs to), or
    None (it gets no gradient); window > 0: the forward's sliding window.
    Returns dq as a [B, Hq, Sq, D] view of a contiguous [B, Sq, Hq, D]
    buffer and dk, dv as [B, Hkv, Skv, D] views of [B, Skv, Hkv, D]
    buffers. The shapes and these options choose the kernels
    (`attention_bwd_entry`): one launch of attention_short_bwd_sm90.cu
    (and its summing launch), or the dQ kernel then the dK/dV kernel of a
    pair."""
    bsz, hq, hkv, sq, skv, d = _check_qkv(q, k, v)
    route = attention_bwd_entry(
        d, skv, hkv, window,
        head_bias=kv_bias is not None and kv_bias.dim() == 3)
    if route != (SHORT_BWD_SM90_ENTRY,):
        kw = dict(scale=scale, causal=causal, kv_bias=kv_bias, window=window)
        dq, delta = _attention_bwd_dq(route[0], q, k, v, out, dout, lse, **kw)
        dk, dv = _attention_bwd_dkv(route[1], q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv
    out, dout = _addressable(out), _addressable(dout)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("attention_bwd: out and dout must have q's shape")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (bsz, hq, sq) \
            or not lse.is_contiguous():
        raise ValueError("attention_bwd: lse must be a contiguous fp32 "
                         "[B, Hq, Sq] tensor")
    # the tensor maps check the strides TMA needs, before any launch
    geom = _short_bwd_geometry(q.shape, q.stride(), k.shape, k.stride(),
                               v.stride(), out.stride(), dout.stride(),
                               q.element_size())
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (out, "out"),
                    (dout, "dout")):
        _require(t, what, contiguous=False)
    _require(lse, "lse", dtype=torch.float32)
    bias_sb = _bias_stride(kv_bias, bsz, skv)
    dq = _bshd(bsz, sq, hq, d, q)
    dk = _bshd(bsz, skv, hkv, d, k)
    dv = _bshd(bsz, skv, hkv, d, v)
    n = short_sm90_key_tile(skv)
    slots = _sm_count(q.device.index) * short_bwd_sm90_blocks(n, hkv)
    chunks = short_bwd_sm90_chunks(bsz, hq, sq, slots)
    ws = torch.empty((bsz * chunks * hq, 2, n, d), device=q.device,
                     dtype=torch.float32)
    code = LIBRARY.get().vls_attention_short_bwd_sm90(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(kv_bias),
        _ptr(lse), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(ws),
        geom.buffer_info()[0], *_strides3(dq), *_strides3(dk),
        *_strides3(dv), bias_sb, chunks, int(causal), float(scale),
        _stream())
    _check_code("attention_bwd", code)
    ATTENTION_BWD_LAUNCHES.add(SHORT_BWD_SM90_ENTRY)
    return dq, dk, dv


def flash_bwd_sm90_geometry(q, k, v, dout):
    """The four tensor maps (q, k, v, dO) that attention_bwd_sm90.cu's
    entries encode, each as `flash_sm90_tensor_map` gives it with the
    backward's 64 x 64 box: 44 int64."""
    geom = []
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (dout, "dout")):
        geom += flash_sm90_tensor_map(t, what, FLASH_SM90_BWD_BOX)
    return tuple(geom)


def _strides3(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _bwd_common(entry, q, k, v, dout, lse, kv_bias, window):
    bsz, hq, hkv, sq, skv, d = _check_qkv(q, k, v)
    qs, ks, vs = (_strides_bhs(q, "q"), _strides_bhs(k, "k"),
                  _strides_bhs(v, "v"))
    dout, ds_ = _bhs_operand(dout, "dout")
    if dout.shape != q.shape:
        raise ValueError("attention_bwd: dout must have q's shape")
    _require(lse, "lse", dtype=torch.float32)
    if tuple(lse.shape) != (bsz, hq, sq):
        raise ValueError("attention_bwd: lse must be [B, Hq, Sq]")
    if window < 0:
        raise ValueError(f"attention_bwd: window must be >= 0, got {window}")
    bias_s = _bias_strides(kv_bias, bsz, hq, skv)
    if (window or bias_s[1]) and entry not in _bwd_pair(FLASH_SM90_HEAD_DIM):
        raise ValueError(f"attention_bwd: {entry} takes neither a sliding "
                         "window nor a per-head bias")
    return (bsz, hq, hkv, sq, skv, d), (qs, ks, vs), dout, ds_, bias_s


def attention_bwd_dq(q, k, v, out, dout, lse, *, scale: float,
                     causal: bool, kv_bias: Optional[torch.Tensor] = None,
                     window: int = 0):
    """K6a of a pair: dQ of `attention` from its output and logsumexp,
    and the per-row delta = rowsum(dO * O) fp32 [B, Hq, Sq] that
    `attention_bwd_dkv` reads. q/k/v/out/dout: [B, H, S, D] bf16 views
    (out and dout are copied once if their strides do not fit); lse fp32
    [B, Hq, Sq] contiguous; kv_bias and window as `attention_bwd`.
    Returns (dq as a [B, Hq, Sq, D] view of a contiguous [B, Sq, Hq, D]
    buffer, delta). The head dim chooses the pair's kernel:
    attention_bwd_sm90.cu at 128, attention_bwd.cu at every other (also
    where `attention_bwd` takes the one-pass kernel)."""
    return _attention_bwd_dq(_bwd_pair(q.shape[-1])[0], q, k, v, out, dout,
                             lse, scale=scale, causal=causal,
                             kv_bias=kv_bias, window=window)


def _attention_bwd_dq(entry, q, k, v, out, dout, lse, *, scale, causal,
                      kv_bias, window=0):
    """`attention_bwd_dq` through the C entry `entry`."""
    shape, qkv_s, dout, ds_, bias_s = _bwd_common(entry, q, k, v, dout, lse,
                                                  kv_bias, window)
    bsz, hq, hkv, sq, skv, d = shape
    out, os_ = _bhs_operand(out, "out")
    if out.shape != q.shape:
        raise ValueError("attention_bwd: out must have q's shape")
    delta = torch.empty((bsz, hq, sq), device=q.device, dtype=torch.float32)
    dq = _bshd(bsz, sq, hq, d, q)
    lib = LIBRARY.get()
    if entry == "vls_flash_bwd_dq_sm90":
        geom = (ctypes.c_longlong * 44)(
            *flash_bwd_sm90_geometry(q, k, v, dout))
        code = lib.vls_flash_bwd_dq_sm90(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout),
            _ptr(kv_bias), _ptr(lse), _ptr(delta), _ptr(dq),
            ctypes.cast(geom, ctypes.c_void_p), *os_, *_strides3(dq),
            *bias_s, float(scale), int(causal), int(window), _stream())
    else:
        code = lib.vls_attention_bwd_dq(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(kv_bias),
            _ptr(lse), _ptr(delta), _ptr(dq), *qkv_s[0], *qkv_s[1],
            *qkv_s[2], *os_, *ds_, *_strides3(dq), bias_s[0], bsz, hq, hkv,
            sq, skv, d, float(scale), int(causal), _stream())
    _check_code("attention_bwd_dq", code)
    ATTENTION_BWD_LAUNCHES.add(entry)
    return dq, delta


def attention_bwd_dkv(q, k, v, dout, lse, delta, *, scale: float,
                      causal: bool, kv_bias: Optional[torch.Tensor] = None,
                      window: int = 0):
    """K6b of a pair: dK and dV of `attention`, summed over each kv
    head's group of q heads in the kernel. delta: from
    `attention_bwd_dq`; kv_bias and window as `attention_bwd`. Returns
    (dk, dv), each a [B, Hkv, Skv, D] view of a contiguous [B, Skv, Hkv,
    D] buffer. The head dim chooses the pair's kernel, as in
    `attention_bwd_dq`."""
    return _attention_bwd_dkv(_bwd_pair(q.shape[-1])[1], q, k, v, dout, lse,
                              delta, scale=scale, causal=causal,
                              kv_bias=kv_bias, window=window)


def _attention_bwd_dkv(entry, q, k, v, dout, lse, delta, *, scale, causal,
                       kv_bias, window=0):
    """`attention_bwd_dkv` through the C entry `entry`."""
    shape, qkv_s, dout, ds_, bias_s = _bwd_common(entry, q, k, v, dout, lse,
                                                  kv_bias, window)
    bsz, hq, hkv, sq, skv, d = shape
    _require(delta, "delta", dtype=torch.float32)
    if tuple(delta.shape) != (bsz, hq, sq):
        raise ValueError("attention_bwd: delta must be [B, Hq, Sq]")
    dk = _bshd(bsz, skv, hkv, d, k)
    dv = _bshd(bsz, skv, hkv, d, v)
    lib = LIBRARY.get()
    if entry == "vls_flash_bwd_dkv_sm90":
        geom = (ctypes.c_longlong * 44)(
            *flash_bwd_sm90_geometry(q, k, v, dout))
        code = lib.vls_flash_bwd_dkv_sm90(
            _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(kv_bias), _ptr(lse),
            _ptr(delta), _ptr(dk), _ptr(dv),
            ctypes.cast(geom, ctypes.c_void_p), *_strides3(dk),
            *_strides3(dv), *bias_s, float(scale), int(causal), int(window),
            _stream())
    else:
        code = lib.vls_attention_bwd_dkv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(kv_bias), _ptr(lse),
            _ptr(delta), _ptr(dk), _ptr(dv), *qkv_s[0], *qkv_s[1],
            *qkv_s[2], *ds_, *_strides3(dk), *_strides3(dv), bias_s[0], bsz,
            hq, hkv, sq, skv, d, float(scale), int(causal), _stream())
    _check_code("attention_bwd_dkv", code)
    ATTENTION_BWD_LAUNCHES.add(entry)
    return dk, dv


class PoolPlan(NamedTuple):
    """pool_sm90.cu's launch: items of one output row by `cw` output
    columns (`chunks` a row, `items` in all), `stages` stages of
    `stage_bytes` (both input row pieces), `grid` persistent blocks of
    `smem` bytes of dynamic shared memory."""
    cw: int
    chunks: int
    items: int
    stage_bytes: int
    stages: int
    grid: int
    smem: int


@functools.lru_cache(maxsize=256)
def maxpool_sm90_plan(n: int, h: int, w: int, c: int, sms: int = H100_SMS):
    """pool_sm90.cu's geometry for a 2x2 max pool of an [n, h, w, c] map,
    or None where it does not take the map (an empty output, c % 8, more
    than POOL_SM90_MAX_VECS output vectors in an item of one pixel, 2^31
    items or more). Pure; cached per shape, as `_forward_geometry`."""
    oh, ow = h // 2, w // 2
    if n <= 0 or oh <= 0 or ow <= 0 or c <= 0 or c % 8:
        return None
    if c // 8 > POOL_SM90_MAX_VECS:
        return None
    cw = 1
    while 2 * cw <= ow and 8 * 2 * cw * c <= POOL_SM90_STAGE:
        cw *= 2
    chunks = -(-ow // cw)
    items = n * oh * chunks
    if items >= 1 << 31:
        return None
    stage_bytes = 8 * cw * c
    return PoolPlan(cw, chunks, items, stage_bytes, ROW_STREAM_STAGES,
                    _row_stream_grid(items, sms),
                    128 + ROW_STREAM_BARS + ROW_STREAM_STAGES * stage_bytes)


def maxpool_entry(n: int, h: int, w: int, c: int) -> str:
    """The C entry that serves `maxpool2x2` on an [n, h, w, c] map:
    pool_sm90.cu where `maxpool_sm90_plan` takes it (c % 8 == 0: every
    shortcut map of K4), pool.cu otherwise."""
    if maxpool_sm90_plan(n, h, w, c) is not None:
        return MAXPOOL_SM90_ENTRY
    return "vls_maxpool2x2_bf16"


def maxpool2x2(x: torch.Tensor, route: Optional[str] = None) -> torch.Tensor:
    """2x2 max pool of a contiguous NHWC bf16 map (the plain version is
    `ops.hiera_block.max_pool_2x2`). The map chooses the kernel
    (`maxpool_entry`); `route` names a C entry of MAXPOOL_ROUTES instead.
    pool_sm90.cu drops an odd last row or column, as the plain version;
    pool.cu takes even H and W only."""
    if route is not None and route not in MAXPOOL_ROUTES:
        raise ValueError(f"maxpool2x2: route must be one of "
                         f"{MAXPOOL_ROUTES}, got {route!r}")
    _require(x, "maxpool2x2 x")
    n, h, w, c = x.shape
    entry = route or maxpool_entry(n, h, w, c)
    if entry != MAXPOOL_SM90_ENTRY and (h % 2 or w % 2):
        raise ValueError("maxpool2x2: pool.cu takes even H and W only")
    y = torch.empty((n, h // 2, w // 2, c), device=x.device, dtype=x.dtype)
    if entry == MAXPOOL_SM90_ENTRY:
        plan = maxpool_sm90_plan(n, h, w, c, _sm_count(x.device.index))
        if plan is None:
            raise ValueError(f"maxpool2x2: {MAXPOOL_SM90_ENTRY} does not "
                             f"take {tuple(x.shape)}")
        code = LIBRARY.get().vls_maxpool2x2_sm90(
            _ptr(x), _ptr(y), n, h, w, c, plan.cw, plan.stages, plan.grid,
            _stream())
    else:
        code = LIBRARY.get().vls_maxpool2x2_bf16(_ptr(x), _ptr(y), n, h, w,
                                                 c, _stream())
    _check_code("maxpool2x2", code)
    MAXPOOL_LAUNCHES.add(entry)
    return y


def w4a8_splits(half: int, out: int) -> int:
    """Blocks along K for the decode GEMV: enough blocks to fill the card
    when out has few 128-column tiles, each still taking >= 64 groups of
    4 packed rows (8 per warp)."""
    col_blocks = -(-out // 128)
    want = -(-W4A8_GEMV_TARGET_BLOCKS // col_blocks)
    return max(1, min(want, (half // 4) // 64))


def w4a8_entry(rows: int, half: int, out: int) -> str:
    """The C entry that serves `w4a8_matmul` at [rows, 2 half] x [2 half,
    out]. At <= 8 rows: the TMA weight stream of csrc/w4a8_gemv_sm90.cu
    where `w4a8_gemv_plan` takes the shape (half and out multiples of 16,
    rows x in <= W4A8_GEMV_X_MAX), else csrc/w4a8.cu's GEMV. Above: the
    TMA + wgmma kernel of csrc/w4a8_sm90.cu where TMA can address the
    operands (half and out multiples of 16), csrc/w4a8.cu's mma.sync tile
    for every other shape."""
    if rows <= W4A8_GEMV_MAX_ROWS:
        return (W4A8_GEMV_ENTRY if w4a8_gemv_plan(rows, half, out)
                is not None else "vls_w4a8")
    if half % W4A8_SM90_ALIGN == 0 and out % W4A8_SM90_ALIGN == 0:
        return "vls_w4a8_sm90"
    return "vls_w4a8"


class W4A8GemvPlan(NamedTuple):
    """w4a8_gemv_sm90.cu's launch: k_boxes boxes of box_k packed rows down
    each of `tiles` column tiles of box_n columns. parts == 1: `grid`
    blocks (one an SM, at most one a tile) take whole tiles in rounds,
    block i tiles i, i + grid, ...; parts > 1: the grid is tiles x parts
    blocks in clusters of `parts`, block i part i % parts of tile i //
    parts (K boxes [p k_boxes // parts, (p + 1) k_boxes // parts)).
    `stages` boxes a ring, `smem` bytes of dynamic shared memory."""
    k_boxes: int
    tiles: int
    parts: int
    grid: int
    stages: int
    smem: int


def w4a8_gemv_smem(rows: int, in_dim: int, stages: int,
                   box_k: int = W4A8_GEMV_BOX_K,
                   box_n: int = W4A8_GEMV_BOX_N) -> int:
    """Dynamic shared memory of a w4a8_gemv_sm90.cu block, as the kernel
    lays it out from a 128-byte-aligned base: the ring, the activation
    rows (+ one box of K: reads past in/2 in a K-tail box), the [rows,
    box_n] int32 sums, 2 stages + 1 mbarriers."""
    x = -(-(rows * in_dim + box_k) // 16) * 16
    return (128 + stages * box_k * box_n + x + rows * box_n * 4
            + (2 * stages + 1) * 8)


@functools.lru_cache(maxsize=None)
def w4a8_gemv_plan(rows: int, half: int, out: int, sms: int = H100_SMS,
                   box_k: int = W4A8_GEMV_BOX_K,
                   box_n: int = W4A8_GEMV_BOX_N,
                   slots: tuple = W4A8_GEMV_H100_SLOTS
                   ) -> Optional[W4A8GemvPlan]:
    """The plan of w4a8_gemv_sm90.cu at [rows, 2 half] x [2 half, out] on
    a card of `sms` SMs, or None where the kernel does not take the shape
    (rows outside 1..8; half or out not a multiple of 16: TMA's 16-byte
    row stride and the activations' bulk copy of the high plane at in/2;
    rows x in over W4A8_GEMV_X_MAX; fewer than W4A8_GEMV_MIN_STAGES
    stages beside the activations). K split into the most parts, up to
    W4A8_GEMV_MAX_PARTS and k_boxes, whose clusters the card holds all at
    once (tiles <= slots[parts - 1]: clusters of that many blocks, one an
    SM, the card holds together); the deepest ring that fits. box_k /
    box_n: the kernel's BK / BN (other values for
    scripts/probe_w4a8_gemv.py's variants only)."""
    if not (1 <= rows <= W4A8_GEMV_MAX_ROWS) or half <= 0 or out <= 0:
        return None
    if half % W4A8_SM90_ALIGN or out % W4A8_SM90_ALIGN:
        return None
    if rows * 2 * half > W4A8_GEMV_X_MAX:
        return None
    stages = W4A8_GEMV_MAX_STAGES
    while stages >= W4A8_GEMV_MIN_STAGES and w4a8_gemv_smem(
            rows, 2 * half, stages, box_k, box_n) > SM90_SMEM_MAX:
        stages -= 1
    if stages < W4A8_GEMV_MIN_STAGES:
        return None
    k_boxes = -(-half // box_k)
    tiles = -(-out // box_n)
    parts = max([p for p in range(2, min(W4A8_GEMV_MAX_PARTS, k_boxes) + 1)
                 if tiles <= slots[p - 1] and tiles * p <= sms], default=1)
    grid = tiles * parts if parts > 1 else min(sms, tiles)
    return W4A8GemvPlan(k_boxes, tiles, parts, grid, stages,
                        w4a8_gemv_smem(rows, 2 * half, stages, box_k, box_n))


def w4a8_gemv_units(plan: W4A8GemvPlan):
    """The kernel's dealing (`for_each_unit`), block by block: each
    block's units, (column tile, first K box, end K box), in the order it
    takes them."""
    if plan.parts == 1:
        return [[(t, 0, plan.k_boxes)
                 for t in range(i, plan.tiles, plan.grid)]
                for i in range(plan.grid)]
    return [[(i // plan.parts, i % plan.parts * plan.k_boxes // plan.parts,
              (i % plan.parts + 1) * plan.k_boxes // plan.parts)]
            for i in range(plan.grid)]


@functools.lru_cache(maxsize=None)
def w4a8_gemv_sm90_geometry(half: int, out: int,
                            box_k: int = W4A8_GEMV_BOX_K,
                            box_n: int = W4A8_GEMV_BOX_N):
    """The int8 tensor map of packed [half, out] (contiguous) that
    csrc/w4a8_gemv_sm90.cu encodes, GEOM_2D int64: byte offset 0, dims
    (out, half) innermost first, the row stride out bytes, box (box_n
    columns, box_k packed rows); no swizzle. TMA needs a row stride in
    multiples of 16 bytes; the activations' bulk copy needs the high
    plane's base (xq + half) 16-byte aligned."""
    if half <= 0 or out <= 0:
        raise ValueError(f"w4a8_gemv_sm90: empty weight [{half}, {out}]")
    if half % W4A8_SM90_ALIGN or out % W4A8_SM90_ALIGN:
        raise ValueError(f"w4a8_gemv_sm90: TMA needs in/2 and out in "
                         f"multiples of {W4A8_SM90_ALIGN}, got in/2={half}, "
                         f"out={out}")
    return (0, out, half, out, box_n, box_k)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cluster_slots(index: int, smem: int) -> tuple:
    """Clusters of 1..W4A8_GEMV_MAX_PARTS blocks of `smem` bytes that
    device `index` holds at once."""
    with torch.cuda.device(index):
        lib = LIBRARY.get()
        return tuple(max(lib.vls_w4a8_gemv_sm90_clusters(p, smem), 0)
                     for p in range(1, W4A8_GEMV_MAX_PARTS + 1))


@functools.lru_cache(maxsize=None)
def _gemv_args(rows: int, half: int, out: int, index: int):
    """(plan, the geometry as a ctypes array) of a call on device `index`,
    built once a shape: the call is on the decode step's hot path."""
    first = w4a8_gemv_plan(rows, half, out)
    if first is None:
        raise ValueError(f"w4a8_gemv_sm90: does not take [{rows}, "
                         f"{2 * half}] x [{2 * half}, {out}]")
    plan = w4a8_gemv_plan(rows, half, out, _sm_count(index),
                          slots=_cluster_slots(index, first.smem))
    geom = (ctypes.c_longlong * 6)(*w4a8_gemv_sm90_geometry(half, out))
    return plan, geom


def w4a8_sm90_geometry(xq: torch.Tensor, packed: torch.Tensor):
    """The three int8 tensor maps that csrc/w4a8_sm90.cu encodes, 18
    int64: for xq's low plane, its high plane (base xq + in/2, so each
    plane's K tail is zero-filled on its own) and packed, each (byte
    offset of the map's base, dims (inner, outer), the outer byte stride,
    box (inner, outer)). TMA needs a contiguous inner dim, a 16-byte
    aligned base and outer byte strides in multiples of 16."""
    for t, what in ((xq, "xq"), (packed, "packed")):
        if t.dim() != 2 or t.stride(1) != 1 or t.element_size() != 1:
            raise ValueError(f"w4a8_sm90 {what}: expected a 2-D int8 tensor "
                             "with a contiguous last dim")
        if t.data_ptr() % W4A8_SM90_ALIGN or t.stride(0) % W4A8_SM90_ALIGN:
            raise ValueError(f"w4a8_sm90 {what}: TMA needs a 16-byte-aligned "
                             "base and a row stride in multiples of 16 "
                             f"bytes, got stride {t.stride(0)}")
    rows, in_dim = xq.shape
    half, out = packed.shape
    if in_dim != 2 * half:
        raise ValueError(f"w4a8_sm90: xq has in={in_dim}, packed has "
                         f"in/2={half}")
    if half % W4A8_SM90_ALIGN or out % W4A8_SM90_ALIGN:
        raise ValueError(f"w4a8_sm90: TMA needs in/2 and out in multiples of "
                         f"{W4A8_SM90_ALIGN}, got in/2={half}, out={out}")
    x_box = (W4A8_SM90_BOX_K, W4A8_SM90_BOX_ROWS)
    w_box = (W4A8_SM90_BOX_COLS, W4A8_SM90_BOX_K)
    return ((0, half, rows, xq.stride(0)) + x_box
            + (half, half, rows, xq.stride(0)) + x_box
            + (0, out, half, packed.stride(0)) + w_box)


def w4a8_matmul(xq: torch.Tensor, a_scale: torch.Tensor,
                packed: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype,
                route: Optional[str] = None) -> torch.Tensor:
    """(int32(xq @ unpack(packed)) * a_scale) * w_scale -> out_dtype.

    xq int8 [rows, in]; a_scale fp32 [rows, 1]; packed int8 [in/2, out]
    (the "halves" int4 layout); w_scale fp32 [out]; out_dtype bf16 or
    fp32. The shape chooses the kernel (`w4a8_entry`); `route` names a C
    entry of W4A8_ROUTES instead, for the tests and for timing csrc/
    w4a8.cu beside the kernels that took its prefill and decode shapes.
    W4A8_LAUNCHES counts the launches by C entry."""
    if route is not None and route not in W4A8_ROUTES:
        raise ValueError(f"w4a8: route must be one of {W4A8_ROUTES}, got "
                         f"{route!r}")
    _require(xq, "w4a8 xq", dtype=torch.int8)
    _require(a_scale, "w4a8 a_scale", dtype=torch.float32)
    _require(packed, "w4a8 packed", dtype=torch.int8)
    _require(w_scale, "w4a8 w_scale", dtype=torch.float32)
    if xq.dim() != 2 or packed.dim() != 2:
        raise ValueError("w4a8: xq and packed must be 2-D")
    rows, in_dim = xq.shape
    half, out = packed.shape
    if in_dim != 2 * half:
        raise ValueError(f"w4a8: xq has in={in_dim}, packed has in/2={half}")
    if in_dim % 8 or out % 4 or in_dim > W4A8_MAX_IN:
        raise ValueError(f"w4a8: needs in % 8 == 0, out % 4 == 0 and in <= "
                         f"{W4A8_MAX_IN}, got in={in_dim}, out={out}")
    if a_scale.numel() != rows or w_scale.numel() != out:
        raise ValueError("w4a8: a_scale must have rows and w_scale out "
                         "elements")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w4a8: out_dtype must be bf16 or fp32, got "
                         f"{out_dtype}")
    y = torch.empty((rows, out), device=xq.device, dtype=out_dtype)
    entry = route or w4a8_entry(rows, half, out)
    if entry == W4A8_GEMV_ENTRY:
        plan, geom = _gemv_args(rows, half, out, xq.device.index)
        _check_code("w4a8_gemv_sm90", LIBRARY.get().vls_w4a8_gemv_sm90(
            _ptr(xq), _ptr(a_scale), _ptr(packed), _ptr(w_scale), _ptr(y),
            ctypes.cast(geom, ctypes.c_void_p), rows, half, out,
            int(out_dtype == torch.float32), plan.parts, plan.grid,
            plan.stages, _stream()))
        W4A8_LAUNCHES.add(entry)
        return y
    if entry == "vls_w4a8_sm90":
        geom = (ctypes.c_longlong * 18)(*w4a8_sm90_geometry(xq, packed))
        _check_code("w4a8_sm90", LIBRARY.get().vls_w4a8_sm90(
            _ptr(xq), _ptr(a_scale), _ptr(packed), _ptr(w_scale), _ptr(y),
            ctypes.cast(geom, ctypes.c_void_p), rows, half, out,
            int(out_dtype == torch.float32), _stream()))
        W4A8_LAUNCHES.add(entry)
        return y
    ksplit, work = 1, None
    if rows <= W4A8_GEMV_MAX_ROWS:
        ksplit = w4a8_splits(half, out)
        if ksplit > 1:
            work = torch.empty((ksplit, rows, out), device=xq.device,
                               dtype=torch.int32)
    _check_code("w4a8", LIBRARY.get().vls_w4a8(
        _ptr(xq), _ptr(a_scale), _ptr(packed), _ptr(w_scale), _ptr(y),
        _ptr(work), rows, in_dim, out, int(out_dtype == torch.float32),
        ksplit, _stream()))
    W4A8_LAUNCHES.add(entry)
    return y


def _rows2d(x: torch.Tensor, what: str):
    _require(x, what)
    if x.dim() != 2 or x.shape[1] % 8:
        raise ValueError(f"{what}: expected [rows, cols] with cols % 8 == 0, "
                         f"got {tuple(x.shape)}")
    return x.shape


class QuantRowsPlan(NamedTuple):
    """w8a8_rows_sm90.cu's launch: G lanes a row, `vecs` 16-byte vectors a
    lane (the kernel instance), `tile_rows` rows a stage (one bulk copy),
    `stages` stages of `stage_bytes`, `tiles` tiles over the rows, `grid`
    persistent blocks of `smem` bytes of dynamic shared memory."""
    group: int
    vecs: int
    tile_rows: int
    stage_bytes: int
    stages: int
    tiles: int
    grid: int
    smem: int


@functools.lru_cache(maxsize=256)
def quant_rows_sm90_plan(rows: int, cols: int, ln: bool,
                         sms: int = H100_SMS):
    """w8a8_rows_sm90.cu's geometry for quantizing [rows, cols] (after a
    LayerNorm where `ln`), or None where it does not take the shape (no
    rows, cols % 8, more than QUANT_ROWS_SM90_LN_VECS vectors a lane after
    a LayerNorm: cols > 1280, more than QUANT_ROWS_SM90_MAX_VECS without:
    cols > 5120). Pure; cached per shape."""
    if rows <= 0 or cols <= 0 or cols % 8:
        return None
    v = cols // 8
    group = 1
    while group < 32 and -(-v // group) > LN_SM90_LANE_VECS:
        group *= 2
    need = -(-v // group)
    if need > (QUANT_ROWS_SM90_LN_VECS if ln else QUANT_ROWS_SM90_MAX_VECS):
        return None
    vecs = min(n for n in QUANT_ROWS_SM90_VECS if n >= need)
    tile_rows = ROW_STREAM_WARPS * (32 // group)
    stage_bytes = tile_rows * cols * 2
    tiles = -(-rows // tile_rows)
    fixed = 128 + ROW_STREAM_BARS + ((8 * cols + 127) // 128 * 128
                                     if ln else 0)
    stages = ROW_STREAM_STAGES
    while stages >= QUANT_ROWS_SM90_MIN_STAGES and \
            fixed + stages * stage_bytes > SMEM_BLOCK_MAX:
        stages -= 1
    if stages < QUANT_ROWS_SM90_MIN_STAGES:
        return None
    smem = fixed + stages * stage_bytes
    grid = _row_stream_grid(tiles, sms)
    if SMEM_SM // (smem + SMEM_RESERVED) < 2:
        # one block an SM where two rings do not fit (fc1's widths)
        grid = min(tiles, sms)
    return QuantRowsPlan(group, vecs, tile_rows, stage_bytes, stages, tiles,
                         grid, smem)


def quant_rows_entry(rows: int, cols: int, ln: bool) -> str:
    """The C entry that serves `quant_rows` (ln False) or `ln_quant_rows`
    (ln True) on a [rows, cols] input: w8a8_rows_sm90.cu where
    `quant_rows_sm90_plan` takes the shape (cols % 8 == 0; cols <= 1280
    after a LayerNorm, <= 5120 without: every row quantizer of K8 at
    CLIP-L's and RADIO-H's widths), w8a8.cu otherwise."""
    if quant_rows_sm90_plan(rows, cols, ln) is not None:
        return QUANT_ROWS_SM90_ENTRY
    return "vls_quant_rows"


def quant_rows_plain(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                     beta: Optional[torch.Tensor] = None, eps: float = 0.0):
    """The row quantizers' plain twin: `quantize_activations_rowwise` of x,
    or of `ops.nn.layer_norm(x)` (fp32, rounded to x's dtype) where gamma
    and beta are given. The CPU path (`ops.vit_block.vit_layer_plain`)
    computes the same through `nn.dense`; the tests and chip_smoke hold
    the kernels to it."""
    from video_llava_seg_torch.ops import nn
    from video_llava_seg_torch.ops.quantization import (
        quantize_activations_rowwise,
    )

    if gamma is not None:
        x = nn.layer_norm({"scale": gamma, "bias": beta}, x, eps)
    return quantize_activations_rowwise(x)


def _quant_rows(x, gamma, beta, eps: float, ln: bool, route):
    if route is not None and route not in QUANT_ROWS_ROUTES:
        raise ValueError(f"quant_rows: route must be one of "
                         f"{QUANT_ROWS_ROUTES}, got {route!r}")
    rows, cols = _rows2d(x, "quant_rows x")
    q = torch.empty((rows, cols), device=x.device, dtype=torch.int8)
    scale = torch.empty((rows, 1), device=x.device, dtype=torch.float32)
    entry = route or quant_rows_entry(rows, cols, ln)
    if entry == QUANT_ROWS_SM90_ENTRY:
        plan = quant_rows_sm90_plan(rows, cols, ln, _sm_count(x.device.index))
        if plan is None:
            raise ValueError(f"quant_rows: {QUANT_ROWS_SM90_ENTRY} does not "
                             f"take [{rows}, {cols}] (ln {ln})")
        code = LIBRARY.get().vls_quant_rows_sm90(
            _ptr(x), _ptr(gamma), _ptr(beta), _ptr(q), _ptr(scale), rows,
            cols, float(eps), int(ln),
            int(gamma is not None and gamma.dtype == torch.float32),
            plan.group, plan.vecs, plan.stages, plan.grid, _stream())
    else:
        if gamma is not None:
            # w8a8.cu takes fp32 gamma / beta
            gamma, beta = gamma.float(), beta.float()
        code = LIBRARY.get().vls_quant_rows(
            _ptr(x), _ptr(gamma), _ptr(beta), _ptr(q), _ptr(scale), rows,
            cols, float(eps), int(ln), _stream())
    _check_code("quant_rows", code)
    QUANT_ROWS_LAUNCHES.add(entry)
    return q, scale


def quant_rows(x: torch.Tensor, route: Optional[str] = None):
    """Per-row symmetric int8 quantization of a contiguous bf16 [rows,
    cols] tensor, bit-equal to `quantize_activations_rowwise`. Returns
    (int8 [rows, cols], fp32 scale [rows, 1]). The shape chooses the
    kernel (`quant_rows_entry`); `route` names a C entry of
    QUANT_ROWS_ROUTES instead, for the tests and for timing w8a8.cu."""
    return _quant_rows(x, None, None, 0.0, False, route)


def ln_quant_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float, route: Optional[str] = None):
    """LayerNorm in fp32 (gamma, beta [cols], both bf16 or both fp32, as
    the tree stores them), rounded to bf16, then per-row int8
    quantization. Returns (int8 [rows, cols], fp32 [rows, 1]). `route`
    as `quant_rows`'."""
    cols = x.shape[-1]
    if gamma.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ln_quant_rows: gamma must be bf16 or fp32, got "
                         f"{gamma.dtype}")
    for t, what in ((gamma, "gamma"), (beta, "beta")):
        _require(t, f"ln_quant_rows {what}", dtype=gamma.dtype)
        if t.numel() != cols:
            raise ValueError(f"ln_quant_rows: {what} must have {cols} "
                             "elements")
    return _quant_rows(x, gamma, beta, eps, True, route)


def gemm_s8_entry(m: int, k: int, n: int) -> str:
    """The C entry that serves `gemm_s8` at [m, k] x [k, n]: the TMA +
    wgmma kernel of csrc/w8a8_sm90.cu where TMA can address the operands
    (k and n multiples of 16: 16-byte row strides; the wrapper requires
    16-byte-aligned bases), csrc/w8a8.cu's mma.sync tile for every other
    shape."""
    if (m > 0 and k > 0 and k % GEMM_S8_SM90_ALIGN == 0
            and n % GEMM_S8_SM90_ALIGN == 0):
        return "vls_gemm_s8_sm90"
    return "vls_gemm_s8"


def gemm_s8_sm90_geometry(a: torch.Tensor, b: torch.Tensor):
    """The two int8 tensor maps that csrc/w8a8_sm90.cu encodes, 12 int64:
    for a [M, K] and b [K, N], each (byte offset of the map's base, dims
    (inner, outer), the outer byte stride, box (inner, outer)). TMA needs
    a contiguous inner dim, a 16-byte-aligned base and outer byte strides
    in multiples of 16."""
    for t, what in ((a, "a"), (b, "b")):
        if t.dim() != 2 or t.stride(1) != 1 or t.element_size() != 1:
            raise ValueError(f"gemm_s8_sm90 {what}: expected a 2-D int8 "
                             "tensor with a contiguous last dim")
        if (t.data_ptr() % GEMM_S8_SM90_ALIGN
                or t.stride(0) % GEMM_S8_SM90_ALIGN):
            raise ValueError(f"gemm_s8_sm90 {what}: TMA needs a 16-byte-"
                             "aligned base and a row stride in multiples of "
                             f"16 bytes, got stride {t.stride(0)}")
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"gemm_s8_sm90: a has K={k}, b has K={b.shape[0]}")
    n = b.shape[1]
    if k % GEMM_S8_SM90_ALIGN or n % GEMM_S8_SM90_ALIGN:
        raise ValueError(f"gemm_s8_sm90: TMA needs K and N in multiples of "
                         f"{GEMM_S8_SM90_ALIGN}, got K={k}, N={n}")
    return ((0, k, m, a.stride(0), GEMM_S8_SM90_BOX_K, GEMM_S8_SM90_BOX_ROWS)
            + (0, n, k, b.stride(0), GEMM_S8_SM90_BOX_COLS,
               GEMM_S8_SM90_BOX_K))


def gemm_s8(a: torch.Tensor, b: torch.Tensor,
            a_scale: Optional[torch.Tensor] = None,
            w_scale: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None,
            scale: Optional[float] = None, act: str = "none",
            route: Optional[str] = None):
    """int8 a [M, K] @ int8 b [K, N] on the tensor cores.

    Without scales: the exact int32 product [M, N]. With a_scale (fp32,
    M elements) and w_scale (fp32 [N]): the W8A8 dense epilogue in bf16,
    bf16((acc * a_scale) * w_scale) [+ bias] [* bf16(scale) | act]
    [+ residual], every step rounded to bf16; bias bf16 [N], residual
    bf16 [M, N]. The shape chooses the kernel (`gemm_s8_entry`); `route`
    names a C entry of GEMM_S8_ROUTES instead, for the tests and for
    timing csrc/w8a8.cu beside the kernel that took its shapes."""
    if route is not None and route not in GEMM_S8_ROUTES:
        raise ValueError(f"gemm_s8: route must be one of {GEMM_S8_ROUTES}, "
                         f"got {route!r}")
    _require(a, "gemm_s8 a", dtype=torch.int8)
    _require(b, "gemm_s8 b", dtype=torch.int8)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_s8: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if k % 4 or n % 4:
        raise ValueError(f"gemm_s8: K ({k}) and N ({n}) must be multiples "
                         "of 4")
    dense = a_scale is not None
    if dense != (w_scale is not None):
        raise ValueError("gemm_s8: give both scales or neither")
    if not dense and (bias is not None or residual is not None
                      or scale is not None or act != "none"):
        raise ValueError("gemm_s8: the int32 mode has no epilogue")
    if scale is not None and act != "none":
        raise ValueError("gemm_s8: q scale and activation are exclusive")
    if dense:
        _require(a_scale, "gemm_s8 a_scale", dtype=torch.float32)
        _require(w_scale, "gemm_s8 w_scale", dtype=torch.float32)
        if a_scale.numel() != m or w_scale.numel() != n:
            raise ValueError("gemm_s8: a_scale must have M and w_scale N "
                             "elements")
    if bias is not None:
        _require(bias, "gemm_s8 bias")
        if bias.numel() != n:
            raise ValueError("gemm_s8: bias must have N elements")
    if residual is not None:
        _require(residual, "gemm_s8 residual")
        if tuple(residual.shape) != (m, n):
            raise ValueError("gemm_s8: residual must be [M, N]")
    y = torch.empty((m, n), device=a.device,
                    dtype=torch.bfloat16 if dense else torch.int32)
    entry = route or gemm_s8_entry(m, k, n)
    epilogue = (int(dense), ACTS[act], float(scale or 0.0), _stream())
    if entry == "vls_gemm_s8_sm90":
        geom = (ctypes.c_longlong * 12)(*gemm_s8_sm90_geometry(a, b))
        code = LIBRARY.get().vls_gemm_s8_sm90(
            _ptr(a), _ptr(a_scale), _ptr(b), _ptr(w_scale), _ptr(bias),
            _ptr(residual), _ptr(y), ctypes.cast(geom, ctypes.c_void_p), m,
            n, k, *epilogue)
    else:
        code = LIBRARY.get().vls_gemm_s8(
            _ptr(a), _ptr(a_scale), _ptr(b), _ptr(w_scale), _ptr(bias),
            _ptr(residual), _ptr(y), m, n, k, *epilogue)
    _check_code("gemm_s8", code)
    GEMM_S8_LAUNCHES.add(entry)
    return y


def window_sm90_boxes(hd: int):
    """window_attention_sm90.cu's column boxes of a head of hd columns:
    (w0, t, tb) = a leading box of w0 columns (64 from head dim 64 up,
    else 32, 128- / 64-byte swizzle) and a tail box tb wide (16, 32 or
    64; 32-, 64- or 128-byte swizzle) over the t = hd - w0 columns left,
    whose map ends at t columns, so that TMA writes zeros in the tb - t
    columns past the head (at 96: 64 + 32; 72: 64 + 8 in a 16-column box;
    56: 32 + 24 in a 32-column box)."""
    w0 = 64 if hd >= 64 else 32
    t = hd - w0
    if hd % 8 or not 0 < t <= 64:
        raise ValueError(f"window_attention_sm90: no column boxes for head "
                         f"dim {hd}")
    return w0, t, 16 if t <= 16 else 32 if t <= 32 else 64


@functools.lru_cache(maxsize=None)
def window_sm90_plan(ws: int, ps: int):
    """window_attention_sm90.cu's plan for windows of ws x ws pixels with
    q pool ps: (sw, qh, nqb) = strip width in pixels, window rows of a
    query box, query boxes a unit; None where the kernel does not take
    the windows (more than WINDOW_SM90_MAX_KEYS keys, or no pooled tile
    of whole 2x2 cells). Without the pool: sw * qh <= 64 query rows a box
    (one box of all ws rows where they fit, else boxes of 64 // sw rows);
    with it: boxes of an even qh whose pooled rows make one tile."""
    if ws <= 0 or ps not in (1, 2) or ws % ps:
        return None
    rows = WINDOW_SM90_ROWS
    pow2 = ws & (ws - 1) == 0
    per_strip = rows if ps == 1 else WINDOW_SM90_POOL_KEYS
    nw = per_strip // (ws * ws) if pow2 and ws * ws < per_strip else 1
    sw = nw * ws
    if sw * ws > WINDOW_SM90_MAX_KEYS:
        return None
    if ps == 1:
        qh = ws if sw * ws <= rows else rows // sw
        nqb = -(-ws // qh)
    else:
        qh = min(rows // sw, ws) // 2 * 2
        if qh < 2:
            return None
        nqb = -(-ws // qh)
        if nqb * (qh // 2) * (sw // 2) > rows:
            return None
    return sw, qh, nqb


def window_entry(hd: int, ws: int, ps: int) -> str:
    """The C entry that serves `window_attention` at head dim hd over ws x
    ws windows with q pool ps: the TMA + wgmma kernel of
    csrc/window_attention_sm90.cu at head dims 56, 72 and 96 (every
    windowed block of SAM2.1-hiera-tiny / small / base-plus / large)
    where `window_sm90_plan` takes the windows and the head dim's key
    tile holds the strip (WINDOW_SM90_HEAD_KEYS), csrc/window_attention.cu
    for every other call (other head dims; ws 16 at head dim 96). K4's
    chain sends every windowed block's attention to the kernel this
    names (on an H100 the TMA + wgmma one beat the chain's former
    partition + attention_sm90.cu stage at every Hiera-S kind)."""
    plan = window_sm90_plan(ws, ps)
    if hd in WINDOW_SM90_HEAD_DIM and plan is not None \
            and plan[0] * ws <= WINDOW_SM90_HEAD_KEYS[hd]:
        return WINDOW_SM90_ENTRY
    return "vls_window_attention"


@functools.lru_cache(maxsize=256)
def window_sm90_geometry(shape, ws: int, ps: int, hd: int):
    """The four bf16 tensor maps that csrc/window_attention_sm90.cu
    encodes over a contiguous qkv [B, Hp, Wp, 3C] of heads of hd columns,
    4 x 15 int64: each the byte offset of its first column (0 for the
    leading box, 2 * w0 for the tail box), dims (w0 | t, 3 * heads, Wp,
    Hp, B) innermost first, the byte strides of dims 1..4 (a head, a
    pixel, a map row, an image), and its box: (w0, 1, sw, ws, 1) and
    (tb, 1, sw, ws, 1) for k and v, (w0, 1, sw, qh, 1) and (tb, 1, sw, qh,
    1) for q, with (w0, t, tb) from `window_sm90_boxes` and (sw, qh) from
    `window_sm90_plan`. TMA needs byte strides in multiples of 16 below
    2^40."""
    plan = window_sm90_plan(ws, ps)
    if plan is None:
        raise ValueError(f"window_attention_sm90: no plan for ws {ws}, "
                         f"pool {ps}")
    sw, qh, _ = plan
    w0, t, tb = window_sm90_boxes(hd)
    b, hp, wp, c3 = shape
    if c3 % (3 * hd):
        raise ValueError(f"window_attention_sm90: {c3} channels are no "
                         f"q, k, v of heads of {hd}")
    strides = (2 * hd, 2 * c3, 2 * wp * c3, 2 * hp * wp * c3)
    if min(strides) <= 0 or any(s % 16 or s >= 1 << 40 for s in strides):
        raise ValueError(f"window_attention_sm90: TMA needs byte strides "
                         f"that are positive multiples of 16 below 2^40, "
                         f"got {strides}")
    dims = (c3 // hd, wp, hp, b)
    geom = ()
    for rows in (ws, qh):
        geom += (0, w0) + dims + strides + (w0, 1, sw, rows, 1)
        geom += (2 * w0, t) + dims + strides + (tb, 1, sw, rows, 1)
    return array.array("q", geom)


def window_attention(qkv: torch.Tensor, *, num_heads: int, ws: int,
                     scale: float, ps: int = 1, out_hw=None,
                     route: Optional[str] = None) -> torch.Tensor:
    """Windowed SDPA over a contiguous fused-qkv NHWC map [B, H, W, 3C]
    (H, W multiples of ws); ps = 2 max-pools q 2x2 per window. Returns
    [B, H/ps, W/ps, C] bf16, or with out_hw = (oh, ow) its crop [B, oh,
    ow, C] (window_attention_sm90.cu writes the crop directly). The shape
    chooses the kernel (`window_entry`); `route` names a C entry of
    WINDOW_ROUTES instead, for the tests and for timing
    window_attention.cu beside the kernel that took its calls."""
    if route is not None and route not in WINDOW_ROUTES:
        raise ValueError(f"window_attention: route must be one of "
                         f"{WINDOW_ROUTES}, got {route!r}")
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError("window_attention: expected qkv [B, H, W, 3C]")
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    if num_heads <= 0 or c % num_heads or (c // num_heads) % 8 \
            or c // num_heads > WINDOW_MAX_HEAD_DIM:
        raise ValueError(f"window_attention: head dim {c / num_heads} must "
                         f"be a multiple of 8 and <= {WINDOW_MAX_HEAD_DIM}")
    if ws <= 0 or h % ws or w % ws or ws * ws > WINDOW_MAX_KEYS:
        raise ValueError(f"window_attention: ws {ws} must divide the "
                         f"{h}x{w} map and hold <= {WINDOW_MAX_KEYS} keys")
    if ps not in (1, 2) or ws % ps:
        raise ValueError(f"window_attention: pool stride {ps} must be 1 or "
                         "2 and divide ws")
    hd = c // num_heads
    entry = route or window_entry(hd, ws, ps)
    if entry == WINDOW_SM90_ENTRY and window_entry(hd, ws, ps) != entry:
        raise ValueError(f"window_attention: {entry} serves head dims "
                         f"{WINDOW_SM90_HEAD_DIM} over strips of at most "
                         f"{WINDOW_SM90_HEAD_KEYS} keys, not head dim {hd}, "
                         f"ws {ws}, pool {ps}")
    full = (h // ps, w // ps)
    oh, ow = full if out_hw is None else out_hw
    if not (0 < oh <= full[0] and 0 < ow <= full[1]):
        raise ValueError(f"window_attention: out_hw {out_hw} must crop the "
                         f"output map {full}")
    if entry == "vls_window_attention" and (
            (h // ws) * (w // ws) * num_heads > 65535 or b > 65535):
        raise ValueError("window_attention: too many windows for one launch")
    _require(qkv, "window_attention qkv")
    if entry == WINDOW_SM90_ENTRY:
        sw, qh, nqb = window_sm90_plan(ws, ps)
        geom = window_sm90_geometry(tuple(qkv.shape), ws, ps, hd)
        o = torch.empty((b, oh, ow, c), device=qkv.device, dtype=qkv.dtype)
        code = LIBRARY.get().vls_window_attention_sm90(
            _ptr(qkv), _ptr(o), geom.buffer_info()[0], b, h, w, c,
            num_heads, ws, ps, sw, qh, nqb, oh, ow, float(scale), _stream())
    else:
        o = torch.empty((b, full[0], full[1], c), device=qkv.device,
                        dtype=qkv.dtype)
        code = LIBRARY.get().vls_window_attention(
            _ptr(qkv), _ptr(o), b, h, w, c, num_heads, ws, ps, float(scale),
            _stream())
    _check_code("window_attention", code)
    WINDOW_LAUNCHES.add(entry)
    if (oh, ow) != tuple(o.shape[1:3]):
        o = o[:, :oh, :ow].contiguous()
    return o
