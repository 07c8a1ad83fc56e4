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
nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

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
    "vls_gemm_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "vls_attention_bf16": [_P] * 6 + [_L] * 13 + [_I] * 7
                          + [_F, _I, _I, _P],
    "vls_flash_fwd_sm90": [_P] * 7 + [_L] * 4 + [_I, _I, _F, _P],
    "vls_attention_bwd_dq": [_P] * 9 + [_L] * 19 + [_I] * 6 + [_F, _I, _P],
    "vls_attention_bwd_dkv": [_P] * 9 + [_L] * 19 + [_I] * 6 + [_F, _I, _P],
    "vls_flash_bwd_dq_sm90": [_P] * 10 + [_L] * 7 + [_F, _I, _P],
    "vls_flash_bwd_dkv_sm90": [_P] * 10 + [_L] * 7 + [_F, _I, _P],
    "vls_maxpool2x2_bf16": [_P, _P, _L, _I, _I, _I, _P],
    "vls_w4a8": [_P] * 6 + [_I] * 5 + [_P],
    "vls_quant_rows": [_P] * 5 + [_L, _I, _F, _I, _P],
    "vls_gemm_s8": [_P] * 7 + [_I] * 5 + [_F, _P],
    "vls_window_attention": [_P, _P] + [_I] * 7 + [_F, _P],
}

ACTS = {"none": 0, "quick_gelu": 1, "gelu": 2}
ATTENTION_HEAD_DIMS = (16, 32, 64, 80, 96, 128)
# attention_sm90.cu: the online form at this head dim; its TMA box is 64
# bf16 columns (one 128-byte swizzle row) by 128 rows of one head of one
# batch row, in the order of the tensor map's dims (D, S, H, B)
FLASH_SM90_HEAD_DIM = 128
FLASH_SM90_BOX = (64, 128, 1, 1)
# attention_bwd_sm90.cu (K6a / K6b at the same head dim) walks 64-row
# tiles and loads every operand as boxes of 64 columns by 64 rows
FLASH_SM90_BWD_BOX = (64, 64, 1, 1)
# w4a8: the int32 sums hold 16 x the true sum (see csrc/w4a8.cu), which
# stays below 2^31 for in <= 2^17
W4A8_MAX_IN = 1 << 17
W4A8_GEMV_MAX_ROWS = 8
# aim the decode GEMV at ~8 blocks per SM of an H100 (132 SMs)
W4A8_GEMV_TARGET_BLOCKS = 132 * 8
# window_attention.cu: all of a window's keys sit in shared memory
WINDOW_MAX_KEYS = 256
WINDOW_MAX_HEAD_DIM = 128


class LaunchCounts:
    """Per-kernel launch counters of the K1..K8 wrappers."""

    NAMES = ("K1", "K2", "K3", "K4", "K5", "K6a", "K6b", "K7", "K8")

    def __init__(self):
        self.counts: Dict[str, int] = {n: 0 for n in self.NAMES}

    def add(self, name: str):
        self.counts[name] += 1

    def reset(self):
        for n in self.NAMES:
            self.counts[n] = 0

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counts)


LAUNCHES = LaunchCounts()


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
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


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


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float) -> torch.Tensor:
    """LayerNorm over the last dim of a contiguous bf16 tensor."""
    for t, what in ((x, "x"), (gamma, "gamma"), (beta, "beta")):
        _require(t, f"layernorm {what}")
    cols = x.shape[-1]
    if gamma.numel() != cols or beta.numel() != cols:
        raise ValueError("layernorm: gamma/beta must match the last dim")
    y = torch.empty_like(x)
    rows = x.numel() // cols if cols else 0
    _check_code("layernorm", LIBRARY.get().vls_layernorm_bf16(
        _ptr(x), _ptr(gamma), _ptr(beta), _ptr(y), rows, cols, float(eps),
        _stream()))
    return y


def gemm(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None, scale: float = 1.0,
         act: str = "none") -> torch.Tensor:
    """act((a @ b + bias) * scale) + residual, a [M, K], b [K, N], bf16."""
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
    _check_code("gemm", LIBRARY.get().vls_gemm_bf16(
        _ptr(a), _ptr(b), _ptr(bias), _ptr(residual), _ptr(c), m, n, k,
        float(scale), ACTS[act], _stream()))
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
    if d not in ATTENTION_HEAD_DIMS:
        raise ValueError(f"attention: head_dim {d} not in "
                         f"{ATTENTION_HEAD_DIMS}")
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


def _bshd(bsz, s, h, d, like):
    """A [B, H, S, D] view of a fresh contiguous [B, S, H, D] buffer."""
    return torch.empty((bsz, s, h, d), device=like.device,
                       dtype=like.dtype).permute(0, 2, 1, 3)


def attention_entry(d: int, two_pass: bool) -> str:
    """The C entry that serves `attention` at head dim d: the TMA +
    wgmma kernel of csrc/attention_sm90.cu for the online form at head
    dim 128, csrc/attention.cu for every other call."""
    if not two_pass and d == FLASH_SM90_HEAD_DIM:
        return "vls_flash_fwd_sm90"
    return "vls_attention_bf16"


def flash_sm90_tensor_map(t: torch.Tensor, what: str,
                          box=FLASH_SM90_BOX):
    """The TMA tensor-map geometry of a [B, H, S, D] bf16 view for
    csrc/attention_sm90.cu and attention_bwd_sm90.cu, which only encode
    it: dims (D, S, H, B) innermost first, the byte strides of S, H and
    B, and the box (the forward's FLASH_SM90_BOX, the backward's
    FLASH_SM90_BWD_BOX). TMA needs a contiguous last dim, byte strides in
    multiples of 16 and a 16-byte-aligned base."""
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{what}: expected [B, H, S, D] with a contiguous "
                         "last dim")
    b, h, s, d = t.shape
    es = t.element_size()
    strides = tuple(t.stride(i) * es for i in (2, 1, 0))
    if any(x <= 0 or x % 16 or x >= 1 << 40 for x in strides):
        raise ValueError(f"{what}: TMA needs byte strides that are positive "
                         f"multiples of 16 below 2^40, got {strides}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data must be 16-byte aligned")
    return (d, s, h, b) + strides + tuple(box)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = False, kv_len: int = -1,
              kv_bias: Optional[torch.Tensor] = None,
              two_pass: bool = False, with_lse: bool = False):
    """Flash attention over strided [B, H, S, D] bf16 views.

    Returns [B, Hq, Sq, D] as a view of a contiguous [B, Sq, Hq, D]
    buffer (so the caller's merge of heads into channels is free), and
    with `with_lse` also the per-row logsumexp, fp32 [B, Hq, Sq] (0 for a
    row with no visible key). kv_bias: fp32 [B, Skv] additive per-key
    bias, or None. The head dim and the form choose the kernel
    (`attention_entry`)."""
    bsz, hq, hkv, sq, skv, d = _check_qkv(q, k, v)
    qs, ks, vs = (_strides_bhs(q, "q"), _strides_bhs(k, "k"),
                  _strides_bhs(v, "v"))
    bias_sb = _bias_stride(kv_bias, bsz, skv)
    o = _bshd(bsz, sq, hq, d, q)
    os_ = (o.stride(0), o.stride(1), o.stride(2))
    lse = (torch.empty((bsz, hq, sq), device=q.device, dtype=torch.float32)
           if with_lse else None)
    if kv_len < 0:
        kv_len = skv
    if attention_entry(d, two_pass) == "vls_flash_fwd_sm90":
        geom = (ctypes.c_longlong * 33)(
            *(flash_sm90_tensor_map(q, "q") + flash_sm90_tensor_map(k, "k")
              + flash_sm90_tensor_map(v, "v")))
        _check_code("attention", LIBRARY.get().vls_flash_fwd_sm90(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(kv_bias), _ptr(lse),
            ctypes.cast(geom, ctypes.c_void_p), *os_, bias_sb, kv_len,
            int(causal), float(scale), _stream()))
        return (o, lse) if with_lse else o
    _check_code("attention", LIBRARY.get().vls_attention_bf16(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(kv_bias), _ptr(lse),
        *qs, *ks, *vs, *os_, bias_sb, bsz, hq, hkv, sq, skv, d, kv_len,
        float(scale), int(causal), int(two_pass), _stream()))
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


def attention_bwd_entry(d: int):
    """The C entries (dQ, dK/dV) that serve `attention_bwd_dq` /
    `attention_bwd_dkv` at head dim d: the TMA + wgmma kernels of
    csrc/attention_bwd_sm90.cu at head dim 128 (the LLM's),
    csrc/attention_bwd.cu at every other head dim."""
    if d == FLASH_SM90_HEAD_DIM:
        return "vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90"
    return "vls_attention_bwd_dq", "vls_attention_bwd_dkv"


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


def _bwd_common(q, k, v, dout, lse, kv_bias):
    bsz, hq, hkv, sq, skv, d = _check_qkv(q, k, v)
    qs, ks, vs = (_strides_bhs(q, "q"), _strides_bhs(k, "k"),
                  _strides_bhs(v, "v"))
    dout, ds_ = _bhs_operand(dout, "dout")
    if dout.shape != q.shape:
        raise ValueError("attention_bwd: dout must have q's shape")
    _require(lse, "lse", dtype=torch.float32)
    if tuple(lse.shape) != (bsz, hq, sq):
        raise ValueError("attention_bwd: lse must be [B, Hq, Sq]")
    bias_sb = _bias_stride(kv_bias, bsz, skv)
    return (bsz, hq, hkv, sq, skv, d), (qs, ks, vs), dout, ds_, bias_sb


def attention_bwd_dq(q, k, v, out, dout, lse, *, scale: float,
                     causal: bool, kv_bias: Optional[torch.Tensor] = None):
    """K6a: dQ of `attention` from its output and logsumexp, and the
    per-row delta = rowsum(dO * O) fp32 [B, Hq, Sq] that
    `attention_bwd_dkv` reads. q/k/v/out/dout: [B, H, S, D] bf16 views
    (out and dout are copied once if their strides do not fit); lse fp32
    [B, Hq, Sq] contiguous. Returns (dq as a [B, Hq, Sq, D] view of a
    contiguous [B, Sq, Hq, D] buffer, delta). The head dim chooses the
    kernel (`attention_bwd_entry`)."""
    return _attention_bwd_dq(attention_bwd_entry(q.shape[-1])[0], q, k, v,
                             out, dout, lse, scale=scale, causal=causal,
                             kv_bias=kv_bias)


def _attention_bwd_dq(entry, q, k, v, out, dout, lse, *, scale, causal,
                      kv_bias):
    """`attention_bwd_dq` through the C entry `entry`."""
    shape, qkv_s, dout, ds_, bias_sb = _bwd_common(q, k, v, dout, lse,
                                                   kv_bias)
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
            bias_sb, float(scale), int(causal), _stream())
    else:
        code = lib.vls_attention_bwd_dq(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(kv_bias),
            _ptr(lse), _ptr(delta), _ptr(dq), *qkv_s[0], *qkv_s[1],
            *qkv_s[2], *os_, *ds_, *_strides3(dq), bias_sb, bsz, hq, hkv,
            sq, skv, d, float(scale), int(causal), _stream())
    _check_code("attention_bwd_dq", code)
    return dq, delta


def attention_bwd_dkv(q, k, v, dout, lse, delta, *, scale: float,
                      causal: bool, kv_bias: Optional[torch.Tensor] = None):
    """K6b: dK and dV of `attention`, summed over each kv head's group of
    q heads in the kernel. delta: from `attention_bwd_dq`. Returns (dk,
    dv), each a [B, Hkv, Skv, D] view of a contiguous [B, Skv, Hkv, D]
    buffer. The head dim chooses the kernel (`attention_bwd_entry`)."""
    return _attention_bwd_dkv(attention_bwd_entry(q.shape[-1])[1], q, k, v,
                              dout, lse, delta, scale=scale, causal=causal,
                              kv_bias=kv_bias)


def _attention_bwd_dkv(entry, q, k, v, dout, lse, delta, *, scale, causal,
                       kv_bias):
    """`attention_bwd_dkv` through the C entry `entry`."""
    shape, qkv_s, dout, ds_, bias_sb = _bwd_common(q, k, v, dout, lse,
                                                   kv_bias)
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
            *_strides3(dv), bias_sb, float(scale), int(causal), _stream())
    else:
        code = lib.vls_attention_bwd_dkv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(kv_bias), _ptr(lse),
            _ptr(delta), _ptr(dk), _ptr(dv), *qkv_s[0], *qkv_s[1],
            *qkv_s[2], *ds_, *_strides3(dk), *_strides3(dv), bias_sb, bsz,
            hq, hkv, sq, skv, d, float(scale), int(causal), _stream())
    _check_code("attention_bwd_dkv", code)
    return dk, dv


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool of a contiguous NHWC bf16 map (H, W even)."""
    _require(x, "maxpool2x2 x")
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError("maxpool2x2: H and W must be even")
    y = torch.empty((n, h // 2, w // 2, c), device=x.device, dtype=x.dtype)
    _check_code("maxpool2x2", LIBRARY.get().vls_maxpool2x2_bf16(
        _ptr(x), _ptr(y), n, h, w, c, _stream()))
    return y


def w4a8_splits(half: int, out: int) -> int:
    """Blocks along K for the decode GEMV: enough blocks to fill the card
    when out has few 128-column tiles, each still taking >= 64 groups of
    4 packed rows (8 per warp)."""
    col_blocks = -(-out // 128)
    want = -(-W4A8_GEMV_TARGET_BLOCKS // col_blocks)
    return max(1, min(want, (half // 4) // 64))


def w4a8_matmul(xq: torch.Tensor, a_scale: torch.Tensor,
                packed: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """(int32(xq @ unpack(packed)) * a_scale) * w_scale -> out_dtype.

    xq int8 [rows, in]; a_scale fp32 [rows, 1]; packed int8 [in/2, out]
    (the "halves" int4 layout); w_scale fp32 [out]; out_dtype bf16 or
    fp32."""
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
    return y


def _rows2d(x: torch.Tensor, what: str):
    _require(x, what)
    if x.dim() != 2 or x.shape[1] % 8:
        raise ValueError(f"{what}: expected [rows, cols] with cols % 8 == 0, "
                         f"got {tuple(x.shape)}")
    return x.shape


def _quant_rows(x, gamma, beta, eps: float, ln: bool):
    rows, cols = _rows2d(x, "quant_rows x")
    q = torch.empty((rows, cols), device=x.device, dtype=torch.int8)
    scale = torch.empty((rows, 1), device=x.device, dtype=torch.float32)
    _check_code("quant_rows", LIBRARY.get().vls_quant_rows(
        _ptr(x), _ptr(gamma), _ptr(beta), _ptr(q), _ptr(scale), rows, cols,
        float(eps), int(ln), _stream()))
    return q, scale


def quant_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization of a contiguous bf16 [rows,
    cols] tensor, bit-equal to `quantize_activations_rowwise`. Returns
    (int8 [rows, cols], fp32 scale [rows, 1])."""
    return _quant_rows(x, None, None, 0.0, False)


def ln_quant_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float):
    """LayerNorm in fp32 (gamma, beta fp32 [cols]), rounded to bf16, then
    per-row int8 quantization. Returns (int8 [rows, cols], fp32 [rows,
    1])."""
    cols = x.shape[-1]
    for t, what in ((gamma, "gamma"), (beta, "beta")):
        _require(t, f"ln_quant_rows {what}", dtype=torch.float32)
        if t.numel() != cols:
            raise ValueError(f"ln_quant_rows: {what} must have {cols} "
                             "elements")
    return _quant_rows(x, gamma, beta, eps, True)


def gemm_s8(a: torch.Tensor, b: torch.Tensor,
            a_scale: Optional[torch.Tensor] = None,
            w_scale: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None,
            scale: Optional[float] = None, act: str = "none"):
    """int8 a [M, K] @ int8 b [K, N] on the tensor cores.

    Without scales: the exact int32 product [M, N]. With a_scale (fp32,
    M elements) and w_scale (fp32 [N]): the W8A8 dense epilogue in bf16,
    bf16((acc * a_scale) * w_scale) [+ bias] [* bf16(scale) | act]
    [+ residual], every step rounded to bf16; bias bf16 [N], residual
    bf16 [M, N]."""
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
    _check_code("gemm_s8", LIBRARY.get().vls_gemm_s8(
        _ptr(a), _ptr(a_scale), _ptr(b), _ptr(w_scale), _ptr(bias),
        _ptr(residual), _ptr(y), m, n, k, int(dense), ACTS[act],
        float(scale or 0.0), _stream()))
    return y


def window_attention(qkv: torch.Tensor, *, num_heads: int, ws: int,
                     scale: float, ps: int = 1) -> torch.Tensor:
    """Windowed SDPA over a contiguous fused-qkv NHWC map [B, H, W, 3C]
    (H, W multiples of ws); ps = 2 max-pools q 2x2 per window. Returns
    [B, H/ps, W/ps, C] bf16."""
    _require(qkv, "window_attention qkv")
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError("window_attention: expected qkv [B, H, W, 3C]")
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    if c % num_heads or (c // num_heads) % 8 \
            or c // num_heads > WINDOW_MAX_HEAD_DIM:
        raise ValueError(f"window_attention: head dim {c / num_heads} must "
                         f"be a multiple of 8 and <= {WINDOW_MAX_HEAD_DIM}")
    if ws <= 0 or h % ws or w % ws or ws * ws > WINDOW_MAX_KEYS:
        raise ValueError(f"window_attention: ws {ws} must divide the "
                         f"{h}x{w} map and hold <= {WINDOW_MAX_KEYS} keys")
    if ps not in (1, 2) or ws % ps:
        raise ValueError(f"window_attention: pool stride {ps} must be 1 or "
                         "2 and divide ws")
    if (h // ws) * (w // ws) * num_heads > 65535 or b > 65535:
        raise ValueError("window_attention: too many windows for one launch")
    o = torch.empty((b, h // ps, w // ps, c), device=qkv.device,
                    dtype=qkv.dtype)
    _check_code("window_attention", LIBRARY.get().vls_window_attention(
        _ptr(qkv), _ptr(o), b, h, w, c, num_heads, ws, ps, float(scale),
        _stream()))
    return o
