"""Build and load the hand-written CUDA kernels in `csrc/`.

Each source compiles with `nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared` into a shared library with a plain C interface under `build/` at
the repository root, at first use, and is loaded with `ctypes`. The
library's file name carries a hash of its source and of the shared headers
in `csrc/`, so an edited source or header is rebuilt and a stale build is
never loaded. `build_all` starts one `nvcc`
per source at once. Nothing is compiled when a module is imported: the
wrappers call `library()` only when they launch a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
SOURCES = ("flash_prefill", "int4_matmul", "int4_mlp", "paged_attention",
           "slot_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

# the element-type code every attention entry takes (`dtype`): bf16 and
# fp16 on the mma bodies, fp32 on the 3xTF32 bodies
DTYPE_CODES = {"torch.bfloat16": 0, "torch.float16": 1, "torch.float32": 2}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_i64 = ctypes.c_longlong
# argument types of each library's C entry points
_SIGNATURES = {
    # q, k, v, lengths, ALiBi slopes (or null), out; then N, T, KH, G, the
    # query heads of a row tile, D, window, dtype
    "flash_prefill": {
        "tgi_flash_prefill": [_vp] * 6 + [_i32] * 8 + [_f32, _vp],
    },
    # q, pools (int8: and their scale pools), table, ctx, ALiBi slopes (or
    # null), outputs, split scratch, arrival counters; then S, KH, G, D, R,
    # page, max_pages, num_pages, pages per split, splits, the tile plan
    # (keys a tile, stages), dtype
    "paged_attention": {
        "tgi_paged_decode": [_vp] * 9 + [_i32] * 13 + [_f32, _vp],
        "tgi_paged_decode_stats": [_vp] * 11 + [_i32] * 13 + [_f32, _vp],
        "tgi_paged_decode_stats_i8": [_vp] * 13 + [_i32] * 13 + [_f32, _vp],
    },
    # x, qweight, qzeros, scales, y, split workspace, arrival counters; then
    # M, N, K, group size, splits, dtype
    "int4_matmul": {
        "tgi_int4_matmul": [_vp] * 7 + [_i32] * 6 + [_vp],
    },
    # x, the six weight tensors (words, zero points, scales of w_gu, then of
    # w_down), workspace, counters, y; then M, H, I, the two group sizes,
    # the two split counts, activation, dtype
    "int4_mlp": {
        "tgi_int4_mlp": [_vp] * 10 + [_i32] * 9 + [_vp],
    },
    # cache strides over S, K, T are int64; S1: q, k, v, ctx, the first
    # live rows, the ALiBi slopes, out, split scratch, arrival counters,
    # then rows per split, splits, the tile plan and dtype; S2 (no slopes):
    # q, k, v, ctx, the ring's four sources, out, split scratch, arrival
    # counters, then rows per split, the cache's and the ring's splits, the
    # ring's columns and step, the tile plan and dtype
    "slot_attention": {
        "tgi_slot_decode": [_vp] * 9 + [_i32] * 5 + [_i64] * 3 + [_i32] * 5
                           + [_f32, _vp],
        "tgi_ring_decode": [_vp] * 11 + [_i32] * 5 + [_i64] * 3 + [_i32] * 8
                           + [_f32, _vp],
    },
}
_ERROR_STRING = {"flash_prefill": "tgi_flash_prefill_error_string",
                 "int4_matmul": "tgi_int4_matmul_error_string",
                 "int4_mlp": "tgi_int4_mlp_error_string",
                 "paged_attention": "tgi_paged_decode_error_string",
                 "slot_attention": "tgi_slot_attention_error_string"}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, the toolkit's default
    location, or `nvcc` on PATH."""
    for cand in (os.path.join(os.getenv("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, every shared header
    in csrc/ (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, target) or None when the
    library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, target, tmp


def _finish(name: str, started) -> None:
    proc, target, tmp = started
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, target)


def build_all() -> dict[str, str]:
    """Compile every source in parallel (one nvcc each); returns
    {name: compiler log} (ptxas register and shared-memory report)."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        for name, st in started.items():
            if st is not None:
                _finish(name, st)
    logs = {}
    for name in SOURCES:
        log = BUILD_DIR / f"{name}.log"
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            st = _start(name)
            if st is not None:
                _finish(name, st)
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, _ERROR_STRING[name])
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def dtype_code(dtype) -> int:
    """The `dtype` argument of an entry for a torch element type."""
    return DTYPE_CODES[str(dtype)]


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = getattr(library(name), _ERROR_STRING[name])(code)
        raise RuntimeError(
            f"CUDA kernel launch in csrc/{name}.cu failed: error {code} "
            f"({msg.decode() if msg else 'unknown'})")
