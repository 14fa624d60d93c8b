"""Build and bind the package's CUDA kernels (``myscaledb_tpu_torch/csrc``).

Each ``.cu`` file has a plain C interface.  ``nvcc`` compiles them for
``sm_90a`` (Hopper) into objects, one process per source, all started
together, and links them into one shared library that ``ctypes`` loads.
The library goes to ``myscaledb_tpu_torch/_build/`` under a name that
hashes the sources and flags, so a changed source rebuilds and an
unchanged one is reused.  Nothing is built at import: the first kernel
launch (or ``build()``) does it.

The native host library (``csrc/host/msdb_host.cpp``: dictionary
encoding and corpus tokenization) is plain C++
and needs no ``nvcc``: ``host_library()`` compiles it at first use with
the host compiler (``$CXX``, else ``c++``) into the same directory, named
by a hash of the source and flags.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("binary_scan.cu", "distinct_count.cu", "errors.cu", "group_agg.cu",
           "join_probe.cu", "merge_count.cu", "segmin_f32.cu",
           "segmin_sq8.cu")
HEADERS = ("hopper.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# entry point -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    # x3, qw, mask2, out, nseg, words, nq, n, has_mask, jaccard, qchunk,
    # stream
    "msdb_binary_segmin": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _P],
    # gid, key, key_bytes, mask, n, G, table, capacity, counts, overflow,
    # stream
    "msdb_distinct_count": [_P, _P, _I, _P, _L, _I, _P, _L, _P, _P, _P],
    # key, key_bytes, lookup, lo, m, mask, n, row_out, found_out, stream
    "msdb_join_probe_direct": [_P, _I, _P, _L, _L, _P, _L, _P, _P, _P],
    # build, nb, starts, lo, hi, shift, steps, probe, n, has_max, out,
    # blocks, stream
    "msdb_merge_count": [_P, _I, _P, _I, _I, _I, _I, _P, _L, _P, _P, _I, _P],
    # gid, mask, arg_ptrs, na, float_bits, wide_bits, lane_arg, lane_kind,
    # init, nl, n, G, nblocks, rows_per_block, part_i, part_f, out_i, out_f,
    # stream
    "msdb_group_agg": [_P, _P, _P, _I, ctypes.c_uint, ctypes.c_uint, _P, _P,
                       _P, _I, _L, _I, _I, _L, _P, _P, _P, _P, _P],
    # x, q, sqn, qaux, mask, qsplit, out, n, d, nq, metric, stream
    "msdb_segmin_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x8, sides, q, scratch, mv, out, n_pad, d, nq, metric, stream
    "msdb_segmin_sq8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # nq, d -> 1 if msdb_segmin_sq8 takes its wgmma branch, 0 for __dp4a
    "msdb_segmin_sq8_branch": [_I, _I],
}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""

HOST_SOURCE = CSRC / "host" / "msdb_host.cpp"
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]
_host_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of myscaledb_tpu_torch/csrc cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES + HEADERS:
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"libmsdb_kernels-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile and link the kernels if the library is missing.  Returns the
    seconds spent (0.0 when it was already built)."""
    global BUILD_LOG
    out = library_path()
    if out.exists():
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for s in SOURCES:
            obj = os.path.join(tmp, s + ".o")
            cmd = [exe, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", obj]
            procs.append((s, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for s, _obj, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {s}\n{text}")
            if p.returncode != 0:
                failed.append(s)
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        so_tmp = os.path.join(tmp, out.name)
        link = subprocess.run(
            [exe, "-shared", "-o", so_tmp] + [o for _s, o, _p in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so_tmp, out)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.msdb_cuda_error_string.argtypes = [ctypes.c_int]
            lib.msdb_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().msdb_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")


def host_library_path() -> Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    return BUILD_DIR / f"libmsdb_host-{h.hexdigest()[:16]}.so"


def host_library() -> Path:
    """Path of the native host library, compiled on first use.  Raises
    when the compiler is missing or fails: no caller falls back to Python
    loops."""
    with _host_lock:
        out = host_library_path()
        if out.exists():
            return out
        cxx = os.environ.get("CXX") or shutil.which("c++") or \
            shutil.which("g++")
        if not cxx:
            raise RuntimeError("no C++ compiler (set CXX): the native host "
                               f"library {HOST_SOURCE} cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a private name, then an atomic rename: processes that build at
        # once never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp,
                                  str(HOST_SOURCE)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {HOST_SOURCE}:\n"
                                   f"{res.stdout}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out
