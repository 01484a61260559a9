"""Build and load the port's hand-written CUDA kernels.

The sources under ``sqlp_tpu_torch/csrc/`` expose a plain C interface; they
are compiled by ``nvcc`` for ``sm_90a`` at first use, one ``nvcc`` per
source, all started together, and linked into one shared library that is
loaded with ``ctypes``. The library lands in ``build/kernels/<hash>``
at the repository root (git-ignored), keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: a CPU-only host imports every module
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
_CSRC = os.path.join(_PKG, "csrc")
_SOURCES = ("pdhg_halpern_round.cu", "pdhg_halpern_cluster.cu",
            "pdhg_halpern_tile.cu", "pdhg_halpern_stream.cu",
            "pdhg_halpern_grid.cu", "pdhg_average_round.cu",
            "pdhg_average_cluster.cu", "pdhg_average_tile.cu",
            "pdhg_average_stream.cu", "pdhg_average_grid.cu",
            "pdhg_halpern_small.cu", "pdhg_average_small.cu",
            "admm_round.cu")
_HEADERS = ("pdhg_common.cuh", "pdhg_cluster.cuh", "pdhg_tile.cuh",
            "pdhg_stream.cuh", "pdhg_grid.cuh", "pdhg_small.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")

_lock = threading.Lock()
_lib = None
build_seconds = 0.0     # wall time of the nvcc run in this process (0: cached)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# a round's operands after the plan's leading integers: K, q, q_per_row,
# then 15 (Halpern) or 12 (average) pointers, B, m, n, n_inner, the stream
_HALPERN = [_P, _P, _I] + [_P] * 15 + [_I] * 4 + [_P]
_AVERAGE = [_P, _P, _I] + [_P] * 12 + [_I] * 4 + [_P]
_SIGNATURES = {
    "pdhg_halpern_round": [_I] + _HALPERN,
    "pdhg_halpern_cluster": [_I] * 2 + _HALPERN,
    "pdhg_halpern_tile": [_I] * 3 + _HALPERN,
    "pdhg_average_round": [_I] + _AVERAGE,
    "pdhg_average_cluster": [_I] * 2 + _AVERAGE,
    "pdhg_average_tile": [_I] * 3 + _AVERAGE,
    "pdhg_halpern_stream": [_I] * 3 + _HALPERN,
    "pdhg_average_stream": [_I] * 3 + _AVERAGE,
    "pdhg_halpern_small": [_I] * 3 + _HALPERN,
    "pdhg_average_small": [_I] * 3 + _AVERAGE,
    "admm_round": [_I] + [_P] * 13 + [_I] * 4 + [_D, _D, _P],
}
# float32 only: BM, P, ldk, mK, then Kr and the scratch Ls, Ybr
_SIGNATURES_F32 = {
    "pdhg_halpern_grid": [_I] * 4 + [_P] * 3 + _HALPERN,
    "pdhg_average_grid": [_I] * 4 + [_P] * 3 + _AVERAGE,
}
# cudaOccupancyMaxActiveClusters queries: integers, then the int* result
_OCCUPANCY = {"pdhg_halpern_cluster": 6, "pdhg_average_cluster": 6,
              "pdhg_halpern_tile": 4, "pdhg_average_tile": 4,
              "pdhg_halpern_stream": 5, "pdhg_average_stream": 5}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of sqlp_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(name.encode())
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _digest(), "libsqlp_torch_kernels.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists;
    returns its path. Raises on any compiler failure."""
    global build_seconds
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _SOURCES:
        obj = os.path.join(os.path.dirname(out), f"{src}.{tag}.o")
        cmd = [nvcc, *_FLAGS, "-c", "-o", obj, os.path.join(_CSRC, src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = f"{out}.{tag}"
    cmd = [nvcc, *_FLAGS, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)       # atomic: concurrent builds agree on one file
    for obj in objs:
        os.remove(obj)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for stem, args in _SIGNATURES.items():
                for suffix in ("f32", "f64"):
                    fn = getattr(lib, f"{stem}_{suffix}")
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
            for stem, args in _SIGNATURES_F32.items():
                fn = getattr(lib, f"{stem}_f32")
                fn.argtypes = args
                fn.restype = ctypes.c_int
            for stem, n_ints in _OCCUPANCY.items():
                fn = getattr(lib, f"{stem}_occupancy")
                fn.argtypes = [_I] * n_ints + [_P]
                fn.restype = ctypes.c_int
            lib.pdhg_stream_smem.argtypes = [_I] * 4
            lib.pdhg_stream_smem.restype = ctypes.c_longlong
            lib.pdhg_grid_smem.argtypes = [_I]
            lib.pdhg_grid_smem.restype = ctypes.c_longlong
            lib.pdhg_small_smem.argtypes = [_I] * 6
            lib.pdhg_small_smem.restype = ctypes.c_longlong
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {code}")
