"""Build and load the port's hand-written CUDA kernels.

The sources under ``sqlp_tpu_torch/csrc/`` expose a plain C interface; they
are compiled by ``nvcc`` for ``sm_90a`` into one shared library at first
use and loaded with ``ctypes``. The library lands in ``build/kernels/<hash>``
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
_SOURCES = ("pdhg_halpern_round.cu", "admm_round.cu")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")

_lock = threading.Lock()
_lib = None
build_seconds = 0.0     # wall time of the nvcc run in this process (0: cached)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "pdhg_halpern_round": [_I] + [_P, _P, _I] + [_P] * 15 + [_I] * 4 + [_P],
    "admm_round": [_P] * 13 + [_I] * 4 + [_D, _D, _P],
}


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
    for name in _SOURCES:
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
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_FLAGS, "-o", tmp,
           *[os.path.join(_CSRC, s) for s in _SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)       # atomic: concurrent builds agree on one file
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
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {code}")
