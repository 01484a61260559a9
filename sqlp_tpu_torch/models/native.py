"""ctypes loader for the native (C++) SMPS parsers.

Port of record: ``sqlp_tpu/models/native.py`` (``get_lib`` :34-92,
``read_cor_native`` :95-146, ``read_sto_native`` :149-196), over the
port's own copies of the parsers, ``sqlp_tpu_torch/csrc/native/``. The
library is built at first use with ``g++ -O2 -shared -fPIC`` into
``build/native/<hash of the sources and flags>/`` at the repository root
(git-ignored): each process compiles under a name of its own and
``os.replace``s the finished library into place, so a process never loads
a half-written file, and an edited source (or one newer than the library)
builds anew. A failed build raises with the compiler's message.
``SQLP_TPU_TORCH_NATIVE=0`` selects the Python parsers instead; it is read
at every parse.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "csrc", "native")
_SOURCES = ("smps_cor.cpp", "smps_sto.cpp")
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _S, _I, _L = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_long
_PD = ctypes.POINTER(ctypes.c_double)
# the C ABI of csrc/native/: name -> (restype, argtypes); handles are void*
_SIGNATURES = {
    "smps_cor_parse": (_P, [_S, _S, _I]),
    "cor_n_rows": (_I, [_P]),
    "cor_n_cols": (_I, [_P]),
    "cor_nnz": (_L, [_P]),
    "cor_names_size": (_L, [_P, _I]),
    "cor_names": (None, [_P, _I, _S]),
    "cor_directions": (None, [_P, _S]),
    "cor_fill_dense": (None, [_P, _PD, _PD, _PD, _PD]),
    "cor_free": (None, [_P]),
    "smps_sto_parse": (_P, [_S, _S, _I]),
    "sto_n_positions": (_I, [_P]),
    "sto_name_size": (_L, [_P]),
    "sto_problem_name": (None, [_P, _S]),
    "sto_positions_size": (_L, [_P]),
    "sto_positions": (None, [_P, _S]),
    "sto_kinds": (None, [_P, ctypes.POINTER(_I)]),
    "sto_offsets": (None, [_P, ctypes.POINTER(_L)]),
    "sto_total_outcomes": (_L, [_P]),
    "sto_params": (None, [_P, _PD, _PD]),
    "sto_free": (None, [_P]),
}


def enabled() -> bool:
    """False when ``SQLP_TPU_TORCH_NATIVE=0`` selects the Python parsers."""
    return os.environ.get("SQLP_TPU_TORCH_NATIVE", "1") != "0"


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_SRC_DIR, name), "rb") as fh:
            h.update(name.encode())
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _digest(), "libsqlp_torch_native.so")


def build() -> str:
    """Compile the parsers unless a library for these sources exists and
    is newer than each of them; returns its path. Raises RuntimeError with
    the compiler's output when g++ fails."""
    out = library_path()
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    if os.path.isfile(out) and all(
            os.path.getmtime(s) <= os.path.getmtime(out) for s in srcs):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *_FLAGS, "-o", tmp, *srcs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"native SMPS parser build did not run: "
                           f"{' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"native SMPS parser build failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)       # atomic: concurrent builds agree on one file
    return out


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use and loaded once per
    process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def read_cor_native(path: str):
    """Parse a cor file with the native parser: the CorData the Python
    parser gives. Raises AssertionError on a malformed file."""
    from sqlp_tpu_torch.models.smps_cor import CorData, lookup_table

    lib = get_lib()
    err = ctypes.create_string_buffer(512)
    h = lib.smps_cor_parse(path.encode(), err, len(err))
    if not h:
        raise AssertionError(err.value.decode()
                             or f"native parse failed: {path}")
    try:
        nr = lib.cor_n_rows(h)
        nc = lib.cor_n_cols(h)

        def names(which):
            buf = ctypes.create_string_buffer(int(lib.cor_names_size(h,
                                                                     which)))
            lib.cor_names(h, which, buf)
            return buf.value.decode()

        problem_name = names(0)
        row_names = names(1).split("\n")[:nr]
        col_names = names(2).split("\n")[:nc]
        dbuf = ctypes.create_string_buffer(nr)
        lib.cor_directions(h, dbuf)
        directions = [chr(b) for b in dbuf.raw[:nr]]
        M = np.empty((nr, nc), np.float64)
        rhs = np.empty(nr, np.float64)
        lb = np.empty(nc, np.float64)
        ub = np.empty(nc, np.float64)
        lib.cor_fill_dense(h, M.ctypes.data_as(_PD), rhs.ctypes.data_as(_PD),
                           lb.ctypes.data_as(_PD), ub.ctypes.data_as(_PD))
    finally:
        lib.cor_free(h)
    return CorData(problem_name=problem_name, directions=directions,
                   row_names=row_names, col_names=col_names,
                   template_matrix=M, rhs=rhs, lower_bound=lb,
                   upper_bound=ub, col_mapping=lookup_table(col_names),
                   row_mapping=lookup_table(row_names))


def read_sto_native(path: str):
    """Parse a sto file with the native parser: the StoData the Python
    parser gives, positions in the same order. Raises AssertionError on a
    malformed file."""
    from sqlp_tpu_torch.models.smps_sto import (DiscreteDistribution,
                                                NormalDistribution, StoData,
                                                UniformDistribution)
    from sqlp_tpu_torch.models.smps_tim import Position

    lib = get_lib()
    err = ctypes.create_string_buffer(512)
    h = lib.smps_sto_parse(path.encode(), err, len(err))
    if not h:
        raise AssertionError(err.value.decode()
                             or f"native parse failed: {path}")
    try:
        n_pos = lib.sto_n_positions(h)
        nbuf = ctypes.create_string_buffer(int(lib.sto_name_size(h)))
        lib.sto_problem_name(h, nbuf)
        pbuf = ctypes.create_string_buffer(int(lib.sto_positions_size(h)))
        lib.sto_positions(h, pbuf)
        pos_lines = pbuf.value.decode().split("\n")[:n_pos]
        kinds = np.empty(n_pos, np.int32)
        offsets = np.empty(n_pos + 1, np.int64)
        lib.sto_kinds(h, kinds.ctypes.data_as(ctypes.POINTER(_I)))
        lib.sto_offsets(h, offsets.ctypes.data_as(ctypes.POINTER(_L)))
        total = int(lib.sto_total_outcomes(h))
        a = np.empty(total, np.float64)
        b = np.empty(total, np.float64)
        lib.sto_params(h, a.ctypes.data_as(_PD), b.ctypes.data_as(_PD))
    finally:
        lib.sto_free(h)
    indep = {}
    for i, line in enumerate(pos_lines):
        col, row = line.split("\t")
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        if kinds[i] == 0:
            indep[Position(col, row)] = DiscreteDistribution(
                list(a[lo:hi]), list(b[lo:hi]))
        elif kinds[i] == 1:
            indep[Position(col, row)] = NormalDistribution(a[lo], b[lo])
        else:
            indep[Position(col, row)] = UniformDistribution(a[lo], b[lo])
    return StoData(problem_name=nbuf.value.decode(), indep=indep)
