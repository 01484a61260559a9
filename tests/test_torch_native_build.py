"""Build the native SMPS parser library once, before any test loads it.

``csrc/libsqlp_native.so`` is git-ignored, so a fresh checkout has none.
``sqlp_tpu/models/native.py:get_lib`` builds it on first use, but checks
``os.path.exists`` while another test process may still be linking the
file: ``ctypes.CDLL`` then fails on a half-written library ("file too
short") and every native test of that process is lost. pytest-xdist
workers each import every test module while collecting, before any of
them runs a test, so the module-level code below runs first in every
worker: it takes an exclusive ``flock`` on a lock file in the ignored
``build/`` directory, runs ``make -C csrc`` if the library is missing or
older than its sources, and releases the lock. Whoever comes second waits
for the lock and finds the finished library.
"""

import ctypes
import fcntl
import os
import subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_ROOT, "csrc")
_LIB = os.path.join(_CSRC, "libsqlp_native.so")
_LOCK = os.path.join(_ROOT, "build", "native_build.lock")


def _stale() -> bool:
    """The staleness rule of sqlp_tpu/models/native.py:get_lib."""
    if not os.path.exists(_LIB):
        return True
    built = os.path.getmtime(_LIB)
    return any(os.path.getmtime(os.path.join(_CSRC, f)) > built
               for f in os.listdir(_CSRC)
               if f.endswith(".cpp") or f == "Makefile")


def _build_once() -> str:
    """Build under the lock if needed; returns the failure text or ''."""
    os.makedirs(os.path.dirname(_LOCK), exist_ok=True)
    with open(_LOCK, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if not _stale():
                return ""
            # -B: a Makefile newer than the library is stale by get_lib's
            # rule but not by make's own
            proc = subprocess.run(["make", "-C", _CSRC, "-s", "-B"],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                return f"make failed ({proc.returncode}): {proc.stderr}"
            return "" if os.path.exists(_LIB) else "make built no library"
        except (OSError, subprocess.TimeoutExpired) as exc:
            return f"make did not run: {exc}"
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


_BUILD_ERROR = _build_once()


def test_native_library_is_built_and_loads():
    """The library exists, is not stale, loads, and exports both parsers;
    the loader of the JAX package then takes it as it is."""
    assert _BUILD_ERROR == "", _BUILD_ERROR
    assert not _stale()
    lib = ctypes.CDLL(_LIB)
    assert hasattr(lib, "smps_cor_parse") and hasattr(lib, "smps_sto_parse")
    from sqlp_tpu.models.native import get_lib
    assert get_lib() is not None
