"""Profiling: a ``torch.profiler`` trace and the program's spans.

Port of record: ``sqlp_tpu/utils/profiling.py``. :func:`trace` records
the host's operators and, on a CUDA host, the card's kernels around a
block and writes a Chrome trace into a directory (open it in Perfetto,
``chrome://tracing`` or TensorBoard's profiler plugin), with the
program's spans beside it.

A span marks where a layer's work starts and ends on the host: a Monte
Carlo panel through the escalation ladder, a ladder step, a PDHG solve,
a restart round. Spans are recorded only while a ``torch.profiler``
session is active (the CLI's ``--profile``, a benchmark's traced run),
in memory, and stamped with ``time.time_ns()``, the Unix clock that the
profiler's events are stamped on, so that a span lines up with the
kernels and runtime calls of the same trace. Outside a session
:func:`span` reads one flag, notes that it was off and hands back a
shared no-op: it records nothing. On or off, a span reads nothing from
the card and never synchronizes it. The store holds one session's
spans: the first span of a session (the first asked for after one was
asked for outside a session, or the first inside :func:`trace`) empties
it. The recording path is single-threaded: one stack of open spans gives
each span its parent.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class Span:
    """One recorded span: ``name``, ``start`` and ``end`` in Unix ns,
    ``parent`` (the index in :func:`spans` of the span open around it,
    -1 for none) and integer ``attrs``, among them stamps in Unix ns set
    by :meth:`mark`. Used as a context manager: entering records it and
    stamps ``start``, leaving stamps ``end``."""

    __slots__ = ("name", "start", "end", "parent", "attrs")

    def __init__(self, name: str, attrs: Dict[str, int]):
        self.name = name
        self.start = self.end = 0
        self.parent = -1
        self.attrs = attrs

    def __enter__(self) -> "Span":
        self.parent = _STACK[-1] if _STACK else -1
        _STACK.append(len(_SPANS))
        _SPANS.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.time_ns()
        if _STACK:
            _STACK.pop()

    def mark(self, key: str) -> None:
        """Stamp ``attrs[key]`` with the time now."""
        self.attrs[key] = time.time_ns()

    def set(self, **attrs: int) -> None:
        self.attrs.update(attrs)

    def to_dict(self) -> dict:
        return {"name": self.name, "start": self.start, "end": self.end,
                "parent": self.parent, "attrs": self.attrs}


class _Off:
    """What :func:`span` hands back with no profiler active: every method
    does nothing, and it reads false."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def mark(self, key: str) -> None:
        pass

    def set(self, **attrs: int) -> None:
        pass


_OFF = _Off()
_SPANS: List[Span] = []
_STACK: List[int] = []
_WAS_OFF = True    # a span was asked for outside a session since the last
                   # one recorded: the next recorded opens a new store


def span(name: str, **attrs: int):
    """A span named ``name`` with integer ``attrs``, to use as a context
    manager; the shared no-op unless a ``torch.profiler`` session is
    active."""
    global _WAS_OFF
    if not _autograd_profiler._is_profiler_enabled:
        _WAS_OFF = True
        return _OFF
    if _WAS_OFF:
        _clear()
    return Span(name, attrs)


def _clear() -> None:
    global _WAS_OFF
    _SPANS.clear()
    _STACK.clear()
    _WAS_OFF = False


def spans() -> List[Span]:
    """The spans of the latest profiler session, in the order they were
    entered."""
    return _SPANS


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace around a block, exported as
    ``<host>_<pid>.<ns>.pt.trace.json`` into ``log_dir``, and the spans
    recorded in the block as ``<host>_<pid>.<ns>.spans.json`` beside it
    (the same name; ``{"clock": "unix_ns", "spans": [{name, start, end,
    parent, attrs}]}``, on the Chrome trace's clock); a no-op for
    ``None``. Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    stem = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}")

    def export(prof) -> None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(stem + ".pt.trace.json")
        with open(stem + ".spans.json", "w") as f:
            json.dump({"clock": "unix_ns",
                       "spans": [s.to_dict() for s in _SPANS]}, f)

    _clear()
    with profile(activities=activities, on_trace_ready=export) as prof:
        yield prof
