"""Profiling hooks: a ``torch.profiler`` trace and phase timers.

Port of record: ``sqlp_tpu/utils/profiling.py``. :func:`trace` records
the host's operators and, on a CUDA host, the card's kernels around a
block and writes a Chrome trace into a directory (open it in Perfetto,
``chrome://tracing`` or TensorBoard's profiler plugin).
:class:`PhaseTimers` accumulates host-clock time by phase, synchronizing
the card first where the phase ran on it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace around a block, exported as
    ``<host>_<pid>.<ms>.pt.trace.json`` into ``log_dir``; a no-op for
    ``None``. Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _synchronize(block_on) -> None:
    """Wait for the CUDA devices of ``block_on`` (a tensor, a device, or a
    sequence of them) to finish their queued work."""
    items = block_on if isinstance(block_on, (list, tuple)) else [block_on]
    for item in items:
        dev = item.device if torch.is_tensor(item) else torch.device(item)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class PhaseTimers:
    """Accumulating wall-clock timers for host-visible phases."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block; with ``block_on`` the card's queued work is
        waited for before the clock is read."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(self.totals[k], 4),
                    "count": self.counts[k],
                    "mean_ms": round(1e3 * self.totals[k]
                                     / max(self.counts[k], 1), 3)}
                for k in self.totals}
