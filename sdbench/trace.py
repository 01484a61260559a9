"""The traced window: ``torch.profiler`` around it, reduced to kernel
intervals, the device's busy time and a breakdown.

Kernel intervals come from the profiler's device events (CUPTI); busy
time is the length of their union, so kernels that overlap on several
streams count once. An idle gap is a stretch of the window in which no
kernel ran; it is named by the host event that overlaps it most, the
longest of those that overlap it all. Only CUDA activity is traced:
the host events are the CUDA runtime calls (a launch, a copy, a wait),
and the host's operators go untraced, since recording them costs the
host-paced cells more of their window than the device time they show.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from collections import defaultdict
from typing import List, Tuple


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]    # (name, start us, end us)
    host_ops: List[Tuple[str, float, float]]
    window_s: float = 0.0

    def union_s(self, match=None) -> float:
        """Seconds in which a kernel (whose name ``match`` accepts, all
        by default) ran."""
        iv = sorted((s, e) for n, s, e in self.kernels
                    if match is None or match(n))
        total, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def busy_s(self) -> float:
        return self.union_s()

    def breakdown(self, top: int = 10) -> dict:
        by_kernel = defaultdict(float)
        for n, s, e in self.kernels:
            by_kernel[n] += (e - s) / 1e6
        ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
        gaps = self._gaps()
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        # events that span most of the window (the profiler's own, a long
        # wait) name nothing and would make every lookup walk them all
        host = sorted((o for o in self.host_ops if o[2] - o[1] <= 2e5),
                      key=lambda o: o[1])
        starts = [o[1] for o in host]
        named = defaultdict(float)
        longest = max((o[2] - o[1] for o in host), default=0.0)
        for gs, ge in gaps[:2000]:
            lo = bisect.bisect_left(starts, gs - longest)
            best, best_ov = "host", 0.0
            best_len = 0.0
            for name, s, e in host[lo:bisect.bisect_right(starts, ge)]:
                ov = min(e, ge) - max(s, gs)
                if ov > best_ov or (ov == best_ov and e - s > best_len):
                    best, best_ov, best_len = name, ov, e - s
            named[best] += (ge - gs) / 1e6
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[n[:120], v] for n, v in idle]}

    def _gaps(self) -> List[Tuple[float, float]]:
        iv = sorted((s, e) for _, s, e in self.kernels)
        out, cur_e = [], None
        for s, e in iv:
            if cur_e is not None and s > cur_e:
                out.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        return out


ACTIVITIES = ("CUDA",)


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block when ``enabled``; yields a holder whose
    ``trace`` is filled (a :class:`Trace`) once the block has ended."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[getattr(ProfilerActivity, a)
                             for a in ACTIVITIES]) as prof:
        yield holder
    kernels, host = [], []
    kineto = getattr(prof.profiler, "kineto_results", None)
    if kineto is not None:
        # the profiler's raw events: far cheaper than building its
        # FunctionEvent tree over a window of a million launches
        for e in kineto.events():
            t0 = e.start_ns() / 1e3
            t1 = t0 + e.duration_ns() / 1e3
            if e.device_type().name == "CUDA":
                kernels.append((e.name(), t0, t1))
            else:
                host.append((e.name(), t0, t1))
    else:
        for e in prof.events():
            tr = e.time_range
            if e.device_type.name == "CUDA":
                kernels.append((e.name, float(tr.start), float(tr.end)))
            else:
                host.append((e.name, float(tr.start), float(tr.end)))
    holder.trace = Trace(kernels=kernels, host_ops=host)
