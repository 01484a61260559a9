"""The program's spans joined with the traced window.

The port records spans (``sqlp_tpu_torch.utils.profiling``) only while a
``torch.profiler`` session is active, so after a traced window has
closed they are that window's: a panel through the driver's ladder
(``driver.panel``), its steps (``ladder.first``, ``ladder.resolve``,
``ladder.f64``, ``ladder.host``), each PDHG solve (``pdhg.solve``), its
compactions (``pdhg.compact``) and restart rounds (``pdhg.round``, with
the stamps ``launched`` and ``enqueued``), an EF solve (``ef.solve``)
and its rounds (``ef.round``). Spans are stamped in Unix ns, the clock of
the profiler's events; the :class:`sdbench.trace.Trace` holds its
intervals in us on the same clock.

Run as a script, it drives one traced run of a cell and prints, as one
JSON line, what the spans say of it::

    python3 -m sdbench.spans --workload ssn.mc_ub --seed <n> --seconds <s>

the cell's end-to-end and per-layer metrics, the traced idle share, the
window's idle time split by the innermost span over it (a round split
at its stamps), the PDHG rounds the spans hold against those the
program counted, the share of rounds whose ``[enqueued, end]``
holds the ``cudaMemcpyAsync`` of their host read, a round's host time
as stamped and less its waits inside CUDA calls, and each ladder step's
share of the panels' time with the benchmark's certificate capture
inside it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

# the steps of the driver's escalation ladder, in their order
LADDER = ("ladder.first", "ladder.resolve", "ladder.f64", "ladder.host")


def recorded(obs: dict, kind: str) -> Optional[list]:
    """The spans of a traced window of a cell of ``kind``; None for
    another kind, an untraced run, or a program that records none."""
    if obs.get("kind") != kind or obs.get("trace") is None:
        return None
    try:
        from sqlp_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return list(spans()) or None


def named(spans: Sequence, name: str) -> list:
    return [s for s in spans if s.name == name]


def mean_us(spans: Sequence, frm: str, to: str) -> Optional[float]:
    """Mean over ``spans`` of the time from stamp ``frm`` to stamp ``to``
    in us; a stamp is an attribute, or ``start`` or ``end``."""
    if not spans:
        return None
    total = sum(_at(s, to) - _at(s, frm) for s in spans)
    return total / len(spans) / 1e3


def _at(s, key: str) -> int:
    if key == "start":
        return s.start
    if key == "end":
        return s.end
    return s.attrs[key]


def union(intervals) -> List[Tuple[float, float]]:
    """Sorted disjoint intervals covering the same time as
    ``intervals`` ((start, end) pairs)."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Covered:
    """How much of an interval the union of ``intervals`` ((start, end)
    pairs) covers, for many intervals: one bisection each."""

    def __init__(self, intervals):
        self.iv = union(intervals)
        self.starts = [s for s, _ in self.iv]
        self.before = [0.0]             # covered time before each interval
        for s, e in self.iv:
            self.before.append(self.before[-1] + (e - s))

    def until(self, t: float) -> float:
        """Covered time before ``t``."""
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        s, e = self.iv[i - 1]
        return self.before[i - 1] + min(e, t) - s

    def within(self, a: float, b: float) -> float:
        return self.until(b) - self.until(a)


def busy(trace) -> Covered:
    """The trace's kernel intervals, for :meth:`Covered.within`."""
    return Covered((s, e) for _, s, e in trace.kernels)


def idle_us(trace, pieces) -> float:
    """The time in us of ``pieces`` ((start, end) in ns) that no kernel
    interval of ``trace`` covers."""
    cov = busy(trace)
    total = 0.0
    for a, b in pieces:
        a, b = a / 1e3, b / 1e3
        total += (b - a) - cov.within(a, b)
    return total


def waits(trace) -> List[Tuple[str, float, float]]:
    """The stretches (name, start us, end us) in which the host waited
    for the card inside a CUDA runtime or driver call of the trace (a
    name that starts with ``cu``): a call that synchronizes waits all of
    its length; any other (a launch, a copy, an allocation) that takes
    more than twice the median length of its name over the window waits
    for what it takes past that median. A launch into a full launch queue
    returns only when the card has finished a kernel, so the host's time
    in it is the card's; the ordinary spread of a call's cost stays
    under twice its median and counts as the host's work."""
    calls = defaultdict(list)
    for name, s, e in trace.host_ops:
        if name.startswith("cu"):
            calls[name].append((s, e))
    out = []
    for name, got in calls.items():
        if "Synchronize" in name:
            out += [(name, s, e) for s, e in got]
            continue
        median = sorted(e - s for s, e in got)[len(got) // 2]
        out += [(name, s + median, e) for s, e in got if e - s > 2 * median]
    return out


def host_us(trace, spans: Sequence, frm: str, to: str) -> Optional[float]:
    """The host's work from stamp ``frm`` to stamp ``to`` of ``spans``,
    in us, their mean: that time less the :func:`waits` inside it."""
    if not spans:
        return None
    waited = Covered((s, e) for _, s, e in waits(trace))
    total = 0.0
    for sp in spans:
        a, b = _at(sp, frm), _at(sp, to)
        total += (b - a) / 1e3 - waited.within(a / 1e3, b / 1e3)
    return total / len(spans)


# a round's parts: from each stamp to the next (the last to its end)
_ROUND_PARTS = {"pdhg.round": (("start", "to launched"),
                               ("launched", "launched to enqueued"),
                               ("enqueued", "read")),
                "ef.round": (("start", "to enqueued"),
                             ("enqueued", "read"))}


def self_pieces(spans: Sequence) -> List[Tuple[str, int, int]]:
    """Each span's time outside its child spans as (label, start, end)
    in ns, a round's split at its stamps into the parts of
    ``_ROUND_PARTS`` (``pdhg.round: read`` and so on). Spans nest (one
    stack records them), so the pieces do not overlap."""
    children = defaultdict(list)
    for s in spans:
        if s.parent >= 0:
            children[s.parent].append(s)
    out = []
    for i, s in enumerate(spans):
        parts = _ROUND_PARTS.get(s.name)
        if parts is not None:
            stamps = [_at(s, k) for k, _ in parts] + [s.end]
            out += [(f"{s.name}: {label}", stamps[j], stamps[j + 1])
                    for j, (_, label) in enumerate(parts)]
            continue
        t = s.start
        for c in children[i]:
            out.append((s.name, t, c.start))
            t = c.end
        out.append((s.name, t, s.end))
    return out


def idle_by_span(trace, spans: Sequence, window_s: float) -> dict:
    """The window's idle time in s by the innermost span over it, and
    ``outside`` every span."""
    cov = busy(trace)
    by = defaultdict(float)
    for label, a, b in self_pieces(spans):
        a, b = a / 1e3, b / 1e3
        by[label] += ((b - a) - cov.within(a, b)) / 1e6
    idle = window_s - trace.busy_s()
    by["outside"] = idle - sum(by.values())
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def read_held(trace, rounds: Sequence, call: str = "cudaMemcpyAsync"
              ) -> Optional[float]:
    """Share of ``rounds`` whose ``[enqueued, end]`` holds a host event
    named ``call`` of the trace whole: the clocks agree."""
    ev = sorted((s, e) for n, s, e in trace.host_ops if n == call)
    if not rounds or not ev:
        return None
    starts = [s for s, _ in ev]
    held = 0
    for r in rounds:
        a, b = r.attrs["enqueued"] / 1e3, r.end / 1e3
        i = bisect.bisect_left(starts, a)
        while i < len(ev) and ev[i][0] <= b:
            if ev[i][1] <= b:
                held += 1
                break
            i += 1
    return held / len(rounds)


def _quantiles(xs) -> Optional[list]:
    if not xs:
        return None
    xs = sorted(xs)
    return [xs[int(q * (len(xs) - 1))] for q in (0.1, 0.5, 0.9, 0.99, 1.0)]


def round_host(trace, rounds: Sequence) -> Optional[dict]:
    """The host's time in a round from its start to ``enqueued`` (us, a
    round's mean), as stamped (``raw``) and less its waits (``host``),
    those waits by call name (us a round), and the launches enqueued
    there: a round's count, and the 10th, 50th, 90th and 99th
    percentiles and the largest of their lengths in us."""
    if not rounds:
        return None
    pieces = [(r.start / 1e3, r.attrs["enqueued"] / 1e3) for r in rounds]
    starts = [a for a, _ in pieces]

    def inside(s):
        k = bisect.bisect_right(starts, s) - 1
        return k >= 0 and s < pieces[k][1]
    lengths = [e - s for name, s, e in trace.host_ops
               if name.startswith(("cudaLaunch", "cuLaunch")) and inside(s)]
    waited = defaultdict(float)
    for name, s, e in waits(trace):
        if inside(s):
            waited[name] += (e - s) / len(rounds)
    return {"raw": mean_us(rounds, "start", "enqueued"),
            "host": host_us(trace, rounds, "start", "enqueued"),
            "waited_us_by_call": dict(waited),
            "launches": len(lengths) / len(rounds),
            "launch_us_p10_p50_p90_p99_max": _quantiles(lengths)}


def ladder_split(trace, sp: Sequence, certs: Sequence) -> dict:
    """For each ladder step: its share of the panels' time in % and its
    seconds, of them those in its PDHG solves and those in the
    benchmark's certificate capture (``certs``, (start, end) in ns, each
    after a solve inside a step), with the card's idle time in the
    capture."""
    panel = sum(x.end - x.start for x in named(sp, "driver.panel"))
    in_children = defaultdict(int)
    for c in sp:
        in_children[c.parent] += c.end - c.start
    cov = busy(trace)
    out = {}
    for i, x in enumerate(sp):
        if x.name not in LADDER:
            continue
        d = out.setdefault(x.name, {"share": 0.0, "s": 0.0, "solve_s": 0.0,
                                    "cert_s": 0.0, "cert_idle_s": 0.0})
        d["s"] += (x.end - x.start) / 1e9
        d["share"] += 100.0 * (x.end - x.start) / panel if panel else 0.0
        d["solve_s"] += in_children[i] / 1e9
        for a, b in certs:
            if x.start <= a and b <= x.end:
                d["cert_s"] += (b - a) / 1e9
                d["cert_idle_s"] += ((b - a) / 1e3
                                     - cov.within(a / 1e3, b / 1e3)) / 1e6
    return out


def report(cell_name: str, seed: int, seconds: float) -> dict:
    """One traced run of the cell on the card, read through its spans.
    It drives the cell as ``harness.run_cell`` does (which hands back no
    observations) and keeps its ``correct``: keep the two in step. It
    also times the benchmark's certificate capture in the mc_ub cells
    (the entry's ``_certificates``, wrapped for this run only)."""
    import importlib
    import time

    from sdbench import harness

    t_start = time.time()
    cell = harness.load_cell(cell_name)
    entry = importlib.import_module(
        f"sdbench.entries.{cell.workload['entry']}")
    certs = []
    take = getattr(entry, "_certificates", None)

    def timed(*a, **k):
        t0 = time.time_ns()
        got = take(*a, **k)
        certs.append((t0, time.time_ns()))
        return got
    if take is not None:
        entry._certificates = timed
    try:
        out = entry.run(cell, seed=seed, seconds=seconds, trace=True,
                        device="cuda", t_start=t_start)
    finally:
        if take is not None:
            entry._certificates = take
    tr, window_s = out.obs["trace"], out.obs["window_s"]
    sp = recorded(out.obs, out.obs["kind"]) or []
    res = {"cell": cell_name, "seed": seed,
           "correct": all(c.ok for c in out.checks) and out.failed == 0,
           "end_to_end": out.end_to_end,
           "idle_share": 1.0 - tr.busy_s() / window_s,
           "window_s": window_s, "spans": len(sp),
           "metrics": {m["name"]: harness.load_metric(m["name"]).read(
               out.obs) for m in cell.per_layer},
           "idle_by_span_s": idle_by_span(tr, sp, window_s)}
    rounds = named(sp, "pdhg.round")
    if out.obs["kind"] == "mc_ub":
        res["rounds"] = {"spans": len(rounds),
                         "counted": out.obs["pdhg_rounds"],
                         "panels": out.obs["panels"]}
        res["read_held"] = read_held(tr, rounds)
        res["round_host_us"] = round_host(tr, rounds)
        res["ladder"] = ladder_split(tr, sp, certs)
        res["cert_capture_s"] = sum(b - a for a, b in certs) / 1e9
    else:
        ef = named(sp, "ef.round")
        res["ef_rounds"] = len(ef)
        res["ef_read_held"] = read_held(tr, ef)
        res["round_host_us"] = round_host(tr, ef)
    return res


if __name__ == "__main__":
    import argparse
    import json

    p = argparse.ArgumentParser(prog="sdbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()
    print(json.dumps(report(args.workload, args.seed, args.seconds)),
          flush=True)
