"""The cell-independent part of a run: finding a cell's files by name,
driving its entry, reading its per-layer metrics, and the result line.

An entry (``sdbench/entries/<entry>.py``) exposes
``run(cell, seed, seconds, trace, device, t_start) -> Outcome``: it sets
up, measures the window, and checks the window's output against the
reference once the window has closed. A per-layer metric
(``sdbench/metrics/<name>.py``) exposes ``read(obs) -> float | None``
over the :class:`Outcome`'s observations; None leaves it out of the line.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "sdbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def params(self) -> dict:
        return self.workload["params"]


@dataclasses.dataclass
class Check:
    """One number compared with its limit; ``ok`` is value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    checks: List[Check]
    end_to_end: Dict[str, float]
    obs: dict                       # what the metric readers read
    device: dict
    breakdown: Optional[dict] = None


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    """The cell's files, by name; ValueError for a name that is not a
    cell of ``BENCHMARK.json``."""
    if not NAME.match(name):
        raise ValueError(f"bad cell name {name!r}")
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"{name!r} is not a cell of BENCHMARK.json")
    workload = _json(os.path.join(HERE, "workloads", f"{name}.json"))
    entry = cells[name]
    if workload["config"] != entry["config"] \
            or int(workload["chips"]) != int(entry["chips"]):
        raise ValueError(f"{name}: workload file and BENCHMARK.json differ")
    config = _json(os.path.join(HERE, "configs", f"{entry['config']}.json"))

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return Cell(name=name, config=config, workload=workload,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def instance_dir(config: dict) -> str:
    """The configuration's SMPS directory in the checkout, once each of
    its files has the SHA-256 that the configuration pins; ValueError
    where one differs, so that a changed instance cannot change the work
    unseen."""
    path = os.path.join(ROOT, config["instance"])
    for fname, want in config["instance_sha256"].items():
        with open(os.path.join(path, fname), "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise ValueError(f"{config['instance']}/{fname}: SHA-256 {got}, "
                             f"the configuration pins {want}")
    return path


def quantity(name: str, known) -> str:
    """The quantity a metric reports: its name, or, for a quantity split
    by cells that report different end-to-end metrics
    (``<quantity>.<suffix>``), the longest prefix that ``known`` holds."""
    stem = name
    while stem not in known:
        if "." not in stem:
            raise ValueError(f"no quantity for metric {name!r}")
        stem = stem.rsplit(".", 1)[0]
    return stem


def load_metric(name: str):
    """The reader module of a per-layer metric, by name: the file
    ``metrics/<quantity>.py`` (:func:`quantity`)."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    readers = {f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
               if f.endswith(".py")}
    path = os.path.join(HERE, "metrics", f"{quantity(name, readers)}.py")
    spec = importlib.util.spec_from_file_location(
        f"sdbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """Drive one run of the cell and return its result object (not yet
    printed). ``device="cpu"`` runs the program's plain versions: for
    the tests only, never for a number."""
    import time
    entry = importlib.import_module(
        f"sdbench.entries.{cell.workload['entry']}")
    out: Outcome = entry.run(cell, seed=seed, seconds=seconds, trace=trace,
                             device=device,
                             t_start=time.time() if t_start is None
                             else t_start)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = load_metric(m["name"]).read(out.obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = out.end_to_end[quantity(m["name"], out.end_to_end)]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = all(c.ok for c in out.checks) and out.failed == 0
    res = {"correct": correct, "attempted": int(out.attempted),
           "failed": int(out.failed), "metrics": metrics,
           "device": out.device}
    if trace and out.breakdown is not None:
        res["breakdown"] = out.breakdown
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in out.checks}
    return res


def emit(res: dict) -> None:
    """Each compared number beside its limit as the last lines on
    standard error, then the result as the last line on standard
    output."""
    for name, c in res["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


def device_info(device: str, count: int = 1) -> dict:
    """The ``device`` block: the card's name, cards used, peak memory
    (``torch.cuda.max_memory_allocated``, the process's peak since it
    began) and the power limit that ``nvidia-smi`` reads."""
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info
