"""Run one benchmark cell once and print its result line.

    python3 sdbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    python3 -m sdbench.run ...           (the same, from the repo root)

Everything is found by name: the cell in ``sdbench/workloads/<cell>.json``
(its configuration, entry, traffic parameters, chips and why), the
configuration in ``sdbench/configs/<config>.json``, the entry that drives
the program in ``sdbench/entries/<entry>.py``, and each per-layer metric
in ``sdbench/metrics/<metric>.py``. ``BENCHMARK.json`` at the root says
which metrics a cell reports.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of the window and the program's counters. Every run checks what the
window produced against the plain reference (``sdbench/reference.py``)
after the window has closed and prints each number compared beside its
limit: on standard error as the last lines, and under ``checks``, the
last key of the result line, which is the last line of standard output.

Exit codes: 0 with a result, also one whose ``correct`` is false; 2 when
the card the cell asks for is missing; 3 when JAX, flax or the JAX
package was loaded; 1 on any other failure. Only a run that exits 0
prints a result.
"""

from __future__ import annotations

import os
import sys
import time

_T_IMPORT = time.time()


def _process_start() -> float:
    """The wall time this process started at (Linux), else the time this
    module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        start = time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
        return min(start, _T_IMPORT)
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# JAX and the JAX package must never be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "sqlp_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="sdbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = _process_start()

    from sdbench import harness

    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"sdbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device="cuda",
                           t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"sdbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    harness.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
