"""The PDHG round kernels' share of their roofline, in %: the least time
of every round the window launched (``sdbench.roofline.pdhg_round`` at
each launch's rows, dtype and variant, 80 steps a round, from the
program's ``launches_by_shape`` counter) over the device time in which a
PDHG kernel ran (the union of their intervals in the profiler's trace,
matched by kernel name). The cells that report it run the Halpern scheme
(B1) alone."""

import re

from sdbench import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "lp_solves_per_s"
BETTER = "higher"

KERNELS = re.compile(r"pdhg_(tile|stream|cluster|halpern|average)_kernel"
                     r"|grid_primal|grid_dual|small_round")
VARIANTS = {"launches": "rows", "cluster_launches": "cluster",
            "tile_launches": "tile", "stream_launches": "stream",
            "grid_launches": "grid", "small_launches": "small"}


def least_s(launches, m, n, steps=80):
    total = 0.0
    for (counter, B, itemsize), count in launches.items():
        halpern = not counter.startswith("average_")
        variant = VARIANTS[counter[len("average_"):] if not halpern
                           else counter]
        dtype = {4: "float32", 8: "float64"}[itemsize]
        total += count * roofline.pdhg_round(B, m, n, dtype, variant, steps,
                                             halpern)
    return total


def read(obs):
    tr = obs.get("trace")
    if obs.get("kind") != "mc_ub" or tr is None or not obs.get("launches"):
        return None
    busy = tr.union_s(lambda name: KERNELS.search(name) is not None)
    if busy <= 0.0:
        return None
    return 100.0 * least_s(obs["launches"], obs["m"], obs["n"]) / busy
