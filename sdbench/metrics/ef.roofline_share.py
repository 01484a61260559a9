"""The certification EF's share of its roofline, in %: the least time of
every step the window ran (``sdbench.roofline.ef_step`` for one
replication of S scenarios, times the replication-steps the program's
``ef_iters`` counted) over the device time of the window (the union of
the profiler's kernel intervals: the EF is all the window runs)."""

from sdbench import roofline

LAYER = "certification EF"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ef_scenario_steps_per_s"
BETTER = "higher"


def read(obs):
    tr = obs.get("trace")
    if obs.get("kind") != "ef" or tr is None or not obs.get("rep_steps"):
        return None
    busy = tr.busy_s()
    if busy <= 0.0:
        return None
    m1, n1, m2, n2 = obs["dims"]
    least = obs["rep_steps"] * roofline.ef_step(1, obs["S"], m1, n1, m2, n2,
                                                obs["dtype"])
    return 100.0 * least / busy
