"""Share of the traced window in which no kernel ran on the card, in %:
1 - (the union of the profiler's kernel intervals) / (the window)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "lp_solves_per_s"
BETTER = "lower"


def read(obs):
    tr = obs.get("trace")
    if obs.get("kind") != "mc_ub" or tr is None or not obs.get("window_s"):
        return None
    return 100.0 * (1.0 - tr.busy_s() / obs["window_s"])
