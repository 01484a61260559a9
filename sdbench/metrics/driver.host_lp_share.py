"""Share of the window's recourse LPs that the driver's escalation ladder
sent to the host's exact solver (``SDSolver.host_fallback_count``), in %."""

LAYER = "driver"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "lp_solves_per_s"
BETTER = "lower"


def read(obs):
    if obs.get("kind") != "mc_ub" or not obs.get("lps"):
        return None
    return 100.0 * obs["host_fallback"] / obs["lps"]
