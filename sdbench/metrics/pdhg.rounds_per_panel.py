"""PDHG restart rounds per panel: ``stats["pdhg_rounds"]`` of every
``solve_batch`` the window's panels made (the first solve and the
ladder's re-solves), over the panels."""

LAYER = "recourse PDHG"
UNIT = "rounds"
SOURCE = "program_counter"
MOVES = "lp_solves_per_s"
BETTER = "lower"


def read(obs):
    if obs.get("kind") != "mc_ub" or not obs.get("panels"):
        return None
    return obs["pdhg_rounds"] / obs["panels"]
