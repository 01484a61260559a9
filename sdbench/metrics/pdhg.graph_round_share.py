"""Share of the window's PDHG restart rounds replayed from a CUDA graph,
in %: the ``pdhg.round`` spans (``ops/pdhg.py:solve_batch``) whose
``graph`` attribute is true, over all of them. Nothing where the rounds'
spans carry no such attribute (a program that replays no round)."""

from sdbench import spans

LAYER = "recourse PDHG"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "lp_solves_per_s"
BETTER = "higher"


def read(obs):
    got = spans.recorded(obs, "mc_ub")
    if got is None:
        return None
    rounds = spans.named(got, "pdhg.round")
    if not rounds or any("graph" not in r.attrs for r in rounds):
        return None
    return 100.0 * sum(bool(r.attrs["graph"]) for r in rounds) / len(rounds)
