"""The card's idle time that the PDHG round loop causes, in us a round:
over the window's ``pdhg.round`` spans (which tile each rung's loop, from
one host read's return to the next's), the time that the union of the
profiler's kernel intervals leaves uncovered, over the rounds."""

from sdbench import spans

LAYER = "recourse PDHG"
UNIT = "us"
SOURCE = "device_trace"
MOVES = "lp_solves_per_s"
BETTER = "lower"


def read(obs):
    got = spans.recorded(obs, "mc_ub")
    rounds = spans.named(got or [], "pdhg.round")
    if not rounds:
        return None
    return spans.idle_us(obs["trace"], [(r.start, r.end) for r in rounds]) \
        / len(rounds)
