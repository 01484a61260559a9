"""The host's work in a PDHG restart round, in us: over the window's
``pdhg.round`` spans (``ops/pdhg.py:solve_batch``), the mean time from
the return of the host read that admitted the round to the return of
``round_step``, every launch and eager op of the round enqueued, less
the time the host waited for the card inside a CUDA call there (a
launch into a full queue, a synchronizing call; ``sdbench.spans.waits``,
read from the trace's runtime calls)."""

from sdbench import spans

LAYER = "recourse PDHG"
UNIT = "us"
SOURCE = "device_trace"
MOVES = "lp_solves_per_s"
BETTER = "lower"


def read(obs):
    got = spans.recorded(obs, "mc_ub")
    if got is None:
        return None
    return spans.host_us(obs["trace"], spans.named(got, "pdhg.round"),
                         "start", "enqueued")
