"""The host's work in a round of the certification EF, in ms: over the
window's ``ef.round`` spans (``models/crash.py``), the mean time from the
return of the host read that admitted the round to the round's work
enqueued, less the time the host waited for the card inside a CUDA call
there (``sdbench.spans.waits``, read from the trace's runtime calls): a
round enqueues about 3,300 launches, more than the launch queue holds,
so while the card is the slower side the host waits in the late ones."""

from sdbench import spans

LAYER = "certification EF"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "ef_scenario_steps_per_s"
BETTER = "lower"


def read(obs):
    got = spans.recorded(obs, "ef")
    if got is None:
        return None
    us = spans.host_us(obs["trace"], spans.named(got, "ef.round"),
                       "start", "enqueued")
    return None if us is None else us / 1e3
