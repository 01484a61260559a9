"""Share of the panels' time that the driver's escalation ladder spends
past its first solve, in %: the time in the ``ladder.resolve``,
``ladder.f64`` and ``ladder.host`` spans (``sd/driver.py:_recourse_objs``)
over the time in the ``driver.panel`` spans."""

from sdbench import spans

LAYER = "driver"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "lp_solves_per_s"
BETTER = "lower"


def read(obs):
    got = spans.recorded(obs, "mc_ub")
    if got is None:
        return None
    panel = sum(s.end - s.start for s in spans.named(got, "driver.panel"))
    if panel <= 0:
        return None
    later = sum(s.end - s.start for s in got
                if s.name in spans.LADDER[1:])
    return 100.0 * later / panel
