"""Stopping rules.

Port of record: ``sqlp_tpu/sd/stopping.py`` (:1-56), copied: no tensor
enters here, but the port imports nothing of the JAX package.

The reference planned these but never implemented them — the plugin file
src/sd_algorithm/plugin/stopping_rule.jl is 0 bytes and readme.md:18 lists
"Need to implement stopping criteria" as an open TODO. This module provides
the standard SD-style rules on top of the per-iteration stats stream:

  * ``LowerBoundStabilization`` — stop when an objective-estimate series
    has moved less than rel_tol over a trailing window. The CLI feeds the
    incumbent estimate (``inc_est``): the candidate series jumps with
    every new cut while the incumbent's estimate is the stable lower-bound
    proxy whose stall actually signals convergence;
  * ``GapRule`` — stop when the Monte-Carlo upper-bound estimate and the
    lb estimate agree within a relative gap (requires periodic evaluate()
    calls; the CI half-width from evaluate_ci can be folded in).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional


@dataclasses.dataclass
class LowerBoundStabilization:
    """Stop when the fed estimate's relative movement over `window`
    checks < rel_tol (the CLI feeds ``inc_est``, see module docstring)."""

    window: int = 20
    rel_tol: float = 1e-4
    _hist: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=64))

    def update(self, est: float) -> bool:
        if self._hist.maxlen < self.window:
            self._hist = deque(self._hist, maxlen=self.window)
        self._hist.append(float(est))
        if len(self._hist) < self.window:
            return False
        recent = list(self._hist)[-self.window:]
        lo, hi = min(recent), max(recent)
        return (hi - lo) <= self.rel_tol * (1.0 + abs(hi))


@dataclasses.dataclass
class GapRule:
    """Stop when (ub - lb) / (1 + |ub|) <= rel_gap (optionally inflating ub
    by a CI half-width for a conservative test)."""

    rel_gap: float = 1e-2

    def check(self, lb_est: float, ub_est: float,
              ub_half_width: float = 0.0) -> bool:
        gap = (ub_est + ub_half_width) - lb_est
        return gap <= self.rel_gap * (1.0 + abs(ub_est))
