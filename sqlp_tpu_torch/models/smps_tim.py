"""SMPS .tim (time/period file) parser, implicit format.

Copy of ``sqlp_tpu/models/smps_tim.py`` (port of record).

Behavioral port of record: src/smps/smps_tim.jl in the reference
(``spSmpsPosition`` :5-8, ``spTimType`` :22-25, ``read_tim`` :30-64).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List

SUPPORTED_SECTIONS = ("TIME", "PERIODS", "ENDATA")


@dataclasses.dataclass(frozen=True)
class Position:
    """A (column, row) position in the LP template (smps_tim.jl:5-8).

    Also used for scenario entries: ``col_name == "RHS"`` marks a
    right-hand-side position.
    """

    col_name: str
    row_name: str


@dataclasses.dataclass(frozen=True)
class Period:
    """One implicit period split point (smps_tim.jl:13-16)."""

    period_name: str
    position: Position


@dataclasses.dataclass
class TimData:
    """Parsed time file (smps_tim.jl:22-25)."""

    problem_name: str
    periods: List[Period]


def read_tim(tim_path: str) -> TimData:
    """Read an implicit time file (smps_tim.jl:30-64)."""
    with open(tim_path, "r") as f:
        lines = f.read().splitlines()

    section = ""
    problem_name = ""
    periods: List[Period] = []

    for line in lines:
        if not line.strip():
            continue
        parts = line.split()
        if line[0] in (" ", "\t"):
            if section != "PERIODS":
                raise AssertionError(
                    f"tim data line outside PERIODS section: {line!r}")
            if len(parts) != 3:
                warnings.warn(
                    f"Parser: more tokens than expected in tim file: {line!r}")
            col_name, row_name, period_name = parts[0], parts[1], parts[2]
            periods.append(Period(period_name, Position(col_name, row_name)))
        else:
            section = parts[0]
            if section not in SUPPORTED_SECTIONS:
                raise AssertionError(f"Unsupported tim section {section!r}")
            if section == "TIME" and len(parts) > 1:
                problem_name = parts[1]

    return TimData(problem_name=problem_name, periods=periods)
