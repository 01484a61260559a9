"""A plain reader of two-stage SMPS triples (.cor, .tim, .sto), numpy only.

The benchmark's own reading of the instance files, independent of the
program: it feeds the scenario sampler and the plain reference. It knows
what ssn and storm need and refuses the rest: free-format MPS with ROWS,
COLUMNS and RHS sections and no BOUNDS or RANGES (every variable in
[0, inf)), an implicit two-period .tim, and an INDEP DISCRETE .sto whose
random entries are right-hand sides of stage-2 rows.

    stage 1:  min c x    s.t. A1 x (senses1) b1,   x >= 0
    stage 2:  min q y    s.t. W y (senses2) r + d - T x,   y >= 0

Senses are "G", "L" or "E" per row.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class TwoStage:
    name: str
    c: np.ndarray          # [n1]
    A1: np.ndarray         # [m1, n1]
    b1: np.ndarray         # [m1]
    senses1: List[str]     # [m1]
    q: np.ndarray          # [n2]
    W: np.ndarray          # [m2, n2]
    T: np.ndarray          # [m2, n1]
    r: np.ndarray          # [m2]
    senses2: List[str]     # [m2]
    rows2: List[str]       # stage-2 row names, in file order


@dataclasses.dataclass(frozen=True)
class Discrete:
    """The .sto's random right-hand sides, in order of first appearance."""
    rows: List[str]            # [Rv] stage-2 row names
    row_index: np.ndarray      # [Rv] index into the stage-2 rows
    base: np.ndarray           # [Rv] the .cor's right-hand side there
    values: List[np.ndarray]   # per variable, its outcomes
    probs: List[np.ndarray]    # per variable, their probabilities


def _lines(path: str):
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("*"):
                yield line.rstrip("\n")


def _sections(path: str) -> Dict[str, list]:
    out: Dict[str, list] = {}
    cur = None
    for line in _lines(path):
        parts = line.split()
        if line[0] not in " \t":
            cur = parts[0]
            out.setdefault(cur, [])
            if len(parts) > 1:
                out[cur].append(parts[1:])
        else:
            out[cur].append(parts)
    return out


def read_two_stage(directory: str) -> TwoStage:
    name = os.path.basename(os.path.normpath(directory))
    cor = _sections(os.path.join(directory, f"{name}.cor"))
    for sec in ("BOUNDS", "RANGES"):
        if cor.get(sec):
            raise ValueError(f"{name}.cor: a {sec} section is not read here")
    kinds = {}
    rows: List[str] = []
    for kind, row in cor["ROWS"]:
        kinds[row] = kind
        rows.append(row)
    obj = [r for r in rows if kinds[r] == "N"][0]
    cons = [r for r in rows if kinds[r] != "N"]
    ri = {r: i for i, r in enumerate(cons)}
    cols: Dict[str, int] = {}
    entries = []
    for parts in cor["COLUMNS"]:
        if "MARKER" in parts:
            raise ValueError(f"{name}.cor: integer markers are not read here")
        col = cols.setdefault(parts[0], len(cols))
        for k in range(1, len(parts) - 1, 2):
            entries.append((parts[k], col, float(parts[k + 1])))
    A = np.zeros((len(cons), len(cols)))
    cost = np.zeros(len(cols))
    for row, col, v in entries:
        if row == obj:
            cost[col] = v
        else:
            A[ri[row], col] = v
    rhs = np.zeros(len(cons))
    for parts in cor.get("RHS", []):
        for k in range(1, len(parts) - 1, 2):
            if parts[k] != obj:
                rhs[ri[parts[k]]] = float(parts[k + 1])

    tim = _sections(os.path.join(directory, f"{name}.tim"))
    periods = [p for p in tim["PERIODS"] if len(p) == 3]
    if len(periods) != 2:
        raise ValueError(f"{name}.tim: two periods expected")
    col2 = cols[periods[1][0]]
    row2 = ri[periods[1][1]]
    sense = [kinds[r] for r in cons]
    return TwoStage(
        name=name, c=cost[:col2], A1=A[:row2, :col2], b1=rhs[:row2],
        senses1=sense[:row2], q=cost[col2:], W=A[row2:, col2:],
        T=A[row2:, :col2], r=rhs[row2:], senses2=sense[row2:],
        rows2=cons[row2:])


def read_discrete(directory: str, lp: TwoStage) -> Discrete:
    name = os.path.basename(os.path.normpath(directory))
    sto = _sections(os.path.join(directory, f"{name}.sto"))
    head = sto.get("INDEP", [[]])[0]
    if head != ["DISCRETE"]:
        raise ValueError(f"{name}.sto: INDEP DISCRETE expected, got {head}")
    order: Dict[str, int] = {}
    vals: List[List[float]] = []
    probs: List[List[float]] = []
    for parts in sto["INDEP"][1:]:
        col, row, v, p = parts[0], parts[1], float(parts[2]), float(parts[-1])
        if col.upper() != "RHS":
            raise ValueError(f"{name}.sto: only right-hand sides are random "
                             f"here, got column {col}")
        k = order.setdefault(row, len(order))
        if k == len(vals):
            vals.append([])
            probs.append([])
        vals[k].append(v)
        probs[k].append(p)
    ri = {r: i for i, r in enumerate(lp.rows2)}
    rows = list(order)
    idx = np.array([ri[r] for r in rows], np.int64)
    return Discrete(rows=rows, row_index=idx, base=lp.r[idx].copy(),
                    values=[np.array(v) for v in vals],
                    probs=[np.array(p) / np.sum(p) for p in probs])
