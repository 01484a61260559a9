"""Per-stage LP templates spliced from a parsed SMPS core/time pair.

Copy of ``sqlp_tpu/models/stage.py`` (port of record).

Behavioral port of record: src/prob.jl (``spStageProblem`` :10-15,
``check_first_stage_feasible`` :20-32) and src/smps/smps_prob.jl
(``get_smps_stage_template`` :14-102) plus ``instantiate!``
(src/smps/smps_routines.jl:7-20). Where the reference builds a JuMP model,
we build dense NumPy blocks: for a two-stage problem, stage 2's template is
exactly the (r, T, W) split that the reference later re-extracts with
``extract_coefficients`` (src/sd_algorithm/subprob.jl:15-69) — here the dense
matrix form IS the primary representation.

Constraint senses are encoded as integers: +1 for 'G' (>=), -1 for 'L' (<=),
0 for 'E' (==).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from sqlp_tpu_torch.models.smps_cor import CorData, lookup_table
from sqlp_tpu_torch.models.smps_tim import TimData
from sqlp_tpu_torch.models.smps_sto import Scenario

SENSE_G, SENSE_L, SENSE_E = 1, -1, 0

_DIR_TO_SENSE = {"G": SENSE_G, "L": SENSE_L, "E": SENSE_E}


@dataclasses.dataclass
class StageLP:
    """One stage of a two-stage SP (reference ``spStageProblem``, prob.jl:10-15).

    Rows:    T @ x_last + W @ y  {>=,<=,==}  rhs   (sense per row)
    Columns: current-stage vars y with box bounds [lb, ub]; last-stage vars
             x_last appear only through T (their bounds live in stage 1).
    Objective (this stage only): c @ y.
    """

    # names
    last_names: List[str]
    cur_names: List[str]
    row_names: List[str]
    # objective over current-stage vars
    c: np.ndarray              # [n_cur]
    # constraint blocks
    T: np.ndarray              # [m, n_last]  (empty n_last for stage 1)
    W: np.ndarray              # [m, n_cur]
    rhs: np.ndarray            # [m]
    senses: np.ndarray         # [m] int, +1 '>=', -1 '<=', 0 '=='
    # bounds on current-stage vars
    lb: np.ndarray             # [n_cur]
    ub: np.ndarray             # [n_cur]
    # bounds on last-stage vars (copied from cor; used by the extensive form)
    last_lb: np.ndarray        # [n_last]
    last_ub: np.ndarray        # [n_last]
    # name of the cor objective row (row 0, direction 'N'): scenario
    # positions addressing it are random COST coefficients — the feature
    # the reference scopes out as TODO 6 ("Allow randomness in cost
    # coefficients q", readme.md:25-26)
    obj_row_name: str = ""

    @property
    def n_cur(self) -> int:
        return len(self.cur_names)

    @property
    def n_last(self) -> int:
        return len(self.last_names)

    @property
    def n_rows(self) -> int:
        return len(self.row_names)

    @property
    def col_lookup(self) -> Dict[str, int]:
        return lookup_table(self.last_names)

    @property
    def cur_lookup(self) -> Dict[str, int]:
        return lookup_table(self.cur_names)

    @property
    def row_lookup(self) -> Dict[str, int]:
        return lookup_table(self.row_names)

    def copy(self) -> "StageLP":
        """Deep copy (reference Base.copy, prob.jl:37-44)."""
        return StageLP(
            last_names=list(self.last_names),
            cur_names=list(self.cur_names),
            row_names=list(self.row_names),
            c=self.c.copy(), T=self.T.copy(), W=self.W.copy(),
            rhs=self.rhs.copy(), senses=self.senses.copy(),
            lb=self.lb.copy(), ub=self.ub.copy(),
            last_lb=self.last_lb.copy(), last_ub=self.last_ub.copy(),
            obj_row_name=self.obj_row_name,
        )


def get_smps_stage_template(cor: CorData, tim: TimData, stage: int) -> StageLP:
    """Slice the cor template into a per-stage LP (smps_prob.jl:14-102).

    ``stage`` is 1-based like the reference. The stage-s template contains
    stage-(s-1) columns as last-stage vars and stage-s columns as current
    vars; its rows are the stage-s constraint rows; its objective is cor row
    0 restricted to the current-stage columns.
    """
    n_periods = len(tim.periods)
    assert 1 <= stage <= n_periods, f"stage {stage} out of range"

    # Column ranges (0-based, end-exclusive), smps_prob.jl:20-34.
    if stage == 1:
        start_col = 0
    else:
        start_col = cor.col_mapping[tim.periods[stage - 2].position.col_name]
    if stage < n_periods:
        end_col = cor.col_mapping[tim.periods[stage].position.col_name]
    else:
        end_col = len(cor.col_names)
    cur_start_col = cor.col_mapping[tim.periods[stage - 1].position.col_name]

    last_names = cor.col_names[start_col:cur_start_col]
    cur_names = cor.col_names[cur_start_col:end_col]

    # Row range (0-based, end-exclusive); row 0 is the objective row,
    # smps_prob.jl:64-77.
    if stage == 1:
        start_row = 1
    else:
        start_row = cor.row_mapping[tim.periods[stage - 1].position.row_name]
    if stage < n_periods:
        end_row = cor.row_mapping[tim.periods[stage].position.row_name]
    else:
        end_row = len(cor.row_names)

    M = cor.template_matrix
    c = M[0, cur_start_col:end_col].copy()
    T = M[start_row:end_row, start_col:cur_start_col].copy()
    W = M[start_row:end_row, cur_start_col:end_col].copy()
    rhs = cor.rhs[start_row:end_row].copy()
    senses = np.array(
        [_DIR_TO_SENSE[d] for d in cor.directions[start_row:end_row]],
        dtype=np.int32)
    row_names = cor.row_names[start_row:end_row]

    return StageLP(
        last_names=last_names,
        cur_names=cur_names,
        row_names=list(row_names),
        c=c, T=T, W=W, rhs=rhs, senses=senses,
        lb=cor.lower_bound[cur_start_col:end_col].copy(),
        ub=cor.upper_bound[cur_start_col:end_col].copy(),
        last_lb=cor.lower_bound[start_col:cur_start_col].copy(),
        last_ub=cor.upper_bound[start_col:cur_start_col].copy(),
        obj_row_name=cor.row_names[0],
    )


def instantiate(sp: StageLP, scenario: Scenario, inplace: bool = False) -> StageLP:
    """Write scenario values into the stage LP (smps_routines.jl:7-20).

    ``col_name == "RHS"`` (or "rhs") patches the right-hand side; a position
    addressing the objective row patches the stage objective coefficient of
    a current-stage variable (random COST, the reference's open TODO 6,
    readme.md:25-26); any other column name patches the transfer-matrix
    coefficient (randomness in W is not a feature of the reference either —
    scenario columns always name last-stage vars, see
    src/sd_algorithm/subprob.jl:81-87).

    Raises AssertionError if a named row/column is not in this stage, same
    as the reference.
    """
    out = sp if inplace else sp.copy()
    row_lookup = out.row_lookup
    col_lookup = out.col_lookup
    cur_lookup = out.cur_lookup
    for pos, val in scenario:
        if pos.row_name == out.obj_row_name and out.obj_row_name:
            assert pos.col_name in cur_lookup, (
                f"Cost position {pos.col_name} not a current-stage var.")
            out.c[cur_lookup[pos.col_name]] = val
            continue
        assert pos.row_name in row_lookup, (
            f"Constraint {pos.row_name} not in this stage problem.")
        i = row_lookup[pos.row_name]
        if pos.col_name in ("RHS", "rhs"):
            out.rhs[i] = val
        else:
            assert pos.col_name in col_lookup, (
                f"Variable {pos.col_name} not in this stage problem.")
            out.T[i, col_lookup[pos.col_name]] = val
    return out


def extract_objective(sp: StageLP) -> np.ndarray:
    """Objective coefficient vector of the stage (reference keeps a JuMP
    AffExpr; ours is just ``sp.c``)."""
    return sp.c


def evaluate_first_stage_objective(sp: StageLP, x: np.ndarray) -> float:
    """c @ x (reference ``evaluate_expr``, src/utils.jl:26-30)."""
    return float(np.dot(sp.c, np.asarray(x, dtype=np.float64)))


def check_first_stage_feasible(sp1: StageLP, x: np.ndarray,
                               tol: float = 1e-9) -> bool:
    """Feasibility of a first-stage decision (prob.jl:20-32).

    The reference fixes x in a copied model and solves a FEASIBILITY_SENSE
    LP; with every variable fixed that reduces to directly checking bounds
    and constraint rows, which is what we do.
    """
    x = np.asarray(x, dtype=np.float64)
    if np.any(x < sp1.lb - tol) or np.any(x > sp1.ub + tol):
        return False
    lhs = sp1.W @ x
    g = sp1.senses == SENSE_G
    l = sp1.senses == SENSE_L
    e = sp1.senses == SENSE_E
    ok = True
    ok &= bool(np.all(lhs[g] >= sp1.rhs[g] - tol))
    ok &= bool(np.all(lhs[l] <= sp1.rhs[l] + tol))
    ok &= bool(np.all(np.abs(lhs[e] - sp1.rhs[e]) <= tol))
    return ok
