"""Compromise decisions across SD replications.

Port of record: ``sqlp_tpu/sd/compromise.py`` (``_merge_states`` :34-58,
``compromise_decision`` :61-115, ``polish_decision`` :118-249). After R
independent SD replications the compromise problem (Sen & Liu)

    min_x  c@x + (1/R) sum_r F_r(x) + rho/2 ||x - x_bar||^2

with F_r replication r's cut model and x_bar the average of the
incumbents is assembled by concatenating the replications' cut pools into
one multi-epigraph state, the machinery of the per-iteration master, and
solved by the ADMM QP. ``polish_decision`` then improves a decision by a
proximal bundle on one fresh scenario panel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from sqlp_tpu_torch.config import QPConfig
from sqlp_tpu_torch.models.routines import project_first_stage
from sqlp_tpu_torch.models.scenario import sample_deltas
from sqlp_tpu_torch.ops.pdhg import solve_batch
from sqlp_tpu_torch.ops.prox_qp import solve_qp
from sqlp_tpu_torch.sd.algorithm import _scenario_rhs
from sqlp_tpu_torch.sd.master import assemble_master
from sqlp_tpu_torch.sd.state import EpigraphSpec, SDState

_MERGED = ("cut_alpha", "cut_beta", "cut_mark", "cut_live", "cut_dual",
           "cut_x", "inc_alpha", "inc_beta", "inc_valid", "total_weight")


def _merge_states(states: Sequence[SDState], especs: Sequence[EpigraphSpec],
                  scale: float) -> Tuple[SDState, EpigraphSpec]:
    """Concatenate the replications' epigraphs into one state; weights
    scaled by ``scale`` (1/R: the merged objective is the average)."""
    merged = dataclasses.replace(states[0], **{
        f: torch.cat([getattr(s, f) for s in states]) for f in _MERGED})
    espec = EpigraphSpec(
        obj_weight=torch.cat([e.obj_weight * scale for e in especs]),
        lower_bound=torch.cat([e.lower_bound for e in especs]))
    return merged, espec


def compromise_decision(inst, states: Sequence[SDState],
                        especs: Sequence[EpigraphSpec], rho: float = 1.0,
                        qp_config: QPConfig = QPConfig(),
                        obj_scale: float = 1.0) -> Tuple[np.ndarray, dict]:
    """Solve the compromise problem over the replications' cut models.

    ``rho`` is the prox weight toward the incumbent average in user units;
    ``obj_scale`` is the replications' ``SDSolver.obj_scale`` (their cut
    pools live in scaled units). The result is clipped to the variable box
    and projected onto the first-stage polytope when a row is still
    violated. Returns (x_compromise, info) with the QP stats, the
    incumbent average ``x_bar`` and the per-replication incumbents.
    """
    R = len(states)
    if R < 1 or len(especs) != R:
        raise ValueError(f"{R} states and {len(especs)} epigraph specs")
    x_bar = torch.mean(torch.stack([s.x_incumbent for s in states]), dim=0)

    arrays = inst.arrays
    if obj_scale != 1.0:
        arrays = dataclasses.replace(arrays, c=arrays.c / obj_scale,
                                     q=arrays.q / obj_scale)
        rho = rho / obj_scale
    merged, espec = _merge_states(states, especs, 1.0 / R)
    merged = dataclasses.replace(merged, x_incumbent=x_bar)
    rho_t = torch.tensor(rho, dtype=arrays.c.dtype, device=arrays.c.device)
    z, _, stats = solve_qp(*assemble_master(arrays, espec, merged, rho_t),
                           qp_config)
    host = lambda t: t.detach().cpu().numpy()
    x = np.clip(np.asarray(host(z[:inst.n1]), np.float64),
                np.asarray(host(inst.arrays.lb1), np.float64),
                np.asarray(host(inst.arrays.ub1), np.float64))
    x, proj_dist = project_first_stage(inst.arrays, x)
    info = {
        "x_bar": host(x_bar),
        "incumbents": [host(s.x_incumbent) for s in states],
        "projection_distance": proj_dist,
        **{k: host(v) for k, v in stats.items()},
    }
    return x, info


def polish_decision(arrays, scenario_model, prep_sub, config, x0,
                    obj_scale: float = 1.0, n_scenarios: int = 8192,
                    rounds: int = 12, rho: float = 1.0, seed: int = 4242,
                    sampling: str = "stratified", qp_config=None,
                    values_fn=None):
    """Proximal-bundle polish of a first-stage decision on one fixed fresh
    scenario panel (the port of record's docstring has the measurements
    behind it).

    One panel of ``n_scenarios`` is drawn (``sampling``, from a generator
    seeded ``seed`` on the instance's device). Each round solves the panel
    at x (warm-started at the previous round's solution), takes the
    certified values from ``values_fn`` (``SDSolver._recourse_objs``,
    called as ``values_fn(H, obj0=..., valid0=...)`` so the round's own
    solve is reused; without it the raw objectives), keeps x as the best
    point when its panel value is lower (a serious step), adds the panel's
    aggregate cut, and takes one proximal master step toward the best
    point through :func:`solve_qp` (z = [x, eta]; rows: stage 1, x
    bounds, one cut per round), clipped and projected onto the
    first-stage polytope.

    Arguments are the driver's scaled internals (``SDSolver.arrays``,
    ``.prep_sub``, ``.config``; ``rho`` scaled too); x is never scaled.
    The final cost estimate must come from an independent sample. Returns
    (x_best, info) with the per-round values (unscaled), the serious
    steps, the step norms and ``f_best``. Raises ValueError on random-cost
    instances.
    """
    if scenario_model.has_cost:
        raise ValueError("polish_decision needs RHS-only randomness: "
                         "random-cost instances need per-scenario "
                         "objectives here")
    host = lambda t: np.asarray(t.detach().cpu().numpy(), np.float64)
    dt = arrays.c.dtype
    dev = arrays.c.device
    c64 = host(arrays.c)
    r64 = host(arrays.r)
    T64 = host(arrays.T)
    A1 = host(arrays.A1)
    b1 = host(arrays.b1)
    senses1 = arrays.senses1.cpu().numpy()
    lb1 = host(arrays.lb1)
    ub1 = host(arrays.ub1)
    rv_row = scenario_model.rv_row.cpu().numpy().astype(np.int64)
    rv_is_rhs = scenario_model.rv_is_rhs.cpu().numpy()
    n1 = c64.shape[0]
    m1 = b1.shape[0]

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    deltas = sample_deltas(gen, scenario_model, n_scenarios,
                           method=sampling).to(dt)
    deltas_h = host(deltas)
    p = np.full(n_scenarios, 1.0 / n_scenarios)

    # proximal master QP: z = [x, eta]; rows = stage-1 | x bounds | cuts
    nz = n1 + 1
    n_rows = m1 + n1 + rounds
    on_dev = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    p_diag = on_dev(np.concatenate([np.full(n1, rho), [0.0]]))
    is_eq = torch.as_tensor(np.concatenate(
        [senses1 == 0, np.zeros(n_rows - m1, bool)]), device=dev)
    A_q = np.zeros((n_rows, nz))
    l_q = np.full(n_rows, -np.inf)
    u_q = np.full(n_rows, np.inf)
    A_q[:m1, :n1] = A1
    l_q[:m1] = np.where(senses1 == -1, -np.inf, b1)
    u_q[:m1] = np.where(senses1 == 1, np.inf, b1)
    A_q[m1:m1 + n1, :n1] = np.eye(n1)
    l_q[m1:m1 + n1] = lb1
    u_q[m1:m1 + n1] = ub1

    if qp_config is None:
        # the one-shot generous config, not the SD master's stall-capped
        # one: this master must reach its optimum or the step is noise
        qp_config = QPConfig()
    x = np.asarray(x0, np.float64)
    x_best = x.copy()
    f_best = np.inf
    values, serious, steps = [], [], []
    Y0 = L0 = None
    for k in range(rounds):
        H = _scenario_rhs(arrays, scenario_model, deltas, on_dev(x))
        obj, Y, Pi, stats = solve_batch(prep_sub, H, config.pdhg, Y0=Y0,
                                        L0=L0)
        Y0, L0 = Y, Pi
        if values_fn is not None:
            vals = values_fn(H, obj0=obj, valid0=stats["pdhg_valid"])
        else:
            vals = host(obj)
        f_x = float(c64 @ x + p @ vals)
        values.append(f_x * obj_scale)
        if f_x < f_best:
            f_best, x_best = f_x, x.copy()
            serious.append(k)
        # the panel's aggregate cut at x (host f64; RHS-only randomness)
        Pi_h = host(Pi)
        pi_rows = Pi_h[:, rv_row]
        rhs_d = np.where(rv_is_rhs[None, :], deltas_h, 0.0)
        alpha = p @ (Pi_h @ r64) + np.sum(p[:, None] * rhs_d * pi_rows)
        beta = -(T64.T @ (p @ Pi_h))
        A_q[m1 + n1 + k, :n1] = -beta
        A_q[m1 + n1 + k, n1] = 1.0
        l_q[m1 + n1 + k] = alpha
        # proximal master step toward the best point
        g = np.concatenate([c64 - rho * x_best, [1.0]])
        z, _, _ = solve_qp(p_diag, on_dev(g), on_dev(A_q), on_dev(l_q),
                           on_dev(u_q), is_eq, qp_config)
        x = np.clip(host(z)[:n1], lb1, ub1)
        x, _ = project_first_stage(arrays, x)
        steps.append(float(np.linalg.norm(x - x_best)))
    info = {"values": values, "serious_steps": serious,
            "step_norms": steps, "f_best": f_best * obj_scale}
    return x_best, info
