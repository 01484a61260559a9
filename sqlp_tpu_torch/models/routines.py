"""Host-side (exact) LP routines: HiGHS via scipy, float64.

Port of record: ``sqlp_tpu/models/routines.py:28-330`` (``solve_lp_host``,
``project_first_stage``, ``recourse_lower_bound``), unchanged numpy code;
tensor arguments are read back to the host first. This is the exact
oracle and fallback of the batched PDHG solver (ops/pdhg.py).

Dual sign convention matches JuMP's for MIN problems: the dual of a
constraint is d(objective)/d(rhs), so duals of '>=' rows are >= 0 and duals
of '<=' rows are <= 0. The golden subgradient test (test/sgd_example.jl:28,
beta = -T' pi) pins this convention.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.optimize

from sqlp_tpu_torch.models.stage import SENSE_E, SENSE_G, SENSE_L


def _np(a, dtype=None) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a, dtype)


def solve_lp_host(c: np.ndarray, A: np.ndarray, rhs: np.ndarray,
                  senses: np.ndarray, lb: np.ndarray, ub: np.ndarray
                  ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Solve min c@y s.t. A y {sense} rhs, lb <= y <= ub via HiGHS.

    Returns (objective, y, duals) with duals in the d(obj)/d(rhs)
    convention described in the module docstring.
    """
    m = len(rhs)
    g = senses == SENSE_G
    l = senses == SENSE_L
    e = senses == SENSE_E
    # '<=' block: L rows as-is, G rows negated.
    A_ub = np.concatenate([A[l], -A[g]], axis=0) if (l.any() or g.any()) else None
    b_ub = np.concatenate([rhs[l], -rhs[g]]) if A_ub is not None else None
    A_eq = A[e] if e.any() else None
    b_eq = rhs[e] if A_eq is not None else None
    bounds = list(zip(
        [v if np.isfinite(v) else None for v in lb],
        [v if np.isfinite(v) else None for v in ub],
    ))
    res = scipy.optimize.linprog(
        c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, bounds=bounds,
        method="highs")
    if res.status != 0:
        raise RuntimeError(f"Failed to solve subproblem: {res.message}")
    duals = np.zeros(m, dtype=np.float64)
    if A_ub is not None:
        mu = np.asarray(res.ineqlin.marginals, dtype=np.float64)
        n_l = int(l.sum())
        # L rows: d obj/d rhs = marginal; G rows: rhs enters negated.
        duals[l] = mu[:n_l]
        duals[g] = -mu[n_l:]
    if A_eq is not None:
        duals[e] = np.asarray(res.eqlin.marginals, dtype=np.float64)
    return float(res.fun), np.asarray(res.x, dtype=np.float64), duals


def project_first_stage(arrays, x0: np.ndarray, tol: float = 1e-7
                        ) -> Tuple[np.ndarray, float]:
    """Project x0 onto the first-stage feasible set {A1 x {senses} b1,
    lb1 <= x <= ub1} in the 1-norm (one host LP).

    The SD incumbent test compares cut-model estimates that ignore
    first-stage feasibility (check_improvement, src/sd_algorithm/
    improvement.jl:19-49), so an infeasible start x0 can pin the incumbent
    forever: its fictitiously low estimate is unbeatable by any feasible
    candidate (observed on storm with x0=0, whose 185 first-stage rows
    exclude 0; the reference only avoids this by crash-starting and its
    ``check_first_stage_feasible`` helper, src/prob.jl:20-32, is never
    called by the drivers).

    Returns (x_projected, distance). distance == 0.0 when x0 was feasible.
    """
    c_dt = np.float64
    x0 = np.asarray(x0, c_dt)
    b1 = _np(arrays.b1, c_dt)
    n1 = x0.shape[0]
    A1 = _np(arrays.A1, c_dt) if b1.size else np.zeros((0, n1))
    senses1 = _np(arrays.senses1)
    lb1 = _np(arrays.lb1, c_dt)
    ub1 = _np(arrays.ub1, c_dt)

    # feasibility check first
    r = A1 @ x0 - b1 if b1.size else np.zeros(0)
    viol = np.concatenate([
        np.abs(r[senses1 == SENSE_E]) if b1.size else np.zeros(0),
        np.maximum(-r[senses1 == SENSE_G], 0.0) if b1.size else np.zeros(0),
        np.maximum(r[senses1 == SENSE_L], 0.0) if b1.size else np.zeros(0),
        np.maximum(lb1 - x0, 0.0),
        np.maximum(x0 - ub1, 0.0),
    ])
    scale = 1.0 + np.abs(b1).max(initial=0.0) + np.abs(x0).max(initial=0.0)
    if viol.size == 0 or viol.max(initial=0.0) <= tol * scale:
        return x0, 0.0

    # min 1'u  s.t.  u >= x - x0, u >= x0 - x, A1 x {senses} b1, bounds
    g = senses1 == SENSE_G
    l = senses1 == SENSE_L
    e = senses1 == SENSE_E
    I = np.eye(n1)
    A_ub_rows = [np.concatenate([I, -I], axis=1),      # x - u <= x0
                 np.concatenate([-I, -I], axis=1)]     # -x - u <= -x0
    b_ub_rows = [x0, -x0]
    if l.any():
        A_ub_rows.append(np.concatenate([A1[l], np.zeros((l.sum(), n1))],
                                        axis=1))
        b_ub_rows.append(b1[l])
    if g.any():
        A_ub_rows.append(np.concatenate([-A1[g], np.zeros((g.sum(), n1))],
                                        axis=1))
        b_ub_rows.append(-b1[g])
    A_ub = np.concatenate(A_ub_rows, axis=0)
    b_ub = np.concatenate(b_ub_rows)
    A_eq = np.concatenate([A1[e], np.zeros((e.sum(), n1))], axis=1) \
        if e.any() else None
    b_eq = b1[e] if A_eq is not None else None
    obj = np.concatenate([np.zeros(n1), np.ones(n1)])
    bounds = [(lo if np.isfinite(lo) else None, hi if np.isfinite(hi) else None)
              for lo, hi in zip(lb1, ub1)] + [(0.0, None)] * n1
    res = scipy.optimize.linprog(obj, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq,
                                 b_eq=b_eq, bounds=bounds, method="highs")
    if res.status != 0:
        raise RuntimeError(
            f"first-stage projection LP failed (status {res.status}: "
            f"{res.message}); the first stage may be infeasible")
    return np.asarray(res.x[:n1], c_dt), float(res.fun)


def recourse_lower_bound(arrays, scenario_model, normal_sigmas: float = 10.0
                         ) -> float:
    """Provably valid lower bound on the per-scenario recourse Q(x, xi).

    The reference takes the epigraph lower bound as a user constant
    (sdEpigraph ctor, src/sd_algorithm/epigraph.jl:52-61) and blends it
    into every stored cut as (1-d)*lb (epigraph.jl:105-106). SD theory
    requires lb <= Q(x, xi) for every master-feasible x and every scenario
    xi: a too-high lb makes every decayed cut overestimate the recourse
    and SD converges to the wrong point (observed on baa99-20, whose
    reference driver passes lb=-500000 while Q dips below -860000 near
    the optimum).

    Here the bound is computed, not guessed: one exact host LP

        min  q'y   s.t.  A1 x {senses1} b1,  W y + T x - S eta {senses2} r,
                         lb1<=x<=ub1, lb2<=y<=ub2, eta in support box,

    where eta_k ranges over each random position's support (discrete:
    [min,max] outcome; uniform: [a,b]; normal: mean +- normal_sigmas*sigma
    — the device sampler is inverse-CDF so draws beyond ~6 sigma cannot
    occur in float32) and S scatters positions to rows. Minimizing jointly
    over x and eta lower-bounds Q at every feasible (x, scenario) pair.
    Transfer-matrix positions contribute the bilinear term -delta*x[j],
    bounded by its box corners (needs finite x bounds).

    Returns -inf (with a warning) when no finite bound exists (unbounded
    recourse over the box, or T-randomness with unbounded x).
    """
    import warnings

    m = scenario_model
    c_dt = np.float64
    q = _np(arrays.q, c_dt)
    W = _np(arrays.W, c_dt)
    T = _np(arrays.T, c_dt)
    r = _np(arrays.r, c_dt)
    b1 = _np(arrays.b1, c_dt)
    A1 = _np(arrays.A1, c_dt) if b1.size else np.zeros((0, T.shape[1]))
    senses1 = _np(arrays.senses1)
    senses2 = _np(arrays.senses2)
    lb1 = _np(arrays.lb1, c_dt)
    ub1 = _np(arrays.ub1, c_dt)
    lb2 = _np(arrays.lb2, c_dt)
    ub2 = _np(arrays.ub2, c_dt)
    m1, n1 = A1.shape
    m2, n2 = W.shape

    # per-position support bounds of the raw value
    from sqlp_tpu_torch.models.scenario import DIST_DISCRETE, DIST_NORMAL
    dist = _np(m.dist_type)
    values = _np(m.values, c_dt)
    mean = _np(m.mean, c_dt)
    std = _np(m.std, c_dt)
    left = _np(m.left, c_dt)
    width = _np(m.width, c_dt)
    v_lo = np.where(dist == DIST_DISCRETE, values.min(axis=1),
                    np.where(dist == DIST_NORMAL,
                             mean - normal_sigmas * std, left))
    v_hi = np.where(dist == DIST_DISCRETE, values.max(axis=1),
                    np.where(dist == DIST_NORMAL,
                             mean + normal_sigmas * std, left + width))
    base = _np(m.base, c_dt)
    is_rhs = _np(m.rv_is_rhs)
    is_cost = _np(m.rv_is_cost)
    rv_col = _np(m.rv_col)
    d_lo, d_hi = v_lo - base, v_hi - base            # delta box
    # effective per-row contribution bounds eta_k
    e_lo, e_hi = d_lo.copy(), d_hi.copy()

    # Random COST positions (reference TODO 6): q_j y_j with q_j ranging
    # over [v_lo, v_hi] is lower-bounded by a LINEAR term when the sign of
    # y_j is fixed by its bounds — q_lo y (y >= 0) / q_hi y (y <= 0); a
    # sign-spanning y with a finite box contributes the constant corner
    # minimum instead (its q term drops to 0). These positions carry no
    # eta variable.
    const_term = 0.0
    q = q.copy()
    if is_cost.any():
        rv_ycol = _np(m.rv_ycol)
        for k in np.nonzero(is_cost)[0]:
            j = int(rv_ycol[k])
            e_lo[k] = e_hi[k] = 0.0
            if lb2[j] >= 0.0:
                q[j] = min(q[j], v_lo[k])
            elif np.isfinite(ub2[j]) and ub2[j] <= 0.0:
                q[j] = max(q[j], v_hi[k])            # y <= 0: min is q_hi y
            elif np.isfinite(lb2[j]) and np.isfinite(ub2[j]):
                corners = [v_lo[k] * lb2[j], v_lo[k] * ub2[j],
                           v_hi[k] * lb2[j], v_hi[k] * ub2[j]]
                const_term += min(corners)
                q[j] = 0.0
            else:
                warnings.warn(
                    "recourse_lower_bound: random cost on a sign-spanning "
                    "unbounded column — no finite bound; supply an "
                    "explicit epigraph lower bound")
                return float("-inf")

    tpos = ~is_rhs & ~is_cost
    if tpos.any():
        xl, xu = lb1[rv_col[tpos]].copy(), ub1[rv_col[tpos]].copy()
        # When the box on x is infinite, the first-stage POLYTOPE may still
        # bound it (master-feasible candidates always satisfy A1 x senses b1;
        # the driver projects x0 onto it too). Tighten each needed column
        # with two tiny implied-bound LPs before giving up.
        need = ~(np.isfinite(xl) & np.isfinite(xu))
        if need.any():
            m1_, n1_ = A1.shape
            g1 = senses1 == SENSE_G
            l1 = senses1 == SENSE_L
            e1 = senses1 == SENSE_E
            A1_ub = (np.concatenate([A1[l1], -A1[g1]], axis=0)
                     if (l1.any() or g1.any()) else None)
            b1_ub = (np.concatenate([b1[l1], -b1[g1]])
                     if A1_ub is not None else None)
            A1_eq = A1[e1] if e1.any() else None
            b1_eq = b1[e1] if A1_eq is not None else None
            x_bounds = list(zip(
                [v if np.isfinite(v) else None for v in lb1],
                [v if np.isfinite(v) else None for v in ub1]))
            for idx in np.nonzero(need)[0]:
                j = rv_col[tpos][idx]
                obj_j = np.zeros(n1_)
                obj_j[j] = 1.0
                for sign, tgt in ((1.0, xl), (-1.0, xu)):
                    res = scipy.optimize.linprog(
                        sign * obj_j, A_ub=A1_ub, b_ub=b1_ub, A_eq=A1_eq,
                        b_eq=b1_eq, bounds=x_bounds, method="highs")
                    if res.status == 0:
                        tgt[idx] = sign * res.fun
        if not (np.isfinite(xl).all() and np.isfinite(xu).all()):
            warnings.warn("recourse_lower_bound: transfer-matrix randomness "
                          "with x unbounded even over the first-stage "
                          "polytope — no finite bound; supply an explicit "
                          "epigraph lower bound")
            return float("-inf")
        corners = np.stack([-d_lo[tpos] * xl, -d_lo[tpos] * xu,
                            -d_hi[tpos] * xl, -d_hi[tpos] * xu])
        e_lo[tpos] = corners.min(axis=0)
        e_hi[tpos] = corners.max(axis=0)

    R = dist.shape[0]
    S = np.zeros((m2, R))
    S[_np(m.rv_row), np.arange(R)] = 1.0
    S[:, is_cost] = 0.0        # cost positions patch q, not a row

    # stacked LP over z = (x, y, eta)
    A = np.zeros((m1 + m2, n1 + n2 + R))
    if m1:
        A[:m1, :n1] = A1
    A[m1:, :n1] = T
    A[m1:, n1:n1 + n2] = W
    A[m1:, n1 + n2:] = -S
    senses = np.concatenate([senses1, senses2])
    rhs = np.concatenate([b1, r])
    obj = np.concatenate([np.zeros(n1), q, np.zeros(R)])
    lo = np.concatenate([lb1, lb2, e_lo])
    hi = np.concatenate([ub1, ub2, e_hi])

    g = senses == SENSE_G
    l = senses == SENSE_L
    e = senses == SENSE_E
    A_ub = np.concatenate([A[l], -A[g]], axis=0) if (l.any() or g.any()) else None
    b_ub = np.concatenate([rhs[l], -rhs[g]]) if A_ub is not None else None
    A_eq = A[e] if e.any() else None
    b_eq = rhs[e] if A_eq is not None else None
    bounds = list(zip([v if np.isfinite(v) else None for v in lo],
                      [v if np.isfinite(v) else None for v in hi]))
    res = scipy.optimize.linprog(obj, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq,
                                 b_eq=b_eq, bounds=bounds, method="highs")
    if res.status != 0:
        warnings.warn(f"recourse_lower_bound LP did not solve "
                      f"(status {res.status}: {res.message}); supply an "
                      f"explicit epigraph lower bound")
        return float("-inf")
    return float(res.fun) + const_term
