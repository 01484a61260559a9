"""The plain reference that decides ``correct``.

It imports nothing of the program: it reads the instance files through
``sdbench.smps`` and works from the benchmark's own inputs (deltas, x).

- :func:`recourse_values`: each scenario's recourse LP
  min q y s.t. W y (senses) r + d - T x, y >= 0, solved exactly in float64
  by scipy's HiGHS, one LP at a time; with ``solutions=True`` also each
  LP's y and its row duals.
- :func:`kkt_errors`: the relative KKT error of a recourse LP's (y, pi),
  in float64, in the measure whose bound ``valid_tol`` the program's
  ladder certifies each value to (worked out again here: the objective's
  normalisation, the sense flips, the Ruiz equilibration).
- :func:`tf32_round`: rounding to TF32's 10-bit mantissa, for the control
  (the reference computed one precision below float32).
"""

from __future__ import annotations

import numpy as np

from sdbench.smps import Discrete, TwoStage


def tf32_round(a):
    """The nearest TF32 value (8-bit exponent, 10-bit mantissa, ties away
    from zero) of each entry of a tensor, in its dtype and on its device,
    or of an array, as a float64 array."""
    import torch
    if not torch.is_tensor(a):
        return tf32_round(torch.as_tensor(np.asarray(a, np.float64))).numpy()
    bits = a.float().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(a.dtype)


def scenario_rhs(lp: TwoStage, disc: Discrete, deltas: np.ndarray,
                 x: np.ndarray) -> np.ndarray:
    """[B, Rv] deltas at x -> [B, m2] right-hand sides r + d - T x."""
    h = np.tile(lp.r - lp.T @ np.asarray(x, np.float64),
                (deltas.shape[0], 1))
    np.add.at(h.T, disc.row_index, np.asarray(deltas, np.float64).T)
    return h


def recourse_values(lp: TwoStage, H: np.ndarray, solutions: bool = False):
    """Exact optimal values of the recourse LPs of each row of H; with
    ``solutions``, (values, Y [B, n2], Pi [B, m2]), Pi in the
    d(value)/d(rhs) convention."""
    from scipy.optimize import linprog

    s = np.asarray(lp.senses2)
    le, ge, eq = s == "L", s == "G", s == "E"
    A_ub = np.concatenate([lp.W[le], -lp.W[ge]])
    A_eq = lp.W[eq]
    out = np.empty(H.shape[0])
    Y = np.zeros((H.shape[0], lp.W.shape[1]))
    Pi = np.zeros(H.shape)
    for b, h in enumerate(H):
        res = linprog(lp.q, A_ub=A_ub, b_ub=np.concatenate([h[le], -h[ge]]),
                      A_eq=A_eq, b_eq=h[eq], bounds=(0, None),
                      method="highs")
        if res.status != 0:
            raise RuntimeError(f"reference LP {b}: {res.message}")
        out[b] = res.fun
        if solutions:
            Y[b] = res.x
            du = res.ineqlin.marginals
            Pi[b, le] = du[:le.sum()]
            Pi[b, ge] = -du[le.sum():]
            if eq.any():
                Pi[b, eq] = res.eqlin.marginals
    return (out, Y, Pi) if solutions else out


def objective_scale(lp: TwoStage) -> float:
    """The program's objective normalisation: the largest cost magnitude
    of either stage, at least 1."""
    return float(max(1.0, np.abs(lp.c).max(initial=0.0),
                     np.abs(lp.q).max(initial=0.0)))


def ruiz(lp: TwoStage, iters: int = 10):
    """Row and column scalings (dr, dc) of the flipped recourse matrix
    (rows of sense "L" negated): ``iters`` passes that divide each row,
    then each column, by the square root of its largest magnitude."""
    flip = np.where(np.asarray(lp.senses2) == "L", -1.0, 1.0)
    K = flip[:, None] * lp.W
    dr, dc = np.ones(K.shape[0]), np.ones(K.shape[1])
    for _ in range(iters):
        r = np.sqrt(np.abs(K).max(1))
        r = np.where(r > 0, r, 1.0)
        K = K / r[:, None]
        c = np.sqrt(np.abs(K).max(0))
        c = np.where(c > 0, c, 1.0)
        K = K / c[None, :]
        dr, dc = dr / r, dc / c
    return dr, dc


def kkt_errors(lp: TwoStage, H: np.ndarray, Y: np.ndarray,
               Pi: np.ndarray, values=None) -> np.ndarray:
    """Per row of H, the relative KKT error of (y, pi) for the recourse
    LP with right-hand side h, in float64: the largest of the primal
    residual, the dual residual and the duality gap, each relative, taken
    on the equilibrated LP with the objective q / ``objective_scale``
    (Pi in that objective's units; every y in [0, inf)). With ``values``
    (in the original objective's units) the gap takes them for the
    primal objective q y: a value that is not its y's objective then
    reads as a gap."""
    H, Y, Pi = (np.asarray(a, np.float64) for a in (H, Y, Pi))
    s = np.asarray(lp.senses2)
    flip = np.where(s == "L", -1.0, 1.0)
    eq = s == "E"
    dr, dc = ruiz(lp)
    q = lp.q / objective_scale(lp)
    ht = H * (flip * dr)[None, :]
    slack = (H - Y @ lp.W.T) * (flip * dr)[None, :]
    pviol = np.where(eq[None, :], np.abs(slack), np.maximum(slack, 0.0))
    pres = np.linalg.norm(pviol, axis=1) / (1.0 + np.linalg.norm(ht, axis=1))
    g = (q[None, :] - Pi @ lp.W) * dc[None, :]
    dres = np.linalg.norm(np.maximum(-g, 0.0), axis=1) / (
        1.0 + np.linalg.norm(q * dc))
    pobj = Y @ q if values is None \
        else np.asarray(values, np.float64) / objective_scale(lp)
    dobj = np.sum(Pi * H, axis=1)
    gap = np.abs(pobj - dobj) / (1.0 + np.abs(pobj) + np.abs(dobj))
    return np.maximum(np.maximum(pres, dres), gap)


def first_stage_point(lp: TwoStage) -> np.ndarray:
    """The point of the first-stage polytope {A1 x (senses1) b1, x >= 0}
    nearest 0 in the 1-norm (x >= 0, so: least sum of x), from HiGHS."""
    from scipy.optimize import linprog

    s = np.asarray(lp.senses1)
    le, ge, eq = s == "L", s == "G", s == "E"
    res = linprog(np.ones(lp.c.shape[0]),
                  A_ub=np.concatenate([lp.A1[le], -lp.A1[ge]]),
                  b_ub=np.concatenate([lp.b1[le], -lp.b1[ge]]),
                  A_eq=lp.A1[eq] if eq.any() else None,
                  b_eq=lp.b1[eq] if eq.any() else None,
                  bounds=(0, None), method="highs")
    if res.status != 0:
        raise RuntimeError(f"first stage of {lp.name}: {res.message}")
    return res.x
