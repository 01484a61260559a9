"""Extensive-form (deterministic equivalent) solver: the crash start and
the certification EF.

Port of record: ``sqlp_tpu/models/crash.py`` (``solve_extensive_form``
:50-401, ``crash_x0`` :456-468). The deterministic equivalent over a
fixed scenario panel

    min  c@x + sum_s p_s q_s@y_s
    s.t. A1 x {senses1} b1
         T_s x + W y_s {senses2} r + dr_s      for each scenario s
         lb1 <= x <= ub1,  lb2 <= y_s <= ub2

is solved by a structured restarted PDHG: the constraint operator is
applied blockwise ([S, n2] panels against the shared W and T), so the
[S*m2, n1+S*n2] matrix never materializes. The products are plain
``torch.matmul`` (FP32 SGEMM / FP64 DGEMM; ``configure_torch`` keeps TF32
off, as the reference pins ``Precision.HIGHEST``).

The port takes an optional leading replication axis: ``deltas`` [R, S, Rv]
solves R extensive forms over one shared probability vector in one call,
the counterpart of the reference's ``jax.vmap`` inside
``sd/lower_bound.py:saa_ef_bound``. A replication that has converged
keeps its carry while the others go on, as a vmapped ``while_loop``
keeps it, so a batched solve equals R single solves. The ``while_loop``
becomes a Python loop with one host read per restart round.
``solve_extensive_form_chunked`` (:404-453) is not ported: it splits a
solve for a TPU worker's program-length limit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sqlp_tpu_torch.config import PDHGConfig
from sqlp_tpu_torch.models.scenario import sample_deltas
from sqlp_tpu_torch.models.stage import SENSE_E, SENSE_L

_BIG = 1e30


def _absmax(M: torch.Tensor, dim: int) -> torch.Tensor:
    """max |M| along ``dim``, 0 where that dimension is empty (the
    reference's ``jnp.max(..., initial=0.0)``: lands-like instances with
    no first-stage rows have an [0, n1] A1)."""
    if M.shape[dim] == 0:
        shape = list(M.shape)
        del shape[dim]
        return M.new_zeros(shape)
    return M.abs().amax(dim)


def _ruiz_scale(v: torch.Tensor) -> torch.Tensor:
    s = torch.sqrt(torch.clamp(v, min=1e-30))
    return torch.where(s > 1e-12, s, torch.ones_like(s))


def _flip(senses: torch.Tensor, dtype) -> torch.Tensor:
    return torch.where(senses == SENSE_L, -1.0, 1.0).to(dtype)


def _sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the leading replication axis."""
    return t.flatten(1).sum(1)


def _bc(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-replication [R] vector shaped to broadcast against ``like``."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _rows(t, idx):
    """Replications ``idx`` of a per-replication tensor (None and tensors
    shared by every replication, leading axis 1, pass through)."""
    if idx is None or t is None or t.shape[0] == 1:
        return t
    return t.index_select(0, idx)


def solve_extensive_form(arrays, model, deltas: torch.Tensor,
                         probs: torch.Tensor,
                         config: PDHGConfig = PDHGConfig(),
                         return_duals: bool = False,
                         x0: Optional[torch.Tensor] = None,
                         Y0: Optional[torch.Tensor] = None,
                         U0: Optional[torch.Tensor] = None,
                         u00: Optional[torch.Tensor] = None,
                         omega0: Optional[torch.Tensor] = None):
    """Solve the extensive form over a fixed scenario panel.

    Args:
      arrays, model: the compiled instance blocks and scenario model; the
        solve runs in ``arrays.c``'s dtype on its device.
      deltas: [S, Rv] raw scenario deltas (value - template), or
        [R, S, Rv] for R extensive forms in one call.
      probs: [S] scenario probabilities (sum to 1), shared by every
        replication.
      config: PDHG parameters (``tol``, ``max_iters``, ``restart_every``).
      x0/Y0/U0/u00: optional warm starts in ORIGINAL units, shaped like the
        outputs (a leading R axis when ``deltas`` has one); ``omega0`` the
        starting primal weight.
      return_duals: also return the best iterate's per-scenario EF duals
        [S, m2], second-stage blocks [S, n2] and stage-1 row duals [m1],
        unscaled to the original rows, columns and objective (duals in
        the d(obj)/d(rhs) convention).

    Returns (x, objective, stats[, duals, Y, u0]), each with the leading R
    axis when ``deltas`` has one; ``stats`` holds tensors ``ef_iters``,
    ``ef_err``, ``ef_err0``, ``ef_omega`` and ``ef_converged``.
    """
    batched = deltas.dim() == 3
    if not batched:
        deltas = deltas[None]
        x0, Y0, U0, u00 = (None if w is None else w[None]
                           for w in (x0, Y0, U0, u00))
    dt = arrays.c.dtype
    dev = arrays.c.device
    deltas = deltas.to(dt)
    R, S = int(deltas.shape[0]), int(deltas.shape[1])
    m1, n1 = arrays.A1.shape
    m2, n2 = arrays.W.shape
    rv_row = model.rv_row.long()
    rv_col = model.rv_col.long()

    # objective normalization (conditioning)
    one = torch.ones((), dtype=dt, device=dev)
    obj_s = torch.maximum(one, torch.maximum(_absmax(arrays.c, 0),
                                             _absmax(arrays.q, 0)))
    c = arrays.c / obj_s
    q = arrays.q / obj_s

    # joint Ruiz equilibration of the structured operator [[A1, 0], [T, W]]
    A1, T, W = arrays.A1, arrays.T, arrays.W
    r1 = torch.ones(m1, dtype=dt, device=dev)
    r2 = torch.ones(m2, dtype=dt, device=dev)
    cx = torch.ones(n1, dtype=dt, device=dev)
    cy = torch.ones(n2, dtype=dt, device=dev)
    for _ in range(8):
        s1 = _ruiz_scale(_absmax(A1, 1))
        s2 = _ruiz_scale(torch.maximum(_absmax(T, 1), _absmax(W, 1)))
        A1 = A1 / s1[:, None]
        T = T / s2[:, None]
        W = W / s2[:, None]
        gx = _ruiz_scale(torch.maximum(_absmax(A1, 0), _absmax(T, 0)))
        gy = _ruiz_scale(_absmax(W, 0))
        A1 = A1 / gx[None, :]
        T = T / gx[None, :]
        W = W / gy[None, :]
        r1, r2, cx, cy = r1 / s1, r2 / s2, cx / gx, cy / gy
    c = c * cx
    q = q * cy
    b1 = arrays.b1 * r1
    r = arrays.r * r2
    lb1, ub1 = arrays.lb1 / cx, arrays.ub1 / cx
    lb2, ub2 = arrays.lb2 / cy, arrays.ub2 / cy

    f1 = _flip(arrays.senses1, dt)
    f2 = _flip(arrays.senses2, dt)
    A1f = f1[:, None] * A1
    Wf = f2[:, None] * W
    eq1 = arrays.senses1 == SENSE_E
    eq2 = arrays.senses2 == SENSE_E

    # sqrt(p_s) symmetric block scaling (crash.py:140-152): y~_s =
    # sqrt(p_s) y_s with scenario rows scaled by sqrt(p_s) keeps W shared
    # and makes the per-step progress independent of S
    spc = torch.sqrt(probs.to(device=dev, dtype=dt))[:, None]       # [S, 1]
    # rows are sense-flipped and sqrt(p_s)-scaled together (f2 is +-1,
    # so one product rounds as the reference's two)
    f2spc = f2[None, :] * spc                                       # [S, m2]

    # per-scenario flipped rhs; index_add_ sums repeated rv_row entries as
    # the reference's .at[].add does
    rhs_delta = torch.where(model.rv_is_rhs, deltas, 0.0) * r2[rv_row]
    r_s = r.expand(R, S, m2).clone().index_add_(-1, rv_row, rhs_delta)
    h2 = r_s * f2spc                                                # [R,S,m2]
    b1f = b1 * f1

    # per-scenario transfer deltas (columns of T): all-zero when the
    # randomness is RHS or cost only, and then left out
    not_tr = model.rv_is_rhs | model.rv_is_cost
    trd = None
    if bool((~not_tr).any()):
        trd = torch.where(not_tr, 0.0, deltas) * (r2[rv_row] * cx[rv_col])

    def T_apply(x, trd):
        """[R', S, m2] = sqrt(p_s) (Tf + dTf_s) x per scenario."""
        base = (x @ T.T)[:, None, :]
        if trd is None:
            return base * f2spc
        out = base.expand(-1, S, m2).clone()
        out.index_add_(-1, rv_row, trd * x[:, rv_col][:, None, :])
        return out * f2spc

    def Tt_apply(U, trd):
        """[R', n1] = sum_s sqrt(p_s) (Tf + dTf_s)' U_s."""
        Uf = U * f2spc
        out = Uf.sum(1) @ T
        if trd is not None:
            out.index_add_(-1, rv_col, (trd * Uf[:, :, rv_row]).sum(1))
        return out

    def K_apply(x, Y, trd):
        kY = torch.matmul(Y, Wf.T)
        kY += T_apply(x, trd)
        return x @ A1f.T, kY

    def Kt_apply(u0, U, trd):
        return u0 @ A1f + Tt_apply(U, trd), torch.matmul(U, Wf)

    # spectral norm of the structured operator by power iteration, per
    # replication (transfer deltas make the operators differ)
    xv = torch.cos(torch.arange(n1, dtype=dt, device=dev) * 0.7 + 0.3)
    Yv = torch.cos(torch.arange(S * n2, dtype=dt, device=dev) * 0.3
                   + 0.1).reshape(S, n2)
    xv = xv.expand(R, n1)
    Yv = Yv.expand(R, S, n2)
    for _ in range(48):
        u0v, Uv = K_apply(xv, Yv, trd)
        xv, Yv = Kt_apply(u0v, Uv, trd)
        nrm = torch.clamp(torch.sqrt(_sum(xv * xv) + _sum(Yv * Yv)),
                          min=1e-30)
        xv = xv / _bc(nrm, xv)
        Yv = Yv / _bc(nrm, Yv)
    u0v, Uv = K_apply(xv, Yv, trd)
    Kx, KY = Kt_apply(u0v, Uv, trd)
    norm = torch.sqrt(torch.sqrt(_sum(Kx ** 2) + _sum(KY ** 2)))
    eta = 0.9 / torch.clamp(norm, min=1e-30)                         # [R]

    lb1c = torch.where(torch.isfinite(lb1), lb1, -_BIG)
    ub1c = torch.where(torch.isfinite(ub1), ub1, _BIG)
    lb2Y = torch.where(torch.isfinite(lb2), lb2, -_BIG)[None, :] * spc
    ub2Y = torch.where(torch.isfinite(ub2), ub2, _BIG)[None, :] * spc

    # per-scenario objective: random cost deltas patch q_s (normalized
    # and column-equilibrated as q was); p_s q_s in y-units is
    # sqrt(p_s) q_s in y~-units
    if model.has_cost:
        cost_delta = torch.where(model.rv_is_cost, deltas, 0.0) * (
            cy[model.rv_ycol.long()] / obj_s)
        q_s = q.expand(R, S, n2).clone().index_add_(
            -1, model.rv_ycol.long(), cost_delta)
        qS = spc * q_s                                               # [R,S,n2]
    else:
        qS = (spc * q[None, :])[None]                                # [1,S,n2]

    # PDLP primal-weight initialization (||objective|| / ||rhs||)
    qn = torch.sqrt(torch.sum(c ** 2) + _sum(qS ** 2))
    hn = torch.sqrt(torch.sum(b1f ** 2) + _sum(h2 ** 2))
    omega_init = torch.where((qn > 1e-30) & (hn > 1e-30),
                             qn / torch.clamp(hn, min=1e-30),
                             torch.ones_like(hn))                    # [R]

    # residual constants: directions without a finite bound carry the
    # dual infeasibility; finite bounds enter the dual objective
    ub1_inf, lb1_inf = ~torch.isfinite(ub1), ~torch.isfinite(lb1)
    ub2_inf, lb2_inf = ~torch.isfinite(ub2), ~torch.isfinite(lb2)
    lb1_0 = torch.where(lb1_inf, 0.0, lb1)
    ub1_0 = torch.where(ub1_inf, 0.0, ub1)
    lb2S = torch.where(lb2_inf, 0.0, lb2)[None, :] * spc
    ub2S = torch.where(ub2_inf, 0.0, ub2)[None, :] * spc
    pscale, qscale = 1.0 + hn, 1.0 + qn

    def proj_dual(u0, U):
        return (torch.where(eq1, u0, torch.clamp(u0, min=0.0)),
                torch.where(eq2, U, torch.clamp(U, min=0.0)))

    def residual(x, Y, u0, U, P):
        h2, trd, qS, pscale, qscale = P
        kx, kY = K_apply(x, Y, trd)
        rx = b1f - kx
        rY = h2 - kY
        p1 = torch.where(eq1, rx.abs(), torch.clamp(rx, min=0.0))
        p2 = torch.where(eq2, rY.abs(), torch.clamp(rY, min=0.0))
        pres = torch.sqrt(_sum(p1 ** 2) + _sum(p2 ** 2)) / pscale
        gx, gY = Kt_apply(u0, U, trd)
        gx = c - gx
        gY = qS - gY
        gxp, gxn = torch.clamp(gx, min=0.0), torch.clamp(-gx, min=0.0)
        gYp, gYn = torch.clamp(gY, min=0.0), torch.clamp(-gY, min=0.0)
        dv_x = torch.where(ub1_inf, gxn, 0.0) + torch.where(lb1_inf, gxp, 0.0)
        dv_Y = torch.where(ub2_inf, gYn, 0.0) + torch.where(lb2_inf, gYp, 0.0)
        dres = torch.sqrt(_sum(dv_x ** 2) + _sum(dv_Y ** 2)) / qscale
        pobj = x @ c + _sum(qS * Y)
        dobj = (_sum(u0 * b1f) + _sum(U * h2) + _sum(gxp * lb1_0)
                - _sum(gxn * ub1_0) + _sum(gYp * lb2S) - _sum(gYn * ub2S))
        gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
        return torch.maximum(torch.maximum(pres, dres), gap)

    def pd_round(x, Y, u0, U, omega, eta, P):
        """restart_every PDHG steps; returns the last iterate and the
        round's average."""
        h2, trd, qS = P[:3]
        tau = eta / omega
        sig = eta * omega
        tx, tY = _bc(tau, x), _bc(tau, Y)
        su, sU = _bc(sig, u0), _bc(sig, U)
        xs, Ys = torch.zeros_like(x), torch.zeros_like(Y)
        us, Us = torch.zeros_like(u0), torch.zeros_like(U)
        for _ in range(config.restart_every):
            gx, gY = Kt_apply(u0, U, trd)
            x1 = torch.clamp(x - tx * (c - gx), lb1c, ub1c)
            gY = torch.sub(qS, gY, out=gY)
            Y1 = torch.sub(Y, gY.mul_(tY)).clamp_(lb2Y, ub2Y)
            kx, kY = K_apply(2.0 * x1 - x, torch.add(Y1, Y1).sub_(Y), trd)
            kY = torch.sub(h2, kY, out=kY)
            u01, U1 = proj_dual(u0 + su * (b1f - kx), U + kY.mul_(sU))
            xs += x1
            Ys += Y1
            us += u01
            Us += U1
            x, Y, u0, U = x1, Y1, u01, U1
        n = float(config.restart_every)
        return (x, Y, u0, U), (xs / n, Ys / n, us / n, Us / n)

    def round_step(C, eta, omega_init, P):
        x, Y, u0, U = C["x"], C["Y"], C["u0"], C["U"]
        (x1, Y1, u01, U1), (xa, Ya, ua, Ua) = pd_round(
            x, Y, u0, U, C["omega"], eta, P)
        ec = residual(x1, Y1, u01, U1, P)
        ea = residual(xa, Ya, ua, Ua, P)
        use_avg = ea < ec

        def pick(mask, a, b):
            return torch.where(_bc(mask, a), a, b)
        xc, Yc = pick(use_avg, xa, x1), pick(use_avg, Ya, Y1)
        uc, Uc = pick(use_avg, ua, u01), pick(use_avg, Ua, U1)
        err = torch.minimum(ea, ec)
        better = err < C["err_best"]
        out = {"xb": pick(better, xc, C["xb"]),
               "Yb": pick(better, Yc, C["Yb"]),
               "Ub": pick(better, Uc, C["Ub"]),
               "ub0": pick(better, uc, C["ub0"]),
               "err_best": torch.minimum(err, C["err_best"])}
        err_r = C["err_r"]
        restart = (err <= 0.2 * err_r) | ((err <= 0.8 * err_r)
                                          & (err > C["err_last"]))
        dprim = torch.sqrt(_sum((xc - x) ** 2) + _sum((Yc - Y) ** 2))
        ddual = torch.sqrt(_sum((uc - u0) ** 2) + _sum((Uc - U) ** 2))
        omega = C["omega"]
        omega_new = torch.where(
            (dprim > 1e-12) & (ddual > 1e-12),
            torch.clamp(torch.exp(0.5 * torch.log(ddual / dprim)
                                  + 0.5 * torch.log(omega)),
                        omega_init * 1e-4, omega_init * 1e4),
            omega)
        out.update(x=pick(restart, xc, x1), Y=pick(restart, Yc, Y1),
                   u0=pick(restart, uc, u01), U=pick(restart, Uc, U1),
                   omega=torch.where(restart, omega_new, omega),
                   err_r=torch.where(restart, err, err_r), err_last=err)
        return out

    # warm starts in original units -> scaled space
    if x0 is None:
        xi = torch.clamp(torch.zeros(R, n1, dtype=dt, device=dev), lb1c, ub1c)
    else:
        xi = torch.clamp(x0.to(dev, dt) / cx, lb1c, ub1c)
    if Y0 is None:
        Yi = torch.clamp(torch.zeros(R, S, n2, dtype=dt, device=dev),
                         lb2Y, ub2Y)
    else:
        Yi = torch.clamp(Y0.to(dev, dt) / cy[None, :] * spc, lb2Y, ub2Y)
    if U0 is None:
        Ui = torch.zeros(R, S, m2, dtype=dt, device=dev)
    else:
        # inverts the dual unscaling below (duals = Ub * r2 f2 sp obj_s)
        Ui = proj_dual(torch.zeros(m1, dtype=dt, device=dev),
                       U0.to(dev, dt) * f2[None, :]
                       / (r2[None, :] * obj_s * spc))[1]
    if u00 is None:
        u0i = torch.zeros(R, m1, dtype=dt, device=dev)
    else:
        u0i = proj_dual(u00.to(dev, dt) * f1 / (r1 * obj_s), Ui)[0]
    # the adaptation clip stays anchored at the norm-based omega_init
    omega_start = (omega_init if omega0 is None
                   else omega0.to(dev, dt).reshape(R).clone())
    P = (h2, trd, qS, pscale, qscale)
    err0 = residual(xi, Yi, u0i, Ui, P)
    # best-iterate tracking starts at the initial point
    C = {"x": xi, "Y": Yi, "u0": u0i, "U": Ui, "xb": xi, "Yb": Yi,
         "Ub": Ui, "ub0": u0i, "omega": omega_start, "err_r": err0,
         "err_last": err0, "err_best": err0}

    n_rounds = max(1, config.max_iters // config.restart_every)
    rounds = np.zeros(R, np.int64)
    while True:
        live = (rounds < n_rounds) & (C["err_best"].cpu().numpy()
                                      > config.tol)
        if not live.any():
            break
        if live.all():
            C = round_step(C, eta, omega_init, P)
        else:
            # finished replications keep their carry, as under a vmapped
            # while_loop: the round runs on the others alone
            idx = torch.as_tensor(np.flatnonzero(live), device=dev)
            sub = round_step({k: _rows(v, idx) for k, v in C.items()},
                             eta[idx], omega_init[idx],
                             tuple(_rows(p, idx) for p in P))
            C = {k: v.index_copy(0, idx, sub[k]) for k, v in C.items()}
        rounds += live

    xb, Yb, Ub, ub0 = C["xb"], C["Yb"], C["Ub"], C["ub0"]
    obj = (xb @ c + _sum(qS * Yb)) * obj_s
    err_best = C["err_best"]
    stats = {"ef_iters": torch.as_tensor(rounds * config.restart_every,
                                         device=dev),
             "ef_err": err_best, "ef_err0": err0, "ef_omega": C["omega"],
             "ef_converged": err_best <= config.tol}
    out = [cx * xb, obj, stats]
    if return_duals:
        # scenario-row duals back to the original rows and objective (row
        # scale, sense flip, sqrt(p_s) block scale, 1/obj_s); the y blocks
        # undo the column and sqrt(p_s) scaling
        out += [Ub * (r2 * f2)[None, :] * obj_s * spc,
                cy[None, :] * Yb / spc,
                ub0 * (r1 * f1) * obj_s]
    if not batched:
        out = [o[0] if torch.is_tensor(o) else
               {k: v[0] for k, v in o.items()} for o in out]
    return tuple(out)


def crash_x0(inst, n_scenarios: int = 10, seed: int = 0,
             config: Optional[PDHGConfig] = None):
    """Sampled-extensive-form starting point (the reference driver's crash
    pattern: sample scenarios, solve the EF, take x). The scenarios come
    from a ``torch.Generator`` on the instance's device seeded ``seed``.
    Returns (x, objective, stats)."""
    config = config or PDHGConfig(tol=1e-6, max_iters=40_000)
    gen = torch.Generator(device=inst.device)
    gen.manual_seed(seed)
    deltas = sample_deltas(gen, inst.scenario_model, n_scenarios)
    probs = torch.full((n_scenarios,), 1.0 / n_scenarios,
                       dtype=inst.arrays.c.dtype, device=inst.device)
    return solve_extensive_form(inst.arrays, inst.scenario_model, deltas,
                                probs, config)
