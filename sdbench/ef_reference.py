"""The plain reference of the certification EF: the extensive form of a
two-stage LP over R replications of S scenarios each, solved by the
structured restarted PDHG that the program's certification runs
(restarted every ``restart`` steps to the better of the last iterate and
the round's average, primal weight adapted at restarts, best iterate
kept), written from that algorithm's description in plain torch and
computed in float64 by default.

    min  c x + sum_s p_s q y_s
    s.t. A1 x (senses1) b1;  T x + W y_s (senses2) r + d_s;  x, y_s >= 0

A PDHG trajectory has no closed form, so the reference follows the
program round by round from the same start, doing again everything the
program derives: the objective's normalisation, the joint Ruiz
equilibration (8 passes), the sense flips and the sqrt(p_s) block
scaling, the operator norm by 48 steps of power iteration from a fixed
start, the primal weight's start, and each round's residuals and
decisions. ``tf32=True`` rounds every matrix product's operands to TF32
first (the control: the reference one precision below float32).

Only what ssn and storm need: random right-hand sides, x and y in
[0, inf).
"""

from __future__ import annotations

import torch

from sdbench.reference import tf32_round
from sdbench.smps import Discrete, TwoStage

_BIG = 1e30


def _rs(v: torch.Tensor) -> torch.Tensor:
    s = torch.sqrt(torch.clamp(v, min=1e-30))
    return torch.where(s > 1e-12, s, torch.ones_like(s))


def _amax(M: torch.Tensor, dim: int) -> torch.Tensor:
    if M.shape[dim] == 0:
        return M.new_zeros(M.shape[1 - dim])
    return M.abs().amax(dim)


def _sum(t: torch.Tensor) -> torch.Tensor:
    return t.flatten(1).sum(1)


def _bc(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


class EF:
    """The extensive forms of one panel of deltas [R, S, Rv] (float64
    outcome minus base), on ``device`` in ``dtype``."""

    def __init__(self, lp: TwoStage, disc: Discrete, deltas: torch.Tensor,
                 dtype=torch.float64, tf32: bool = False):
        dev = deltas.device
        self.dt, self.dev, self.tf32 = dtype, dev, tf32

        def T_(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)
        R, S = int(deltas.shape[0]), int(deltas.shape[1])
        self.R, self.S = R, S
        c, q = T_(lp.c), T_(lp.q)
        A1, T, W = T_(lp.A1), T_(lp.T), T_(lp.W)
        m1, n1 = A1.shape
        m2, n2 = W.shape
        obj_s = torch.maximum(torch.ones((), dtype=dtype, device=dev),
                              torch.maximum(_amax(c, 0), _amax(q, 0)))
        c, q = c / obj_s, q / obj_s
        r1 = torch.ones(m1, dtype=dtype, device=dev)
        r2 = torch.ones(m2, dtype=dtype, device=dev)
        cx = torch.ones(n1, dtype=dtype, device=dev)
        cy = torch.ones(n2, dtype=dtype, device=dev)
        for _ in range(8):
            s1 = _rs(_amax(A1, 1))
            s2 = _rs(torch.maximum(_amax(T, 1), _amax(W, 1)))
            A1, T, W = A1 / s1[:, None], T / s2[:, None], W / s2[:, None]
            gx = _rs(torch.maximum(_amax(A1, 0), _amax(T, 0)))
            gy = _rs(_amax(W, 0))
            A1, T, W = A1 / gx[None, :], T / gx[None, :], W / gy[None, :]
            r1, r2, cx, cy = r1 / s1, r2 / s2, cx / gx, cy / gy
        self.c, self.q = c * cx, q * cy
        f1 = torch.as_tensor([-1.0 if s == "L" else 1.0 for s in lp.senses1],
                             dtype=dtype, device=dev)
        f2 = torch.as_tensor([-1.0 if s == "L" else 1.0 for s in lp.senses2],
                             dtype=dtype, device=dev)
        self.eq1 = torch.as_tensor([s == "E" for s in lp.senses1], device=dev)
        self.eq2 = torch.as_tensor([s == "E" for s in lp.senses2], device=dev)
        self.A1f, self.Wf, self.T = f1[:, None] * A1, f2[:, None] * W, T
        probs = torch.full((S,), 1.0 / S, dtype=dtype, device=dev)
        self.spc = torch.sqrt(probs)[:, None]
        self.f2spc = f2[None, :] * self.spc
        rows = torch.as_tensor(disc.row_index, device=dev)
        r_s = (T_(lp.r) * r2).expand(R, S, m2).clone()
        r_s.index_add_(-1, rows, deltas.to(dtype) * r2[rows])
        self.h2 = r_s * self.f2spc
        self.b1f = T_(lp.b1) * r1 * f1
        self.qS = (self.spc * self.q[None, :])[None]
        self.ub2Y = torch.full((n2,), _BIG, dtype=dtype,
                               device=dev)[None, :] * self.spc
        self.r1, self.r2, self.cx, self.cy = r1, r2, cx, cy
        self.f1, self.f2, self.obj_s = f1, f2, obj_s
        self.n1, self.m1 = n1, m1

        # operator norm per replication, power iteration from a fixed start
        xv = torch.cos(torch.arange(n1, dtype=dtype, device=dev) * 0.7 + 0.3)
        Yv = torch.cos(torch.arange(S * n2, dtype=dtype, device=dev) * 0.3
                       + 0.1).reshape(S, n2)
        xv, Yv = xv.expand(R, n1), Yv.expand(R, S, n2)
        for _ in range(48):
            xv, Yv = self.Kt(*self.K(xv, Yv))
            nrm = torch.clamp(torch.sqrt(_sum(xv * xv) + _sum(Yv * Yv)),
                              min=1e-30)
            xv, Yv = xv / _bc(nrm, xv), Yv / _bc(nrm, Yv)
        Kx, KY = self.Kt(*self.K(xv, Yv))
        norm = torch.sqrt(torch.sqrt(_sum(Kx ** 2) + _sum(KY ** 2)))
        self.eta = 0.9 / torch.clamp(norm, min=1e-30)
        qn = torch.sqrt(torch.sum(self.c ** 2) + _sum(self.qS ** 2))
        hn = torch.sqrt(torch.sum(self.b1f ** 2) + _sum(self.h2 ** 2))
        self.omega_init = torch.where((qn > 1e-30) & (hn > 1e-30),
                                      qn / torch.clamp(hn, min=1e-30),
                                      torch.ones_like(hn))
        self.pscale, self.qscale = 1.0 + hn, 1.0 + qn

    def _mm(self, a, b):
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def K(self, x, Y):
        kY = self._mm(Y, self.Wf.T) \
            + self._mm(x, self.T.T)[:, None, :] * self.f2spc
        return self._mm(x, self.A1f.T), kY

    def Kt(self, u0, U):
        gx = self._mm(u0, self.A1f) + self._mm((U * self.f2spc).sum(1),
                                              self.T)
        return gx, self._mm(U, self.Wf)

    def proj(self, u0, U):
        return (torch.where(self.eq1, u0, torch.clamp(u0, min=0.0)),
                torch.where(self.eq2, U, torch.clamp(U, min=0.0)))

    def residual(self, x, Y, u0, U, pobj=None):
        kx, kY = self.K(x, Y)
        rx, rY = self.b1f - kx, self.h2 - kY
        p1 = torch.where(self.eq1, rx.abs(), torch.clamp(rx, min=0.0))
        p2 = torch.where(self.eq2, rY.abs(), torch.clamp(rY, min=0.0))
        pres = torch.sqrt(_sum(p1 ** 2) + _sum(p2 ** 2)) / self.pscale
        gx, gY = self.Kt(u0, U)
        gx, gY = self.c - gx, self.qS - gY
        # every variable lies in [0, inf): the negative reduced costs are
        # the dual infeasibility, and the bounds add nothing to the dual
        # objective
        gxn, gYn = torch.clamp(-gx, min=0.0), torch.clamp(-gY, min=0.0)
        dres = torch.sqrt(_sum(gxn ** 2) + _sum(gYn ** 2)) / self.qscale
        if pobj is None:
            pobj = x @ self.c + _sum(self.qS * Y)
        dobj = _sum(u0 * self.b1f) + _sum(U * self.h2)
        gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
        return torch.maximum(torch.maximum(pres, dres), gap)

    def _round(self, x, Y, u0, U, omega, restart):
        tau, sig = self.eta / omega, self.eta * omega
        tx, tY, su, sU = _bc(tau, x), _bc(tau, Y), _bc(sig, u0), _bc(sig, U)
        sums = [torch.zeros_like(v) for v in (x, Y, u0, U)]
        for _ in range(restart):
            gx, gY = self.Kt(u0, U)
            x1 = torch.clamp(x - tx * (self.c - gx), min=0.0, max=_BIG)
            Y1 = torch.minimum(torch.clamp(Y - tY * (self.qS - gY), min=0.0),
                               self.ub2Y)
            kx, kY = self.K(2.0 * x1 - x, 2.0 * Y1 - Y)
            u01, U1 = self.proj(u0 + su * (self.b1f - kx),
                                U + sU * (self.h2 - kY))
            for s, v in zip(sums, (x1, Y1, u01, U1)):
                s += v
            x, Y, u0, U = x1, Y1, u01, U1
        return (x, Y, u0, U), tuple(s / float(restart) for s in sums)

    def scaled(self, point=None):
        """(x, Y, u0, U) in this EF's scaled units: zero, or ``point`` =
        (x, Y, U, u0) in original units, projected onto the bounds."""
        R, dt, dev = self.R, self.dt, self.dev
        if point is None:
            x = torch.zeros(R, self.n1, dtype=dt, device=dev)
            Y = torch.zeros_like(self.h2[..., :1].expand(
                -1, -1, self.qS.shape[-1]))
            return (x, Y, torch.zeros(R, self.m1, dtype=dt, device=dev),
                    torch.zeros_like(self.h2))
        x0, Y0, U0, u00 = (torch.as_tensor(v).to(dev, dt) for v in point)
        x = torch.clamp(x0 / self.cx, min=0.0, max=_BIG)
        Y = torch.minimum(torch.clamp(Y0 / self.cy[None, :] * self.spc,
                                      min=0.0), self.ub2Y)
        U = self.proj(torch.zeros(self.m1, dtype=dt, device=dev),
                      U0 * self.f2[None, :]
                      / (self.r2[None, :] * self.obj_s * self.spc))[1]
        u0 = self.proj(u00 * self.f1 / (self.r1 * self.obj_s), U)[0]
        return x, Y, u0, U

    def error(self, point=None, objective=None) -> torch.Tensor:
        """[R] relative KKT error of zero or of ``point`` = (x, Y, U, u0)
        in original units: the program's measure, worked out here. With
        ``objective`` [R] (original units) the gap takes it for the
        primal objective: an objective that is not the point's reads as
        a gap."""
        pobj = None if objective is None else \
            torch.as_tensor(objective).to(self.dev, self.dt) / self.obj_s
        return self.residual(*self.scaled(point), pobj=pobj)

    def solve(self, rounds: int, restart: int = 80, tol: float = 0.0,
              start=None):
        """Up to ``rounds`` rounds (a replication stops once its best
        error is at most ``tol``) from zero, or from ``start`` = (x, Y,
        U, u0, omega) in original units; returns (x [R, n1], objective
        [R], rounds run [R], error [R])."""
        R, dt, dev = self.R, self.dt, self.dev
        if start is None:
            x, Y, u0, U = self.scaled(None)
            omega = self.omega_init.clone()
        else:
            x, Y, u0, U = self.scaled(start[:4])
            omega = torch.as_tensor(start[4]).to(dev, dt).reshape(R).clone()
        err = self.residual(x, Y, u0, U)
        C = {"x": x, "Y": Y, "u0": u0, "U": U, "xb": x, "Yb": Y,
             "ub0": u0, "Ub": U, "omega": omega, "err_r": err,
             "err_last": err, "err_best": err}
        done = torch.zeros(R, dtype=torch.long)
        for _ in range(rounds):
            live = (C["err_best"] > tol).cpu()
            if not bool(live.any()):
                break
            idx = torch.nonzero(live)[:, 0].to(dev)
            sub = self._step({k: v.index_select(0, idx) for k, v in C.items()},
                             idx, restart)
            C = {k: v.index_copy(0, idx, sub[k]) for k, v in C.items()}
            done += live.long()
        obj = (C["xb"] @ self.c + _sum(self.qS * C["Yb"])) * self.obj_s
        return self.cx * C["xb"], obj, done, C["err_best"]

    def _step(self, C, idx, restart):
        """One round of the replications ``idx``; the per-replication
        constants are taken at ``idx``."""
        keep = (self.eta, self.omega_init, self.h2, self.pscale)
        self.eta, self.omega_init = self.eta[idx], self.omega_init[idx]
        self.h2, self.pscale = self.h2[idx], self.pscale[idx]
        try:
            x, Y, u0, U = C["x"], C["Y"], C["u0"], C["U"]
            (x1, Y1, u01, U1), (xa, Ya, ua, Ua) = self._round(
                x, Y, u0, U, C["omega"], restart)
            ec = self.residual(x1, Y1, u01, U1)
            ea = self.residual(xa, Ya, ua, Ua)
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
            restart_now = (err <= 0.2 * err_r) | ((err <= 0.8 * err_r)
                                                  & (err > C["err_last"]))
            dprim = torch.sqrt(_sum((xc - x) ** 2) + _sum((Yc - Y) ** 2))
            ddual = torch.sqrt(_sum((uc - u0) ** 2) + _sum((Uc - U) ** 2))
            omega = C["omega"]
            omega_new = torch.where(
                (dprim > 1e-12) & (ddual > 1e-12),
                torch.clamp(torch.exp(0.5 * torch.log(ddual / dprim)
                                      + 0.5 * torch.log(omega)),
                            self.omega_init * 1e-4, self.omega_init * 1e4),
                omega)
            out.update(x=pick(restart_now, xc, x1),
                       Y=pick(restart_now, Yc, Y1),
                       u0=pick(restart_now, uc, u01),
                       U=pick(restart_now, Uc, U1),
                       omega=torch.where(restart_now, omega_new, omega),
                       err_r=torch.where(restart_now, err, err_r),
                       err_last=err)
            return out
        finally:
            self.eta, self.omega_init, self.h2, self.pscale = keep
