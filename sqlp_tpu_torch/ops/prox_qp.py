"""Proximal master QP solver (OSQP-style ADMM) on tensors.

Port of record: ``sqlp_tpu/ops/prox_qp.py:solve_qp`` (:84-571). Solves

    min 1/2 z' diag(p) z + g' z   s.t.  l <= A z <= u

with Ruiz and cost scaling, adaptive rho, windowed stall detection with
forced rho restarts and the hard cap, the cold warm-retry, best-iterate
tracking, the active-set polish and the primal / dual repair passes. The
check interval of ``check_every`` ADMM steps is the CUDA kernel
``admm_round`` on the card and its plain version on the CPU
(ops/cuda/admm_kernel.py); the ``while_loop`` becomes a Python loop with
one host read per check interval.

The solve always runs in float64, on every device, as the JAX package
does wherever f64 is native (``prox_qp.py:121-128`` with x64 on); inputs
and outputs stay in the caller's dtype. The explicit-inverse z-update
replaces the TPU-only ``_pcg`` path, which existed because emulated-f64
LU faulted the TPU; CUDA has native f64 ``torch.linalg.inv``.

Dual convention: the returned ``mu`` is the OSQP dual of l <= Az <= u.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from sqlp_tpu_torch.config import QPConfig
from sqlp_tpu_torch.ops.cuda.admm_kernel import admm_round

_INF = float("inf")


def _nanmin(a: float, b: float) -> float:
    """min that propagates NaN, as jnp.minimum does."""
    return math.nan if math.isnan(a) or math.isnan(b) else min(a, b)


def _nanmax(a: float, b: float) -> float:
    """max that propagates NaN, as jnp.maximum does."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def _inv(M: torch.Tensor) -> torch.Tensor:
    """Explicit inverse; a singular matrix yields NaNs (as jnp.linalg.inv
    does) instead of raising, so the callers' finiteness guards reject
    the candidate."""
    Mi, info = torch.linalg.inv_ex(M)
    return torch.where(info != 0, torch.full_like(Mi, math.nan), Mi)


def scale_qp(p_diag, g, A, l, u):
    """OSQP-style problem scaling (``prox_qp.py:141-166``): Ruiz-equilibrate
    A and normalize the cost. Returns (As, dr, dc, cost_s, p_s, g_s, l_s,
    u_s, lc, uc); lc / uc carry finite sentinels for infinite bounds."""
    mA, nz = A.shape
    dtype, dev = A.dtype, A.device
    one = torch.ones((), dtype=dtype, device=dev)
    As = A
    dr = torch.ones(mA, dtype=dtype, device=dev)
    dc = torch.ones(nz, dtype=dtype, device=dev)
    for _ in range(10):
        rn = torch.sqrt(torch.amax(torch.abs(As), dim=1))
        rn = torch.where(rn > 0, rn, one)
        As = As / rn[:, None]
        cn = torch.sqrt(torch.amax(torch.abs(As), dim=0))
        cn = torch.where(cn > 0, cn, one)
        As = As / cn[None, :]
        dr, dc = dr / rn, dc / cn
    g_s = dc * g
    cost_s = 1.0 / torch.clamp_min(torch.amax(torch.abs(g_s)), 1.0)
    p_s = cost_s * dc * dc * p_diag
    g_s = cost_s * g_s
    l_s = dr * l
    u_s = dr * u
    lc = torch.where(torch.isfinite(l_s), l_s, torch.full_like(l_s, -1e30))
    uc = torch.where(torch.isfinite(u_s), u_s, torch.full_like(u_s, 1e30))
    return (As.contiguous(), dr, dc, cost_s, p_s, g_s.contiguous(), l_s, u_s,
            lc.contiguous(), uc.contiguous())


def _rho_vector(is_eq, rho_s: float, eq_scale: float, dtype) -> torch.Tensor:
    """Per-row ADMM penalty: equality rows get ``eq_scale`` times more."""
    mA = is_eq.shape[0]
    return torch.where(
        is_eq, torch.full((mA,), rho_s * eq_scale, dtype=dtype,
                          device=is_eq.device),
        torch.full((mA,), rho_s, dtype=dtype, device=is_eq.device))


def _factor(As, p_s, sigma: float, rho_vec):
    """(M, Minv) of the z-update at penalty rho_vec."""
    M = torch.diag(p_s + sigma) + (As.T * rho_vec[None, :]) @ As
    return M.contiguous(), _inv(M).contiguous()


def admm_operands(p_diag, g, A, l, u, is_eq, config: QPConfig = QPConfig(),
                  rho: float = 0.1):
    """The operands of ``admm_round`` for a cold start of this QP at
    penalty ``rho``, in float64: (As, M, Minv, g_s, lc, uc, rho_vec, z,
    zeta, mu) — what one check interval of :func:`solve_qp` receives."""
    f = lambda a: a.to(torch.float64)
    p_diag, g, A, l, u = map(f, (p_diag, g, A, l, u))
    As, _, _, _, p_s, g_s, _, _, lc, uc = scale_qp(p_diag, g, A, l, u)
    rho_vec = _rho_vector(is_eq, rho, config.rho_eq_scale, torch.float64)
    M, Mi = _factor(As, p_s, config.sigma, rho_vec)
    z = torch.zeros(A.shape[1], dtype=torch.float64, device=A.device)
    zeta = torch.clamp(As @ z, lc, uc).contiguous()
    return As, M, Mi, g_s, lc, uc, rho_vec, z, zeta, torch.zeros_like(zeta)


def solve_qp(p_diag: torch.Tensor, g: torch.Tensor, A: torch.Tensor,
             l: torch.Tensor, u: torch.Tensor, is_eq: torch.Tensor,
             config: QPConfig = QPConfig(),
             z0: Optional[torch.Tensor] = None,
             mu0: Optional[torch.Tensor] = None,
             rho_init=None) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Solve min 1/2 z'diag(p)z + g'z s.t. l <= Az <= u by ADMM.

    p_diag [nz], g [nz], A [mA, nz] (zero rows allowed), l, u [mA]
    (+-inf allowed), is_eq [mA] bool; z0, mu0 optional warm start;
    rho_init optional starting penalty. Returns (z, mu, stats).
    """
    mA, nz = A.shape
    out_dtype = A.dtype
    dev = A.device
    dtype = torch.float64
    f = lambda a: a.to(dtype)
    p_diag, g, A, l, u = map(f, (p_diag, g, A, l, u))
    z0 = None if z0 is None else f(z0)
    mu0 = None if mu0 is None else f(mu0)
    eff_tol = max(config.tol, 512.0 * torch.finfo(dtype).eps)
    sig = config.sigma

    As, dr, dc, cost_s, p_s, g_s, l_s, u_s, lc, uc = scale_qp(p_diag, g, A,
                                                               l, u)

    z_w = torch.zeros(nz, dtype=dtype, device=dev) if z0 is None \
        else z0 / dc
    mu_w = torch.zeros(mA, dtype=dtype, device=dev) if mu0 is None \
        else cost_s * mu0 / dr
    n_rounds = max(1, config.max_iters // config.check_every)

    def rho_vector(rho_s: float) -> torch.Tensor:
        return _rho_vector(is_eq, rho_s, config.rho_eq_scale, dtype)

    def factor(rho_s: float):
        return _factor(As, p_s, sig, rho_vector(rho_s))

    def residuals(z, zeta, mu):
        """Per-row relative primal / per-component dual residuals in the
        original problem (``prox_qp.py:208-223``)."""
        zo = dc * z
        muo = (dr / cost_s) * mu
        Az = A @ zo
        zetao = zeta / dr
        pscale = 1.0 + torch.maximum(torch.abs(Az), torch.abs(zetao))
        pres = torch.amax(torch.abs(Az - zetao) / pscale)
        grad = p_diag * zo + g
        Atmu = A.T @ muo
        dscale = 1.0 + torch.maximum(torch.abs(grad), torch.abs(Atmu))
        dres = torch.amax(torch.abs(grad + Atmu) / dscale)
        return pres, dres

    def _run(z, mu, rho_s: float):
        """Full ADMM loop from one start; returns the best check-point
        iterate, its error, the round count and the adapted rho. Scalars
        of the loop control live on the host (one read per interval)."""
        zeta = torch.clamp(As @ z, lc, uc)
        M, Mi = factor(rho_s)
        err = _INF
        err_best = _INF
        err_mark = _INF
        winct = restarts = hard_ct = rounds = 0
        stalled = False
        z_best, mu_best = z, mu
        while rounds < n_rounds and err > eff_tol and not stalled:
            rho_vec = rho_vector(rho_s)
            z, zeta, mu = admm_round(As, M, Mi, g_s, lc, uc, rho_vec,
                                     z.contiguous(), zeta.contiguous(),
                                     mu.contiguous(), config.check_every,
                                     config.over_relax, config.sigma)
            pres_t, dres_t = residuals(z, zeta, mu)
            finite_t = (torch.isfinite(z).all() & torch.isfinite(zeta).all()
                        & torch.isfinite(mu).all())
            vals = torch.stack([pres_t, dres_t, finite_t.to(dtype)]).tolist()
            pres, dres, finite = vals[0], vals[1], vals[2] > 0.5
            err = _nanmax(pres, dres)
            if err < err_best:
                z_best, mu_best = z, mu
            err_best = _nanmin(err, err_best)
            winct += 1
            window_done = winct >= config.stall_rounds
            improved = err_best < err_mark * 0.97
            stalled_win = window_done and not improved
            if window_done:
                err_mark = err_best
                winct = 0
                hard_ct = 0 if improved else hard_ct + 1
            hard_stalled = (config.stall_hard_windows > 0
                            and hard_ct >= config.stall_hard_windows)
            near_tol = err_best <= config.stall_tol_factor * eff_tol
            stalled_win = stalled_win and near_tol
            if stalled_win:
                restarts += 1
            stalled = (stalled_win and restarts > config.stall_restarts) \
                or hard_stalled
            # OSQP rho adaptation toward the lagging residual; a stalled
            # window forces at least a decade (prox_qp.py:309-325)
            ratio = math.sqrt((pres + 1e-20) / (dres + 1e-20))
            adapt = ratio > 2.0 or ratio < 0.5
            alt = 10.0 if restarts % 2 == 0 else 0.1
            big = _nanmax(ratio, 10.0) if ratio >= 1.0 \
                else _nanmin(ratio, 0.1)
            forced = big if abs(math.log(ratio)) > 0.2 else alt
            scale = forced if stalled_win else (ratio if adapt else 1.0)
            rho_s = min(max(rho_s * scale, 1e-6), 1e6)
            if not finite:
                # self-healing: restart this solve from zeros
                z = torch.zeros_like(z)
                zeta = torch.zeros_like(zeta)
                mu = torch.zeros_like(mu)
                err = _INF
                winct = 0
                err_mark = _INF
                stalled = False
                rho_s = config.rho
                hard_ct = 0
            if scale != 1.0 or not finite:
                M, Mi = factor(rho_s)
            rounds += 1
        use_best = err_best < err
        zr = z_best if use_best else z
        mur = mu_best if use_best else mu
        return zr, mur, _nanmin(err_best, err), rounds, rho_s

    rho0 = config.rho
    rho_w = rho0 if rho_init is None else min(max(float(rho_init), 1e-6),
                                              1e6)
    z, mu, err, rounds, rho_out = _run(z_w, mu_w, rho_w)
    if (z0 is not None or mu0 is not None) and config.warm_retry \
            and not err <= config.warm_retry_factor * eff_tol:
        # a stale warm start can trap ADMM; rerun cold, keep the better
        zc, muc, errc, rc, rhoc = _run(
            torch.zeros(nz, dtype=dtype, device=dev),
            torch.zeros(mA, dtype=dtype, device=dev), rho0)
        rounds += rc
        if errc < err:
            z, mu, rho_out = zc, muc, rhoc
        err = _nanmin(errc, err)

    # ---- active-set polish + primal / dual repair (prox_qp.py:404-556)
    inf_t = torch.full((), _INF, dtype=dtype, device=dev)

    def kkt_err(zs, mus):
        zo = dc * zs
        muo = (dr / cost_s) * mus
        Az = A @ zo
        zero = torch.zeros((), dtype=dtype, device=dev)
        pviol = torch.clamp_min(torch.maximum(
            torch.where(torch.isfinite(l), l - Az, zero),
            torch.where(torch.isfinite(u), Az - u, zero)), 0.0)
        pres = torch.amax(pviol / (1.0 + torch.abs(Az)))
        grad = p_diag * zo + g
        dres = torch.amax(torch.abs(grad + A.T @ muo) / (1.0 + torch.abs(grad)))
        e = torch.maximum(pres, dres)
        return torch.where(torch.isfinite(e), e, inf_t)

    delta = 1e-8
    pt_inv = 1.0 / (p_s + delta)
    eye = torch.eye(mA, dtype=dtype, device=dev)
    fin_l = l_s > -1e29
    fin_u = u_s < 1e29

    def spd_solve(S, b):
        Sinv = _inv(S)
        x = Sinv @ b
        return x + Sinv @ (b - S @ x)

    act_eps = 1e-4 * torch.amax(torch.abs(mu)) + 1e-30
    Az_s = As @ z
    near_l = fin_l & (Az_s - lc < 1e-5 * (1.0 + torch.abs(lc)))
    near_u = fin_u & (uc - Az_s < 1e-5 * (1.0 + torch.abs(uc)))
    strong = torch.abs(mu) > act_eps
    active_union = strong | near_l | near_u
    side_l0 = torch.where(strong, mu < 0, near_l)

    def polish_pass(side_l, active, nu0):
        b_act = torch.where(side_l, lc, uc)
        usable = active & (torch.abs(b_act) < 1e29)
        w = usable.to(dtype)
        Aw = As * w[:, None]
        S = (Aw * pt_inv[None, :]) @ Aw.T + delta * eye
        rhs = Aw @ (pt_inv * (-g_s)) - w * b_act
        nu = spd_solve(S, rhs) * w
        z_pol = pt_inv * (-g_s - Aw.T @ nu)
        for _ in range(2):
            r_z = -g_s - p_s * z_pol - Aw.T @ nu
            r_nu = w * b_act - Aw @ z_pol
            dnu = spd_solve(S, Aw @ (pt_inv * r_z) - r_nu) * w
            z_pol = z_pol + pt_inv * (r_z - Aw.T @ dnu)
            nu = nu + dnu
        Az = As @ z_pol
        wrong = torch.where(side_l, nu > act_eps, nu < -act_eps)
        viol_l = fin_l & (Az < lc - 1e-9 * (1.0 + torch.abs(lc)))
        viol_u = fin_u & (Az > uc + 1e-9 * (1.0 + torch.abs(uc)))
        active1 = (usable & ~wrong) | viol_l | viol_u
        side_l1 = viol_l | (~viol_u & side_l)
        return (side_l1, active1, nu), (z_pol, nu)

    err_admm = kkt_err(z, mu)
    best_z, best_mu, best_err = z, mu, err_admm
    for seed in (strong, active_union):
        carry = (side_l0, seed, mu)
        for _ in range(3):
            carry, (z_pol, nu) = polish_pass(*carry)
            finite = torch.isfinite(z_pol).all() & torch.isfinite(nu).all()
            err_pol = torch.where(finite, kkt_err(z_pol, nu), inf_t)
            take = err_pol < best_err
            best_z = torch.where(take, z_pol, best_z)
            best_mu = torch.where(take, nu, best_mu)
            best_err = torch.minimum(err_pol, best_err)

    rown2 = torch.clamp_min(torch.sum(As * As, dim=1), 1e-30)
    z_rep = best_z
    for _ in range(4):
        Az = As @ z_rep
        viol = torch.clamp_min(Az - uc, 0.0) + torch.clamp_max(Az - lc, 0.0)
        z_rep = z_rep - As.T @ (viol / rown2)
    err_rep = kkt_err(z_rep, best_mu)
    take_rep = torch.isfinite(z_rep).all() & (err_rep < best_err)
    best_z = torch.where(take_rep, z_rep, best_z)
    best_err = torch.minimum(err_rep, best_err)

    Azb = As @ best_z
    tight = (fin_l & (Azb - lc < 1e-6 * (1.0 + torch.abs(lc)))) | (
        fin_u & (uc - Azb < 1e-6 * (1.0 + torch.abs(uc))))
    wd = ((torch.abs(best_mu) > act_eps) | tight).to(dtype)
    r_s = p_s * best_z + g_s + As.T @ best_mu
    Awd = As * wd[:, None]
    Sd = Awd @ Awd.T + delta * eye
    dmu = spd_solve(Sd, -(Awd @ r_s)) * wd
    mu_rep = best_mu + dmu
    err_drep = kkt_err(best_z, mu_rep)
    take_drep = torch.isfinite(mu_rep).all() & (err_drep < best_err)
    best_mu = torch.where(take_drep, mu_rep, best_mu)
    best_err = torch.minimum(err_drep, best_err)

    z, mu, err_final = best_z, best_mu, best_err
    stats = {
        "qp_iters": rounds * config.check_every,
        "qp_err": err_final.to(out_dtype),
        "qp_polished": err_final < err_admm,
        "qp_converged": (err_final <= eff_tol) | bool(err <= eff_tol),
        "qp_rho": torch.tensor(rho_out, dtype=out_dtype, device=dev),
    }
    return ((dc * z).to(out_dtype), ((dr / cost_s) * mu).to(out_dtype),
            stats)
