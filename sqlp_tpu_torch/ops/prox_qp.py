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

A leading batch axis on the operands solves that many QPs together (the
replicated SD step's R masters, ``sqlp_tpu/sd/algorithm.py:683-695``):
one kernel launch per check interval steps every QP still running. A QP
that has met its stopping test is frozen, as ``jax.vmap`` of the
reference's ``while_loop`` freezes it by a select, so each QP's result
equals its own unbatched solve.

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
    """Explicit inverse over the trailing two axes; a singular matrix
    yields NaNs (as jnp.linalg.inv does) instead of raising, so the
    callers' finiteness guards reject the candidate. On CPU tensors the
    call runs under one intra-op thread (MKL's batched f64 LU never
    returns with more, as in ``ops/crossover.py:_batched_solve``), and the
    caller's count is restored after it."""
    if M.device.type == "cpu":
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            Mi, info = torch.linalg.inv_ex(M)
        finally:
            torch.set_num_threads(threads)
    else:
        Mi, info = torch.linalg.inv_ex(M)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(Mi, math.nan), Mi)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, over a leading batch axis when there is one. On the CPU
    each QP's product is taken on its own: a batched BLAS call sums in
    another order than the unbatched one, and a batched solve is to repeat
    each QP's unbatched arithmetic exactly. On the card one batched
    product serves every QP."""
    if a.dim() == 2 or a.device.type != "cpu":
        return a @ b
    return torch.stack([x @ y for x, y in zip(a, b)])


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product over a leading batch axis: [R, m, n] x
    [R, n] -> [R, m] (as :func:`_matmul`)."""
    if M.device.type != "cpu":
        return (M @ x[..., None])[..., 0]
    return torch.stack([m @ v for m, v in zip(M, x)])


def _mtv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Transposed product: [R, m, n]' x [R, m] -> [R, n]."""
    return _mv(M.transpose(-1, -2), x)


def scale_qp(p_diag, g, A, l, u):
    """OSQP-style problem scaling (``prox_qp.py:141-166``): Ruiz-equilibrate
    A and normalize the cost, over any leading batch axes. Returns (As,
    dr, dc, cost_s, p_s, g_s, l_s, u_s, lc, uc); lc / uc carry finite
    sentinels for infinite bounds."""
    mA, nz = A.shape[-2:]
    dtype, dev = A.dtype, A.device
    one = torch.ones((), dtype=dtype, device=dev)
    As = A
    dr = torch.ones(A.shape[:-1], dtype=dtype, device=dev)
    dc = torch.ones(A.shape[:-2] + (nz,), dtype=dtype, device=dev)
    for _ in range(10):
        rn = torch.sqrt(torch.amax(torch.abs(As), dim=-1))
        rn = torch.where(rn > 0, rn, one)
        As = As / rn[..., :, None]
        cn = torch.sqrt(torch.amax(torch.abs(As), dim=-2))
        cn = torch.where(cn > 0, cn, one)
        As = As / cn[..., None, :]
        dr, dc = dr / rn, dc / cn
    g_s = dc * g
    cost_s = 1.0 / torch.clamp_min(torch.amax(torch.abs(g_s), dim=-1), 1.0)
    p_s = cost_s[..., None] * dc * dc * p_diag
    g_s = cost_s[..., None] * g_s
    l_s = dr * l
    u_s = dr * u
    lc = torch.where(torch.isfinite(l_s), l_s, torch.full_like(l_s, -1e30))
    uc = torch.where(torch.isfinite(u_s), u_s, torch.full_like(u_s, 1e30))
    return (As.contiguous(), dr, dc, cost_s, p_s, g_s.contiguous(), l_s, u_s,
            lc.contiguous(), uc.contiguous())


def _rho_vector(is_eq, rho_s, eq_scale: float, dtype) -> torch.Tensor:
    """Per-row ADMM penalty: equality rows get ``eq_scale`` times more.
    ``rho_s`` is a float, or one value per QP of a batch."""
    rho = torch.as_tensor(rho_s, dtype=dtype, device=is_eq.device)
    rho = rho[..., None].expand(is_eq.shape)
    return torch.where(is_eq, rho * eq_scale, rho).contiguous()


def _factor(As, p_s, sigma: float, rho_vec):
    """(M, Minv) of the z-update at penalty rho_vec."""
    M = torch.diag_embed(p_s + sigma) + _matmul(
        As.transpose(-1, -2) * rho_vec[..., None, :], As)
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

    With a leading batch axis (A [R, mA, nz], the vectors [R, ...],
    ``rho_init`` [R]; ``is_eq`` may stay [mA]) the R QPs are solved
    together and every output carries the R axis; each QP's result is its
    unbatched solve.
    """
    if A.dim() == 2:
        one = lambda t: None if t is None else t[None]
        rho1 = None if rho_init is None else \
            torch.as_tensor(rho_init).reshape(1)
        z, mu, stats = _solve_batched(
            p_diag[None], g[None], A[None], l[None], u[None], is_eq[None],
            config, one(z0), one(mu0), rho1)
        return z[0], mu[0], {k: v[0] for k, v in stats.items()}
    return _solve_batched(p_diag, g, A, l, u,
                          is_eq.expand(A.shape[:-1]), config, z0, mu0,
                          rho_init)


def _solve_batched(p_diag, g, A, l, u, is_eq, config: QPConfig, z0, mu0,
                   rho_init):
    """:func:`solve_qp` on a batch of R QPs (every operand [R, ...])."""
    R, mA, nz = A.shape
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

    z_w = torch.zeros((R, nz), dtype=dtype, device=dev) if z0 is None \
        else z0 / dc
    mu_w = torch.zeros((R, mA), dtype=dtype, device=dev) if mu0 is None \
        else cost_s[:, None] * mu0 / dr
    n_rounds = max(1, config.max_iters // config.check_every)

    def residuals(ids, z, zeta, mu):
        """Per-row relative primal / per-component dual residuals in the
        original problem (``prox_qp.py:208-223``), one pair per QP."""
        zo = dc[ids] * z
        muo = (dr[ids] / cost_s[ids, None]) * mu
        Az = _mv(A[ids], zo)
        zetao = zeta / dr[ids]
        pscale = 1.0 + torch.maximum(torch.abs(Az), torch.abs(zetao))
        pres = torch.amax(torch.abs(Az - zetao) / pscale, dim=-1)
        grad = p_diag[ids] * zo + g[ids]
        Atmu = _mtv(A[ids], muo)
        dscale = 1.0 + torch.maximum(torch.abs(grad), torch.abs(Atmu))
        dres = torch.amax(torch.abs(grad + Atmu) / dscale, dim=-1)
        return pres, dres

    def _run(ids: torch.Tensor, z, mu, rho_s: list):
        """Full ADMM loop for the QPs ``ids`` from one start each; returns
        the best check-point iterates, their errors, round counts and
        adapted rhos. The stopping and adaptation scalars of each QP live
        on the host (one read per interval for the whole batch); a QP
        whose loop has ended is no longer stepped."""
        n = len(rho_s)
        As_r, g_r, lc_r, uc_r = As[ids], g_s[ids], lc[ids], uc[ids]
        eq_r = is_eq[ids]
        zeta = torch.clamp(_mv(As_r, z), lc_r, uc_r)
        M, Mi = _factor(As_r, p_s[ids], sig,
                        _rho_vector(eq_r, rho_s, config.rho_eq_scale, dtype))
        err = [_INF] * n
        err_best = [_INF] * n
        err_mark = [_INF] * n
        winct = [0] * n
        restarts = [0] * n
        hard_ct = [0] * n
        rounds = [0] * n
        stalled = [False] * n
        z_best, mu_best = z.clone(), mu.clone()
        while True:
            act = [b for b in range(n) if rounds[b] < n_rounds
                   and err[b] > eff_tol and not stalled[b]]
            if not act:
                break
            full = len(act) == n
            at = torch.as_tensor(act, device=dev)
            pick = (lambda t: t) if full else (lambda t: t[at])
            rho_vec = _rho_vector(pick(eq_r), [rho_s[b] for b in act],
                                  config.rho_eq_scale, dtype)
            za, zetaa, mua = admm_round(
                pick(As_r), pick(M), pick(Mi), pick(g_r), pick(lc_r),
                pick(uc_r), rho_vec, pick(z).contiguous(),
                pick(zeta).contiguous(), pick(mu).contiguous(),
                config.check_every, config.over_relax, config.sigma)
            pres_t, dres_t = residuals(pick(ids), za, zetaa, mua)
            finite_t = (torch.isfinite(za).all(-1)
                        & torch.isfinite(zetaa).all(-1)
                        & torch.isfinite(mua).all(-1))
            vals = torch.stack([pres_t, dres_t, finite_t.to(dtype)]).tolist()
            better, heal, refac = [], [], []
            for j, b in enumerate(act):
                pres, dres, finite = vals[0][j], vals[1][j], vals[2][j] > 0.5
                e = _nanmax(pres, dres)
                if e < err_best[b]:
                    better.append(j)
                err_best[b] = _nanmin(e, err_best[b])
                winct[b] += 1
                window_done = winct[b] >= config.stall_rounds
                improved = err_best[b] < err_mark[b] * 0.97
                stalled_win = window_done and not improved
                if window_done:
                    err_mark[b] = err_best[b]
                    winct[b] = 0
                    hard_ct[b] = 0 if improved else hard_ct[b] + 1
                hard_stalled = (config.stall_hard_windows > 0
                                and hard_ct[b] >= config.stall_hard_windows)
                near_tol = err_best[b] <= config.stall_tol_factor * eff_tol
                stalled_win = stalled_win and near_tol
                if stalled_win:
                    restarts[b] += 1
                stalled[b] = (stalled_win
                              and restarts[b] > config.stall_restarts) \
                    or hard_stalled
                # OSQP rho adaptation toward the lagging residual; a
                # stalled window forces at least a decade
                # (prox_qp.py:309-325)
                ratio = math.sqrt((pres + 1e-20) / (dres + 1e-20))
                adapt = ratio > 2.0 or ratio < 0.5
                alt = 10.0 if restarts[b] % 2 == 0 else 0.1
                big = _nanmax(ratio, 10.0) if ratio >= 1.0 \
                    else _nanmin(ratio, 0.1)
                forced = big if abs(math.log(ratio)) > 0.2 else alt
                scale = forced if stalled_win else (ratio if adapt else 1.0)
                rho_s[b] = min(max(rho_s[b] * scale, 1e-6), 1e6)
                err[b] = e
                if not finite:
                    # self-healing: restart this solve from zeros
                    heal.append(j)
                    err[b] = _INF
                    winct[b] = 0
                    err_mark[b] = _INF
                    stalled[b] = False
                    rho_s[b] = config.rho
                    hard_ct[b] = 0
                if scale != 1.0 or not finite:
                    refac.append(b)
                rounds[b] += 1
            if better:
                jb = torch.as_tensor(better, device=dev)
                z_best[at[jb]] = za[jb]
                mu_best[at[jb]] = mua[jb]
            if heal:
                jh = torch.as_tensor(heal, device=dev)
                za[jh], zetaa[jh], mua[jh] = 0.0, 0.0, 0.0
            if full:
                z, zeta, mu = za, zetaa, mua
            else:
                z, zeta, mu = z.clone(), zeta.clone(), mu.clone()
                z[at], zeta[at], mu[at] = za, zetaa, mua
            if refac:
                rf = torch.as_tensor(refac, device=dev)
                M, Mi = M.clone(), Mi.clone()
                M[rf], Mi[rf] = _factor(
                    As_r[rf], p_s[ids[rf]], sig,
                    _rho_vector(eq_r[rf], [rho_s[b] for b in refac],
                                config.rho_eq_scale, dtype))
        use_best = torch.as_tensor([eb < e for eb, e in zip(err_best, err)],
                                   device=dev)[:, None]
        zr = torch.where(use_best, z_best, z)
        mur = torch.where(use_best, mu_best, mu)
        return (zr, mur, [_nanmin(eb, e) for eb, e in zip(err_best, err)],
                rounds, rho_s)

    rho0 = config.rho
    if rho_init is None:
        rho_w = [rho0] * R
    else:
        rho_w = [min(max(v, 1e-6), 1e6) for v in
                 torch.as_tensor(rho_init).reshape(R).tolist()]
    ids = torch.arange(R, device=dev)
    z, mu, err, rounds, rho_out = _run(ids, z_w, mu_w, rho_w)
    if (z0 is not None or mu0 is not None) and config.warm_retry:
        # a stale warm start can trap ADMM; rerun cold, keep the better
        retry = [b for b in range(R)
                 if not err[b] <= config.warm_retry_factor * eff_tol]
        if retry:
            rt = torch.as_tensor(retry, device=dev)
            zc, muc, errc, rc, rhoc = _run(
                rt, torch.zeros((len(retry), nz), dtype=dtype, device=dev),
                torch.zeros((len(retry), mA), dtype=dtype, device=dev),
                [rho0] * len(retry))
            z, mu = z.clone(), mu.clone()
            for j, b in enumerate(retry):
                rounds[b] += rc[j]
                if errc[j] < err[b]:
                    z[b], mu[b], rho_out[b] = zc[j], muc[j], rhoc[j]
                err[b] = _nanmin(errc[j], err[b])

    # ---- active-set polish + primal / dual repair (prox_qp.py:404-556),
    # every QP of the batch at once
    inf_t = torch.full((), _INF, dtype=dtype, device=dev)
    col = lambda t: t[:, None]

    def kkt_err(zs, mus):
        zo = dc * zs
        muo = (dr / col(cost_s)) * mus
        Az = _mv(A, zo)
        zero = torch.zeros((), dtype=dtype, device=dev)
        pviol = torch.clamp_min(torch.maximum(
            torch.where(torch.isfinite(l), l - Az, zero),
            torch.where(torch.isfinite(u), Az - u, zero)), 0.0)
        pres = torch.amax(pviol / (1.0 + torch.abs(Az)), dim=-1)
        grad = p_diag * zo + g
        dres = torch.amax(torch.abs(grad + _mtv(A, muo))
                          / (1.0 + torch.abs(grad)), dim=-1)
        e = torch.maximum(pres, dres)
        return torch.where(torch.isfinite(e), e, inf_t)

    delta = 1e-8
    pt_inv = 1.0 / (p_s + delta)
    eye = torch.eye(mA, dtype=dtype, device=dev)
    fin_l = l_s > -1e29
    fin_u = u_s < 1e29

    def spd_solve(S, b):
        Sinv = _inv(S)
        x = _mv(Sinv, b)
        return x + _mv(Sinv, b - _mv(S, x))

    act_eps = col(1e-4 * torch.amax(torch.abs(mu), dim=-1) + 1e-30)
    Az_s = _mv(As, z)
    near_l = fin_l & (Az_s - lc < 1e-5 * (1.0 + torch.abs(lc)))
    near_u = fin_u & (uc - Az_s < 1e-5 * (1.0 + torch.abs(uc)))
    strong = torch.abs(mu) > act_eps
    active_union = strong | near_l | near_u
    side_l0 = torch.where(strong, mu < 0, near_l)

    def polish_pass(side_l, active, nu0):
        b_act = torch.where(side_l, lc, uc)
        usable = active & (torch.abs(b_act) < 1e29)
        w = usable.to(dtype)
        Aw = As * w[..., None]
        S = _matmul(Aw * pt_inv[:, None, :], Aw.transpose(-1, -2)) \
            + delta * eye
        rhs = _mv(Aw, pt_inv * (-g_s)) - w * b_act
        nu = spd_solve(S, rhs) * w
        z_pol = pt_inv * (-g_s - _mtv(Aw, nu))
        for _ in range(2):
            r_z = -g_s - p_s * z_pol - _mtv(Aw, nu)
            r_nu = w * b_act - _mv(Aw, z_pol)
            dnu = spd_solve(S, _mv(Aw, pt_inv * r_z) - r_nu) * w
            z_pol = z_pol + pt_inv * (r_z - _mtv(Aw, dnu))
            nu = nu + dnu
        Az = _mv(As, z_pol)
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
            finite = torch.isfinite(z_pol).all(-1) & torch.isfinite(nu).all(-1)
            err_pol = torch.where(finite, kkt_err(z_pol, nu), inf_t)
            take = err_pol < best_err
            best_z = torch.where(col(take), z_pol, best_z)
            best_mu = torch.where(col(take), nu, best_mu)
            best_err = torch.minimum(err_pol, best_err)

    rown2 = torch.clamp_min(torch.sum(As * As, dim=-1), 1e-30)
    z_rep = best_z
    for _ in range(4):
        Az = _mv(As, z_rep)
        viol = torch.clamp_min(Az - uc, 0.0) + torch.clamp_max(Az - lc, 0.0)
        z_rep = z_rep - _mtv(As, viol / rown2)
    err_rep = kkt_err(z_rep, best_mu)
    take_rep = torch.isfinite(z_rep).all(-1) & (err_rep < best_err)
    best_z = torch.where(col(take_rep), z_rep, best_z)
    best_err = torch.minimum(err_rep, best_err)

    Azb = _mv(As, best_z)
    tight = (fin_l & (Azb - lc < 1e-6 * (1.0 + torch.abs(lc)))) | (
        fin_u & (uc - Azb < 1e-6 * (1.0 + torch.abs(uc))))
    wd = ((torch.abs(best_mu) > act_eps) | tight).to(dtype)
    r_s = p_s * best_z + g_s + _mtv(As, best_mu)
    Awd = As * wd[..., None]
    Sd = _matmul(Awd, Awd.transpose(-1, -2)) + delta * eye
    dmu = spd_solve(Sd, -_mv(Awd, r_s)) * wd
    mu_rep = best_mu + dmu
    err_drep = kkt_err(best_z, mu_rep)
    take_drep = torch.isfinite(mu_rep).all(-1) & (err_drep < best_err)
    best_mu = torch.where(col(take_drep), mu_rep, best_mu)
    best_err = torch.minimum(err_drep, best_err)

    z, mu, err_final = best_z, best_mu, best_err
    err_admm_ok = torch.as_tensor([e <= eff_tol for e in err], device=dev)
    stats = {
        "qp_iters": torch.as_tensor(rounds, device=dev) * config.check_every,
        "qp_err": err_final.to(out_dtype),
        "qp_polished": err_final < err_admm,
        "qp_converged": (err_final <= eff_tol) | err_admm_ok,
        "qp_rho": torch.as_tensor(rho_out, dtype=out_dtype, device=dev),
    }
    return ((dc * z).to(out_dtype),
            ((dr / col(cost_s)) * mu).to(out_dtype), stats)
