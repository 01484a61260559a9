"""Dual-vertex crossover: sharpen first-order duals to basic solutions.

Port of record: ``sqlp_tpu/ops/crossover.py:sharpen_duals`` (:51-237).
PDHG returns epsilon-optimal, interior-ish duals; this rounds a batch of
them toward vertices of the dual polyhedron by batched active-set
least-squares solves over [B, m, m] normal systems, refines the active
sets for up to six sweeps, and accepts a rounded dual only where it stays
dual-feasible and loses no dual objective (rejected elements keep their
input dual, so cuts can only tighten).

``torch.linalg.solve`` raises on a singular system where
``jnp.linalg.solve`` returns non-finite values that the acceptance test
rejects (crossover.py:234); ``torch.linalg.solve_ex`` keeps the JAX
semantics: a singular element's solution is marked non-finite and
rejected. The f64 TPU fallback (``crossover_f64_fallback``) is not
ported: it accepted 0 duals at a 17x slowdown on storm (ROADMAP A6).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sqlp_tpu_torch.models.stage import SENSE_E, SENSE_G, SENSE_L


def _batched_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    x, info = torch.linalg.solve_ex(M, rhs[..., None])
    x = x[..., 0]
    # singular factorizations: non-finite like jnp.linalg.solve
    return torch.where((info != 0)[:, None],
                       torch.full_like(x, float("nan")), x)


def sharpen_duals(W: torch.Tensor, q: torch.Tensor, senses: torch.Tensor,
                  lb: torch.Tensor, ub: torch.Tensor, H: torch.Tensor,
                  Y: torch.Tensor, Pi: torch.Tensor,
                  feas_tol: float = 1e-6, active_tol: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round a batch of duals toward vertices; keep originals when unsafe.

    W [m, n], q [n], senses [m], lb/ub [n]; H [B, m] right-hand sides,
    Y [B, n] primal solutions, Pi [B, m] duals (d(obj)/d(rhs)).
    Returns (Pi_out [B, m], accepted [B] bool).
    """
    dt = W.dtype
    H = H.to(dt)
    Y = Y.to(dt)
    Pi = Pi.to(dt)
    zero = torch.zeros((), dtype=dt, device=W.device)

    is_eq = senses == SENSE_E
    is_ge = senses == SENSE_G
    is_le = senses == SENSE_L

    # --- 1. active structure
    slack = Y @ W.T - H
    h_scale = 1.0 + torch.abs(H)
    row_active = is_eq[None, :] | (torch.abs(slack) <= active_tol * h_scale) \
        | (torch.abs(Pi) > active_tol)
    y_scale = 1.0 + torch.abs(Y)
    at_lb = torch.isfinite(lb)[None, :] & (Y - lb[None, :]
                                           <= active_tol * y_scale)
    at_ub = torch.isfinite(ub)[None, :] & (ub[None, :] - Y
                                           <= active_tol * y_scale)
    interior = ~(at_lb | at_ub)

    # --- 2+3. masked normal equations + active-set restoration
    lo_inf = ~torch.isfinite(lb)
    hi_inf = ~torch.isfinite(ub)
    q_scale = 1.0 + torch.abs(q)

    def solve_ls(interior_f, row_active_b):
        Wc = W[None, :, :] * interior_f[:, None, :]
        M = Wc @ Wc.transpose(1, 2)
        ra = row_active_b.to(dt)
        M = M * ra[:, :, None] * ra[:, None, :]
        diag_reg = torch.where(row_active_b,
                               1e-8 * (1.0 + torch.abs(M).amax()),
                               torch.ones((), dtype=dt, device=W.device))
        M = M + torch.diag_embed(diag_reg)
        rhs = (Wc @ q) * ra
        return _batched_solve(M, rhs)

    pi_v = torch.zeros_like(Pi)
    changed = True
    k = 0
    while k < 6 and changed:
        pi = solve_ls(interior.to(dt), row_active)
        bad_row = (is_ge[None, :] & (pi < -active_tol * (1.0 + torch.abs(pi)))
                   ) | (is_le[None, :]
                        & (pi > active_tol * (1.0 + torch.abs(pi))))
        row_act1 = row_active & ~bad_row
        pi = torch.where(is_ge[None, :], torch.clamp_min(pi, 0.0), pi)
        pi = torch.where(is_le[None, :], torch.clamp_max(pi, 0.0), pi)
        g = q[None, :] - pi @ W
        viol = (hi_inf[None, :] & (g < -active_tol * q_scale[None, :])) | (
            lo_inf[None, :] & (g > active_tol * q_scale[None, :]))
        interior1 = interior | viol
        # one host read per sweep: stable sets reproduce the same pi
        changed = bool(torch.any(interior1 != interior)
                       | torch.any(row_act1 != row_active))
        interior, row_active, pi_v = interior1, row_act1, pi
        k += 1

    # --- 4. final sign projection + acceptance test
    pi_v = torch.where(is_ge[None, :], torch.clamp_min(pi_v, 0.0), pi_v)
    pi_v = torch.where(is_le[None, :], torch.clamp_max(pi_v, 0.0), pi_v)
    pi_v = torch.where(
        torch.abs(pi_v) <= 1e-12 * (1.0 + torch.abs(pi_v).amax()), zero,
        pi_v)

    def dual_metrics(P):
        g = q[None, :] - P @ W
        dviol = (torch.where(hi_inf[None, :], torch.clamp_min(-g, 0.0), zero)
                 + torch.where(lo_inf[None, :], torch.clamp_min(g, 0.0),
                               zero))
        dres = torch.linalg.norm(dviol, dim=-1) / (1.0 + torch.linalg.norm(q))
        lb_term = torch.where(torch.isfinite(lb), lb, zero)
        ub_term = torch.where(torch.isfinite(ub), ub, zero)
        dobj = (torch.sum(P * H, dim=-1) + torch.clamp_min(g, 0.0) @ lb_term
                - torch.clamp_min(-g, 0.0) @ ub_term)
        return dres, dobj

    dres_v, dobj_v = dual_metrics(pi_v)
    dres_0, dobj_0 = dual_metrics(Pi)
    obj_scale = 1.0 + torch.abs(dobj_0)
    accept = (dres_v <= feas_tol) & (dobj_v >= dobj_0 - 1e-9 * obj_scale)
    accept = accept & torch.all(torch.isfinite(pi_v), dim=-1)
    return torch.where(accept[:, None], pi_v, Pi), accept
