"""Master problem assembly: state -> canonical QP (l <= Az <= u).

Port of record: ``sqlp_tpu/sd/master.py`` (``assemble_master`` :36-86,
``cut_dual_slice`` :89-92). Variables z = [x (n1); eta (E)]; row layout
(must agree with ``state.master_rows``):

    [0, m1)               stage-1 rows  A1 x {senses1} b1
    [m1, m1+n1)           variable bounds  lb1 <= x <= ub1
    [m1+n1, m1+n1+E*K)    cut rows  eta_e - d beta@x >= d alpha + (1-d) lb_e
    [m1+n1+E*K, ... +E)   incumbent-cut rows at discount 1.0
"""

from __future__ import annotations

import torch

from sqlp_tpu_torch.models.stage import SENSE_E, SENSE_G, SENSE_L


def assemble_master(arrays, espec, state, rho: torch.Tensor):
    """(p_diag, g, A, l, u, is_eq) of the regularized master

        min c@x + sum_e w_e eta_e + rho/2 ||x - x_incumbent||^2.
    """
    E, K = state.cut_alpha.shape
    n1 = arrays.c.shape[0]
    m1 = arrays.b1.shape[0]
    dt = arrays.c.dtype
    dev = arrays.c.device
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    zeros = lambda *s: torch.zeros(s, dtype=dt, device=dev)

    p_diag = torch.cat([rho.expand(n1).to(dt), zeros(E)])
    g = torch.cat([arrays.c - rho * state.x_incumbent, espec.obj_weight])

    A1 = torch.cat([arrays.A1, zeros(m1, E)], dim=1)
    s1 = arrays.senses1
    l1 = torch.where(s1 == SENSE_L, -inf, arrays.b1)
    u1 = torch.where(s1 == SENSE_G, inf, arrays.b1)

    eye1 = torch.eye(n1, dtype=dt, device=dev)
    Ab = torch.cat([eye1, zeros(n1, E)], dim=1)

    d = state.cut_mark / torch.clamp_min(state.total_weight[:, None], 1e-30)
    alpha_t = d * state.cut_alpha + (1.0 - d) * espec.lower_bound[:, None]
    beta_t = d[:, :, None] * state.cut_beta
    live = state.cut_live.reshape(E * K)
    eta_block = torch.repeat_interleave(
        torch.eye(E, dtype=dt, device=dev), K, dim=0)
    Ac = torch.cat([-beta_t.reshape(E * K, n1), eta_block], dim=1)
    Ac = torch.where(live[:, None], Ac, zeros())
    lc = torch.where(live, alpha_t.reshape(E * K), -inf)
    uc = inf.expand(E * K)

    Ai = torch.cat([-state.inc_beta, torch.eye(E, dtype=dt, device=dev)],
                   dim=1)
    Ai = torch.where(state.inc_valid[:, None], Ai, zeros())
    li = torch.where(state.inc_valid, state.inc_alpha, -inf)
    ui = inf.expand(E)

    A = torch.cat([A1, Ab, Ac, Ai], dim=0)
    l = torch.cat([l1, arrays.lb1, lc, li])
    u = torch.cat([u1, arrays.ub1, uc, ui])
    is_eq = torch.cat([s1 == SENSE_E,
                       torch.zeros(n1 + E * K + E, dtype=torch.bool,
                                   device=dev)])
    return p_diag, g, A, l, u, is_eq


def cut_dual_slice(mu: torch.Tensor, m1: int, n1: int, E: int,
                   K: int) -> torch.Tensor:
    """The [E, K] cut-row multipliers (the prune signal)."""
    return mu[m1 + n1: m1 + n1 + E * K].reshape(E, K)
