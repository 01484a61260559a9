"""The SD iteration on tensors.

Port of record: ``sqlp_tpu/sd/algorithm.py`` (``_scenario_rhs`` :44-58,
``_quad_scalar_schedule`` :61-94, ``_refresh_cuts`` :97-145,
``_sample_and_rhs`` :148-271, ``_sharpen_flat`` :274-287, ``_finish``
:290-519, ``sd_step`` :522-611, ``sd_step_replicated`` :614-705,
``sd_run`` :735-772, ``sd_run_replicated`` :775-820), the 8-step loop of
the reference's ``sd_iteration!``:

  1. add new scenarios to each epigraph           -> scenario store append
  2. solve subproblems at the candidate           -> one batched PDHG call
  3. ... and at the incumbent; collect duals      ->   (both points at once)
  4. prune near-zero-dual cuts if master solved   -> live-mask update
  5. build SASA cut per epigraph at the candidate -> argmax matmul + insert
  6. refresh incumbent cut at the incumbent       -> replace [E] slots
  7. incumbent selection                          -> branchless compare
  8. regularized master solve -> new candidate    -> ADMM QP

The step is eager PyTorch: branches that read device data (the crossover
gate, the cut-refresh gate, the candidate repair loop, the solvers'
stopping tests) read it on the host. The replicated step runs R SD
replications in lockstep on a stacked state: one PDHG solve over the
flattened panel, one batched master QP. Importance sampling
(``proposal=``) is a single-run feature, as in the reference's CLI: the
replicated step takes no proposal.

``sd_step(..., mesh=)`` runs the step on a rank's part of a sharded state
(``parallel/mesh.py``): the scenario stream, the reservoir's draws, the
subproblem panel, the crossover and the master are replicated (every rank
draws and solves the same), a reservoir write lands on the rank that owns
its slot, and the pool's warm start, the dual push and the cuts combine
over the mesh's axes. With ``mesh=None`` the single-device step runs as
it did.
"""

from __future__ import annotations

import dataclasses as _dc
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sqlp_tpu_torch.config import SDConfig
from sqlp_tpu_torch.models.scenario import (cost_panel, effective_rhs_deltas,
                                            sample_deltas, sample_values,
                                            scenario_log_pdf)
from sqlp_tpu_torch.ops.crossover import sharpen_duals
from sqlp_tpu_torch.ops.pdhg import PreparedLP, solve_batch
from sqlp_tpu_torch.ops.prox_qp import solve_qp
from sqlp_tpu_torch.parallel.mesh import (gather_rows,
                                          global_quantized_argmax, offset_of)
from sqlp_tpu_torch.sd.cuts import Cut, build_sasa_cut, evaluate_multi_epigraph
from sqlp_tpu_torch.sd.dual_pool import push_duals
from sqlp_tpu_torch.sd.master import assemble_master, cut_dual_slice
from sqlp_tpu_torch.sd.state import (EpigraphSpec, SDState, stack_states,
                                     state_at)


def _scenario_rhs(arrays, model, deltas: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """h = r - T x + scatter(effective deltas): [P, R] deltas -> [P, m2]."""
    dt = arrays.r.dtype
    x = x.to(dt)
    deltas = deltas.to(dt)
    eff = effective_rhs_deltas(model, deltas, x)
    m2 = arrays.r.shape[0]
    dense = torch.zeros(deltas.shape[:-1] + (m2,), dtype=dt,
                        device=deltas.device)
    dense = dense.index_add_(-1, model.rv_row.long(), eff)
    return (arrays.r - arrays.T @ x) + dense


def _quad_scalar_schedule(state: SDState, config: SDConfig):
    """Prox-weight schedules (the reference's quad_scalar.jl). Returns
    (rho for this master solve, quad_scalar, normDk_1, normDk_init)."""
    if config.quad_schedule == "constant":
        rho = torch.tensor(config.quad_scalar_init,
                           dtype=state.quad_scalar.dtype,
                           device=state.quad_scalar.device)
        return rho, state.quad_scalar, state.normDk_1, state.normDk_init

    if config.quad_schedule != "adaptive":
        raise ValueError(f"unknown quad_schedule {config.quad_schedule!r}")
    diff = state.x_incumbent - state.x_candidate
    normDk = torch.sum(diff * diff)
    tol = config.quad_tolerance
    early = ~state.normDk_init & (normDk <= tol)
    normDk_1_eff = torch.where(state.normDk_init, state.normDk_1, normDk)
    qs = state.quad_scalar
    shrink = state.is_improved & (normDk > tol) & (
        normDk >= config.quad_r3 * normDk_1_eff)
    qs = torch.where(
        shrink,
        qs * (config.quad_r2 * config.quad_r3 * normDk_1_eff
              / torch.clamp_min(normDk, 1e-30)),
        qs)
    qs = torch.where(~state.is_improved, qs / config.quad_r2, qs)
    qs = torch.clamp(qs, config.quad_min, config.quad_max)
    new_qs = torch.where(early, state.quad_scalar, qs)
    new_normDk_1 = torch.where(early, state.normDk_1, normDk)
    new_init = state.normDk_init | (normDk > tol)
    return new_qs, new_qs, new_normDk_1, new_init


def _refresh_cuts(arrays, model, state: SDState, mesh=None) -> SDState:
    """Rebuild every live stored cut at its generating point against the
    current dual pool and scenario store, at full weight (the weight mark
    resets to the epigraph's total). A refreshed cut is an ordinary SASA
    cut at the stored x, so validity is untouched; dead slots keep their
    contents. One host read of the live mask picks the slots to build."""
    live = state.cut_live.cpu().tolist()
    alpha, beta = state.cut_alpha.clone(), state.cut_beta.clone()
    for e, row in enumerate(live):
        for k, is_live in enumerate(row):
            if is_live:
                cut = build_sasa_cut(arrays, model, state.duals,
                                     state.n_duals, state.scen_deltas[e],
                                     state.scen_weights[e],
                                     state.total_weight[e],
                                     state.cut_x[e, k], mesh=mesh)
                alpha[e, k] = cut.alpha
                beta[e, k] = cut.beta
    return _dc.replace(
        state, cut_alpha=alpha, cut_beta=beta,
        cut_mark=torch.where(state.cut_live, state.total_weight[:, None],
                             state.cut_mark))


def _refresh_due(state: SDState, config: SDConfig) -> bool:
    """The periodic refresh fires before a step whose pre-increment
    iteration counter is a positive multiple of ``cut_refresh_every``
    (one host read)."""
    if config.cut_refresh_every <= 0:
        return False
    it = int(state.it.reshape(-1)[0])
    return it > 0 and it % config.cut_refresh_every == 0


def _sample_and_rhs(arrays, model, espec: EpigraphSpec, state: SDState,
                    config: SDConfig, generator: torch.Generator,
                    deltas: Optional[torch.Tensor],
                    weights: Optional[torch.Tensor], proposal=None,
                    mesh=None):
    """Steps 1-2a: sample / append scenarios and build the [2EB, m2]
    subproblem RHS panel plus the pool dual warm start. Returns
    (store, H, L0, Q). With ``proposal`` (a ScenarioModel over the same
    positions) the E*B values are drawn from it and weighted by the exact
    density ratio p_model / p_proposal, on the device."""
    E = espec.n_epi
    B = config.scenarios_per_iter
    S = config.max_scenarios
    m2 = arrays.r.shape[0]
    dt = arrays.c.dtype
    dev = arrays.c.device

    if deltas is not None:
        if tuple(deltas.shape) != (E, B, model.n_rv):
            raise ValueError(
                f"user scenarios must be [n_epi={E}, B={B}, R={model.n_rv}], "
                f"got {tuple(deltas.shape)} (B is config.scenarios_per_iter)")
        new_deltas = deltas.to(dt)
    elif proposal is not None:
        if weights is not None:
            raise ValueError("a proposal computes its own weights: pass "
                             "proposal= or weights=, not both")
        vals = sample_values(generator, proposal, E * B,
                             method=config.sampling)
        logw = scenario_log_pdf(model, vals) - scenario_log_pdf(proposal,
                                                                vals)
        new_deltas = (vals - model.base).to(dt).reshape(E, B, model.n_rv)
        weights = torch.exp(logw).to(dt).reshape(E, B)
    else:
        new_deltas = sample_deltas(generator, model, E * B,
                                   method=config.sampling
                                   ).reshape(E, B, model.n_rv)
    if weights is None:
        new_w = torch.ones((E, B), dtype=dt, device=dev)
    else:
        if tuple(weights.shape) != (E, B):
            raise ValueError(f"weights must be [{E}, {B}], got "
                             f"{tuple(weights.shape)}")
        new_w = weights.to(dt)

    # Pre-saturation: append in stream order. At capacity: reservoir
    # sampling (Vitter's R) keeps the stored panel a uniform subsample of
    # the stream (sqlp_tpu/sd/algorithm.py:195-221); its draws come from
    # the solver's generator.
    u_res = torch.rand((E, B), generator=generator, dtype=dt, device=dev)
    j_res = torch.randint(0, S, (E, B), generator=generator, device=dev)
    scen_deltas, scen_weights = state.scen_deltas, state.scen_weights
    e_idx = torch.arange(E, device=dev)
    if mesh is not None:
        # this rank holds the slots [s_off, s_off + S_loc) of the store
        S_loc = scen_deltas.shape[1]
        s_off = offset_of(mesh.scen_axis, S_loc)
    for i in range(B):
        t = (state.n_stream + (i + 1)).to(dt)
        pre = state.n_scen + i < S
        take = u_res[:, i] * t < S
        idx = torch.where(pre, torch.clamp_max(state.n_scen + i, S - 1),
                          j_res[:, i].to(state.n_scen.dtype)).long()
        write = pre | take
        if mesh is not None:
            write = write & (idx >= s_off) & (idx < s_off + S_loc)
            idx = torch.clamp(idx - s_off, 0, S_loc - 1)
        old_d = scen_deltas[e_idx, idx]
        old_w = scen_weights[e_idx, idx]
        scen_deltas = scen_deltas.index_put(
            (e_idx, idx), torch.where(write[:, None], new_deltas[:, i],
                                      old_d))
        scen_weights = scen_weights.index_put(
            (e_idx, idx), torch.where(write, new_w[:, i], old_w))
    n_scen = torch.clamp_max(state.n_scen + B, S)
    overflow = torch.sum(torch.clamp_min(state.n_scen + B - S, 0)).to(
        state.scen_dropped.dtype)
    total_weight = state.total_weight + torch.sum(new_w, dim=1)
    n_stream = state.n_stream + B

    flat = new_deltas.reshape(E * B, model.n_rv)
    h_cand = _scenario_rhs(arrays, model, flat, state.x_candidate)
    h_inc = _scenario_rhs(arrays, model, flat, state.x_incumbent)
    # order [E, (cand, inc), B]: pool pushes follow the reference's
    # per-epigraph cand-then-inc sequence
    H = torch.stack([h_cand.reshape(E, B, m2), h_inc.reshape(E, B, m2)],
                    dim=1).reshape(2 * E * B, m2)
    if model.has_cost:
        n2 = arrays.q.shape[0]
        Qc = cost_panel(model, flat, arrays.q).reshape(E, B, n2)
        Q = torch.stack([Qc, Qc], dim=1).reshape(2 * E * B, n2)
    else:
        Q = None
    d_ax = None if mesh is None else mesh.dual_axis
    if config.pool_dual_warm_start and d_ax is not None:
        # the same start over a sharded pool: the quantum from the global
        # column max, the winner's row from its owner
        D_loc = state.duals.shape[0]
        off = offset_of(d_ax, D_loc)
        live = (off + torch.arange(D_loc, device=dev))[:, None] \
            < state.n_duals
        scores = torch.where(live, state.duals @ H.T,
                             torch.full((), float("-inf"), dtype=dt,
                                        device=dev))
        best = global_quantized_argmax(scores, d_ax, off, eps=1e-4)
        L0 = torch.where(state.n_duals > 0,
                         gather_rows(state.duals, best, d_ax, off),
                         state.sub_warm_L)
    elif config.pool_dual_warm_start:
        # pool-argmax dual warm start, quantized like the cut pick
        D = config.max_dual_vertices
        live = torch.arange(D, device=dev)[:, None] < state.n_duals
        scores = torch.where(live, state.duals @ H.T,
                             torch.full((), float("-inf"), dtype=dt,
                                        device=dev))
        quantum = 1e-4 * (1.0 + torch.abs(torch.amax(scores, dim=0)))
        L0_pool = state.duals[torch.argmax(torch.floor(scores / quantum),
                                           dim=0)]
        L0 = torch.where(state.n_duals > 0, L0_pool, state.sub_warm_L)
    else:
        L0 = state.sub_warm_L

    store = dict(scen_deltas=scen_deltas, scen_weights=scen_weights,
                 n_scen=n_scen, n_stream=n_stream,
                 total_weight=total_weight, overflow=overflow)
    return store, H, L0, Q


def _sharpen_flat(arrays, H, sub_Y, Pi):
    """Crossover on the flat element batch."""
    return sharpen_duals(arrays.W, arrays.q, arrays.senses2, arrays.lb2,
                         arrays.ub2, H, sub_Y, Pi)


def _finish_pre(arrays, model, espec: EpigraphSpec, state: SDState,
                config: SDConfig, store: dict, Pi_sharp, pdhg_valid,
                mesh=None):
    """Steps 3-7: dual-pool push, cut prune/build, incumbent selection and
    the prox schedule. Returns (state_now, master, extra): the state the
    master is assembled from, the master QP's operands, and what the
    post-master half needs."""
    E = espec.n_epi
    n1 = arrays.c.shape[0]
    dt = arrays.c.dtype
    dev = arrays.c.device
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    scen_deltas = store["scen_deltas"]
    scen_weights = store["scen_weights"]
    total_weight = store["total_weight"]

    duals, duals_rounded, n_duals, duals_dropped, duals_score = push_duals(
        state.duals, state.duals_rounded, state.n_duals, Pi_sharp,
        state.duals_dropped, config.dual_sig_bits,
        valid=pdhg_valid, score=state.duals_score,
        axis=None if mesh is None else mesh.dual_axis)

    # ---- 4. prune near-zero-dual cuts
    mu_scale = torch.amax(torch.where(state.cut_live, torch.abs(state.cut_dual),
                                      torch.zeros((), dtype=dt, device=dev)))
    prune_tol = torch.clamp_min(1e-3 * mu_scale, config.cut_remove_tolerance)
    prune = state.master_solved & (torch.abs(state.cut_dual) < prune_tol)
    cut_live = state.cut_live & ~prune

    state_last = _dc.replace(
        state, scen_deltas=scen_deltas, scen_weights=scen_weights,
        n_scen=store["n_scen"], n_stream=store["n_stream"],
        total_weight=total_weight, cut_live=cut_live,
        duals=duals, duals_rounded=duals_rounded, n_duals=n_duals)
    last_cand_eval = evaluate_multi_epigraph(state_last, espec,
                                             state.x_candidate)
    last_inc_eval = evaluate_multi_epigraph(state_last, espec,
                                            state.x_incumbent)

    # ---- 5. SASA cuts at the candidate (and incumbent), per epigraph
    def build_at(x):
        cuts, counts = [], []
        for e in range(E):
            c, n = build_sasa_cut(arrays, model, duals, n_duals,
                                  scen_deltas[e], scen_weights[e],
                                  total_weight[e], x, with_counts=True,
                                  mesh=mesh)
            cuts.append(c)
            counts.append(n)
        return (Cut(torch.stack([c.alpha for c in cuts]),
                    torch.stack([c.beta for c in cuts])),
                torch.stack(counts))

    cand_cut, cand_counts = build_at(state.x_candidate)
    argmax_counts = torch.sum(cand_counts, dim=0)
    if config.update_incumbent_cut:
        inc_cut, inc_counts = build_at(state.x_incumbent)
        argmax_counts = argmax_counts + torch.sum(inc_counts, dim=0)

    # insert: first dead slot, else evict the smallest-|dual| live cut
    slot_score = torch.where(cut_live, torch.abs(state.cut_dual), ninf)
    slots = torch.argmin(slot_score, dim=1)
    e_idx = torch.arange(E, device=dev)
    at = (e_idx, slots)
    cut_alpha = state.cut_alpha.index_put(at, cand_cut.alpha)
    cut_beta = state.cut_beta.index_put(at, cand_cut.beta)
    cut_mark = state.cut_mark.index_put(at, total_weight)
    cut_dual = state.cut_dual.index_put(
        at, torch.full((E,), float("inf"), dtype=dt, device=dev))
    cut_live = cut_live.index_put(
        at, torch.ones(E, dtype=torch.bool, device=dev))
    cut_x = state.cut_x.index_put(at, state.x_candidate.expand(E, n1))

    # ---- 6. refresh incumbent cut
    if config.update_incumbent_cut:
        inc_alpha, inc_beta = inc_cut.alpha, inc_cut.beta
        inc_valid = torch.ones(E, dtype=torch.bool, device=dev)
    else:
        inc_alpha, inc_beta = state.inc_alpha, state.inc_beta
        inc_valid = state.inc_valid
    duals_score = config.dual_score_decay * duals_score + argmax_counts

    state_now = _dc.replace(
        state_last, cut_alpha=cut_alpha, cut_beta=cut_beta,
        cut_mark=cut_mark, cut_dual=cut_dual, cut_live=cut_live,
        cut_x=cut_x, inc_alpha=inc_alpha, inc_beta=inc_beta,
        inc_valid=inc_valid)

    # ---- 7. incumbent selection
    f_cand = arrays.c @ state.x_candidate
    f_inc = arrays.c @ state.x_incumbent
    cand_est = evaluate_multi_epigraph(state_now, espec,
                                       state.x_candidate) + f_cand
    inc_est = evaluate_multi_epigraph(state_now, espec,
                                      state.x_incumbent) + f_inc
    req = config.incumbent_q * ((last_cand_eval + f_cand)
                                - (last_inc_eval + f_inc))
    is_improved = cand_est < inc_est + req
    # never promote a first-stage-infeasible candidate
    res_c = arrays.A1 @ state.x_candidate - arrays.b1
    viol_c = torch.where(
        arrays.senses1 == 1, torch.clamp_min(-res_c, 0.0),
        torch.where(arrays.senses1 == -1, torch.clamp_min(res_c, 0.0),
                    torch.abs(res_c)))
    cand_feasible = torch.all(viol_c <= 1e-4 * (1.0 + torch.abs(arrays.b1)))
    is_improved = is_improved & cand_feasible

    state_now = _dc.replace(state_now, is_improved=is_improved,
                            cand_est=cand_est, inc_est=inc_est,
                            req_improvement=req)

    # ---- schedule BEFORE incumbent replacement
    rho, quad_scalar, normDk_1, normDk_init = _quad_scalar_schedule(
        state_now, config)
    x_incumbent = torch.where(is_improved, state.x_candidate,
                              state.x_incumbent)
    state_now = _dc.replace(state_now, x_incumbent=x_incumbent,
                            quad_scalar=quad_scalar, normDk_1=normDk_1,
                            normDk_init=normDk_init)

    master = assemble_master(arrays, espec, state_now, rho)
    extra = dict(rho=rho, duals_dropped=duals_dropped,
                 duals_score=duals_score, overflow=store["overflow"])
    return state_now, master, extra


def _finish_post(arrays, espec: EpigraphSpec, state: SDState,
                 config: SDConfig, state_now: SDState, extra: dict, z, mu,
                 qp_stats: dict, sub_obj, sub_Y, Pi, xover_dry,
                 crossover_accepted) -> Tuple[SDState, dict]:
    """Step 8 after the master solve: candidate repair and the new state
    and stats."""
    E = espec.n_epi
    K = config.max_cuts
    n1 = arrays.c.shape[0]
    m1 = arrays.b1.shape[0]
    # box clip, then relaxed hyperplane-projection sweeps close residual
    # stage-1 row violations (sqlp_tpu/sd/algorithm.py:441-485)
    x_candidate = torch.clamp(z[:n1], arrays.lb1, arrays.ub1)
    rownorm2 = torch.clamp_min(torch.sum(arrays.A1 * arrays.A1, dim=1),
                               1e-30)

    def _row_viol(x):
        resid = arrays.A1 @ x - arrays.b1
        return torch.where(
            arrays.senses1 == 1, torch.clamp_max(resid, 0.0),
            torch.where(arrays.senses1 == -1, torch.clamp_min(resid, 0.0),
                        resid))

    def _repair_sweep(x):
        x = x - arrays.A1.T @ (_row_viol(x) / rownorm2)
        return torch.clamp(x, arrays.lb1, arrays.ub1)

    for _ in range(4):
        x_candidate = _repair_sweep(x_candidate)
    feas_big = 1e-6 * (1.0 + torch.abs(arrays.b1))
    sweeps = 0
    while sweeps < 60 and m1 > 0 and bool(
            torch.any(torch.abs(_row_viol(x_candidate)) > feas_big)):
        x_candidate = _repair_sweep(x_candidate)
        sweeps += 1
    cut_dual = cut_dual_slice(mu, m1, n1, E, K)

    new_state = _dc.replace(
        state_now,
        it=state.it + 1,
        x_candidate=x_candidate,
        xover_dry=xover_dry,
        cut_dual=cut_dual,
        master_solved=qp_stats["qp_converged"],
        master_z=z,
        master_mu=mu,
        master_rho=qp_stats["qp_rho"],
        scen_dropped=state.scen_dropped + extra["overflow"],
        duals_dropped=extra["duals_dropped"],
        duals_score=extra["duals_score"],
        sub_warm_Y=sub_Y,
        sub_warm_L=Pi,
    )
    stats = {
        "it": new_state.it,
        "cand_est": state_now.cand_est,
        "inc_est": state_now.inc_est,
        "is_improved": state_now.is_improved,
        "rho": extra["rho"],
        "n_duals": state_now.n_duals,
        "n_cuts_live": torch.sum(state_now.cut_live),
        "sub_obj_mean": torch.mean(sub_obj),
        "x_candidate": x_candidate,
        "crossover_accepted": crossover_accepted,
        **qp_stats,
    }
    return new_state, stats


def _finish(arrays, model, espec: EpigraphSpec, state: SDState,
            config: SDConfig, store: dict, sub_obj, sub_Y, Pi, Pi_sharp,
            pdhg_valid, xover_dry, crossover_accepted, mesh=None
            ) -> Tuple[SDState, dict]:
    """Steps 3-8: dual-pool push, cut prune/build, incumbent selection,
    schedule, master solve, candidate repair."""
    state_now, master, extra = _finish_pre(arrays, model, espec, state,
                                           config, store, Pi_sharp,
                                           pdhg_valid, mesh)
    z, mu, qp_stats = solve_qp(*master, config.qp, z0=state.master_z,
                               mu0=state.master_mu,
                               rho_init=state.master_rho)
    return _finish_post(arrays, espec, state, config, state_now, extra, z,
                        mu, qp_stats, sub_obj, sub_Y, Pi, xover_dry,
                        crossover_accepted)


def sd_step(arrays, model, espec: EpigraphSpec, prep_sub: PreparedLP,
            state: SDState, config: SDConfig, generator: torch.Generator,
            deltas: Optional[torch.Tensor] = None,
            weights: Optional[torch.Tensor] = None, proposal=None,
            mesh=None) -> Tuple[SDState, dict]:
    """One SD iteration: state -> (state', stats).

    ``generator`` (on the state's device) draws the scenarios and the
    reservoir's choices; ``deltas`` ([E, B, R]) supplies the iteration's
    scenarios instead of sampling them; ``weights`` ([E, B], default 1) is
    the per-scenario weight of ``add_scenario!``; ``proposal`` (a
    ScenarioModel over the same positions) draws the scenarios from it
    and weights each by the exact density ratio (importance sampling,
    no host read); ``mesh`` (a ``parallel.mesh.Mesh``) steps this rank's
    part of a sharded state.
    """
    if _refresh_due(state, config):
        state = _refresh_cuts(arrays, model, state, mesh)
    store, H, L0, Q = _sample_and_rhs(arrays, model, espec, state, config,
                                      generator, deltas, weights, proposal,
                                      mesh)

    sub_obj, sub_Y, Pi, sub_stats = solve_batch(
        prep_sub, H, config.pdhg, Y0=state.sub_warm_Y, L0=L0, Q=Q)

    if config.dual_crossover and not model.has_cost:
        # adaptive gate: skip the batched [m2, m2] solves once the
        # acceptance test has rejected everything for crossover_dry_limit
        # consecutive iterations (one host read)
        live = config.crossover_dry_limit <= 0 or \
            int(state.xover_dry) < config.crossover_dry_limit
        if live:
            Pi_sharp, xover = _sharpen_flat(arrays, H, sub_Y, Pi)
        else:
            Pi_sharp = Pi
            xover = torch.zeros(Pi.shape[0], dtype=torch.bool,
                                device=Pi.device)
        n_acc = torch.sum(xover).to(torch.int32)
        xover_dry = torch.where(n_acc > 0, torch.zeros_like(state.xover_dry),
                                state.xover_dry + 1)
    else:
        Pi_sharp = Pi
        xover_dry = state.xover_dry
        n_acc = torch.zeros((), dtype=torch.int32, device=Pi.device)

    new_state, stats = _finish(arrays, model, espec, state, config, store,
                               sub_obj, sub_Y, Pi, Pi_sharp,
                               sub_stats["pdhg_valid"], xover_dry, n_acc,
                               mesh)
    stats.update(sub_stats)
    return new_state, stats


def sd_step_replicated(arrays, model, espec: EpigraphSpec,
                       prep_sub: PreparedLP, states: SDState,
                       config: SDConfig, generators: List[torch.Generator],
                       deltas: Optional[torch.Tensor] = None
                       ) -> Tuple[SDState, dict]:
    """One SD iteration on R stacked replications (every field of
    ``states`` carries a leading R axis; ``stack_states`` builds one).

    Replication r samples from ``generators[r]`` unless ``deltas``
    ([R, E*B, n_rv]) supplies every replication's scenarios. The
    per-replication sample / RHS builds feed ONE ``solve_batch`` over the
    flattened [R*2EB, m2] panel (one restart loop, one compaction ladder);
    the crossover masks its per-replication dry gate instead of branching;
    the R master QPs are one batched ``solve_qp`` without the cold warm
    retry, as under the reference's vmap (``algorithm.py:683-687``). Stats
    are [R]-shaped, with the panel-global PDHG scalars broadcast.
    """
    R = states.cut_alpha.shape[0]
    E = espec.n_epi
    B = config.scenarios_per_iter
    if len(generators) != R:
        raise ValueError(f"{len(generators)} generators for {R} "
                         f"replications")
    if deltas is not None and tuple(deltas.shape[:2]) != (R, E * B):
        raise ValueError(f"replicated scenarios must be [R={R}, E*B="
                         f"{E * B}, n_rv], got {tuple(deltas.shape)}")
    reps = [state_at(states, r) for r in range(R)]
    if _refresh_due(states, config):
        # replications run in lockstep: one gate for all
        reps = [_refresh_cuts(arrays, model, st) for st in reps]
    parts = [_sample_and_rhs(
        arrays, model, espec, st, config, generators[r],
        None if deltas is None else deltas[r].reshape(E, B, -1), None)
        for r, st in enumerate(reps)]
    P = parts[0][1].shape[0]                        # 2*E*B rows per rep
    H = torch.cat([pt[1] for pt in parts])
    Q = None if parts[0][3] is None else torch.cat([pt[3] for pt in parts])
    sub_obj, sub_Y, Pi, sub_stats = solve_batch(
        prep_sub, H, config.pdhg,
        Y0=torch.cat([st.sub_warm_Y for st in reps]),
        L0=torch.cat([pt[2] for pt in parts]), Q=Q)

    dry = states.xover_dry
    if config.dual_crossover and not model.has_cost:
        live = torch.ones_like(dry, dtype=torch.bool) \
            if config.crossover_dry_limit <= 0 \
            else dry < config.crossover_dry_limit
        # the batched active-set solves are skipped only when every
        # replication's gate is dry (one host read)
        if bool(torch.any(live)):
            live_el = torch.repeat_interleave(live, P)
            Pi_sharp, accept = _sharpen_flat(arrays, H, sub_Y, Pi)
            Pi_sharp = torch.where(live_el[:, None], Pi_sharp, Pi)
            accept = accept & live_el
        else:
            Pi_sharp = Pi
            accept = torch.zeros(Pi.shape[0], dtype=torch.bool,
                                 device=Pi.device)
        n_acc = torch.sum(accept.reshape(R, P), dim=1).to(torch.int32)
        xover_dry = torch.where(n_acc > 0, torch.zeros_like(dry), dry + 1)
    else:
        Pi_sharp = Pi
        xover_dry = dry
        n_acc = torch.zeros(R, dtype=torch.int32, device=Pi.device)

    rows = [slice(r * P, (r + 1) * P) for r in range(R)]
    valid = sub_stats["pdhg_valid"]
    pre = [_finish_pre(arrays, model, espec, reps[r], config,
                       parts[r][0], Pi_sharp[rows[r]], valid[rows[r]])
           for r in range(R)]
    master = [torch.stack([pr[1][i] for pr in pre]) for i in range(6)]
    qp_cfg = _dc.replace(config.qp, warm_retry=False)
    z, mu, qp_stats = solve_qp(*master, qp_cfg, z0=states.master_z,
                               mu0=states.master_mu,
                               rho_init=states.master_rho)
    outs = [_finish_post(arrays, espec, reps[r], config, pre[r][0],
                         pre[r][2], z[r], mu[r],
                         {k: v[r] for k, v in qp_stats.items()},
                         sub_obj[rows[r]], sub_Y[rows[r]], Pi[rows[r]],
                         xover_dry[r], n_acc[r])
            for r in range(R)]
    new_states = stack_states([o[0] for o in outs])
    stats = {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}
    for k, v in sub_stats.items():
        if k in ("pdhg_done", "pdhg_valid", "pdhg_err"):
            stats[k] = v.reshape(R, P)
        else:
            t = torch.as_tensor(v, device=Pi.device)
            stats[k] = t.expand((R,) + t.shape)
    return new_states, stats


def scalar_stat_keys(stats: Dict, ndim: int = 0) -> Tuple[str, ...]:
    """Sorted names of the scalar entries of an ``sd_step`` stats dict
    (``ndim=1``: the [R]-shaped entries of ``sd_step_replicated``'s): the
    column order of the packed panels."""
    def scalar(v) -> bool:
        if torch.is_tensor(v):
            return v.dim() == ndim
        return ndim == 0 and isinstance(v, (int, float, bool))

    return tuple(sorted(k for k, v in stats.items() if scalar(v)))


def _pack(rows: List[torch.Tensor]) -> np.ndarray:
    """Per-step stat rows -> one float32 host array (one transfer)."""
    return torch.stack(rows).to(torch.float32).cpu().numpy()


def sd_run(arrays, model, espec: EpigraphSpec, prep_sub: PreparedLP,
           state: SDState, config: SDConfig, n_steps: int,
           generator: torch.Generator, proposal=None, mesh=None
           ) -> Tuple[SDState, np.ndarray, Tuple[str, ...]]:
    """Run n_steps SD iterations (drawing from ``proposal`` when given;
    on this rank's part of a sharded state with ``mesh``).
    Returns (state, packed, keys): packed is one [n_steps, n_keys] float32
    host array of the per-iteration scalar stats, column j named keys[j],
    read back once at the end."""
    rows: List[torch.Tensor] = []
    keys: Tuple[str, ...] = ()
    for _ in range(n_steps):
        state, stats = sd_step(arrays, model, espec, prep_sub, state,
                               config, generator, proposal=proposal,
                               mesh=mesh)
        if not keys:
            keys = scalar_stat_keys(stats)
        rows.append(torch.stack([
            torch.as_tensor(stats[k], device=state.it.device).to(
                torch.float64) for k in keys]))
    if not rows:
        return state, np.zeros((0, 0), np.float32), keys
    return state, _pack(rows), keys


def sd_run_replicated(arrays, model, espec: EpigraphSpec,
                      prep_sub: PreparedLP, states: SDState,
                      config: SDConfig, n_steps: int,
                      generators: List[torch.Generator]
                      ) -> Tuple[SDState, np.ndarray, Tuple[str, ...]]:
    """Advance R stacked replications n_steps iterations in lockstep.
    Returns (states, packed, keys): packed is one [n_steps, n_keys, R]
    float32 host array of the per-iteration, per-replication scalar
    stats, read back once at the end."""
    rows: List[torch.Tensor] = []
    keys: Tuple[str, ...] = ()
    for _ in range(n_steps):
        states, stats = sd_step_replicated(arrays, model, espec, prep_sub,
                                           states, config, generators)
        if not keys:
            keys = scalar_stat_keys(stats, ndim=1)
        rows.append(torch.stack([stats[k].to(torch.float64) for k in keys]))
    if not rows:
        return states, np.zeros((0, 0, 0), np.float32), keys
    return states, _pack(rows), keys
