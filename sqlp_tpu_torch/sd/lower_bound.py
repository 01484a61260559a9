"""Certified lower bounds for SD solutions: the model, the level-bundle
polish and the extensive-form (EF) routes.

Port of record: ``sqlp_tpu/sd/lower_bound.py`` (``cut_model_min``
:77-208, ``_certification_streams`` :211-301, ``saa_polish`` :304-720,
``_feasproj_consts`` / ``_feasproj_run`` :722-770,
``_refine_recourse_duals`` :773-852, ``_lagrangian_corrections`` :934-976,
``saa_ef_bound`` :979-1340, ``t_lower_bound`` :1342-1393,
``certified_lower_bound`` :1395-1441).

Per replication, a deterministic lower bound on its sample-average (SAA)
optimum v_N:

* the model route (``certified_lower_bound``): the exact minimum of the
  SD run's own cut model over the first-stage polytope (host HiGHS, f64);
* the polish route (``saa_polish``): a level bundle that tightens the
  model with full-stream average cuts before taking its exact minimum.
  Each round evaluates every replication's points in one batched recourse
  solve, assembles the cuts in f64 on the device and projects onto the
  level set with one R-batched ADMM QP;
* the EF route (``saa_ef_bound``): solve the replication's sample-average
  extensive form over its certification stream (models/crash.py, all R
  replications in one batched solve, then an f64 continuation), walk the
  per-scenario duals to dual feasibility (a minimal-movement projection,
  f64, on the device), deduct the exact weak-duality correction of what
  infeasibility remains, and take the exact minimum of the one aggregate
  cut per epigraph on the host. By LP duality that minimum is v_N less
  the solve's duality gap. ``extra_cuts`` merges the polish's cuts in
  (the ``ef_polish`` route of the driver).

Certification streams are fresh (Latin hypercube by default), the SD
run's own, or the SD run's extended; under ``fresh_pairing="antithetic"``
replication 2k+1 certifies on the complement of replication 2k's stream.
``t_lower_bound`` turns R i.i.d. per-replication bounds (or R/2 pair
means) into a Student-t confidence bound on the true optimum. The
validity caveats and the measurements behind each default are those of
the port of record's docstrings. Not ported: ``refine_mode="resolve"``
(it crashes the bound to the epigraph floor on degenerate recourse; the
port raises ValueError), and the reference's ``vmap_group`` split and
``ef_chunk_iters`` (both work around TPU compile and program-length
limits). The f64 continuation runs unless ``refine_f64=False``: the
reference's default (None) skips it only on the TPU backend.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import scipy.optimize
import torch

from sqlp_tpu_torch.models.crash import solve_extensive_form
from sqlp_tpu_torch.models.routines import (_np, project_first_stage,
                                            solve_lp_host)
from sqlp_tpu_torch.models.scenario import cost_panel, sample_deltas
from sqlp_tpu_torch.models.stage import SENSE_G, SENSE_L
from sqlp_tpu_torch.ops.pdhg import solve_batch
from sqlp_tpu_torch.ops.prox_qp import solve_qp
from sqlp_tpu_torch.sd.algorithm import _scenario_rhs


def _np64(a) -> np.ndarray:
    return _np(a, np.float64)


def _to64(dc):
    """A copy of a dataclass of tensors with its floating tensors in
    float64 (the instance arrays and the scenario model)."""
    return dataclasses.replace(dc, **{
        f.name: getattr(dc, f.name).to(torch.float64)
        for f in dataclasses.fields(dc)
        if torch.is_tensor(getattr(dc, f.name))
        and getattr(dc, f.name).is_floating_point()})


def cut_model_min(arrays, espec, state, obj_scale: float = 1.0,
                  check_validity: bool = True,
                  extra_cuts: Optional[Sequence] = None,
                  include_state_cuts: bool = True,
                  return_x: bool = False):
    """Exact minimum of the cut model over the first-stage polytope.

        min_x  c@x + sum_e w_e eta_e
        s.t.   A1 x {senses1} b1,  lb1 <= x <= ub1,
               eta_e >= d alpha + (1-d) lb_e + d beta@x   (live cuts)
               eta_e >= alpha_inc + beta_inc@x            (incumbent cut)
               eta_e >= lb_e

    solved on the host by HiGHS in f64. The arguments are the solver's
    scaled arrays, spec and state; ``obj_scale`` unscales the value.
    ``extra_cuts`` ([(e, alpha, beta), ...], scaled units) adds
    full-weight cuts; ``include_state_cuts=False`` drops the SD run's own
    cut pool and incumbent cuts (required when the extra cuts certify a
    stream the SD cuts are not valid for).

    Returns the unscaled optimal value, or with ``return_x`` the tuple
    (value, x, eta) in scaled units.
    """
    c = _np64(arrays.c)
    A1 = _np64(arrays.A1)
    b1 = _np64(arrays.b1)
    senses1 = _np(arrays.senses1)
    lb1 = _np64(arrays.lb1)
    ub1 = _np64(arrays.ub1)
    w = _np64(espec.obj_weight)
    lb_e = _np64(espec.lower_bound)
    n1 = c.shape[0]
    E = w.shape[0]

    if check_validity:
        dropped = int(_np(state.scen_dropped))
        if dropped != 0:
            warnings.warn(
                "scenario reservoir overflowed during this run "
                f"(scen_dropped={dropped}); post-saturation cuts average a "
                "subsample of the stream, so the cut-model minimum is no "
                "longer a strict bound on the stream's SAA optimum")
        sw = _np64(state.scen_weights)
        ns = _np(state.n_scen)
        live_w = np.concatenate(
            [sw[e, :int(ns[e])] for e in range(E)]) if ns.sum() else \
            np.ones(0)
        if live_w.size and not np.allclose(live_w, 1.0, atol=1e-9):
            warnings.warn(
                "non-unit scenario weights (importance sampling?): the "
                "SAA inequality E[min] <= min E needs unbiased sample "
                "averages; the certified-bound claim does not cover "
                "self-normalized IS streams")
        if not math.isclose(float(w.sum()), 1.0, rel_tol=1e-6):
            warnings.warn(
                f"epigraph weights sum to {float(w.sum()):.6g} != 1; the "
                "cut-model minimum bounds sum_e w_e E[Q], not E[Q]")

    cut_alpha = _np64(state.cut_alpha)          # [E, K]
    cut_beta = _np64(state.cut_beta)            # [E, K, n1]
    cut_mark = _np64(state.cut_mark)
    cut_live = _np(state.cut_live)
    total_w = np.maximum(_np64(state.total_weight), 1e-30)
    inc_alpha = _np64(state.inc_alpha)
    inc_beta = _np64(state.inc_beta)
    inc_valid = _np(state.inc_valid)

    # variables z = [x (n1); eta (E)]
    obj = np.concatenate([c, w])
    rows_ub, rhs_ub = [], []
    rows_eq, rhs_eq = [], []
    zpad = np.zeros(E)
    for i in range(A1.shape[0]):
        row = np.concatenate([A1[i], zpad])
        if senses1[i] == 0:                      # '=='
            rows_eq.append(row)
            rhs_eq.append(b1[i])
        elif senses1[i] == 1:                    # '>=' -> negate
            rows_ub.append(-row)
            rhs_ub.append(-b1[i])
        else:                                    # '<='
            rows_ub.append(row)
            rhs_ub.append(b1[i])
    for e in range(E if include_state_cuts else 0):
        d = cut_mark[e] / total_w[e]
        for k in range(cut_alpha.shape[1]):
            if not cut_live[e, k]:
                continue
            # eta_e >= d alpha + (1-d) lb + d beta@x
            row = np.concatenate([d[k] * cut_beta[e, k], zpad])
            row[n1 + e] = -1.0
            rows_ub.append(row)
            rhs_ub.append(-(d[k] * cut_alpha[e, k]
                            + (1.0 - d[k]) * lb_e[e]))
        if inc_valid[e]:
            row = np.concatenate([inc_beta[e], zpad])
            row[n1 + e] = -1.0
            rows_ub.append(row)
            rhs_ub.append(-inc_alpha[e])
    for (e, alpha, beta) in (extra_cuts or ()):
        row = np.concatenate([np.asarray(beta, np.float64), zpad])
        row[n1 + int(e)] = -1.0
        rows_ub.append(row)
        rhs_ub.append(-float(alpha))

    bounds = [(lo if np.isfinite(lo) else None,
               hi if np.isfinite(hi) else None)
              for lo, hi in zip(lb1, ub1)]
    bounds += [(float(lb_e[e]) if np.isfinite(lb_e[e]) else None, None)
               for e in range(E)]

    res = scipy.optimize.linprog(
        obj,
        A_ub=np.asarray(rows_ub) if rows_ub else None,
        b_ub=np.asarray(rhs_ub) if rhs_ub else None,
        A_eq=np.asarray(rows_eq) if rows_eq else None,
        b_eq=np.asarray(rhs_eq) if rows_eq else None,
        bounds=bounds, method="highs")
    if res.status != 0:
        raise RuntimeError(
            f"cut-model master LP failed ({res.message}); an unbounded "
            f"status usually means an epigraph has no live cuts and an "
            f"infinite lower bound")
    if return_x:
        return float(res.fun), res.x[:n1].copy(), res.x[n1:].copy()
    return float(res.fun) * obj_scale


def stream_generator(device, seed: int, index: int) -> torch.Generator:
    """The generator of certification stream ``index`` (replication r,
    epigraph e: r * E + e) under ``seed``: the counterpart of the
    reference's ``jax.random.fold_in(PRNGKey(seed), index)``. Distinct
    (seed, index) pairs get independent seeds through numpy's
    SeedSequence."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0]))
    return g


def _certification_streams(states, scenario_model, R, E, N_sd,
                           extra_scenarios, fresh_scenarios, seed,
                           fresh_sampling, fresh_pairing=None):
    """The per-replication certification streams ([R, E, N, Rv] deltas and
    [R, E, N] weights, host f64) and whether the SD run's own cuts may
    enter the bound model: only when the certification stream IS the
    run's own full stream (no fresh replacement, no extension, no
    reservoir overflow). Streams are drawn per replication index r (the
    port has no group split, so r is the global index).

    ``fresh_pairing="antithetic"`` (fresh streams only, R even): the
    replications pair up, and replication 2k+1 certifies on the
    complement (u -> 1 - u) of the stream of replication 2k, stream index
    k * E + e. Every stream keeps its distribution, so each bound stays
    valid; the Student-t interval is then taken over the pair means."""
    # the admissibility decision reads states[0] only: every replication
    # must agree on it
    drops = [int(_np(s.scen_dropped)) for s in states]
    counts = [_np(s.n_scen) for s in states]
    if not all((d == 0) == (drops[0] == 0) for d in drops):
        raise ValueError(
            f"replications disagree on reservoir overflow ({drops}); the "
            "SD-cut admissibility decision is shared: certify these states "
            "separately or use fresh_scenarios")
    if not all(np.array_equal(c, counts[0]) for c in counts):
        raise ValueError(
            "replications disagree on per-epigraph scenario counts; "
            "certify these states separately or use fresh_scenarios")
    if fresh_pairing not in (None, "antithetic"):
        raise ValueError(f"unknown fresh_pairing {fresh_pairing!r}")
    if fresh_pairing and fresh_scenarios <= 0:
        raise ValueError("antithetic pairing pairs fresh certification "
                         "streams: it needs fresh_scenarios > 0")
    if fresh_pairing and R % 2:
        raise ValueError(f"antithetic replication pairing needs an even "
                         f"R, got {R}")
    dev = scenario_model.base.device

    def draws(n, method, paired=False):
        return np.stack([
            np.stack([
                _np64(sample_deltas(
                    stream_generator(dev, seed, (r // 2 if paired else r)
                                     * E + e),
                    scenario_model, n, method=method,
                    complement=paired and bool(r % 2)))
                for e in range(E)])
            for r in range(R)])

    if fresh_scenarios > 0:
        if extra_scenarios != 0:
            raise ValueError("fresh_scenarios replaces the stream; "
                             "extra_scenarios extends it")
        deltas_h = draws(fresh_scenarios, fresh_sampling,
                         paired=fresh_pairing == "antithetic")
        return deltas_h, np.ones(deltas_h.shape[:3]), False
    deltas_h = np.stack([_np64(s.scen_deltas)[:, :N_sd] for s in states])
    weights_h = np.stack([_np64(s.scen_weights)[:, :N_sd] for s in states])
    include_state_cuts = extra_scenarios <= 0 and drops[0] == 0
    if extra_scenarios > 0:
        if not np.allclose(weights_h, 1.0, atol=1e-9):
            raise ValueError("extended certification streams require unit "
                             "scenario weights (plain i.i.d. sampling)")
        extras = draws(extra_scenarios, "iid")
        deltas_h = np.concatenate([deltas_h, extras], axis=2)
        weights_h = np.concatenate(
            [weights_h, np.ones(extras.shape[:3])], axis=2)
    return deltas_h, weights_h, include_state_cuts


def saa_polish(arrays, scenario_model, espec, prep_sub, states: Sequence,
               config, obj_scale: float = 1.0, max_rounds: int = 24,
               gap_tol: float = 1e-4, extra_scenarios: int = 0,
               seed: int = 9000, level_lambda: float = 0.3,
               qp_rows_cap: int = 64, fresh_scenarios: int = 0,
               fresh_sampling: str = "stratified",
               fresh_pairing=None) -> Dict:
    """Level-bundle polish: drive each replication's certified lower bound
    toward its SAA optimum v_N (the port of record's docstring has the
    measurements behind the design).

      round 1   evaluate at each replication's incumbent;
      round k   lb_r = the exact bound-model minimum (host HiGHS f64: the
                valid, monotone bound); evaluate two points per
                replication: the projection of the previous point onto the
                level set {model <= lb + level_lambda (ub - lb)} (one
                R-batched ADMM QP, :func:`solve_qp` over a leading R axis,
                whose model also holds the SD run's own cuts) and the
                bound model's argmin (the Kelley point).

    Every round solves all R * P * E * N recourse LPs in one
    :func:`solve_batch` call, warm-started at the previous round's
    solution (tiled over the point axis when it grows from 1 to 2), and
    assembles the full-weight average cuts on the device in f64: elements
    the solve could not certify take the replication's best pool vertex
    (``seed_dual`` on random-cost instances), 400 projection steps walk
    the duals to dual feasibility, and the exact weak-duality correction
    of what remains enters each alpha. Only the [R, P, E] alpha and value
    panels and the [R, P, E, n1] beta panel come to the host.

    ``extra_scenarios`` / ``fresh_scenarios`` / ``fresh_pairing``: the
    certification streams of :func:`_certification_streams`; on any
    stream but the run's own the SD cuts leave the bound model (they
    still shape the projection QP). ``qp_rows_cap`` (at least 2E) is the
    ring of polish cuts the projection QP holds.

    Returns (bounds unscaled): lb_per_rep (the final exact model minima),
    saa_ub_per_rep (the best SAA value estimate found, the bundle's
    stopping signal, not a bound), gap_per_rep, rounds, cuts_per_rep (per
    replication the (e, alpha, beta) cuts, scaled units, valid for the
    same streams: ``saa_ef_bound(extra_cuts=...)`` takes them),
    dual_infeas_per_rep (the worst relative dual infeasibility left after
    the projection, already corrected for in the alphas), n_scenarios and,
    beyond the port of record, round_seconds (the wall time of each
    evaluated round; every round ends in host reads).
    """
    R = len(states)
    E, K = states[0].cut_alpha.shape
    n_scen = _np(states[0].n_scen)
    for s in states:
        if not np.array_equal(_np(s.n_scen), n_scen):
            raise ValueError("replications must share scenario counts "
                             "(same run length)")
    N_sd = int(n_scen.max())
    if int(n_scen.min()) != N_sd:
        raise ValueError("per-epigraph scenario counts differ")
    if qp_rows_cap < 2 * E:
        raise ValueError(f"qp_rows_cap={qp_rows_cap} cannot hold one "
                         f"round of cuts (2E = {2 * E})")

    f8 = torch.float64
    dt = arrays.c.dtype
    dev = arrays.c.device
    w_e = _np64(espec.obj_weight)
    lb_e = _np64(espec.lower_bound)
    c64 = _np64(arrays.c)
    A1 = _np64(arrays.A1)
    b1 = _np64(arrays.b1)
    senses1 = _np(arrays.senses1)
    lb1 = _np64(arrays.lb1)
    ub1 = _np64(arrays.ub1)
    sm = scenario_model
    has_cost = sm.has_cost
    n1 = c64.shape[0]
    m1 = b1.shape[0]
    m2 = arrays.r.shape[0]
    n2 = arrays.q.shape[0]

    deltas_h, weights_h, include_state_cuts = _certification_streams(
        states, sm, R, E, N_sd, extra_scenarios, fresh_scenarios, seed,
        fresh_sampling, fresh_pairing)
    N = deltas_h.shape[2]
    p_h = weights_h / np.maximum(
        weights_h.sum(axis=2, keepdims=True), 1e-30)   # [R, E, N]
    deltas_d = torch.as_tensor(deltas_h, dtype=dt, device=dev)
    p_d = torch.as_tensor(p_h, dtype=f8, device=dev)

    # per-replication live pools for the epsilon-feasible dual fallback
    pools_d = torch.stack([s.duals for s in states])   # [R, D, m2]
    npool_d = torch.as_tensor([max(int(_np(s.n_duals)), 1) for s in states],
                              device=dev)
    seed_d = sm.seed_dual.to(f8) if has_cost else None

    # ---- on-device f64 cut assembly, all replications at once -----------
    rv_row_d = sm.rv_row.long()
    rv_col_d = sm.rv_col.long()
    rhs_mask = sm.rv_is_rhs
    tr_mask = ~(sm.rv_is_rhs | sm.rv_is_cost) if has_cost \
        else ~sm.rv_is_rhs
    r_d64 = arrays.r.to(f8)
    T_d64 = arrays.T.to(f8)
    fp = _feasproj_consts(arrays)
    lb2, ub2 = arrays.lb2.to(f8), arrays.ub2.to(f8)
    lb_ok, ub_ok = torch.isfinite(lb2), torch.isfinite(ub2)
    lbf = torch.where(lb_ok, lb2, 0.0)
    ubf = torch.where(ub_ok, ub2, 0.0)
    q64 = arrays.q.to(f8)
    qn_pol = float(1.0 + np.abs(_np64(arrays.q)).max())

    def assemble(Pi, valid, obj, H, Q_el, cap, P):
        """Pi / H [R, P*E*N, m2]; valid / obj [R, P*E*N]; Q_el [R, P*E*N,
        n2] per-element costs (random-cost instances) or None; cap [n2]
        correction cap. Returns (alpha [R, P, E], beta [R, P, E, n1],
        vals [R, P, E], vmax [R]) in f64."""
        PEN = Pi.shape[1]
        if has_cost:
            sub = seed_d.expand(R, PEN, m2)
        else:
            live = (torch.arange(pools_d.shape[1], device=dev)[None, :, None]
                    < npool_d[:, None, None])
            sc = torch.where(live, pools_d @ H.transpose(1, 2), -math.inf)
            win = torch.argmax(sc, dim=1)                  # [R, PEN]
            sub = torch.gather(pools_d, 1,
                               win[..., None].expand(R, PEN, m2))
        Pi_use = torch.where(valid[..., None], Pi, sub).to(f8)
        q_el = Q_el.to(f8).reshape(R * PEN, n2) if has_cost \
            else q64[None, :]
        Pi_use = _feasproj_run(fp, Pi_use.reshape(R * PEN, m2), q_el, 400)
        red = (q_el - Pi_use @ fp["W64"]).reshape(R, PEN, n2)
        viol = (torch.where(fp["ub_inf"], torch.clamp(-red, min=0.0), 0.0)
                + torch.where(fp["lb_inf"], torch.clamp(red, min=0.0), 0.0))
        vmax = torch.amax(viol, dim=(1, 2)) / qn_pol
        term = torch.where(
            red >= 0.0,
            torch.where(lb_ok, red * lbf, -red * cap),
            torch.where(ub_ok, red * ubf, red * cap))
        corr_el = term.sum(-1).reshape(R, P, E, N)
        PiR = Pi_use.reshape(R, P, E, N, m2)
        d64 = deltas_d.to(f8)                              # [R, E, N, Rv]
        pi_rows = PiR[..., rv_row_d]                       # [R, P, E, N, Rv]
        rhs_del = torch.where(rhs_mask, d64, 0.0)
        alpha = (torch.einsum("ren,rpenm,m->rpe", p_d, PiR, r_d64)
                 + torch.einsum("ren,renv,rpenv->rpe", p_d, rhs_del,
                                pi_rows)
                 + torch.einsum("ren,rpen->rpe", p_d, corr_el))
        pibar = torch.einsum("ren,rpenm->rpem", p_d, PiR)
        beta = -torch.einsum("rpem,mk->rpek", pibar, T_d64)
        tr = torch.einsum("ren,renv,rpenv->rpev", p_d,
                          torch.where(tr_mask, d64, 0.0), pi_rows)
        beta = beta.index_add(-1, rv_col_d,
                              -torch.where(tr_mask, tr, 0.0))
        vals = torch.einsum("ren,rpen->rpe", p_d,
                            obj.reshape(R, P, E, N).to(f8))
        return alpha, beta, vals, vmax

    # ---- R-batched level-projection QP ----------------------------------
    # Static row layout: stage-1 | x bounds | eta >= lb_e | the SD run's
    # own cut pool + incumbent cuts (frozen during the polish) | a
    # qp_rows_cap ring of polish cuts | level.
    nz = n1 + E
    sd_rows = E * K + E
    n_rows = m1 + n1 + E + sd_rows + qp_rows_cap + 1
    p_diag = torch.as_tensor(np.concatenate([np.ones(n1), np.zeros(E)]),
                             dtype=dt, device=dev).expand(R, nz)
    is_eq = torch.as_tensor(np.concatenate(
        [senses1 == 0, np.zeros(n_rows - m1, bool)]), device=dev)
    A_base = np.zeros((n_rows, nz))
    l_base = np.full(n_rows, -np.inf)
    u_base = np.full(n_rows, np.inf)
    A_base[:m1, :n1] = A1
    l_base[:m1] = np.where(senses1 == -1, -np.inf, b1)   # '<=' rows
    u_base[:m1] = np.where(senses1 == 1, np.inf, b1)     # '>=' rows
    A_base[m1:m1 + n1, :n1] = np.eye(n1)
    l_base[m1:m1 + n1] = lb1
    u_base[m1:m1 + n1] = ub1
    A_base[m1 + n1:m1 + n1 + E, n1:] = np.eye(E)
    l_base[m1 + n1:m1 + n1 + E] = lb_e
    A_base[-1] = np.concatenate([c64, w_e])              # level row
    A_b = np.broadcast_to(A_base, (R,) + A_base.shape).copy()
    l_b = np.broadcast_to(l_base, (R, n_rows)).copy()
    u_b = np.broadcast_to(u_base, (R, n_rows)).copy()
    off_sd = m1 + n1 + E
    for r in range(R):
        st = states[r]
        d = _np64(st.cut_mark) / np.maximum(
            _np64(st.total_weight)[:, None], 1e-30)
        livec = _np(st.cut_live)
        a_c = _np64(st.cut_alpha)
        b_c = _np64(st.cut_beta)
        for e in range(E):
            for k in range(K):
                if not livec[e, k]:
                    continue
                row = off_sd + e * K + k
                A_b[r, row, :n1] = -d[e, k] * b_c[e, k]
                A_b[r, row, n1 + e] = 1.0
                l_b[r, row] = d[e, k] * a_c[e, k] + (1 - d[e, k]) * lb_e[e]
        inc_v = _np(st.inc_valid)
        a_i = _np64(st.inc_alpha)
        b_i = _np64(st.inc_beta)
        for e in range(E):
            if not inc_v[e]:
                continue
            row = off_sd + E * K + e
            A_b[r, row, :n1] = -b_i[e]
            A_b[r, row, n1 + e] = 1.0
            l_b[r, row] = a_i[e]

    qp_cfg = dataclasses.replace(config.qp, warm_retry=False)
    on_dev = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    z0 = torch.zeros((R, nz), dtype=dt, device=dev)
    mu0 = torch.zeros((R, n_rows), dtype=dt, device=dev)

    cuts: list = [[] for _ in range(R)]
    ring = 0                                           # next QP cut slot
    off_ring = off_sd + sd_rows
    centers = np.stack([_np64(s.x_incumbent) for s in states])
    lb = np.full(R, -np.inf)
    ub = np.full(R, np.inf)
    gap = np.full(R, np.inf)
    dual_infeas = np.zeros(R)
    x_kelley = centers.copy()
    prev_YL = None
    rounds = 0
    lb_rich = np.full(R, -np.inf)
    round_s = []

    def model_min(r, with_state_cuts):
        return cut_model_min(
            arrays, espec, states[r], check_validity=False,
            extra_cuts=cuts[r], include_state_cuts=with_state_cuts,
            return_x=True)

    for rounds in range(1, max_rounds + 1):
        t_round = time.perf_counter()
        if include_state_cuts or cuts[0]:
            # the Kelley companion chases the BOUND model's argmin: cuts
            # land where the reported bound is attained
            for r in range(R):
                lb[r], x_kelley[r], _ = model_min(r, include_state_cuts)
        if include_state_cuts:
            lb_rich = lb                   # the bound model is the QP's
        else:
            # the rich model (SD cuts + polish cuts) drives the level: it
            # matches the projection QP's rows, so the level set is never
            # empty
            for r in range(R):
                lb_rich[r], _, _ = model_min(r, True)
        if rounds > 1:
            gap = (ub - lb) / (1.0 + np.abs(ub))
            if gap.max() <= gap_tol:
                rounds -= 1
                break
        if rounds == 1:
            X = centers[:, None, :]                    # [R, 1, n1]
        else:
            level = lb_rich + level_lambda * (ub - lb_rich)
            g_b = np.concatenate([-centers, np.zeros((R, E))], axis=1)
            u_b[:, -1] = level
            z, mu, _ = solve_qp(p_diag, on_dev(g_b), on_dev(A_b),
                                on_dev(l_b), on_dev(u_b), is_eq, qp_cfg,
                                z0=z0, mu0=mu0)
            z0, mu0 = z, mu
            Xq = _np64(z)[:, :n1]
            X = np.zeros((R, 2, n1))
            for r in range(R):
                xr = Xq[r]
                if not np.all(np.isfinite(xr)):
                    # degenerate projection: a stabilized Kelley step
                    xr = 0.7 * centers[r] + 0.3 * x_kelley[r]
                xr = np.clip(xr, lb1, ub1)
                X[r, 0], _ = project_first_stage(arrays, xr)
                X[r, 1] = x_kelley[r]                  # the Kelley point
        P = X.shape[1]
        Xd = on_dev(X)
        H = torch.cat([
            _scenario_rhs(arrays, sm, deltas_d[r].reshape(E * N, -1),
                          Xd[r, pp])
            for r in range(R) for pp in range(P)])     # [R*P*E*N, m2]
        if has_cost:
            Q = cost_panel(sm, deltas_d[:, None].expand(
                R, P, E, N, deltas_d.shape[-1]).reshape(R * P * E * N, -1),
                arrays.q)
        else:
            Q = None
        if prev_YL is not None and prev_YL[0].shape[0] == R * P * E * N:
            Y0, L0 = prev_YL
        elif prev_YL is not None:
            # P grew (round 1 -> 2): tile the previous solution over the
            # new per-replication point axis
            Pp = prev_YL[0].shape[0] // (R * E * N)

            def tile(a):
                return a.reshape(R, Pp, E * N, -1)[:, :1].expand(
                    R, P, E * N, a.shape[-1]).reshape(R * P * E * N, -1)

            Y0, L0 = tile(prev_YL[0]), tile(prev_YL[1])
        else:
            Y0 = L0 = None
        obj, Y, Pi, stats = solve_batch(prep_sub, H, config.pdhg, Y0=Y0,
                                        L0=L0, Q=Q)
        prev_YL = (Y, Pi)
        cap = 10.0 * (1.0 + torch.amax(torch.abs(Y.to(f8)), dim=0))
        alpha_all, beta_all, vals_all, vmax_all = assemble(
            Pi.reshape(R, P * E * N, m2),
            stats["pdhg_valid"].reshape(R, P * E * N),
            obj.reshape(R, P * E * N), H.reshape(R, P * E * N, m2),
            None if Q is None else Q.reshape(R, P * E * N, n2), cap, P)
        dual_infeas = np.maximum(dual_infeas, _np64(vmax_all))
        alpha_all = _np64(alpha_all)                   # [R, P, E]
        beta_all = _np64(beta_all)                     # [R, P, E, n1]
        vals_all = _np64(vals_all)                     # [R, P, E]

        for r in range(R):
            for pp in range(P):
                for e in range(E):
                    alpha, beta = alpha_all[r, pp, e], beta_all[r, pp, e]
                    cuts[r].append((e, alpha, beta))
                    row = off_ring + ((ring + pp * E + e) % qp_rows_cap)
                    A_b[r, row, :n1] = -beta
                    A_b[r, row, n1:] = 0.0
                    A_b[r, row, n1 + e] = 1.0
                    l_b[r, row] = alpha
                    u_b[r, row] = np.inf
                # the exact-sample SAA value at each point: the bundle's
                # upper bound (PDHG's objective error only moves the
                # stopping signal)
                ub[r] = min(ub[r],
                            float(c64 @ X[r, pp] + w_e @ vals_all[r, pp]))
        ring += P * E
        centers = X[:, 0]
        round_s.append(time.perf_counter() - t_round)

    for r in range(R):
        lb[r], _, _ = cut_model_min(
            arrays, espec, states[r],
            check_validity=(r == 0 and include_state_cuts),
            extra_cuts=cuts[r], include_state_cuts=include_state_cuts,
            return_x=True)
    gap = (ub - lb) / (1.0 + np.abs(ub))
    return {
        "lb_per_rep": lb * obj_scale,
        "saa_ub_per_rep": ub * obj_scale,
        "gap_per_rep": gap,
        "rounds": rounds,
        "cuts_per_rep": cuts,
        "dual_infeas_per_rep": dual_infeas,
        "n_scenarios": N,
        "round_seconds": round_s,
    }


def _feasproj_consts(arrays) -> Dict:
    """Device constants of the dual-feasibility projection: f64 W, the
    sign-cone masks, the infinite-direction masks and the gradient step
    1/||W||_2^2 (host power iteration)."""
    senses2 = _np(arrays.senses2)
    Wh = _np64(arrays.W)
    v = np.cos(np.arange(Wh.shape[1]) * 0.37 + 0.2)
    for _ in range(30):
        v = Wh.T @ (Wh @ v)
        v /= max(np.linalg.norm(v), 1e-30)
    L_w = float(v @ (Wh.T @ (Wh @ v)))                     # ||W||_2^2
    dev = arrays.W.device
    return {
        "W64": arrays.W.to(torch.float64),
        "pos": torch.as_tensor(senses2 == SENSE_G, device=dev),
        "neg": torch.as_tensor(senses2 == SENSE_L, device=dev),
        "ub_inf": ~torch.isfinite(arrays.ub2),
        "lb_inf": ~torch.isfinite(arrays.lb2),
        "step": 1.0 / max(L_w, 1e-30),
    }


def _feasproj_run(c: Dict, Pi: torch.Tensor, q_s: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """Projected gradient descent on the squared infinite-direction dual
    violation f(pi) = 0.5 ||masked relu(W'pi - q_s)||^2 with a sign-cone
    projection each step: moves a batch of epsilon-feasible duals to the
    dual-feasible set by about their violation (f64 matmuls). Pi: [B, m2];
    q_s: [B, n2] or [1, n2]."""
    W = c["W64"]
    # a mask that holds everywhere (or nowhere) needs no select: the
    # same numbers with fewer passes over the [B, n2] panel
    up_all, lo_none = bool(c["ub_inf"].all()), not bool(c["lb_inf"].any())
    for _ in range(iters):
        red = Pi @ W - q_s
        g = torch.clamp(red, min=0.0)
        if not up_all:
            g = torch.where(c["ub_inf"], g, 0.0)
        if not lo_none:
            g = g - torch.where(c["lb_inf"], torch.clamp(-red, min=0.0),
                                0.0)
        Pi = Pi - c["step"] * (g @ W.T)
        Pi = torch.where(c["pos"], torch.clamp(Pi, min=0.0), Pi)
        Pi = torch.where(c["neg"], torch.clamp(Pi, max=0.0), Pi)
    return Pi


def _refine_recourse_duals(arrays, scenario_model, deltas_u, x_ef, Y_ef, pt,
                           chunk: int = 8192, pg_iters: int = 2500):
    """Minimal-movement f64 feasibility polish of the EF dual panel (the
    port of record's docstring has the measurements behind it).

    Args (tensors on the instance's device): deltas_u [R, EN, Rv]
    certification deltas; x_ef [R, n1]; Y_ef [R, EN, n2] EF second-stage
    blocks; pt [R, EN, m2] recourse duals (original units).

    Returns (pt_polished [R, EN, m2], H [R, EN, m2] recourse rhs panels,
    Ymax [n2] max |y| observed, n_unrefined=0), host f64.
    """
    arrays64 = _to64(arrays)
    model64 = _to64(scenario_model)
    consts = _feasproj_consts(arrays)
    R, EN, m2 = pt.shape
    pt_out = np.empty((R, EN, m2), np.float64)
    H_out = np.empty((R, EN, m2), np.float64)
    Ymax = _np64(Y_ef.abs().amax(dim=(0, 1)))
    for r in range(R):
        d64 = deltas_u[r].to(torch.float64)
        H_out[r] = _np64(_scenario_rhs(arrays64, model64, d64,
                                       x_ef[r].to(torch.float64)))
        Q_r = (cost_panel(model64, d64, arrays64.q)
               if scenario_model.has_cost else None)
        for lo in range(0, EN, chunk):
            hi = min(lo + chunk, EN)
            q_c = arrays64.q[None, :] if Q_r is None else Q_r[lo:hi]
            pt_out[r, lo:hi] = _np64(_feasproj_run(
                consts, pt[r, lo:hi].to(torch.float64), q_c, pg_iters))
    return pt_out, H_out, Ymax, 0


def _cost_rows(scenario_model, deltas: np.ndarray,
               q64: np.ndarray) -> np.ndarray:
    """Per-scenario stage-2 costs q_s [N, n2] of host f64 deltas [N, Rv]."""
    dev = scenario_model.rv_is_cost.device
    return _np64(cost_panel(scenario_model,
                            torch.as_tensor(deltas, device=dev),
                            torch.as_tensor(q64, device=dev)))


def _lagrangian_corrections(arrays, scenario_model, deltas_re, pt_re,
                            Ymax, qn):
    """Exact weak-duality correction terms for epsilon-feasible duals
    (host f64): for any row-sign-feasible pi, Q(x, xi_s) >= pi'(r_s - T_s
    x) + sum_j min over y_j in [lb_j, ub_j] of red_j y_j with red = q_s -
    W'pi; the sum is the per-scenario correction (exactly 0 for
    dual-feasible pi on lb = 0 columns, a capped estimate 10 (1 + max|y|)
    where the active bound is infinite).

    Args: deltas_re / pt_re [N, Rv] / [N, m2], one replication's panel.
    Returns (corr [N], relv [N] max relative violation per scenario).
    """
    W64 = _np64(arrays.W)
    q64 = _np64(arrays.q)
    lb64 = _np64(arrays.lb2)
    ub64 = _np64(arrays.ub2)
    q_s = _cost_rows(scenario_model, deltas_re, q64) \
        if scenario_model.has_cost else q64[None, :]
    red = q_s - pt_re @ W64                               # [N, n2]
    viol = np.maximum(-red, 0.0)
    relv = viol.max(axis=1) / qn
    cap = 10.0 * (1.0 + Ymax)
    lb_ok = np.isfinite(lb64)
    ub_ok = np.isfinite(ub64)
    term_pos = np.where(lb_ok[None, :], red * np.where(lb_ok, lb64, 0.0),
                        -red * cap[None, :])
    term_neg = np.where(ub_ok[None, :], red * np.where(ub_ok, ub64, 0.0),
                        red * cap[None, :])
    term = np.where(red >= 0.0, term_pos, term_neg)
    return term.sum(axis=1), relv


# the defaults of saa_ef_bound's refine_tol (the f64 continuation's
# tolerance) and host_exact_cap (the most scenarios per replication
# re-solved exactly on the host)
REFINE_TOL = 1e-6
HOST_EXACT_CAP = 1024


def saa_ef_bound(arrays, scenario_model, espec, states: Sequence,
                 config, obj_scale: float = 1.0,
                 extra_scenarios: int = 0, seed: int = 9000,
                 ef_config=None, extra_cuts: Optional[Sequence] = None,
                 refine_f64: Optional[bool] = None,
                 refine_tol: float = REFINE_TOL,
                 refine_iters: int = 4000,
                 fresh_scenarios: int = 0,
                 fresh_sampling: str = "stratified",
                 fresh_pairing=None,
                 refine_duals: bool = True,
                 refine_mode: str = "project",
                 refine_duals_tol: float = 1e-7,
                 host_exact_cap: int = HOST_EXACT_CAP) -> Dict:
    """SAA lower bound from extensive-form dual certificates.

    For each replication, solve the sample-average extensive form over
    its certification stream (all R in one batched solve, then an f64
    continuation warm-started at the f32 solution), and turn the
    per-scenario duals into ONE aggregate cut per epigraph: alpha_e =
    sum_s p_s pi_s' r_s, beta_e = -sum_s p_s (T_s)' pi_s. The exact
    minimum of c'x + sum_e w_e max(cut_e, lb_e) over the first-stage
    polytope (host HiGHS f64, :func:`cut_model_min`) is the bound.

    Validity, in three layers: with ``refine_duals`` (the default) the
    minimal-movement projection (``refine_mode="project"``, the only mode
    ported) walks the duals to dual feasibility, while
    ``refine_duals=False`` takes the raw EF duals; scenarios still
    violating above 1e-3 relative are re-solved exactly on the host (at
    most ``host_exact_cap`` per replication, the worst first); the
    remaining epsilon is deducted from each cut by the exact weak-duality
    correction (``cut_correction_per_rep``). Certificates past 5e-2
    relative violation are rejected: their bound is reported as -inf.
    ``refine_duals_tol`` is accepted as in the port of record, whose
    projection does not read it either: it runs a fixed 2500 steps.

    ``fresh_scenarios`` replaces each replication's stream by a fresh one
    (``fresh_sampling``, Latin hypercube by default); ``extra_scenarios``
    extends the SD stream with fresh i.i.d. draws (the SD cuts then leave
    the bound model); ``fresh_pairing`` as in
    :func:`_certification_streams`. ``extra_cuts`` (per replication a
    list of (e, alpha, beta), scaled units, valid for the same streams:
    :func:`saa_polish`'s ``cuts_per_rep`` under the same seed) joins the
    aggregate cuts in each final cut-model minimum. ``refine_f64=False``
    skips the f64 continuation (None or True runs it), which stops at
    ``refine_tol`` or ``refine_iters`` iterations.

    Returns lb_per_rep, x_ef_per_rep, ef_obj_per_rep, ef_err_per_rep,
    dual_infeas_per_rep, cut_correction_per_rep, host_exact_count,
    n_unrefined (R·E·N raw duals without ``refine_duals``, else 0),
    n_scenarios (bounds unscaled), and, beyond the port of record,
    ef_iters_per_rep / refine_iters_per_rep (the two passes; 0 without
    the continuation),
    ef_err_first_per_rep (the first pass's error) and ``seconds``: the
    wall time of the f32 EF solve (``ef``), the f64 continuation
    (``refine``), the dual projection (``projection``) and the host part
    (``host``: corrections, exact re-solves, aggregate cuts, HiGHS).
    """
    if refine_mode == "resolve":
        raise ValueError(
            "refine_mode='resolve' is not ported: per-scenario re-solves land "
            "on other optimal vertices of degenerate recourse and crash the "
            "aggregate cut to the epigraph floor (measured on ssn); use "
            "'project' or refine_duals=False")
    if refine_mode != "project":
        raise ValueError(f"unknown refine_mode {refine_mode!r}")
    R = len(states)
    E = int(states[0].cut_alpha.shape[0])
    n_scen = _np(states[0].n_scen)
    N_sd = int(n_scen.max())
    if int(n_scen.min()) != N_sd:
        raise ValueError("per-epigraph scenario counts differ")

    deltas_h, weights_h, include_state_cuts = _certification_streams(
        states, scenario_model, R, E, N_sd, extra_scenarios,
        fresh_scenarios, seed, fresh_sampling, fresh_pairing)
    N = deltas_h.shape[2]
    p_h = weights_h / np.maximum(
        weights_h.sum(axis=2, keepdims=True), 1e-30)     # [R, E, N]
    w_e = _np64(espec.obj_weight)
    # the probability layout is shared by every replication
    if not np.allclose(w_e[:, None] * p_h, (w_e[:, None] * p_h[0])[None]):
        raise ValueError("replications disagree on scenario weights")

    dt = arrays.c.dtype
    dev = arrays.c.device
    deltas_u = torch.as_tensor(deltas_h.reshape(R, E * N, -1), dtype=dt,
                               device=dev)
    probs_u = torch.as_tensor((w_e[:, None] * p_h[0]).reshape(E * N),
                              dtype=dt, device=dev)

    if ef_config is None:
        # one decade below the production subproblem tolerance: at 1e-4
        # the EF duals' slopes are too noisy for a tight aggregate cut
        if config.pdhg.tol > 1e-5:
            ef_config = dataclasses.replace(
                config.pdhg, tol=1e-5,
                max_iters=max(config.pdhg.max_iters, 400_000))
        else:
            ef_config = config.pdhg
    seconds = {}
    t0 = time.perf_counter()
    x_ef, obj_ef, stats, duals, Y_ef, u0_ef = solve_extensive_form(
        arrays, scenario_model, deltas_u, probs_u, ef_config,
        return_duals=True)
    seconds["ef"] = time.perf_counter() - t0
    ef_iters = _np(stats["ef_iters"])
    ef_err_first = _np64(stats["ef_err"])

    # f64 continuation warm-started at the f32 solution: the f32 duals'
    # per-scenario feasibility floors near the f32 roundoff of the
    # p_s-scaled objective; a short f64 continuation has no such floor
    f8 = torch.float64
    refine_iters_done = np.zeros(R, np.int64)
    seconds["refine"] = 0.0
    if refine_f64 is None or refine_f64:
        t0 = time.perf_counter()
        cfg64 = dataclasses.replace(ef_config, tol=refine_tol,
                                    max_iters=refine_iters)
        x_ef, obj_ef, stats64, duals, Y_ef, u0_ef = solve_extensive_form(
            _to64(arrays), _to64(scenario_model), deltas_u.to(f8),
            probs_u.to(f8), cfg64, return_duals=True, x0=x_ef.to(f8),
            Y0=Y_ef.to(f8), U0=duals.to(f8), u00=u0_ef.to(f8))
        seconds["refine"] = time.perf_counter() - t0
        ef_err = _np64(stats64["ef_err"])
        refine_iters_done = _np(stats64["ef_iters"])
    else:
        ef_err = ef_err_first

    # per-scenario recourse duals: EF block duals over their weights
    pt = duals / torch.clamp(torch.as_tensor(
        (w_e[:, None] * p_h).reshape(R, E * N), dtype=f8,
        device=dev)[..., None], min=1e-30)

    t0 = time.perf_counter()
    qn = float(1.0 + np.max(np.abs(_np64(arrays.q))))
    if refine_duals:
        pt_h, H_h, Ymax, n_unrefined = _refine_recourse_duals(
            arrays, scenario_model, deltas_u, x_ef, Y_ef, pt)
    else:
        # the raw EF duals (a copy: the host-exact repair writes into it)
        pt_h = np.array(_np64(pt))
        H_h = np.stack([
            _np64(_scenario_rhs(arrays, scenario_model, deltas_u[r], x_ef[r]))
            for r in range(R)])
        Ymax = _np64(Y_ef.abs().amax(dim=(0, 1)))
        n_unrefined = R * E * N
    seconds["projection"] = time.perf_counter() - t0

    # host-exact repair of the worst offenders, then the exact
    # weak-duality correction on whatever epsilon remains
    t0 = time.perf_counter()
    W64h = _np64(arrays.W)
    q64h = _np64(arrays.q)
    lb64h = _np64(arrays.lb2)
    ub64h = _np64(arrays.ub2)
    senses2_h = _np(arrays.senses2)
    deltas_uh = deltas_h.reshape(R, E * N, -1)
    corr = np.zeros((R, E * N), np.float64)
    dual_infeas = np.zeros(R, np.float64)
    host_exact_count = 0
    for r in range(R):
        corr_r, relv = _lagrangian_corrections(
            arrays, scenario_model, deltas_uh[r], pt_h[r], Ymax, qn)
        # 1e-3, not smaller: a cold exact vertex on degenerate recourse
        # destroys the aggregate cut's joint slope structure; mild epsilon
        # goes through the corrections instead
        fix = np.flatnonzero(relv > 1e-3)
        if fix.size > host_exact_cap:
            warnings.warn(
                f"replication {r}: {fix.size} certification scenarios "
                f"still violate dual feasibility > 1e-3 after the f64 "
                f"refinement; repairing only the worst {host_exact_cap} "
                f"on the host (the rest carry exact corrections)")
            fix = fix[np.argsort(relv[fix])[::-1][:host_exact_cap]]
        for s in fix:
            qs = (_cost_rows(scenario_model, deltas_uh[r, s:s + 1],
                             q64h)[0]
                  if scenario_model.has_cost else q64h)
            try:
                _, _, pi_exact = solve_lp_host(
                    qs, W64h, H_h[r, s], senses2_h, lb64h, ub64h)
            except RuntimeError:
                continue                     # keep the corrected epsilon
            pt_h[r, s] = pi_exact
            host_exact_count += 1
        if fix.size:
            corr_r, relv = _lagrangian_corrections(
                arrays, scenario_model, deltas_uh[r], pt_h[r], Ymax, qn)
        corr[r] = corr_r
        dual_infeas[r] = float(relv.max())
    if dual_infeas.max() > 1e-3:
        warnings.warn(
            f"EF dual certificates remain poorly feasible after repair "
            f"(max relative reduced-cost violation {dual_infeas.max():.2e},"
            f" ef_err {ef_err.max():.2e}); the weak-duality corrections "
            f"keep the bound valid but it may be far below the SAA "
            f"optimum: raise ef_config.max_iters")
    cert_bad = dual_infeas > 5e-2

    # aggregate cuts, exact f64 on the host
    sm = scenario_model
    rv_row = _np(sm.rv_row).astype(np.int64)
    rv_col = _np(sm.rv_col).astype(np.int64)
    rv_is_rhs = _np(sm.rv_is_rhs)
    rv_is_cost = _np(sm.rv_is_cost) if sm.has_cost \
        else np.zeros_like(rv_is_rhs)
    r64 = _np64(arrays.r)
    T64 = _np64(arrays.T)
    pt_h = pt_h.reshape(R, E, N, -1)
    corr = corr.reshape(R, E, N)
    lb = np.zeros(R)
    for r in range(R):
        cuts_r = list(extra_cuts[r]) if extra_cuts is not None else []
        for e in range(E):
            p = p_h[r, e]
            Pi_re = pt_h[r, e]
            pi_rows = Pi_re[:, rv_row]
            rhs_d = np.where(rv_is_rhs[None, :], deltas_h[r, e], 0.0)
            alpha = (p @ (Pi_re @ r64)
                     + np.sum(p[:, None] * rhs_d * pi_rows)
                     + p @ corr[r, e])
            beta = -(T64.T @ (p @ Pi_re))
            not_tr = rv_is_rhs | rv_is_cost.astype(bool)
            tr = np.where(not_tr[None, :], 0.0,
                          p[:, None] * deltas_h[r, e] * pi_rows)
            np.subtract.at(beta, rv_col, tr.sum(axis=0))
            cuts_r.append((e, alpha, beta))
        lb[r], _, _ = cut_model_min(
            arrays, espec, states[r], check_validity=(r == 0),
            extra_cuts=cuts_r, include_state_cuts=include_state_cuts,
            return_x=True)
    seconds["host"] = time.perf_counter() - t0
    if cert_bad.any():
        warnings.warn(
            f"{int(cert_bad.sum())}/{R} EF certificates rejected "
            f"(dual infeasibility > 5e-2); their bounds are reported as "
            f"-inf: this instance needs a larger EF iteration budget")
        lb = np.where(cert_bad, -np.inf, lb)
    return {
        "lb_per_rep": lb * obj_scale,
        # the EF argmins: free first-stage candidates (x is never
        # objective-scaled)
        "x_ef_per_rep": _np64(x_ef),
        "ef_obj_per_rep": _np64(obj_ef) * obj_scale,
        "ef_err_per_rep": ef_err,
        "dual_infeas_per_rep": dual_infeas,
        # objective-weighted total correction folded into each
        # replication's cuts, unscaled (negative = deduction)
        "cut_correction_per_rep": np.einsum(
            "e,ren,ren->r", w_e, p_h, corr) * obj_scale,
        "host_exact_count": host_exact_count,
        "n_unrefined": n_unrefined,
        "n_scenarios": N,
        "ef_iters_per_rep": ef_iters,
        "ef_err_first_per_rep": ef_err_first,
        "refine_iters_per_rep": refine_iters_done,
        "seconds": seconds,
    }


def t_lower_bound(per_rep: np.ndarray, confidence: float = 0.95,
                  pair_means: bool = False) -> Dict:
    """Student-t aggregation of i.i.d. per-replication bounds: mean -
    t_{R-1,conf} std / sqrt(R). ``pair_means=True`` aggregates the R/2
    means of consecutive (antithetic) pairs instead. A non-finite
    per-replication bound (a rejected certificate) gives lb_cert -inf with
    a warning naming the replications."""
    import scipy.stats

    per_rep = np.asarray(per_rep, np.float64)
    if pair_means:
        if per_rep.shape[0] % 2:
            raise ValueError("pairing needs an even R")
        per_rep = 0.5 * (per_rep[0::2] + per_rep[1::2])
    R = per_rep.shape[0]
    if not np.all(np.isfinite(per_rep)):
        bad = np.flatnonzero(~np.isfinite(per_rep)).tolist()
        warnings.warn(
            f"replications {bad} carry non-finite lower bounds (rejected "
            f"or failed certificates); lb_cert is -inf: re-run those "
            f"replications with a larger certification budget")
        return {
            "lb_cert": -math.inf,
            "lb_mean": -math.inf,
            "lb_half_width": math.inf,
            "lb_per_rep": per_rep,
            "confidence": confidence,
            "n_replications": R,
        }
    mean = float(per_rep.mean())
    if R > 1:
        t = float(scipy.stats.t.ppf(0.5 * (1.0 + confidence), R - 1))
        hw = t * float(per_rep.std(ddof=1)) / math.sqrt(R)
    else:
        hw = math.inf
        warnings.warn("one replication gives no variance estimate; "
                      "lb_cert is -inf: run R >= 2 replications")
    return {
        "lb_cert": mean - hw,
        "lb_mean": mean,
        "lb_half_width": hw,
        "lb_per_rep": per_rep,
        "confidence": confidence,
        "n_replications": R,
    }


def certified_lower_bound(arrays, espec, states: Sequence,
                          obj_scale: float = 1.0,
                          confidence: float = 0.95) -> Dict:
    """The model route: each replication's exact cut-model minimum
    (:func:`cut_model_min`) aggregated by :func:`t_lower_bound`.

    Also returns ``dual_infeas_per_rep``, a diagnostic (reported, not
    deducted): the worst relative infinite-direction reduced-cost
    violation over each replication's live dual pool, the feasibility
    epsilon the SD cuts inherit from the subproblem solver.
    """
    R = len(states)
    if R < 1:
        raise ValueError("no replication states")
    per_rep = np.array([
        cut_model_min(arrays, espec, s, obj_scale=obj_scale,
                      check_validity=(r == 0))
        for r, s in enumerate(states)])
    out = t_lower_bound(per_rep, confidence)
    Wh = _np64(arrays.W)
    q = _np64(arrays.q)
    qn = 1.0 + np.abs(q).max()
    ub_inf = ~np.isfinite(_np64(arrays.ub2))
    lb_inf = ~np.isfinite(_np64(arrays.lb2))
    infeas = np.zeros(R)
    for r, s in enumerate(states):
        nd = int(_np(s.n_duals))
        if nd == 0:
            continue
        red = q[None, :] - _np64(s.duals)[:nd] @ Wh
        viol = (np.where(ub_inf[None, :], np.maximum(-red, 0.0), 0.0)
                + np.where(lb_inf[None, :], np.maximum(red, 0.0), 0.0))
        infeas[r] = viol.max() / qn
    out["dual_infeas_per_rep"] = infeas
    return out
