"""Cut machinery: argmax over the dual pool, SASA cut assembly, epigraph
evaluation.

Port of record: ``sqlp_tpu/sd/cuts.py`` (``quantized_argmax`` :42-67,
``argmax_duals`` :70-96, ``build_sasa_cut`` :99-192, ``eval_dual`` :195,
``evaluate_epigraph`` :206-222, ``evaluate_multi_epigraph`` :225-232).
The score panel is one [D, R] x [R, S] matmul plus a base mat-vec; the
pick is the tiling-invariant quantized argmax, kept because matmul tiling
on the card flips near-ties just as it did between TPU meshes.
``torch.argmax`` returns the first maximum, like ``jnp.argmax``.

``build_sasa_cut(..., mesh=)`` builds the same cut from a sharded state
(``parallel/mesh.py``): the sums over scenarios are partial sums over the
rank's scenario block added over the scenario axis, the argmax over a
sharded pool is ``global_quantized_argmax`` over the dual axis, and the
winners' rows come from their owners (``gather_rows``). On a 1-D mesh
with ``shard_duals`` the pool and the scenarios shard over the same axis,
so no rank holds both operands of a [D_i, S_j] score block with i != j and
one operand has to move: the scenario block does. Each rank all-gathers
the axis's scenario deltas [S_local, R] and weights [S_local], S (R + 1)
elements on every rank (1.4 MB at ssn's S = 4096, R = 86 in float32),
rather than the pool's rows [D_local, m2] (m2 = 175 on ssn); the step's
scenario sums then run over the whole store on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sqlp_tpu_torch.models.scenario import effective_rhs_deltas
from sqlp_tpu_torch.parallel.mesh import (gather, gather_rows,
                                          global_quantized_argmax, offset_of,
                                          psum)


class Cut(NamedTuple):
    """eta >= alpha + beta @ x."""

    alpha: torch.Tensor
    beta: torch.Tensor


def quantized_argmax(scores: torch.Tensor) -> torch.Tensor:
    """Tiling-invariant argmax over axis 0 of a [D, S] score panel: scores
    are floored to a quantum relative to the per-column best (1e-4 in f32,
    1e-9 in f64) so ties inside a cell resolve to the lowest pool index."""
    eps = 1e-4 if scores.dtype == torch.float32 else 1e-9
    best = torch.amax(scores, dim=0)
    quantum = torch.where(torch.isfinite(best), eps * (1.0 + torch.abs(best)),
                          torch.ones_like(best))
    return torch.argmax(torch.floor(scores / quantum), dim=0)


def argmax_duals(duals: torch.Tensor, n_duals: torch.Tensor,
                 base: torch.Tensor, rv_row: torch.Tensor,
                 eff_deltas: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scenario argmax over the live pool: scores[d, s] = pi_d @ (base
    + scatter(eff_deltas[s])). Returns (max value [S], argmax [S])."""
    D = duals.shape[0]
    base_scores = duals @ base
    delta_scores = duals[:, rv_row.long()] @ eff_deltas.T
    scores = base_scores[:, None] + delta_scores
    live = (torch.arange(D, device=duals.device) < n_duals)[:, None]
    scores = torch.where(live, scores, torch.full_like(scores,
                                                       float("-inf")))
    return torch.amax(scores, dim=0), quantized_argmax(scores)


def build_sasa_cut(arrays, model, duals: torch.Tensor,
                   n_duals: torch.Tensor, scen_deltas: torch.Tensor,
                   scen_weights: torch.Tensor, total_weight: torch.Tensor,
                   x: torch.Tensor, with_counts: bool = False, mesh=None):
    """One SASA cut for one epigraph at x:

        alpha = sum_s p_s pi_s @ (r + dr_s),  beta = -sum_s p_s (T + dT_s)' pi_s

    with p_s = weight_s / sum(stored weights) and pi_s the pool argmax for
    scenario s. Random-cost instances mask dual-infeasible (vertex,
    scenario) pairs and add the universally feasible seed dual as a
    virtual pool row. With ``with_counts`` also returns the per-vertex
    argmax win mass (the pool's eviction score signal). With a ``mesh``
    the stores and the pool are this rank's blocks, the counts too.
    """
    if mesh is not None:
        return _build_sasa_cut_mesh(arrays, model, duals, n_duals,
                                    scen_deltas, scen_weights, x,
                                    with_counts, mesh)
    rv_row = model.rv_row.long()
    eff = effective_rhs_deltas(model, scen_deltas, x)
    base = arrays.r - arrays.T @ x
    if model.has_cost:
        duals = torch.cat([duals, model.seed_dual[None, :].to(duals.dtype)])
        D = duals.shape[0]
        scores = (duals @ base)[:, None] + duals[:, rv_row] @ eff.T
        live = torch.cat([torch.arange(D - 1, device=duals.device) < n_duals,
                          torch.ones(1, dtype=torch.bool,
                                     device=duals.device)])
        ninf = torch.full_like(scores, float("-inf"))
        scores = torch.where(live[:, None], scores, ninf)
        for k, j in model.cost_idx:
            slack = duals @ arrays.W[:, j] - model.base[k]
            tol_k = 1e-4 * (1.0 + torch.abs(model.base[k]))
            viol = slack[:, None] > scen_deltas[:, k][None, :] + tol_k
            scores = torch.where(viol, ninf, scores)
        best = quantized_argmax(scores)
    else:
        _, best = argmax_duals(duals, n_duals, base, model.rv_row, eff)

    wsum = torch.sum(scen_weights)
    p = scen_weights / torch.clamp_min(wsum, 1e-30)
    # per-vertex win mass as a one-hot product, not a scatter-add: many
    # scenarios share a vertex, and a scatter-add on the card sums them by
    # atomics in an order that changes run to run, so a seeded run would
    # not repeat itself
    slots = torch.arange(duals.shape[0], device=p.device)
    counts = (slots[:, None] == best[None, :]).to(p.dtype) @ p
    pi_at_rows = duals[:, rv_row][best]

    zero = torch.zeros((), dtype=scen_deltas.dtype, device=p.device)
    rhs_delta = torch.where(model.rv_is_rhs[None, :], scen_deltas, zero)
    alpha = (counts @ (duals @ arrays.r)
             + torch.sum(p * torch.sum(rhs_delta * pi_at_rows, dim=1)))
    pi_bar = counts @ duals
    beta = -(arrays.T.T @ pi_bar)
    not_tr = (model.rv_is_rhs | model.rv_is_cost) if model.has_cost \
        else model.rv_is_rhs
    tr_contrib = torch.where(not_tr[None, :], zero,
                             p[:, None] * scen_deltas * pi_at_rows)
    beta = beta.index_add(0, model.rv_col.long(), -torch.sum(tr_contrib,
                                                             dim=0))
    cut = Cut(alpha=alpha, beta=beta)
    if with_counts:
        return cut, (counts[:-1] if model.has_cost else counts)
    return cut


def _build_sasa_cut_mesh(arrays, model, duals, n_duals, scen_deltas,
                         scen_weights, x, with_counts, mesh):
    """``build_sasa_cut`` on a rank's blocks (module docstring). The
    scenario sums are taken with the weights and normalized after the sum
    over the scenario axis; the seed dual of a random-cost instance is the
    virtual row D (the pool's global capacity), replicated, and counted
    once."""
    s_ax, d_ax = mesh.scen_axis, mesh.dual_axis
    if d_ax is s_ax:
        scen_deltas = gather(scen_deltas, s_ax, 0)
        scen_weights = gather(scen_weights, s_ax, 0)
        s_ax = None
    dt, dev = scen_deltas.dtype, scen_deltas.device
    rv_row = model.rv_row.long()
    eff = effective_rhs_deltas(model, scen_deltas, x)
    base = arrays.r - arrays.T @ x
    D_loc = duals.shape[0]
    d_off = offset_of(d_ax, D_loc)
    index = d_off + torch.arange(D_loc, device=dev)
    live = index < n_duals
    rows = duals
    if model.has_cost:
        D_seed = D_loc * (1 if d_ax is None else d_ax.size)
        seed = model.seed_dual.to(dt)
        rows = torch.cat([duals, seed[None, :]])
        index = torch.cat([index, torch.full((1,), D_seed, device=dev)])
        live = torch.cat([live, torch.ones(1, dtype=torch.bool, device=dev)])
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    scores = (rows @ base)[:, None] + rows[:, rv_row] @ eff.T
    scores = torch.where(live[:, None], scores, ninf)
    if model.has_cost:
        for k, j in model.cost_idx:
            slack = rows @ arrays.W[:, j] - model.base[k]
            tol_k = 1e-4 * (1.0 + torch.abs(model.base[k]))
            viol = slack[:, None] > scen_deltas[:, k][None, :] + tol_k
            scores = torch.where(viol, ninf, scores)
    best = global_quantized_argmax(scores, d_ax, index)

    w = scen_weights
    counts_w = (index[:, None] == best[None, :]).to(dt) @ w
    pi_at_rows = gather_rows(duals[:, rv_row], best, d_ax, d_off)
    if model.has_cost:
        pi_at_rows = torch.where((best == D_seed)[:, None], seed[rv_row],
                                 pi_at_rows)
    zero = torch.zeros((), dtype=dt, device=dev)
    rhs_delta = torch.where(model.rv_is_rhs[None, :], scen_deltas, zero)
    alpha_w = torch.sum(w * torch.sum(rhs_delta * pi_at_rows, dim=1))
    not_tr = (model.rv_is_rhs | model.rv_is_cost) if model.has_cost \
        else model.rv_is_rhs
    tr_w = torch.sum(torch.where(not_tr[None, :], zero,
                                 w[:, None] * scen_deltas * pi_at_rows),
                     dim=0)
    n_rows = rows.shape[0]
    # one sum over the scenario axis: the weight, the win mass, the
    # scenario parts of alpha and of beta
    tot = psum(torch.cat([torch.sum(w)[None], counts_w, alpha_w[None],
                          tr_w]), s_ax)
    wsum = torch.clamp_min(tot[0], 1e-30)
    counts = tot[1:1 + n_rows] / wsum
    alpha_s = tot[1 + n_rows] / wsum
    tr = tot[2 + n_rows:] / wsum
    # one sum over the dual axis: the pool's parts of alpha and pi_bar
    pool = counts[:D_loc]
    tot = psum(torch.cat([(pool @ (duals @ arrays.r))[None], pool @ duals]),
               d_ax)
    alpha = tot[0] + alpha_s
    pi_bar = tot[1:]
    if model.has_cost:
        alpha = alpha + counts[D_loc] * (seed @ arrays.r)
        pi_bar = pi_bar + counts[D_loc] * seed
    beta = -(arrays.T.T @ pi_bar)
    beta = beta.index_add(0, model.rv_col.long(), -tr)
    cut = Cut(alpha=alpha, beta=beta)
    if with_counts:
        return cut, pool
    return cut


def eval_dual(arrays, model, delta: torch.Tensor, x: torch.Tensor,
              pi: torch.Tensor) -> torch.Tensor:
    """pi' ((r + dr) - (T + dT) x) for one scenario delta [R]."""
    eff = effective_rhs_deltas(model, delta[None, :], x)[0]
    base = arrays.r - arrays.T @ x
    return pi @ base + pi[model.rv_row.long()] @ eff


def evaluate_epigraph(cut_alpha, cut_beta, cut_mark, cut_live, inc_alpha,
                      inc_beta, inc_valid, total_weight, lower_bound,
                      x: torch.Tensor) -> torch.Tensor:
    """Pointwise max over discounted cuts, the undiscounted incumbent cut
    and the lower bound, unweighted. Cut value: d (alpha + beta @ x) +
    (1 - d) lb with d = weight_mark / total. Leading axes broadcast, so
    [E, K] cut arrays evaluate all epigraphs at once."""
    d = cut_mark / torch.clamp_min(total_weight[..., None], 1e-30)
    vals = d * (cut_alpha + cut_beta @ x) + (1.0 - d) * lower_bound[..., None]
    vals = torch.where(cut_live, vals, torch.full_like(vals, float("-inf")))
    best = torch.maximum(lower_bound, torch.amax(vals, dim=-1))
    inc_val = inc_alpha + inc_beta @ x
    return torch.maximum(best, torch.where(
        inc_valid, inc_val, torch.full_like(inc_val, float("-inf"))))


def evaluate_multi_epigraph(state, espec, x: torch.Tensor) -> torch.Tensor:
    """Objective-weighted sum over epigraphs."""
    per_epi = evaluate_epigraph(
        state.cut_alpha, state.cut_beta, state.cut_mark, state.cut_live,
        state.inc_alpha, state.inc_beta, state.inc_valid,
        state.total_weight, espec.lower_bound, x)
    return torch.sum(espec.obj_weight * per_epi)
