"""Scenario model: padded marginal tables + batched sampler, on tensors.

Port of record: ``sqlp_tpu/models/scenario.py`` (``ScenarioModel`` :52-89,
``build_scenario_model`` :92-196, ``_compute_seed_dual`` :199-257,
``sample_values``/``sample_deltas`` :290-357, ``values_to_deltas`` :360,
``deltas_to_rhs`` :418, ``effective_rhs_deltas`` :429, ``cost_panel``
:447). The tables are compiled by the same host numpy code, then placed on
the requested device. Sampling draws from an explicit ``torch.Generator``;
it cannot reproduce the JAX PRNG stream, so the tests hand both packages
the same numpy deltas instead. Only ``method="iid"`` is ported.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from sqlp_tpu_torch.models.smps_sto import (DiscreteDistribution,
                                            NormalDistribution, StoData,
                                            UniformDistribution)
from sqlp_tpu_torch.models.smps_tim import Position
from sqlp_tpu_torch.models.stage import SENSE_G, SENSE_L, StageLP

DIST_DISCRETE, DIST_NORMAL, DIST_UNIFORM = 0, 1, 2

# tensor fields in declaration order (the static flags follow)
SCENARIO_FIELDS = ("rv_row", "rv_is_rhs", "rv_col", "base", "dist_type",
                   "values", "cdf", "mean", "std", "left", "width",
                   "rv_is_cost", "rv_ycol", "seed_dual")
_FLOAT_FIELDS = ("base", "values", "cdf", "mean", "std", "left", "width",
                 "seed_dual")


@dataclasses.dataclass(frozen=True)
class ScenarioModel:
    """Padded per-position marginals, ready for batched device sampling."""

    rv_row: torch.Tensor        # [R] int, stage-2 constraint row index
    rv_is_rhs: torch.Tensor     # [R] bool
    rv_col: torch.Tensor        # [R] int (0 where is_rhs)
    base: torch.Tensor          # [R] template value at the position
    dist_type: torch.Tensor     # [R] int in {DISCRETE, NORMAL, UNIFORM}
    values: torch.Tensor        # [R, V] outcome values (padded with last)
    cdf: torch.Tensor           # [R, V] inclusive CDF (padded with 1)
    mean: torch.Tensor          # [R]
    std: torch.Tensor           # [R]
    left: torch.Tensor          # [R]
    width: torch.Tensor         # [R]
    rv_is_cost: torch.Tensor    # [R] bool
    rv_ycol: torch.Tensor       # [R] int (0 where not cost)
    seed_dual: torch.Tensor     # [m2]
    has_cost: bool = False
    seed_valid: bool = False
    cost_idx: tuple = ()        # ((position k, ycol j), ...)

    @property
    def n_rv(self) -> int:
        return int(self.rv_row.shape[0])


def scenario_model_from_numpy(fields, has_cost: bool = False,
                              seed_valid: bool = False, cost_idx=(),
                              dtype: torch.dtype = torch.float32,
                              device="cpu") -> ScenarioModel:
    """Tensors from a mapping of field name -> array-like (for example the
    JAX package's ScenarioModel read through ``np.asarray``)."""
    t = {}
    for name in SCENARIO_FIELDS:
        a = np.array(fields[name])
        if name in _FLOAT_FIELDS:
            t[name] = torch.as_tensor(a, dtype=dtype, device=device)
        else:
            t[name] = torch.as_tensor(a, device=device)
    return ScenarioModel(**t, has_cost=bool(has_cost),
                         seed_valid=bool(seed_valid),
                         cost_idx=tuple((int(k), int(j))
                                        for k, j in cost_idx))


def build_scenario_model(sto: StoData, sp2: StageLP,
                         dtype: torch.dtype = torch.float32, device="cpu",
                         dual_system=None) -> ScenarioModel:
    """Compile a parsed sto file against the stage-2 template
    (``sqlp_tpu/models/scenario.py:92-196``)."""
    positions: List[Position] = list(sto.indep.keys())
    R = len(positions)
    row_lookup = sp2.row_lookup
    col_lookup = sp2.col_lookup
    cur_lookup = sp2.cur_lookup

    v_max = 1
    for d in sto.indep.values():
        if isinstance(d, DiscreteDistribution):
            v_max = max(v_max, len(d.value))

    rv_row = np.zeros(R, np.int32)
    rv_is_rhs = np.zeros(R, bool)
    rv_col = np.zeros(R, np.int32)
    rv_is_cost = np.zeros(R, bool)
    rv_ycol = np.zeros(R, np.int32)
    base = np.zeros(R, np.float64)
    dist_type = np.zeros(R, np.int32)
    values = np.zeros((R, v_max), np.float64)
    cdf = np.ones((R, v_max), np.float64)
    mean = np.zeros(R, np.float64)
    std = np.zeros(R, np.float64)
    left = np.zeros(R, np.float64)
    width = np.zeros(R, np.float64)

    for k, pos in enumerate(positions):
        if pos.row_name == sp2.obj_row_name and sp2.obj_row_name:
            if pos.col_name not in cur_lookup:
                raise ValueError(
                    f"Cost position col {pos.col_name} not a stage-2 var")
            j = cur_lookup[pos.col_name]
            rv_is_cost[k] = True
            rv_ycol[k] = j
            base[k] = sp2.c[j]
        else:
            if pos.row_name not in row_lookup:
                raise ValueError(f"Random position row {pos.row_name} not "
                                 f"in stage-2 template")
            i = row_lookup[pos.row_name]
            rv_row[k] = i
            if pos.col_name in ("RHS", "rhs"):
                rv_is_rhs[k] = True
                base[k] = sp2.rhs[i]
            else:
                if pos.col_name not in col_lookup:
                    raise ValueError(f"Random position col {pos.col_name} "
                                     f"not a last-stage var")
                j = col_lookup[pos.col_name]
                rv_col[k] = j
                base[k] = sp2.T[i, j]

        d = sto.indep[pos]
        if isinstance(d, DiscreteDistribution):
            dist_type[k] = DIST_DISCRETE
            vals = np.asarray(d.value, np.float64)
            probs = np.asarray(d.probability, np.float64)
            n = len(vals)
            values[k, :n] = vals
            values[k, n:] = vals[-1]
            c = np.cumsum(probs) / probs.sum()
            cdf[k, :n] = c
            cdf[k, n:] = 1.0
        elif isinstance(d, NormalDistribution):
            dist_type[k] = DIST_NORMAL
            mean[k] = d.mean
            std[k] = np.sqrt(d.variance)
        elif isinstance(d, UniformDistribution):
            dist_type[k] = DIST_UNIFORM
            left[k] = d.left
            width[k] = d.right - d.left
        else:
            raise TypeError(f"Unknown distribution {type(d)}")

    has_cost = bool(rv_is_cost.any())
    if dual_system is None:
        dual_system = (sp2.W, sp2.rhs, sp2.senses)
    m2 = len(dual_system[1])
    seed_dual = np.zeros(m2, np.float64)
    seed_valid = False
    if has_cost:
        seed_dual, seed_valid = _compute_seed_dual(
            sp2, dual_system, rv_is_cost, rv_ycol, dist_type, values,
            mean, std, left)

    return scenario_model_from_numpy(
        dict(rv_row=rv_row, rv_is_rhs=rv_is_rhs, rv_col=rv_col, base=base,
             dist_type=dist_type, values=values, cdf=cdf, mean=mean,
             std=std, left=left, width=width, rv_is_cost=rv_is_cost,
             rv_ycol=rv_ycol, seed_dual=seed_dual),
        has_cost=has_cost, seed_valid=seed_valid,
        cost_idx=tuple((int(k), int(rv_ycol[k]))
                       for k in np.flatnonzero(rv_is_cost)),
        dtype=dtype, device=device)


def _compute_seed_dual(sp2: StageLP, dual_system, rv_is_cost, rv_ycol,
                       dist_type, values, mean, std, left,
                       normal_sigmas: float = 10.0):
    """A dual vector feasible for every scenario's dual polytope
    (``sqlp_tpu/models/scenario.py:199-257``): one host LP."""
    import warnings

    import scipy.optimize

    q_min = np.asarray(sp2.c, np.float64).copy()
    for k in np.flatnonzero(rv_is_cost):
        j = int(rv_ycol[k])
        if dist_type[k] == DIST_DISCRETE:
            lo = float(values[k].min())
        elif dist_type[k] == DIST_NORMAL:
            lo = float(mean[k] - normal_sigmas * std[k])
        else:
            lo = float(left[k])
        q_min[j] = min(q_min[j], lo)

    W_sys, r_sys, s_sys = dual_system
    W = np.asarray(W_sys, np.float64)
    r = np.asarray(r_sys, np.float64)
    senses = np.asarray(s_sys)
    bounds = [(0.0, None) if s == SENSE_G else
              (None, 0.0) if s == SENSE_L else (None, None)
              for s in senses]
    for c_obj in (-r, np.zeros_like(r)):
        res = scipy.optimize.linprog(c_obj, A_ub=W.T, b_ub=q_min,
                                     bounds=bounds, method="highs")
        if res.status == 0:
            return np.asarray(res.x, np.float64), True
        if res.status != 3:
            break
    warnings.warn(
        "no universally feasible dual exists for the random-cost support "
        "(recourse unbounded at the support-minimum cost q_min); SD cut "
        "generation cannot be certified — use the extensive-form solver "
        "or tighten the cost distribution's support")
    return np.zeros(len(r), np.float64), False


def sample_values(generator: torch.Generator, model: ScenarioModel,
                  batch: int, method: str = "iid") -> torch.Tensor:
    """Draw a [batch, R] panel of raw scenario values: inverse-CDF lookup
    for discrete positions, affine maps of uniform / normal draws for the
    others. ``generator`` must live on the model's device."""
    if method != "iid" and batch > 1:
        raise NotImplementedError(
            f"sampling method {method!r} is not ported yet (ROADMAP A2: "
            f"antithetic, stratified, LHS); use 'iid'")
    R = model.n_rv
    dt = model.values.dtype
    dev = model.values.device
    u = torch.rand((batch, R), generator=generator, dtype=dt, device=dev)
    z = torch.randn((batch, R), generator=generator, dtype=dt, device=dev)
    idx = torch.sum(u[:, :, None] >= model.cdf[None, :, :], dim=-1)
    idx = torch.clamp(idx, 0, model.values.shape[1] - 1)
    discrete = torch.gather(
        model.values.expand(batch, R, model.values.shape[1]), 2,
        idx[:, :, None])[..., 0]
    normal = model.mean + model.std * z
    uniform = model.left + model.width * u
    return torch.where(model.dist_type == DIST_DISCRETE, discrete,
                       torch.where(model.dist_type == DIST_NORMAL, normal,
                                   uniform))


def sample_deltas(generator: torch.Generator, model: ScenarioModel,
                  batch: int, method: str = "iid") -> torch.Tensor:
    """[batch, R] panel of deltas against the template (value - base)."""
    return sample_values(generator, model, batch, method) - model.base


def values_to_deltas(model: ScenarioModel, values) -> torch.Tensor:
    """Raw scenario values [..., R] (sto-position order) -> deltas."""
    return torch.as_tensor(values, dtype=model.base.dtype,
                           device=model.base.device) - model.base


def deltas_to_rhs(model: ScenarioModel, deltas: torch.Tensor,
                  m2: int) -> torch.Tensor:
    """Scatter an RHS-position delta panel [..., R] to dense [..., m2];
    transfer positions contribute 0 here."""
    d = torch.where(model.rv_is_rhs, deltas, torch.zeros_like(deltas))
    out = torch.zeros(deltas.shape[:-1] + (m2,), dtype=deltas.dtype,
                      device=deltas.device)
    return out.index_add_(-1, model.rv_row.long(), d)


def effective_rhs_deltas(model: ScenarioModel, deltas: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Per-position effective RHS contribution at a fixed first-stage x:
    the delta itself for RHS positions, -delta * x[col] for transfer
    positions, 0 for cost positions. Returns [..., R]."""
    tr = -deltas * x[..., model.rv_col.long()]
    if model.has_cost:
        tr = torch.where(model.rv_is_cost, torch.zeros_like(tr), tr)
    return torch.where(model.rv_is_rhs, deltas, tr)


def cost_panel(model: ScenarioModel, deltas: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """Per-scenario stage-2 objective q_s = q + scatter(cost deltas):
    [..., R] -> [..., n2]."""
    d = torch.where(model.rv_is_cost, deltas,
                    torch.zeros_like(deltas)).to(q.dtype)
    out = q.expand(deltas.shape[:-1] + q.shape).clone()
    return out.index_add_(-1, model.rv_ycol.long(), d)
