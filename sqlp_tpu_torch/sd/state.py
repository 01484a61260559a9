"""SD solver state: one dataclass of fixed-capacity tensors.

Port of record: ``sqlp_tpu/sd/state.py`` (``EpigraphSpec`` :31-42,
``SDState`` :45-120, ``master_rows`` :123, ``init_state`` :129-179,
``default_epigraph_spec`` :182-192). Scenario stores and the dual pool
are pre-allocated with live counts, cut pools recycle slots, exactly as in
the reference package, so a state reads and writes the ``.npz`` schema of
``sqlp_tpu/utils/checkpoint.py:25-42`` (:func:`state_to_numpy`,
:func:`state_from_numpy`). The JAX PRNG ``key`` field has no counterpart:
the solver's ``torch.Generator`` stands in its place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from sqlp_tpu_torch.config import SDConfig


@dataclasses.dataclass(frozen=True)
class EpigraphSpec:
    """Per-epigraph objective weights and recourse lower bounds."""

    obj_weight: torch.Tensor   # [E]
    lower_bound: torch.Tensor  # [E]

    @property
    def n_epi(self) -> int:
        return int(self.obj_weight.shape[0])


@dataclasses.dataclass(frozen=True)
class SDState:
    """Full algorithm state carried between iterations."""

    it: torch.Tensor            # int32 iteration counter
    # scenario stores (per epigraph)
    scen_deltas: torch.Tensor   # [E, S, R]
    scen_weights: torch.Tensor  # [E, S]
    n_scen: torch.Tensor        # [E] int32
    n_stream: torch.Tensor      # [E] int32 stream position
    total_weight: torch.Tensor  # [E]
    scen_dropped: torch.Tensor  # int32
    # shared dual-vertex pool
    duals: torch.Tensor         # [D, m2]
    duals_rounded: torch.Tensor  # [D, m2]
    n_duals: torch.Tensor       # int32
    duals_dropped: torch.Tensor  # int32
    duals_score: torch.Tensor   # [D]
    # cut pools
    cut_alpha: torch.Tensor     # [E, K]
    cut_beta: torch.Tensor      # [E, K, n1]
    cut_mark: torch.Tensor      # [E, K]
    cut_live: torch.Tensor      # [E, K] bool
    cut_dual: torch.Tensor      # [E, K]
    cut_x: torch.Tensor         # [E, K, n1]
    # incumbent cuts
    inc_alpha: torch.Tensor     # [E]
    inc_beta: torch.Tensor      # [E, n1]
    inc_valid: torch.Tensor     # [E] bool
    # solutions
    x_candidate: torch.Tensor   # [n1]
    x_incumbent: torch.Tensor   # [n1]
    # improvement info
    cand_est: torch.Tensor
    inc_est: torch.Tensor
    req_improvement: torch.Tensor
    is_improved: torch.Tensor   # bool
    # prox-weight schedule registers
    quad_scalar: torch.Tensor
    normDk_1: torch.Tensor
    normDk_init: torch.Tensor   # bool
    # crossover adaptive gate
    xover_dry: torch.Tensor     # int32
    # master solve bookkeeping
    master_solved: torch.Tensor  # bool
    master_z: torch.Tensor      # [n1+E]
    master_mu: torch.Tensor     # [mA]
    master_rho: torch.Tensor    # scalar
    # subproblem warm starts for the [2*E*B] panel
    sub_warm_Y: torch.Tensor    # [2*E*B, n2]
    sub_warm_L: torch.Tensor    # [2*E*B, m2]

    @property
    def n_epi(self) -> int:
        return int(self.cut_alpha.shape[0])


def master_rows(n1: int, m1: int, E: int, K: int) -> int:
    """Row count of the assembled master QP (layout in sd/master.py)."""
    return m1 + n1 + E * K + E


def init_state(inst, espec: EpigraphSpec, config: SDConfig,
               x0) -> SDState:
    """Fresh state at x_candidate = x_incumbent = x0, on the instance's
    device."""
    E = espec.n_epi
    S, D, K = config.max_scenarios, config.max_dual_vertices, config.max_cuts
    n1, m1, m2 = inst.n1, inst.m1, inst.m2
    R = inst.n_rv
    dt = config.jdtype
    dev = inst.device

    def f(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def i32(shape=()):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def b(shape=()):
        return torch.zeros(shape, dtype=torch.bool, device=dev)

    def s(v):
        return torch.tensor(v, dtype=dt, device=dev)

    x0 = torch.as_tensor(np.asarray(x0), dtype=dt, device=dev)
    return SDState(
        it=i32(),
        scen_deltas=f((E, S, R)), scen_weights=f((E, S)),
        n_scen=i32((E,)), n_stream=i32((E,)), total_weight=f((E,)),
        scen_dropped=i32(),
        duals=f((D, m2)), duals_rounded=f((D, m2)), n_duals=i32(),
        duals_dropped=i32(), duals_score=f((D,)),
        cut_alpha=f((E, K)), cut_beta=f((E, K, n1)), cut_mark=f((E, K)),
        cut_live=b((E, K)), cut_dual=f((E, K)),
        cut_x=x0.expand((E, K) + x0.shape).clone(),
        inc_alpha=f((E,)), inc_beta=f((E, n1)), inc_valid=b((E,)),
        x_candidate=x0, x_incumbent=x0.clone(),
        cand_est=s(float("nan")), inc_est=s(float("nan")),
        req_improvement=s(0.0), is_improved=b(),
        quad_scalar=s(config.quad_scalar_init), normDk_1=s(0.0),
        normDk_init=b(),
        xover_dry=i32(),
        master_solved=b(),
        master_z=f((n1 + E,)),
        master_mu=f((master_rows(n1, m1, E, K),)),
        master_rho=s(config.qp.rho),
        sub_warm_Y=f((2 * E * config.scenarios_per_iter, inst.n2)),
        sub_warm_L=f((2 * E * config.scenarios_per_iter, m2)),
    )


def default_epigraph_spec(n_epi: int = 1, obj_weight=1.0, lower_bound=0.0,
                          dtype: torch.dtype = torch.float32,
                          device="cpu") -> EpigraphSpec:
    """Uniform epigraph spec (one epigraph of weight 1 is the common
    case)."""
    w = np.full(n_epi, obj_weight, np.float64) if np.isscalar(obj_weight) \
        else np.asarray(obj_weight, np.float64)
    lb = np.full(n_epi, lower_bound, np.float64) \
        if np.isscalar(lower_bound) else np.asarray(lower_bound, np.float64)
    if not w.shape == lb.shape == (n_epi,):
        raise ValueError(f"obj_weight {w.shape} and lower_bound {lb.shape} "
                         f"must both have shape ({n_epi},)")
    return EpigraphSpec(
        obj_weight=torch.as_tensor(w, dtype=dtype, device=device),
        lower_bound=torch.as_tensor(lb, dtype=dtype, device=device))


def state_to_numpy(state: SDState) -> Dict[str, np.ndarray]:
    """Field name -> host array, the payload of the reference package's
    ``.npz`` checkpoint (without its PRNG ``key``)."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}


def state_from_numpy(fields, template: SDState) -> SDState:
    """State from a mapping of field name -> array (an ``.npz`` written by
    ``sqlp_tpu.utils.checkpoint.save_state`` qualifies; its ``key`` and
    metadata entries are ignored). Shapes are checked against
    ``template``, whose dtypes and device are adopted."""
    out = {}
    for f in dataclasses.fields(SDState):
        t = getattr(template, f.name)
        if f.name not in fields:
            raise ValueError(f"state field {f.name} missing")
        a = np.array(fields[f.name])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"state field {f.name}: shape {a.shape} != "
                             f"configured {tuple(t.shape)} (capacities "
                             f"must match)")
        out[f.name] = torch.as_tensor(a, device=t.device).to(t.dtype)
    return SDState(**out)
