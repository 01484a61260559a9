"""Compromise decisions across SD replications.

Port of record: ``sqlp_tpu/sd/compromise.py`` (``_merge_states`` :34-58,
``compromise_decision`` :61-115). After R independent SD replications the
compromise problem (Sen & Liu)

    min_x  c@x + (1/R) sum_r F_r(x) + rho/2 ||x - x_bar||^2

with F_r replication r's cut model and x_bar the average of the
incumbents is assembled by concatenating the replications' cut pools into
one multi-epigraph state, the machinery of the per-iteration master, and
solved by the ADMM QP. ``polish_decision`` is not ported (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from sqlp_tpu_torch.config import QPConfig
from sqlp_tpu_torch.models.routines import project_first_stage
from sqlp_tpu_torch.ops.prox_qp import solve_qp
from sqlp_tpu_torch.sd.master import assemble_master
from sqlp_tpu_torch.sd.state import EpigraphSpec, SDState

_MERGED = ("cut_alpha", "cut_beta", "cut_mark", "cut_live", "cut_dual",
           "cut_x", "inc_alpha", "inc_beta", "inc_valid", "total_weight")


def _merge_states(states: Sequence[SDState], especs: Sequence[EpigraphSpec],
                  scale: float) -> Tuple[SDState, EpigraphSpec]:
    """Concatenate the replications' epigraphs into one state; weights
    scaled by ``scale`` (1/R: the merged objective is the average)."""
    merged = dataclasses.replace(states[0], **{
        f: torch.cat([getattr(s, f) for s in states]) for f in _MERGED})
    espec = EpigraphSpec(
        obj_weight=torch.cat([e.obj_weight * scale for e in especs]),
        lower_bound=torch.cat([e.lower_bound for e in especs]))
    return merged, espec


def compromise_decision(inst, states: Sequence[SDState],
                        especs: Sequence[EpigraphSpec], rho: float = 1.0,
                        qp_config: QPConfig = QPConfig(),
                        obj_scale: float = 1.0) -> Tuple[np.ndarray, dict]:
    """Solve the compromise problem over the replications' cut models.

    ``rho`` is the prox weight toward the incumbent average in user units;
    ``obj_scale`` is the replications' ``SDSolver.obj_scale`` (their cut
    pools live in scaled units). The result is clipped to the variable box
    and projected onto the first-stage polytope when a row is still
    violated. Returns (x_compromise, info) with the QP stats, the
    incumbent average ``x_bar`` and the per-replication incumbents.
    """
    R = len(states)
    if R < 1 or len(especs) != R:
        raise ValueError(f"{R} states and {len(especs)} epigraph specs")
    x_bar = torch.mean(torch.stack([s.x_incumbent for s in states]), dim=0)

    arrays = inst.arrays
    if obj_scale != 1.0:
        arrays = dataclasses.replace(arrays, c=arrays.c / obj_scale,
                                     q=arrays.q / obj_scale)
        rho = rho / obj_scale
    merged, espec = _merge_states(states, especs, 1.0 / R)
    merged = dataclasses.replace(merged, x_incumbent=x_bar)
    rho_t = torch.tensor(rho, dtype=arrays.c.dtype, device=arrays.c.device)
    z, _, stats = solve_qp(*assemble_master(arrays, espec, merged, rho_t),
                           qp_config)
    host = lambda t: t.detach().cpu().numpy()
    x = np.clip(np.asarray(host(z[:inst.n1]), np.float64),
                np.asarray(host(inst.arrays.lb1), np.float64),
                np.asarray(host(inst.arrays.ub1), np.float64))
    x, proj_dist = project_first_stage(inst.arrays, x)
    info = {
        "x_bar": host(x_bar),
        "incumbents": [host(s.x_incumbent) for s in states],
        "projection_distance": proj_dist,
        **{k: host(v) for k, v in stats.items()},
    }
    return x, info
