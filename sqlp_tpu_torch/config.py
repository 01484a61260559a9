"""Solver configuration.

Port of record: ``sqlp_tpu/config.py``. The dataclasses keep their field
names and defaults, except that the Pallas switches (``use_pallas``,
``pallas_exact_small``) are gone: a CUDA tensor always goes to the
hand-written kernel and a CPU tensor to its plain PyTorch version, so the
device of the data decides and nothing turns the kernel off on the card.
``SDConfig.jdtype`` is a ``torch.dtype`` here.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PDHGConfig:
    """Batched first-order LP parameters (subproblem solver); field
    meanings as in ``sqlp_tpu/config.py:19-66``."""

    tol: float = 1e-7
    valid_tol: float = 1e-4
    stall_rounds: int = 50
    restart_every: int = 80
    max_iters: int = 20_000
    omega_smoothing: float = 0.5
    ruiz_iters: int = 10
    compaction: bool = True
    compact_min_batch: int = 2048
    # "halpern" (reflected Halpern, kernel pdhg_halpern_round) or
    # "average" (restart to the Polyak average, kernel pdhg_average_round)
    scheme: str = "halpern"


@dataclasses.dataclass(frozen=True)
class QPConfig:
    """Master proximal-QP (OSQP-style ADMM) parameters; field meanings as
    in ``sqlp_tpu/config.py:69-141``."""

    tol: float = 1e-8
    max_iters: int = 4_000
    check_every: int = 25
    sigma: float = 1e-6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    over_relax: float = 1.6
    stall_rounds: int = 6
    stall_restarts: int = 4
    stall_tol_factor: float = 10.0
    stall_hard_windows: int = 0
    warm_retry: bool = True
    warm_retry_factor: float = 50.0


@dataclasses.dataclass(frozen=True)
class SDConfig:
    """Full SD solver configuration (``sqlp_tpu/config.py:144-271``).

    Capacities stay fixed-size tensors with live counts/masks, as in the
    reference package, so states checkpoint to the same ``.npz`` schema.
    """

    cut_remove_tolerance: float = 1e-3
    incumbent_q: float = 0.2
    dual_sig_bits: int = 16
    dual_score_decay: float = 0.95

    quad_schedule: str = "constant"
    quad_scalar_init: float = 0.1
    quad_min: float = 1e-3
    quad_max: float = 1e4
    quad_r2: float = 0.95
    quad_r3: float = 2.0
    quad_tolerance: float = 1e-3

    max_scenarios: int = 4096
    max_dual_vertices: int = 2048
    max_cuts: int = 96
    scenarios_per_iter: int = 1

    # "iid", "antithetic" or "stratified" (the latter two act on batches
    # of more than one scenario)
    sampling: str = "iid"

    update_incumbent_cut: bool = True
    # rebuild every live cut against the current pool every this many
    # iterations (0: never)
    cut_refresh_every: int = 0
    pool_dual_warm_start: bool = True
    dual_crossover: bool = True
    crossover_dry_limit: int = 64

    dtype: str = "float32"
    normalize_objective: bool = True

    pdhg: PDHGConfig = dataclasses.field(default_factory=PDHGConfig)
    qp: QPConfig = dataclasses.field(
        default_factory=lambda: QPConfig(
            stall_rounds=3, stall_restarts=1, stall_hard_windows=10))

    @property
    def jdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "SDConfig":
        return dataclasses.replace(self, **kw)


def _pow2ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def autoscale_capacities(config: SDConfig, n_iters: int,
                         n_epi: int = 1, mesh_devices: int = 0) -> SDConfig:
    """Shrink pool capacities to what ``n_iters`` iterations can fill
    (``sqlp_tpu/config.py:278-304``); the scenario capacity stays a
    multiple of ``mesh_devices``, the ranks of the mesh's scenario axis."""
    need_s = max(64, _pow2ceil(n_iters * config.scenarios_per_iter))
    if mesh_devices and mesh_devices > 1:
        need_s = max(need_s, _pow2ceil(mesh_devices))
        need_s += (-need_s) % mesh_devices
    need_d = max(64, _pow2ceil(2 * n_iters * config.scenarios_per_iter
                               * max(n_epi, 1)))
    return config.replace(
        max_scenarios=min(config.max_scenarios, need_s),
        max_dual_vertices=min(config.max_dual_vertices, need_d))
