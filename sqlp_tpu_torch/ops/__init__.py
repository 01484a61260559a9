"""Numerical layer: batched PDHG LP solver, ADMM prox-QP master, dual
crossover; ``ops/cuda`` wraps the hand-written kernels (see the package
docstring)."""

from sqlp_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "sqlp_tpu_torch.ops.pdhg": ("PreparedLP", "prepare_lp", "solve_batch"),
    "sqlp_tpu_torch.ops.prox_qp": ("solve_qp",),
})
