"""sqlp_tpu_torch — the two-stage regularized SD solver in PyTorch + CUDA.

A port of the JAX package ``sqlp_tpu`` (the reference, kept beside it) to
PyTorch on an NVIDIA H100. Layout mirrors the reference:

  models/    SMPS parsers (native C++ and Python), stage templates, scenario
             model, instance tensors
  ops/       batched PDHG LP solver, ADMM prox-QP master, dual crossover;
             ops/cuda/ wraps the hand-written CUDA kernels (csrc/) and
             holds their plain PyTorch versions
  sd/        dual pool, cuts, master assembly, the SD step, driver
  parallel/  ranks on torch.distributed, meshes, the sharded state's
             layout and the step's combines
  utils/     process configuration, checkpoints, JSONL metrics, profiling

This package imports torch, numpy and scipy, never jax. Each package's
``__init__`` re-exports the names of its JAX counterpart's, resolved on
first access (``_exports.py``): ``from sqlp_tpu_torch import SDConfig``,
``from sqlp_tpu_torch.sd import SDSolver, solve_instance``.
"""

from sqlp_tpu_torch._exports import lazy_exports

__version__ = "0.1.0"

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "sqlp_tpu_torch.config": ("SDConfig",),
})
