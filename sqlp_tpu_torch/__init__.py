"""sqlp_tpu_torch — the two-stage regularized SD solver in PyTorch + CUDA.

A port of the JAX package ``sqlp_tpu`` (the reference, kept beside it) to
PyTorch on an NVIDIA H100. Layout mirrors the reference:

  models/    SMPS parsers, stage templates, scenario model, instance tensors
  ops/       batched PDHG LP solver, ADMM prox-QP master, dual crossover;
             ops/cuda/ wraps the hand-written CUDA kernels (csrc/) and
             holds their plain PyTorch versions
  sd/        dual pool, cuts, master assembly, the SD step, driver
  utils/     process configuration

This package imports torch, numpy and scipy, never jax.
"""

__version__ = "0.1.0"
