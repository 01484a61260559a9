"""Process-level PyTorch configuration, applied explicitly by entry points.

Port of ``sqlp_tpu/utils/jaxsetup.py:configure_jax``. The JAX package pins
``Precision.HIGHEST`` on every accuracy-critical product
(``sqlp_tpu/ops/pdhg.py:49``, ``sd/cuts.py``, ``sd/algorithm.py:41``); on
the card, TF32 would silently undo that for float32 matmuls, so both TF32
switches are turned off here. The CLI, the ``SDSolver`` constructor and
``chip_smoke.py`` call :func:`configure_torch`.
"""

from __future__ import annotations

import torch


def configure_torch() -> None:
    """Idempotent; safe to call from every entry point."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device a public entry point places its tensors on. The default
    is the card; asking for CUDA on a host without one raises instead of
    going on silently on the CPU (pass ``device="cpu"`` for the plain
    versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default is the CUDA card) but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"on the CPU")
    return dev
