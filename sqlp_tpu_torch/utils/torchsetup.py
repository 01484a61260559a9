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
