"""ADMM check interval of the master QP: CUDA kernel wrapper and its plain
version.

Port of ``sqlp_tpu/ops/pallas/admm_kernel.py:admm_round_pallas`` (body
``_kernel``, :44-77). The kernel source is
``sqlp_tpu_torch/csrc/admm_round.cu``; its header says what bounds it on
the card and how the design answers that.

:func:`admm_round` launches the kernel for CUDA tensors and runs
:func:`admm_round_ref` (the loop of ``sqlp_tpu/ops/prox_qp.py:198-206,
254-258``) only for CPU tensors. Unlike the TPU kernel (f32 only), both the
f32 and the f64 instance exist; the SD master runs in f64.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sqlp_tpu_torch.ops.cuda import build

# launches of the CUDA kernel in this process (the plain version does not
# count); chip_smoke.py resets it before driving the main path
launches = 0


def admm_round_ref(As, M, Minv, g, lc, uc, rho, z, zeta, mu, n_inner: int,
                   alpha: float, sigma: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: n_inner ADMM steps on the scaled problem."""
    AsT = As.T
    for _ in range(n_inner):
        rhs = sigma * z - g + AsT @ (rho * zeta - mu)
        x = Minv @ rhs
        x = x + Minv @ (rhs - M @ x)
        v = alpha * (As @ x) + (1.0 - alpha) * zeta
        zeta1 = torch.clamp(v + mu / rho, lc, uc)
        mu = mu + rho * (v - zeta1)
        z, zeta = x, zeta1
    return z, zeta, mu


def admm_round(As, M, Minv, g, lc, uc, rho, z, zeta, mu, n_inner: int,
               alpha: float, sigma: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run n_inner ADMM steps; returns (z, zeta, mu).

    As [mA, nz]; M, Minv [nz, nz] symmetric; g [nz]; lc, uc, rho [mA]
    (finite sentinels); z [nz]; zeta, mu [mA]. A leading batch axis on
    every argument solves that many QPs in one launch (one block each).
    CUDA tensors launch the kernel, CPU tensors run the plain version.
    """
    global launches
    if As.device.type == "cpu":
        if As.dim() == 3:
            outs = [admm_round_ref(*(a[b] for a in (As, M, Minv, g, lc, uc,
                                                    rho, z, zeta, mu)),
                                   n_inner, alpha, sigma)
                    for b in range(As.shape[0])]
            return tuple(torch.stack(o) for o in zip(*outs))
        return admm_round_ref(As, M, Minv, g, lc, uc, rho, z, zeta, mu,
                              n_inner, alpha, sigma)
    if As.device.type != "cuda":
        raise ValueError(f"admm_round: unsupported device {As.device}")
    dt = As.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"admm_round: dtype {dt} not supported")
    batched = As.dim() == 3
    nb = As.shape[0] if batched else 1
    mA, nz = As.shape[-2:]
    lead = (nb,) if batched else ()
    shapes = {"As": (As, lead + (mA, nz)), "M": (M, lead + (nz, nz)),
              "Minv": (Minv, lead + (nz, nz)), "g": (g, lead + (nz,)),
              "lc": (lc, lead + (mA,)), "uc": (uc, lead + (mA,)),
              "rho": (rho, lead + (mA,)), "z": (z, lead + (nz,)),
              "zeta": (zeta, lead + (mA,)), "mu": (mu, lead + (mA,))}
    for name, (t, shape) in shapes.items():
        if t.device != As.device:
            raise ValueError(f"admm_round: {name} on {t.device}, As on "
                             f"{As.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"admm_round: {name} shape {tuple(t.shape)} "
                             f"!= {shape}")
        if t.dtype != dt:
            raise TypeError(f"admm_round: {name} dtype {t.dtype} != {dt}")
        if not t.is_contiguous():
            raise ValueError(f"admm_round: {name} not contiguous")
    zo = torch.empty_like(z)
    zetao = torch.empty_like(zeta)
    muo = torch.empty_like(mu)
    lib = build.load()
    fn = lib.admm_round_f32 if dt == torch.float32 else lib.admm_round_f64
    stream = torch.cuda.current_stream(As.device).cuda_stream
    with torch.cuda.device(As.device):
        code = fn(As.data_ptr(), M.data_ptr(), Minv.data_ptr(),
                  g.data_ptr(), lc.data_ptr(), uc.data_ptr(),
                  rho.data_ptr(), z.data_ptr(), zeta.data_ptr(),
                  mu.data_ptr(), zo.data_ptr(), zetao.data_ptr(),
                  muo.data_ptr(), nb, mA, nz, int(n_inner), float(alpha),
                  float(sigma), stream)
    build.check(code, "admm_round")
    launches += 1
    return zo, zetao, muo
