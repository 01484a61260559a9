"""ADMM check interval of the master QP: CUDA kernel wrapper and its plain
version.

Port of ``sqlp_tpu/ops/pallas/admm_kernel.py:admm_round_pallas`` (body
``_kernel``, :44-77). The kernel source is
``sqlp_tpu_torch/csrc/admm_round.cu``: each master lives in the shared
memory of a thread-block cluster of :func:`_plan` CTAs; its header says
what bounds it on the card and how the design answers that.

:func:`admm_round` launches the kernel for CUDA tensors and runs
:func:`admm_round_ref` (the loop of ``sqlp_tpu/ops/prox_qp.py:198-206,
254-258``) only for CPU tensors. Unlike the TPU kernel (f32 only), both the
f32 and the f64 instance exist; the SD master runs in f64.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from sqlp_tpu_torch.ops.cuda import build

# launches of the CUDA kernel in this process (the plain version does not
# count); chip_smoke.py resets it before driving the main path
launches = 0
# the launches that stepped more than one master (an R-batched solve)
batched_launches = 0

_SMEM_MAX = 227 * 1024      # dynamic shared memory one block may use (sm_90)
# CTAs per master (chip_smoke.py --phases sweep; PERF.md): 8 measured
# faster than 1, 2 and 4 on the ssn and storm masters in f32 and f64 (132
# KB and more of As, M and Minv); one block measured faster than 2, 4 and 8
# on lands' master (under 5 KB). Masters under _SPLIT_BYTES, between the
# two, take one block.
_CLUSTER = 8
_SPLIT_BYTES = 64 * 1024


def _stride(nz: int) -> int:
    """Row stride of the resident matrices: nz padded to 8 mod 32."""
    return nz + (8 - nz % 32) % 32


def _smem_bytes(C: int, mA: int, nz: int, itemsize: int) -> int:
    """Shared memory of one CTA when a cluster of C splits the master
    (mirrors csrc/admm_round.cu:admm_smem_elems)."""
    s = _stride(nz)
    ra = -(-mA // C)
    rm = -(-nz // C)
    return (ra * s + 2 * rm * s + 6 * nz + 6 * ra) * itemsize


@functools.lru_cache(maxsize=64)
def _plan(mA: int, nz: int, itemsize: int) -> int:
    """CTAs in the cluster that carries one master: one block for a master
    under ``_SPLIT_BYTES`` that fits it, else ``_CLUSTER``; raises where
    the row slices of As, M and Minv miss a CTA's shared memory even then.
    A pure function of the shapes and the dtype's size."""
    small = (mA * nz + 2 * nz * nz) * itemsize < _SPLIT_BYTES
    for C in ((1, _CLUSTER) if small else (_CLUSTER,)):
        if _smem_bytes(C, mA, nz, itemsize) <= _SMEM_MAX:
            return C
    raise ValueError(f"admm_round: a master with mA={mA}, nz={nz} does "
                     f"not fit a cluster of {_CLUSTER}")


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
               alpha: float, sigma: float, *, plan: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run n_inner ADMM steps; returns (z, zeta, mu).

    As [mA, nz]; M, Minv [nz, nz] symmetric; g [nz]; lc, uc, rho [mA]
    (finite sentinels); z [nz]; zeta, mu [mA]. A leading batch axis on
    every argument solves that many QPs in one launch (one cluster each,
    of ``plan`` CTAs; default :func:`_plan` of the shapes). CUDA tensors
    launch the kernel, CPU tensors run the plain version. A refused launch
    raises.
    """
    global launches, batched_launches
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
    C = _plan(mA, nz, As.element_size()) if plan is None else int(plan)
    lib = build.load()
    fn = lib.admm_round_f32 if dt == torch.float32 else lib.admm_round_f64
    stream = torch.cuda.current_stream(As.device).cuda_stream
    with torch.cuda.device(As.device):
        code = fn(C, As.data_ptr(), M.data_ptr(), Minv.data_ptr(),
                  g.data_ptr(), lc.data_ptr(), uc.data_ptr(),
                  rho.data_ptr(), z.data_ptr(), zeta.data_ptr(),
                  mu.data_ptr(), zo.data_ptr(), zetao.data_ptr(),
                  muo.data_ptr(), nb, mA, nz, int(n_inner), float(alpha),
                  float(sigma), stream)
    build.check(code, f"admm_round (cluster of {C})")
    launches += 1
    batched_launches += int(nb > 1)
    return zo, zetao, muo
