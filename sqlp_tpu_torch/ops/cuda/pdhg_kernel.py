"""Reflected-Halpern PDHG round: CUDA kernel wrapper and its plain version.

Port of ``sqlp_tpu/ops/pallas/pdhg_kernel.py:pdhg_round_pallas_halpern``
(body ``_kernel_halpern``, :150-262). The kernel source is
``sqlp_tpu_torch/csrc/pdhg_halpern_round.cu``; its header says what bounds
it on the card and how the design answers that.

:func:`pdhg_halpern_round` launches the kernel for CUDA tensors and runs
:func:`pdhg_halpern_round_ref` (the loop of ``sqlp_tpu/ops/pdhg.py:305-320``)
only for CPU tensors. The Pallas batch padding and block picking
(``pick_blk``) are TPU artefacts and have no counterpart: the kernel masks
its ragged last block itself.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sqlp_tpu_torch.ops.cuda import build

# launches of the CUDA kernel in this process (the plain version does not
# count); chip_smoke.py resets it before driving the main path
launches = 0

_SMEM_BUDGET = 200 * 1024
_SMS = 132


def pdhg_halpern_round_ref(K, q, lb, ub, is_eq, ht, tau, sig, Y, L, kh,
                           Yanc, Lanc, n_inner: int
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: n_inner reflected-Halpern PDHG steps.

    Returns (Ycarry, Lcarry, Ycand, Lcand) exactly as the kernel does.
    """
    qrow = q[None, :] if q.dim() == 1 else q
    tau = tau[:, None]
    sig = sig[:, None]
    eq = is_eq[None, :]
    Yc, Lc = Y, L
    for t in range(n_inner):
        G = qrow - L @ K
        Y1 = torch.clamp(Y - tau * G, lb, ub)
        Yb = 2.0 * Y1 - Y
        S = ht - Yb @ K.T
        Lr = L + sig * S
        L1 = torch.where(eq, Lr, torch.clamp_min(Lr, 0.0))
        k = (kh + t)[:, None]
        w = (k + 1.0) / (k + 2.0)
        Y2 = w * Yb + (1.0 - w) * Yanc
        L2 = w * (2.0 * L1 - L) + (1.0 - w) * Lanc
        Y, L, Yc, Lc = Y2, L2, Y1, L1
    return Y, L, Yc, Lc


def _rows_per_block(B: int, m: int, n: int, itemsize: int) -> int:
    """Batch rows a block carries: several when the panel is large enough
    to fill the card twice over anyway (each K read then serves them all),
    one for the small SD-step panel (latency-bound: more blocks)."""
    per_row = (4 * n + 4 * m) * itemsize
    for rows in (4, 2):
        if rows * per_row <= _SMEM_BUDGET and -(-B // rows) >= 2 * _SMS:
            return rows
    if per_row > 227 * 1024:
        raise ValueError(f"pdhg_halpern_round: one row needs {per_row} B "
                         f"of shared memory (m={m}, n={n}), over the "
                         f"227 KB a block may use")
    return 1


def pdhg_halpern_round(K, q, lb, ub, is_eq, ht, tau, sig, Y, L, kh, Yanc,
                       Lanc, n_inner: int) -> Tuple[torch.Tensor, ...]:
    """One Halpern restart round; returns (Ycarry, Lcarry, Ycand, Lcand).

    K [m, n]; q [n] shared or [B, n] per element; lb, ub [n] (finite
    sentinels); is_eq [m] bool; ht [B, m]; tau, sig, kh [B]; Y, Yanc
    [B, n]; L, Lanc [B, m]. CUDA tensors launch the kernel, CPU tensors run
    the plain version; anything else raises.
    """
    global launches
    if K.device.type == "cpu":
        return pdhg_halpern_round_ref(K, q, lb, ub, is_eq, ht, tau, sig, Y,
                                      L, kh, Yanc, Lanc, n_inner)
    if K.device.type != "cuda":
        raise ValueError(f"pdhg_halpern_round: unsupported device "
                         f"{K.device}")
    dt = K.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"pdhg_halpern_round: dtype {dt} not supported")
    m, n = K.shape
    B = ht.shape[0]
    per_row = q.dim() == 2
    shapes = {"K": (K, (m, n)), "q": (q, (B, n) if per_row else (n,)),
              "lb": (lb, (n,)), "ub": (ub, (n,)), "is_eq": (is_eq, (m,)),
              "ht": (ht, (B, m)), "tau": (tau, (B,)), "sig": (sig, (B,)),
              "Y": (Y, (B, n)), "L": (L, (B, m)), "kh": (kh, (B,)),
              "Yanc": (Yanc, (B, n)), "Lanc": (Lanc, (B, m))}
    for name, (t, shape) in shapes.items():
        if t.device != K.device:
            raise ValueError(f"pdhg_halpern_round: {name} on {t.device}, "
                             f"K on {K.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"pdhg_halpern_round: {name} shape "
                             f"{tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"pdhg_halpern_round: {name} not contiguous")
        want = torch.bool if name == "is_eq" else dt
        if t.dtype != want:
            raise TypeError(f"pdhg_halpern_round: {name} dtype {t.dtype} "
                            f"!= {want}")
    if B == 0 or n_inner <= 0:
        return Y.clone(), L.clone(), Y.clone(), L.clone()
    Yo = torch.empty_like(Y)
    Lo = torch.empty_like(L)
    Yc = torch.empty_like(Y)
    Lc = torch.empty_like(L)
    rows = _rows_per_block(B, m, n, K.element_size())
    lib = build.load()
    fn = lib.pdhg_halpern_round_f32 if dt == torch.float32 \
        else lib.pdhg_halpern_round_f64
    stream = torch.cuda.current_stream(K.device).cuda_stream
    with torch.cuda.device(K.device):
        code = fn(rows, K.data_ptr(), q.data_ptr(), int(per_row),
                  lb.data_ptr(), ub.data_ptr(), is_eq.data_ptr(),
                  ht.data_ptr(), tau.data_ptr(), sig.data_ptr(),
                  Y.data_ptr(), L.data_ptr(), kh.data_ptr(),
                  Yanc.data_ptr(), Lanc.data_ptr(), Yo.data_ptr(),
                  Lo.data_ptr(), Yc.data_ptr(), Lc.data_ptr(),
                  B, m, n, int(n_inner), stream)
    build.check(code, "pdhg_halpern_round")
    launches += 1
    return Yo, Lo, Yc, Lc
