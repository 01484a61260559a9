"""PDHG restart rounds: CUDA kernel wrappers and their plain versions.

Two kernels, one per restart scheme of ``solve_batch``:

- :func:`pdhg_halpern_round` ports
  ``sqlp_tpu/ops/pallas/pdhg_kernel.py:pdhg_round_pallas_halpern`` (body
  ``_kernel_halpern``, :150-262); source
  ``sqlp_tpu_torch/csrc/pdhg_halpern_round.cu``; plain version
  :func:`pdhg_halpern_round_ref` (the loop of
  ``sqlp_tpu/ops/pdhg.py:305-320``).
- :func:`pdhg_average_round` ports ``pdhg_round_pallas`` (body ``_kernel``,
  :106-147, 265-330); source ``sqlp_tpu_torch/csrc/pdhg_average_round.cu``;
  plain version :func:`pdhg_average_round_ref` (the loop of
  ``sqlp_tpu/ops/pdhg.py:330-340``).

Each source's header says what bounds it on the card and how the design
answers that. A wrapper launches its kernel for CUDA tensors and runs the
plain version only for CPU tensors. The Pallas batch padding and block
picking (``pick_blk``) are TPU artefacts and have no counterpart: the
kernels mask their ragged last block themselves.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sqlp_tpu_torch.ops.cuda import build

# launches of each CUDA kernel in this process (the plain versions do not
# count); chip_smoke.py resets them before driving a path
launches = 0            # pdhg_halpern_round
average_launches = 0    # pdhg_average_round

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


def pdhg_average_round_ref(K, q, lb, ub, is_eq, ht, tau, sig, Y, L,
                           n_inner: int) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: n_inner PDHG steps with running sums.

    Returns (Y, L, Yavg, Lavg) exactly as the kernel does; the averages
    divide the sums by n_inner.
    """
    qrow = q[None, :] if q.dim() == 1 else q
    tau = tau[:, None]
    sig = sig[:, None]
    eq = is_eq[None, :]
    Ys = torch.zeros_like(Y)
    Ls = torch.zeros_like(L)
    for _ in range(n_inner):
        G = qrow - L @ K
        Y1 = torch.clamp(Y - tau * G, lb, ub)
        S = ht - (2.0 * Y1 - Y) @ K.T
        Lr = L + sig * S
        L1 = torch.where(eq, Lr, torch.clamp_min(Lr, 0.0))
        Y, L, Ys, Ls = Y1, L1, Ys + Y1, Ls + L1
    return Y, L, Ys / n_inner, Ls / n_inner


def _rows_per_block(name: str, B: int, per_row: int) -> int:
    """Batch rows a block carries, given the shared memory one row needs:
    several when the panel is large enough to fill the card twice over
    anyway (each K read then serves them all), one for the small SD-step
    panel (latency-bound: more blocks)."""
    for rows in (4, 2):
        if rows * per_row <= _SMEM_BUDGET and -(-B // rows) >= 2 * _SMS:
            return rows
    if per_row > 227 * 1024:
        raise ValueError(f"{name}: one row needs {per_row} B of shared "
                         f"memory, over the 227 KB a block may use")
    return 1


def _check_operands(name: str, K: torch.Tensor, shapes: dict) -> None:
    """Device, shape, contiguity and dtype of every operand, against K's;
    raises on what the kernel does not take."""
    dt = K.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dt} not supported")
    for arg, (t, shape) in shapes.items():
        if t.device != K.device:
            raise ValueError(f"{name}: {arg} on {t.device}, K on {K.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)} != "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} not contiguous")
        want = torch.bool if arg == "is_eq" else dt
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} dtype {t.dtype} != {want}")


def _common_shapes(K, q, lb, ub, is_eq, ht, tau, sig, Y, L) -> dict:
    """Expected shapes of the operands both kernels take."""
    m, n = K.shape
    B = ht.shape[0]
    return {"K": (K, (m, n)), "q": (q, (B, n) if q.dim() == 2 else (n,)),
            "lb": (lb, (n,)), "ub": (ub, (n,)), "is_eq": (is_eq, (m,)),
            "ht": (ht, (B, m)), "tau": (tau, (B,)), "sig": (sig, (B,)),
            "Y": (Y, (B, n)), "L": (L, (B, m))}


def _kernel_device(name: str, K: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if K.device.type == "cpu":
        return False
    if K.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {K.device}")
    return True


def pdhg_halpern_round(K, q, lb, ub, is_eq, ht, tau, sig, Y, L, kh, Yanc,
                       Lanc, n_inner: int) -> Tuple[torch.Tensor, ...]:
    """One Halpern restart round; returns (Ycarry, Lcarry, Ycand, Lcand).

    K [m, n]; q [n] shared or [B, n] per element; lb, ub [n] (finite
    sentinels); is_eq [m] bool; ht [B, m]; tau, sig, kh [B]; Y, Yanc
    [B, n]; L, Lanc [B, m]. CUDA tensors launch the kernel, CPU tensors run
    the plain version; anything else raises.
    """
    global launches
    name = "pdhg_halpern_round"
    if not _kernel_device(name, K):
        return pdhg_halpern_round_ref(K, q, lb, ub, is_eq, ht, tau, sig, Y,
                                      L, kh, Yanc, Lanc, n_inner)
    m, n = K.shape
    B = ht.shape[0]
    shapes = _common_shapes(K, q, lb, ub, is_eq, ht, tau, sig, Y, L)
    shapes.update(kh=(kh, (B,)), Yanc=(Yanc, (B, n)), Lanc=(Lanc, (B, m)))
    _check_operands(name, K, shapes)
    if B == 0 or n_inner <= 0:
        return Y.clone(), L.clone(), Y.clone(), L.clone()
    Yo = torch.empty_like(Y)
    Lo = torch.empty_like(L)
    Yc = torch.empty_like(Y)
    Lc = torch.empty_like(L)
    rows = _rows_per_block(name, B, (4 * n + 4 * m) * K.element_size())
    lib = build.load()
    fn = lib.pdhg_halpern_round_f32 if K.dtype == torch.float32 \
        else lib.pdhg_halpern_round_f64
    stream = torch.cuda.current_stream(K.device).cuda_stream
    with torch.cuda.device(K.device):
        code = fn(rows, K.data_ptr(), q.data_ptr(), int(q.dim() == 2),
                  lb.data_ptr(), ub.data_ptr(), is_eq.data_ptr(),
                  ht.data_ptr(), tau.data_ptr(), sig.data_ptr(),
                  Y.data_ptr(), L.data_ptr(), kh.data_ptr(),
                  Yanc.data_ptr(), Lanc.data_ptr(), Yo.data_ptr(),
                  Lo.data_ptr(), Yc.data_ptr(), Lc.data_ptr(),
                  B, m, n, int(n_inner), stream)
    build.check(code, name)
    launches += 1
    return Yo, Lo, Yc, Lc


def pdhg_average_round(K, q, lb, ub, is_eq, ht, tau, sig, Y, L,
                       n_inner: int) -> Tuple[torch.Tensor, ...]:
    """One restart-to-average round; returns (Y, L, Yavg, Lavg).

    Operands as for :func:`pdhg_halpern_round` without the Halpern step
    count and anchors. CUDA tensors launch the kernel, CPU tensors run the
    plain version; anything else raises.
    """
    global average_launches
    name = "pdhg_average_round"
    if not _kernel_device(name, K):
        return pdhg_average_round_ref(K, q, lb, ub, is_eq, ht, tau, sig, Y,
                                      L, n_inner)
    m, n = K.shape
    B = ht.shape[0]
    _check_operands(name, K, _common_shapes(K, q, lb, ub, is_eq, ht, tau,
                                            sig, Y, L))
    if B == 0 or n_inner <= 0:
        return Y.clone(), L.clone(), Y.clone(), L.clone()
    Yo = torch.empty_like(Y)
    Lo = torch.empty_like(L)
    Ya = torch.empty_like(Y)
    La = torch.empty_like(L)
    rows = _rows_per_block(name, B, (3 * n + 3 * m) * K.element_size())
    lib = build.load()
    fn = lib.pdhg_average_round_f32 if K.dtype == torch.float32 \
        else lib.pdhg_average_round_f64
    stream = torch.cuda.current_stream(K.device).cuda_stream
    with torch.cuda.device(K.device):
        code = fn(rows, K.data_ptr(), q.data_ptr(), int(q.dim() == 2),
                  lb.data_ptr(), ub.data_ptr(), is_eq.data_ptr(),
                  ht.data_ptr(), tau.data_ptr(), sig.data_ptr(),
                  Y.data_ptr(), L.data_ptr(), Yo.data_ptr(), Lo.data_ptr(),
                  Ya.data_ptr(), La.data_ptr(), B, m, n, int(n_inner),
                  stream)
    build.check(code, name)
    average_launches += 1
    return Yo, Lo, Ya, La
