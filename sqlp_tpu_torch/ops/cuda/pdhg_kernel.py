"""PDHG restart rounds: CUDA kernel wrappers and their plain versions.

Two rounds, one per restart scheme of ``solve_batch``:

- :func:`pdhg_halpern_round` ports
  ``sqlp_tpu/ops/pallas/pdhg_kernel.py:pdhg_round_pallas_halpern`` (body
  ``_kernel_halpern``, :150-262) in two variants that compute the same
  function: the row-block kernel ``sqlp_tpu_torch/csrc/pdhg_halpern_round.cu``
  (large panels; K read from L2) and the cluster kernel
  ``sqlp_tpu_torch/csrc/pdhg_halpern_cluster.cu`` (small panels; K resident
  in a thread-block cluster's shared memory). :func:`_plan` picks one from
  the shapes and dtype alone. Plain version :func:`pdhg_halpern_round_ref`
  (the loop of ``sqlp_tpu/ops/pdhg.py:305-320``).
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

import functools
from typing import Optional, Tuple

import torch

from sqlp_tpu_torch.ops.cuda import build

# launches of each CUDA kernel in this process (the plain versions do not
# count); chip_smoke.py resets them before driving a path
launches = 0            # pdhg_halpern_round, row-block variant
cluster_launches = 0    # pdhg_halpern_round, cluster variant
average_launches = 0    # pdhg_average_round

_SMEM_BUDGET = 200 * 1024
_SMEM_MAX = 227 * 1024  # dynamic shared memory one block may use (sm_90)
_SMS = 132

# The cluster variant (csrc/pdhg_halpern_cluster.cu), set from the chip
# measurements in PERF.md (chip_smoke.py --phases sweep). It pays
# once per launch to load K into the clusters' shared memory and once per
# step for a cluster barrier, and wins where the row-block kernel is bound
# by one SM's L2 bandwidth: a K too large for L1 and too few rows to fill
# the card. Past about three waves of clusters the row-block kernel's
# reuse of each K read across a block's rows wins again.
_CLUSTER_MIN_K_BYTES = 128 * 1024
_CLUSTER_SIZES = (4, 8, 16)         # CTAs per cluster; 16 is non-portable
_CLUSTER_ROWS = (1, 2, 4, 8)        # batch rows one cluster carries
_CLUSTER_MAX_WAVES = 3
_CLUSTER_WARPS = 16
_CLUSTER_REGS = 108                 # 32-bit registers of the lane arrays


def _cluster_mi(m: int) -> int:
    """Rows of K per lane (i = lane + 32 k, k < MI) the cluster kernel is
    instantiated for; 0 where m is too large for it."""
    return 6 if m <= 192 else (18 if m <= 576 else 0)


def _cluster_smem(C: int, R: int, m: int, n: int, itemsize: int,
                  q_rows: int) -> int:
    """Shared memory of one CTA of the cluster kernel, in bytes (mirrors
    csrc/pdhg_halpern_cluster.cu:cluster_smem_elems)."""
    nc = -(-n // C)
    return (nc * m + (2 + q_rows + 3 * R) * nc
            + (4 + _CLUSTER_WARPS + 2) * R * m) * itemsize


def _cluster_fits(C: int, R: int, m: int, n: int, itemsize: int) -> bool:
    """The cluster kernel takes (C, R) at these shapes: its lane arrays fit
    the register budget and a CTA's slice and vectors (per-row q assumed)
    fit its shared memory."""
    mi = _cluster_mi(m)
    return (mi > 0 and (2 * R + 1) * mi * itemsize // 4 <= _CLUSTER_REGS
            and _cluster_smem(C, R, m, n, itemsize, R) <= _SMEM_MAX)


@functools.lru_cache(maxsize=256)
def _clusters_per_wave(C: int, R: int, m: int, n: int,
                       itemsize: int) -> int:
    """Clusters of C CTAs and R rows each that the current card runs at
    once at these shapes: ``cudaOccupancyMaxActiveClusters`` of that
    launch, asked once (nothing is launched)."""
    import ctypes
    out = ctypes.c_int(0)
    code = build.load().pdhg_halpern_cluster_occupancy(
        int(itemsize == 8), C, R, R, m, n, ctypes.addressof(out))
    build.check(code, f"cudaOccupancyMaxActiveClusters (C={C}, R={R})")
    return out.value


def _waves(B: int, C: int, R: int, m: int, n: int, itemsize: int) -> int:
    """Waves of clusters a [B] panel takes at C CTAs and R rows each."""
    clusters = -(-B // R)
    return -(-clusters // _clusters_per_wave(C, R, m, n, itemsize))


def _cluster_shape(B: int, m: int, n: int, itemsize: int):
    """(C, R) of the cluster variant for a [B] panel, or None where it does
    not take these shapes: of the sizes whose slices fit and that the card
    can schedule, the fewest waves, then the fewest rows per cluster, then
    the larger cluster."""
    fit = [(C, R) for C in _CLUSTER_SIZES for R in _CLUSTER_ROWS
           if _cluster_fits(C, R, m, n, itemsize)
           and _clusters_per_wave(C, R, m, n, itemsize) > 0]
    if not fit:
        return None
    return min(fit, key=lambda cr: (_waves(B, *cr, m, n, itemsize), cr[1],
                                    -cr[0]))


@functools.lru_cache(maxsize=256)
def _plan(B: int, m: int, n: int, itemsize: int) -> tuple:
    """The variant of the Halpern round for a [B] panel of an [m, n] K:
    ``("cluster", C, R)`` (clusters of C CTAs, R batch rows each) or
    ``("rows", ROWS)`` (the row-block kernel, ROWS rows per block). A
    function of the shapes and the dtype's size, and for a K of at least
    ``_CLUSTER_MIN_K_BYTES`` of the card's cluster occupancy."""
    if m * n * itemsize >= _CLUSTER_MIN_K_BYTES:
        shape = _cluster_shape(B, m, n, itemsize)
        if shape is not None and _waves(B, *shape, m, n, itemsize) \
                <= _CLUSTER_MAX_WAVES:
            return ("cluster",) + shape
    return ("rows", _rows_per_block("pdhg_halpern_round", B,
                                    (4 * n + 4 * m) * itemsize))


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
                       Lanc, n_inner: int, *, plan: Optional[tuple] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """One Halpern restart round; returns (Ycarry, Lcarry, Ycand, Lcand).

    K [m, n]; q [n] shared or [B, n] per element; lb, ub [n] (finite
    sentinels); is_eq [m] bool; ht [B, m]; tau, sig, kh [B]; Y, Yanc
    [B, n]; L, Lanc [B, m]. CUDA tensors launch the kernel variant that
    ``plan`` names (default :func:`_plan` of the shapes), CPU tensors run
    the plain version; anything else raises. A refused launch raises.
    """
    global launches, cluster_launches
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
    if plan is None:
        plan = _plan(B, m, n, K.element_size())
    lib = build.load()
    f64 = K.dtype == torch.float64
    if plan[0] == "cluster":
        fn = lib.pdhg_halpern_cluster_f64 if f64 \
            else lib.pdhg_halpern_cluster_f32
        head = (plan[1], plan[2])
    elif plan[0] == "rows":
        fn = lib.pdhg_halpern_round_f64 if f64 \
            else lib.pdhg_halpern_round_f32
        head = (plan[1],)
    else:
        raise ValueError(f"{name}: unknown plan {plan!r}")
    stream = torch.cuda.current_stream(K.device).cuda_stream
    with torch.cuda.device(K.device):
        code = fn(*head, K.data_ptr(), q.data_ptr(), int(q.dim() == 2),
                  lb.data_ptr(), ub.data_ptr(), is_eq.data_ptr(),
                  ht.data_ptr(), tau.data_ptr(), sig.data_ptr(),
                  Y.data_ptr(), L.data_ptr(), kh.data_ptr(),
                  Yanc.data_ptr(), Lanc.data_ptr(), Yo.data_ptr(),
                  Lo.data_ptr(), Yc.data_ptr(), Lc.data_ptr(),
                  B, m, n, int(n_inner), stream)
    build.check(code, f"{name} {plan}")
    if plan[0] == "cluster":
        cluster_launches += 1
    else:
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
