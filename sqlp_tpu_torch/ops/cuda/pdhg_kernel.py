"""PDHG restart rounds: CUDA kernel wrappers and their plain versions.

Two rounds, one per restart scheme of ``solve_batch``:

- :func:`pdhg_halpern_round` ports
  ``sqlp_tpu/ops/pallas/pdhg_kernel.py:pdhg_round_pallas_halpern`` (body
  ``_kernel_halpern``, :150-262); plain version
  :func:`pdhg_halpern_round_ref` (the loop of
  ``sqlp_tpu/ops/pdhg.py:305-320``).
- :func:`pdhg_average_round` ports ``pdhg_round_pallas`` (body ``_kernel``,
  :106-147, 265-330); plain version :func:`pdhg_average_round_ref` (the
  loop of ``sqlp_tpu/ops/pdhg.py:330-340``).

Each has six kernel variants under ``sqlp_tpu_torch/csrc/`` that compute
the same function, and :func:`_plan` picks one from the shapes, the dtype
and the card's cluster occupancy:

- ``("cluster", C, R)``: ``pdhg_{halpern,average}_cluster.cu`` (both from
  ``pdhg_cluster.cuh``), small panels; K resident in the shared memory of
  a cluster of C CTAs, R batch rows per cluster, scalar FMAs;
- ``("tile", C, arith)``: ``pdhg_{halpern,average}_tile.cu`` (both from
  ``pdhg_tile.cuh``), large panels; K resident in persistent clusters of C
  CTAs that walk tiles of at most 16 rows (:func:`_tile_rows`; a fourth
  element forces the height). ``arith`` names how the products are
  computed, one way per dtype (``_TILE_ARITH``): ``"mma"`` in float64
  (FP64 matrix instructions on 16-row tiles), ``"fma"`` in float32 (FP32
  FMAs summed in blocks of 8 k, the float64 instruction's order);
- ``("stream", C, TM)``: ``pdhg_{halpern,average}_stream.cu`` (both from
  ``pdhg_stream.cuh``), a K whose slices fit no cluster (storm): K streamed
  from L2 through shared memory every step for tiles of TM = 16 rows on a
  cluster of C CTAs; float32 in the row-block kernels' order of summation
  (bit for bit theirs), float64 on FP64 matrix instructions;
- ``("grid", BM, P)``: ``pdhg_{halpern,average}_grid.cu`` (both from
  ``pdhg_grid.cuh``), float32 panels of such a K too large for the
  cluster kernel: the iterates stay in device memory and every step is two
  launches over the whole panel (cut into P parts, at most 4, on streams
  of their own), primal tiles of BM rows x 128 columns and dual tiles of
  32 rows x 16 constraints; bit for bit the row-block round;
- ``("small", W, R)``: ``pdhg_{halpern,average}_small.cu`` (both from
  ``pdhg_small.cuh``), a K under ``_CLUSTER_MIN_K_BYTES`` (lands,
  transship, baa99-20): K resident in a block's shared memory, groups of
  W warps carrying R batch rows each, :func:`_small_groups` groups a
  block; bit for bit the row-block round;
- ``("rows", ROWS)``: ``pdhg_{halpern,average}_round.cu``, the row-block
  kernels (K read from L2) for what no other variant takes.

Each source's header says what bounds it on the card and how the design
answers that. A wrapper launches its kernel for CUDA tensors and runs the
plain version only for CPU tensors. The Pallas batch padding and block
picking (``pick_blk``) are TPU artefacts and have no counterpart: the
kernels mask their ragged last block themselves.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref
from typing import Optional, Tuple

import torch

from sqlp_tpu_torch.ops.cuda import build

# the counter of each (scheme, variant) in launches_by_shape
COUNTERS = {("halpern", "rows"): "launches",
            ("halpern", "cluster"): "cluster_launches",
            ("halpern", "tile"): "tile_launches",
            ("halpern", "stream"): "stream_launches",
            ("halpern", "grid"): "grid_launches",
            ("halpern", "small"): "small_launches",
            ("average", "rows"): "average_launches",
            ("average", "cluster"): "average_cluster_launches",
            ("average", "tile"): "average_tile_launches",
            ("average", "stream"): "average_stream_launches",
            ("average", "grid"): "average_grid_launches",
            ("average", "small"): "average_small_launches"}
# launches of the CUDA kernels in this process (the plain versions do not
# count) by (counter, B, itemsize): which rung of a path went through
# which variant; chip_smoke.py clears it before driving a path
launches_by_shape = collections.Counter()
# restart rounds replayed from a CUDA graph ("replays") and graphs captured
# ("captures") by ops/pdhg.py:solve_batch in this process
graph_counts = collections.Counter()


def launch_counts() -> dict:
    """The launches of each counter of :data:`COUNTERS` (0 included):
    :data:`launches_by_shape` summed over rows and itemsize."""
    out = dict.fromkeys(COUNTERS.values(), 0)
    for (counter, _, _), n in launches_by_shape.items():
        out[counter] += n
    return out


def count_launch(scheme: str, plan: tuple, B: int, itemsize: int,
                 n: int = 1) -> None:
    """Count ``n`` launches of the variant ``plan`` names at [B] in
    :data:`launches_by_shape`: a replay of a captured round counts its
    launch, and a capture takes back the one its wrapper counted (a
    negative ``n``), since nothing ran."""
    key = (COUNTERS[scheme, plan[0]], B, itemsize)
    launches_by_shape[key] += n
    if launches_by_shape[key] == 0:
        del launches_by_shape[key]


def graph_holds(K: torch.Tensor, plan: tuple):
    """What a launch of ``plan`` reads besides its operands: the padded
    copy of K that the stream variant takes (:func:`_stream_k`), which a
    CUDA graph of the launch must keep alive; None for the other variants
    that a graph takes."""
    return _stream_k(K)[0] if plan[0] == "stream" else None

_SMEM_BUDGET = 200 * 1024
_SMEM_MAX = 227 * 1024  # dynamic shared memory one block may use (sm_90)

# The cluster variants (csrc/pdhg_cluster.cuh) and the tile variants
# (csrc/pdhg_tile.cuh), set from the chip measurements in PERF.md
# (chip_smoke.py --phases sweep). Both keep K in the shared memory of
# thread-block clusters, so they need a K too large for L1 to win
# anything; the cluster variants pay one cluster barrier per step and run
# scalar FMAs for R rows at a time, the tile variants two barriers per
# step and matrix instructions for 16 rows at a time. Measured on ssn: a
# round of the cluster kernel takes 0.35 ms at R = 1, 0.33-0.48 at R = 2
# and 0.82 at R = 4, one pass of the tile kernel 0.61-0.85 ms whatever the
# rows in it, so the cluster kernel keeps the panels that one wave of
# clusters of at most 2 rows holds. Where no tile shape fits (storm) the
# grid variants (csrc/pdhg_grid.cuh) take the float32 panels past
# _CLUSTER_MAX_WAVES_VS_STREAM waves of the cluster kernel (storm: 12 waves
# of clusters of 16 CTAs and one row, 84 rows; the sweep put the grid
# kernel ahead of the stream kernel at 100 and 256 rows and of the
# row-block kernel from 2 rows, and behind the cluster kernel at 64), and
# the stream variants (csrc/pdhg_stream.cuh) the float64 panels, which fit
# no cluster, up to _STREAM_MAX_ROWS (float32 ones too while the grid
# variant is not admitted for them); where none of them fits, the cluster
# kernel keeps up to 3 waves against the row-block kernel, as measured
# before the tile kernel existed. The row-block kernel keeps a K that fits
# L1 (lands) and storm's float64 average round past 256 rows.
_CLUSTER_MIN_K_BYTES = 128 * 1024
_CLUSTER_SIZES = (4, 8, 16)         # CTAs per cluster; 16 is non-portable
_CLUSTER_ROWS = (1, 2, 4, 8)        # batch rows one cluster carries
_CLUSTER_MAX_WAVES = 3              # against the row-block kernel
_CLUSTER_MAX_ROWS_VS_TILE = 2       # against the tile kernel, in one wave
_CLUSTER_MAX_WAVES_VS_STREAM = 12   # against the stream and grid kernels
_CLUSTER_WARPS = 16
_CLUSTER_REGS = 108                 # 32-bit registers of the lane arrays
_TILE_ROWS = 16                     # batch rows a tile holds at most
# the tile kernels' arithmetic, by itemsize (csrc/pdhg_tile.cuh)
_TILE_ARITH = {4: "fma", 8: "mma"}
_SCHEMES = ("halpern", "average")
# the stream kernels (csrc/pdhg_stream.cuh:layout): batch rows of a tile,
# cluster sizes (storm, the one K that reaches the stream plan, fits from 3
# CTAs in float32 and only at 16 in float64), the f32 stage (elements) and
# f64 chunk (K rows), stages
_STREAM_TM = 16
_STREAM_SIZES = (3, 4, 5, 6, 7, 8, 16)
_STREAM_STAGE32 = 4096
_STREAM_KR64 = 32
_STREAM_MAX_STAGES = 4
_STREAM_BAR_BYTES = 32          # an mbarrier of 8 bytes per stage
# the dtypes whose stream variant the plan gives panels: float32 only
# while it is bit for bit the row-block round (chip_smoke.py's b1 and b2
# hold it so at storm's shapes); float64 is held to 1e-10 of the plain
# round
_STREAM_ITEMSIZES = (4, 8)
# the largest panel, by (itemsize, scheme), the stream kernel takes; the
# grid kernel (float32) or the row-block kernel takes larger ones (None:
# no limit). From the sweep at storm's shapes (PERF.md): from 1024 rows
# the row-block kernel's 2 or 4 rows a block measured faster, except the
# Halpern round in float64, where a block holds 2 rows to the stream
# kernel's 16
_STREAM_MAX_ROWS = {(4, "halpern"): 256, (4, "average"): 256,
                    (8, "halpern"): None, (8, "average"): 256}
# the grid kernels (csrc/pdhg_grid.cuh): the dtypes whose grid variant the
# plan gives panels, float32 only while it is bit for bit the row-block
# round (chip_smoke.py's b1 and b2 hold it so); its primal tile heights,
# largest first, its primal tile width and K rows a stage, its dual tile
# (rows, constraints), its stages and the pads of its operands
_GRID_ITEMSIZES = (4,)
_GRID_BM = (128, 64)
_GRID_PARTS = (1, 2, 3, 4)          # streams a panel's rows split over
_GRID_PART_ROWS = 512               # rows of a part, at least
_GRID_BN = 128
_GRID_BK = 16
_GRID_DUAL = (32, 16)
_GRID_STAGES = 3
_GRID_M_ROUND = 16
_GRID_B_ROUND = 128
# the small kernels (csrc/pdhg_small.cuh), for a K under
# _CLUSTER_MIN_K_BYTES: warps of a group, batch rows of a group, warps of
# a block; _small_shape's thresholds
# the dtypes whose small variant the plan gives panels: both, while it is
# bit for bit the row-block round (chip_smoke.py's b1 and b2 hold it so)
_SMALL_ITEMSIZES = (4, 8)
_SMALL_WARPS = (1, 2, 4, 8, 16)
_SMALL_ROWS = (1, 2, 4)
_SMALL_MAX_WARPS = 16
_SMALL_TINY_N, _SMALL_TINY_M = 32, 8    # the tiny layout's largest K
_SMALL_COLS_PER_WARP = 16       # n / this: a latency-bound group's warps
_SMALL_MAX_LAT_WARPS = 8        # a group's warps at most (the sweep)
_SMALL_LATENCY_ROWS = 2         # rows an SM up to which a group has 1 row
_SMALL_THROUGHPUT_ROWS = 8      # rows an SM past which W drops to W / 4


@functools.lru_cache(maxsize=1)
def _sm_count() -> int:
    """Streaming multiprocessors of the current card."""
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def _row_values(m: int, n: int, scheme: str) -> int:
    """Values a batch row keeps in a row-block kernel's shared memory."""
    return 4 * n + 4 * m if scheme == "halpern" else 3 * n + 3 * m


def _cluster_mi(m: int) -> int:
    """Rows of K per lane (i = lane + 32 k, k < MI) the cluster kernels
    are instantiated for; 0 where m is too large for them."""
    return 6 if m <= 192 else (18 if m <= 576 else 0)


def _cluster_smem(C: int, R: int, m: int, n: int, itemsize: int,
                  q_rows: int, scheme: str = "halpern") -> int:
    """Shared memory of one CTA of a cluster kernel, in bytes (mirrors
    csrc/pdhg_cluster.cuh:cluster_smem_elems): a row keeps 3 [nc] and 4 [m]
    vectors under Halpern, 2 and 3 under the average scheme."""
    ny, nl = (3, 4) if scheme == "halpern" else (2, 3)
    nc = -(-n // C)
    return (nc * m + (2 + q_rows + ny * R) * nc
            + (nl + _CLUSTER_WARPS + 2) * R * m) * itemsize


def _cluster_fits(C: int, R: int, m: int, n: int, itemsize: int,
                  scheme: str = "halpern") -> bool:
    """The scheme's cluster kernel takes (C, R) at these shapes: its lane
    arrays (the same (2 R + 1) MI values under either scheme) fit the
    register budget and a CTA's slice and vectors (per-row q assumed) fit
    its shared memory."""
    mi = _cluster_mi(m)
    return (mi > 0 and (2 * R + 1) * mi * itemsize // 4 <= _CLUSTER_REGS
            and _cluster_smem(C, R, m, n, itemsize, R, scheme) <= _SMEM_MAX)


def _occupancy(kernel: str, *args: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of one launch of ``kernel`` on
    the current card (nothing is launched)."""
    out = ctypes.c_int(0)
    code = getattr(build.load(), f"{kernel}_occupancy")(
        *args, ctypes.addressof(out))
    build.check(code, f"cudaOccupancyMaxActiveClusters ({kernel} {args})")
    return out.value


@functools.lru_cache(maxsize=256)
def _clusters_per_wave(C: int, R: int, m: int, n: int, itemsize: int,
                       scheme: str = "halpern") -> int:
    """Clusters of C CTAs and R rows each that the current card runs at
    once at these shapes, asked once per shape."""
    return _occupancy(f"pdhg_{scheme}_cluster", int(itemsize == 8), C, R, R,
                      m, n)


def _waves(B: int, C: int, R: int, m: int, n: int, itemsize: int,
           scheme: str = "halpern") -> int:
    """Waves of clusters a [B] panel takes at C CTAs and R rows each."""
    clusters = -(-B // R)
    return -(-clusters // _clusters_per_wave(C, R, m, n, itemsize, scheme))


def _cluster_shape(B: int, m: int, n: int, itemsize: int,
                   scheme: str = "halpern", max_rows: int = 8):
    """(C, R) of the cluster variant for a [B] panel, or None where it does
    not take these shapes: of the sizes of at most ``max_rows`` rows whose
    slices fit and that the card can schedule, the fewest waves, then the
    fewest rows per cluster, then the larger cluster."""
    fit = [(C, R) for C in _CLUSTER_SIZES for R in _CLUSTER_ROWS
           if R <= max_rows and _cluster_fits(C, R, m, n, itemsize, scheme)
           and _clusters_per_wave(C, R, m, n, itemsize, scheme) > 0]
    if not fit:
        return None
    return min(fit, key=lambda cr: (_waves(B, *cr, m, n, itemsize, scheme),
                                    cr[1], -cr[0]))


def _tile_smem(C: int, m: int, n: int, itemsize: int) -> int:
    """Shared memory of one CTA of a tile kernel, in bytes (mirrors
    csrc/pdhg_tile.cuh:layout; the same under either scheme and at any
    tile height): the column slice of K in whole 8 x 8 blocks (float32 at
    padded strides, :func:`_tile_k_stride`), the tile's full L and its
    reflected Yb as the products read them (float32 row-major at a row
    stride 4 elements past the padded width, float64 in
    matrix-instruction blocks), the [C, TM, mc] exchange buffer, two
    [TM, nc] vectors, two [TM, mc] vectors, bounds, q and row scalars."""
    TM = _TILE_ROWS
    nc = -(-n // C)
    ncp = -(-nc // 8) * 8
    mp = -(-m // 8) * 8
    mc = -(-(mp // 8) // C) * 8
    pad = 4 if itemsize == 4 else 0
    return (ncp // 8 * _tile_k_stride(mp // 8, itemsize)
            + TM * (mp + pad) + C * TM * mc + TM * (ncp + pad)
            + 2 * TM * (ncp + 4) + 2 * TM * mc + 3 * ncp
            + 5 * TM) * itemsize


def _tile_k_stride(nit: int, itemsize: int) -> int:
    """Elements from one column block of a tile CTA's K slice to the next
    (csrc/pdhg_tile.cuh:layout, sj): nit 8 x 8 blocks, in float32 each
    padded to 72 elements and the column block to 16 mod 32 elements."""
    if itemsize == 8:
        return nit * 64
    return nit * 72 + (16 - nit * 72 % 32) % 32


def _tile_fits(C: int, m: int, n: int, itemsize: int, arith: str) -> bool:
    """``arith`` is the dtype's arithmetic and a CTA's shared memory holds
    the tile kernel's footprint."""
    return (_TILE_ARITH.get(itemsize) == arith
            and _tile_smem(C, m, n, itemsize) <= _SMEM_MAX)


@functools.lru_cache(maxsize=256)
def _tile_clusters_per_wave(C: int, m: int, n: int, itemsize: int,
                            scheme: str = "halpern") -> int:
    """Clusters of C CTAs that the current card runs at once at these
    shapes, asked once per shape: the tile kernels launch at most so many
    and each walks its share of the tiles."""
    return _occupancy(f"pdhg_{scheme}_tile", int(itemsize == 8), C, m, n)


def _tile_passes(B: int, C: int, m: int, n: int, itemsize: int,
                 scheme: str = "halpern") -> int:
    """Tiles the busiest cluster walks for a [B] panel (the same at the
    tile height :func:`_tile_rows` picks as at 16 rows)."""
    per_wave = _tile_clusters_per_wave(C, m, n, itemsize, scheme)
    return -(-(-(-B // _TILE_ROWS)) // per_wave)


def _tile_rows(B: int, C: int, m: int, n: int, itemsize: int,
               scheme: str = "halpern") -> int:
    """Batch rows of a tile for a [B] panel: 16 in float64 (the matrix
    instruction's tile); in float32 the fewest that keep the passes of
    16-row tiles, so the tiles spread over every cluster the card runs (a
    float32 row's sums do not depend on the rows beside it)."""
    if itemsize == 8:
        return _TILE_ROWS
    per_wave = _tile_clusters_per_wave(C, m, n, itemsize, scheme)
    passes = _tile_passes(B, C, m, n, itemsize, scheme)
    return -(-B // (per_wave * passes))


def _tile_shape(B: int, m: int, n: int, itemsize: int,
                scheme: str = "halpern"):
    """(C, arith) of the tile variant for a [B] panel, or None where no
    cluster size fits: the fewest tiles in turn through the busiest
    cluster, then the larger cluster (more SMs on each tile). It picked
    the fastest size at every point of the sweep."""
    arith = _TILE_ARITH[itemsize]
    fit = [C for C in _CLUSTER_SIZES
           if _tile_fits(C, m, n, itemsize, arith)
           and _tile_clusters_per_wave(C, m, n, itemsize, scheme) > 0]
    if not fit:
        return None
    return min(fit, key=lambda C: (
        _tile_passes(B, C, m, n, itemsize, scheme), -C)), arith


def _up4(x: int) -> int:
    return -(-x // 4) * 4


def _stream_layout(C: int, m: int, n: int, itemsize: int):
    """(elements before the ring, elements of a stage, stages, fits) of a
    stream kernel's CTA (mirrors csrc/pdhg_stream.cuh:layout; the same
    under either scheme). A CTA owns nc columns, a multiple of 16 bytes.
    float32: the tile's full L [m, TM] and Yb [n, TM], the owned columns'
    Y and anchor or sum [TM, nc], the owned rows' anchor or sum and
    right-hand side [mc, TM], bounds, q and row scalars; float64: the tile
    kernel's regions without the resident K, the exchange buffer's rows
    per owner even, stages of 32 K rows at a stride of 8 mod 16. The
    stages' mbarriers take the last 32 bytes."""
    TM = _STREAM_TM
    v = 16 // itemsize
    nc = -(-(-(-n // C)) // v) * v
    if itemsize == 4:
        mc = -(-m // C)
        base = (_up4(m * TM) + _up4(n * TM) + 2 * _up4(TM * nc)
                + 2 * _up4(mc * TM) + 3 * _up4(nc) + 3 * TM)
        stage = _STREAM_STAGE32
        units_ok = stage // nc >= 1 and nc <= 512
    else:
        ncp = -(-nc // 8) * 8
        mp = -(-m // 8) * 8
        mc = (-(-m // C) + 1) // 2 * 2
        base = (TM * mp + _up4(C * TM * mc) + TM * ncp + 2 * TM * (ncp + 4)
                + 2 * _up4(TM * mc) + 3 * ncp + 3 * TM)
        stage = _STREAM_KR64 * (ncp + 8 if ncp % 16 == 0 else ncp)
        units_ok = ncp // 8 <= 32
    cap = (_SMEM_MAX - _STREAM_BAR_BYTES) // itemsize
    stages = min(_STREAM_MAX_STAGES, (cap - base) // stage) if cap > base \
        else 0
    return base, stage, stages, stages >= 2 and units_ok


def _stream_smem(C: int, m: int, n: int, itemsize: int) -> int:
    """Shared memory of one CTA of a stream kernel, in bytes: the regions,
    as many stages (at most 4) as 227 KB hold and their mbarriers; 0 where
    fewer than 2 stages fit or the threads cannot take the step."""
    base, stage, stages, ok = _stream_layout(C, m, n, itemsize)
    return (base + stages * stage) * itemsize + _STREAM_BAR_BYTES if ok \
        else 0


# copies of K laid out for a kernel, by (kind, device, dtype): (a weak
# reference to the K they come from, K's version, the copies)
_DERIVED_K = {}


def _derived(K: torch.Tensor, kind: str, make):
    """``make()``, kept while the same tensor, unmodified, comes back
    (every round of a solve hands the wrapper one K)."""
    key = (kind, K.device, K.dtype)
    held = _DERIVED_K.get(key)
    if held is not None and held[0]() is K and held[1] == K._version:
        return held[2]
    out = make()
    _DERIVED_K[key] = (weakref.ref(K), K._version, out)
    return out


def _stream_k(K: torch.Tensor):
    """(K, ldk): K with its row stride ldk padded to a multiple of 16
    bytes, zeros past column n, as the stream kernels' bulk copies need."""
    m, n = K.shape
    v = 16 // K.element_size()
    ldk = -(-n // v) * v
    if ldk == n:
        return K, ldk

    def make():
        Kp = torch.zeros((m, ldk), dtype=K.dtype, device=K.device)
        Kp[:, :n] = K
        return Kp
    return _derived(K, "stream", make), ldk


def _grid_smem(BM: int, itemsize: int) -> int:
    """Dynamic shared memory of the larger of a grid round's two kernels,
    in bytes (mirrors csrc/pdhg_grid.cuh:primal_smem and dual_smem): the
    primal phase's stages of BM rows of L (a row stride of 20 elements)
    and 16 rows of 128 columns of K, the dual phase's stages of 32 rows of
    Yb and 16 of K, 128 columns each; 0 for a float64 operand or a tile
    height the kernel does not have."""
    if itemsize != 4 or BM not in _GRID_BM:
        return 0
    primal = _GRID_STAGES * (BM * (_GRID_BK + 4) + _GRID_BK * _GRID_BN)
    dual = _GRID_STAGES * sum(_GRID_DUAL) * 128
    return max(primal, dual) * itemsize


def _grid_fits(BM: int, itemsize: int, P: int = 1) -> bool:
    """The grid kernel takes primal tiles of BM rows of this dtype, the
    panel in P parts."""
    return P in _GRID_PARTS and 0 < _grid_smem(BM, itemsize) <= _SMEM_MAX


def _grid_shape(B: int, m: int, n: int, itemsize: int):
    """(BM, P) of the grid variant for a [B] panel, or None for a dtype it
    does not take: the tallest primal tile whose tiles fill every SM twice
    (two CTAs of 2 BM threads fit an SM), else the shortest; parts of at
    least 512 rows, at most 4 (the sweep at storm's rungs: 4 parts of 1024
    rows at B = 4096, 2 of 512 at 1024)."""
    fit = [BM for BM in _GRID_BM if _grid_fits(BM, itemsize)]
    if not fit:
        return None
    P = min(max(_GRID_PARTS), max(1, -(-B // _GRID_PART_ROWS)))
    cols = -(-n // _GRID_BN)
    for BM in fit:
        if -(-B // BM) * cols >= 2 * _sm_count():
            return BM, P
    return fit[-1], P


def _grid_k(K: torch.Tensor):
    """(Kp, Kr): K with its rows padded to a multiple of 16 and its columns
    to one of 128 (zeros), as the grid kernels' unmasked stages read it,
    and the same with the columns of every block of 128 residue-major
    (position 4 l + k holds column 32 k + l), the dual phase's operand.
    Kept while the same tensor, unmodified, comes back."""
    def make():
        m, n = K.shape
        mK = -(-m // _GRID_M_ROUND) * _GRID_M_ROUND
        ldk = -(-n // _GRID_BN) * _GRID_BN
        Kp = torch.zeros((mK, ldk), dtype=K.dtype, device=K.device)
        Kp[:m, :n] = K
        Kr = Kp.view(mK, ldk // 128, 4, 32).transpose(2, 3).reshape(mK, ldk)
        return Kp, Kr.contiguous()
    return _derived(K, "grid", make)


def _stream_fits(C: int, TM: int, m: int, n: int, itemsize: int) -> bool:
    """The stream kernel takes (C, TM) at these shapes: a cluster size it
    is launched with, tiles of 16 rows, and a footprint that fits."""
    return (C in _STREAM_SIZES and TM == _STREAM_TM
            and 0 < _stream_smem(C, m, n, itemsize) <= _SMEM_MAX)


@functools.lru_cache(maxsize=256)
def _stream_clusters_per_wave(C: int, m: int, n: int, itemsize: int,
                              scheme: str = "halpern") -> int:
    """Clusters of C CTAs of the scheme's stream kernel that the current
    card runs at once at these shapes, asked once per shape."""
    return _occupancy(f"pdhg_{scheme}_stream", int(itemsize == 8), C,
                      _STREAM_TM, m, n)


def _stream_step_cost(C: int, m: int, n: int, itemsize: int) -> int:
    """The busiest thread's (float32) or warp's (float64) products in one
    step of a tile on a cluster of C: float32 FMAs of its G units (one per
    8 rows of an owned column; 512 threads) and of its S rows (a warp per
    owned row, 16 batch rows per lane and column); float64 matrix
    instructions of its G column tiles and of its S row tiles (4 warps per
    chunk of 32 rows)."""
    nc = -(-n // C)
    if itemsize == 4:
        mc = -(-m // C)
        return (-(-2 * nc // 512) * m * 8
                + -(-mc // 16) * -(-n // 32) * 16)
    njt = -(-nc // 8)
    mp = -(-m // 8) * 8
    return -(-njt // 16) * mp // 8 + -(-mp // _STREAM_KR64) * njt


def _stream_shape(B: int, m: int, n: int, itemsize: int,
                  scheme: str = "halpern"):
    """(C, TM) of the stream variant for a [B] panel, or None where no
    cluster size fits: the fewest waves of tiles times the busiest
    thread's products in a step, then the larger cluster."""
    fit = [C for C in _STREAM_SIZES
           if _stream_fits(C, _STREAM_TM, m, n, itemsize)
           and _stream_clusters_per_wave(C, m, n, itemsize, scheme) > 0]
    if not fit:
        return None
    tiles = -(-B // _STREAM_TM)

    def cost(C):
        per_wave = _stream_clusters_per_wave(C, m, n, itemsize, scheme)
        return -(-tiles // per_wave) * _stream_step_cost(C, m, n, itemsize)
    return min(fit, key=lambda C: (cost(C), -C)), _STREAM_TM


def _small_smem(R: int, G: int, m: int, n: int, itemsize: int,
                q_rows: int = 1) -> int:
    """Dynamic shared memory of a small kernel's block of G groups of R
    rows, in bytes (mirrors csrc/pdhg_small.cuh:smem_bytes; the same under
    either scheme): K [mp, ldk], lb, ub and a shared q [np], then for each
    row Y, its anchor or sum, Yb, a per-row q (``q_rows``) [np] and L, its
    anchor or sum, ht [mp]; then is_eq in bytes. mp and np are m and n
    padded to multiples of 4 and ldk is n, or 8, 32 and 32 elements and
    16 bytes in the tiny layout (n up to _SMALL_TINY_N, m up to
    _SMALL_TINY_M)."""
    tiny = n <= _SMALL_TINY_N and m <= _SMALL_TINY_M
    mp, np_, ldk = ((_SMALL_TINY_M, _SMALL_TINY_N,
                     _SMALL_TINY_N + 16 // itemsize) if tiny
                    else (_up4(m), _up4(n), n))
    fixed = mp * ldk + (2 if q_rows else 3) * np_
    row = (4 if q_rows else 3) * np_ + 3 * mp
    return (fixed + G * R * row) * itemsize + _up4(m)


def _small_fits(W: int, R: int, G: int, m: int, n: int, itemsize: int,
                q_rows: int = 1) -> bool:
    """The small kernel takes groups of W warps and R rows, G a block, at
    these shapes (per-row q assumed unless ``q_rows`` is 0)."""
    return (W in _SMALL_WARPS and R in _SMALL_ROWS and isinstance(G, int)
            and G >= 1 and G * W <= _SMALL_MAX_WARPS and m > 0 and n > 0
            and _small_smem(R, G, m, n, itemsize, q_rows) <= _SMEM_MAX)


def _small_groups(B: int, W: int, R: int, m: int, n: int,
                  itemsize: int) -> int:
    """Groups a block of the small kernel carries for a [B] panel: as many
    as the block's warps and shared memory (per-row q assumed) allow while
    the panel still gives every SM a block (each block copies K once for
    all its rows); at least 1."""
    rows_per_sm = -(-B // _sm_count())
    G = 1
    while (G * 2 * W <= _SMALL_MAX_WARPS and G * 2 * R <= rows_per_sm
           and _small_fits(W, R, G * 2, m, n, itemsize)):
        G *= 2
    return G


def _small_shape(B: int, m: int, n: int, itemsize: int):
    """(W, R) of the small variant for a [B] panel, or None where one group
    of a row does not fit a block. From the sweep (chip_smoke.py --phases
    sweep, PERF.md §6): W_lat is n / 16 warps rounded up to a power of 2,
    at most 8 (lands 1, transship 8, baa99-20 8). While the panel gives
    each SM at most 2 rows, a group carries 1 row on W_lat warps (latency
    bounds the step); up to 8 rows an SM, 2 rows (the tiny layout) or 4 on
    W_lat warps; past that 4 rows on a quarter of them, so more rows share
    each block's copy of K. Every shape it gives measured faster than the
    row-block kernel in the sweep."""
    W = next((w for w in _SMALL_WARPS if _SMALL_COLS_PER_WARP * w >= n),
             _SMALL_MAX_LAT_WARPS)
    W = min(W, _SMALL_MAX_LAT_WARPS)
    if not _small_fits(W, 1, 1, m, n, itemsize):
        return None
    rows_per_sm = -(-B // _sm_count())
    if rows_per_sm <= _SMALL_LATENCY_ROWS:
        return W, 1
    tiny = n <= _SMALL_TINY_N and m <= _SMALL_TINY_M
    if rows_per_sm <= _SMALL_THROUGHPUT_ROWS:
        R = 2 if tiny else 4
    else:
        W, R = max(1, W // 4), 4
    while R > 1 and not _small_fits(W, R, 1, m, n, itemsize):
        R //= 2
    return W, R


@functools.lru_cache(maxsize=512)
def _plan(B: int, m: int, n: int, itemsize: int,
          scheme: str = "halpern") -> tuple:
    """The variant of the scheme's round for a [B] panel of an [m, n] K:
    ``("cluster", C, R)``, ``("tile", C, arith)``, ``("stream", C, TM)``,
    ``("grid", BM, P)``, ``("small", W, R)`` or ``("rows", ROWS)``. A
    function of the shapes, the dtype's size and the card's SM count, and
    for a K of at least ``_CLUSTER_MIN_K_BYTES`` of the card's cluster
    occupancy: a panel that one wave of small clusters holds takes the
    cluster kernel, a larger one the tile kernel; where no tile shape fits,
    the grid kernel takes the float32 panels the cluster kernel does not
    (storm's from 85 rows), the stream kernel the float64 ones up to its
    ``_STREAM_MAX_ROWS``, and what fits none of them the row-block kernel
    (storm's float64 average round past 256 rows). A smaller K takes the
    small kernel wherever a group of its rows fits a block."""
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}")
    if m * n * itemsize >= _CLUSTER_MIN_K_BYTES:
        tile = _tile_shape(B, m, n, itemsize, scheme)
        grid = _grid_shape(B, m, n, itemsize) \
            if tile is None and itemsize in _GRID_ITEMSIZES else None
        most = _STREAM_MAX_ROWS[itemsize, scheme]
        stream = _stream_shape(B, m, n, itemsize, scheme) \
            if tile is None and grid is None \
            and itemsize in _STREAM_ITEMSIZES \
            and (most is None or B <= most) else None
        if tile is not None:
            max_rows, max_waves = _CLUSTER_MAX_ROWS_VS_TILE, 1
        elif stream is not None or grid is not None:
            max_rows, max_waves = 8, _CLUSTER_MAX_WAVES_VS_STREAM
        else:
            max_rows, max_waves = 8, _CLUSTER_MAX_WAVES
        shape = _cluster_shape(B, m, n, itemsize, scheme, max_rows)
        if shape is not None and _waves(B, *shape, m, n, itemsize, scheme) \
                <= max_waves:
            return ("cluster",) + shape
        if tile is not None:
            return ("tile",) + tile
        if grid is not None:
            return ("grid",) + grid
        if stream is not None:
            return ("stream",) + stream
    elif itemsize in _SMALL_ITEMSIZES:
        small = _small_shape(B, m, n, itemsize)
        if small is not None:
            return ("small",) + small
    return ("rows", _rows_per_block(f"pdhg_{scheme}_round", B,
                                    _row_values(m, n, scheme) * itemsize))


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
        if rows * per_row <= _SMEM_BUDGET and -(-B // rows) >= 2 * _sm_count():
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


def _no_plan_on_cpu(name: str, plan) -> None:
    """CPU tensors run the plain version, which no plan names: a forced
    plan raises rather than falling back."""
    if plan is not None:
        raise ValueError(f"{name}: plan {plan!r} names a CUDA kernel, but "
                         f"the operands are CPU tensors (the plain version "
                         f"takes no plan)")


def _launch(scheme: str, plan: tuple, K, operands, B: int, m: int, n: int,
            n_inner: int) -> None:
    """Launch the scheme's kernel variant that ``plan`` names on the
    current stream, raise if the launch is refused, and count it."""
    name = f"pdhg_{scheme}_round"
    if not (isinstance(plan, tuple) and plan
            and plan[0] in ("rows", "cluster", "tile", "stream", "grid",
                            "small")
            and len(plan) in ((2,) if plan[0] == "rows" else
                              (3, 4) if plan[0] == "tile" else (3,))):
        raise ValueError(f"{name}: unknown plan {plan!r}")
    it = K.element_size()
    if plan[0] == "rows":
        stem, head = name, (plan[1],)
    elif plan[0] == "cluster":
        stem, head = f"pdhg_{scheme}_cluster", plan[1:]
    elif plan[0] == "stream":
        C, TM = plan[1:]
        if not _stream_fits(C, TM, m, n, it):
            raise ValueError(f"{name}: no stream kernel for {plan!r} at "
                             f"m={m} n={n} itemsize={it}")
        if _stream_clusters_per_wave(C, m, n, it, scheme) <= 0:
            raise ValueError(f"{name}: the card cannot schedule {plan!r}")
        Kp, ldk = _stream_k(K)
        stem, head = f"pdhg_{scheme}_stream", (C, TM, ldk)
        operands = (Kp,) + tuple(operands[1:])
    elif plan[0] == "small":
        W, R = plan[1:]
        if not (isinstance(W, int) and isinstance(R, int)
                and _small_fits(W, R, 1, m, n, it)):
            raise ValueError(f"{name}: no small kernel for {plan!r} at "
                             f"m={m} n={n} itemsize={it} (W in "
                             f"{_SMALL_WARPS}, R in {_SMALL_ROWS}, a group "
                             f"within {_SMEM_MAX} B)")
        stem = f"pdhg_{scheme}_small"
        head = (W, R, _small_groups(B, W, R, m, n, it))
    elif plan[0] == "grid":
        BM, P = plan[1:]
        if not (isinstance(BM, int) and isinstance(P, int)
                and _grid_fits(BM, it, P)):
            raise ValueError(f"{name}: no grid kernel for {plan!r} at "
                             f"itemsize={it} (float32 only, BM in "
                             f"{_GRID_BM}, P in {_GRID_PARTS})")
        Kp, Kr = _grid_k(K)
        mK, ldk = Kp.shape
        Bp = -(-B // _GRID_B_ROUND) * _GRID_B_ROUND
        Ls = torch.empty((Bp, mK), dtype=K.dtype, device=K.device)
        Ybr = torch.empty((Bp, ldk), dtype=K.dtype, device=K.device)
        stem = f"pdhg_{scheme}_grid"
        head = (BM, P, ldk, mK, Kr.data_ptr(), Ls.data_ptr(),
                Ybr.data_ptr())
        operands = (Kp,) + tuple(operands[1:])
    else:
        C, arith = plan[1:3]
        tm = plan[3] if len(plan) == 4 else None
        if not (_tile_fits(C, m, n, it, arith) and (
                tm is None or isinstance(tm, int) and (
                    tm == _TILE_ROWS or it == 4 and 1 <= tm < _TILE_ROWS))):
            raise ValueError(f"{name}: no tile kernel for {plan!r} at "
                             f"m={m} n={n} itemsize={it}")
        per_wave = _tile_clusters_per_wave(C, m, n, it, scheme)
        if per_wave <= 0:
            raise ValueError(f"{name}: the card cannot schedule {plan!r}")
        if tm is None:
            tm = _tile_rows(B, C, m, n, it, scheme)
        stem = f"pdhg_{scheme}_tile"
        head = (C, min(-(-B // tm), per_wave), tm)
    fn = getattr(build.load(), f"{stem}_f64" if it == 8 else f"{stem}_f32")
    stream = torch.cuda.current_stream(K.device).cuda_stream
    with torch.cuda.device(K.device):
        code = fn(*head, *(t if isinstance(t, int) else t.data_ptr()
                           for t in operands), B, m, n, int(n_inner), stream)
    build.check(code, f"{name} {plan}")
    count_launch(scheme, plan, B, it)


def pdhg_halpern_round(K, q, lb, ub, is_eq, ht, tau, sig, Y, L, kh, Yanc,
                       Lanc, n_inner: int, *, plan: Optional[tuple] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """One Halpern restart round; returns (Ycarry, Lcarry, Ycand, Lcand).

    K [m, n]; q [n] shared or [B, n] per element; lb, ub [n] (finite
    sentinels); is_eq [m] bool; ht [B, m]; tau, sig, kh [B]; Y, Yanc
    [B, n]; L, Lanc [B, m]. CUDA tensors launch the kernel variant that
    ``plan`` names (default :func:`_plan` of the shapes), CPU tensors run
    the plain version (and raise if a plan is forced); anything else
    raises. A refused launch raises.
    """
    name = "pdhg_halpern_round"
    if not _kernel_device(name, K):
        _no_plan_on_cpu(name, plan)
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
        plan = _plan(B, m, n, K.element_size(), "halpern")
    _launch("halpern", plan, K,
            (K, q, int(q.dim() == 2), lb, ub, is_eq, ht, tau, sig, Y, L, kh,
             Yanc, Lanc, Yo, Lo, Yc, Lc), B, m, n, n_inner)
    return Yo, Lo, Yc, Lc


def pdhg_average_round(K, q, lb, ub, is_eq, ht, tau, sig, Y, L,
                       n_inner: int, *, plan: Optional[tuple] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """One restart-to-average round; returns (Y, L, Yavg, Lavg).

    Operands as for :func:`pdhg_halpern_round` without the Halpern step
    count and anchors. CUDA tensors launch the kernel variant that ``plan``
    names (default :func:`_plan` of the shapes under the average scheme),
    CPU tensors run the plain version (and raise if a plan is forced);
    anything else raises.
    """
    name = "pdhg_average_round"
    if not _kernel_device(name, K):
        _no_plan_on_cpu(name, plan)
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
    if plan is None:
        plan = _plan(B, m, n, K.element_size(), "average")
    _launch("average", plan, K,
            (K, q, int(q.dim() == 2), lb, ub, is_eq, ht, tau, sig, Y, L, Yo,
             Lo, Ya, La), B, m, n, n_inner)
    return Yo, Lo, Ya, La
