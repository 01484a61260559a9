// PDHG round for large batches, both restart schemes: tiles of at most
// 16 batch rows, K resident in the shared memory of a thread-block cluster
// that walks the tiles in turn (Hopper, sm_90a).
// Instantiated by pdhg_halpern_tile.cu (reflected Halpern, AVG = false) and
// pdhg_average_tile.cu (restart to the average, AVG = true); the step's
// two products are written once here, so both schemes reduce in the same
// order. The step is the one pdhg_cluster.cuh states.
//
// The layout of the work (unchanged since the kernel was first written):
//
// - K resident: a cluster of C CTAs; CTA c owns the column slice
//   [c nc, (c+1) nc) of K and keeps it in its shared memory for the whole
//   launch, zero-padded to whole 8 x 8 blocks. The cluster is persistent:
//   it walks the row tiles cid, cid + nclusters, ...
// - A tile's iterate lives in shared memory: every CTA holds the tile's
//   full L [tm, m] (an operand of its primal product) and, for its own
//   columns, Y, the reflected Yb and the anchor (Halpern) or running sum
//   (average). The dual update is split by constraint row: CTA c owns rows
//   [c mc, (c+1) mc), whole blocks of 8, and keeps their anchor or running
//   sum and right-hand side.
// - Primal product G = L K[:, slice], its epilogue updating Y, Yb and the
//   anchor blend or sum in place; dual product, this CTA's share of
//   Yb K^T, stored into the exchange buffer of the CTA that owns the
//   constraint row over distributed shared memory (stores only: loads
//   through a mapped pointer were measured at a full round trip each).
//   After a cluster barrier the owner sums the C shares in rank order
//   0..C-1, updates L and stores the new value into every CTA's copy; a
//   second cluster barrier ends the step. Every sum has a fixed order (no
//   atomics): two launches are bitwise equal.
// - Arithmetic, one per dtype: float64 on mma.sync.m16n8k8.f64 (full IEEE),
//   float32 as scalar FP32 FMAs in the float64 instruction's order: per
//   output, blocks of 8 k in ascending order, each an fmaf chain in
//   ascending k into s, then acc += s (the one float32 arithmetic that
//   passes both float32 gates, chip_smoke.py:_f32_gate; the tensor-core
//   candidates and the gates they failed are in PERF.md section 6).
//
// What bounds it, and what this design does about it (NVIDIA H100 80GB
// HBM3, 700 W, ssn, C = 4, float32; PERF.md section 6). The first design
// spent 17 of a 16-row step's 21 us in the float32 products: L and Yb
// followed the float64 fragments, so a warp's 16-byte loads hit the same
// banks four ways (L) or two (K), the dual product read K one scalar per
// FMA column: its loops issued 12 (primal) and 36 (dual) loads per 64
// FMAs. Now:
// - float32 keeps L and Yb row-major at a row stride of 4 mod 8 elements
//   and pads K's 8 x 8 blocks to strides of 8 (rows) and 16 (columns) mod
//   32 elements, so the words a quarter warp reads fall in distinct banks
//   or are one word broadcast. A lane owns R rows by 4 outputs (R = 2 from
//   13 rows, else tm / 4 rounded up): the primal product reads a column's
//   8 rows as two words, the dual product 4 constraint rows of a column as
//   one, 2 R + 8 words per block of 8 k for 32 R FMAs, all in registers.
//   The loop is bound by instruction issue, not by shared memory: at 16
//   rows a product takes about 4.8 us a step (split by building the
//   kernel with parts left out), where its FMAs alone take 4,050 cycles
//   at 128 a cycle.
// - float32 tiles are as short as the panel's 16-row passes allow (tm,
//   ops/cuda/pdhg_kernel.py:_tile_rows), so a panel that would leave
//   clusters idle spreads over the card (256 rows: 29 tiles of 9 on 30
//   clusters, not 16 of 16); rows are independent, so no output's sum
//   changes with tm. float64 keeps 16-row mma tiles.
// - The float32 epilogues run apart from the products, over all 12 warps
//   in 16-byte words; the dual update reads and stores words too (the
//   new L into every CTA's copy with one st.shared::cluster.v4 per CTA),
//   and the owner's operands are read between the first cluster
//   barrier's arrive and its wait. The epilogues' roundings are pinned
//   (fma_rn, blend) to the ones the first design compiled to, and
//   chip_smoke.py holds every output to the first design's bits.
// - What is left outside the products is about 3.8 us of a 16-row step:
//   the two cluster barriers, two CTA barriers, the epilogues and the
//   update. The algorithm needs both exchanges a step. Two tiles in
//   flight, which could hide one, and bulk copies of the next tile, do
//   not fit beside K at any shape the plan sends here
//   (ops/cuda/pdhg_kernel.py:_tile_smem: 209 KB of 227 at ssn f32 on 4
//   CTAs, 224 at ssn f64 on 8; a 16-row tile's rows take 42 KB in f32).

// Rows past B in the ragged last tile run on zeros and are never written
// back. Candidates and averages are written from the last step's
// epilogues, so no buffer holds them.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "pdhg_common.cuh"

namespace pdhg_tile {

namespace cg = cooperative_groups;

using pdhg::clip;
using Args = pdhg::RoundArgs;

// 12 warps: the float64 products keep them busy at ssn (23 column and 22
// row blocks, two a warp), three on each of the SM's schedulers, and so do
// the float32 ones at 16 rows (368 lane units of 2 rows by 4 outputs);
// the float32 epilogues and both dtypes' dual updates take all 12
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemMax = 227 * 1024;

// batch rows a tile holds at most; float64 tiles hold exactly this many
// (one 16-row matrix-instruction tile on every warp)
constexpr int kTM = 16;

// offsets, in elements, of a CTA's shared-memory regions (mirrored by
// ops/cuda/pdhg_kernel.py:_tile_smem); every region is a multiple of 4
// elements long. lm and ln are the row strides of L and Yb: float32 keeps
// them row-major at mp + 4 and ncp + 4, float64 in mma A-fragment blocks.
// si and sj are the strides of K's 8 x 8 blocks along its rows and its
// columns: float32 pads them to 8 and 16 mod 32 elements, so the 16-byte
// words that a quarter warp reads from neighbouring units' blocks fall in
// distinct banks; float64 keeps them packed.
struct Layout {
  int nc, ncp, mp, ys, mc, lm, ln, si, sj;
  size_t Ks, Lf, Rx, Yb, Yc, Ya, La, hs, lbs, ubs, qs, rows, total;
};

__host__ __device__ inline Layout layout(int C, int m, int n, bool f32) {
  Layout l;
  l.nc = (n + C - 1) / C;        // columns a CTA owns
  l.ncp = (l.nc + 7) / 8 * 8;    // padded to whole blocks of 8
  l.mp = (m + 7) / 8 * 8;
  l.ys = l.ncp + 4;              // stride of a row-major [*, nc] row
  l.mc = (l.mp / 8 + C - 1) / C * 8;      // constraint rows a CTA owns
  l.lm = f32 ? l.mp + 4 : l.mp;
  l.ln = f32 ? l.ncp + 4 : l.ncp;
  const int nit = l.mp / 8;
  l.si = f32 ? 72 : 64;
  l.sj = f32 ? nit * 72 + (16 - nit * 72 % 32 + 32) % 32 : nit * 64;
  size_t o = 0;
  l.Ks = o;   o += static_cast<size_t>(l.ncp / 8) * l.sj;  // 8 x 8 blocks
  l.Lf = o;   o += static_cast<size_t>(kTM) * l.lm;
  l.Rx = o;   o += static_cast<size_t>(C) * kTM * l.mc;  // [C][TM][mc] shares
  l.Yb = o;   o += static_cast<size_t>(kTM) * l.ln;
  l.Yc = o;   o += static_cast<size_t>(kTM) * l.ys;     // [TM][ys] Y
  l.Ya = o;   o += static_cast<size_t>(kTM) * l.ys;     // anchor | sum
  l.La = o;   o += static_cast<size_t>(kTM) * l.mc;     // [TM][mc] anchor|sum
  l.hs = o;   o += static_cast<size_t>(kTM) * l.mc;     // [TM][mc] rhs
  l.lbs = o;  o += l.ncp;
  l.ubs = o;  o += l.ncp;
  l.qs = o;   o += l.ncp;                               // shared q
  l.rows = o; o += 5 * static_cast<size_t>(kTM);  // tau, sig, kh, w[2]
  l.total = o;
  return l;
}

// float64: where element (r, k) of a [16, 8 ksteps] operand of the A side
// lives, in elements from the buffer's start: 16 x 8 blocks of 128
// elements in (row block, k step) order; in a block the four values of
// lane 4 (r % 8) + k % 4 are adjacent, in the order of the instruction's A
// registers.
__device__ __forceinline__ int a_offset(int r, int k, int ksteps) {
  return ((r >> 4) * ksteps + (k >> 3)) * 128 +
         ((((r & 7) << 2) + (k & 3)) << 2) + (((k >> 2) & 1) << 1) +
         ((r >> 3) & 1);
}

// Where element (i, j) of the K slice lives: 8 x 8 blocks, block (i / 8,
// j / 8) at (j / 8) sj + (i / 8) si; in a block, (i % 8, j % 8) at
// 2 (4 (j % 8) + i % 4) + (i % 8) / 4. A column's 8 rows are adjacent
// (rows 0 4 1 5 | 2 6 3 7: two 16-byte words), and so are, for one
// column, the 8 rows as words {0 4 1 5} and {2 6 3 7}.
__device__ __forceinline__ int k_offset(int i, int j, int si, int sj) {
  return (j >> 3) * sj + (i >> 3) * si +
         ((((j & 7) << 2) + (i & 3)) << 1) + ((i >> 2) & 1);
}

// The address, in the cluster's shared window, of this CTA's shared
// variable p in the CTA of that rank
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;"
               :: "r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;"
               :: "r"(addr), "d"(v) : "memory");
}
__device__ __forceinline__ void st_cluster2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
               :: "r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ void st_cluster2(uint32_t addr, double a,
                                            double b) {
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};"
               :: "r"(addr), "d"(a), "d"(b) : "memory");
}
__device__ __forceinline__ void st_cluster4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// the cluster barrier in its two halves: stores before the arrive are
// visible to every CTA of the cluster after its wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mma_f64(double (&c)[4],
                                        const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The accumulator of one 16 x 8 output tile; with g = lane / 4 and tig =
// lane % 4 a lane holds (g, 2 tig) (g, 2 tig + 1) (g + 8, 2 tig) (g + 8,
// 2 tig + 1), under either type (pdhg_stream.cuh uses both).
template <typename T>
struct Acc {
  T v[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = T(0);
  }
};

// a warp's share of a float64 product: all 16 rows by kNTW tiles of 8
// columns, so that every A fragment read from shared memory serves
// several matrix instructions
constexpr int kNTW = 2;

// float64: acc[nt] += A[0 .. 16, 0 .. 8 ksteps) Bt[:, 8 nt .. 8 nt + 8),
// each k step one 16 x 8 x 8 warp product per column tile. A lane holds
//   a: (g, tig) (g + 8, tig) (g, tig + 4) (g + 8, tig + 4)   [row, k]
//   b: (tig, g) (tig + 4, g)                                 [k, column]
// As: the A-side buffer (a_offset order). Bs: K's block of the first
// column tile and k step 0; b_nt and b_ks elements further lie the next
// column tile and the next k step. PRIMAL: the product reduces over K's
// rows (a lane's two values adjacent), else over its columns. Column tiles
// past ntiles are skipped. The next step's operands are read before this
// step's instructions start.
template <bool PRIMAL>
__device__ __forceinline__ void tile_product(const double* As,
                                             const double* Bs, int b_nt,
                                             int b_ks, int ntiles,
                                             int ksteps, int lane,
                                             Acc<double> (&acc)[kNTW]) {
  const int b_at = PRIMAL ? 2 * lane
                          : ((((lane & 3) << 2) + ((lane >> 2) & 3)) << 1) +
                                (lane >> 4);
  // two operand sets in turn, so that no set is copied
  auto read = [&](int ks, double (&a)[4], double (&b)[kNTW][2]) {
#pragma unroll
    for (int nt = 0; nt < kNTW; ++nt) {
      const double* Bb = Bs + nt * b_nt + ks * b_ks + b_at;
      const bool ok = nt < ntiles;
      b[nt][0] = ok ? Bb[0] : 0.0;
      b[nt][1] = ok ? Bb[PRIMAL ? 1 : 32] : 0.0;
    }
    const double* blk = As + ks * 128 + 4 * lane;   // a lane's 4 adjacent
    const double2 u = *reinterpret_cast<const double2*>(blk);
    const double2 w = *reinterpret_cast<const double2*>(blk + 2);
    a[0] = u.x; a[1] = u.y; a[2] = w.x; a[3] = w.y;
  };
  auto step = [&](const double (&a)[4], const double (&b)[kNTW][2]) {
#pragma unroll
    for (int nt = 0; nt < kNTW; ++nt) mma_f64(acc[nt].v, a, b[nt]);
  };
  double a0[4], a1[4], b0[kNTW][2], b1[kNTW][2];
  read(0, a0, b0);
  for (int ks = 0; ks < ksteps; ks += 2) {
    const bool odd = ks + 1 < ksteps;
    if (odd) read(ks + 1, a1, b1);
    step(a0, b0);
    if (odd) {
      if (ks + 2 < ksteps) read(ks + 2, a0, b0);
      step(a1, b1);
    }
  }
}

// The epilogues' roundings, pinned (pdhg_common.cuh) to the ones nvcc's
// contraction gave the first design (its SASS): y - tau (q - g) as
// fma(-tau, q - g, y), l + sig (h - s) as fma(sig, h - s, l), and the
// Halpern blend w x + (1 - w) y as fma(1 - w, y, w x) with w x rounded
using pdhg::blend;
using pdhg::fma_rn;
using pdhg::mul_rn;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// float32, one lane's unit: R batch rows of A (row-major, the row at
// A + rr rstride for rr < R, k from 0) by 4 outputs, over nkb blocks of
// 8 k in ascending order; per output and block an fmaf chain over the
// block's k in ascending order into s, then acc += s. Kb: the unit's
// words in K's block of k block 0, kstride elements to the next block.
// PRIMAL: the outputs are 4 columns of the block, two apart, column c two
// words at Kb + 16 c (rows 0 4 1 5 | 2 6 3 7); else the 4 rows of
// one word (rows {0 4 1 5} or {2 6 3 7} of the block), the word of column
// j at Kb + 8 j. The loop is issue-bound: reading the next block's A
// words ahead, into a copy or a second register set, measured slower than
// unrolling it 4 times and leaving the order of the loads to the
// compiler.
template <int R, bool PRIMAL>
__device__ __forceinline__ void fma_rows(const float* A, int rstride,
                                         const float* Kb, int kstride,
                                         int nkb, float (&acc)[R][4]) {
#pragma unroll 4
  for (int kb = 0; kb < nkb; ++kb) {
    float a[R][8];                       // [row][k]
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float4 lo = ld4(A + rr * rstride + 8 * kb);
      const float4 hi = ld4(A + rr * rstride + 8 * kb + 4);
      a[rr][0] = lo.x; a[rr][1] = lo.y; a[rr][2] = lo.z; a[rr][3] = lo.w;
      a[rr][4] = hi.x; a[rr][5] = hi.y; a[rr][6] = hi.z; a[rr][7] = hi.w;
    }
    const float* B = Kb + kb * kstride;
    if constexpr (PRIMAL) {
      // two columns at a time: 2 R independent chains
#pragma unroll
      for (int c = 0; c < 4; c += 2) {
        float b[2][8];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float4 u = ld4(B + 16 * (c + cc));
          const float4 w = ld4(B + 16 * (c + cc) + 4);
          b[cc][0] = u.x; b[cc][1] = u.z; b[cc][2] = w.x; b[cc][3] = w.z;
          b[cc][4] = u.y; b[cc][5] = u.w; b[cc][6] = w.y; b[cc][7] = w.w;
        }
        float s[R][2];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) s[rr][0] = s[rr][1] = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
              s[rr][cc] = fmaf(a[rr][k], b[cc][k], s[rr][cc]);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          acc[rr][c] += s[rr][0];
          acc[rr][c + 1] += s[rr][1];
        }
      }
    } else {
      float s[R][4];
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int y = 0; y < 4; ++y) s[rr][y] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 u = ld4(B + 8 * j);
        const float b[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            s[rr][y] = fmaf(a[rr][j], b[y], s[rr][y]);
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[rr][y] += s[rr][y];
    }
  }
}

// N adjacent values of T, read and written as one word
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};
template <int N, typename T>
__device__ __forceinline__ Vec<T, N> ldv(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}
template <typename T, int N>
__device__ __forceinline__ void stv(T* p, const Vec<T, N>& x) {
  *reinterpret_cast<Vec<T, N>*>(p) = x;
}

// f(std::integral_constant<int, R>()) for R = rows of 1 to 4
template <typename F>
__device__ __forceinline__ void rows_dispatch(int rows, F&& f) {
  switch (rows) {
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    case 3: f(std::integral_constant<int, 3>()); break;
    default: f(std::integral_constant<int, 4>()); break;
  }
}

template <typename T, bool AVG>
__global__ void __launch_bounds__(kThreads, 1)
pdhg_tile_kernel(const T* __restrict__ K, const T* __restrict__ q,
                 int q_per_row, const T* __restrict__ lb,
                 const T* __restrict__ ub, const uint8_t* __restrict__ is_eq,
                 const T* __restrict__ ht, const T* __restrict__ tau,
                 const T* __restrict__ sig, const T* __restrict__ Y0,
                 const T* __restrict__ L0, const T* __restrict__ kh,
                 const T* __restrict__ Yanc, const T* __restrict__ Lanc,
                 T* __restrict__ Yout, T* __restrict__ Lout,
                 T* __restrict__ Yout2, T* __restrict__ Lout2, int B, int m,
                 int n, int n_inner, int C, int tm) {
  constexpr bool F32 = sizeof(T) == 4;
  // constraint rows of one dual-update item: float32 a 16-byte word
  // (its new L goes to every CTA in one store), float64 one
  constexpr int V = F32 ? 4 : 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / C;
  const int nclusters = gridDim.x / C;
  const Layout lay = layout(C, m, n, F32);
  const int ncp = lay.ncp, mp = lay.mp, ys = lay.ys, mc = lay.mc;
  const int lm = lay.lm, ln = lay.ln;
  const int nit = mp / 8;                             // row blocks of K
  const int njt = ncp / 8;                            // column blocks
  const int c0 = rank * lay.nc;                       // first owned column
  const int ncl = max(0, min(lay.nc, n - c0));        // owned columns
  const int i0 = rank * mc;                           // first owned row
  const int si = lay.si, sj = lay.sj;
  // float32: a lane's R rows p, p + G, ..., p + (R - 1) G of the tile:
  // 2 from 13 rows (G = 7 or 8: 322-368 lane units a product, 3 warps on
  // each scheduler), else tm / 4 rounded up (fewer, longer units measured
  // faster there)
  const int R = tm > 12 ? 2 : (tm + 3) >> 2;
  const int G = (tm + R - 1) / R;
  const int tid = threadIdx.x;
  // float32: this thread's first epilogue item (row er, columns 4 ej ..
  // 4 ej + 3) of the tile's [tm, ncl] outputs in words of 4 columns,
  // row-major, kThreads apart
  const int nw = (ncl + 3) / 4;
  const int nw_e = max(nw, 1);
  const int er = nw > 0 ? tid / nw_e : kTM;
  const int ej = tid - er * nw_e;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* Ks = smem + lay.Ks;
  T* Lf = smem + lay.Lf;
  T* Rx = smem + lay.Rx;
  T* Yb = smem + lay.Yb;
  T* Yc = smem + lay.Yc;
  T* Ya = smem + lay.Ya;
  T* La = smem + lay.La;
  T* hs = smem + lay.hs;
  T* lbs = smem + lay.lbs;
  T* ubs = smem + lay.ubs;
  T* qs = smem + lay.qs;
  T* taus = smem + lay.rows;
  T* sigs = taus + kTM;
  T* khs = sigs + kTM;
  T* ws = khs + kTM;                                  // [2][TM]

  // where L's element (r, i) lives in every CTA's copy
  auto l_at = [&](int r, int i) {
    return F32 ? r * lm + i : a_offset(r, i, nit);
  };

  // the resident slice of K once per launch; every buffer but the
  // exchange buffer (other CTAs store into it) zeroed, so rows a short
  // tile leaves out hold zeros
  {
    constexpr int W = 16 / sizeof(T);     // values of a 16-byte word
    const int rx0 = static_cast<int>(lay.Rx) / W;
    const int rx1 = static_cast<int>(lay.Yb) / W;
    const int end = static_cast<int>(lay.total + W - 1) / W;
    Vec<T, W> zero;
#pragma unroll
    for (int v = 0; v < W; ++v) zero.v[v] = T(0);
    for (int idx = tid; idx < end; idx += kThreads)
      if (idx < rx0 || idx >= rx1) stv(smem + W * idx, zero);
  }
  __syncthreads();
  for (int jl = tid; jl < ncp; jl += kThreads) {
    const bool ok = jl < ncl;
    lbs[jl] = ok ? lb[c0 + jl] : T(0);
    ubs[jl] = ok ? ub[c0 + jl] : T(0);
    qs[jl] = (ok && !q_per_row) ? q[c0 + jl] : T(0);
  }
  // a warp per row of K, its lanes along the owned columns
  for (int i = warp; i < m; i += kWarps)
    for (int jl = lane; jl < ncl; jl += 32)
      Ks[k_offset(i, jl, si, sj)] = K[static_cast<size_t>(i) * n + c0 + jl];
  // every CTA of the cluster runs before any stores into another
  cluster_arrive();
  cluster_wait();

  // The primal epilogue of output (r, jl) with product value a: Y, Yb
  // (at yb_at), the anchor blend or the running sum, and on the last step
  // the outputs
  auto primal_out = [&](int r, int jl, int yb_at, T a, int row0, int nrows,
                        const T* wt, bool last) {
    const bool live = r < nrows;
    const size_t gi = static_cast<size_t>(row0 + r) * n + c0 + jl;
    const T qj = q_per_row ? (live ? q[gi] : T(0)) : qs[jl];
    const T y = Yc[r * ys + jl];
    const T y1 = clip(fma_rn(-taus[r], qj - a, y), lbs[jl], ubs[jl]);
    const T yb = T(2) * y1 - y;
    Yb[yb_at] = yb;
    if constexpr (AVG) {
      const T ysum = Ya[r * ys + jl] + y1;
      Yc[r * ys + jl] = y1;
      Ya[r * ys + jl] = ysum;
      if (last && live) {
        Yout[gi] = y1;
        Yout2[gi] = ysum / static_cast<T>(n_inner);
      }
    } else {
      const T w = wt[r];
      const T ynew = blend(w, yb, Ya[r * ys + jl]);
      Yc[r * ys + jl] = ynew;
      if (last && live) {
        Yout[gi] = ynew;
        Yout2[gi] = y1;
      }
    }
  };

  // float32: the epilogues of row r, columns jl .. jl + 3, in 16-byte
  // words (every region's rows and columns 4-aligned); the product is in
  // Yb. Columns past ncl hold zeros in every operand, so they stay zero,
  // and nothing of theirs reaches device memory.
  auto primal_out4 = [&](int r, int jl, int row0, int nrows, const T* wt,
                         bool last) {
    if constexpr (F32) {
      const bool live = r < nrows;
      const size_t gi = static_cast<size_t>(row0 + r) * n + c0 + jl;
      const float4 a = ld4(Yb + r * ln + jl);
      const float4 yv = ld4(Yc + r * ys + jl);
      const float4 av = ld4(Ya + r * ys + jl);
      const float4 lo = ld4(lbs + jl), hi = ld4(ubs + jl);
      float4 qv = ld4(qs + jl);
      const float tr = taus[r];
      const float w = AVG ? 0.f : wt[r];
      float4 y1, yb, yn;
#define PDHG_TILE_LANE(f)                                                  \
  {                                                                        \
    const bool col = jl + lane_of_##f < ncl;                               \
    if (q_per_row) qv.f = (live && col) ? q[gi + lane_of_##f] : 0.f;       \
    y1.f = clip(fma_rn(-tr, qv.f - a.f, yv.f), lo.f, hi.f);                \
    yb.f = 2.f * y1.f - yv.f;                                              \
    yn.f = AVG ? av.f + y1.f : blend(w, yb.f, av.f);                       \
    if (last && live && col) {                                             \
      if (AVG) {                                                           \
        Yout[gi + lane_of_##f] = y1.f;                                     \
        Yout2[gi + lane_of_##f] = yn.f / static_cast<float>(n_inner);      \
      } else {                                                             \
        Yout[gi + lane_of_##f] = yn.f;                                     \
        Yout2[gi + lane_of_##f] = y1.f;                                    \
      }                                                                    \
    }                                                                      \
  }
      constexpr int lane_of_x = 0, lane_of_y = 1, lane_of_z = 2,
                    lane_of_w = 3;
      PDHG_TILE_LANE(x)
      PDHG_TILE_LANE(y)
      PDHG_TILE_LANE(z)
      PDHG_TILE_LANE(w)
#undef PDHG_TILE_LANE
      *reinterpret_cast<float4*>(Yb + r * ln + jl) = yb;
      if constexpr (AVG) {
        *reinterpret_cast<float4*>(Yc + r * ys + jl) = y1;
        *reinterpret_cast<float4*>(Ya + r * ys + jl) = yn;
      } else {
        *reinterpret_cast<float4*>(Yc + r * ys + jl) = yn;
      }
    }
  };

  // The dual update's items: float32 V adjacent owned constraint rows of
  // one tile row, row-major over [tm][mc]; float64 one value, in the order
  // L's operand buffer stores the owned rows (item idx: row block
  // idx / (128 nb), K block idx / 128 % nb of the owned ones, position
  // idx % 128 of a_offset in the block), so that a warp's stores of the
  // new L into another CTA are contiguous. Item idx's anchor or sum and
  // right-hand side live at V idx.
  const int ng = mc / V;
  const int nb = mc / 8;                              // owned row blocks
  auto item = [&](int idx, int& r, int& io) {
    if constexpr (F32) {
      r = idx / ng;
      io = (idx - r * ng) * V;
    } else {
      const int pos = idx & 127;
      r = (idx / (128 * nb)) * 16 + (pos & 1) * 8 + (pos >> 4);
      io = ((idx >> 7) % nb) * 8 + ((pos >> 1) & 1) * 4 + ((pos >> 2) & 3);
    }
  };
  struct Own {
    Vec<T, V> l, h, a;
    T s;
    uint32_t eq;
  };
  auto own = [&](int idx) {
    Own o;
    int r, io;
    item(idx, r, io);
    const int i = i0 + io;
    o.l = ldv<V>(Lf + l_at(r, i));
    o.h = ldv<V>(hs + V * idx);
    o.a = ldv<V>(La + V * idx);
    o.s = sigs[r];
    o.eq = 0;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (i + v < m && is_eq[i + v] != 0) o.eq |= 1u << v;
    return o;
  };

  const int ntiles = (B + tm - 1) / tm;
  for (int tile = cid; tile < ntiles; tile += nclusters) {
    const int row0 = tile * tm;
    const int nrows = min(tm, B - row0);
    for (int idx = tid; idx < tm * mp; idx += kThreads) {
      const int r = idx / mp;
      const int i = idx - r * mp;
      Lf[l_at(r, i)] =
          (r < nrows && i < m) ? L0[static_cast<size_t>(row0 + r) * m + i]
                               : T(0);
    }
    for (int idx = tid; idx < tm * ys; idx += kThreads) {
      const int r = idx / ys;
      const int jl = idx - r * ys;
      const bool ok = r < nrows && jl < ncl;
      const size_t gi = static_cast<size_t>(row0 + r) * n + c0 + jl;
      Yc[idx] = ok ? Y0[gi] : T(0);
      if constexpr (AVG) {
        Ya[idx] = T(0);
      } else {
        Ya[idx] = ok ? Yanc[gi] : T(0);
      }
    }
    for (int idx = tid; idx < tm * ng; idx += kThreads) {
      int r, io;
      item(idx, r, io);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = i0 + io + v;
        const bool ok = r < nrows && i < m;
        const size_t gi = static_cast<size_t>(row0 + r) * m + i;
        hs[V * idx + v] = ok ? ht[gi] : T(0);
        if constexpr (AVG) {
          La[V * idx + v] = T(0);
        } else {
          La[V * idx + v] = ok ? Lanc[gi] : T(0);
        }
      }
    }
    if (tid < tm) {
      const bool ok = tid < nrows;
      taus[tid] = ok ? tau[row0 + tid] : T(0);
      sigs[tid] = ok ? sig[row0 + tid] : T(0);
      if constexpr (!AVG) {
        const T k = ok ? kh[row0 + tid] : T(0);
        khs[tid] = k;
        ws[tid] = (k + T(1)) / (k + T(2));
      }
    }
    __syncthreads();

    for (int t = 0; t < n_inner; ++t) {
      const bool last = t == n_inner - 1;
      const T* wt = ws + (t & 1) * kTM;    // the step's Halpern weights
      // primal step of the owned columns
      if constexpr (F32) {
        // a lane per unit: R rows by the 4 columns 8 jb + hc + 2 c of
        // column block jb; the products go into Yb, and every thread then
        // takes its share of the epilogues
        auto unit = [&](auto rows) {
          constexpr int RR = decltype(rows)::value;
          for (int u = tid; u < G * 2 * njt; u += kThreads) {
            const int p = u % G;
            const int grp = u / G;
            const int jb = grp >> 1, hc = grp & 1;
            float acc[RR][4] = {};
            fma_rows<RR, true>(Lf + p * lm, G * lm, Ks + jb * sj + 8 * hc,
                               si, nit, acc);
#pragma unroll
            for (int rr = 0; rr < RR; ++rr) {
              const int r = p + rr * G;
              if (r >= tm) continue;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int jl = jb * 8 + hc + 2 * c;
                if (jl < ncl) Yb[r * ln + jl] = acc[rr][c];
              }
            }
          }
        };
        rows_dispatch(R, unit);
        __syncthreads();
        for (int r = er, e = ej; r < tm;) {
          primal_out4(r, 4 * e, row0, nrows, wt, last);
          e += kThreads % nw_e;
          r += kThreads / nw_e;
          if (e >= nw_e) {
            e -= nw_e;
            ++r;
          }
        }
      } else {
        // a warp per kNTW column tiles of all 16 rows
        for (int nt0 = warp * kNTW; nt0 < njt; nt0 += kWarps * kNTW) {
          Acc<double> acc[kNTW];
#pragma unroll
          for (int nt = 0; nt < kNTW; ++nt) acc[nt].zero();
          tile_product<true>(Lf, Ks + nt0 * sj, sj, si, njt - nt0, nit,
                             lane, acc);
#pragma unroll
          for (int nt = 0; nt < kNTW; ++nt) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int r = g + (c >> 1) * 8;
              const int jl = (nt0 + nt) * 8 + 2 * tig + (c & 1);
              if (jl < ncl)
                primal_out(r, jl, a_offset(r, jl, njt), acc[nt].v[c], row0,
                           nrows, wt, last);
            }
          }
        }
      }
      __syncthreads();
      // this CTA's share of Yb K^T into the exchange buffer of the CTA
      // that owns each constraint row; a lane's two adjacent constraint
      // rows have one owner (mc is even): one store per pair
      if constexpr (F32) {
        // a lane per unit: R rows by the 4 constraint rows
        // 8 ib + {2 h, 2 h + 4, 2 h + 1, 2 h + 5} of one K word, stored
        // as two pairs of adjacent rows
        auto unit = [&](auto rows) {
          constexpr int RR = decltype(rows)::value;
          for (int u = tid; u < G * 2 * nit; u += kThreads) {
            const int p = u % G;
            const int grp = u / G;
            const int ib = grp >> 1, h = grp & 1;
            float acc[RR][4] = {};
            fma_rows<RR, false>(Yb + p * ln, G * ln, Ks + ib * si + 4 * h,
                                sj, njt, acc);
            const int i = ib * 8 + 2 * h;
            const int owner = (ib * 8) / mc;
#pragma unroll
            for (int rr = 0; rr < RR; ++rr) {
              const int r = p + rr * G;
              if (r >= tm) continue;
              T* at = Rx + (rank * kTM + r) * mc + i - owner * mc;
              if (i < m)
                st_cluster2(cluster_addr(at, owner), acc[rr][0], acc[rr][2]);
              if (i + 4 < m)
                st_cluster2(cluster_addr(at + 4, owner), acc[rr][1],
                            acc[rr][3]);
            }
          }
        };
        rows_dispatch(R, unit);
      } else {
        // a warp per kNTW tiles of constraint rows
        for (int it0 = warp * kNTW; it0 < nit; it0 += kWarps * kNTW) {
          Acc<double> acc[kNTW];
#pragma unroll
          for (int nt = 0; nt < kNTW; ++nt) acc[nt].zero();
          tile_product<false>(Yb, Ks + it0 * si, si, sj, nit - it0, njt,
                              lane, acc);
#pragma unroll
          for (int nt = 0; nt < kNTW; ++nt) {
            const int i = (it0 + nt) * 8 + 2 * tig;
            if (i < m) {
              const int owner = i / mc;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = g + h * 8;
                st_cluster2(
                    cluster_addr(Rx + (rank * kTM + r) * mc + i - owner * mc,
                                 owner),
                    acc[nt].v[2 * h], acc[nt].v[2 * h + 1]);
              }
            }
          }
        }
      }
      cluster_arrive();
      // while the shares land: the owner's operands of its first item and
      // the next step's Halpern weights
      const bool mine = tid < tm * ng;
      Own o0;
      if (mine) o0 = own(tid);
      if constexpr (!AVG) {
        if (tid < tm) {
          const T k = khs[tid] + T(t + 1);
          ws[((t + 1) & 1) * kTM + tid] = (k + T(1)) / (k + T(2));
        }
      }
      cluster_wait();
      // dual step of the owned constraint rows: the shares it was sent, in
      // rank order; the new L into every CTA's copy
      for (int idx = tid; idx < tm * ng; idx += kThreads) {
        const Own o = idx == tid ? o0 : own(idx);
        int r, io;
        item(idx, r, io);
        const int i = i0 + io;
        if (i >= m) continue;
        Vec<T, V> s;
#pragma unroll
        for (int v = 0; v < V; ++v) s.v[v] = T(0);
        for (int c = 0; c < C; ++c) {
          const Vec<T, V> x = ldv<V>(Rx + (c * kTM + r) * mc + io);
#pragma unroll
          for (int v = 0; v < V; ++v) s.v[v] += x.v[v];
        }
        const bool live = r < nrows;
        Vec<T, V> lnew, lsum;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          lnew.v[v] = T(0);
          lsum.v[v] = o.a.v[v];
          if (i + v >= m) continue;
          const size_t gi = static_cast<size_t>(row0 + r) * m + i + v;
          const T l = o.l.v[v];
          const T lr = fma_rn(o.s, o.h.v[v] - s.v[v], l);
          const T l1 = ((o.eq >> v) & 1u || !(lr < T(0))) ? lr : T(0);
          if constexpr (AVG) {
            lsum.v[v] = o.a.v[v] + l1;
            lnew.v[v] = l1;
            if (last && live) {
              Lout[gi] = l1;
              Lout2[gi] = lsum.v[v] / static_cast<T>(n_inner);
            }
          } else {
            const T w = wt[r];
            lnew.v[v] = blend(w, T(2) * l1 - l, o.a.v[v]);
            if (last && live) {
              Lout[gi] = lnew.v[v];
              Lout2[gi] = l1;
            }
          }
        }
        if constexpr (AVG) stv(La + V * idx, lsum);
        for (int c = 0; c < C; ++c) {
          if constexpr (F32) {
            st_cluster4(cluster_addr(Lf + r * lm + i, c),
                        make_float4(lnew.v[0], lnew.v[1], lnew.v[2],
                                    lnew.v[3]));
          } else {
            st_cluster(cluster_addr(Lf + a_offset(r, i, nit), c),
                       lnew.v[0]);
          }
        }
      }
      // also keeps every CTA resident until the others' stores have landed
      cluster_arrive();
      cluster_wait();
    }
  }
}

// launches on nclusters persistent clusters with tiles of tm rows, or with
// max_clusters set only asks the card how many such clusters it runs at
// once; returns cudaError_t
template <typename T, bool AVG>
int launch(int C, int nclusters, int tm, const Args& a, int* max_clusters) {
  if (C < 1 || C > 16 || nclusters < 1 || tm < 1 || tm > kTM ||
      (sizeof(T) == 8 && tm != kTM))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout(C, a.m, a.n, sizeof(T) == 4).total * sizeof(T);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pdhg_tile_kernel<T, AVG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * nclusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(a.stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) {
    err = cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
    return static_cast<int>(err);
  }
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.K), static_cast<const T*>(a.q),
      a.q_per_row, static_cast<const T*>(a.lb), static_cast<const T*>(a.ub),
      static_cast<const uint8_t*>(a.is_eq), static_cast<const T*>(a.ht),
      static_cast<const T*>(a.tau), static_cast<const T*>(a.sig),
      static_cast<const T*>(a.Y), static_cast<const T*>(a.L),
      static_cast<const T*>(a.kh), static_cast<const T*>(a.Yanc),
      static_cast<const T*>(a.Lanc), static_cast<T*>(a.Yout),
      static_cast<T*>(a.Lout), static_cast<T*>(a.Yout2),
      static_cast<T*>(a.Lout2), a.B, a.m, a.n, a.n_inner, C, tm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters of a launch at these shapes
template <bool AVG>
int occupancy(int f64, int C, int m, int n, int* out) {
  Args a = {};
  a.m = m;
  a.n = n;
  a.n_inner = 1;
  return f64 ? launch<double, AVG>(C, 1, kTM, a, out)
             : launch<float, AVG>(C, 1, kTM, a, out);
}

}  // namespace pdhg_tile
