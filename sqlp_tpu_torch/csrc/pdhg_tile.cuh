// PDHG round for large batches, both restart schemes: tiles of TM = 16
// batch rows, K resident in the shared memory of a thread-block cluster
// that walks the tiles in turn (Hopper, sm_90a).
// Instantiated by pdhg_halpern_tile.cu (reflected Halpern, AVG = false) and
// pdhg_average_tile.cu (restart to the average, AVG = true); the step's
// two products are written once here, so both schemes reduce in the same
// order. The step is the one pdhg_cluster.cuh states.
//
// What bounds the row-block kernels at large B: a block carries 4 batch
// rows and reads K twice per step from L2, so at B = 4096 a thousand
// blocks draw about 1 GB per step through L2, and the products are scalar
// FMAs. This design reads K from device memory once per launch and runs
// the products on 16-row tiles (float64 as matrix instructions):
//
// - K resident: a cluster of C CTAs; CTA c owns the column slice
//   [c nc, (c+1) nc) of K and keeps it in its shared memory for the whole
//   launch, zero-padded to whole 8 x 8 blocks. The cluster is persistent:
//   it walks the row tiles cid, cid + nclusters, ...
// - A tile's iterate lives in shared memory: every CTA holds the tile's
//   full L [TM, m] (an operand of its primal product) and, for its own
//   columns, Y, the reflected Yb and the anchor (Halpern) or running sum
//   (average). The dual update is split by constraint row: CTA c owns rows
//   [c mc, (c+1) mc), whole blocks of 8, and keeps their L, anchor or
//   running sum and right-hand side, in the order the owner walks them:
//   the order L's operand buffer stores them, so that a warp's stores of
//   the new L into another CTA are contiguous.
// - Primal product G = L K[:, slice] ([TM, m] x [m, nc]): a warp per block
//   of all TM rows by 16 columns, accumulating over m in steps of 8 (tiles
//   of 32 rows were measured slower at every panel size); its epilogue updates Y, Yb and the anchor blend or sum in place.
// - Dual product, this CTA's share of Yb K^T ([TM, nc] x [nc, m]): a warp
//   per block of TM rows by 16 constraint rows, from the same
//   resident slice; its epilogue stores each share into the exchange
//   buffer of the CTA that owns the constraint row, over distributed
//   shared memory. After one cluster barrier the owner sums the C shares
//   it was sent in rank order 0..C-1, updates L and stores the new value
//   into every CTA's copy; a second cluster barrier ends the step. Every
//   sum has a fixed order (no atomics): two launches are bitwise equal.
//   All traffic between CTAs is stores (st.shared::cluster), which do not
//   stall the sender; loads through a mapped generic pointer were measured
//   at a full round trip each, one after the other.
// - Arithmetic, one per dtype: float64 on mma.sync.m16n8k8.f64 (full
//   IEEE; measured at twice the rate of four m8n8k4 on the H100); float32
//   as scalar FP32 FMAs on the same tiles and output fragments, summed in
//   blocks of 8 k as the float64 instruction sums them, the one float32
//   arithmetic measured so far that passes both float32 gates
//   (chip_smoke.py:_f32_gate). The tensor-core candidates measured faster
//   and taken out (3xTF32; FP64 mma on widened float32 operands; split
//   TF32 with six terms), each with the gate it failed and its times, are
//   in PERF.md section 6.
// - In the inner loop every load and register move competes with the
//   matrix instructions for dispatch (measured: the loop's time is the sum
//   of both), so the operands are laid out to need few. L and Yb are
//   stored in the order the instruction's A fragment wants them (16 x 8
//   blocks, a lane's four values adjacent: one contiguous load per
//   fragment and no register shuffling). K is stored in 8 x 8 blocks
//   whose order serves both products (one load of two adjacent elements
//   per B fragment in the primal product, two single elements in the dual
//   one).
//
// Rows past B in the ragged last tile run on zeros and are never written
// back. Candidates and averages are written from the last step's
// epilogues, so no buffer holds them.

#pragma once

#include <cooperative_groups.h>

#include "pdhg_common.cuh"

namespace pdhg_tile {

namespace cg = cooperative_groups;

using pdhg::clip;
using Args = pdhg::RoundArgs;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemMax = 227 * 1024;

// batch rows of a tile: one 16-row matrix-instruction tile on every warp
constexpr int kTM = 16;

// offsets, in elements, of a CTA's shared-memory regions (mirrored by
// ops/cuda/pdhg_kernel.py:_tile_smem); every region is a multiple of 4
// elements long
struct Layout {
  int nc, ncp, mp, ys, mc;
  size_t Ks, Lf, Rx, Yb, Yc, Ya, La, hs, lbs, ubs, qs, rows, total;
};

__host__ __device__ inline Layout layout(int C, int TM, int m, int n) {
  Layout l;
  l.nc = (n + C - 1) / C;        // columns a CTA owns
  l.ncp = (l.nc + 7) / 8 * 8;    // padded to whole blocks of 8
  l.mp = (m + 7) / 8 * 8;
  l.ys = l.ncp + 4;              // stride of a row-major [*, nc] row
  l.mc = (l.mp / 8 + C - 1) / C * 8;      // constraint rows a CTA owns
  size_t o = 0;
  l.Ks = o;   o += static_cast<size_t>(l.ncp) * l.mp;   // 8 x 8 blocks
  l.Lf = o;   o += static_cast<size_t>(TM) * l.mp;       // A blocks
  l.Rx = o;   o += static_cast<size_t>(C) * TM * l.mc;  // [C][TM][mc] shares
  l.Yb = o;   o += static_cast<size_t>(TM) * l.ncp;      // A blocks
  l.Yc = o;   o += static_cast<size_t>(TM) * l.ys;      // [TM][ys] Y
  l.Ya = o;   o += static_cast<size_t>(TM) * l.ys;      // anchor | sum
  l.La = o;   o += static_cast<size_t>(TM) * l.mc;      // [TM][mc] anchor|sum
  l.hs = o;   o += static_cast<size_t>(TM) * l.mc;      // [TM][mc] rhs
  l.lbs = o;  o += l.ncp;
  l.ubs = o;  o += l.ncp;
  l.qs = o;   o += l.ncp;                               // shared q
  l.rows = o; o += 5 * static_cast<size_t>(TM);  // tau, sig, kh, w[2]
  l.total = o;
  return l;
}

// Where element (r, k) of a [TM, 8 ksteps] operand of the A side lives, in
// elements from the buffer's start: 16 x 8 blocks of 128 elements in
// (row block, k step) order; in a block the four values of lane
// 4 (r % 8) + k % 4 are adjacent, in the order of the instruction's A
// registers.
__device__ __forceinline__ int a_offset(int r, int k, int ksteps) {
  return ((r >> 4) * ksteps + (k >> 3)) * 128 +
         ((((r & 7) << 2) + (k & 3)) << 2) + (((k >> 2) & 1) << 1) +
         ((r >> 3) & 1);
}

// Where element (i, j) of the K slice lives: 8 x 8 blocks in (column
// block, row block) order; in a block, (i % 8, j % 8) at
// 2 (4 (j % 8) + i % 4) + (i % 8) / 4.
__device__ __forceinline__ int k_offset(int i, int j, int iblocks) {
  return ((j >> 3) * iblocks + (i >> 3)) * 64 +
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

__device__ __forceinline__ void mma_f64(double (&c)[4],
                                        const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Store x at element `at` of every CTA's copy of an A-side buffer, this
// CTA's included
template <typename T>
__device__ __forceinline__ void store_a_all(T* buf, int at, T x, int C) {
  for (int c = 0; c < C; ++c) st_cluster(cluster_addr(buf + at, c), x);
}

// The accumulator of one 16 x 8 output tile; with g = lane / 4 and tig =
// lane % 4 a lane holds (g, 2 tig) (g, 2 tig + 1) (g + 8, 2 tig) (g + 8,
// 2 tig + 1), under either type.
template <typename T>
struct Acc {
  T v[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = T(0);
  }
};

// a warp's share of a product: all kTM rows by kNTW tiles of 8 columns, so
// that every A fragment read from shared memory serves several matrix
// instructions
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

// float32: the same product with scalar FP32 FMAs, on the same operands
// and into the same output fragment: a lane sums its 2 rows
// by 2 columns of each tile over a block of 8 k in ascending order and adds
// the block's sum to the running one, as the float64 instruction does. Per
// block it reads its two rows of A as four 16-byte loads (a_offset keeps (g, k)
// (g + 8, k) (g, k + 4) (g + 8, k + 4) adjacent) and its columns of K from
// the block's k_offset order: 8 adjacent values per column in the primal
// product, 8 values a block row apart in the dual one.
template <bool PRIMAL>
__device__ __forceinline__ void tile_product_fma(
    const float* As, const float* Bs, int b_nt, int b_ks, int ntiles,
    int ksteps, int lane, Acc<float> (&acc)[kNTW]) {
  const int g = lane >> 2;
  const int tig = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    float a[2][8];                       // [row g + 8 h][k]
    const float* Ab = As + ks * 128 + 16 * g;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(Ab + 4 * kk);
      a[0][kk] = v.x;
      a[1][kk] = v.y;
      a[0][kk + 4] = v.z;
      a[1][kk + 4] = v.w;
    }
#pragma unroll
    for (int nt = 0; nt < kNTW; ++nt) {
      if (nt >= ntiles) break;
      const float* Bb = Bs + nt * b_nt + ks * b_ks;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = 2 * tig + cc;    // of the tile's 8
        float b[8];                      // [k]
        if constexpr (PRIMAL) {
          // column col of K's block: rows 0 4 1 5 | 2 6 3 7
          const float4 u = *reinterpret_cast<const float4*>(Bb + 8 * col);
          const float4 w = *reinterpret_cast<const float4*>(Bb + 8 * col + 4);
          b[0] = u.x; b[4] = u.y; b[1] = u.z; b[5] = u.w;
          b[2] = w.x; b[6] = w.y; b[3] = w.z; b[7] = w.w;
        } else {
          // row col of K's block: column j at 8 j + 2 (col % 4) + col / 4
          const float* Br = Bb + 2 * (col & 3) + (col >> 2);
#pragma unroll
          for (int k = 0; k < 8; ++k) b[k] = Br[8 * k];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) s = fmaf(a[h][k], b[k], s);
          acc[nt].v[2 * h + cc] += s;
        }
      }
    }
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
                 int n, int n_inner, int C) {
  constexpr int TM = kTM;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / C;
  const int nclusters = gridDim.x / C;
  const Layout lay = layout(C, TM, m, n);
  const int ncp = lay.ncp, mp = lay.mp, ys = lay.ys, mc = lay.mc;
  const int nit = mp / 8;                             // row blocks of K
  const int njt = ncp / 8;                            // column blocks
  const int c0 = rank * lay.nc;                       // first owned column
  const int ncl = max(0, min(lay.nc, n - c0));        // owned columns
  const int i0 = rank * mc;                           // first owned row
  const int nb = mc / 8;                              // owned row blocks
  // the owned rows in the order Lf stores them: item idx is row block
  // idx / (128 nb), K block idx / 128 % nb of the owned ones, and in the
  // block the position idx % 128 of a_offset
  auto item_row = [](int idx, int nb) {
    const int pos = idx & 127;
    return (idx / (128 * nb)) * 16 + (pos & 1) * 8 + (pos >> 4);
  };
  auto item_col = [](int idx, int nb) {      // constraint row, from i0
    const int pos = idx & 127;
    return ((idx >> 7) % nb) * 8 + ((pos >> 1) & 1) * 4 + ((pos >> 2) & 3);
  };
  const int tid = threadIdx.x;
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
  T* sigs = taus + TM;
  T* khs = sigs + TM;
  T* ws = khs + TM;                                   // [2][TM]

  // the resident slice of K, once per launch
  for (int idx = tid; idx < ncp * mp; idx += kThreads) Ks[idx] = T(0);
  for (int jl = tid; jl < ncp; jl += kThreads) {
    const bool ok = jl < ncl;
    lbs[jl] = ok ? lb[c0 + jl] : T(0);
    ubs[jl] = ok ? ub[c0 + jl] : T(0);
    qs[jl] = (ok && !q_per_row) ? q[c0 + jl] : T(0);
  }
  __syncthreads();
  for (int idx = tid; idx < ncl * m; idx += kThreads) {
    const int i = idx / ncl;
    const int jl = idx - i * ncl;
    Ks[k_offset(i, jl, nit)] = K[static_cast<size_t>(i) * n + c0 + jl];
  }

  const T cnt = static_cast<T>(n_inner);
  const int ntiles = (B + TM - 1) / TM;
  for (int tile = cid; tile < ntiles; tile += nclusters) {
    const int row0 = tile * TM;
    const int nrows = min(TM, B - row0);
    for (int idx = tid; idx < TM * mp; idx += kThreads) {
      const int r = idx / mp;
      const int i = idx - r * mp;
      Lf[a_offset(r, i, nit)] =
          (r < nrows && i < m) ? L0[static_cast<size_t>(row0 + r) * m + i]
                               : T(0);
    }
    for (int idx = tid; idx < TM * ncp; idx += kThreads)
      Yb[idx] = T(0);
    for (int idx = tid; idx < TM * ys; idx += kThreads) {
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
    for (int idx = tid; idx < TM * mc; idx += kThreads) {
      const int r = item_row(idx, nb);
      const int i = i0 + item_col(idx, nb);
      const bool ok = r < nrows && i < m;
      const size_t gi = static_cast<size_t>(row0 + r) * m + i;
      hs[idx] = ok ? ht[gi] : T(0);
      if constexpr (AVG) {
        La[idx] = T(0);
      } else {
        La[idx] = ok ? Lanc[gi] : T(0);
      }
    }
    if (tid < TM) {
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
      const T* wt = ws + (t & 1) * TM;     // the step's Halpern weights
      // primal step of the owned columns: a warp per kNTW column tiles
      for (int nt0 = warp * kNTW; nt0 < njt; nt0 += kWarps * kNTW) {
        Acc<T> acc[kNTW];
#pragma unroll
        for (int nt = 0; nt < kNTW; ++nt) acc[nt].zero();
        if constexpr (sizeof(T) == 4) {
          tile_product_fma<true>(Lf, Ks + nt0 * nit * 64, nit * 64, 64,
                                 njt - nt0, nit, lane, acc);
        } else {
          tile_product<true>(Lf, Ks + nt0 * nit * 64, nit * 64, 64,
                             njt - nt0, nit, lane, acc);
        }
#pragma unroll
        for (int nt = 0; nt < kNTW; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = g + (c >> 1) * 8;
            const int jl = (nt0 + nt) * 8 + 2 * tig + (c & 1);
            if (jl < ncl) {
              const bool live = r < nrows;
              const size_t gi = static_cast<size_t>(row0 + r) * n + c0 + jl;
              const T qj = q_per_row ? (live ? q[gi] : T(0)) : qs[jl];
              const T y = Yc[r * ys + jl];
              const T y1 = clip(y - taus[r] * (qj - acc[nt].v[c]),
                                lbs[jl], ubs[jl]);
              const T yb = T(2) * y1 - y;
              Yb[a_offset(r, jl, njt)] = yb;
              if constexpr (AVG) {
                const T ysum = Ya[r * ys + jl] + y1;
                Yc[r * ys + jl] = y1;
                Ya[r * ys + jl] = ysum;
                if (last && live) {
                  Yout[gi] = y1;
                  Yout2[gi] = ysum / cnt;
                }
              } else {
                const T w = wt[r];
                const T ynew = w * yb + (T(1) - w) * Ya[r * ys + jl];
                Yc[r * ys + jl] = ynew;
                if (last && live) {
                  Yout[gi] = ynew;
                  Yout2[gi] = y1;
                }
              }
            }
          }
        }
      }
      __syncthreads();
      // this CTA's share of Yb K^T: a warp per kNTW tiles of constraint
      // rows
      for (int it0 = warp * kNTW; it0 < nit; it0 += kWarps * kNTW) {
        Acc<T> acc[kNTW];
#pragma unroll
        for (int nt = 0; nt < kNTW; ++nt) acc[nt].zero();
        if constexpr (sizeof(T) == 4) {
          tile_product_fma<false>(Yb, Ks + it0 * 64, 64, nit * 64, nit - it0,
                                  njt, lane, acc);
        } else {
          tile_product<false>(Yb, Ks + it0 * 64, 64, nit * 64, nit - it0,
                              njt, lane, acc);
        }
#pragma unroll
        for (int nt = 0; nt < kNTW; ++nt) {
          // a lane's two adjacent constraint rows have one owner (mc is
          // even): one store per output row
          const int i = (it0 + nt) * 8 + 2 * tig;
          if (i < m) {
            const int owner = i / mc;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = g + h * 8;
              st_cluster2(
                  cluster_addr(Rx + (rank * TM + r) * mc + i - owner * mc,
                               owner),
                  acc[nt].v[2 * h], acc[nt].v[2 * h + 1]);
            }
          }
        }
      }
      cluster.sync();
      // dual step of the owned constraint rows: the shares it was sent, in
      // rank order; the new L into every CTA's copy
      if constexpr (!AVG) {
        if (tid < TM) {
          const T k = khs[tid] + T(t + 1);
          ws[((t + 1) & 1) * TM + tid] = (k + T(1)) / (k + T(2));
        }
      }
      for (int idx = tid; idx < TM * mc; idx += kThreads) {
        const int r = item_row(idx, nb);
        const int io = item_col(idx, nb);
        const int i = i0 + io;
        if (i < m) {
          T s = T(0);
          for (int c = 0; c < C; ++c) s += Rx[(c * TM + r) * mc + io];
          const bool live = r < nrows;
          const size_t gi = static_cast<size_t>(row0 + r) * m + i;
          // = a_offset(r, i, nit)
          const int lat =
              ((idx / (128 * nb)) * nit + (i >> 3)) * 128 + (idx & 127);
          const T l = Lf[lat];
          const T lr = l + sigs[r] * (hs[idx] - s);
          const T l1 = (is_eq[i] != 0 || !(lr < T(0))) ? lr : T(0);
          T lnew;
          if constexpr (AVG) {
            const T lsum = La[idx] + l1;
            La[idx] = lsum;
            lnew = l1;
            if (last && live) {
              Lout[gi] = l1;
              Lout2[gi] = lsum / cnt;
            }
          } else {
            const T w = wt[r];
            lnew = w * (T(2) * l1 - l) + (T(1) - w) * La[idx];
            if (last && live) {
              Lout[gi] = lnew;
              Lout2[gi] = l1;
            }
          }
          store_a_all(Lf, lat, lnew, C);
        }
      }
      // also keeps every CTA resident until the others' stores have landed
      cluster.sync();
    }
  }
}

// launches on nclusters persistent clusters, or with max_clusters set only
// asks the card how many such clusters it runs at once; returns cudaError_t
template <typename T, bool AVG>
int launch(int C, int nclusters, const Args& a, int* max_clusters) {
  if (C < 1 || C > 16 || nclusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout(C, kTM, a.m, a.n).total * sizeof(T);
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
      static_cast<T*>(a.Lout2), a.B, a.m, a.n, a.n_inner, C);
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
  return f64 ? launch<double, AVG>(C, 1, a, out)
             : launch<float, AVG>(C, 1, a, out);
}

}  // namespace pdhg_tile
