// PDHG round for a K that fits no cluster, both restart schemes: tiles of
// TM = 16 batch rows on a thread-block cluster, K streamed from L2 through
// a ring of shared-memory stages every step (Hopper, sm_90a).
// Instantiated by pdhg_halpern_stream.cu (reflected Halpern, AVG = false)
// and pdhg_average_stream.cu (restart to the average, AVG = true); the
// step is the one pdhg_cluster.cuh states.
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas_halpern
// (body _kernel_halpern) and pdhg_round_pallas (body _kernel), in the
// regime where K is too large for the cluster and tile variants: storm
// (m 528, n 1259) in float64 (the average round up to 256 rows); its
// float32 panels go to the grid variant (pdhg_grid.cuh) and come here
// only while that is not admitted for them. The TPU kernel keeps K
// resident in VMEM and runs 128-row blocks against it.
//
// What bounds it on this card: K is 2.66 MB in f32 and 5.32 MB in f64,
// against 227 KB of shared memory a CTA (f64 K does not fit even a 16-CTA
// cluster), so every step reads K twice from L2, once per product. The
// row-block kernel (pdhg_halpern_round.cu) reads it there for the 2 or 4
// batch rows one block holds: at storm B = 1024 that is 218 GB (f32) per
// 80-step round, L2-bound at about 7 TB/s. Here every K element that
// reaches shared memory serves a whole tile of 16 rows, so a round moves
// B / 16 x 2 x |K| x 80 bytes (27 GB in f32 at B = 1024), and the
// products' FMAs (f32) or FP64 matrix instructions (f64) bound it.
//
// The design:
//
// - K stays in L2. A CTA streams the K it needs each step through a ring
//   of NS stages (2-4, as many as shared memory holds): one warp issues a
//   bulk copy (TMA, cp.async.bulk) per row segment of a chunk and the
//   stage's mbarrier counts the bytes in; the stage of chunk q + NS - 1 is
//   issued once every thread is done with chunk q - 1 (a CTA barrier per
//   chunk), while chunk q is used. Bulk copies need 16-byte aligned rows,
//   so the wrapper hands the kernel K with its row stride ldk padded to a
//   multiple of 16 bytes (zeros past n), and a CTA's column slice starts
//   at a multiple of 16 bytes. Copying element by element with cp.async
//   took about 40 % of the round (measured at storm B = 1024 in both
//   dtypes). The chunk sequence runs on across the products and the
//   steps, so the next product's first chunks are in flight during each
//   cluster barrier.
// - A tile's iterates are split over a cluster of C CTAs: CTA c owns the
//   column slice [c nc, (c+1) nc) of the n-vectors (Y and its anchor or
//   running sum, bounds, q) and the constraint rows [c mc, (c+1) mc) of
//   the m-vectors (the anchor or running sum of L, the right-hand side).
//   Every CTA keeps the full L of the tile (the primal product's operand).
//   The new values are stored into every CTA's copy over distributed
//   shared memory (st.shared::cluster); two cluster barriers a step.
// - float32 keeps the row-block kernels' order of summation
//   (pdhg_common.cuh), so the round is bit for bit theirs:
//   G = q - L K: a thread per (owned column, 8 of the 16 rows) sums over
//     i = 0 .. m-1 in order, K[:, slice] streamed in blocks of whole rows;
//   S = ht - Yb K^T: split by constraint row, each CTA holds the full Yb
//     of the tile (written by its owners after the primal step, 16 values
//     a column, quads swizzled so that a warp's 16-byte loads are free of
//     bank conflicts); a warp per owned row (4 rows a warp, so that each
//     Yb value read serves 4 FMAs, measured 28 % slower at storm B = 1024:
//     64 accumulators a thread spill), lane l sums over j = l mod 32 in
//     order while K[rows, :] streams in blocks of 16 rows by 256
//     columns, and each row's 16 sums are reduced over the lanes in
//     the XOR tree of warp_sum's shuffles (a reduce-scatter: 16 shuffles
//     for 16 rows; the same pairs are added, and a + b = b + a, so the
//     bits are warp_sum's).
// - float64 holds the tile kernel's split (pdhg_tile.cuh), as the full Yb
//   of a tile does not fit beside the full L: both products stream the
//   CTA's column slice K[:, slice], 32 rows at a time (row-major, the row
//   stride 8 mod 16 elements so that the G product's B fragments load
//   without bank conflicts), and run on mma.sync.m16n8k8.f64 with
//   pdhg_tile.cuh's A fragment layout: G on a warp per 8 owned columns,
//   the CTA's share of Yb K^T on a warp per 8 constraint rows of the
//   chunk, stored into the owning CTA's exchange buffer; after a cluster
//   barrier the owner sums the C shares in rank order 0..C-1.
//
// Every sum has a fixed order (no atomics): two launches are bitwise
// equal. Rows past B in a ragged tile run on zeros and are never written
// back. Candidates and averages are written from the last step's
// epilogues.

#pragma once

#include <cooperative_groups.h>

#include "pdhg_tile.cuh"

namespace pdhg_stream {

namespace cg = cooperative_groups;

using pdhg::clip;
using Args = pdhg::RoundArgs;
using pdhg_tile::a_offset;
using pdhg_tile::Acc;
using pdhg_tile::cluster_addr;
using pdhg_tile::mma_f64;
using pdhg_tile::st_cluster;
using pdhg_tile::st_cluster2;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 16;                    // batch rows of a tile
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kMaxStages = 4;
constexpr int kStage32 = 4096;             // f32 elements of a stage
constexpr int kRows32 = 8;                 // f32 batch rows of a G thread
constexpr int kKR64 = 32;                  // f64 K rows of a chunk
constexpr int kMaxTiles64 = 2;             // f64 G column tiles of a warp

__host__ __device__ inline size_t up4(size_t x) { return (x + 3) / 4 * 4; }

// offsets, in elements, of a CTA's shared-memory regions (mirrored by
// ops/cuda/pdhg_kernel.py:_stream_smem); every region is a multiple of 4
// elements long, so the ring starts 16-byte aligned; the stages' mbarriers
// follow the ring (kMaxStages x 8 bytes, in `total`'s last elements)
struct Layout {
  int nc, mc;      // columns and constraint rows a CTA owns (at most); nc
                   // a multiple of 16 bytes
  int S, ns;       // elements of a stage, stages
  int kr, jb;      // f32: K rows of a G chunk, columns of an S chunk
  int ncp, mp, ys; // f64: nc and m padded to whole blocks of 8, Y stride
  int ks;          // f64: row stride of a chunk
  size_t L, Yt, Rx, Yb, Y, Ya, La, hs, lbs, ubs, qs, rows, ring, bars,
      total;
  bool ok;         // the round fits: at least 2 stages, and the threads
                   // take every G unit
};

template <typename T>
__host__ __device__ inline Layout layout(int C, int m, int n) {
  Layout l = {};
  constexpr int v = 16 / sizeof(T);          // elements of 16 bytes
  l.nc = ((n + C - 1) / C + v - 1) / v * v;
  size_t o = 0;
  if (sizeof(T) == 4) {
    l.mc = (m + C - 1) / C;
    l.L = o;    o += up4(static_cast<size_t>(m) * kTM);   // [m][TM]
    l.Yt = o;   o += up4(static_cast<size_t>(n) * kTM);   // [n][TM] quads
    l.Y = o;    o += up4(static_cast<size_t>(kTM) * l.nc);
    l.Ya = o;   o += up4(static_cast<size_t>(kTM) * l.nc);
    l.La = o;   o += up4(static_cast<size_t>(l.mc) * kTM);  // [mc][TM]
    l.hs = o;   o += up4(static_cast<size_t>(l.mc) * kTM);
    l.lbs = o;  o += up4(l.nc);
    l.ubs = o;  o += up4(l.nc);
    l.qs = o;   o += up4(l.nc);
    l.rows = o; o += 3 * kTM;                 // tau, sig, kh
    l.S = kStage32;
    l.kr = l.S / l.nc;
    l.jb = l.S / kWarps;
  } else {
    l.ncp = (l.nc + 7) / 8 * 8;
    l.mp = (m + 7) / 8 * 8;
    l.ys = l.ncp + 4;
    l.mc = ((m + C - 1) / C + 1) / 2 * 2;  // even: a lane's pair of rows
    l.L = o;    o += static_cast<size_t>(kTM) * l.mp;        // A blocks
    l.Rx = o;   o += up4(static_cast<size_t>(C) * kTM * l.mc);
    l.Yb = o;   o += static_cast<size_t>(kTM) * l.ncp;       // A blocks
    l.Y = o;    o += static_cast<size_t>(kTM) * l.ys;
    l.Ya = o;   o += static_cast<size_t>(kTM) * l.ys;
    l.La = o;   o += up4(static_cast<size_t>(kTM) * l.mc);   // [TM][mc]
    l.hs = o;   o += up4(static_cast<size_t>(kTM) * l.mc);
    l.lbs = o;  o += l.ncp;
    l.ubs = o;  o += l.ncp;
    l.qs = o;   o += l.ncp;
    l.rows = o; o += 3 * kTM;
    l.ks = l.ncp % 16 == 0 ? l.ncp + 8 : l.ncp;
    l.S = kKR64 * l.ks;
    l.kr = kKR64;
  }
  l.ring = o;
  const size_t nbar = kMaxStages * 8 / sizeof(T);   // the mbarriers
  const size_t cap = kSmemMax / sizeof(T) - nbar;
  const size_t room = cap > o ? (cap - o) / l.S : 0;
  l.ns = static_cast<int>(room < kMaxStages ? room : kMaxStages);
  l.bars = o + static_cast<size_t>(l.ns) * l.S;
  l.total = l.bars + nbar;
  l.ok = l.ns >= 2 && (sizeof(T) == 4
                           ? l.kr >= 1 && 2 * l.nc <= 2 * kThreads
                           : l.ncp / 8 <= kMaxTiles64 * kWarps);
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%1], %0;"
               :: "r"(count), "r"(smem_addr(bar)) : "memory");
}

// one arrival that also announces the bytes the stage's copies will bring
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %0;"
               :: "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// a bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, float a, float b,
                                            float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

// f32: where quad qd (rows 4 qd .. 4 qd + 3) of column j lives in Yt
__device__ __forceinline__ int yt_offset(int j, int qd) {
  return j * kTM + ((qd ^ ((j >> 1) & 3)) << 2);
}

// One level of the f32 S product's reduce-scatter: lanes that differ in
// bit 2 HALF trade halves of their first 2 HALF sums and add what they
// keep to what they get; afterwards v[k < HALF] is row k + HALF (lane's
// bit) of the rows v[k < 2 HALF] held
template <int HALF>
__device__ __forceinline__ void scatter_level(float (&v)[kTM], int lane) {
  const bool up = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = up ? v[k] : v[k + HALF];
    const float keep = up ? v[k + HALF] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// The step's update of one primal entry, in the row-block kernels' own
// expressions (pdhg_halpern_round.cu, pdhg_average_round.cu), so that the
// float32 round keeps their bits. y is the iterate, ya its anchor
// (Halpern) or running sum (average), acc the entry of L K, kt = kh + t;
// y and ya are updated in place; returns Yb = 2 Y1 - Y and sets y1.
template <typename T, bool AVG>
__device__ __forceinline__ T primal_update(T& y, T& ya, T qj, T acc, T tau,
                                           T lo, T hi, T kt, T& y1) {
  const T y0 = y;
  y1 = clip(y0 - tau * (qj - acc), lo, hi);
  const T yb = T(2) * y1 - y0;
  if constexpr (AVG) {
    y = y1;
    ya += y1;
  } else {
    const T w = (kt + T(1)) / (kt + T(2));
    y = w * yb + (T(1) - w) * ya;
  }
  return yb;
}

// The step's update of one dual entry, likewise: l is the entry of L, la
// its anchor or running sum (updated in place under the average scheme),
// h of ht, acc of Yb K^T; returns the new L and sets l1 = T(z)'s entry.
template <typename T, bool AVG>
__device__ __forceinline__ T dual_update(T l, T& la, T h, T acc, T sig,
                                         bool eq, T kt, T& l1) {
  const T lr = l + sig * (h - acc);
  l1 = (eq || !(lr < T(0))) ? lr : T(0);
  if constexpr (AVG) {
    la += l1;
    return l1;
  } else {
    const T w = (kt + T(1)) / (kt + T(2));
    return w * (T(2) * l1 - l) + (T(1) - w) * la;
  }
}

// The ring of K chunks: chunk q of the launch lives in stage q % ns, its
// (q / ns)-th use, whose mbarrier phase has parity (q / ns) & 1; the chunk
// sequence repeats every step (G chunks, then S chunks)
struct Ring {
  int ns, per_step, total, q;
};

template <typename T, bool AVG>
__global__ void __launch_bounds__(kThreads, 1)
pdhg_stream_kernel(const T* __restrict__ K, int ldk,
                   const T* __restrict__ q,
                   int q_per_row, const T* __restrict__ lb,
                   const T* __restrict__ ub,
                   const uint8_t* __restrict__ is_eq,
                   const T* __restrict__ ht, const T* __restrict__ tau,
                   const T* __restrict__ sig, const T* __restrict__ Y0,
                   const T* __restrict__ L0, const T* __restrict__ kh,
                   const T* __restrict__ Yanc, const T* __restrict__ Lanc,
                   T* __restrict__ Yout, T* __restrict__ Lout,
                   T* __restrict__ Yout2, T* __restrict__ Lout2, int B,
                   int m, int n, int n_inner, int C) {
  constexpr int TM = kTM;
  constexpr bool F32 = sizeof(T) == 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / C) * TM;
  const int nrows = min(TM, B - row0);
  const Layout lay = layout<T>(C, m, n);
  const int nc = lay.nc, mc = lay.mc;
  const int c0 = rank * nc;                       // first owned column
  const int ncl = max(0, min(nc, n - c0));        // owned columns
  const int i0 = rank * mc;                       // first owned row
  const int mcl = max(0, min(mc, m - i0));        // owned rows
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* Ls = smem + lay.L;
  T* Ys = smem + lay.Y;
  T* Yas = smem + lay.Ya;
  T* Las = smem + lay.La;
  T* hs = smem + lay.hs;
  T* lbs = smem + lay.lbs;
  T* ubs = smem + lay.ubs;
  T* qs = smem + lay.qs;
  T* taus = smem + lay.rows;
  T* sigs = taus + TM;
  T* khs = sigs + TM;
  T* ring = smem + lay.ring;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);

  // the chunk sequence of a step: f32 G chunks (kr rows of K[:, slice]),
  // then S chunks (16 owned rows by jb columns, row group by row group);
  // f64 the column slice in chunks of 32 rows, twice
  const int nG = F32 ? (m + lay.kr - 1) / lay.kr
                     : (lay.mp + kKR64 - 1) / kKR64;
  const int nJ = F32 ? (n + lay.jb - 1) / lay.jb : 0;
  const int nGrp = (mcl + kWarps - 1) / kWarps;
  const int nS = F32 ? nGrp * nJ : nG;
  Ring rg = {lay.ns, nG + nS, (nG + nS) * n_inner, 0};

  // warp 0 issues a chunk's copies: lane 0 announces its bytes on the
  // stage's mbarrier, then the lanes issue a bulk copy per row segment
  auto load_chunk = [&](int qq) {
    if (qq >= rg.total || warp != 0) return;
    T* st = ring + static_cast<size_t>(qq % rg.ns) * lay.S;
    uint64_t* bar = bars + qq % rg.ns;
    const int c = qq % rg.per_step;
    const T* src;          // the first row's segment
    T* dst;
    int rows, stride;      // rows to copy, the chunk's row stride
    uint32_t bytes;        // of a row segment
    if constexpr (F32) {
      if (c < nG) {
        const int ia = c * lay.kr;
        rows = min(lay.kr, m - ia);
        src = K + static_cast<size_t>(ia) * ldk + c0;
        stride = nc;
        bytes = (ncl + 3) / 4 * 16;
      } else {
        const int grp = (c - nG) / nJ;
        const int j0 = ((c - nG) - grp * nJ) * lay.jb;
        rows = max(0, min(kWarps, mcl - grp * kWarps));
        src = K + static_cast<size_t>(i0 + grp * kWarps) * ldk + j0;
        stride = lay.jb;
        bytes = (min(lay.jb, n - j0) + 3) / 4 * 16;
      }
    } else {
      const int ia = (c % nG) * kKR64;
      rows = min(kKR64, m - ia);
      src = K + static_cast<size_t>(ia) * ldk + c0;
      stride = lay.ks;
      bytes = (ncl + 1) / 2 * 16;
    }
    dst = st;
    if (bytes == 0) rows = 0;
    if (lane == 0) bar_expect(bar, static_cast<uint32_t>(rows) * bytes);
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_copy(dst + static_cast<size_t>(r) * stride,
                src + static_cast<size_t>(r) * ldk, bytes, bar);
  };
  // the next chunk's stage, once its bytes have landed and every thread is
  // done with the stage the new load overwrites
  auto next_chunk = [&]() -> const T* {
    bar_wait(bars + rg.q % rg.ns, (rg.q / rg.ns) & 1);
    __syncthreads();
    load_chunk(rg.q + rg.ns - 1);
    const T* st = ring + static_cast<size_t>(rg.q % rg.ns) * lay.S;
    ++rg.q;
    return st;
  };

  // the tile's operands
  for (int jl = tid; jl < nc; jl += kThreads) {
    const bool ok = jl < ncl;
    lbs[jl] = ok ? lb[c0 + jl] : T(0);
    ubs[jl] = ok ? ub[c0 + jl] : T(0);
    qs[jl] = (ok && !q_per_row) ? q[c0 + jl] : T(0);
  }
  if (tid < TM) {
    const bool ok = tid < nrows;
    taus[tid] = ok ? tau[row0 + tid] : T(0);
    sigs[tid] = ok ? sig[row0 + tid] : T(0);
    khs[tid] = (ok && !AVG) ? kh[row0 + tid] : T(0);
  }
  const int ys = F32 ? nc : lay.ys;
  for (int idx = tid; idx < TM * nc; idx += kThreads) {
    const int r = idx / nc;
    const int jl = idx - r * nc;
    const bool ok = r < nrows && jl < ncl;
    const size_t gi = static_cast<size_t>(row0 + r) * n + c0 + jl;
    Ys[r * ys + jl] = ok ? Y0[gi] : T(0);
    Yas[r * ys + jl] = (ok && !AVG) ? Yanc[gi] : T(0);
  }
  if constexpr (F32) {
    for (int idx = tid; idx < m * TM; idx += kThreads) {
      const int i = idx / TM;
      const int r = idx - i * TM;
      Ls[idx] = r < nrows ? L0[static_cast<size_t>(row0 + r) * m + i]
                          : T(0);
    }
    for (int idx = tid; idx < mc * TM; idx += kThreads) {
      const int il = idx / TM;
      const int r = idx - il * TM;
      const bool ok = r < nrows && il < mcl;
      const size_t gi = static_cast<size_t>(row0 + r) * m + i0 + il;
      hs[idx] = ok ? ht[gi] : T(0);
      Las[idx] = (ok && !AVG) ? Lanc[gi] : T(0);
    }
  } else {
    const int nit = lay.mp / 8;
    for (int idx = tid; idx < TM * lay.mp; idx += kThreads) {
      const int r = idx / lay.mp;
      const int i = idx - r * lay.mp;
      Ls[a_offset(r, i, nit)] =
          (r < nrows && i < m) ? L0[static_cast<size_t>(row0 + r) * m + i]
                               : T(0);
    }
    T* Yb = smem + lay.Yb;
    for (int idx = tid; idx < TM * lay.ncp; idx += kThreads) Yb[idx] = T(0);
    for (int idx = tid; idx < TM * mc; idx += kThreads) {
      const int r = idx / mc;
      const int il = idx - r * mc;
      const bool ok = r < nrows && il < mcl;
      const size_t gi = static_cast<size_t>(row0 + r) * m + i0 + il;
      hs[idx] = ok ? ht[gi] : T(0);
      Las[idx] = (ok && !AVG) ? Lanc[gi] : T(0);
    }
  }
  // the ring starts at zero: the columns of a stage past a CTA's owned
  // slice are never copied, and the products read them (as zeros) in
  // float64
  for (size_t idx = tid; idx < static_cast<size_t>(rg.ns) * lay.S;
       idx += kThreads)
    ring[idx] = T(0);
  if (tid == 0) {
    for (int s = 0; s < rg.ns; ++s) bar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  for (int s = 0; s < rg.ns - 1; ++s) load_chunk(s);
  // every CTA of the cluster runs before any store reaches it
  cluster.sync();

  const T cnt = static_cast<T>(n_inner);
  for (int t = 0; t < n_inner; ++t) {
    const bool last = t == n_inner - 1;
    if constexpr (F32) {
      // ---- G = q - L K[:, slice]: units (column jl, rows g*8 .. g*8+7),
      // unit u = g ncl + jl, a thread takes u = tid and tid + kThreads
      T acc[2][kRows32];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int r = 0; r < kRows32; ++r) acc[u][r] = T(0);
      const int units = 2 * ncl;
      for (int c = 0; c < nG; ++c) {
        const T* st = next_chunk();
        const int ia = c * lay.kr;
        const int rows = min(lay.kr, m - ia);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int unit = tid + u * kThreads;
          if (unit < units) {
            const int g = unit >= ncl;
            const int jl = unit - g * ncl;
            const T* Li = Ls + static_cast<size_t>(ia) * TM + g * kRows32;
#pragma unroll 4
            for (int il = 0; il < rows; ++il) {
              const T kij = st[il * nc + jl];
              const float4 a = *reinterpret_cast<const float4*>(Li);
              const float4 b = *reinterpret_cast<const float4*>(Li + 4);
              acc[u][0] += a.x * kij;
              acc[u][1] += a.y * kij;
              acc[u][2] += a.z * kij;
              acc[u][3] += a.w * kij;
              acc[u][4] += b.x * kij;
              acc[u][5] += b.y * kij;
              acc[u][6] += b.z * kij;
              acc[u][7] += b.w * kij;
              Li += TM;
            }
          }
        }
      }
      // primal update of the thread's units; Yb into every CTA's Yt
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int unit = tid + u * kThreads;
        if (unit < units) {
          const int g = unit >= ncl;
          const int jl = unit - g * ncl;
          const int j = c0 + jl;
          const T lo = lbs[jl];
          const T hi = ubs[jl];
          T yb8[kRows32];
#pragma unroll
          for (int rr = 0; rr < kRows32; ++rr) {
            const int r = g * kRows32 + rr;
            const bool live = r < nrows;
            const size_t gi = static_cast<size_t>(row0 + r) * n + j;
            const T qj = q_per_row ? (live ? q[gi] : T(0)) : qs[jl];
            T y1;
            yb8[rr] = primal_update<T, AVG>(
                Ys[r * nc + jl], Yas[r * nc + jl], qj, acc[u][rr], taus[r],
                lo, hi, khs[r] + T(t), y1);
            if (last && live) {
              Yout[gi] = Ys[r * nc + jl];
              Yout2[gi] = AVG ? Yas[r * nc + jl] / cnt : y1;
            }
          }
          T* Yt = smem + lay.Yt;
          const int lo4 = yt_offset(j, 2 * g);
          const int hi4 = yt_offset(j, 2 * g + 1);
          for (int cc = 0; cc < C; ++cc) {
            st_cluster4(cluster_addr(Yt + lo4, cc), yb8[0], yb8[1], yb8[2],
                        yb8[3]);
            st_cluster4(cluster_addr(Yt + hi4, cc), yb8[4], yb8[5], yb8[6],
                        yb8[7]);
          }
        }
      }
      cluster.sync();
      // ---- S = ht - Yb K^T on the owned rows: row group by row group, a
      // warp per row, lane l over j = l mod 32
      const T* Yt = smem + lay.Yt;
      for (int grp = 0; grp < nGrp; ++grp) {
        const int il = grp * kWarps + warp;
        T acc16[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) acc16[r] = T(0);
        for (int jc = 0; jc < nJ; ++jc) {
          const T* st = next_chunk();
          if (il >= mcl) continue;
          const int j0 = jc * lay.jb;
          const int cols = min(lay.jb, n - j0);
          const T* Kw = st + warp * lay.jb;
#pragma unroll 2
          for (int jj = lane; jj < cols; jj += 32) {
            const T kij = Kw[jj];
            const int j = j0 + jj;
#pragma unroll
            for (int qd = 0; qd < 4; ++qd) {
              const float4 v =
                  *reinterpret_cast<const float4*>(Yt + yt_offset(j, qd));
              acc16[4 * qd] += kij * v.x;
              acc16[4 * qd + 1] += kij * v.y;
              acc16[4 * qd + 2] += kij * v.z;
              acc16[4 * qd + 3] += kij * v.w;
            }
          }
        }
        if (il >= mcl) continue;
        // reduce-scatter over the lanes: lanes 2 r and 2 r + 1 end with
        // row r's sum
        scatter_level<8>(acc16, lane);
        scatter_level<4>(acc16, lane);
        scatter_level<2>(acc16, lane);
        scatter_level<1>(acc16, lane);
        acc16[0] += __shfl_xor_sync(0xffffffffu, acc16[0], 1);
        const int r = lane >> 1;
        const int i = i0 + il;
        const bool even = (lane & 1) == 0;
        const int at = i * TM + r;
        const int own = il * TM + r;
        T la = Las[own];
        T l1;
        const T lnew = dual_update<T, AVG>(Ls[at], la, hs[own], acc16[0],
                                           sigs[r], is_eq[i] != 0,
                                           khs[r] + T(t), l1);
        if (even) {
          if (AVG) Las[own] = la;
          if (last && r < nrows) {
            const size_t gi = static_cast<size_t>(row0 + r) * m + i;
            Lout[gi] = lnew;
            Lout2[gi] = AVG ? la / cnt : l1;
          }
        }
        __syncwarp();
        // the pair splits the stores: even lanes to even ranks
        for (int cc = lane & 1; cc < C; cc += 2)
          st_cluster(cluster_addr(Ls + at, cc), lnew);
      }
    } else {
      // ---- float64: G = q - L K[:, slice] on FP64 matrix instructions
      const int nit = lay.mp / 8;
      const int njt = lay.ncp / 8;
      const int g = lane >> 2;
      const int tig = lane & 3;
      T* Yb = smem + lay.Yb;
      T* Rx = smem + lay.Rx;
      Acc<T> acc[kMaxTiles64];
#pragma unroll
      for (int u = 0; u < kMaxTiles64; ++u) acc[u].zero();
      for (int c = 0; c < nG; ++c) {
        const T* st = next_chunk();
        const int ks0 = c * (kKR64 / 8);
        const int kst = min(kKR64, lay.mp - c * kKR64) / 8;
#pragma unroll
        for (int u = 0; u < kMaxTiles64; ++u) {
          const int nt = warp + u * kWarps;
          if (nt < njt) {
            for (int ks = 0; ks < kst; ++ks) {
              const T* blk = Ls + (ks0 + ks) * 128 + 4 * lane;
              const double2 x = *reinterpret_cast<const double2*>(blk);
              const double2 z = *reinterpret_cast<const double2*>(blk + 2);
              const double a[4] = {x.x, x.y, z.x, z.y};
              // (k, column) = (tig, g) and (tig + 4, g) of the block
              const T* Bb = st + (ks * 8 + tig) * lay.ks + nt * 8 + g;
              const double b[2] = {Bb[0], Bb[4 * lay.ks]};
              mma_f64(acc[u].v, a, b);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kMaxTiles64; ++u) {
        const int nt = warp + u * kWarps;
        if (nt < njt) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int r = g + (cc >> 1) * 8;
            const int jl = nt * 8 + 2 * tig + (cc & 1);
            if (jl < ncl) {
              const bool live = r < nrows;
              const size_t gi = static_cast<size_t>(row0 + r) * n + c0 + jl;
              const T qj = q_per_row ? (live ? q[gi] : T(0)) : qs[jl];
              T y1;
              Yb[a_offset(r, jl, njt)] = primal_update<T, AVG>(
                  Ys[r * ys + jl], Yas[r * ys + jl], qj, acc[u].v[cc],
                  taus[r], lbs[jl], ubs[jl], khs[r] + T(t), y1);
              if (last && live) {
                Yout[gi] = Ys[r * ys + jl];
                Yout2[gi] = AVG ? Yas[r * ys + jl] / cnt : y1;
              }
            }
          }
        }
      }
      // (next_chunk's barrier orders the Yb stores before their reads)
      // ---- this CTA's share of Yb K^T: a warp per 8 constraint rows of
      // the chunk, stored into the owner's exchange buffer
      for (int c = 0; c < nG; ++c) {
        const T* st = next_chunk();
        const int kst = min(kKR64, lay.mp - c * kKR64) / 8;
        if (warp < kst) {
          Acc<T> s;
          s.zero();
          for (int kc = 0; kc < njt; ++kc) {
            const T* blk = Yb + kc * 128 + 4 * lane;
            const double2 x = *reinterpret_cast<const double2*>(blk);
            const double2 z = *reinterpret_cast<const double2*>(blk + 2);
            const double a[4] = {x.x, x.y, z.x, z.y};
            // (k, row) = (tig, g) and (tig + 4, g): K[row, k]
            const T* Bb = st + (warp * 8 + g) * lay.ks + kc * 8 + tig;
            const double b[2] = {Bb[0], Bb[4]};
            mma_f64(s.v, a, b);
          }
          const int i = c * kKR64 + warp * 8 + 2 * tig;
          if (i < m) {
            const int owner = i / mc;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = g + h * 8;
              st_cluster2(cluster_addr(Rx + (rank * TM + r) * mc + i -
                                           owner * mc, owner),
                          s.v[2 * h], s.v[2 * h + 1]);
            }
          }
        }
      }
      cluster.sync();
      // dual step of the owned rows: the shares in rank order; the new L
      // into every CTA's copy
      for (int idx = tid; idx < TM * mcl; idx += kThreads) {
        const int r = idx / mcl;
        const int il = idx - r * mcl;
        const int i = i0 + il;
        T s = T(0);
        for (int cc = 0; cc < C; ++cc) s += Rx[(cc * TM + r) * mc + il];
        const int lat = a_offset(r, i, nit);
        T l1;
        const T lnew = dual_update<T, AVG>(Ls[lat], Las[r * mc + il],
                                           hs[r * mc + il], s, sigs[r],
                                           is_eq[i] != 0, khs[r] + T(t), l1);
        if (last && r < nrows) {
          const size_t gi = static_cast<size_t>(row0 + r) * m + i;
          Lout[gi] = lnew;
          Lout2[gi] = AVG ? Las[r * mc + il] / cnt : l1;
        }
        for (int cc = 0; cc < C; ++cc)
          st_cluster(cluster_addr(Ls + lat, cc), lnew);
      }
    }
    // the new L has landed everywhere; also keeps every CTA resident until
    // the others' stores into it are done
    cluster.sync();
  }
}

// launches one cluster of C CTAs per tile of TM rows, or with max_clusters
// set only asks the card how many such clusters it runs at once; returns
// cudaError_t
template <typename T, bool AVG>
int launch(int C, int TM, int ldk, const Args& a, int* max_clusters) {
  if (C < 2 || C > 16 || TM != kTM || ldk < a.n ||
      ldk % (16 / static_cast<int>(sizeof(T))) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout<T>(C, a.m, a.n);
  const size_t smem = lay.total * sizeof(T);
  if (!lay.ok || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pdhg_stream_kernel<T, AVG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int ntiles = max(1, (a.B + kTM - 1) / kTM);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ntiles);
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
      &cfg, kernel, static_cast<const T*>(a.K), ldk,
      static_cast<const T*>(a.q),
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
int occupancy(int f64, int C, int TM, int m, int n, int* out) {
  Args a = {};
  a.B = kTM;
  a.m = m;
  a.n = n;
  a.n_inner = 1;
  const int ldk = (n + 3) / 4 * 4;
  return f64 ? launch<double, AVG>(C, TM, ldk, a, out)
             : launch<float, AVG>(C, TM, ldk, a, out);
}

// shared memory of one CTA in bytes, 0 where the shapes do not fit
inline long long smem_bytes(int f64, int C, int m, int n) {
  const Layout l = f64 ? layout<double>(C, m, n) : layout<float>(C, m, n);
  const size_t bytes = l.total * (f64 ? 8 : 4);   // mbarriers included
  return (l.ok && bytes <= kSmemMax) ? static_cast<long long>(bytes) : 0;
}

}  // namespace pdhg_stream
