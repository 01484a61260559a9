// PDHG round for small batches, both restart schemes: one thread-block
// cluster per group of batch rows, K resident in the cluster's shared
// memory (Hopper, sm_90a). Instantiated by pdhg_halpern_cluster.cu
// (reflected Halpern, AVG = false) and pdhg_average_cluster.cu (restart to
// the average, AVG = true); the step's two products are written once here,
// so both schemes reduce in the same order.
//
// Per row and step, both schemes:
//
//   G  = q - L K,  Y1 = clip(Y - tau G, lb, ub),  Yb = 2 Y1 - Y
//   S  = ht - Yb K^T,  L1 = L + sig S projected ('==' rows free)
//
// then Halpern:  w = (kh + t + 1) / (kh + t + 2)
//                Y <- w Yb + (1 - w) Yanc,  L <- w (2 L1 - L) + (1 - w) Lanc
//                returns the carry (Y, L) and the last candidate (Y1, L1)
//      average:  Y <- Y1, L <- L1, Ysum += Y1, Lsum += L1
//                returns the last iterate and (Ysum, Lsum) / n_inner (a
//                true division, as ops/cuda/pdhg_kernel.py:
//                pdhg_average_round_ref divides)
//
// The design, for a cluster of C CTAs (C = 4, 8 or 16, from
// ops/cuda/pdhg_kernel.py):
//
// - K resident: CTA c owns the contiguous column slice [c nc, (c+1) nc) and
//   loads K[:, slice] once per launch into its shared memory, stored
//   column-major (Ks[j][i]), and keeps it for all n_inner steps.
// - Primal step, local: a warp per owned column j, its lanes over the m
//   constraint rows (i = lane + 32 k, k < MI). Each lane keeps its share
//   of every row's L in registers for the step, forms G_j with a butterfly
//   warp sum (every lane ends with the same bits), and updates column j
//   (Halpern: Y, Y1 and the anchor blend; average: Y and its running sum,
//   which stays local to the owning CTA).
// - Dual step, one exchange: the same warp then adds Yb_j K[i, j] into
//   per-lane partial sums of S for its lanes' rows, reusing the K values it
//   just read, so each K element leaves shared memory once per step. The
//   warps' partials are summed in warp order into this CTA's exchange
//   buffer; after one cluster barrier every CTA reads the C buffers over
//   distributed shared memory and sums them in rank order 0..C-1, so every
//   CTA updates a bitwise-identical copy of L (and, in the average scheme,
//   of Lsum) and a seeded run stays deterministic. The exchange buffer is
//   double-buffered, so one cluster barrier per step suffices.
// - Arithmetic: plain FP32/FP64 FMA, no tensor cores.
//
// A cluster carries R batch rows (R in {1, 2, 4, 8}); every K element read
// from shared memory serves all R of them. Rows past B in a ragged last
// cluster run on zeros and are never written back. A row keeps 3 [nc] and
// 4 [m] vectors under Halpern and 2 and 3 under the average scheme (no
// anchors, no separate candidate), so the two schemes have their own
// shared-memory counts.

#pragma once

#include <cooperative_groups.h>

#include "pdhg_common.cuh"

namespace pdhg_cluster {

namespace cg = cooperative_groups;

using pdhg::clip;
using Args = pdhg::RoundArgs;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// every lane ends with the same bits: at each level partners add the same
// two values, and floating-point addition commutes
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// register budget of the per-lane arrays (L, S partials, K values), in
// 32-bit registers: either scheme keeps (2 R + 1) MI values of type T
template <typename T, int R, int MI>
constexpr bool fits_registers() {
  return (2 * R + 1) * MI * static_cast<int>(sizeof(T) / 4) <= 108;
}

// [nc] and [m] vectors a batch row keeps in shared memory
template <bool AVG>
constexpr int y_vectors() { return AVG ? 2 : 3; }
template <bool AVG>
constexpr int l_vectors() { return AVG ? 3 : 4; }

// shared-memory footprint in elements of T (mirrored by
// ops/cuda/pdhg_kernel.py:_cluster_smem)
template <bool AVG>
inline size_t cluster_smem_elems(int C, int R, int m, int n, int q_rows) {
  const size_t nc = (n + C - 1) / C;
  return nc * m + (2 + q_rows + y_vectors<AVG>() * R) * nc +
         static_cast<size_t>(l_vectors<AVG>() + kWarps + 2) * R * m;
}

// Halpern: aux = (kh, Yanc, Lanc), out = (Ycarry, Lcarry, Ycand, Lcand);
// average: aux unused (null), out = (Y, L, Yavg, Lavg)
template <typename T, bool AVG, int R, int MI>
__global__ void __launch_bounds__(kThreads, 1)
pdhg_cluster_kernel(const T* __restrict__ K, const T* __restrict__ q,
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
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / C) * R;
  const int nrows = min(R, B - row0);
  const int nc = (n + C - 1) / C;
  const int c0 = rank * nc;
  const int ncl = max(0, min(nc, n - c0));
  const int q_rows = q_per_row ? R : 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);      // [nc][m], column-major
  T* lbs = Ks + static_cast<size_t>(nc) * m;   // [nc]
  T* ubs = lbs + nc;                           // [nc]
  T* qs = ubs + nc;                            // [q_rows][nc]
  T* Ys = qs + q_rows * nc;                    // [R][nc] iterate / carry
  T* Yas = Ys + R * nc;                        // [R][nc] anchor | sum
  T* Ycs = Yas + R * nc;                       // [R][nc] candidate (Halpern)
  T* Ls = AVG ? Ycs : Ycs + R * nc;            // [R][m] iterate / carry
  T* Las = Ls + R * m;                         // [R][m] anchor | sum
  T* Lcs = Las + R * m;                        // [R][m] candidate (Halpern)
  T* hs = AVG ? Lcs : Lcs + R * m;             // [R][m] right-hand side
  T* scr = hs + R * m;                         // [kWarps][R][m]
  T* exch = scr + kWarps * R * m;              // [2][R][m]

  for (int idx = tid; idx < ncl * m; idx += kThreads) {
    const int i = idx / ncl;
    const int jl = idx - i * ncl;
    Ks[jl * m + i] = K[static_cast<size_t>(i) * n + c0 + jl];
  }
  for (int jl = tid; jl < ncl; jl += kThreads) {
    lbs[jl] = lb[c0 + jl];
    ubs[jl] = ub[c0 + jl];
    if (!q_per_row) qs[jl] = q[c0 + jl];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = r < nrows;
      const size_t g = static_cast<size_t>(row0 + r) * n + c0 + jl;
      const T y = ok ? Y0[g] : T(0);
      Ys[r * nc + jl] = y;
      if constexpr (AVG) {
        Yas[r * nc + jl] = T(0);
      } else {
        Ycs[r * nc + jl] = y;
        Yas[r * nc + jl] = ok ? Yanc[g] : T(0);
      }
      if (q_per_row) qs[r * nc + jl] = ok ? q[g] : T(0);
    }
  }
  for (int i = tid; i < m; i += kThreads) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = r < nrows;
      const size_t g = static_cast<size_t>(row0 + r) * m + i;
      const T l = ok ? L0[g] : T(0);
      Ls[r * m + i] = l;
      if constexpr (AVG) {
        Las[r * m + i] = T(0);
      } else {
        Lcs[r * m + i] = l;
        Las[r * m + i] = ok ? Lanc[g] : T(0);
      }
      hs[r * m + i] = ok ? ht[g] : T(0);
    }
  }
  T tau_r[R], sig_r[R], kh_r[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool ok = r < nrows;
    tau_r[r] = ok ? tau[row0 + r] : T(0);
    sig_r[r] = ok ? sig[row0 + r] : T(0);
    kh_r[r] = T(0);
    if constexpr (!AVG) kh_r[r] = ok ? kh[row0 + r] : T(0);
  }
  __syncthreads();

  for (int t = 0; t < n_inner; ++t) {
    T w_r[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T k = kh_r[r] + T(t);
      w_r[r] = (k + T(1)) / (k + T(2));
    }
    // this lane's share of L for the step, and its S partial sums
    T Lr[R][MI], P[R][MI];
#pragma unroll
    for (int k = 0; k < MI; ++k) {
      const int i = lane + 32 * k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        Lr[r][k] = i < m ? Ls[r * m + i] : T(0);
        P[r][k] = T(0);
      }
    }
    // primal step of each owned column, fused with its S contribution
    for (int jl = warp; jl < ncl; jl += kWarps) {
      const T* Kc = Ks + jl * m;
      T kv[MI];
#pragma unroll
      for (int k = 0; k < MI; ++k) {
        const int i = lane + 32 * k;
        kv[k] = i < m ? Kc[i] : T(0);
      }
      T acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = T(0);
#pragma unroll
        for (int k = 0; k < MI; ++k) acc[r] += Lr[r][k] * kv[k];
        acc[r] = warp_allsum(acc[r]);
      }
      const T lo = lbs[jl];
      const T hi = ubs[jl];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T qj = qs[(q_per_row ? r * nc : 0) + jl];
        const T y = Ys[r * nc + jl];
        const T y1 = clip(y - tau_r[r] * (qj - acc[r]), lo, hi);
        const T yb = T(2) * y1 - y;
        const T ya = Yas[r * nc + jl];
        __syncwarp();
        if (lane == 0) {
          if constexpr (AVG) {
            Ys[r * nc + jl] = y1;
            Yas[r * nc + jl] = ya + y1;
          } else {
            Ycs[r * nc + jl] = y1;
            Ys[r * nc + jl] = w_r[r] * yb + (T(1) - w_r[r]) * ya;
          }
        }
#pragma unroll
        for (int k = 0; k < MI; ++k) P[r][k] += yb * kv[k];
      }
    }
    // this CTA's S partial: the warps' sums in warp order
#pragma unroll
    for (int k = 0; k < MI; ++k) {
      const int i = lane + 32 * k;
      if (i < m) {
#pragma unroll
        for (int r = 0; r < R; ++r) scr[(warp * R + r) * m + i] = P[r][k];
      }
    }
    __syncthreads();
    T* ex = exch + (t & 1) * R * m;
    for (int idx = tid; idx < R * m; idx += kThreads) {
      T s = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += scr[w * R * m + idx];
      ex[idx] = s;
    }
    cluster.sync();
    // the cluster's S, summed in rank order; every CTA updates its own
    // bitwise-identical copy of L
    for (int i = tid; i < m; i += kThreads) {
      const bool eq = is_eq[i] != 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int idx = r * m + i;
        // all C remote loads in flight before the first add
        T part[16];
#pragma unroll
        for (int c = 0; c < 16; ++c)
          part[c] = c < C ? cluster.map_shared_rank(ex, c)[idx] : T(0);
        T s = T(0);
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if (c < C) s += part[c];
        const T l = Ls[idx];
        const T lr = l + sig_r[r] * (hs[idx] - s);
        const T l1 = (eq || !(lr < T(0))) ? lr : T(0);
        if constexpr (AVG) {
          Ls[idx] = l1;
          Las[idx] += l1;
        } else {
          Lcs[idx] = l1;
          Ls[idx] = w_r[r] * (T(2) * l1 - l) + (T(1) - w_r[r]) * Las[idx];
        }
      }
    }
    __syncthreads();
  }

  const T cnt = static_cast<T>(n_inner);
  for (int jl = tid; jl < ncl; jl += kThreads) {
    for (int r = 0; r < nrows; ++r) {
      const size_t g = static_cast<size_t>(row0 + r) * n + c0 + jl;
      Yout[g] = Ys[r * nc + jl];
      Yout2[g] = AVG ? Yas[r * nc + jl] / cnt : Ycs[r * nc + jl];
    }
  }
  if (rank == 0) {
    for (int i = tid; i < m; i += kThreads) {
      for (int r = 0; r < nrows; ++r) {
        const size_t g = static_cast<size_t>(row0 + r) * m + i;
        Lout[g] = Ls[r * m + i];
        Lout2[g] = AVG ? Las[r * m + i] / cnt : Lcs[r * m + i];
      }
    }
  }
  // no CTA leaves while another may still read its exchange buffer
  cluster.sync();
}

// launches, or with max_clusters set only asks the card how many such
// clusters it runs at once; returns cudaError_t
template <typename T, bool AVG, int R, int MI>
int launch_cluster(int C, const Args& a, int* max_clusters) {
  if constexpr (!fits_registers<T, R, MI>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (C < 2 || C > 16 || a.m > 32 * MI)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem =
        cluster_smem_elems<AVG>(C, R, a.m, a.n, a.q_per_row ? R : 1) *
        sizeof(T);
    auto kernel = pdhg_cluster_kernel<T, AVG, R, MI>;
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
    cfg.gridDim = dim3(C * ((a.B + R - 1) / R));
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
        a.q_per_row, static_cast<const T*>(a.lb),
        static_cast<const T*>(a.ub), static_cast<const uint8_t*>(a.is_eq),
        static_cast<const T*>(a.ht), static_cast<const T*>(a.tau),
        static_cast<const T*>(a.sig), static_cast<const T*>(a.Y),
        static_cast<const T*>(a.L), static_cast<const T*>(a.kh),
        static_cast<const T*>(a.Yanc), static_cast<const T*>(a.Lanc),
        static_cast<T*>(a.Yout), static_cast<T*>(a.Lout),
        static_cast<T*>(a.Yout2), static_cast<T*>(a.Lout2), a.B, a.m, a.n,
        a.n_inner, C);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, bool AVG, int R>
int launch_mi(int C, const Args& a, int* max_clusters) {
  if (a.m <= 32 * 6) return launch_cluster<T, AVG, R, 6>(C, a, max_clusters);
  return launch_cluster<T, AVG, R, 18>(C, a, max_clusters);
}

template <typename T, bool AVG>
int launch(int C, int R, const Args& a, int* max_clusters) {
  switch (R) {
    case 1:
      return launch_mi<T, AVG, 1>(C, a, max_clusters);
    case 2:
      return launch_mi<T, AVG, 2>(C, a, max_clusters);
    case 4:
      return launch_mi<T, AVG, 4>(C, a, max_clusters);
    case 8:
      return launch_mi<T, AVG, 8>(C, a, max_clusters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cudaOccupancyMaxActiveClusters of a launch at these shapes (shared q)
template <bool AVG>
int occupancy(int f64, int C, int R, int B, int m, int n, int* out) {
  Args a = {};
  a.B = B;
  a.m = m;
  a.n = n;
  a.n_inner = 1;
  return f64 ? launch<double, AVG>(C, R, a, out)
             : launch<float, AVG>(C, R, a, out);
}

}  // namespace pdhg_cluster
