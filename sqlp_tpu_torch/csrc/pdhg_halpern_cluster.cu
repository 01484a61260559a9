// Reflected-Halpern PDHG round for small batches: one thread-block cluster
// per group of batch rows, K resident in the cluster's shared memory
// (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas_halpern
// (body _kernel_halpern) in its small-panel regime (the SD step's B = 2
// panel and the short tails of the MC ladder); pdhg_halpern_round.cu keeps
// the large panels. It computes exactly what the row-block kernel and
// ops/cuda/pdhg_kernel.py:pdhg_halpern_round_ref compute: per row and step
//
//   G  = q - L K,  Y1 = clip(Y - tau G, lb, ub),  Yb = 2 Y1 - Y
//   S  = ht - Yb K^T,  L1 = L + sig S projected ('==' rows free)
//   w  = (kh + t + 1) / (kh + t + 2)
//   Y <- w Yb + (1 - w) Yanc,  L <- w (2 L1 - L) + (1 - w) Lanc
//
// and returns the carry (Y, L) and the last candidate (Y1, L1).
//
// What bounds it on this card: at B = 2 the row-block kernel runs two
// blocks, each re-reading K (482 KB for ssn in f32) from L2 twice per step
// through one SM, so a round is bound by one SM's L2 bandwidth. The TPU
// kernel kept K in VMEM for the whole round. The design here does the same
// with a cluster of C CTAs (C = 4, 8 or 16, from ops/cuda/pdhg_kernel.py:
// _plan):
//
// - K resident: CTA c owns the contiguous column slice [c nc, (c+1) nc) and
//   loads K[:, slice] once per launch into its shared memory, stored
//   column-major (Ks[j][i]), and keeps it for all n_inner steps.
// - Primal step, local: a warp per owned column j, its lanes over the m
//   constraint rows (i = lane + 32 k, k < MI). Each lane keeps its share
//   of every row's L in registers for the step, forms G_j with a butterfly
//   warp sum (every lane ends with the same bits), and updates Y, Y1 and
//   the anchor blend for column j.
// - Dual step, one exchange: the same warp then adds Yb_j K[i, j] into
//   per-lane partial sums of S for its lanes' rows, reusing the K values it
//   just read, so each K element leaves shared memory once per step. The
//   warps' partials are summed in warp order into this CTA's exchange
//   buffer; after one cluster barrier every CTA reads the C buffers over
//   distributed shared memory and sums them in rank order 0..C-1, so every
//   CTA updates a bitwise-identical copy of L and a seeded run stays
//   deterministic. The exchange buffer is double-buffered, so one cluster
//   barrier per step suffices.
// - Arithmetic: plain FP32/FP64 FMA, no tensor cores.
//
// A cluster carries R batch rows (R in {1, 2, 4, 8}); every K element read
// from shared memory serves all R of them. Rows past B in a ragged last
// cluster run on zeros and are never written back.

#include <cooperative_groups.h>

#include "pdhg_common.cuh"

namespace cg = cooperative_groups;

namespace {

using pdhg::clip;

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
// 32-bit registers: the kernel keeps (2 R + 1) MI values of type T
template <typename T, int R, int MI>
constexpr bool fits_registers() {
  return (2 * R + 1) * MI * static_cast<int>(sizeof(T) / 4) <= 108;
}

// shared-memory footprint in elements of T (mirrored by
// ops/cuda/pdhg_kernel.py:_cluster_smem)
__host__ __device__ inline size_t cluster_smem_elems(int C, int R, int m,
                                                     int n, int q_rows) {
  const size_t nc = (n + C - 1) / C;
  return nc * m + (2 + q_rows + 3 * R) * nc +
         static_cast<size_t>(4 + kWarps + 2) * R * m;
}

template <typename T, int R, int MI>
__global__ void __launch_bounds__(kThreads, 1)
pdhg_halpern_cluster_kernel(const T* __restrict__ K, const T* __restrict__ q,
                            int q_per_row, const T* __restrict__ lb,
                            const T* __restrict__ ub,
                            const uint8_t* __restrict__ is_eq,
                            const T* __restrict__ ht,
                            const T* __restrict__ tau,
                            const T* __restrict__ sig,
                            const T* __restrict__ Y0,
                            const T* __restrict__ L0,
                            const T* __restrict__ kh,
                            const T* __restrict__ Yanc,
                            const T* __restrict__ Lanc, T* __restrict__ Yout,
                            T* __restrict__ Lout, T* __restrict__ Ycand,
                            T* __restrict__ Lcand, int B, int m, int n,
                            int n_inner, int C) {
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
  T* Ys = qs + q_rows * nc;                    // [R][nc] carry
  T* Yas = Ys + R * nc;                        // [R][nc] anchor
  T* Ycs = Yas + R * nc;                       // [R][nc] candidate
  T* Ls = Ycs + R * nc;                        // [R][m] carry
  T* Las = Ls + R * m;                         // [R][m] anchor
  T* Lcs = Las + R * m;                        // [R][m] candidate
  T* hs = Lcs + R * m;                         // [R][m] right-hand side
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
      Ycs[r * nc + jl] = y;
      Yas[r * nc + jl] = ok ? Yanc[g] : T(0);
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
      Lcs[r * m + i] = l;
      Las[r * m + i] = ok ? Lanc[g] : T(0);
      hs[r * m + i] = ok ? ht[g] : T(0);
    }
  }
  T tau_r[R], sig_r[R], kh_r[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool ok = r < nrows;
    tau_r[r] = ok ? tau[row0 + r] : T(0);
    sig_r[r] = ok ? sig[row0 + r] : T(0);
    kh_r[r] = ok ? kh[row0 + r] : T(0);
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
          Ycs[r * nc + jl] = y1;
          Ys[r * nc + jl] = w_r[r] * yb + (T(1) - w_r[r]) * ya;
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
        Lcs[idx] = l1;
        Ls[idx] = w_r[r] * (T(2) * l1 - l) + (T(1) - w_r[r]) * Las[idx];
      }
    }
    __syncthreads();
  }

  for (int jl = tid; jl < ncl; jl += kThreads) {
    for (int r = 0; r < nrows; ++r) {
      const size_t g = static_cast<size_t>(row0 + r) * n + c0 + jl;
      Yout[g] = Ys[r * nc + jl];
      Ycand[g] = Ycs[r * nc + jl];
    }
  }
  if (rank == 0) {
    for (int i = tid; i < m; i += kThreads) {
      for (int r = 0; r < nrows; ++r) {
        const size_t g = static_cast<size_t>(row0 + r) * m + i;
        Lout[g] = Ls[r * m + i];
        Lcand[g] = Lcs[r * m + i];
      }
    }
  }
  // no CTA leaves while another may still read its exchange buffer
  cluster.sync();
}

template <typename T, int R, int MI>
int launch_cluster(int C, const void* K, const void* q, int q_per_row,
                   const void* lb, const void* ub, const void* is_eq,
                   const void* ht, const void* tau, const void* sig,
                   const void* Y, const void* L, const void* kh,
                   const void* Yanc, const void* Lanc, void* Yout, void* Lout,
                   void* Ycand, void* Lcand, int B, int m, int n,
                   int n_inner, void* stream, int* max_clusters) {
  if constexpr (!fits_registers<T, R, MI>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (C < 2 || C > 16 || m > 32 * MI)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem =
        cluster_smem_elems(C, R, m, n, q_per_row ? R : 1) * sizeof(T);
    auto kernel = pdhg_halpern_cluster_kernel<T, R, MI>;
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
    cfg.gridDim = dim3(C * ((B + R - 1) / R));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (max_clusters != nullptr) {
      err = cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
      return static_cast<int>(err);
    }
    err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(K), static_cast<const T*>(q),
        q_per_row, static_cast<const T*>(lb), static_cast<const T*>(ub),
        static_cast<const uint8_t*>(is_eq), static_cast<const T*>(ht),
        static_cast<const T*>(tau), static_cast<const T*>(sig),
        static_cast<const T*>(Y), static_cast<const T*>(L),
        static_cast<const T*>(kh), static_cast<const T*>(Yanc),
        static_cast<const T*>(Lanc), static_cast<T*>(Yout),
        static_cast<T*>(Lout), static_cast<T*>(Ycand),
        static_cast<T*>(Lcand), B, m, n, n_inner, C);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int R>
int launch_mi(int C, const void* K, const void* q, int q_per_row,
              const void* lb, const void* ub, const void* is_eq,
              const void* ht, const void* tau, const void* sig, const void* Y,
              const void* L, const void* kh, const void* Yanc,
              const void* Lanc, void* Yout, void* Lout, void* Ycand,
              void* Lcand, int B, int m, int n, int n_inner, void* stream,
              int* max_clusters) {
  if (m <= 32 * 6)
    return launch_cluster<T, R, 6>(C, K, q, q_per_row, lb, ub, is_eq, ht,
                                   tau, sig, Y, L, kh, Yanc, Lanc, Yout, Lout,
                                   Ycand, Lcand, B, m, n, n_inner, stream,
                                   max_clusters);
  return launch_cluster<T, R, 18>(C, K, q, q_per_row, lb, ub, is_eq, ht, tau,
                                  sig, Y, L, kh, Yanc, Lanc, Yout, Lout,
                                  Ycand, Lcand, B, m, n, n_inner, stream,
                                  max_clusters);
}

template <typename T>
int launch(int C, int R, const void* K, const void* q, int q_per_row,
           const void* lb, const void* ub, const void* is_eq, const void* ht,
           const void* tau, const void* sig, const void* Y, const void* L,
           const void* kh, const void* Yanc, const void* Lanc, void* Yout,
           void* Lout, void* Ycand, void* Lcand, int B, int m, int n,
           int n_inner, void* stream, int* max_clusters) {
  switch (R) {
    case 1:
      return launch_mi<T, 1>(C, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                             Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand,
                             B, m, n, n_inner, stream, max_clusters);
    case 2:
      return launch_mi<T, 2>(C, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                             Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand,
                             B, m, n, n_inner, stream, max_clusters);
    case 4:
      return launch_mi<T, 4>(C, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                             Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand,
                             B, m, n, n_inner, stream, max_clusters);
    case 8:
      return launch_mi<T, 8>(C, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                             Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand,
                             B, m, n, n_inner, stream, max_clusters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// one round on a cluster of C CTAs per R batch rows; returns cudaError_t
int pdhg_halpern_cluster_f32(int C, int R, const void* K, const void* q,
                             int q_per_row, const void* lb, const void* ub,
                             const void* is_eq, const void* ht,
                             const void* tau, const void* sig, const void* Y,
                             const void* L, const void* kh, const void* Yanc,
                             const void* Lanc, void* Yout, void* Lout,
                             void* Ycand, void* Lcand, int B, int m, int n,
                             int n_inner, void* stream) {
  return launch<float>(C, R, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig, Y,
                       L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand, B, m, n,
                       n_inner, stream, nullptr);
}

int pdhg_halpern_cluster_f64(int C, int R, const void* K, const void* q,
                             int q_per_row, const void* lb, const void* ub,
                             const void* is_eq, const void* ht,
                             const void* tau, const void* sig, const void* Y,
                             const void* L, const void* kh, const void* Yanc,
                             const void* Lanc, void* Yout, void* Lout,
                             void* Ycand, void* Lcand, int B, int m, int n,
                             int n_inner, void* stream) {
  return launch<double>(C, R, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                        Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand, B, m,
                        n, n_inner, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters for that launch (B rows, shared q), into
// *out; nothing is launched
int pdhg_halpern_cluster_occupancy(int f64, int C, int R, int B, int m,
                                   int n, int* out) {
  const void* p = nullptr;
  return f64 ? launch<double>(C, R, p, p, 0, p, p, p, p, p, p, p, p, p, p, p,
                              nullptr, nullptr, nullptr, nullptr, B, m, n, 1,
                              nullptr, out)
             : launch<float>(C, R, p, p, 0, p, p, p, p, p, p, p, p, p, p, p,
                             nullptr, nullptr, nullptr, nullptr, B, m, n, 1,
                             nullptr, out);
}

}  // extern "C"
