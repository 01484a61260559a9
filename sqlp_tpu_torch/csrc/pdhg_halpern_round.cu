// Reflected-Halpern PDHG round for a batch of recourse LPs (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas_halpern
// (body _kernel_halpern). One launch runs n_inner PDHG steps for every
// batch row; per row and step
//
//   G  = q - L K                      (column reduction over the m rows)
//   Y1 = clip(Y - tau G, lb, ub)
//   Yb = 2 Y1 - Y
//   S  = ht - Yb K^T                  (row reduction over the n columns)
//   L1 = L + sig S, projected ('==' rows free, others >= 0)
//   k  = kh + t,  w = (k + 1) / (k + 2)
//   Y <- w Yb + (1 - w) Yanc,  L <- w (2 L1 - L) + (1 - w) Lanc
//
// and the round returns the carry (Y, L) and the candidate T(z) = (Y1, L1)
// of the last step.
//
// What bounds it on this card: every step reads K twice (2 m n elements:
// 0.96 MB for ssn in f32, 5.3 MB for storm) against 4 m n flops per row.
// K stays resident in the 50 MB L2, so the limit is the L2 bandwidth an SM
// can draw, divided over the rows a block carries. The design: the whole
// n_inner loop runs inside one launch; a block carries ROWS batch rows
// whose iterates, anchors, candidates and right-hand side live in shared
// memory; each K element read from L2 serves all ROWS rows. The G product
// is coalesced with threads over columns; the S product gives a warp per
// constraint row and ends in a shuffle reduction. Plain FMA in the working
// type (the TPU's bf16x3 split is a matrix-unit workaround with no role
// here). The SD step's panel (B = 2) occupies two SMs: latency, not
// throughput, bounds that regime: each thread then has few
// independent L2 loads in flight, so the reduction loops are unrolled to
// raise memory-level parallelism.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// clip that keeps NaN, as jnp.clip does
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
pdhg_halpern_kernel(const T* __restrict__ K, const T* __restrict__ q,
                    int q_per_row, const T* __restrict__ lb,
                    const T* __restrict__ ub,
                    const uint8_t* __restrict__ is_eq,
                    const T* __restrict__ ht, const T* __restrict__ tau,
                    const T* __restrict__ sig, const T* __restrict__ Y0,
                    const T* __restrict__ L0, const T* __restrict__ kh,
                    const T* __restrict__ Yanc, const T* __restrict__ Lanc,
                    T* __restrict__ Yout, T* __restrict__ Lout,
                    T* __restrict__ Ycand, T* __restrict__ Lcand, int B,
                    int m, int n, int n_inner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  // per-row layout: Y[n] Ya[n] Yc[n] Yb[n] L[m] La[m] Lc[m] h[m]
  const int stride = 4 * n + 4 * m;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - row0);
  const int tid = threadIdx.x;

  for (int r = 0; r < nrows; ++r) {
    T* s = smem + r * stride;
    const size_t bn = static_cast<size_t>(row0 + r) * n;
    const size_t bm = static_cast<size_t>(row0 + r) * m;
    for (int j = tid; j < n; j += kThreads) {
      s[j] = Y0[bn + j];
      s[n + j] = Yanc[bn + j];
      s[2 * n + j] = Y0[bn + j];
    }
    for (int i = tid; i < m; i += kThreads) {
      s[4 * n + i] = L0[bm + i];
      s[4 * n + m + i] = Lanc[bm + i];
      s[4 * n + 2 * m + i] = L0[bm + i];
      s[4 * n + 3 * m + i] = ht[bm + i];
    }
  }
  T tau_r[ROWS], sig_r[ROWS], kh_r[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool ok = r < nrows;
    tau_r[r] = ok ? tau[row0 + r] : T(0);
    sig_r[r] = ok ? sig[row0 + r] : T(0);
    kh_r[r] = ok ? kh[row0 + r] : T(0);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int t = 0; t < n_inner; ++t) {
    // primal step: threads over columns, G = q - L K
    for (int j = tid; j < n; j += kThreads) {
      T acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = T(0);
#pragma unroll 8
      for (int i = 0; i < m; ++i) {
        const T kij = K[static_cast<size_t>(i) * n + j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] += smem[r * stride + 4 * n + i] * kij;
      }
      const T lo = lb[j];
      const T hi = ub[j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
          T* s = smem + r * stride;
          const T qj = q_per_row
              ? q[static_cast<size_t>(row0 + r) * n + j] : q[j];
          const T y = s[j];
          const T y1 = clip(y - tau_r[r] * (qj - acc[r]), lo, hi);
          const T yb = T(2) * y1 - y;
          const T k = kh_r[r] + T(t);
          const T w = (k + T(1)) / (k + T(2));
          s[2 * n + j] = y1;
          s[3 * n + j] = yb;
          s[j] = w * yb + (T(1) - w) * s[n + j];
        }
      }
    }
    __syncthreads();
    // dual step: a warp per constraint row, S = ht - Yb K^T
    for (int i = warp; i < m; i += kWarps) {
      const T* Ki = K + static_cast<size_t>(i) * n;
      T acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = T(0);
#pragma unroll 4
      for (int j = lane; j < n; j += 32) {
        const T kij = Ki[j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] += kij * smem[r * stride + 3 * n + j];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0) {
        const bool eq = is_eq[i] != 0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nrows) {
            T* s = smem + r * stride + 4 * n;
            const T l = s[i];
            const T lr = l + sig_r[r] * (s[3 * m + i] - acc[r]);
            const T l1 = (eq || !(lr < T(0))) ? lr : T(0);
            const T k = kh_r[r] + T(t);
            const T w = (k + T(1)) / (k + T(2));
            s[2 * m + i] = l1;
            s[i] = w * (T(2) * l1 - l) + (T(1) - w) * s[m + i];
          }
        }
      }
    }
    __syncthreads();
  }

  for (int r = 0; r < nrows; ++r) {
    const T* s = smem + r * stride;
    const size_t bn = static_cast<size_t>(row0 + r) * n;
    const size_t bm = static_cast<size_t>(row0 + r) * m;
    for (int j = tid; j < n; j += kThreads) {
      Yout[bn + j] = s[j];
      Ycand[bn + j] = s[2 * n + j];
    }
    for (int i = tid; i < m; i += kThreads) {
      Lout[bm + i] = s[4 * n + i];
      Lcand[bm + i] = s[4 * n + 2 * m + i];
    }
  }
}

template <typename T, int ROWS>
int launch_rows(const void* K, const void* q, int q_per_row, const void* lb,
                const void* ub, const void* is_eq, const void* ht,
                const void* tau, const void* sig, const void* Y,
                const void* L, const void* kh, const void* Yanc,
                const void* Lanc, void* Yout, void* Lout, void* Ycand,
                void* Lcand, int B, int m, int n, int n_inner,
                void* stream) {
  const size_t smem = static_cast<size_t>(ROWS) * (4 * n + 4 * m) * sizeof(T);
  auto kernel = pdhg_halpern_kernel<T, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + ROWS - 1) / ROWS;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(K), static_cast<const T*>(q), q_per_row,
      static_cast<const T*>(lb), static_cast<const T*>(ub),
      static_cast<const uint8_t*>(is_eq), static_cast<const T*>(ht),
      static_cast<const T*>(tau), static_cast<const T*>(sig),
      static_cast<const T*>(Y), static_cast<const T*>(L),
      static_cast<const T*>(kh), static_cast<const T*>(Yanc),
      static_cast<const T*>(Lanc), static_cast<T*>(Yout),
      static_cast<T*>(Lout), static_cast<T*>(Ycand), static_cast<T*>(Lcand),
      B, m, n, n_inner);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int rows, const void* K, const void* q, int q_per_row,
           const void* lb, const void* ub, const void* is_eq, const void* ht,
           const void* tau, const void* sig, const void* Y, const void* L,
           const void* kh, const void* Yanc, const void* Lanc, void* Yout,
           void* Lout, void* Ycand, void* Lcand, int B, int m, int n,
           int n_inner, void* stream) {
  switch (rows) {
    case 1:
      return launch_rows<T, 1>(K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                               Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand,
                               Lcand, B, m, n, n_inner, stream);
    case 2:
      return launch_rows<T, 2>(K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                               Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand,
                               Lcand, B, m, n, n_inner, stream);
    case 4:
      return launch_rows<T, 4>(K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                               Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand,
                               Lcand, B, m, n, n_inner, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int pdhg_halpern_round_f32(int rows, const void* K, const void* q,
                           int q_per_row, const void* lb, const void* ub,
                           const void* is_eq, const void* ht,
                           const void* tau, const void* sig, const void* Y,
                           const void* L, const void* kh, const void* Yanc,
                           const void* Lanc, void* Yout, void* Lout,
                           void* Ycand, void* Lcand, int B, int m, int n,
                           int n_inner, void* stream) {
  return launch<float>(rows, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig, Y,
                       L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand, B, m, n,
                       n_inner, stream);
}

int pdhg_halpern_round_f64(int rows, const void* K, const void* q,
                           int q_per_row, const void* lb, const void* ub,
                           const void* is_eq, const void* ht,
                           const void* tau, const void* sig, const void* Y,
                           const void* L, const void* kh, const void* Yanc,
                           const void* Lanc, void* Yout, void* Lout,
                           void* Ycand, void* Lcand, int B, int m, int n,
                           int n_inner, void* stream) {
  return launch<double>(rows, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                        Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand, B, m,
                        n, n_inner, stream);
}

}  // extern "C"
