// Restart-to-average PDHG round for a batch of recourse LPs (Hopper,
// sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas (body
// _kernel). One launch runs n_inner plain PDHG steps for every batch row;
// per row and step
//
//   G  = q - L K                      (column reduction over the m rows)
//   Y1 = clip(Y - tau G, lb, ub)
//   S  = ht - (2 Y1 - Y) K^T          (row reduction over the n columns)
//   L1 = L + sig S, projected ('==' rows free, others >= 0)
//   Y <- Y1, L <- L1, Ysum += Y1, Lsum += L1
//
// and the round returns the last iterate (Y, L) and the running average
// (Ysum / n_inner, Lsum / n_inner). The average is a true division by
// n_inner, as the XLA loop's division by its step count
// (sqlp_tpu/ops/pdhg.py:340) and the plain version are; the TPU kernel
// multiplies by 1 / n_inner, which rounds differently.
//
// What bounds it on this card: the same as the Halpern round
// (pdhg_halpern_round.cu). Every step reads K twice (2 m n elements: 0.96
// MB for ssn in f32, 5.3 MB for storm) against 4 m n flops per row; K stays
// in the 50 MB L2, so the limit is the L2 bandwidth an SM can draw,
// divided over the rows a block carries. The design is B1's: the whole
// n_inner loop is one launch; a block carries ROWS batch rows whose
// iterate, reflected primal, running sums and right-hand side live in
// shared memory (3 n + 3 m values a row, against B1's 4 n + 4 m: there is
// no anchor and no separate candidate); each K element read from L2 serves
// all ROWS rows. The two products are B1's (pdhg_common.cuh), so both
// schemes reduce in the same order. The ragged last block is masked.
//
// Where the plan sends it (ops/cuda/pdhg_kernel.py:_plan): a K small enough
// for L1 (lands), and storm's float64 panels past 256 rows (the stream
// variant takes them up to 256 rows); storm's float32 panels past the
// cluster variant's go to the grid variant (pdhg_average_grid.cu).
//
// The launch bounds ask for two resident blocks, which caps a thread at 64
// registers. With the thread count alone ptxas built the f32 one-row
// instance with 32 registers and a spill, and the round ran 1.8x slower
// (ssn, B = 2: 4.07 against 2.21 ms on an H100 SXM at 700 W); the bound
// gives 56 registers, no spill, and no loss at B = 4096.

#include "pdhg_common.cuh"

namespace {

using pdhg::clip;
using pdhg::col_products;
using pdhg::kThreads;
using pdhg::kWarps;
using pdhg::row_products;

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads, 2)
pdhg_average_kernel(const T* __restrict__ K, const T* __restrict__ q,
                    int q_per_row, const T* __restrict__ lb,
                    const T* __restrict__ ub,
                    const uint8_t* __restrict__ is_eq,
                    const T* __restrict__ ht, const T* __restrict__ tau,
                    const T* __restrict__ sig, const T* __restrict__ Y0,
                    const T* __restrict__ L0, T* __restrict__ Yout,
                    T* __restrict__ Lout, T* __restrict__ Yavg,
                    T* __restrict__ Lavg, int B, int m, int n,
                    int n_inner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  // per-row layout: Y[n] Yb[n] Ysum[n] L[m] Lsum[m] h[m]
  const int stride = 3 * n + 3 * m;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - row0);
  const int tid = threadIdx.x;

  for (int r = 0; r < nrows; ++r) {
    T* s = smem + r * stride;
    const size_t bn = static_cast<size_t>(row0 + r) * n;
    const size_t bm = static_cast<size_t>(row0 + r) * m;
    for (int j = tid; j < n; j += kThreads) {
      s[j] = Y0[bn + j];
      s[n + j] = T(0);
      s[2 * n + j] = T(0);
    }
    for (int i = tid; i < m; i += kThreads) {
      s[3 * n + i] = L0[bm + i];
      s[3 * n + m + i] = T(0);
      s[3 * n + 2 * m + i] = ht[bm + i];
    }
  }
  T tau_r[ROWS], sig_r[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool ok = r < nrows;
    tau_r[r] = ok ? tau[row0 + r] : T(0);
    sig_r[r] = ok ? sig[row0 + r] : T(0);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int t = 0; t < n_inner; ++t) {
    // primal step: threads over columns, G = q - L K
    for (int j = tid; j < n; j += kThreads) {
      T acc[ROWS];
      col_products<T, ROWS>(K, smem + 3 * n, stride, m, n, j, acc);
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
          s[n + j] = T(2) * y1 - y;
          s[j] = y1;
          s[2 * n + j] += y1;
        }
      }
    }
    __syncthreads();
    // dual step: a warp per constraint row, S = ht - (2 Y1 - Y) K^T
    for (int i = warp; i < m; i += kWarps) {
      T acc[ROWS];
      row_products<T, ROWS>(K + static_cast<size_t>(i) * n, smem + n,
                            stride, n, lane, acc);
      if (lane == 0) {
        const bool eq = is_eq[i] != 0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nrows) {
            T* s = smem + r * stride + 3 * n;
            const T lr = s[i] + sig_r[r] * (s[2 * m + i] - acc[r]);
            const T l1 = (eq || !(lr < T(0))) ? lr : T(0);
            s[i] = l1;
            s[m + i] += l1;
          }
        }
      }
    }
    __syncthreads();
  }

  const T cnt = static_cast<T>(n_inner);
  for (int r = 0; r < nrows; ++r) {
    const T* s = smem + r * stride;
    const size_t bn = static_cast<size_t>(row0 + r) * n;
    const size_t bm = static_cast<size_t>(row0 + r) * m;
    for (int j = tid; j < n; j += kThreads) {
      Yout[bn + j] = s[j];
      Yavg[bn + j] = s[2 * n + j] / cnt;
    }
    for (int i = tid; i < m; i += kThreads) {
      Lout[bm + i] = s[3 * n + i];
      Lavg[bm + i] = s[3 * n + m + i] / cnt;
    }
  }
}

template <typename T, int ROWS>
int launch_rows(const void* K, const void* q, int q_per_row, const void* lb,
                const void* ub, const void* is_eq, const void* ht,
                const void* tau, const void* sig, const void* Y,
                const void* L, void* Yout, void* Lout, void* Yavg,
                void* Lavg, int B, int m, int n, int n_inner, void* stream) {
  const size_t smem = static_cast<size_t>(ROWS) * (3 * n + 3 * m) * sizeof(T);
  auto kernel = pdhg_average_kernel<T, ROWS>;
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
      static_cast<T*>(Yout), static_cast<T*>(Lout), static_cast<T*>(Yavg),
      static_cast<T*>(Lavg), B, m, n, n_inner);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int rows, const void* K, const void* q, int q_per_row,
           const void* lb, const void* ub, const void* is_eq, const void* ht,
           const void* tau, const void* sig, const void* Y, const void* L,
           void* Yout, void* Lout, void* Yavg, void* Lavg, int B, int m,
           int n, int n_inner, void* stream) {
  switch (rows) {
    case 1:
      return launch_rows<T, 1>(K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                               Y, L, Yout, Lout, Yavg, Lavg, B, m, n,
                               n_inner, stream);
    case 2:
      return launch_rows<T, 2>(K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                               Y, L, Yout, Lout, Yavg, Lavg, B, m, n,
                               n_inner, stream);
    case 4:
      return launch_rows<T, 4>(K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                               Y, L, Yout, Lout, Yavg, Lavg, B, m, n,
                               n_inner, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int pdhg_average_round_f32(int rows, const void* K, const void* q,
                           int q_per_row, const void* lb, const void* ub,
                           const void* is_eq, const void* ht,
                           const void* tau, const void* sig, const void* Y,
                           const void* L, void* Yout, void* Lout,
                           void* Yavg, void* Lavg, int B, int m, int n,
                           int n_inner, void* stream) {
  return launch<float>(rows, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig, Y,
                       L, Yout, Lout, Yavg, Lavg, B, m, n, n_inner, stream);
}

int pdhg_average_round_f64(int rows, const void* K, const void* q,
                           int q_per_row, const void* lb, const void* ub,
                           const void* is_eq, const void* ht,
                           const void* tau, const void* sig, const void* Y,
                           const void* L, void* Yout, void* Lout,
                           void* Yavg, void* Lavg, int B, int m, int n,
                           int n_inner, void* stream) {
  return launch<double>(rows, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig,
                        Y, L, Yout, Lout, Yavg, Lavg, B, m, n, n_inner,
                        stream);
}

}  // extern "C"
