// ADMM check interval of the SD master QP (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/admm_kernel.py, admm_round_pallas (body
// _kernel). One launch runs n_inner OSQP-style ADMM steps on the scaled
// master of every QP in the batch; per step
//
//   rhs  = sigma z - g + As^T (rho zeta - mu)
//   x    = Minv rhs;  x += Minv (rhs - M x)      (one refinement step)
//   v    = alpha As x + (1 - alpha) zeta
//   zeta = clip(v + mu / rho, l, u)
//   mu  += rho (v - zeta),  z = x
//
// What bounds it on this card: the master is tiny (ssn nz = 90, mA = 187;
// storm nz = 122, mA = 403 at K = 96) and its steps are strictly
// sequential, so a step is a chain of six dependent mat-vec products whose
// cost is latency: L2 reads of As, M and Minv and the block barriers
// between the products. The design: one thread block per QP (a leading
// batch axis lets replications run R masters in one launch), the vectors
// z, x, rhs, the residual, zeta, mu and rho zeta - mu in shared memory,
// all n_inner steps inside the launch. As^T w is a column reduction
// (threads over the nz columns, coalesced); As x and the two symmetric
// nz x nz products are row reductions (a warp per row, shuffle sums), so
// every product reads its matrix row-major as the plain version does. In
// f64 the three matrices of the ssn master take about 265 KB, more than a
// block's shared memory, so they are read from L2; keeping them resident
// is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// out[j] = sum_k A[j, k] v[k], a warp per row j
template <typename T>
__device__ __forceinline__ void rowdot(const T* __restrict__ A,
                                       const T* v, T* out, int rows,
                                       int cols, int warp, int lane) {
  for (int j = warp; j < rows; j += kWarps) {
    const T* Aj = A + static_cast<size_t>(j) * cols;
    T acc = T(0);
#pragma unroll 4
    for (int k = lane; k < cols; k += 32) acc += Aj[k] * v[k];
    acc = warp_sum(acc);
    if (lane == 0) out[j] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
admm_kernel(const T* __restrict__ As, const T* __restrict__ M,
            const T* __restrict__ Minv, const T* __restrict__ g,
            const T* __restrict__ lc, const T* __restrict__ uc,
            const T* __restrict__ rho, const T* __restrict__ z0,
            const T* __restrict__ zeta0, const T* __restrict__ mu0,
            T* __restrict__ zout, T* __restrict__ zetaout,
            T* __restrict__ muout, int mA, int nz, int n_inner, T alpha,
            T sigma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* z = reinterpret_cast<T*>(smem_raw);
  T* x = z + nz;
  T* rhs = x + nz;
  T* res = rhs + nz;
  T* zeta = res + nz;
  T* mu = zeta + mA;
  T* w = mu + mA;

  const int b = blockIdx.x;
  As += static_cast<size_t>(b) * mA * nz;
  M += static_cast<size_t>(b) * nz * nz;
  Minv += static_cast<size_t>(b) * nz * nz;
  g += static_cast<size_t>(b) * nz;
  lc += static_cast<size_t>(b) * mA;
  uc += static_cast<size_t>(b) * mA;
  rho += static_cast<size_t>(b) * mA;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int j = tid; j < nz; j += kThreads) z[j] = z0[b * nz + j];
  for (int i = tid; i < mA; i += kThreads) {
    zeta[i] = zeta0[b * mA + i];
    mu[i] = mu0[b * mA + i];
  }
  __syncthreads();

  for (int t = 0; t < n_inner; ++t) {
    for (int i = tid; i < mA; i += kThreads) w[i] = rho[i] * zeta[i] - mu[i];
    __syncthreads();
    // rhs = sigma z - g + As^T w: threads over columns
    for (int j = tid; j < nz; j += kThreads) {
      T acc = T(0);
#pragma unroll 8
      for (int i = 0; i < mA; ++i)
        acc += As[static_cast<size_t>(i) * nz + j] * w[i];
      rhs[j] = sigma * z[j] - g[j] + acc;
    }
    __syncthreads();
    rowdot(Minv, rhs, x, nz, nz, warp, lane);           // x = Minv rhs
    __syncthreads();
    rowdot(M, x, res, nz, nz, warp, lane);              // res = M x
    __syncthreads();
    for (int j = tid; j < nz; j += kThreads) res[j] = rhs[j] - res[j];
    __syncthreads();
    rowdot(Minv, res, z, nz, nz, warp, lane);           // z = Minv res
    __syncthreads();
    for (int j = tid; j < nz; j += kThreads) x[j] = x[j] + z[j];
    __syncthreads();
    // As x, a warp per row, then the zeta / mu updates of that row
    for (int i = warp; i < mA; i += kWarps) {
      const T* Ai = As + static_cast<size_t>(i) * nz;
      T acc = T(0);
      for (int k = lane; k < nz; k += 32) acc += Ai[k] * x[k];
      acc = warp_sum(acc);
      if (lane == 0) {
        const T v = alpha * acc + (T(1) - alpha) * zeta[i];
        const T r = rho[i];
        const T c = v + mu[i] / r;
        const T lo = lc[i];
        const T hi = uc[i];
        const T z1 = c < lo ? lo : (c > hi ? hi : c);
        zeta[i] = z1;
        mu[i] = mu[i] + r * (v - z1);
      }
    }
    for (int j = tid; j < nz; j += kThreads) z[j] = x[j];
    __syncthreads();
  }

  for (int j = tid; j < nz; j += kThreads) zout[b * nz + j] = z[j];
  for (int i = tid; i < mA; i += kThreads) {
    zetaout[b * mA + i] = zeta[i];
    muout[b * mA + i] = mu[i];
  }
}

template <typename T>
int launch(const void* As, const void* M, const void* Minv, const void* g,
           const void* lc, const void* uc, const void* rho, const void* z,
           const void* zeta, const void* mu, void* zout, void* zetaout,
           void* muout, int nb, int mA, int nz, int n_inner, double alpha,
           double sigma, void* stream) {
  const size_t smem = static_cast<size_t>(4 * nz + 3 * mA) * sizeof(T);
  auto kernel = admm_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(As), static_cast<const T*>(M),
      static_cast<const T*>(Minv), static_cast<const T*>(g),
      static_cast<const T*>(lc), static_cast<const T*>(uc),
      static_cast<const T*>(rho), static_cast<const T*>(z),
      static_cast<const T*>(zeta), static_cast<const T*>(mu),
      static_cast<T*>(zout), static_cast<T*>(zetaout),
      static_cast<T*>(muout), mA, nz, n_inner, static_cast<T>(alpha),
      static_cast<T>(sigma));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int admm_round_f32(const void* As, const void* M, const void* Minv,
                   const void* g, const void* lc, const void* uc,
                   const void* rho, const void* z, const void* zeta,
                   const void* mu, void* zout, void* zetaout, void* muout,
                   int nb, int mA, int nz, int n_inner, double alpha,
                   double sigma, void* stream) {
  return launch<float>(As, M, Minv, g, lc, uc, rho, z, zeta, mu, zout,
                       zetaout, muout, nb, mA, nz, n_inner, alpha, sigma,
                       stream);
}

int admm_round_f64(const void* As, const void* M, const void* Minv,
                   const void* g, const void* lc, const void* uc,
                   const void* rho, const void* z, const void* zeta,
                   const void* mu, void* zout, void* zetaout, void* muout,
                   int nb, int mA, int nz, int n_inner, double alpha,
                   double sigma, void* stream) {
  return launch<double>(As, M, Minv, g, lc, uc, rho, z, zeta, mu, zout,
                        zetaout, muout, nb, mA, nz, n_inner, alpha, sigma,
                        stream);
}

}  // extern "C"
