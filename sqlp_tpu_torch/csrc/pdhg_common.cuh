// Device code shared by the PDHG round kernels (Hopper, sm_90a). clip and
// RoundArgs serve every variant, the pinned roundings below every variant
// that keeps the row-block kernels' bits; the two products below are the
// row-block kernels' (pdhg_halpern_round.cu and pdhg_average_round.cu).
//
// Both row-block kernels keep a block's batch rows in shared memory, ROWS rows at a
// fixed stride, and read K from L2. The two products of a PDHG step are
// written once here so that both schemes reduce in the same order:
//
//   col_products: acc[r] = sum_i L_r[i] K[i, j]   (thread per column j,
//                 coalesced over j; the G = q - L K product)
//   row_products: acc[r] = sum_j K[i, j] v_r[j]   (warp per row i, lanes
//                 over j, shuffle reduction; the S = ht - Yb K^T product)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pdhg {

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

// L_r lives at Ls + r * stride (r < ROWS); K is [m, n] row-major
template <typename T, int ROWS>
__device__ __forceinline__ void col_products(const T* __restrict__ K,
                                             const T* Ls, int stride, int m,
                                             int n, int j, T (&acc)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = T(0);
#pragma unroll 8
  for (int i = 0; i < m; ++i) {
    const T kij = K[static_cast<size_t>(i) * n + j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] += Ls[r * stride + i] * kij;
  }
}

// v_r lives at vs + r * stride; Ki is row i of K; after the shuffle
// reduction lane 0 holds the sums
template <typename T, int ROWS>
__device__ __forceinline__ void row_products(const T* __restrict__ Ki,
                                             const T* vs, int stride, int n,
                                             int lane, T (&acc)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = T(0);
#pragma unroll 4
  for (int j = lane; j < n; j += 32) {
    const T kij = Ki[j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] += kij * vs[r * stride + j];
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = warp_sum(acc[r]);
}

// The epilogues' roundings, pinned. They are the ones nvcc's contraction
// gives the row-block kernels' expressions (cuobjdump -sass of
// pdhg_halpern_round.cu and pdhg_average_round.cu, float32 and float64,
// every ROWS): y - tau (q - g) as fma(-tau, q - g, y); 2 y1 - y as
// (y1 + y1) - y, which equals 2 y1 - y rounded; l + sig (h - s) as
// fma(sig, h - s, l); the Halpern blend w x + (1 - w) y as
// fma(1 - w, y, w x) with w x rounded; w = (k + 1) / (k + 2), k = kh + t,
// an IEEE division; the products' FMA chains start from +0. Kernels that
// keep the row-block kernels' bits use these, so their roundings do not
// move with the code around them.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
// w x + (1 - w) y
template <typename T>
__device__ __forceinline__ T blend(T w, T x, T y) {
  return fma_rn(sub_rn(T(1), w), y, mul_rn(w, x));
}
// the Halpern weight w = (k + 1) / (k + 2), k = kh + t
template <typename T>
__device__ __forceinline__ T halpern_w(T kh, int t) {
  const T k = add_rn(kh, static_cast<T>(t));
  return div_rn(add_rn(k, T(1)), add_rn(k, T(2)));
}
// the primal step's Y1 = clip(y - tau (q - g), lo, hi)
template <typename T>
__device__ __forceinline__ T primal_y1(T y, T tau, T q, T g, T lo, T hi) {
  return clip(fma_rn(-tau, sub_rn(q, g), y), lo, hi);
}
// the reflection 2 a - b
template <typename T>
__device__ __forceinline__ T reflect(T a, T b) {
  return sub_rn(add_rn(a, a), b);
}
// the dual step's projected L1 = L + sig (h - s): '==' rows free, others
// >= 0 (NaN kept)
template <typename T>
__device__ __forceinline__ T dual_l1(T l, T sig, T h, T s, bool eq) {
  const T lr = fma_rn(sig, sub_rn(h, s), l);
  return (eq || !(lr < T(0))) ? lr : T(0);
}

// the operands of one round, as the C interfaces of the cluster and tile
// kernels pass them to their launchers. Halpern: aux = (kh, Yanc, Lanc),
// out = (Ycarry, Lcarry, Ycand, Lcand); average: aux null, out = (Y, L,
// Yavg, Lavg)
struct RoundArgs {
  const void *K, *q;
  int q_per_row;
  const void *lb, *ub, *is_eq, *ht, *tau, *sig, *Y, *L, *kh, *Yanc, *Lanc;
  void *Yout, *Lout, *Yout2, *Lout2;
  int B, m, n, n_inner;
  void* stream;
};

}  // namespace pdhg
