// Device code shared by the PDHG round kernels (Hopper, sm_90a). clip and
// RoundArgs serve every variant; the two products below are the row-block
// kernels' (pdhg_halpern_round.cu and pdhg_average_round.cu).
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
