// Restart-to-average PDHG round as grid-wide product phases, for float32
// panels of a K that fits no cluster (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas (body
// _kernel) where K is too large for the cluster and tile variants and the
// float32 panel too large for the cluster variant (storm under
// scheme="average" from 85 rows). It computes exactly what
// ops/cuda/pdhg_kernel.py:pdhg_average_round_ref computes, bit for bit
// what pdhg_average_round.cu computes.
//
// What bounds the row-block kernel there is what bounds the Halpern one
// (pdhg_halpern_grid.cu). pdhg_grid.cuh says how the grid phases answer
// it. This file instantiates it for the average scheme: the second output
// buffers hold the running sums, divided by n_inner in the last step's
// epilogues (a true division).

#include "pdhg_grid.cuh"

extern "C" {

// one round at primal tiles of BM rows in at most P parts; operands and
// scratch as for pdhg_halpern_grid_f32, without the Halpern step count
// and anchors; returns cudaError_t
int pdhg_average_grid_f32(int BM, int P, int ldk, int mK, const void* Kr,
                          void* Ls, void* Ybr, const void* K, const void* q,
                          int q_per_row, const void* lb, const void* ub,
                          const void* is_eq, const void* ht, const void* tau,
                          const void* sig, const void* Y, const void* L,
                          void* Yout, void* Lout, void* Yavg, void* Lavg,
                          int B, int m, int n, int n_inner, void* stream) {
  const pdhg::RoundArgs a = {K,       q,    q_per_row, lb,   ub,   is_eq,
                             ht,      tau,  sig,       Y,    L,    nullptr,
                             nullptr, nullptr, Yout,   Lout, Yavg, Lavg,
                             B,       m,    n,         n_inner, stream};
  return pdhg_grid::launch<true>(BM, P, ldk, mK, Kr, Ls, Ybr, a);
}

}  // extern "C"
