// Restart-to-average PDHG round for a K that fits one block's shared
// memory (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas (body
// _kernel) for a K under 128 KB (lands, transship, baa99-20 and the toy
// instances) at every panel size the plan gives it. It computes exactly
// what ops/cuda/pdhg_kernel.py:pdhg_average_round_ref computes, bit for
// bit what pdhg_average_round.cu computes.
//
// pdhg_small.cuh holds the design. This file instantiates it for the
// average scheme: the anchor slots hold the running sums, divided by
// n_inner in the last step's epilogues (a true division).

#include "pdhg_small.cuh"

extern "C" {

// one round; operands as for pdhg_halpern_small_f32 without the Halpern
// step count and anchors; returns cudaError_t
#define PDHG_AVERAGE_SMALL(SUFFIX, T)                                        \
  int pdhg_average_small_##SUFFIX(                                          \
      int W, int R, int G, const void* K, const void* q, int q_per_row,     \
      const void* lb, const void* ub, const void* is_eq, const void* ht,    \
      const void* tau, const void* sig, const void* Y, const void* L,       \
      void* Yout, void* Lout, void* Yavg, void* Lavg, int B, int m, int n,  \
      int n_inner, void* stream) {                                          \
    const pdhg::RoundArgs a = {K,       q,       q_per_row, lb,   ub,       \
                               is_eq,   ht,      tau,       sig,  Y,        \
                               L,       nullptr, nullptr,   nullptr, Yout,  \
                               Lout,    Yavg,    Lavg,      B,    m,        \
                               n,       n_inner, stream};                   \
    return pdhg_small::launch<T, true>(W, R, G, a);                         \
  }

PDHG_AVERAGE_SMALL(f32, float)
PDHG_AVERAGE_SMALL(f64, double)

}  // extern "C"
