// Reflected-Halpern PDHG round for a K that fits one block's shared
// memory (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas_halpern
// (body _kernel_halpern) for a K under 128 KB (lands, transship,
// baa99-20 and the toy instances) at every panel size the plan gives it.
// It computes exactly what ops/cuda/pdhg_kernel.py:pdhg_halpern_round_ref
// computes, bit for bit what pdhg_halpern_round.cu computes.
//
// What held the row-block kernel back there, and the design that answers
// it (K resident in shared memory, groups of W warps carrying R rows that
// sync only with each other, the dual sums reduce-scattered over the
// lanes), are in pdhg_small.cuh. This file instantiates it for the Halpern
// scheme.

#include "pdhg_small.cuh"

extern "C" {

// one round: groups of W warps carrying R batch rows, G groups a block;
// returns cudaError_t (cudaErrorInvalidValue for a (W, R, G) the kernel
// does not take at these shapes)
#define PDHG_HALPERN_SMALL(SUFFIX, T)                                        \
  int pdhg_halpern_small_##SUFFIX(                                          \
      int W, int R, int G, const void* K, const void* q, int q_per_row,     \
      const void* lb, const void* ub, const void* is_eq, const void* ht,    \
      const void* tau, const void* sig, const void* Y, const void* L,       \
      const void* kh, const void* Yanc, const void* Lanc, void* Yout,       \
      void* Lout, void* Ycand, void* Lcand, int B, int m, int n,            \
      int n_inner, void* stream) {                                          \
    const pdhg::RoundArgs a = {K,    q,    q_per_row, lb,   ub,    is_eq,   \
                               ht,   tau,  sig,       Y,    L,     kh,      \
                               Yanc, Lanc, Yout,      Lout, Ycand, Lcand,   \
                               B,    m,    n,         n_inner, stream};     \
    return pdhg_small::launch<T, false>(W, R, G, a);                        \
  }

PDHG_HALPERN_SMALL(f32, float)
PDHG_HALPERN_SMALL(f64, double)

// dynamic shared memory of a block of G groups of R rows, in bytes
// (ops/cuda/pdhg_kernel.py:_small_smem mirrors it; the same under either
// scheme)
long long pdhg_small_smem(int R, int G, int m, int n, int itemsize,
                          int q_per_row) {
  return static_cast<long long>(
      pdhg_small::smem_bytes(R, G, m, n, itemsize, q_per_row));
}

}  // extern "C"
