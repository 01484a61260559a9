// Reflected-Halpern PDHG round for small batches on a thread-block cluster
// with K resident in its shared memory (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas_halpern
// (body _kernel_halpern) in its small-panel regime (the SD step's B = 2
// panel and the short tails of the MC ladder); pdhg_halpern_tile.cu takes
// the large panels and pdhg_halpern_round.cu what neither takes. It
// computes exactly what ops/cuda/pdhg_kernel.py:pdhg_halpern_round_ref
// computes.
//
// What bounds the row-block kernel there: at B = 2 it runs two blocks, each
// re-reading K (482 KB for ssn in f32) from L2 twice per step through one
// SM, so a round is bound by one SM's L2 bandwidth. The TPU kernel kept K
// in VMEM for the whole round; pdhg_cluster.cuh does the same with a
// cluster of C CTAs and says how. This file instantiates it for the
// Halpern scheme.

#include "pdhg_cluster.cuh"

namespace {

using pdhg_cluster::Args;

template <typename T>
int run(int C, int R, const void* K, const void* q, int q_per_row,
        const void* lb, const void* ub, const void* is_eq, const void* ht,
        const void* tau, const void* sig, const void* Y, const void* L,
        const void* kh, const void* Yanc, const void* Lanc, void* Yout,
        void* Lout, void* Ycand, void* Lcand, int B, int m, int n,
        int n_inner, void* stream) {
  const Args a = {K,   q,  q_per_row, lb,   ub,   is_eq, ht,   tau,
                  sig, Y,  L,         kh,   Yanc, Lanc,  Yout, Lout,
                  Ycand, Lcand, B,    m,    n,    n_inner, stream};
  return pdhg_cluster::launch<T, false>(C, R, a, nullptr);
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
  return run<float>(C, R, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig, Y, L,
                    kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand, B, m, n,
                    n_inner, stream);
}

int pdhg_halpern_cluster_f64(int C, int R, const void* K, const void* q,
                             int q_per_row, const void* lb, const void* ub,
                             const void* is_eq, const void* ht,
                             const void* tau, const void* sig, const void* Y,
                             const void* L, const void* kh, const void* Yanc,
                             const void* Lanc, void* Yout, void* Lout,
                             void* Ycand, void* Lcand, int B, int m, int n,
                             int n_inner, void* stream) {
  return run<double>(C, R, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig, Y,
                     L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand, B, m, n,
                     n_inner, stream);
}

// cudaOccupancyMaxActiveClusters for that launch (B rows, shared q), into
// *out; nothing is launched
int pdhg_halpern_cluster_occupancy(int f64, int C, int R, int B, int m,
                                   int n, int* out) {
  return pdhg_cluster::occupancy<false>(f64, C, R, B, m, n, out);
}

}  // extern "C"
