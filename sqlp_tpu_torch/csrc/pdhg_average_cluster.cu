// Restart-to-average PDHG round for small batches on a thread-block
// cluster with K resident in its shared memory (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas (body
// _kernel) in its small-panel regime: the replicated SD step's panel (16
// rows at 8 replications x 2) and the short tails of the MC ladder under
// scheme="average"; pdhg_average_tile.cu takes the large panels and
// pdhg_average_round.cu what neither takes. It computes exactly what
// ops/cuda/pdhg_kernel.py:pdhg_average_round_ref computes.
//
// What bounds the row-block kernel there: at 16 rows it runs 16 blocks,
// each re-reading K (482 KB for ssn in f32) from L2 twice per step through
// one SM, so a round is bound by one SM's L2 bandwidth while most of the
// card idles. pdhg_cluster.cuh keeps K's column slices in the shared
// memory of a cluster of C CTAs for the whole round and says how; this
// file instantiates it for the average scheme: no anchors and no Halpern
// weight, the running sum of Y local to the CTA that owns the column, the
// running sum of L identical in every CTA, both divided by n_inner at the
// end (a true division, as the plain version divides).

#include "pdhg_cluster.cuh"

namespace {

using pdhg_cluster::Args;

template <typename T>
int run(int C, int R, const void* K, const void* q, int q_per_row,
        const void* lb, const void* ub, const void* is_eq, const void* ht,
        const void* tau, const void* sig, const void* Y, const void* L,
        void* Yout, void* Lout, void* Yavg, void* Lavg, int B, int m, int n,
        int n_inner, void* stream) {
  const Args a = {K,   q,  q_per_row, lb,      ub,      is_eq,   ht,   tau,
                  sig, Y,  L,         nullptr, nullptr, nullptr, Yout, Lout,
                  Yavg, Lavg, B,      m,       n,       n_inner, stream};
  return pdhg_cluster::launch<T, true>(C, R, a, nullptr);
}

}  // namespace

extern "C" {

// one round on a cluster of C CTAs per R batch rows; returns cudaError_t
int pdhg_average_cluster_f32(int C, int R, const void* K, const void* q,
                             int q_per_row, const void* lb, const void* ub,
                             const void* is_eq, const void* ht,
                             const void* tau, const void* sig, const void* Y,
                             const void* L, void* Yout, void* Lout,
                             void* Yavg, void* Lavg, int B, int m, int n,
                             int n_inner, void* stream) {
  return run<float>(C, R, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig, Y, L,
                    Yout, Lout, Yavg, Lavg, B, m, n, n_inner, stream);
}

int pdhg_average_cluster_f64(int C, int R, const void* K, const void* q,
                             int q_per_row, const void* lb, const void* ub,
                             const void* is_eq, const void* ht,
                             const void* tau, const void* sig, const void* Y,
                             const void* L, void* Yout, void* Lout,
                             void* Yavg, void* Lavg, int B, int m, int n,
                             int n_inner, void* stream) {
  return run<double>(C, R, K, q, q_per_row, lb, ub, is_eq, ht, tau, sig, Y,
                     L, Yout, Lout, Yavg, Lavg, B, m, n, n_inner, stream);
}

// cudaOccupancyMaxActiveClusters for that launch (B rows, shared q), into
// *out; nothing is launched
int pdhg_average_cluster_occupancy(int f64, int C, int R, int B, int m,
                                   int n, int* out) {
  return pdhg_cluster::occupancy<true>(f64, C, R, B, m, n, out);
}

}  // extern "C"
