// Restart-to-average PDHG round for large batches: tiles of batch rows, K
// resident in a thread-block cluster's shared memory (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas (body
// _kernel) in its large-panel regime (the Monte-Carlo panel's large rungs
// under scheme="average"); pdhg_average_cluster.cu keeps the small panels
// and pdhg_average_round.cu what neither takes. It computes exactly what
// ops/cuda/pdhg_kernel.py:pdhg_average_round_ref computes.
//
// What bounds the row-block kernel there is what bounds the Halpern one
// (pdhg_halpern_tile.cu): 4 rows per block, K twice per step from L2,
// scalar FMAs. pdhg_tile.cuh keeps K's column slices in a cluster's shared
// memory and runs the products as FP64 mma.sync instructions on 16-row
// tiles in float64 and as FP32 FMAs in float32 on tiles as short as the
// panel's passes allow; what bounds it now is what bounds the Halpern
// round (pdhg_halpern_tile.cu), and that header says how. This
// file instantiates it for the average scheme: the anchor buffers hold
// the running sums (Y's with the CTA that owns the column, L's with the
// CTA that owns the constraint row), divided by n_inner in the last step's
// epilogue (a true division).

#include "pdhg_tile.cuh"

namespace {

using pdhg_tile::Args;

template <typename T>
int run(int C, int nclusters, int tm, const void* K, const void* q,
        int q_per_row, const void* lb, const void* ub, const void* is_eq,
        const void* ht, const void* tau, const void* sig, const void* Y,
        const void* L, void* Yout, void* Lout, void* Yavg, void* Lavg, int B,
        int m, int n, int n_inner, void* stream) {
  const Args a = {K,   q,  q_per_row, lb,      ub,      is_eq,   ht,   tau,
                  sig, Y,  L,         nullptr, nullptr, nullptr, Yout, Lout,
                  Yavg, Lavg, B,      m,       n,       n_inner, stream};
  return pdhg_tile::launch<T, true>(C, nclusters, tm, a, nullptr);
}

}  // namespace

extern "C" {

// one round on nclusters persistent clusters of C CTAs walking tiles of
// tm rows (float64: 16); returns cudaError_t
int pdhg_average_tile_f32(int C, int nclusters, int tm,
                          const void* K,
                          const void* q, int q_per_row, const void* lb,
                          const void* ub, const void* is_eq, const void* ht,
                          const void* tau, const void* sig, const void* Y,
                          const void* L, void* Yout, void* Lout, void* Yavg,
                          void* Lavg, int B, int m, int n, int n_inner,
                          void* stream) {
  return run<float>(C, nclusters, tm, K, q, q_per_row, lb, ub, is_eq, ht,
                    tau, sig, Y, L, Yout, Lout, Yavg, Lavg, B, m, n, n_inner,
                    stream);
}

int pdhg_average_tile_f64(int C, int nclusters, int tm,
                          const void* K,
                          const void* q, int q_per_row, const void* lb,
                          const void* ub, const void* is_eq, const void* ht,
                          const void* tau, const void* sig, const void* Y,
                          const void* L, void* Yout, void* Lout, void* Yavg,
                          void* Lavg, int B, int m, int n, int n_inner,
                          void* stream) {
  return run<double>(C, nclusters, tm, K, q, q_per_row, lb, ub, is_eq, ht,
                     tau, sig, Y, L, Yout, Lout, Yavg, Lavg, B, m, n,
                     n_inner, stream);
}

// cudaOccupancyMaxActiveClusters for that launch, into *out; nothing is
// launched
int pdhg_average_tile_occupancy(int f64, int C, int m, int n,
                                int* out) {
  return pdhg_tile::occupancy<true>(f64, C, m, n, out);
}

}  // extern "C"
