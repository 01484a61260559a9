// Restart-to-average PDHG round for a K that fits no cluster: tiles of 16
// batch rows on a thread-block cluster, K streamed through shared memory
// every step (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas (body
// _kernel) where K is too large for the cluster and tile variants (storm
// under scheme="average"). It computes exactly what
// ops/cuda/pdhg_kernel.py:pdhg_average_round_ref computes; in float32 bit
// for bit what pdhg_average_round.cu computes.
//
// What bounds the row-block kernel there is what bounds the Halpern one
// (pdhg_halpern_stream.cu): a few rows per block, K twice a step from L2.
// pdhg_stream.cuh streams K through shared memory for tiles of 16 rows and
// says how. This file instantiates it for the average scheme: the anchor
// buffers hold the running sums (Y's with the CTA that owns the column,
// L's with the CTA that owns the constraint row), divided by n_inner in
// the last step's epilogue (a true division).

#include "pdhg_stream.cuh"

namespace {

using pdhg_stream::Args;

template <typename T>
int run(int C, int TM, int ldk, const void* K, const void* q,
        int q_per_row, const void* lb, const void* ub, const void* is_eq,
        const void* ht, const void* tau, const void* sig, const void* Y,
        const void* L, void* Yout, void* Lout, void* Yavg, void* Lavg, int B,
        int m, int n, int n_inner, void* stream) {
  const Args a = {K,   q,  q_per_row, lb,      ub,      is_eq,   ht,   tau,
                  sig, Y,  L,         nullptr, nullptr, nullptr, Yout, Lout,
                  Yavg, Lavg, B,      m,       n,       n_inner, stream};
  return pdhg_stream::launch<T, true>(C, TM, ldk, a, nullptr);
}

}  // namespace

extern "C" {

// one round on a cluster of C CTAs per tile of TM rows; K's rows lie ldk
// elements apart (a multiple of 16 bytes, at least n); returns
// cudaError_t
int pdhg_average_stream_f32(int C, int TM, int ldk,
                            const void* K, const void* q,
                            int q_per_row, const void* lb, const void* ub,
                            const void* is_eq, const void* ht,
                            const void* tau, const void* sig, const void* Y,
                            const void* L, void* Yout, void* Lout,
                            void* Yavg, void* Lavg, int B, int m, int n,
                            int n_inner, void* stream) {
  return run<float>(C, TM, ldk, K, q, q_per_row, lb, ub, is_eq, ht, tau,
                    sig, Y, L, Yout, Lout, Yavg, Lavg, B, m, n, n_inner,
                    stream);
}

int pdhg_average_stream_f64(int C, int TM, int ldk,
                            const void* K, const void* q,
                            int q_per_row, const void* lb, const void* ub,
                            const void* is_eq, const void* ht,
                            const void* tau, const void* sig, const void* Y,
                            const void* L, void* Yout, void* Lout,
                            void* Yavg, void* Lavg, int B, int m, int n,
                            int n_inner, void* stream) {
  return run<double>(C, TM, ldk, K, q, q_per_row, lb, ub, is_eq, ht, tau,
                     sig, Y, L, Yout, Lout, Yavg, Lavg, B, m, n, n_inner,
                     stream);
}

// cudaOccupancyMaxActiveClusters for that launch, into *out; nothing is
// launched
int pdhg_average_stream_occupancy(int f64, int C, int TM, int m, int n,
                                  int* out) {
  return pdhg_stream::occupancy<true>(f64, C, TM, m, n, out);
}

}  // extern "C"
