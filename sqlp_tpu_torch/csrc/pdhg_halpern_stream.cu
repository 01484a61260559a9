// Reflected-Halpern PDHG round for a K that fits no cluster: tiles of 16
// batch rows on a thread-block cluster, K streamed through shared memory
// every step (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas_halpern
// (body _kernel_halpern) where K is too large for the cluster and tile
// variants (storm, 2.66 MB in f32 and 5.32 MB in f64): storm's f64 panels
// (its f32 panels past the cluster kernel's go to the grid variant,
// pdhg_halpern_grid.cu, and come here only while that is not admitted for
// them). It computes exactly what
// ops/cuda/pdhg_kernel.py:pdhg_halpern_round_ref computes; in float32 bit
// for bit what pdhg_halpern_round.cu computes.
//
// What bounds the row-block kernel there: a block carries 2 or 4 batch
// rows and reads K from L2 twice a step for them, so the round sits at the
// L2's bandwidth. pdhg_stream.cuh streams K through a ring of shared-memory
// stages so that every element read serves a tile of 16 rows, splits the
// tile over a cluster, and says how. This file instantiates it for the
// Halpern scheme.

#include "pdhg_stream.cuh"

namespace {

using pdhg_stream::Args;

template <typename T>
int run(int C, int TM, int ldk, const void* K, const void* q,
        int q_per_row, const void* lb, const void* ub, const void* is_eq,
        const void* ht, const void* tau, const void* sig, const void* Y,
        const void* L, const void* kh, const void* Yanc, const void* Lanc,
        void* Yout, void* Lout, void* Ycand, void* Lcand, int B, int m,
        int n, int n_inner, void* stream) {
  const Args a = {K,   q,  q_per_row, lb,   ub,   is_eq, ht,   tau,
                  sig, Y,  L,         kh,   Yanc, Lanc,  Yout, Lout,
                  Ycand, Lcand, B,    m,    n,    n_inner, stream};
  return pdhg_stream::launch<T, false>(C, TM, ldk, a, nullptr);
}

}  // namespace

extern "C" {

// one round on a cluster of C CTAs per tile of TM rows; K's rows lie ldk
// elements apart (a multiple of 16 bytes, at least n); returns
// cudaError_t
int pdhg_halpern_stream_f32(int C, int TM, int ldk,
                            const void* K, const void* q,
                            int q_per_row, const void* lb, const void* ub,
                            const void* is_eq, const void* ht,
                            const void* tau, const void* sig, const void* Y,
                            const void* L, const void* kh, const void* Yanc,
                            const void* Lanc, void* Yout, void* Lout,
                            void* Ycand, void* Lcand, int B, int m, int n,
                            int n_inner, void* stream) {
  return run<float>(C, TM, ldk, K, q, q_per_row, lb, ub, is_eq, ht, tau,
                    sig, Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand, B,
                    m, n, n_inner, stream);
}

int pdhg_halpern_stream_f64(int C, int TM, int ldk,
                            const void* K, const void* q,
                            int q_per_row, const void* lb, const void* ub,
                            const void* is_eq, const void* ht,
                            const void* tau, const void* sig, const void* Y,
                            const void* L, const void* kh, const void* Yanc,
                            const void* Lanc, void* Yout, void* Lout,
                            void* Ycand, void* Lcand, int B, int m, int n,
                            int n_inner, void* stream) {
  return run<double>(C, TM, ldk, K, q, q_per_row, lb, ub, is_eq, ht, tau,
                     sig, Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand, B,
                     m, n, n_inner, stream);
}

// cudaOccupancyMaxActiveClusters for that launch, into *out; nothing is
// launched
int pdhg_halpern_stream_occupancy(int f64, int C, int TM, int m, int n,
                                  int* out) {
  return pdhg_stream::occupancy<false>(f64, C, TM, m, n, out);
}

// shared memory of one CTA of either scheme's stream kernel, in bytes; 0
// where the shapes do not fit (ops/cuda/pdhg_kernel.py:_stream_smem
// mirrors it)
long long pdhg_stream_smem(int f64, int C, int m, int n) {
  return pdhg_stream::smem_bytes(f64, C, m, n);
}

}  // extern "C"
