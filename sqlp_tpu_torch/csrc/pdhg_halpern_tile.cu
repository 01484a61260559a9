// Reflected-Halpern PDHG round for large batches: tiles of batch rows, K
// resident in a thread-block cluster's shared memory (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas_halpern
// (body _kernel_halpern) in its large-panel regime (the Monte-Carlo
// panel's 4096- and 1024-row rungs); pdhg_halpern_cluster.cu keeps the
// small panels and pdhg_halpern_round.cu what neither takes. It computes
// exactly what ops/cuda/pdhg_kernel.py:pdhg_halpern_round_ref computes.
//
// What bounds the row-block kernel there: a block carries 4 batch rows and
// reads K twice per step from L2, so the round sits at the L2's bandwidth
// (about 79 GB per 80-step round at ssn B = 4096), and its products are
// scalar FMAs. The TPU kernel kept K in VMEM and ran the products on the
// matrix unit as three bf16 passes; pdhg_tile.cuh keeps K's column slices
// in a cluster's shared memory and runs the products as FP64 mma.sync
// instructions on tiles of 16 rows in float64 and as FP32 FMAs in
// float32, each lane holding R rows by 4 outputs in registers, on tiles
// as short as the panel's passes allow. What bounds it now: FMA-loop
// instruction issue in float32 (a product about 4.8 us of a 16-row
// step's 13.5 at ssn), the FP64 matrix instructions and the dual update in
// float64, and in both the step's two cluster barriers; that header says
// how each cost was measured. This file instantiates it for the Halpern
// scheme.

#include "pdhg_tile.cuh"

namespace {

using pdhg_tile::Args;

template <typename T>
int run(int C, int nclusters, int tm, const void* K, const void* q,
        int q_per_row, const void* lb, const void* ub, const void* is_eq,
        const void* ht, const void* tau, const void* sig, const void* Y,
        const void* L, const void* kh, const void* Yanc, const void* Lanc,
        void* Yout, void* Lout, void* Ycand, void* Lcand, int B, int m,
        int n, int n_inner, void* stream) {
  const Args a = {K,   q,  q_per_row, lb,   ub,   is_eq, ht,   tau,
                  sig, Y,  L,         kh,   Yanc, Lanc,  Yout, Lout,
                  Ycand, Lcand, B,    m,    n,    n_inner, stream};
  return pdhg_tile::launch<T, false>(C, nclusters, tm, a, nullptr);
}

}  // namespace

extern "C" {

// one round on nclusters persistent clusters of C CTAs walking tiles of
// tm rows (float64: 16); returns cudaError_t
int pdhg_halpern_tile_f32(int C, int nclusters, int tm,
                          const void* K,
                          const void* q, int q_per_row, const void* lb,
                          const void* ub, const void* is_eq, const void* ht,
                          const void* tau, const void* sig, const void* Y,
                          const void* L, const void* kh, const void* Yanc,
                          const void* Lanc, void* Yout, void* Lout,
                          void* Ycand, void* Lcand, int B, int m, int n,
                          int n_inner, void* stream) {
  return run<float>(C, nclusters, tm, K, q, q_per_row, lb, ub, is_eq, ht,
                    tau, sig, Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand, Lcand,
                    B, m, n, n_inner, stream);
}

int pdhg_halpern_tile_f64(int C, int nclusters, int tm,
                          const void* K,
                          const void* q, int q_per_row, const void* lb,
                          const void* ub, const void* is_eq, const void* ht,
                          const void* tau, const void* sig, const void* Y,
                          const void* L, const void* kh, const void* Yanc,
                          const void* Lanc, void* Yout, void* Lout,
                          void* Ycand, void* Lcand, int B, int m, int n,
                          int n_inner, void* stream) {
  return run<double>(C, nclusters, tm, K, q, q_per_row, lb, ub, is_eq, ht,
                     tau, sig, Y, L, kh, Yanc, Lanc, Yout, Lout, Ycand,
                     Lcand, B, m, n, n_inner, stream);
}

// cudaOccupancyMaxActiveClusters for that launch, into *out; nothing is
// launched
int pdhg_halpern_tile_occupancy(int f64, int C, int m, int n,
                                int* out) {
  return pdhg_tile::occupancy<false>(f64, C, m, n, out);
}


}  // extern "C"
