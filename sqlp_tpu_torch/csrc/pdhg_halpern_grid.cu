// Reflected-Halpern PDHG round as grid-wide product phases, for float32
// panels of a K that fits no cluster (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas_halpern
// (body _kernel_halpern) where K is too large for the cluster and tile
// variants and the float32 panel too large for the cluster variant:
// storm's from 85 rows, the MC bound's 1024- and 4096-row panels among
// them. It computes exactly what
// ops/cuda/pdhg_kernel.py:pdhg_halpern_round_ref computes, bit for bit what
// pdhg_halpern_round.cu computes.
//
// What bounds the row-block kernel there: a block carries 2 or 4 batch
// rows and reads K from L2 twice a step for them, so the round sits at the
// L2's bandwidth. pdhg_grid.cuh keeps the iterates in device memory and
// runs each step as two launches over the whole panel, so that every K
// element that reaches shared memory serves a tile of 32 to 128 rows, and
// says how. This file instantiates it for the Halpern scheme.

#include "pdhg_grid.cuh"

extern "C" {

// one round at primal tiles of BM rows, the panel's rows in at most P
// parts on streams of their own; K (padded to mK x ldk rows and columns,
// zeros past m and n) and Kr (the same, residue-major) come from the
// wrapper, as do the scratch Ls ([Bp, mK]) and Ybr ([Bp, ldk]), Bp the
// panel's rows rounded up to 128; returns cudaError_t
int pdhg_halpern_grid_f32(int BM, int P, int ldk, int mK, const void* Kr,
                          void* Ls, void* Ybr, const void* K, const void* q,
                          int q_per_row, const void* lb, const void* ub,
                          const void* is_eq, const void* ht, const void* tau,
                          const void* sig, const void* Y, const void* L,
                          const void* kh, const void* Yanc, const void* Lanc,
                          void* Yout, void* Lout, void* Ycand, void* Lcand,
                          int B, int m, int n, int n_inner, void* stream) {
  const pdhg::RoundArgs a = {K,     q,    q_per_row, lb,   ub,    is_eq,
                             ht,    tau,  sig,       Y,    L,     kh,
                             Yanc,  Lanc, Yout,      Lout, Ycand, Lcand,
                             B,     m,    n,         n_inner, stream};
  return pdhg_grid::launch<false>(BM, P, ldk, mK, Kr, Ls, Ybr, a);
}

// dynamic shared memory of the larger phase at tile rows BM, in bytes; 0
// where BM is no tile height of the kernel's (ops/cuda/pdhg_kernel.py:
// _grid_smem mirrors it)
long long pdhg_grid_smem(int BM) { return pdhg_grid::smem_bytes(BM); }

}  // extern "C"
