// PDHG round as grid-wide product phases, for float32 panels of a K that
// fits no cluster, both restart schemes (Hopper, sm_90a). Instantiated by
// pdhg_halpern_grid.cu (reflected Halpern, AVG = false) and
// pdhg_average_grid.cu (restart to the average, AVG = true); the step is
// the one pdhg_halpern_round.cu and pdhg_average_round.cu state.
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas_halpern
// (body _kernel_halpern) and pdhg_round_pallas (body _kernel), in the
// regime where K fits no cluster and the float32 panel is too large for
// the cluster kernel: storm (m 528, n 1259, K 2.66 MB in f32) from 85
// rows, the MC bound's 1024- and 4096-row panels among them (the sweep
// put it ahead of the stream kernel there). The TPU kernel keeps K
// resident in VMEM and runs 128-row blocks against it.
//
// What bounds it on this card: the two products, 2 m n FMAs a row and
// step (at storm B = 4096, 5.4 G FMAs a step, 13.0 ms a round at the
// FP32 peak). The row-block kernel holds 4 rows a block in shared memory
// and reads K from L2 for them, twice a step: 436 GB of L2 reads a round
// at B = 4096, L2-bound. The stream kernel holds a tile's iterates in a
// cluster's shared memory, which caps a tile at 16 rows. Here the
// iterates stay in device memory and every step is two launches over the
// whole panel, so a tile is as tall as the registers allow:
//
// - Primal phase, G = q - L K: a CTA of 2 BM threads takes an output tile
//   of BM rows x 128 columns, a thread 8 x 8 outputs (rows tr + BM/8 r,
//   columns 4 tc .. 4 tc + 3 and 64 + 4 tc ..). L (rows) and K (columns)
//   pass through a ring of 3 cp.async stages of 16 K rows; every K value
//   that reaches shared memory serves BM rows, every L value 128 columns.
//   Each output sums i = 0 .. m-1 in order, one FMA chain from zero (the
//   row-block kernel's col_products, pdhg_common.cuh). The epilogue forms
//   Y1 = clip(Y - tau G, lb, ub), Yb = 2 Y1 - Y and the Halpern blend (or
//   the running sum) of Y, in place, and stores Yb in the dual phase's
//   layout.
// - Dual phase, S = ht - Yb K^T: a CTA of 8 warps takes 32 rows x 16
//   constraints, a warp 8 x 8 of them (two CTAs an SM, so that one's
//   stages fill while the other computes). The row-block kernel's order
//   is a warp per constraint row, lane l summing j = l mod 32 in
//   increasing j,
//   then warp_sum's shuffle tree. Here lane l keeps that sum for all 64
//   outputs of its warp: Yb and K are stored with their columns permuted
//   residue-major within blocks of 128 (position 4 l + k holds column
//   32 k + l), so a lane's 16-byte word holds its j, j + 32, j + 64,
//   j + 96 in order and a warp's 32 words are 512 contiguous bytes (no
//   bank conflict). The 64 sums are then reduced over the lanes in the
//   XOR tree of warp_sum's shuffles (a reduce-scatter: each level adds the
//   pairs warp_sum adds, a + b = b + a; lane l ends with outputs 2 l and
//   2 l + 1), and the epilogue forms L1 and the update of L.
// - One C call enqueues 2 n_inner launches for each part of the panel, no
//   host synchronisation. The rows are independent LPs, so the panel is
//   cut into P (at most 4) parts, each on a stream of its own forked from
//   the caller's and joined back into it: one part's phases fill the SMs
//   that another's last wave of tiles leaves idle (chip_smoke.py's sweep
//   times P = 1, 2 and 4; PERF.md). The scratch (L at a padded stride, the
//   permuted Yb) comes from the wrapper; the launcher only fills it.
// - Every pad is zero (K's rows to a multiple of 16 and columns to one of
//   128, L's columns and the panel's rows to those of the scratch), so the
//   products run unmasked; a pad only adds +0 = 0 x 0 to a sum, which is
//   never -0, so every sum keeps its bits. Rows past B are never written.
// - The epilogues' roundings are pinned (fma(-tau, q - g, y),
//   fma(sig, h - s, l), the blend fma(1 - w, y, w x)) to the ones nvcc's
//   contraction gives the row-block kernel's expressions, as pdhg_tile.cuh
//   pins its own; chip_smoke.py's b1 and b2 hold every output to the
//   row-block kernel's bits.
//
// Every sum has a fixed order (no atomics): two launches are bitwise
// equal.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pdhg_common.cuh"

namespace pdhg_grid {

using pdhg::clip;
using Args = pdhg::RoundArgs;

constexpr int kBN = 128;               // primal tile columns
constexpr int kBK = 16;                // K rows of a primal stage
constexpr int kAS = kBK + 4;           // row stride of a stage's L rows
constexpr int kStages = 3;             // both phases
constexpr int kJC = 128;               // columns of a dual stage
constexpr int kDWR = 4;                // dual warps along rows
constexpr int kDWI = 2;                // and along constraints
constexpr int kDR = 8;                 // rows and constraints of a warp
constexpr int kDBM = kDWR * kDR;       // dual tile: 32 rows
constexpr int kDBI = kDWI * kDR;       // x 16 constraints
constexpr int kDThreads = 32 * kDWR * kDWI;
constexpr int kMRound = 16;            // K's rows padded to this
constexpr int kBRound = 128;           // the scratch's rows padded to this
constexpr int kMaxParts = 4;           // streams a round's rows split over

// dynamic shared memory of each phase, in bytes (mirrored by
// ops/cuda/pdhg_kernel.py:_grid_smem)
__host__ __device__ constexpr size_t primal_smem(int BM) {
  return static_cast<size_t>(kStages) * (BM * kAS + kBK * kBN) *
         sizeof(float);
}
__host__ __device__ constexpr size_t dual_smem() {
  return static_cast<size_t>(kStages) * (kDBM + kDBI) * kJC * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// the row-block kernel's roundings (its expressions as nvcc contracts
// them), pinned in pdhg_common.cuh
using pdhg::blend;
using pdhg::halpern_w;
// where column j lies in a row of the permuted Yb and K: position 4 l + k
// of its block of 128 holds column 32 k + l
__device__ __forceinline__ int residue_major(int j) {
  return (j & ~127) | ((j & 31) << 2) | ((j >> 5) & 3);
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// One primal phase (step t): G = q - L K on a BM x 128 tile and the
// primal epilogue. Y is the iterate (read and written in place), Ya the
// Halpern anchor, Y2 the Halpern candidate (last step) or the running sum
// (its average on the last step); Yb goes to Ybr, residue-major, at row
// stride ldk.
template <int BM, bool AVG>
__global__ void __launch_bounds__(2 * BM, 256 / BM)
grid_primal(const float* __restrict__ Kp, const float* __restrict__ Ls,
            int ldk, int mK, const float* __restrict__ q, int q_per_row,
            const float* __restrict__ lb, const float* __restrict__ ub,
            const float* __restrict__ tau, const float* __restrict__ kh,
            const float* __restrict__ Ya, float* __restrict__ Y,
            float* __restrict__ Y2, float* __restrict__ Ybr, int B, int n,
            int t, int n_inner) {
  constexpr int NT = 2 * BM;
  constexpr int RG = BM / 8;           // row groups: a thread's rows tr + RG r
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                // [stage][BM][kAS]
  float* Bs = smem + kStages * BM * kAS;           // [stage][kBK][kBN]
  const int tid = threadIdx.x;
  const int tc = tid & 15;
  const int tr = tid >> 4;
  const int c0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * BM;
  const int nk = mK / kBK;

  auto load = [&](int kt) {
    float* a = As + (kt % kStages) * BM * kAS;
    float* b = Bs + (kt % kStages) * kBK * kBN;
    const int k0 = kt * kBK;
#pragma unroll
    for (int e = tid; e < BM * kBK / 4; e += NT) {
      const int r = e >> 2;
      const int c = (e & 3) * 4;
      cp_async16(a + r * kAS + c,
                 Ls + static_cast<size_t>(row0 + r) * mK + k0 + c);
    }
#pragma unroll
    for (int e = tid; e < kBK * kBN / 4; e += NT) {
      const int r = e >> 5;
      const int c = (e & 31) * 4;
      cp_async16(b + r * kBN + c,
                 Kp + static_cast<size_t>(k0 + r) * ldk + c0 + c);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();     // stage kt landed; stage kt - 1 is free
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_commit();
    const float* a = As + (kt % kStages) * BM * kAS;
    const float* b = Bs + (kt % kStages) * kBK * kBN;
#pragma unroll
    for (int kq = 0; kq < kBK / 4; ++kq) {
      float4 av[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        av[r] = *reinterpret_cast<const float4*>(
            a + (tr + RG * r) * kAS + 4 * kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* bk = b + (4 * kq + kk) * kBN + 4 * tc;
        const float4 b0 = *reinterpret_cast<const float4*>(bk);
        const float4 b1 = *reinterpret_cast<const float4*>(bk + 64);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                             b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float x = lane_of(av[r], kk);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] = __fmaf_rn(x, bv[c], acc[r][c]);
        }
      }
    }
  }

  const bool last = t == n_inner - 1;
  const float cnt = static_cast<float>(n_inner);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = row0 + tr + RG * r;
    if (row >= B) continue;
    const float tr_ = tau[row];
    const float w = AVG ? 0.f : halpern_w(kh[row], t);
    const size_t base = static_cast<size_t>(row) * n;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = c0 + (c >> 2) * 64 + 4 * tc + (c & 3);
      if (j >= n) continue;
      const size_t gi = base + j;
      const float qj = q_per_row ? q[gi] : q[j];
      const float y = Y[gi];
      const float y1 =
          clip(__fmaf_rn(-tr_, __fsub_rn(qj, acc[r][c]), y), lb[j], ub[j]);
      const float yb = __fsub_rn(__fmul_rn(2.f, y1), y);
      Ybr[static_cast<size_t>(row) * ldk + residue_major(j)] = yb;
      if constexpr (AVG) {
        const float s = __fadd_rn(t == 0 ? 0.f : Y2[gi], y1);
        Y[gi] = y1;
        Y2[gi] = last ? __fdiv_rn(s, cnt) : s;
      } else {
        Y[gi] = blend(w, yb, Ya[gi]);
        if (last) Y2[gi] = y1;
      }
    }
  }
}

// One level of the dual sums' reduce-scatter over the lanes: lanes that
// differ in bit P / 4 trade halves of their first P sums and add what they
// keep to what they get; afterwards v[k < P / 2] is output k of the half
// the lane's bit selects
template <int P>
__device__ __forceinline__ void scatter_level(float (&v)[kDR * kDR],
                                             int lane) {
  constexpr int H = P / 2;
  const bool up = (lane & (P / 4)) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? v[k] : v[k + H];
    const float keep = up ? v[k + H] : v[k];
    v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, P / 4));
  }
}

// One dual phase (step t): S = ht - Yb K^T on a 32 x 32 tile and the dual
// epilogue. Ls is L at row stride mK (read and written in place); La the
// Halpern anchor; L2 the Halpern candidate (last step) or the running sum
// (its average on the last step); Lout receives the new L on the last
// step.
template <bool AVG>
__global__ void __launch_bounds__(kDThreads, 512 / kDThreads)
grid_dual(const float* __restrict__ Kr, const float* __restrict__ Ybr,
          int ldk, int mK, const uint8_t* __restrict__ is_eq,
          const float* __restrict__ ht, const float* __restrict__ sig,
          const float* __restrict__ kh, const float* __restrict__ La,
          float* __restrict__ Ls, float* __restrict__ L2,
          float* __restrict__ Lout, int B, int m, int t, int n_inner) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = (kDBM + kDBI) * kJC;           // floats of a stage
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp / kDWI;
  const int wi = warp % kDWI;
  const int i0 = blockIdx.x * kDBI;
  const int row0 = blockIdx.y * kDBM;
  const int nc = ldk / kJC;

  auto load = [&](int c) {
    float* ys = smem + (c % kStages) * S;          // [kDBM][kJC]
    float* ks = ys + kDBM * kJC;                   // [kDBI][kJC]
#pragma unroll
    for (int e = tid; e < kDBM * kJC / 4; e += kDThreads) {
      const int r = e >> 5;
      const int c4 = (e & 31) * 4;
      cp_async16(ys + r * kJC + c4,
                 Ybr + static_cast<size_t>(row0 + r) * ldk + c * kJC + c4);
    }
#pragma unroll
    for (int e = tid; e < kDBI * kJC / 4; e += kDThreads) {
      const int r = e >> 5;
      const int c4 = (e & 31) * 4;
      cp_async16(ks + r * kJC + c4,
                 Kr + static_cast<size_t>(i0 + r) * ldk + c * kJC + c4);
    }
  };

  float acc[kDR * kDR];                 // acc[r * 8 + i]
#pragma unroll
  for (int k = 0; k < kDR * kDR; ++k) acc[k] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nc) load(s);
    cp_commit();
  }
  for (int c = 0; c < nc; ++c) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < nc) load(c + kStages - 1);
    cp_commit();
    const float* ys = smem + (c % kStages) * S + wr * kDR * kJC + 4 * lane;
    const float* ks = smem + (c % kStages) * S + kDBM * kJC +
                      wi * kDR * kJC + 4 * lane;
    float4 yv[kDR];
#pragma unroll
    for (int r = 0; r < kDR; ++r)
      yv[r] = *reinterpret_cast<const float4*>(ys + r * kJC);
#pragma unroll
    for (int i = 0; i < kDR; ++i) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + i * kJC);
#pragma unroll
      for (int r = 0; r < kDR; ++r) {
        float& a = acc[r * kDR + i];
        a = __fmaf_rn(kv.x, yv[r].x, a);
        a = __fmaf_rn(kv.y, yv[r].y, a);
        a = __fmaf_rn(kv.z, yv[r].z, a);
        a = __fmaf_rn(kv.w, yv[r].w, a);
      }
    }
  }

  scatter_level<64>(acc, lane);
  scatter_level<32>(acc, lane);
  scatter_level<16>(acc, lane);
  scatter_level<8>(acc, lane);
  scatter_level<4>(acc, lane);

  // lane l holds outputs 2 l and 2 l + 1: row l / 4, constraints
  // 2 (l mod 4) and the next
  const int row = row0 + wr * kDR + (lane >> 2);
  if (row >= B) return;
  const bool last = t == n_inner - 1;
  const float cnt = static_cast<float>(n_inner);
  const float sg = sig[row];
  const float w = AVG ? 0.f : halpern_w(kh[row], t);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + wi * kDR + 2 * (lane & 3) + h;
    if (i >= m) continue;
    const size_t gl = static_cast<size_t>(row) * mK + i;
    const size_t gi = static_cast<size_t>(row) * m + i;
    const float l = Ls[gl];
    const float lr = __fmaf_rn(sg, __fsub_rn(ht[gi], acc[h]), l);
    const float l1 = (is_eq[i] != 0 || !(lr < 0.f)) ? lr : 0.f;
    if constexpr (AVG) {
      const float s = __fadd_rn(t == 0 ? 0.f : L2[gi], l1);
      Ls[gl] = l1;
      L2[gi] = last ? __fdiv_rn(s, cnt) : s;
      if (last) Lout[gi] = l1;
    } else {
      const float lnew =
          blend(w, __fsub_rn(__fmul_rn(2.f, l1), l), La[gi]);
      Ls[gl] = lnew;
      if (last) {
        Lout[gi] = lnew;
        L2[gi] = l1;
      }
    }
  }
}

// One round: fills the scratch (Ls: L at row stride mK, zero pads; Ybr:
// zeros; Yout: Y), then enqueues the two phases of every step for each of
// at most P parts of the panel. Kp is K with its rows and columns padded
// (mK, ldk), Kr the same residue-major; returns cudaError_t
template <bool AVG>
int launch(int BM, int P, int ldk, int mK, const void* Kr, void* Ls,
           void* Ybr, const Args& a) {
  if ((BM != 64 && BM != 128) || P < 1 || P > kMaxParts ||
      ldk % kJC != 0 || ldk < a.n ||
      mK % kMRound != 0 || mK < a.m || a.B <= 0 || a.n_inner <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const int Bp = (a.B + kBRound - 1) / kBRound * kBRound;
  const size_t fs = sizeof(float);
  cudaError_t err = cudaMemsetAsync(Ls, 0, Bp * mK * fs, st);
  if (err == cudaSuccess)
    err = cudaMemcpy2DAsync(Ls, mK * fs, a.L, a.m * fs, a.m * fs, a.B,
                            cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(Ybr, 0, Bp * static_cast<size_t>(ldk) * fs, st);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(a.Yout, a.Y, static_cast<size_t>(a.B) * a.n * fs,
                          cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  auto primal = BM == 128 ? grid_primal<128, AVG> : grid_primal<64, AVG>;
  auto dual = grid_dual<AVG>;
  const size_t ps = primal_smem(BM);
  const size_t ds = dual_smem();
  err = cudaFuncSetAttribute(primal,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ps));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dual,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(ds));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* Kpf = static_cast<const float*>(a.K);
  const float* Krf = static_cast<const float*>(Kr);
  auto fp = [](const void* p, size_t e) {
    return p ? const_cast<float*>(static_cast<const float*>(p)) + e : nullptr;
  };
  auto step = [&](int rb, int rows, cudaStream_t s, int t) {
    const dim3 pg(ldk / kBN, (rows + BM - 1) / BM);
    const dim3 dg(mK / kDBI, (rows + kDBM - 1) / kDBM);
    const size_t rn = static_cast<size_t>(rb) * a.n;
    const size_t rm = static_cast<size_t>(rb) * a.m;
    primal<<<pg, 2 * BM, ps, s>>>(
        Kpf, fp(Ls, static_cast<size_t>(rb) * mK), ldk, mK,
        fp(a.q, a.q_per_row ? rn : 0), a.q_per_row, fp(a.lb, 0),
        fp(a.ub, 0), fp(a.tau, rb), fp(a.kh, rb), fp(a.Yanc, rn),
        fp(a.Yout, rn), fp(a.Yout2, rn),
        fp(Ybr, static_cast<size_t>(rb) * ldk), rows, a.n, t, a.n_inner);
    dual<<<dg, kDThreads, ds, s>>>(
        Krf, fp(Ybr, static_cast<size_t>(rb) * ldk), ldk, mK,
        static_cast<const uint8_t*>(a.is_eq), fp(a.ht, rm), fp(a.sig, rb),
        fp(a.kh, rb), fp(a.Lanc, rm), fp(Ls, static_cast<size_t>(rb) * mK),
        fp(a.Lout2, rm), fp(a.Lout, rm), rows, a.m, t, a.n_inner);
  };
  // the panel's rows in at most P parts of whole 128-row blocks, part p on
  // a stream of its own: part 0 on the caller's, the others forked from it
  // and joined back into it (cudaStreamWaitEvent waits for the event's
  // latest record, so one event serves every fork and join)
  const int per = ((a.B + P - 1) / P + kBRound - 1) / kBRound * kBRound;
  const int np = (a.B + per - 1) / per;
  cudaStream_t ss[kMaxParts] = {st};
  cudaEvent_t ev;
  err = cudaEventCreateWithFlags(&ev, cudaEventDisableTiming);
  if (err != cudaSuccess) return static_cast<int>(err);
  int made = 1;
  err = cudaEventRecord(ev, st);
  while (err == cudaSuccess && made < np) {
    err = cudaStreamCreateWithFlags(&ss[made], cudaStreamNonBlocking);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(ss[made++], ev, 0);
  }
  for (int t = 0; t < a.n_inner && err == cudaSuccess; ++t) {
    for (int p = 0; p < np; ++p)
      step(p * per, min(per, a.B - p * per), ss[p], t);
    err = cudaGetLastError();
  }
  for (int p = 1; p < made; ++p) {
    cudaError_t e = cudaEventRecord(ev, ss[p]);
    if (e == cudaSuccess) e = cudaStreamWaitEvent(st, ev, 0);
    if (e == cudaSuccess) e = cudaStreamDestroy(ss[p]);
    if (err == cudaSuccess) err = e;
  }
  cudaEventDestroy(ev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory of the larger phase at tile rows BM, in bytes; 0
// where BM is no tile height of the kernel's
inline long long smem_bytes(int BM) {
  if (BM != 64 && BM != 128) return 0;
  const size_t p = primal_smem(BM);
  const size_t d = dual_smem();
  return static_cast<long long>(p > d ? p : d);
}

}  // namespace pdhg_grid
