// PDHG round for a K small enough to sit whole in one block's shared
// memory, both restart schemes (Hopper, sm_90a). Instantiated by
// pdhg_halpern_small.cu (reflected Halpern, AVG = false) and
// pdhg_average_small.cu (restart to the average, AVG = true); the step is
// the one pdhg_halpern_round.cu and pdhg_average_round.cu state, and every
// output is bit for bit theirs.
//
// Replaces: sqlp_tpu/ops/pallas/pdhg_kernel.py, pdhg_round_pallas_halpern
// (body _kernel_halpern) and pdhg_round_pallas (body _kernel), in the
// regime of a K under 128 KB (lands 7 x 12, transship 35 x 77, baa99-20
// 40 x 250, the toy instances), at every panel size: the SD step's 2 rows,
// the replications' 16, the MC ladder's 256 to 4096. The TPU kernel keeps
// K resident in VMEM and runs 128-row blocks against it.
//
// What held the row-block kernel back in this regime: 512 threads a block
// whatever the shape (on lands 12 of them in the primal phase) meeting at
// two block-wide barriers a step; K, q, the bounds and is_eq read from
// device memory (L1) every step; a division per element and step for the
// Halpern weight; lane 0 alone running the dual epilogue of each row in
// turn; at most 4 batch rows a block. The design here:
//
// - Resident operands. A block copies K, lb, ub, is_eq and a shared q into
//   its shared memory once (cp.async), beside its rows' iterates, anchors
//   (or running sums), reflected primal, right-hand side and per-row q;
//   nothing is read from device memory inside the n_inner loop. baa99-20's
//   K in float64 (80 KB) leaves room for 16 rows of float64 vectors.
//   At the MC panel a block carries 16 to 32 rows, so the copies of K are
//   a few MB a launch against the 80 steps' products.
// - Fitted to the shape. A group of W warps carries R batch rows (R = 1, 2
//   or 4, register-blocked: each K element a thread loads serves R rows);
//   a block carries G groups that share its copy of K. A group syncs only
//   with itself, __syncwarp for W = 1, else a named barrier (bar.sync
//   1 + g, 32 W): no block-wide barrier inside the loop. The plan
//   (ops/cuda/pdhg_kernel.py:_small_shape, from chip_smoke.py's sweep)
//   picks W from n and the panel's rows per SM (many warps a row while
//   latency bounds the step, few when the rows fill the card), R from the
//   rows per SM, and G as the most groups that keep a block on every SM.
// - The same sums. G = q - L K: a thread per column, one FMA chain over
//   i = 0 .. m-1 from +0 for each row (col_products' order), L read four
//   at a time (K's and L's zero pads to a multiple of 4 rows add exact
//   zeros). S = ht - Yb K^T: the group's warps take the constraint rows
//   in turn, i = warp + W k; for up to kItems (row, batch row) items at
//   once lane l keeps the FMA chain over j = l, l + 32, ... from +0
//   (row_products' order), then the items are reduced over the lanes in
//   the XOR tree of warp_sum's shuffle-down levels 16, 8, 4, 2, 1 as a
//   reduce-scatter: each level adds the pairs warp_sum adds (a + b = b + a
//   bitwise), half the items stay with each half of the lanes, and each
//   item ends in its own lanes, which run its epilogue (no lane 0 in
//   turn). The independent chains and trees of several items interleave.
//   8 items a warp: 16 doubled the unrolled code and ran slower (the
//   sweep, baa99-20 at 2 rows).
// - The tiny layout (n <= 32, m <= 8: lands and the toy instances), where a
//   step is a chain of dependent latencies for one warp: K's rows at a
//   stride of 32 elements and 16 bytes with zero pads, each primal
//   thread's column of K in registers, and a thread per dual item that
//   loads its row of K and Yb in 16-byte words and sums the 32 lane
//   partials in warp_sum's tree in registers (tiny_dual_sum), with no
//   shuffle. On lands a step took 0.88 us in the warp layout and takes
//   0.52 us in this one, float32 (the sweep's fixed-cost lines, PERF.md).
// - The Halpern weight w = (k + 1) / (k + 2) once per row and step, by the
//   same IEEE division; the epilogues' roundings pinned (pdhg_common.cuh).
// - Every input the row-block kernel takes: float32 and float64, both
//   schemes, shared or per-element q, a ragged last group (rows past B run
//   on zeros and are never written), NaN kept as clip keeps it.
//
// Every sum has a fixed order (no atomics): two launches are bitwise
// equal.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pdhg_common.cuh"

namespace pdhg_small {

using Args = pdhg::RoundArgs;
using pdhg::add_rn;
using pdhg::blend;
using pdhg::div_rn;
using pdhg::dual_l1;
using pdhg::fma_rn;
using pdhg::halpern_w;
using pdhg::primal_y1;
using pdhg::reflect;

constexpr int kItems = 8;         // (row, batch row) sums a warp reduces
                                  // at once
constexpr int kMaxWarps = 16;     // warps of a block
// the tiny layout (K's rows at a stride of 32, a column of K in each
// thread's registers, a thread per dual item): up to 32 columns and 8
// constraint rows (lands and the toy instances)
constexpr int kLaneN = 32;
constexpr int kLaneM = 8;
constexpr size_t kSmemMax = 227 * 1024;

__host__ __device__ constexpr int up4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr bool tiny(int m, int n) {
  return n <= kLaneN && m <= kLaneM;
}
// K's row stride (in the tiny layout 32 and 16 bytes, so that the rows
// of a dual thread's items start in different banks), and the padded
// lengths of a row's n- and m-vectors
__host__ __device__ constexpr int ldk_of(int m, int n, int itemsize) {
  return tiny(m, n) ? kLaneN + 16 / itemsize : n;
}
__host__ __device__ constexpr int np_of(int m, int n) {
  return tiny(m, n) ? kLaneN : up4(n);
}
__host__ __device__ constexpr int mp_of(int m, int n) {
  return tiny(m, n) ? kLaneM : up4(m);
}

// The block's shared memory, in elements of the working type: K [mp,
// ldk], lb, ub and a shared q (np each), then for each of its G R rows Y,
// the anchor or running sum, Yb, a per-row q (np each) and L, its anchor
// or running sum, ht (mp each), then is_eq in bytes
// (ops/cuda/pdhg_kernel.py:_small_smem mirrors it). mp is m padded to a
// multiple of 4 (8 in the tiny layout), np n padded to a multiple of 4
// (32), ldk n (32 elements and 16 bytes). The pads of K, L and Yb are
// zero, so the products run over whole quads: a pad adds
// fma(0, 0, acc) = acc (acc is never -0: it starts at +0, and a sum is -0
// only if both terms are), and every sum keeps its bits.
__host__ __device__ constexpr int fixed_elems(int m, int n, int itemsize,
                                              int q_per_row) {
  return mp_of(m, n) * ldk_of(m, n, itemsize) +
         (q_per_row ? 2 : 3) * np_of(m, n);
}
__host__ __device__ constexpr int row_elems(int m, int n, int q_per_row) {
  return (q_per_row ? 4 : 3) * np_of(m, n) + 3 * mp_of(m, n);
}
__host__ __device__ constexpr size_t smem_bytes(int R, int G, int m, int n,
                                                int itemsize, int q_per_row) {
  return (static_cast<size_t>(fixed_elems(m, n, itemsize, q_per_row)) +
          static_cast<size_t>(G) * R * row_elems(m, n, q_per_row)) *
             itemsize +
         static_cast<size_t>(up4(m));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// the group's barrier: its one warp, or its W warps on barrier 1 + g
__device__ __forceinline__ void group_sync(int W, int g) {
  if (W == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" :: "r"(1 + g), "r"(32 * W) : "memory");
}

// 16 bytes of shared memory (4 float32 or 2 float64 elements), aligned
__device__ __forceinline__ void ldv(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ldv(const double* p, double* o) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  o[0] = v.x; o[1] = v.y;
}

// four consecutive elements of shared memory, 16-byte aligned
__device__ __forceinline__ void ld4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld4(const double* p, double* o) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// The reduce-scatter of N live items v[0 .. N) over the lanes, from the
// XOR level O down to 1: at a level with N > 1 items, lanes with bit O set
// keep the upper half, the others the lower, and each adds what its
// partner (lane ^ O) holds of the half it keeps; with one item left the
// level adds the partner's. Lane l ends with item l >> (5 - log2 P) in
// v[0], as warp_sum's lane 0 would sum it.
template <int P, int N, int O, typename T>
__device__ __forceinline__ void reduce_scatter(T (&v)[P], int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const T send = up ? v[k] : v[k + H];
        const T keep = up ? v[k + H] : v[k];
        v[k] = add_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
      }
      reduce_scatter<P, H, O / 2>(v, lane);
    } else {
      v[0] = add_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      reduce_scatter<P, 1, O / 2>(v, lane);
    }
  }
}

// The sum warp_sum's lane 0 forms of row_products' lane partials, in one
// thread, in the tiny layout: lane l's partial is fma(K_il, yb_l, +0)
// (K's and Yb's zero pads give +0 past n), the level of offset 16 adds the
// partials of l and l + 16, and each later level of offset OFF the sums
// of l and l + OFF, as the shuffle-down tree does for lane 0. Ki and yb
// are 16-byte aligned rows of kLaneN elements.
template <typename T>
__device__ __forceinline__ T tiny_dual_sum(const T* Ki, const T* yb) {
  constexpr int V = 16 / sizeof(T);
  T u[kLaneN / 2];
#pragma unroll
  for (int c = 0; c < kLaneN / 2; c += V) {
    T k0[V], k1[V], y0[V], y1[V];
    ldv(Ki + c, k0);
    ldv(Ki + kLaneN / 2 + c, k1);
    ldv(yb + c, y0);
    ldv(yb + kLaneN / 2 + c, y1);
#pragma unroll
    for (int v = 0; v < V; ++v)
      u[c + v] = add_rn(fma_rn(k0[v], y0[v], T(0)),
                        fma_rn(k1[v], y1[v], T(0)));
  }
#pragma unroll
  for (int off = kLaneN / 4; off >= 1; off >>= 1)
#pragma unroll
    for (int l = 0; l < off; ++l) u[l] = add_rn(u[l], u[l + off]);
  return u[0];
}

template <int P>
__host__ __device__ constexpr int log2i() {
  return P <= 1 ? 0 : 1 + log2i<P / 2>();
}

template <typename T, bool AVG, int R, bool TINY>
__global__ void __launch_bounds__(32 * kMaxWarps)
small_round(Args a, int W, int G) {
  constexpr int NI = kItems / R;          // constraint rows of a chunk
  constexpr int SHIFT = 5 - log2i<kItems>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int m = a.m;
  const int n = a.n;
  const int B = a.B;
  const int n_inner = a.n_inner;
  const int qrow = a.q_per_row != 0;
  const int np = np_of(m, n);
  const int mp = mp_of(m, n);
  const int ldk = ldk_of(m, n, sizeof(T));
  const int re = row_elems(m, n, qrow);
  T* Ks = sm;
  T* lbs = Ks + mp * ldk;
  T* ubs = lbs + np;
  T* qs = ubs + np;                       // the shared q (unused per row)
  T* rows = sm + fixed_elems(m, n, sizeof(T), qrow);
  uint8_t* eqs = reinterpret_cast<uint8_t*>(rows + G * R * re);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* K = static_cast<const T*>(a.K);
  const T* q = static_cast<const T*>(a.q);
  const T* lb = static_cast<const T*>(a.lb);
  const T* ub = static_cast<const T*>(a.ub);
  const uint8_t* is_eq = static_cast<const uint8_t*>(a.is_eq);
  for (int e = tid; e < mp * ldk; e += nt) {
    const int i = e / ldk;
    const int j = e - i * ldk;
    if (i < m && j < n)
      cp_async(Ks + e, K + i * n + j);
    else
      Ks[e] = T(0);
  }
  for (int j = tid; j < n; j += nt) {
    cp_async(lbs + j, lb + j);
    cp_async(ubs + j, ub + j);
    if (!qrow) cp_async(qs + j, q + j);
  }
  for (int i = tid; i < m; i += nt) eqs[i] = is_eq[i];

  // the group: W warps, R batch rows from row0
  const int NT = 32 * W;
  const int g = tid / NT;
  const int gt = tid - g * NT;
  const int warp = gt >> 5;
  const int lane = tid & 31;
  const int row0 = (blockIdx.x * G + g) * R;
  const int nrows = min(R, B - row0);
  T* base = rows + g * R * re;
  // a row's vectors: Y, A (anchor or sum), Yb, Q (per-row q) [np]; L, LA
  // (anchor or sum), H [mp]
  auto Yof = [&](int r) { return base + r * re; };
  auto Lof = [&](int r) { return base + r * re + (qrow ? 4 : 3) * np; };

  const T* Y0 = static_cast<const T*>(a.Y);
  const T* L0 = static_cast<const T*>(a.L);
  const T* Ya = static_cast<const T*>(a.Yanc);
  const T* La = static_cast<const T*>(a.Lanc);
  const T* ht = static_cast<const T*>(a.ht);
  T tau[R], sig[R], kh[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool live = r < nrows;
    const size_t bn = static_cast<size_t>(row0 + r) * n;
    const size_t bm = static_cast<size_t>(row0 + r) * m;
    T* Yr = Yof(r);
    T* Lr = Lof(r);
    for (int j = n + gt; j < np; j += NT) Yr[2 * np + j] = T(0);
    for (int j = gt; j < n; j += NT) {
      if (live) {
        cp_async(Yr + j, Y0 + bn + j);
        if constexpr (AVG)
          Yr[np + j] = T(0);
        else
          cp_async(Yr + np + j, Ya + bn + j);
        if (qrow) cp_async(Yr + 3 * np + j, q + bn + j);
      } else {
        Yr[j] = T(0);
        Yr[np + j] = T(0);
        if (qrow) Yr[3 * np + j] = T(0);
      }
    }
    for (int i = m + gt; i < mp; i += NT) Lr[i] = T(0);
    for (int i = gt; i < m; i += NT) {
      if (live) {
        cp_async(Lr + i, L0 + bm + i);
        if constexpr (AVG)
          Lr[mp + i] = T(0);
        else
          cp_async(Lr + mp + i, La + bm + i);
        cp_async(Lr + 2 * mp + i, ht + bm + i);
      } else {
        Lr[i] = T(0);
        Lr[mp + i] = T(0);
        Lr[2 * mp + i] = T(0);
      }
    }
    tau[r] = live ? static_cast<const T*>(a.tau)[row0 + r] : T(0);
    sig[r] = live ? static_cast<const T*>(a.sig)[row0 + r] : T(0);
    kh[r] = live && !AVG ? static_cast<const T*>(a.kh)[row0 + r] : T(0);
  }
  cp_wait_all();
  __syncthreads();
  if (nrows <= 0) return;       // a group past the panel: nothing to do

  T* Yout = static_cast<T*>(a.Yout);
  T* Lout = static_cast<T*>(a.Lout);
  T* Yout2 = static_cast<T*>(a.Yout2);
  T* Lout2 = static_cast<T*>(a.Lout2);
  const T cnt = static_cast<T>(n_inner);
  const int mw = warp < m ? (m - warp + W - 1) / W : 0;  // this warp's rows
  // the tiny layout: this thread's column of K in registers
  T kc[TINY ? kLaneM : 1];
  if constexpr (TINY) {
#pragma unroll
    for (int i = 0; i < kLaneM; ++i)
      kc[i] = gt < kLaneN ? Ks[i * ldk + gt] : T(0);
  }

  for (int t = 0; t < n_inner; ++t) {
    const bool last = t == n_inner - 1;
    T w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = AVG ? T(0) : halpern_w(kh[r], t);

    // primal phase: a thread per column, G = q - L K
    for (int j = gt; j < n; j += NT) {
      T acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = T(0);
      if constexpr (TINY) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          T l[kLaneM];
#pragma unroll
          for (int i = 0; i < kLaneM; i += 4) ld4(Lof(r) + i, l + i);
#pragma unroll
          for (int i = 0; i < kLaneM; ++i)
            acc[r] = fma_rn(l[i], kc[i], acc[r]);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < mp; i += 4) {
          const T k0 = Ks[i * ldk + j];
          const T k1 = Ks[(i + 1) * ldk + j];
          const T k2 = Ks[(i + 2) * ldk + j];
          const T k3 = Ks[(i + 3) * ldk + j];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            T l[4];
            ld4(Lof(r) + i, l);
            acc[r] = fma_rn(l[0], k0, acc[r]);
            acc[r] = fma_rn(l[1], k1, acc[r]);
            acc[r] = fma_rn(l[2], k2, acc[r]);
            acc[r] = fma_rn(l[3], k3, acc[r]);
          }
        }
      }
      const T lo = lbs[j];
      const T hi = ubs[j];
      const T qsh = qrow ? T(0) : qs[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T* Yr = Yof(r);
        const T y = Yr[j];
        const T y1 = primal_y1(y, tau[r], qrow ? Yr[3 * np + j] : qsh,
                               acc[r], lo, hi);
        const T yb = reflect(y1, y);
        Yr[2 * np + j] = yb;
        const size_t gi = static_cast<size_t>(row0 + r) * n + j;
        if constexpr (AVG) {
          const T s = add_rn(Yr[np + j], y1);
          Yr[j] = y1;
          Yr[np + j] = s;
          if (last && r < nrows) {
            Yout[gi] = y1;
            Yout2[gi] = div_rn(s, cnt);
          }
        } else {
          const T yn = blend(w[r], yb, Yr[np + j]);
          Yr[j] = yn;
          if (last && r < nrows) {
            Yout[gi] = yn;
            Yout2[gi] = y1;
          }
        }
      }
    }
    group_sync(W, g);

    // the dual epilogue of constraint row i of batch row r, given its
    // product s = (Yb K^T)_i
    auto dual_out = [&](int i, int r, T s) {
      T sg = sig[0], wr = w[0];
#pragma unroll
      for (int rr = 1; rr < R; ++rr)
        if (r == rr) {
          sg = sig[rr];
          wr = w[rr];
        }
      T* Lr = Lof(r);
      const T l = Lr[i];
      const T l1 = dual_l1(l, sg, Lr[2 * mp + i], s, eqs[i] != 0);
      const size_t gi = static_cast<size_t>(row0 + r) * m + i;
      if constexpr (AVG) {
        const T sum = add_rn(Lr[mp + i], l1);
        Lr[i] = l1;
        Lr[mp + i] = sum;
        if (last) {
          Lout[gi] = l1;
          Lout2[gi] = div_rn(sum, cnt);
        }
      } else {
        const T ln = blend(wr, reflect(l1, l), Lr[mp + i]);
        Lr[i] = ln;
        if (last) {
          Lout[gi] = ln;
          Lout2[gi] = l1;
        }
      }
    };

    if constexpr (TINY) {
      // dual phase, a thread per (row, batch row) item: the 32 lane
      // partials and warp_sum's tree of them, in registers
      for (int e = gt; e < m * R; e += NT) {
        const int i = e / R;
        const int r = e - i * R;
        if (r < nrows)
          dual_out(i, r, tiny_dual_sum(Ks + i * ldk, Yof(r) + 2 * np));
      }
    } else {
      // dual phase: this warp's constraint rows i = warp + W k, NI at a
      // time, S = ht - Yb K^T
      for (int c0 = 0; c0 < mw; c0 += NI) {
        T p[kItems];
#pragma unroll
        for (int e = 0; e < kItems; ++e) p[e] = T(0);
#pragma unroll 4
        for (int j = lane; j < n; j += 32) {
          T yb[R];
#pragma unroll
          for (int r = 0; r < R; ++r) yb[r] = Yof(r)[2 * np + j];
#pragma unroll
          for (int ri = 0; ri < NI; ++ri) {
            if (c0 + ri < mw) {
              const T k = Ks[(warp + W * (c0 + ri)) * ldk + j];
#pragma unroll
              for (int r = 0; r < R; ++r)
                p[ri * R + r] = fma_rn(k, yb[r], p[ri * R + r]);
            }
          }
        }
        reduce_scatter<kItems, kItems, 16>(p, lane);
        const int e = lane >> SHIFT;
        const int ri = e / R;
        const int r = e - ri * R;
        if ((lane & ((1 << SHIFT) - 1)) == 0 && c0 + ri < mw && r < nrows)
          dual_out(warp + W * (c0 + ri), r, p[0]);
      }
    }
    group_sync(W, g);
  }
}

// the plan's (W, R, G) at these shapes, or false
inline bool admits(int W, int R, int G, int m, int n, int itemsize,
                   int q_per_row) {
  return (W == 1 || W == 2 || W == 4 || W == 8 || W == 16) &&
         (R == 1 || R == 2 || R == 4) && G >= 1 && G * W <= kMaxWarps &&
         m > 0 && n > 0 &&
         smem_bytes(R, G, m, n, itemsize, q_per_row) <= kSmemMax;
}

// One round: ceil(B / (G R)) blocks of G groups of W warps, R batch rows
// a group; returns cudaError_t
template <typename T, bool AVG>
int launch(int W, int R, int G, const Args& a) {
  if (!admits(W, R, G, a.m, a.n, sizeof(T), a.q_per_row) || a.B <= 0 ||
      a.n_inner <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      smem_bytes(R, G, a.m, a.n, sizeof(T), a.q_per_row);
  auto kernel = tiny(a.m, a.n)
                    ? (R == 4 ? small_round<T, AVG, 4, true>
                              : (R == 2 ? small_round<T, AVG, 2, true>
                                        : small_round<T, AVG, 1, true>))
                    : (R == 4 ? small_round<T, AVG, 4, false>
                              : (R == 2 ? small_round<T, AVG, 2, false>
                                        : small_round<T, AVG, 1, false>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = G * R;
  const int grid = (a.B + per_block - 1) / per_block;
  kernel<<<grid, 32 * W * G, smem, static_cast<cudaStream_t>(a.stream)>>>(
      a, W, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pdhg_small
