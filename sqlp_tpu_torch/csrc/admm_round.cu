// ADMM check interval of the SD master QP, the master resident in a
// thread-block cluster's shared memory (Hopper, sm_90a).
//
// Replaces: sqlp_tpu/ops/pallas/admm_kernel.py, admm_round_pallas (body
// _kernel). One launch runs n_inner OSQP-style ADMM steps on the scaled
// master of every QP in the batch; per step
//
//   rhs  = sigma z - g + As^T (rho zeta - mu)
//   x    = Minv rhs;  x += Minv (rhs - M x)      (one refinement step)
//   v    = alpha As x + (1 - alpha) zeta
//   zeta = clip(v + mu / rho, l, u)
//   mu  += rho (v - zeta),  z = x
//
// What bounds it on this card: the master is tiny (ssn nz = 90, mA = 187;
// storm nz = 122, mA = 403 at K = 96) and its steps are strictly
// sequential: each is a chain of five dependent mat-vec products, so its
// cost is latency. The TPU kernel keeps As, M and Minv in VMEM for the
// whole interval (admm_kernel.py:8-11). In f64 they take about 272 KB for
// ssn and 646 KB for storm, more than one block's 227 KB, so a single
// block would re-read them from L2 at every step. The design:
//
// - One cluster of C CTAs per QP (the grid is nb clusters, so R masters of
//   the replicated path take one launch). ops/cuda/admm_kernel.py:_plan
//   picks C from the shapes: 8 for the ssn and storm masters, 1 for small
//   masters such as lands' (each measured fastest); C = 1 runs on block
//   barriers alone.
// - Matrices resident: CTA c owns a row slice of As (and of zeta, mu, rho,
//   lc, uc) and a row slice of M and of Minv, loaded once per launch. Row
//   strides are padded to 8 mod 32 elements so the four 8-lane groups of
//   a warp read four rows from disjoint banks.
// - Per step: each CTA forms As^T w over its own rows; the nz partials go
//   through distributed shared memory and every CTA sums them in rank
//   order 0..C-1 (so all CTAs hold bitwise-identical copies of rhs, x and
//   z, and a seeded run stays deterministic). The three nz x nz products
//   each compute their own rows and store them into every CTA's copy of
//   the result over DSMEM, followed by one cluster barrier; As x computes
//   its own rows and the zeta / mu updates stay local. Four cluster
//   barriers and two block barriers per step; with C = 1 all six are
//   block barriers.
// - Products: an 8-lane group per output element, lanes over the inner
//   dimension, a butterfly shuffle sum (every lane of the group ends with
//   the same bits, and lane c stores the result into CTA c).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kGroup = 8;                      // lanes per output element
constexpr int kGroups = kThreads / kGroup;
constexpr int kMaxCluster = 8;

template <typename T>
__device__ __forceinline__ T group_allsum(T v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// out_j = sum_k A[j * rs + k * cs] v[k] for j < rows, k < cols: a group
// per output j, lanes over k; fn(j, out_j) runs in every lane of j's
// group. The loop bound is the same for every thread, so all 32 lanes of
// a warp reach each shuffle.
template <typename T, typename F>
__device__ __forceinline__ void group_products(const T* A, int rs, int cs,
                                               const T* v, int rows,
                                               int cols, int grp, int gl,
                                               F&& fn) {
  for (int j0 = 0; j0 < rows; j0 += kGroups) {
    const int j = j0 + grp;
    T acc = T(0);
    if (j < rows) {
      const T* Aj = A + j * rs;
#pragma unroll 4
      for (int k = gl; k < cols; k += kGroup) acc += Aj[k * cs] * v[k];
    }
    acc = group_allsum(acc);
    if (j < rows) fn(j, acc);
  }
}

// row stride (elements) of the resident matrices: nz padded to 8 mod 32
__host__ __device__ inline int padded_stride(int nz) {
  return nz + ((8 - nz % 32) + 32) % 32;
}

// shared-memory footprint in elements of T (mirrored by
// ops/cuda/admm_kernel.py:_smem_bytes)
__host__ __device__ inline size_t admm_smem_elems(int C, int mA, int nz) {
  const size_t s = padded_stride(nz);
  const size_t ra = (mA + C - 1) / C;
  const size_t rm = (nz + C - 1) / C;
  return ra * s + 2 * rm * s + 6 * static_cast<size_t>(nz) + 6 * ra;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
admm_cluster_kernel(const T* __restrict__ As, const T* __restrict__ M,
                    const T* __restrict__ Minv, const T* __restrict__ g,
                    const T* __restrict__ lc, const T* __restrict__ uc,
                    const T* __restrict__ rho, const T* __restrict__ z0,
                    const T* __restrict__ zeta0, const T* __restrict__ mu0,
                    T* __restrict__ zout, T* __restrict__ zetaout,
                    T* __restrict__ muout, int mA, int nz, int n_inner,
                    T alpha, T sigma, int C) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int b = blockIdx.x / C;
  const int s = padded_stride(nz);
  const int ra = (mA + C - 1) / C;
  const int a0 = rank * ra;
  const int na = max(0, min(ra, mA - a0));     // own rows of As
  const int rm = (nz + C - 1) / C;
  const int m0 = rank * rm;
  const int nm = max(0, min(rm, nz - m0));     // own rows of M, Minv
  const int tid = threadIdx.x;
  const int grp = tid / kGroup;
  const int gl = tid % kGroup;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ass = reinterpret_cast<T*>(smem_raw);     // [ra][s] own rows of As
  T* Ms = Ass + static_cast<size_t>(ra) * s;   // [rm][s] own rows of M
  T* Mis = Ms + static_cast<size_t>(rm) * s;   // [rm][s] own rows of Minv
  T* z = Mis + static_cast<size_t>(rm) * s;    // [nz] full copies
  T* rhs = z + nz;
  T* xa = rhs + nz;
  T* rb = xa + nz;
  T* ex = rb + nz;                             // this CTA's As^T w partial
  T* gs = ex + nz;
  T* zeta = gs + nz;                           // [ra] own rows
  T* mu = zeta + ra;
  T* rhos = mu + ra;
  T* lcs = rhos + ra;
  T* ucs = lcs + ra;
  T* w = ucs + ra;

  As += static_cast<size_t>(b) * mA * nz;
  M += static_cast<size_t>(b) * nz * nz;
  Minv += static_cast<size_t>(b) * nz * nz;
  for (int idx = tid; idx < na * nz; idx += kThreads) {
    const int i = idx / nz;
    const int k = idx - i * nz;
    Ass[i * s + k] = As[static_cast<size_t>(a0 + i) * nz + k];
  }
  for (int idx = tid; idx < nm * nz; idx += kThreads) {
    const int j = idx / nz;
    const int k = idx - j * nz;
    Ms[j * s + k] = M[static_cast<size_t>(m0 + j) * nz + k];
    Mis[j * s + k] = Minv[static_cast<size_t>(m0 + j) * nz + k];
  }
  for (int k = tid; k < nz; k += kThreads) {
    z[k] = z0[static_cast<size_t>(b) * nz + k];
    gs[k] = g[static_cast<size_t>(b) * nz + k];
  }
  for (int i = tid; i < na; i += kThreads) {
    const size_t gi = static_cast<size_t>(b) * mA + a0 + i;
    zeta[i] = zeta0[gi];
    mu[i] = mu0[gi];
    rhos[i] = rho[gi];
    lcs[i] = lc[gi];
    ucs[i] = uc[gi];
    w[i] = rho[gi] * zeta0[gi] - mu0[gi];
  }
  // remote copies this lane stores into (lane gl < C serves CTA gl)
  T* xa_to = xa;
  T* rb_to = rb;
  T* z_to = z;
  if (C > 1) {
    const unsigned dst = gl < C ? gl : 0;
    xa_to = cluster.map_shared_rank(xa, dst);
    rb_to = cluster.map_shared_rank(rb, dst);
    z_to = cluster.map_shared_rank(z, dst);
    cluster.sync();   // every CTA of the cluster is running
  } else {
    __syncthreads();
  }
  const bool stores = gl < C;

  auto cluster_barrier = [&]() {
    if (C > 1) cluster.sync(); else __syncthreads();
  };

  for (int t = 0; t < n_inner; ++t) {
    // As^T w over this CTA's rows: a group per column, lanes over rows
    group_products(Ass, 1, s, w, nz, na, grp, gl, [&](int j, T acc) {
      if (gl == 0) ex[j] = acc;
    });
    cluster_barrier();
    // rhs = sigma z - g + the C partials in rank order
    for (int k = tid; k < nz; k += kThreads) {
      T part[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        part[c] = c < C ? (C > 1 ? cluster.map_shared_rank(ex, c)[k] : ex[k])
                        : T(0);
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        if (c < C) acc += part[c];
      rhs[k] = sigma * z[k] - gs[k] + acc;
    }
    __syncthreads();
    // x = Minv rhs, own rows, into every CTA
    group_products(Mis, s, 1, rhs, nm, nz, grp, gl, [&](int j, T acc) {
      if (stores) xa_to[m0 + j] = acc;
    });
    cluster_barrier();
    // residual rhs - M x, own rows, into every CTA
    group_products(Ms, s, 1, xa, nm, nz, grp, gl, [&](int j, T acc) {
      if (stores) rb_to[m0 + j] = rhs[m0 + j] - acc;
    });
    cluster_barrier();
    // z = x + Minv residual, own rows, into every CTA
    group_products(Mis, s, 1, rb, nm, nz, grp, gl, [&](int j, T acc) {
      if (stores) z_to[m0 + j] = xa[m0 + j] + acc;
    });
    cluster_barrier();
    // As z over own rows, then this row's zeta / mu / w
    group_products(Ass, s, 1, z, na, nz, grp, gl, [&](int i, T acc) {
      if (gl == 0) {
        const T v = alpha * acc + (T(1) - alpha) * zeta[i];
        const T r = rhos[i];
        const T c = v + mu[i] / r;
        const T lo = lcs[i];
        const T hi = ucs[i];
        const T z1 = c < lo ? lo : (c > hi ? hi : c);
        const T mu1 = mu[i] + r * (v - z1);
        zeta[i] = z1;
        mu[i] = mu1;
        w[i] = r * z1 - mu1;
      }
    });
    __syncthreads();
  }

  if (rank == 0)
    for (int k = tid; k < nz; k += kThreads)
      zout[static_cast<size_t>(b) * nz + k] = z[k];
  for (int i = tid; i < na; i += kThreads) {
    const size_t gi = static_cast<size_t>(b) * mA + a0 + i;
    zetaout[gi] = zeta[i];
    muout[gi] = mu[i];
  }
  // no CTA leaves while another may still read or write its copies
  if (C > 1) cluster.sync();
}

template <typename T>
int launch(int C, const void* As, const void* M, const void* Minv,
           const void* g, const void* lc, const void* uc, const void* rho,
           const void* z, const void* zeta, const void* mu, void* zout,
           void* zetaout, void* muout, int nb, int mA, int nz, int n_inner,
           double alpha, double sigma, void* stream) {
  if (C < 1 || C > kMaxCluster || (C & (C - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = admm_smem_elems(C, mA, nz) * sizeof(T);
  auto kernel = admm_cluster_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(As), static_cast<const T*>(M),
      static_cast<const T*>(Minv), static_cast<const T*>(g),
      static_cast<const T*>(lc), static_cast<const T*>(uc),
      static_cast<const T*>(rho), static_cast<const T*>(z),
      static_cast<const T*>(zeta), static_cast<const T*>(mu),
      static_cast<T*>(zout), static_cast<T*>(zetaout),
      static_cast<T*>(muout), mA, nz, n_inner, static_cast<T>(alpha),
      static_cast<T>(sigma), C);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// one interval for nb QPs, a cluster of C CTAs each; returns cudaError_t
int admm_round_f32(int C, const void* As, const void* M, const void* Minv,
                   const void* g, const void* lc, const void* uc,
                   const void* rho, const void* z, const void* zeta,
                   const void* mu, void* zout, void* zetaout, void* muout,
                   int nb, int mA, int nz, int n_inner, double alpha,
                   double sigma, void* stream) {
  return launch<float>(C, As, M, Minv, g, lc, uc, rho, z, zeta, mu, zout,
                       zetaout, muout, nb, mA, nz, n_inner, alpha, sigma,
                       stream);
}

int admm_round_f64(int C, const void* As, const void* M, const void* Minv,
                   const void* g, const void* lc, const void* uc,
                   const void* rho, const void* z, const void* zeta,
                   const void* mu, void* zout, void* zetaout, void* muout,
                   int nb, int mA, int nz, int n_inner, double alpha,
                   double sigma, void* stream) {
  return launch<double>(C, As, M, Minv, g, lc, uc, rho, z, zeta, mu, zout,
                        zetaout, muout, nb, mA, nz, n_inner, alpha, sigma,
                        stream);
}

}  // extern "C"
