// K5w: unpivoted in-place Gauss-Jordan inverse of a batch of (n, n) blocks
// stored batch-last as (n, n, B), at a block size n given at run time (the
// port launches it above K5's n <= 72: n = 90, 110, 132, 156 at k = 7 .. 10,
// and any n beyond).
//
// Replaces the JAX package's incompressibleeulerhdg_tpu/linalg/smallinv.py
// `gauss_jordan_inv_bl` above its Pallas gate (n <= 48): the jnp pivot loop
// (`fori_loop` over k), which the port's K5 also replaces up to n = 72.
// Callers: the own-cell and the patch Schur inverses of every
// tentative-operator build at k >= 7 (structured, slab-local and
// partition-local tables, the disk's dense build, DG implicit).
//
// Pivot k does the plain version's arithmetic entry by entry
// (linalg/smallinv.py:gauss_jordan_inv_plain), with p = A[k, k]:
//     row_k[j] = A[k, j] * (1/p),  row_k[k] = 1/p
//     f[i]     = A[i, k],          f[k]     = 0
//     A[i, j] -= f[i] * row_k[j]          (one FMA)
//     A[:, k]  = -f * (1/p);  A[k, :] = row_k
//
// What bounds it on the card: n^3 FMAs a block against 2 n^2 entries of
// traffic, 22.5 FLOP a byte at n = 90 in float32, just above the H100's 20
// (67 TFLOP/s over 3.35 TB/s): at (90, 90, 32768) the arithmetic takes
// 0.713 ms and the bytes 0.634 ms.  The pivot loop must therefore run near
// the FMA rate, which a shared-memory access for every FMA rules out (an
// SM issues about one shared-memory instruction a cycle and four warp
// FMAs).
//
// What the design does about it (the plan comes from the Python wrapper,
// linalg/smallinv.py:wide_gj_plan, and arrives as arguments):
// - register tiles, as K4 and K5 (csrc/gauss_jordan.cuh), at a run-time n:
//   a thread holds an R x R tile of one block (R a compile-time constant,
//   R in GJW_TILES), the block is TR x TR tiles (TR = ceil(n / R), entries
//   past n start as the identity and are never stored), and a thread block
//   holds BB consecutive batch entries, the entry fastest in threadIdx.x, so
//   a warp's loads and stores run over neighbouring blocks;
// - the pivot loop runs over tile rows at run time and unrolls the R pivots
//   of a tile row, so every register index is a constant (the owner of
//   pivot k + 1's row and column is selected on the unrolled index);
// - the owners of row k and column k, and the owner of (k, k) with 1/p,
//   publish them to shared memory through a double buffer: one barrier a
//   pivot, and R + R + 1 shared loads for R^2 FMAs (tiles padded to an odd
//   stride, so the lanes of a warp hit distinct banks);
// - where one block's tiles exceed the registers of one SM (float64
//   n = 182: 66,248 registers for the block alone), its tile rows are split
//   over a cluster of CS <= 8 thread blocks on neighbouring SMs (a cluster
//   launch, cudaLaunchKernelEx): the owner of row k + 1 and 1/p stores them
//   into every rank's buffer through distributed shared memory
//   (cooperative_groups map_shared_rank), a column stays with its rank, and
//   one cluster barrier a pivot (release/acquire) takes the place of
//   __syncthreads;
// - past a cluster of 8 (float64 n > 384, float32 n > 540 with the tiles
//   below) the blocks are inverted in place in device memory by the
//   runtime-width pivot loop of `gauss_jordan_wide_dev_kernel` (G = 16
//   consecutive entries a block, pivot row and column from a shared double
//   buffer): slow, but the card then has no width limit.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int GJW_SMEM_MAX = 232448;
constexpr int GJW_CLUSTER_MAX = 8;   // the portable cluster size
constexpr int GJW_DEV_THREADS = 1024;

// The register tiles: R x R a thread, at most MAXT threads a thread block,
// so ptxas may give a thread 65,536 / MAXT registers (the Python plan reads
// the same table: linalg/smallinv.py WIDE_GJ_TILES).
#define GJW_TILES(X)                                            \
  X(float, 6, 640) X(float, 8, 512) X(float, 9, 448) X(float, 10, 384) \
  X(double, 4, 640) X(double, 6, 448) X(double, 8, 320)

// Publish pivot k's row (tile row t, local row L), column (tile column t,
// local column L) and 1/p into buffer q.  CL: the row and 1/p go to every
// rank of the cluster.
template <typename T, int R, bool CL>
__device__ __forceinline__ void gjw_publish(const T (&a)[R][R], int L, int t, int q, int tr,
                                            int tc, bool act, T* rowb, T* colb, T* invb,
                                            int BUF, int TS, int BB, int b, int CS) {
  if (!act) return;
  if (tr == t) {
    const int o = q * BUF + tc * TS + b;
    const bool diag = tc == t;
    const T inv = diag ? T(1) / a[L][L] : T(0);
    if constexpr (CL) {
      cg::cluster_group cl = cg::this_cluster();
      for (int r = 0; r < CS; ++r) {
        T* rr = cl.map_shared_rank(rowb, r);
#pragma unroll
        for (int lj = 0; lj < R; ++lj) rr[o + lj * BB] = a[L][lj];
        if (diag) cl.map_shared_rank(invb, r)[q * BB + b] = inv;
      }
    } else {
#pragma unroll
      for (int lj = 0; lj < R; ++lj) rowb[o + lj * BB] = a[L][lj];
      if (diag) invb[q * BB + b] = inv;
    }
  }
  if (tc == t) {
    const int o = q * BUF + tr * TS + b;
#pragma unroll
    for (int li = 0; li < R; ++li) colb[o + li * BB] = a[li][L];
  }
}

template <bool CL>
__device__ __forceinline__ void gjw_sync() {
  if constexpr (CL)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Register-tiled pivot loop.  A thread block (a cluster rank, CL) holds the
// tile rows rank * RPC .. of BB consecutive batch entries (cluster `grp`).
template <typename T, int R, int MAXT, bool CL>
__global__ void __launch_bounds__(MAXT) gauss_jordan_wide_kernel(
    const T* __restrict__ A, T* __restrict__ out, int n, long long B, int BB, int CS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RP = R | 1;  // odd tile stride in a buffer: no bank conflicts
  const int TR = (n + R - 1) / R;
  const int RPC = (TR + CS - 1) / CS;  // tile rows a rank
  const int TS = RP * BB, BUF = TR * TS;
  T* rowb = reinterpret_cast<T*>(smem_raw);  // [2][TR][RP][BB]
  T* colb = rowb + 2 * BUF;                  // [2][TR][RP][BB]
  T* invb = colb + 2 * BUF;                  // [2][BB]
  int rank = 0;
  long long grp = blockIdx.x;
  if constexpr (CL) {
    rank = (int)cg::this_cluster().block_rank();
    grp = blockIdx.x / CS;
  }
  const int b = threadIdx.x % BB, pos = threadIdx.x / BB;
  const int tr = rank * RPC + pos / TR, tc = pos % TR;
  const bool act = tr < TR;  // the last rank may hold fewer tile rows
  const int trc = act ? tr : TR - 1;  // a row of the buffers to read
  const long long col = grp * BB + b;
  const bool live = act && col < B;
  const int i0 = tr * R, j0 = tc * R;

  T a[R][R];
#pragma unroll
  for (int li = 0; li < R; ++li)
#pragma unroll
    for (int lj = 0; lj < R; ++lj) {
      const int i = i0 + li, j = j0 + lj;
      a[li][lj] = (live && i < n && j < n) ? A[((long long)i * n + j) * B + col] : T(i == j);
    }

  if constexpr (CL) cg::this_cluster().sync();  // every rank runs before a remote store
  gjw_publish<T, R, CL>(a, 0, 0, 0, tr, tc, act, rowb, colb, invb, BUF, TS, BB, b, CS);
  for (int kt = 0; kt < TR; ++kt) {
#pragma unroll
    for (int kr = 0; kr < R; ++kr) {
      const int k = kt * R + kr;
      if (k < n) {  // uniform across the cluster
        gjw_sync<CL>();
        const int q = k & 1;
        const T inv_p = invb[q * BB + b];
        const T* rq = rowb + q * BUF + tc * TS + b;
        const T* cq = colb + q * BUF + trc * TS + b;
        const bool own_row = tr == kt, own_col = tc == kt;
        T rk[R], f[R];
#pragma unroll
        for (int lj = 0; lj < R; ++lj) rk[lj] = rq[lj * BB] * inv_p;
#pragma unroll
        for (int li = 0; li < R; ++li) f[li] = cq[li * BB];
        if (own_col) rk[kr] = inv_p;
        if (own_row) f[kr] = T(0);
#pragma unroll
        for (int li = 0; li < R; ++li)
#pragma unroll
          for (int lj = 0; lj < R; ++lj) a[li][lj] -= f[li] * rk[lj];
        if (own_col) {
#pragma unroll
          for (int li = 0; li < R; ++li) a[li][kr] = -f[li] * inv_p;
        }
        if (own_row) {
#pragma unroll
          for (int lj = 0; lj < R; ++lj) a[kr][lj] = rk[lj];
        }
        if (k + 1 < n) {  // pivot k + 1: the next local row, or the next tile row's first
          const int L = kr + 1 < R ? kr + 1 : 0;
          const int t = kr + 1 < R ? kt : kt + 1;
          gjw_publish<T, R, CL>(a, L, t, q ^ 1, tr, tc, act, rowb, colb, invb, BUF, TS, BB, b,
                                CS);
        }
      }
    }
  }
  // the last remote stores (pivot n - 1's row) preceded pivot n - 1's
  // cluster barrier: no rank touches another's shared memory from here on

  if (live) {
#pragma unroll
    for (int li = 0; li < R; ++li)
#pragma unroll
      for (int lj = 0; lj < R; ++lj) {
        const int i = i0 + li, j = j0 + lj;
        if (i < n && j < n) out[((long long)i * n + j) * B + col] = a[li][lj];
      }
  }
}

// Device-memory pivot loop, for blocks past a cluster's registers: the G
// blocks of a thread block are inverted in place in `out` (copied from A
// first); a thread owns work items (j, g), column j of entry g, over the
// rows i = r, r + RS, ...; pivot k's row and column come from a shared
// double buffer that the writers of row and column k + 1 fill.
template <typename T>
__global__ void __launch_bounds__(GJW_DEV_THREADS) gauss_jordan_wide_dev_kernel(
    const T* __restrict__ A, T* __restrict__ out, int n, long long B, int G, int RS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* prow = reinterpret_cast<T*>(smem_raw);  // [2][n][G] rows, then [2][n][G] columns
  T* pcol = prow + 2 * n * G;
  const long long b0 = (long long)blockIdx.x * G;
  T* W = out + b0;
  const int items = n * G;
  const int nt = blockDim.x;
  for (int t = threadIdx.x; t < items * RS; t += nt) {
    const int g = t % G, j = (t / G) % n, r = t / items;
    if (b0 + g >= B) continue;
    for (int i = r; i < n; i += RS) {
      const long long e = ((long long)i * n + j) * B;
      const T v = A[e + b0 + g];
      W[e + g] = v;
      if (i == 0) prow[j * G + g] = v;
      if (j == 0) pcol[i * G + g] = v;
    }
  }
  for (int k = 0; k < n; ++k) {
    __syncthreads();
    const int q = k & 1;
    const T* rk_ = prow + q * n * G;
    const T* fk_ = pcol + q * n * G;
    T* rn_ = prow + (q ^ 1) * n * G;
    T* fn_ = pcol + (q ^ 1) * n * G;
    for (int t = threadIdx.x; t < items * RS; t += nt) {
      const int g = t % G, j = (t / G) % n, r = t / items;
      if (b0 + g >= B) continue;
      const T inv_p = T(1) / rk_[k * G + g];
      const T rkj = j == k ? inv_p : rk_[j * G + g] * inv_p;
      for (int i = r; i < n; i += RS) {
        T* w = W + ((long long)i * n + j) * B + g;
        const T f = fk_[i * G + g];
        const T v = i == k ? rkj : j == k ? -f * inv_p : *w - f * rkj;
        *w = v;
        if (i == k + 1) rn_[j * G + g] = v;
        if (j == k + 1) fn_[i * G + g] = v;
      }
    }
  }
}

template <typename T, int R, int MAXT>
static int launch_tiles(int n, const void* A, void* out, long long B, int BB, int CS,
                        int threads, int smem, cudaStream_t st) {
  const int TR = (n + R - 1) / R;
  const int RPC = (TR + CS - 1) / CS;
  const long long need = (4LL * TR * (R | 1) * BB + 2LL * BB) * (long long)sizeof(T);
  if (threads != BB * RPC * TR || threads > MAXT || smem != need || smem > GJW_SMEM_MAX ||
      CS > GJW_CLUSTER_MAX || (CS > 1 && (CS - 1) * RPC >= TR))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;  // the cap only: a launch takes the bytes it asks for
  if (!attr) {
    cudaError_t a = cudaFuncSetAttribute(gauss_jordan_wide_kernel<T, R, MAXT, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GJW_SMEM_MAX);
    if (a == cudaSuccess)
      a = cudaFuncSetAttribute(gauss_jordan_wide_kernel<T, R, MAXT, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, GJW_SMEM_MAX);
    if (a != cudaSuccess) return (int)a;
    attr = true;
  }
  const unsigned int groups = blocks_for(B, BB);
  if (CS == 1) {
    gauss_jordan_wide_kernel<T, R, MAXT, false><<<groups, threads, smem, st>>>(
        (const T*)A, (T*)out, n, B, BB, 1);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * CS);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CS;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gauss_jordan_wide_kernel<T, R, MAXT, true>,
                                           (const T*)A, (T*)out, n, B, BB, CS);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
static int launch_dev(int n, const void* A, void* out, long long B, int G, int RS, int threads,
                      int smem, cudaStream_t st) {
  if (G < 1 || RS < 1 || threads < 1 || threads > GJW_DEV_THREADS ||
      smem != 4LL * n * G * (long long)sizeof(T) || smem > GJW_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  static bool attr = false;  // the cap only: a launch takes the bytes it asks for
  if (!attr) {
    const cudaError_t a = cudaFuncSetAttribute(gauss_jordan_wide_dev_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               GJW_SMEM_MAX);
    if (a != cudaSuccess) return (int)a;
    attr = true;
  }
  gauss_jordan_wide_dev_kernel<T><<<blocks_for(B, G), threads, smem, st>>>(
      (const T*)A, (T*)out, n, B, G, RS);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(int n, const void* A, void* out, long long B, int path, int R, int BB, int CS,
                  int threads, int smem, cudaStream_t st) {
  if (path == 1) return launch_dev<T>(n, A, out, B, BB, CS, threads, smem, st);
#define IEHDG_GJW_CASE(TT, RR, MT)                                                  \
  if constexpr (std::is_same<T, TT>::value) {                                      \
    if (R == RR) return launch_tiles<T, RR, MT>(n, A, out, B, BB, CS, threads, smem, st); \
  }
  GJW_TILES(IEHDG_GJW_CASE)
#undef IEHDG_GJW_CASE
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 float64.  A and out (n, n, B) contiguous, B >= 1.
// The plan (linalg/smallinv.py:wide_gj_plan): path 0, register tiles R x R
// (R of GJW_TILES), BB batch entries a thread block (a cluster of CS, 1 for
// none), `threads` = BB * ceil(TR / CS) * TR, `smem` the buffers' bytes;
// path 1, device memory, BB = G entries a thread block, CS = RS row slices.
// A plan that does not match returns cudaErrorInvalidValue.
IEHDG_EXPORT int iehdg_gauss_jordan_wide(int device, int dtype, int n, const void* A, void* out,
                                         long long B, int path, int R, int BB, int CS,
                                         int threads, int smem, void* stream) {
  if (n < 1 || B < 1 || BB < 1 || CS < 1 || (dtype != 0 && dtype != 1) ||
      (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(n, A, out, B, path, R, BB, CS, threads, smem, st)
                    : launch<double>(n, A, out, B, path, R, BB, CS, threads, smem, st);
}
