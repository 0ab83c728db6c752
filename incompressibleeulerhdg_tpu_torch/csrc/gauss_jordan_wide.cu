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
//     A[i, j] -= f[i] * row_k[j]
//     A[:, k]  = -f * (1/p);  A[k, :] = row_k
// with the products and the difference rounded apart (no FMA contraction),
// as PyTorch's elementwise operations round them: on the same inputs the
// kernel and the plain version give the same bits.
//
// What bounds it on the card: n^3 FMAs a block against 2 n^2 entries of
// traffic, 22.5 FLOP a byte at n = 90 in float32, just above the H100's 20
// (67 TFLOP/s over 3.35 TB/s): at (90, 90, 32768) the bytes take 0.634 ms
// and the arithmetic 0.713 ms.  K5's register tiles stop at n = 72 (a
// 10x10 float64 tile would take 200 registers for the tile alone, and the
// pivot loop, unrolled over N, sets nvcc's time for that library).
//
// What the design does about it, for a simple kernel that is right at any
// n (two instantiations a scalar type, one a memory path; a later redesign
// may tile registers):
// - a thread block holds G consecutive batch entries in shared memory as
//   [n][n][G], G as large as 232,448 B allows (the entries and the pivot
//   buffers below); each load and store of a table entry covers the G
//   entries of one run, and every entry is read once and written once;
// - a thread owns work items (j, g): column j of batch entry g, over the
//   rows i = r, r + RS, ... (RS row slices, so a block has enough threads
//   when n G is small); consecutive threads hold consecutive (j, g), so a
//   warp's shared-memory accesses are consecutive words;
// - pivot k's row and column are read from a buffer, not from the block:
//   the thread that writes the new A[k + 1, j] or A[i, k + 1] also writes it
//   into the buffer of pivot k + 1 (two buffers in turn), so each pivot
//   updates every entry with one barrier;
// - where even G = 1 does not fit (float64 n > 168, from k = 11; float32
//   n > 239), the same kernel works in place on its output buffer in device
//   memory (G = 16 consecutive entries a block, so a warp's accesses still
//   run over consecutive blocks; 2, 4 and 8 were slower on the H100) and stages only the pivot buffers: slow,
//   but the card then has no width limit.
#include <type_traits>

#include "common.cuh"

constexpr int GJW_SMEM_MAX = 232448;
constexpr int GJW_THREADS_MAX = 1024;
constexpr int GJW_G_DEVICE = 16;  // batch entries a block on the device-memory path

// plan: {G, row slices RS, threads, shared bytes, 1 = blocks in shared memory}
static int gjw_plan(int n, int size, int* plan) {
  const long long entries = (long long)n * n, buffers = 4LL * n;  // 2 x (row + column)
  long long G = GJW_SMEM_MAX / ((entries + buffers) * size);
  const int in_smem = G >= 1;
  if (!in_smem) {
    G = GJW_SMEM_MAX / (buffers * size);
    if (G < 1) return (int)cudaErrorInvalidValue;
    G = G < GJW_G_DEVICE ? G : GJW_G_DEVICE;
  }
  const long long items = (long long)n * G;
  long long rs = GJW_THREADS_MAX / items;
  rs = rs < 1 ? 1 : rs > n ? n : rs;
  long long threads = items * rs;
  threads = threads > GJW_THREADS_MAX ? GJW_THREADS_MAX : (threads + 31) / 32 * 32;
  plan[0] = (int)G;
  plan[1] = (int)rs;
  plan[2] = (int)threads;
  plan[3] = (int)(((in_smem ? entries : 0) + buffers) * G * size);
  plan[4] = in_smem;
  return 0;
}

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b);
template <>
__device__ __forceinline__ float mul_rn<float>(float a, float b) { return __fmul_rn(a, b); }
template <>
__device__ __forceinline__ double mul_rn<double>(double a, double b) { return __dmul_rn(a, b); }

// entry (i, j) of pivot k's update, from its old value a, f = A[i, k] and
// row_k[j] (rkj)
template <typename T>
__device__ __forceinline__ T pivot_update(T a, T f, T rkj, T inv_p, int i, int j, int k) {
  if (i == k) return rkj;
  if (j == k) return -mul_rn(f, inv_p);
  return a - mul_rn(f, rkj);
}

// IN_SMEM: the G blocks of the thread block lie in shared memory as
// [n][n][G] (int offsets); else in place in `out` (stride B, 64-bit offsets)
template <typename T, bool IN_SMEM>
__global__ void __launch_bounds__(GJW_THREADS_MAX) gauss_jordan_wide_kernel(
    const T* __restrict__ A, T* __restrict__ out, int n, long long B, int G, int RS) {
  using I = std::conditional_t<IN_SMEM, int, long long>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // [2][n][G] rows, then [2][n][G] columns
  T* prow = buf;
  T* pcol = buf + 2 * n * G;
  const long long b0 = (long long)blockIdx.x * G;
  T* W;
  if constexpr (IN_SMEM) W = buf + 4 * n * G; else W = out + b0;
  const I S = IN_SMEM ? (I)G : (I)B;  // stride of an entry (i, j)
  const I rstride = (I)n * S;         // stride of a row
  const int items = n * G;
  const int nt = blockDim.x;

  // load (the tail past B as the identity, never stored), and publish
  // pivot 0's row and column
  for (int t = threadIdx.x; t < items * RS; t += nt) {
    const int g = t % G, j = (t / G) % n, r = t / items;
    const bool live = b0 + g < B;
    for (int i = r; i < n; i += RS) {
      const long long e = (long long)i * n + j;
      const T v = live ? A[e * B + b0 + g] : T(i == j);
      if (IN_SMEM || live) W[i * rstride + j * S + g] = v;
      if (i == 0) prow[j * G + g] = v;
      if (j == 0) pcol[i * G + g] = v;
    }
  }
  for (int k = 0; k < n; ++k) {
    __syncthreads();
    const int q = k & 1, qn = q ^ 1;
    const T* rk_ = prow + q * n * G;
    const T* fk_ = pcol + q * n * G;
    T* rn_ = prow + qn * n * G;
    T* fn_ = pcol + qn * n * G;
    for (int t = threadIdx.x; t < items * RS; t += nt) {
      const int g = t % G, j = (t / G) % n, r = t / items;
      if (!IN_SMEM && b0 + g >= B) continue;
      const T inv_p = T(1) / rk_[k * G + g];
      const T rkj = j == k ? inv_p : mul_rn(rk_[j * G + g], inv_p);
      T* w = W + j * S + g;  // entry (0, j) of block g
      const T* f = fk_ + g;
      int i = r;
      // four rows at a time, loads first (the compiler cannot move a load
      // above the store of an earlier row: both are shared memory)
      for (; i + 3 * RS < n; i += 4 * RS) {
        T fv[4], wv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          fv[u] = f[(i + u * RS) * G];
          wv[u] = w[(i + u * RS) * rstride];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int iu = i + u * RS;
          const T v = pivot_update(wv[u], fv[u], rkj, inv_p, iu, j, k);
          w[iu * rstride] = v;
          if (iu == k + 1) rn_[j * G + g] = v;
          if (j == k + 1) fn_[iu * G + g] = v;
        }
      }
      for (; i < n; i += RS) {
        const T v = pivot_update(w[i * rstride], f[i * G], rkj, inv_p, i, j, k);
        w[i * rstride] = v;
        if (i == k + 1) rn_[j * G + g] = v;
        if (j == k + 1) fn_[i * G + g] = v;
      }
    }
  }
  if constexpr (IN_SMEM) {
    for (int t = threadIdx.x; t < items * RS; t += nt) {
      const int g = t % G, j = (t / G) % n, r = t / items;
      if (b0 + g >= B) continue;
      for (int i = r; i < n; i += RS)
        out[((long long)i * n + j) * B + b0 + g] = W[i * rstride + j * S + g];
    }
  }
}

template <typename T>
static int launch(int n, const void* A, void* out, long long B, cudaStream_t st) {
  int p[5];
  const int e = gjw_plan(n, (int)sizeof(T), p);
  if (e) return e;
  static bool attr = false;  // the cap only: a launch takes the bytes it asks for
  if (!attr) {
    cudaError_t a = cudaFuncSetAttribute(gauss_jordan_wide_kernel<T, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         GJW_SMEM_MAX);
    if (a == cudaSuccess)
      a = cudaFuncSetAttribute(gauss_jordan_wide_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, GJW_SMEM_MAX);
    if (a != cudaSuccess) return (int)a;
    attr = true;
  }
  const unsigned int nb = blocks_for(B, p[0]);
  if (p[4])
    gauss_jordan_wide_kernel<T, true><<<nb, p[2], p[3], st>>>((const T*)A, (T*)out, n, B, p[0],
                                                              p[1]);
  else
    gauss_jordan_wide_kernel<T, false><<<nb, p[2], p[3], st>>>((const T*)A, (T*)out, n, B, p[0],
                                                               p[1]);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 float64.  A and out (n, n, B) contiguous, B >= 1.
IEHDG_EXPORT int iehdg_gauss_jordan_wide(int device, int dtype, int n, const void* A,
                                         void* out, long long B, void* stream) {
  if (n < 1 || B < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(n, A, out, B, st) : launch<double>(n, A, out, B, st);
}

// The launch plan of block size n: {G, RS, threads, shared bytes, in shared memory}.
IEHDG_EXPORT int iehdg_gauss_jordan_wide_plan(int dtype, int n, int* plan) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  return gjw_plan(n, dtype == 0 ? 4 : 8, plan);
}
