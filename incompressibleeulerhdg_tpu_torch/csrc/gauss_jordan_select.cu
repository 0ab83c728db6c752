// K5: unpivoted in-place Gauss-Jordan inverse of a batch of (n, n) blocks
// stored batch-last as (n, n, B), n <= 48, in the masked-select formulation.
//
// Replaces the Pallas kernel tools/microbench_gj.py `_gj_old` (kernel body
// `_gj_old_kernel_factory`): at each pivot k the whole block is updated,
//
//     row_k = where(j == k, 1/p, A[k, j]/p)       p = A[k, k]
//     f     = where(i == k, 0, A[i, k])
//     A    -= f (x) row_k
//     A[:, k] = -f/p;  A[k, :] = row_k            (by selects)
//
// Callers: `gauss_jordan_inv_bl` for 32 < n <= 48, where the one-row-per-lane
// warp of K4 (csrc/gauss_jordan.cu) has too few lanes -- the own-cell and
// patch Schur inverses of the tentative-operator build at k = 4 (n = 42) --
// and the K4-vs-K5 A/B of tools/microbench_gj.py.
//
// What bounds it on the card: a 42x42 block is 74 KFMA against
// 2 * 42*42*4 B = 14 KB of traffic in float32 (about 10 FLOP a byte), and
// every pivot needs the block's updated pivot row and column, so the blocks
// must stay on chip across all n pivots.  Shared-memory traffic and the two
// barriers a pivot, not device memory, set the time.
//
// What the design does about it: one thread block holds BB consecutive batch
// entries (8 in float32, 4 in float64: 32 bytes, one full sector per table
// entry) of the whole (n, n) table in shared memory, laid out as in device
// memory with the batch index fastest, so the loads and stores coalesce.  At
// n = 48 that is 74 KB (dynamic shared memory, opted in above 48 KB).  Each
// pivot copies row k, column k and 1/p to small buffers, then every thread
// updates its entries with the selects; two barriers a pivot.  The tail of
// the batch is padded with identities in shared memory and never stored.
#include "common.cuh"

#define IEHDG_GJS_MAX_N 48
#define IEHDG_GJS_THREADS 256

template <typename T>
struct SelectBatch {
  static constexpr int value = sizeof(T) == 4 ? 8 : 4;
};

template <typename T>
static size_t select_smem_bytes(int n) {
  constexpr int BB = SelectBatch<T>::value;
  return (size_t)(n * n + 2 * n + 1) * BB * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(IEHDG_GJS_THREADS) gauss_jordan_select_kernel(
    const T* __restrict__ A, T* __restrict__ out, int n, long long B) {
  constexpr int BB = SelectBatch<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // (n, n, BB) block entries
  T* prow = s + n * n * BB;               // (n, BB) pivot row A[k, :]
  T* pcol = prow + n * BB;                // (n, BB) pivot column A[:, k]
  T* pinv = pcol + n * BB;                // (BB,) 1 / A[k, k]
  const long long b0 = (long long)blockIdx.x * BB;
  const int total = n * n * BB;

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int ij = e / BB, b = e % BB;
    const long long col = b0 + b;
    s[e] = col < B ? A[(long long)ij * B + col] : (ij % (n + 1) == 0 ? T(1) : T(0));
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    for (int e = threadIdx.x; e < n * BB; e += blockDim.x) {
      const int i = e / BB, b = e % BB;
      prow[e] = s[(k * n + i) * BB + b];
      pcol[e] = s[(i * n + k) * BB + b];
    }
    if (threadIdx.x < BB) pinv[threadIdx.x] = T(1) / s[(k * n + k) * BB + threadIdx.x];
    __syncthreads();
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int ij = e / BB, b = e % BB;
      const int i = ij / n, j = ij - i * n;
      const T inv_p = pinv[b];
      const T row_kj = (j == k) ? inv_p : prow[j * BB + b] * inv_p;
      const T f = (i == k) ? T(0) : pcol[i * BB + b];
      T v = s[e] - f * row_kj;
      if (j == k) v = -f * inv_p;
      if (i == k) v = row_kj;
      s[e] = v;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int ij = e / BB, b = e % BB;
    const long long col = b0 + b;
    if (col < B) out[(long long)ij * B + col] = s[e];
  }
}

template <typename T>
static int launch(const void* A, void* out, int n, long long B, cudaStream_t st) {
  constexpr int BB = SelectBatch<T>::value;
  const size_t smem = select_smem_bytes<T>(n);
  cudaError_t e = cudaFuncSetAttribute(gauss_jordan_select_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  gauss_jordan_select_kernel<T><<<blocks_for(B, BB), IEHDG_GJS_THREADS, smem, st>>>(
      (const T*)A, (T*)out, n, B);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 float64.  A and out (n, n, B) contiguous, n <= 48.
IEHDG_EXPORT int iehdg_gauss_jordan_select(int device, int dtype, int n, const void* A,
                                           void* out, long long B, void* stream) {
  if (n < 1 || n > IEHDG_GJS_MAX_N) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(A, out, n, B, st);
  if (dtype == 1) return launch<double>(A, out, n, B, st);
  return (int)cudaErrorInvalidValue;
}
