// K4: unpivoted in-place Gauss-Jordan inverse of a batch of (n, n) blocks
// stored batch-last as (n, n, B), n <= 32.
//
// Replaces the Pallas kernel incompressibleeulerhdg_tpu/linalg/smallinv.py
// `_gj_pallas` (kernel body `_gj_pallas_kernel_factory`).  Callers are the
// per-stage tentative-operator build: the own-cell block inverses and the
// per-colour patch Schur inverses (n = nu = 20 at k=2; B = nc or the colour
// size), twice per SSP2 step.
//
// What bounds it on the card: n^3 = 8000 FMAs per 20x20 block against
// 2 n^2 * 4 B = 3.2 KB of traffic (float32), about 2.5 FLOP per byte, so
// bandwidth and latency of the loads, not arithmetic, set the time.  At
// 256^2, k=2 one build inverts 131072 + 3 * 65.5k blocks: about 0.5 GB in
// and 0.5 GB out.
//
// What the design does about it: a 20x20 block is 400 values, more than a
// thread's 255 registers, so one warp owns one block with one row per lane
// (n <= 32 registers a lane) and the pivot row is broadcast by __shfl_sync;
// the block is read from and written to device memory exactly once.  The
// pivot and column loops are unrolled to 32 with uniform `< n` guards, so
// one instantiation per scalar type serves every n <= 32.  Rows of one
// block lie n*B elements apart in the batch-last layout, so a warp's loads
// touch n sectors; the neighbouring warps of a block read the rest of those
// sectors, which L1/L2 then serve.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(128) gauss_jordan_kernel(
    const T* __restrict__ A, T* __restrict__ out, int n, long long B) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long b = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (b >= B) return;  // uniform across the warp
  const bool row_ok = lane < n;
  T a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j)
    a[j] = (row_ok && j < n) ? A[((long long)lane * n + j) * B + b] : T(0);

#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k < n) {
      const T inv_p = T(1) / __shfl_sync(FULL, a[k], k);
      const T f = a[k];  // this row's entry in the pivot column
      const bool pivot_row = lane == k;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j < n) {
          // normalised pivot row entry (row k of the result)
          const T rk = (j == k) ? inv_p : __shfl_sync(FULL, a[j], k) * inv_p;
          if (pivot_row) {
            a[j] = rk;
          } else if (j == k) {
            a[j] = -f * inv_p;
          } else {
            a[j] = a[j] - f * rk;
          }
        }
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j < n) out[((long long)lane * n + j) * B + b] = a[j];
  }
}

// dtype: 0 float32, 1 float64.  A and out (n, n, B) contiguous, n <= 32.
IEHDG_EXPORT int iehdg_gauss_jordan(int device, int dtype, int n, const void* A,
                                    void* out, long long B, void* stream) {
  if (n < 1 || n > 32) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 128;  // four blocks (warps) per thread block
  const unsigned int grid = blocks_for(B * 32, threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    gauss_jordan_kernel<float><<<grid, threads, 0, st>>>((const float*)A, (float*)out, n, B);
  else if (dtype == 1)
    gauss_jordan_kernel<double><<<grid, threads, 0, st>>>((const double*)A, (double*)out, n, B);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
