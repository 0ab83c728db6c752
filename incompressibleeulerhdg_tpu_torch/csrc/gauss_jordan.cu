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
// 2 n^2 * 4 B = 3.2 KB of traffic (float32), 5 FLOP per byte, below the
// H100's 20 FLOP per byte (67 TFLOP/s over 3.35 TB/s): device memory sets
// the least time, 0.125 ms for the 131072 own-cell blocks at 256^2, k=2.
// The arithmetic must therefore cost well under the time of the bytes, and
// the loads must coalesce.
//
// What the design does about it (csrc/gauss_jordan.cuh): a thread holds a
// register tile of one block (10x5 at n = 20), consecutive lanes hold
// consecutive blocks, so each load and store instruction of a warp moves
// one table entry of 32 neighbouring blocks (128 contiguous bytes) and each
// entry moves once.  A pivot costs one barrier and C + R + 1 shared-memory
// reads for R * C FMAs (16 reads for 50 FMAs at n = 20), and no warp
// shuffle.  Several thread blocks of 256 threads share an SM, so some invert
// while others load.  Instantiated for N = 12, 20, 30 (k = 1, 2, 3) and 32; a block of
// n <= N runs in the smallest such N, its entries past n held as the
// identity.
#include "gauss_jordan.cuh"

template <typename T, int N>
__global__ void __launch_bounds__(GjPlan<T, N>::THREADS) gauss_jordan_kernel(
    const T* __restrict__ A, T* __restrict__ out, int n, long long B) {
  using P = GjPlan<T, N>;
  gj_tile<T, N, P::R, P::C, P::BB>(A, out, n, B);
}

template <typename T, int N>
static int run(const void* A, void* out, int n, long long B, cudaStream_t st, int* plan) {
  return gj_launch<T, N>(gauss_jordan_kernel<T, N>, A, out, n, B, st, plan);
}

template <typename T>
static int dispatch(int n, const void* A, void* out, long long B, cudaStream_t st, int* plan) {
  if (n <= 12) return run<T, 12>(A, out, n, B, st, plan);
  if (n <= 20) return run<T, 20>(A, out, n, B, st, plan);
  if (n <= 30) return run<T, 30>(A, out, n, B, st, plan);
  return run<T, 32>(A, out, n, B, st, plan);
}

// dtype: 0 float32, 1 float64.  A and out (n, n, B) contiguous, n <= 32.
IEHDG_EXPORT int iehdg_gauss_jordan(int device, int dtype, int n, const void* A,
                                    void* out, long long B, void* stream) {
  if (n < 1 || n > 32 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? dispatch<float>(n, A, out, B, st, nullptr)
                    : dispatch<double>(n, A, out, B, st, nullptr);
}

// The launch plan of block size n: {N, R, C, BB, threads, shared bytes}.
IEHDG_EXPORT int iehdg_gauss_jordan_plan(int dtype, int n, int* plan) {
  if (n < 1 || n > 32 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  return dtype == 0 ? dispatch<float>(n, nullptr, nullptr, 0, nullptr, plan)
                    : dispatch<double>(n, nullptr, nullptr, 0, nullptr, plan);
}
