// K5: unpivoted in-place Gauss-Jordan inverse of a batch of (n, n) blocks
// stored batch-last as (n, n, B), n <= 72.
//
// Replaces the Pallas kernel tools/microbench_gj.py `_gj_old` (kernel body
// `_gj_old_kernel_factory`), the masked-select formulation: at each pivot k
// the whole block is updated,
//
//     row_k = where(j == k, 1/p, A[k, j]/p)       p = A[k, k]
//     f     = where(i == k, 0, A[i, k])
//     A    -= f (x) row_k
//     A[:, k] = -f/p;  A[k, :] = row_k            (by selects)
//
// which gives, entry by entry, the same values as K4's indexed fix-ups.
// Callers: `gauss_jordan_inv_bl` for 32 < n <= 72 -- the own-cell and patch
// Schur inverses of the tentative-operator build at k = 4, 5, 6 (n = 42,
// 56, 72) -- and `gauss_jordan_inv_select` for any n <= 72.
//
// What bounds it on the card: a 42x42 block is 74 KFMA against
// 2 * 42*42*4 B = 14 KB of traffic in float32 (10.5 FLOP a byte), so at
// (42, 42, 32768) the bytes (0.138 ms at 3.35 TB/s) and the arithmetic
// (0.073 ms at 67 TFLOP/s) are within a factor of two: the FMAs must issue
// at a good share of the peak while the loads stream, and the blocks must
// stay on chip across all n pivots.
//
// What the design does about it: K4's register-tiled template
// (csrc/gauss_jordan.cuh) -- a thread keeps a 7x7 tile of one block in
// registers (n = 42), so a pivot is 49 FMAs against 15 shared-memory reads
// and one barrier, with the select formulation's row/column fix-ups done
// as register moves on the owners of row k and column k only.  Each entry
// moves once, coalesced over consecutive blocks.  A 42x42 float32 block is
// 7 KB, so the register file holds 16 blocks an SM: 8 a thread block (288
// threads, 96 registers), two thread blocks an SM.  A warp's access to one
// table entry is then a run of 8 blocks (32 bytes), which sets the time of
// the loads and stores (a copy with this access pattern alone takes about
// twice the bytes bound, tools/tune_gj.py).  Instantiated for N = 20, 42
// (k = 4), 48, 56 (k = 5) and 72 (k = 6); a block of n <= N runs in the
// smallest such N, its entries past n held as the identity.  At N = 56 a
// thread holds a 7x7 tile (8 blocks a thread block in float32, 4 in
// float64), at N = 72 a 6x6 tile in float32 (4 blocks) and a 9x9 tile in
// float64 (2 blocks), the fastest of tools/tune_gj.py's plans without a
// spill on the H100; the pivot loop is unrolled over N, which sets nvcc's
// time for this library.
//
// That design (variant 0) is bound by its shared-memory issue and its
// thread-block-wide barrier a pivot, not by its FMAs.  Variant 1, the team
// design of csrc/gauss_jordan_team.cuh, gives each block a team of two
// warps on a named barrier of its own, publishes the pivot row and column
// so a thread reads its fragments as 16-byte vectors (5 shared loads for 49
// FMAs at n = 56), and stages the thread block's blocks through shared
// memory so device memory still moves in runs of consecutive batch
// entries.  The port takes whichever variant was faster on the card at the
// width and dtype (linalg/smallinv.py SELECT_MEASURED); both stay built, so
// one process can time both.
#include "gauss_jordan.cuh"
#include "gauss_jordan_team.cuh"

template <typename T, int N>
__global__ void __launch_bounds__(GjPlan<T, N>::THREADS) gauss_jordan_select_kernel(
    const T* __restrict__ A, T* __restrict__ out, int n, long long B) {
  using P = GjPlan<T, N>;
  gj_tile<T, N, P::R, P::C, P::BB>(A, out, n, B);
}

template <typename T, int N>
__global__ void __launch_bounds__(GtShape<T, N, GtPlan<T, N>::BB>::THREADS)
    gauss_jordan_select_kernel_team(const T* __restrict__ A, T* __restrict__ out, int n,
                                    long long B) {
  gt_tile<T, N, GtPlan<T, N>::BB, GtPlan<T, N>::G>(A, out, n, B);
}

// Variant 1 (the team design) at N: launch, or (plan != nullptr) describe it:
// plan = {N, R, R, BB, threads, shared bytes, G}.
template <typename T, int N>
static int run_team(const void* A, void* out, int n, long long B, cudaStream_t st, int* plan) {
  constexpr int BB = GtPlan<T, N>::BB, G = GtPlan<T, N>::G;
  using S = GtShape<T, N, BB, G>;
  if (plan) {
    const int p[7] = {N, S::R, S::R, BB, S::THREADS, S::SMEM, G};
    for (int i = 0; i < 7; ++i) plan[i] = p[i];
    return 0;
  }
  static bool attr = false;
  return gt_launch<T, N, BB, G>(gauss_jordan_select_kernel_team<T, N>, attr, A, out, n, B, st);
}

template <typename T, int N>
static int run(int variant, const void* A, void* out, int n, long long B, cudaStream_t st,
               int* plan) {
  if (variant == 1) return run_team<T, N>(A, out, n, B, st, plan);
  return gj_launch<T, N>(gauss_jordan_select_kernel<T, N>, A, out, n, B, st, plan);
}

template <typename T>
static int dispatch(int variant, int n, const void* A, void* out, long long B, cudaStream_t st,
                    int* plan) {
  if (n <= 20) return run<T, 20>(variant, A, out, n, B, st, plan);
  if (n <= 42) return run<T, 42>(variant, A, out, n, B, st, plan);
  if (n <= 48) return run<T, 48>(variant, A, out, n, B, st, plan);
  if (n <= 56) return run<T, 56>(variant, A, out, n, B, st, plan);
  return run<T, 72>(variant, A, out, n, B, st, plan);
}

// dtype: 0 float32, 1 float64.  A and out (n, n, B) contiguous, n <= 72.
// variant: 0 PR 4's register-tiled template (csrc/gauss_jordan.cuh), 1 the
// team design (csrc/gauss_jordan_team.cuh); the port chooses it by n and
// dtype from a measured table (linalg/smallinv.py SELECT_MEASURED).
IEHDG_EXPORT int iehdg_gauss_jordan_select(int device, int dtype, int n, const void* A,
                                           void* out, long long B, int variant, void* stream) {
  if (n < 1 || n > 72 || (dtype != 0 && dtype != 1) || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? dispatch<float>(variant, n, A, out, B, st, nullptr)
                    : dispatch<double>(variant, n, A, out, B, st, nullptr);
}

// The launch plan of block size n under `variant`: {N, R, C, BB, threads,
// shared bytes, G} (variant 0: static shared memory, G left as it is; 1:
// dynamic shared memory, G groups of BB blocks staged at once).
IEHDG_EXPORT int iehdg_gauss_jordan_select_plan(int dtype, int n, int variant, int* plan) {
  if (n < 1 || n > 72 || (dtype != 0 && dtype != 1) || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  return dtype == 0 ? dispatch<float>(variant, n, nullptr, nullptr, 0, nullptr, plan)
                    : dispatch<double>(variant, n, nullptr, nullptr, 0, nullptr, plan);
}
