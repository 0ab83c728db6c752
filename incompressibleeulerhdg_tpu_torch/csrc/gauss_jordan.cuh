// The device template of K4 (csrc/gauss_jordan.cu) and K5
// (csrc/gauss_jordan_select.cu): unpivoted in-place Gauss-Jordan inverse of
// a batch of (n, n) blocks stored batch-last as (n, n, B), register-tiled.
//
// One instantiation serves every n <= N (N known at compile time).  The
// (N, N) block is cut into TR x TC tiles of R x C entries (the last tiles
// may run past N); a thread holds one tile of one block in registers, and a
// thread block holds BB consecutive batch entries, the batch entry fastest
// in threadIdx.x: the lanes of a warp load and store one table entry of
// consecutive blocks, which lie next to each other in device memory, so
// every access is coalesced and every entry is read once and written once.
// Entries outside n x n, and the blocks of the batch tail past B, start as
// the identity and are never stored; they never reach an entry inside n x n.
//
// Pivot k does the plain version's arithmetic entry by entry
// (linalg/smallinv.py:gauss_jordan_inv_plain), with p = A[k, k]:
//     row_k[j] = A[k, j] * (1/p),  row_k[k] = 1/p
//     f[i]     = A[i, k],          f[k]     = 0
//     A[i, j] -= f[i] * row_k[j]
//     A[:, k]  = -f * (1/p);  A[k, :] = row_k
// The owners of row k and column k publish them, and the owner of (k, k)
// publishes 1/p, to shared memory (batch entry fastest: no bank conflicts);
// every thread then reads C + R + 1 values for its R * C FMAs.  The
// published values are double-buffered, so one barrier a pivot suffices:
// pivot k + 2 writes buffer k & 1 only after the barrier of pivot k + 1,
// which every reader of pivot k has passed.  The pivot loop is unrolled over
// N, so every register index is a constant.
#pragma once

#include "common.cuh"

template <int N, int R, int C, int BB>
struct GjShape {
  static constexpr int TR = (N + R - 1) / R;  // tile rows
  static constexpr int TC = (N + C - 1) / C;  // tile columns
  static constexpr int THREADS = TR * TC * BB;
  static_assert(THREADS <= 1024, "a thread block holds at most 1024 threads");
};

template <typename T, int N, int R, int C, int BB>
struct GjShared {  // one pivot's row, column and 1/p, two buffers
  T row[2][GjShape<N, R, C, BB>::TC * C][BB];
  T col[2][GjShape<N, R, C, BB>::TR * R][BB];
  T inv[2][BB];
};

// Launch plans of the instantiated block sizes: tile R x C, BB batch entries
// a thread block, for float32 and float64, chosen by device time on the H100
// (tools/tune_gj.py).  A double tile takes twice the registers, so the
// float64 plans hold fewer batch entries a thread block, and from N = 56 on
// they may take another tile.
template <typename T, int N>
struct GjPlan;

#define IEHDG_GJ_PLAN2(N_, R32_, C32_, BB32_, R64_, C64_, BB64_)                   \
  template <typename T>                                                            \
  struct GjPlan<T, N_> : GjShape<N_, sizeof(T) == 4 ? R32_ : R64_,                 \
                                 sizeof(T) == 4 ? C32_ : C64_,                     \
                                 sizeof(T) == 4 ? BB32_ : BB64_> {                 \
    static constexpr int R = sizeof(T) == 4 ? R32_ : R64_;                         \
    static constexpr int C = sizeof(T) == 4 ? C32_ : C64_;                         \
    static constexpr int BB = sizeof(T) == 4 ? BB32_ : BB64_;                      \
    static_assert(sizeof(GjShared<T, N_, R, C, BB>) <= 48 * 1024, "static smem"); \
  };
#define IEHDG_GJ_PLAN(N_, R_, C_, BB32_, BB64_) IEHDG_GJ_PLAN2(N_, R_, C_, BB32_, R_, C_, BB64_)

IEHDG_GJ_PLAN(12, 6, 6, 32, 32)
IEHDG_GJ_PLAN(20, 10, 5, 32, 16)
IEHDG_GJ_PLAN(30, 8, 8, 16, 8)
IEHDG_GJ_PLAN(32, 8, 8, 16, 16)
IEHDG_GJ_PLAN(42, 7, 7, 8, 4)
IEHDG_GJ_PLAN(48, 8, 8, 8, 4)
IEHDG_GJ_PLAN2(56, 7, 7, 8, 7, 7, 4)
IEHDG_GJ_PLAN2(72, 6, 6, 4, 9, 9, 2)
#undef IEHDG_GJ_PLAN
#undef IEHDG_GJ_PLAN2

// Publish pivot k's row, column and 1/p into buffer k & 1 (k is a constant
// once the pivot loop is unrolled).
template <typename T, int N, int R, int C, int BB>
__device__ __forceinline__ void gj_publish(GjShared<T, N, R, C, BB>& sh, const T (&a)[R][C],
                                           int k, int tr, int tc, int i0, int j0, int b) {
  const int q = k & 1;
  if (tr == k / R) {
#pragma unroll
    for (int lj = 0; lj < C; ++lj) sh.row[q][j0 + lj][b] = a[k % R][lj];
    if (tc == k / C) sh.inv[q][b] = T(1) / a[k % R][k % C];
  }
  if (tc == k / C) {
#pragma unroll
    for (int li = 0; li < R; ++li) sh.col[q][i0 + li][b] = a[li][k % C];
  }
}

template <typename T, int N, int R, int C, int BB>
__device__ __forceinline__ void gj_tile(const T* __restrict__ A, T* __restrict__ out, int n,
                                        long long B) {
  using S = GjShape<N, R, C, BB>;
  __shared__ GjShared<T, N, R, C, BB> sh;
  const int b = threadIdx.x % BB;
  const int pos = threadIdx.x / BB;
  const int tr = pos / S::TC, tc = pos % S::TC;
  const int i0 = tr * R, j0 = tc * C;
  const long long col = (long long)blockIdx.x * BB + b;
  const bool live = col < B;

  T a[R][C];
#pragma unroll
  for (int li = 0; li < R; ++li)
#pragma unroll
    for (int lj = 0; lj < C; ++lj) {
      const int i = i0 + li, j = j0 + lj;
      a[li][lj] = (live && i < n && j < n) ? A[((long long)i * n + j) * B + col] : T(i == j);
    }

  gj_publish(sh, a, 0, tr, tc, i0, j0, b);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < n) {  // uniform across the thread block
      __syncthreads();
      const int q = k & 1;
      const T inv_p = sh.inv[q][b];
      const bool own_row = tr == k / R, own_col = tc == k / C;
      T rk[C], f[R];
#pragma unroll
      for (int lj = 0; lj < C; ++lj) rk[lj] = sh.row[q][j0 + lj][b] * inv_p;
#pragma unroll
      for (int li = 0; li < R; ++li) f[li] = sh.col[q][i0 + li][b];
      if (own_col) rk[k % C] = inv_p;
      if (own_row) f[k % R] = T(0);
#pragma unroll
      for (int li = 0; li < R; ++li)
#pragma unroll
        for (int lj = 0; lj < C; ++lj) a[li][lj] -= f[li] * rk[lj];
      if (own_col) {
#pragma unroll
        for (int li = 0; li < R; ++li) a[li][k % C] = -f[li] * inv_p;
      }
      if (own_row) {
#pragma unroll
        for (int lj = 0; lj < C; ++lj) a[k % R][lj] = rk[lj];
      }
      if (k + 1 < n) gj_publish(sh, a, k + 1, tr, tc, i0, j0, b);
    }
  }

  if (live) {
#pragma unroll
    for (int li = 0; li < R; ++li)
#pragma unroll
      for (int lj = 0; lj < C; ++lj) {
        const int i = i0 + li, j = j0 + lj;
        if (i < n && j < n) out[((long long)i * n + j) * B + col] = a[li][lj];
      }
  }
}

// Launch `kernel`, an instantiation of gj_tile with tile R x C and BB batch
// entries a thread block, over B blocks of size n.
template <typename T, int N, int R, int C, int BB>
static int gj_run(void (*kernel)(const T*, T*, int, long long), const void* A, void* out, int n,
                  long long B, cudaStream_t st) {
  kernel<<<blocks_for(B, BB), GjShape<N, R, C, BB>::THREADS, 0, st>>>((const T*)A, (T*)out, n, B);
  return (int)cudaGetLastError();
}

// Launch plan GjPlan<T, N>'s instantiation `kernel`, or (plan != nullptr)
// describe it: plan = {N, R, C, BB, threads, shared bytes}.
template <typename T, int N>
static int gj_launch(void (*kernel)(const T*, T*, int, long long), const void* A, void* out,
                     int n, long long B, cudaStream_t st, int* plan) {
  using P = GjPlan<T, N>;
  if (plan) {
    const int p[6] = {N, P::R, P::C, P::BB, P::THREADS,
                      (int)sizeof(GjShared<T, N, P::R, P::C, P::BB>)};
    for (int i = 0; i < 6; ++i) plan[i] = p[i];
    return 0;
  }
  return gj_run<T, N, P::R, P::C, P::BB>(kernel, A, out, n, B, st);
}
