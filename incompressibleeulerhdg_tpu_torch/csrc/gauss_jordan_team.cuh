// K5's team design (csrc/gauss_jordan_select.cu, variant 1): unpivoted
// Gauss-Jordan inverse of a batch of (n, n) blocks stored batch-last as
// (n, n, B), one block a team of two warps, panel by panel.
//
// PR 4's template (csrc/gauss_jordan.cuh, K4 and K5's variant 0) pivots one
// index at a time: at n = 56 a thread spends about 65 issue slots of
// overhead (shared loads, the scaling of the pivot row, the fix-ups of row
// and column k, the publication of pivot k + 1, a barrier over the whole
// thread block) on 49 FMAs.  Here a team of 64 threads holds a block as an
// 8 x 8 grid of R x R register tiles (R = ceil(N / 8)) and takes the R
// pivots of one tile row kt at once, as K5b does over the card
// (csrc/gauss_jordan_wide.cu): with P the panel,
//     Dinv = A[P,P]^-1,  R' = Dinv A[P,:] off P and Dinv on P,
//     N' = -A[:,P] off P and the identity on P,
//     A <- A0 + N' R'     (A0: A with the rows and columns of P zeroed)
// 1. the owners of tile row kt publish A[P,:], the owners of tile column kt
//    N' (the diagonal tile's owner the identity);
// 2. the team's first warp runs the R pivot steps of the plain version on
//    the rows P alone (a column or three a lane in registers, the pivot
//    column by shuffles, no barrier inside): that leaves R' in them, Dinv
//    on P's columns;
// 3. every thread zeroes its tile if it lies in P's rows or columns and adds
//    N'[I,:] R'[:,J]: R^3 FMAs from 2 R^2 values read as 16-byte vectors
//    (the tile columns of a warp read 128 contiguous bytes, the lanes of a
//    tile row share theirs: a broadcast);
// a named barrier of the team's own after steps 1 and 2 (bar.sync 1 +
// team, 64): 2 barriers for R pivots.  Measured at (56, 56, 32768) f32
// without device memory (tools/tune_gj.py --team, NVIDIA H100 80GB HBM3,
// 700.00 W): a warp inverting A[P,P] in shared memory took 0.45 of the
// panels' 1.11 ms, the update's FMAs 0.23; every thread inverting it in
// its registers, then forming R' a column a thread, 0.90 ms.
// Device memory moves through a shared stage of the thread block's G BB
// blocks (its BB teams invert G groups of BB blocks one after another),
// read and written in runs of G BB consecutive batch entries with
// GT_UNROLL loads in flight a thread (the teams' tiles are scattered
// entries of one block; one load in flight left the staging latency-bound,
// and runs of 4 blocks took twice the time of runs of 8: 1.0 against
// 0.53 ms at (56, 56, 32768) f32).  A thread-block cluster that gathered 32 blocks' runs of 128
// bytes and handed each value to its owner through distributed shared
// memory was slower (2.1 ms for the staging alone).  During the panels a
// team's plane of the stage holds its panel buffers.  Entries outside
// n x n, and the blocks past B, start as the identity and are never
// stored; panels past n are skipped.
#pragma once

#include "common.cuh"

template <typename T, int N, int BB, int G = 1>
struct GtShape {
  static constexpr int TR = 8;                           // tile rows (and columns) of a block
  static constexpr int R = (N + TR - 1) / TR;            // a thread's R x R tile, a panel's pivots
  static constexpr int TEAM = TR * TR;                   // threads a block
  static constexpr int THREADS = TEAM * BB;
  static constexpr int VEC = 16 / (int)sizeof(T);        // scalars a 16-byte vector
  static constexpr int RP = (R + VEC - 1) / VEC * VEC;   // a tile's row or column, padded
  static constexpr int SEG = TR * RP;                    // one row of N'^T or R'
  static constexpr int PANEL = 2 * R * SEG;              // N'^T and R' of one panel
  static constexpr int GB = G * BB;                      // blocks a thread block stages
  static constexpr int PAD = (32 / GB + VEC - 1) / VEC * VEC;     // planes on other banks
  static constexpr int PLANE = (N * N + 31) / 32 * 32 + PAD;      // a staged block
  static constexpr int SMEM = GB * PLANE * (int)sizeof(T);
  static_assert(BB >= 1 && BB <= 15, "named barriers 1 .. BB");
  static_assert(THREADS <= 1024, "a thread block holds at most 1024 threads");
  static_assert(2 * PANEL <= PLANE, "a team's plane holds its two panel buffers");
  static_assert((PLANE * (int)sizeof(T)) % 16 == 0, "16-byte aligned planes");
};

// Launch plans: BB blocks (teams) a thread block, G groups of BB blocks it
// stages at once, by scalar type and instantiated N, chosen by device time
// on the H100 (tools/tune_gj.py --team).
template <typename T, int N>
struct GtPlan;

#define IEHDG_GT_PLAN(N_, BB32_, G32_, BB64_, G64_)                      \
  template <typename T>                                                  \
  struct GtPlan<T, N_> {                                                 \
    static constexpr int BB = sizeof(T) == 4 ? BB32_ : BB64_;            \
    static constexpr int G = sizeof(T) == 4 ? G32_ : G64_;               \
  };
IEHDG_GT_PLAN(20, 4, 1, 2, 1)
IEHDG_GT_PLAN(42, 4, 2, 2, 2)
IEHDG_GT_PLAN(48, 4, 2, 2, 2)
IEHDG_GT_PLAN(56, 4, 1, 2, 2)
IEHDG_GT_PLAN(72, 8, 1, 4, 1)
#undef IEHDG_GT_PLAN

constexpr int GT_UNROLL = 16;  // loads in flight a thread while the batch is staged

__device__ __forceinline__ void gt_team_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Scalar l of tile segment s in one row of a panel buffer:
// [RP / VEC][TR][VEC], so the 8 segments' vectors lie side by side.
template <typename S>
__device__ __forceinline__ int gt_slot(int s, int l) {
  return ((l / S::VEC) * S::TR + s) * S::VEC + l % S::VEC;
}

// The R scalars of tile segment s of one buffer row, as RP / VEC 16-byte
// vector loads.
template <typename T, typename S>
__device__ __forceinline__ void gt_read(const T* row, int s, T (&v)[S::R]) {
#pragma unroll
  for (int q = 0; q < S::RP / S::VEC; ++q) {
    const T* p = row + (q * S::TR + s) * S::VEC;
    if constexpr (sizeof(T) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (4 * q + l < S::R) v[4 * q + l] = xs[l];
    } else {
      const double2 x = *reinterpret_cast<const double2*>(p);
      if (2 * q < S::R) v[2 * q] = x.x;
      if (2 * q + 1 < S::R) v[2 * q + 1] = x.y;
    }
  }
}

// The panel's R pivot steps (the plain version's, on rows P alone) on the
// row panel A[P,:] (rA, R rows of TR R columns), by one warp: lane l holds
// columns l, l + 32, .. (NC of them) in registers; pivot k's column comes
// from its lane by shuffles.  The result, R' (Dinv on P's columns), goes
// to rR in the same layout.
template <typename T, typename S>
__device__ __forceinline__ void gt_warp_panel(const T* rA, T* rR, int kt, int lane) {
  constexpr int R = S::R, NJ = S::TR * R, NC = (NJ + 31) / 32;
  T v[NC][R];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = lane + 32 * c;
#pragma unroll
    for (int p = 0; p < R; ++p) v[c][p] = j < NJ ? rA[p * S::SEG + gt_slot<S>(j / R, j % R)] : T(0);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int g = kt * R + k;  // the pivot's column
    const int gc = g / 32;     // its register slot in lane g % 32
    T f[R];
#pragma unroll
    for (int p = 0; p < R; ++p) {
      T mine = v[0][p];
#pragma unroll
      for (int c = 1; c < NC; ++c)
        if (gc == c) mine = v[c][p];
      f[p] = __shfl_sync(0xffffffffu, mine, g % 32);
    }
    const T inv_p = T(1) / f[k];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bool piv = lane + 32 * c == g;
      const T rk = piv ? inv_p : v[c][k] * inv_p;
#pragma unroll
      for (int p = 0; p < R; ++p) {
        if (p == k) continue;
        v[c][p] = piv ? -f[p] * inv_p : v[c][p] - f[p] * rk;
      }
      v[c][k] = rk;
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = lane + 32 * c;
    if (j < NJ) {
#pragma unroll
      for (int p = 0; p < R; ++p) rR[p * S::SEG + gt_slot<S>(j / R, j % R)] = v[c][p];
    }
  }
}

// MODE (for tools/tune_gj.py --team only): 0 the inverse; 1 the staging
// and the tiles' round trip alone, no panels; 2 the panels alone on
// identity blocks, no device memory.
template <typename T, int N, int BB, int G, int MODE = 0>
__device__ __forceinline__ void gt_tile(const T* __restrict__ A, T* __restrict__ out, int n,
                                        long long B) {
  using S = GtShape<T, N, BB, G>;
  constexpr int R = S::R, GB = S::GB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const long long col0 = (long long)blockIdx.x * GB;
  const int nn = n * n;

  // the thread block's G BB blocks into the stage: x = e GB + b, runs of GB
  // consecutive batch entries, GT_UNROLL loads in flight a thread; the
  // blocks past B as the identity
  const int total = GB * nn;
  for (int x0 = tid; x0 < total; x0 += GT_UNROLL * S::THREADS) {
    T v[GT_UNROLL];
#pragma unroll
    for (int u = 0; u < GT_UNROLL; ++u) {
      const int x = x0 + u * S::THREADS;
      const long long col = col0 + x % GB;
      v[u] = (MODE != 2 && x < total && col < B) ? A[(long long)(x / GB) * B + col] : T(0);
    }
#pragma unroll
    for (int u = 0; u < GT_UNROLL; ++u) {
      const int x = x0 + u * S::THREADS;
      if (x < total) stage[(x % GB) * S::PLANE + x / GB] = v[u];
    }
  }
  if (MODE == 2 || col0 + GB > B) {  // the last thread block (uniform): its blocks past B
    __syncthreads();                 // after every zero of the loads above
    for (int x = tid; x < GB * n; x += S::THREADS) {
      const int b = x / n, i = x % n;
      if (MODE == 2 || col0 + b >= B) stage[b * S::PLANE + i * n + i] = T(1);
    }
  }
  __syncthreads();

  const int team = tid / S::TEAM, pos = tid % S::TEAM;
  const int tr = pos / S::TR, tc = pos % S::TR;
  const int i0 = tr * R, j0 = tc * R;
  const int team_bar = 1 + team;
  // group g: team t inverts the stage's block g BB + t
  for (int g = 0; g < G; ++g) {
    T* st = stage + (g * BB + team) * S::PLANE;
    T a[R][R];
#pragma unroll
    for (int li = 0; li < R; ++li)
#pragma unroll
      for (int lj = 0; lj < R; ++lj) {
        const int i = i0 + li, j = j0 + lj;
        a[li][lj] = (i < n && j < n) ? st[i * n + j] : T(i == j);
      }

    // the panels, in the team's plane once every thread holds its tile:
    // rA[p * SEG + slot(tile column, j)] = A[P,j], rR the same for R', and
    // two buffers cP[p * SEG + slot(tile row, i)] = N'[i][p] (rA is read
    // between the barriers of one panel, rR after the second, cP up to the
    // next panel's first)
    T* rA = st;
    T* rR = st + R * S::SEG;
    gt_team_sync(team_bar, S::TEAM);
    for (int kt = 0; kt < (MODE == 1 ? 0 : S::TR) && kt * R < n; ++kt) {
      T* cP = st + (2 + (kt & 1)) * R * S::SEG;
      const bool orow = tr == kt, ocol = tc == kt;
      // 1. A[P,:] from tile row kt; N' from tile column kt (the identity on P)
      if (orow) {
#pragma unroll
        for (int p = 0; p < R; ++p)
#pragma unroll
          for (int c = 0; c < R; ++c) rA[p * S::SEG + gt_slot<S>(tc, c)] = a[p][c];
      }
      if (ocol) {
#pragma unroll
        for (int p = 0; p < R; ++p)
#pragma unroll
          for (int li = 0; li < R; ++li)
            cP[p * S::SEG + gt_slot<S>(tr, li)] = orow ? T(li == p) : -a[li][p];
      }
      gt_team_sync(team_bar, S::TEAM);
      // 2. R' = the panel's R pivot steps on the row panel A[P,:], by the
      //    first warp: lane l holds columns l, l + 32, .. in registers, the
      //    pivot column comes by shuffles (Dinv ends on P's columns)
      if (pos < 32) gt_warp_panel<T, S>(rA, rR, kt, pos);
      gt_team_sync(team_bar, S::TEAM);
      // 3. A0 + N'[I,:] R'[:,J]
      if (orow || ocol) {
#pragma unroll
        for (int li = 0; li < R; ++li)
#pragma unroll
          for (int lj = 0; lj < R; ++lj) a[li][lj] = T(0);
      }
#pragma unroll
      for (int p = 0; p < R; ++p) {
        T nv[R], rv[R];
        gt_read<T, S>(cP + p * S::SEG, tr, nv);
        gt_read<T, S>(rR + p * S::SEG, tc, rv);
#pragma unroll
        for (int li = 0; li < R; ++li)
#pragma unroll
          for (int lj = 0; lj < R; ++lj) a[li][lj] += nv[li] * rv[lj];
      }
  }
  gt_team_sync(team_bar, S::TEAM);  // the last panel's buffers read: the plane is free

  // each thread rewrites the stage entries it read
#pragma unroll
  for (int li = 0; li < R; ++li)
#pragma unroll
    for (int lj = 0; lj < R; ++lj) {
      const int i = i0 + li, j = j0 + lj;
      if (i < n && j < n) st[i * n + j] = a[li][lj];
    }
  }
  // then runs of GB again
  __syncthreads();
  for (int x0 = tid; x0 < total; x0 += GT_UNROLL * S::THREADS) {
    T v[GT_UNROLL];
#pragma unroll
    for (int u = 0; u < GT_UNROLL; ++u) {
      const int x = x0 + u * S::THREADS;
      v[u] = x < total ? stage[(x % GB) * S::PLANE + x / GB] : T(0);
    }
#pragma unroll
    for (int u = 0; u < GT_UNROLL; ++u) {
      const int x = x0 + u * S::THREADS;
      const long long col = col0 + x % GB;
      if (MODE != 2 && x < total && col < B) out[(long long)(x / GB) * B + col] = v[u];
    }
  }
}

// Launch gt_tile's kernel `kernel` over B blocks, GtShape's threads and
// shared bytes a thread block; `attr` (the caller's flag for this kernel)
// records that its shared-memory cap is set.
template <typename T, int N, int BB, int G>
static int gt_launch(void (*kernel)(const T*, T*, int, long long), bool& attr, const void* A,
                     void* out, int n, long long B, cudaStream_t st) {
  using S = GtShape<T, N, BB, G>;
  if (!attr) {  // the cap only: a launch takes the bytes it asks for
    const cudaError_t a = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               S::SMEM);
    if (a != cudaSuccess) return (int)a;
    attr = true;
  }
  kernel<<<blocks_for(B, S::GB), S::THREADS, S::SMEM, st>>>((const T*)A, (T*)out, n, B);
  return (int)cudaGetLastError();
}
