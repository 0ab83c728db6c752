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
//   below), and where the dispatch's measured table says so, the blocks go
//   to K5b, the blocked kernel at the end of this file
//   (`gauss_jordan_blocked`, entry iehdg_gauss_jordan_blocked): panels of b
//   pivots, each a rank-b update over the whole card, on DMMA in float64.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int GJW_SMEM_MAX = 232448;
constexpr int GJW_CLUSTER_MAX = 8;   // the portable cluster size

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
static int launch(int n, const void* A, void* out, long long B, int path, int R, int BB, int CS,
                  int threads, int smem, cudaStream_t st) {
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
// none), `threads` = BB * ceil(TR / CS) * TR, `smem` the buffers' bytes.
// Past a cluster of 8 the port launches iehdg_gauss_jordan_blocked below.
// A plan that does not match returns cudaErrorInvalidValue.
IEHDG_EXPORT int iehdg_gauss_jordan_wide(int device, int dtype, int n, const void* A, void* out,
                                         long long B, int path, int R, int BB, int CS,
                                         int threads, int smem, void* stream) {
  if (n < 1 || B < 1 || BB < 1 || CS < 1 || (dtype != 0 && dtype != 1) || path != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(n, A, out, B, path, R, BB, CS, threads, smem, st)
                    : launch<double>(n, A, out, B, path, R, BB, CS, threads, smem, st);
}

// ---------------------------------------------------------------------------
// K5b, the blocked path (gauss_jordan_blocked): Gauss-Jordan over panels P of
// b pivots, for blocks no cluster of 8 holds in registers.  With Q the other
// indices, one panel does, exactly as b single pivot steps would in exact
// arithmetic:
//     Dinv = A[P,P]^-1,  R = Dinv A[P,Q]
//     A[Q,Q] -= A[Q,P] R,  A[Q,P] = -A[Q,P] Dinv,  A[P,Q] = R,  A[P,P] = Dinv
// which is one rank-b update of the whole block, A <- A0 + N' R'' with A0
// = A with the rows and columns of P zeroed.  The panel kernel forms N' and
// R'' from the panel's pivot steps themselves (not from Dinv: see it), so
// every entry gets the plain version's updates, summed in its order.
//
// Per chunk of the batch (the workspace holds `chunk` blocks):
// 1. copy: the batch-last columns into a block-major workspace W (m, n, n)
//    through 32 x 33 shared tiles (at B = 32 an entry of the batch-last
//    table is a 256-byte run, which no tile of a block could read well);
// 2. per panel, two launches:
//    - panel: one thread block a block runs the panel's pivot steps (the
//      plain version's arithmetic) and writes the factors N', R'' of the
//      update into the workspace as (b, n) rows (see the kernel); no tile
//      of the update then reads what another writes;
//    - update: a 64 x 64 output tile x batch entry a thread block, over the
//      whole card (at n = 420, b = 32, 32 blocks: 1,568 thread blocks):
//      A0[I,J] + N'[I,:] R''[:,J], both staged in shared memory.  In
//      float64 the product runs on the tensor cores (mma.sync m8n8k4 f64,
//      DMMA: wgmma has no f64 form), four warps of 32 x 32; in float32 on
//      FFMA register tiles of 4 x 4 a thread (no TF32: the inverse keeps
//      float32 accuracy);
// 3. copy back into the batch-last output.
// What bounds it: n^3 FMAs a block against 2 n^2 entries, far above the
// card's 20 FLOP a byte from n = 90 on: the operations bound (67 TFLOP/s
// through DMMA in float64).  A panel re-reads and re-writes the block, so
// the update moves 2 n^2 entries a panel; the chunk keeps W near the L2.
constexpr int GJB_PANEL = 32;            // pivots a panel
constexpr int GJB_TILE = 64;             // update tile (rows and columns)
constexpr int GJB_PANEL_THREADS = 256;
constexpr int GJB_RC = 16;               // multipliers a vector-load group of the panel kernel

constexpr int GJB_LD = GJB_TILE + 4;     // shared row stride of the staged N', R'

// Block-major copy: TO, columns c0 .. c0 + m of the batch-last (nn, B) table
// `src` into `dst` (m, nn); otherwise back.  e-tiles on x, batch tiles on y.
template <typename T, bool TO>
__global__ void __launch_bounds__(256) gauss_jordan_blocked_copy_kernel(
    const T* __restrict__ src, T* __restrict__ dst, long long nn, long long B, long long c0,
    int m) {
  __shared__ T tile[32][33];
  const long long e0 = (long long)blockIdx.x * 32;
  const int b0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  if constexpr (TO) {
    for (int y = ty; y < 32; y += 8) {
      const long long e = e0 + y;
      const int b = b0 + tx;
      if (e < nn && b < m) tile[y][tx] = src[e * B + c0 + b];
    }
    __syncthreads();
    for (int y = ty; y < 32; y += 8) {
      const int b = b0 + y;
      const long long e = e0 + tx;
      if (e < nn && b < m) dst[(long long)b * nn + e] = tile[tx][y];
    }
  } else {
    for (int y = ty; y < 32; y += 8) {
      const int b = b0 + y;
      const long long e = e0 + tx;
      if (e < nn && b < m) tile[y][tx] = src[(long long)b * nn + e];
    }
    __syncthreads();
    for (int y = ty; y < 32; y += 8) {
      const long long e = e0 + y;
      const int b = b0 + tx;
      if (e < nn && b < m) dst[e * B + c0 + b] = tile[tx][y];
    }
  }
}

// GJB_RC consecutive values of shared memory (16-byte aligned) in vector loads.
template <typename T>
__device__ __forceinline__ void gjb_load_rc(const T* p, T (&v)[GJB_RC]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int q = 0; q < GJB_RC / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < GJB_RC / 2; ++q) {
      const double2 x = reinterpret_cast<const double2*>(p)[q];
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  }
}

// One thread block a block of the chunk: the panel P = k0 .. k0 + bt of
// block blockIdx.x of W, the plain version's pivot steps regrouped
// (linalg/smallinv.py:gauss_jordan_inv_blocked_plain):
// 1. the panel's pivot steps on its diagonal block D, recording each pivot
//    row as it is at its pivot, scaled (RtP, P's columns), its 1/p, and
//    every other panel row's multiplier at that pivot (MT[k][r]);
// 2. R'' (BP, n): on every other column j the same pivot steps (one thread
//    a column, the column in registers), recording the pivot row's entry at
//    each pivot; on P's columns RtP below its diagonal;
// 3. N' (n, BP), stored transposed: off P minus each row's multipliers at
//    the panel's pivots (a forward recurrence over them); on P the identity
//    above minus the panel rows' later multipliers.
// Rows and columns past bt are zero (the diagonal block padded with the
// identity).  Inverting A[P,P] and multiplying by it instead is the same in
// exact arithmetic but lost 2 of 5 significant digits on k = 18's float64
// blocks.
template <typename T, int BP>
__global__ void __launch_bounds__(GJB_PANEL_THREADS) gauss_jordan_blocked_panel_kernel(
    const T* __restrict__ W, T* __restrict__ NT, T* __restrict__ RT, int n, int k0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int PER = BP * BP / GJB_PANEL_THREADS;  // entries of D a thread
  T* D = reinterpret_cast<T*>(smem_raw);  // [BP][BP]: A[P,P] under the pivot steps
  T* RtP = D + BP * BP;                   // [BP][BP]: pivot row k at its pivot, scaled
  T* MT = RtP + BP * BP;                  // [BP][BP]: row r's multiplier at pivot k
  T* invp = MT + BP * BP;                 // [BP]
  const int bt = min(BP, n - k0);
  const long long blk = blockIdx.x;
  const T* Wb = W + blk * n * (long long)n;
  T* NTb = NT + blk * BP * (long long)n;
  T* RTb = RT + blk * BP * (long long)n;
  const int tid = threadIdx.x;

  // entry idx = tid + s * THREADS of D, (r, c) = (idx / BP, idx % BP): a
  // warp holds one row's consecutive columns, so D[r][k] is a broadcast
  T v[PER];
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int idx = tid + s * GJB_PANEL_THREADS, r = idx / BP, c = idx % BP;
    v[s] = (r < bt && c < bt) ? Wb[(long long)(k0 + r) * n + k0 + c] : T(r == c);
    D[idx] = v[s];
    RtP[idx] = T(0);
    MT[idx] = T(0);
  }
  __syncthreads();
  for (int k = 0; k < bt; ++k) {  // 1.
    const T inv_p = T(1) / D[k * BP + k];
    T nv[PER];
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      const int idx = tid + s * GJB_PANEL_THREADS, r = idx / BP, c = idx % BP;
      const T rk = c == k ? inv_p : D[k * BP + c] * inv_p;
      const T f = D[r * BP + k];
      if (r == k) RtP[k * BP + c] = rk;
      if (c == k && r != k) MT[k * BP + r] = f;
      nv[s] = r == k ? rk : (c == k ? -f * inv_p : v[s] - f * rk);
    }
    if (tid == 0) invp[k] = inv_p;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < PER; ++s) D[tid + s * GJB_PANEL_THREADS] = v[s] = nv[s];
    __syncthreads();
  }

  // 2. R'' on the other columns: the pivot steps on column j
  for (int j = tid; j < n; j += GJB_PANEL_THREADS) {
    if (j >= k0 && j < k0 + bt) continue;
    T a[BP];
#pragma unroll
    for (int r = 0; r < BP; ++r) a[r] = r < bt ? Wb[(long long)(k0 + r) * n + j] : T(0);
#pragma unroll
    for (int k = 0; k < BP; ++k) {
      if (k < bt) {
        const T t = a[k] * invp[k];
        RTb[(long long)k * n + j] = t;
#pragma unroll
        for (int r0 = 0; r0 < BP; r0 += GJB_RC) {
          T m[GJB_RC];
          gjb_load_rc(MT + k * BP + r0, m);
#pragma unroll
          for (int r = 0; r < GJB_RC; ++r) a[r0 + r] -= m[r] * t;  // m[k] is 0
        }
        a[k] = t;
      } else {
        RTb[(long long)k * n + j] = T(0);
      }
    }
  }
  // R'' on P's columns: RtP below (and on) its diagonal
  for (int idx = tid; idx < BP * bt; idx += GJB_PANEL_THREADS) {
    const int k = idx / bt, c = idx % bt;
    RTb[(long long)k * n + k0 + c] = c <= k ? RtP[k * BP + c] : T(0);
  }
  // 3. N'
  for (int i = tid; i < n; i += GJB_PANEL_THREADS) {
    if (i >= k0 && i < k0 + bt) {
      const int r = i - k0;
#pragma unroll
      for (int p = 0; p < BP; ++p)
        NTb[(long long)p * n + i] = p == r ? T(1) : (p > r ? -MT[p * BP + r] : T(0));
    } else {
      T f[BP];
#pragma unroll
      for (int k = 0; k < BP; ++k) {
        T x = k < bt ? Wb[(long long)i * n + k0 + k] : T(0);
#pragma unroll
        for (int j = 0; j < k; ++j) x -= f[j] * RtP[j * BP + k];
        f[k] = x;
        NTb[(long long)k * n + i] = -x;
      }
    }
  }
}

// Stage N'[p][i0 + c] and R'[p][j0 + c] (p < BP, c < 64; zero past n).
template <typename T, int BP, int THREADS>
__device__ __forceinline__ void gjb_stage(T* sN, T* sR, const T* NTb, const T* RTb, int n,
                                          int i0, int j0) {
  constexpr int LD = GJB_LD;
#pragma unroll
  for (int it = 0; it < BP * GJB_TILE / THREADS; ++it) {  // every load in flight at once
    const int x = threadIdx.x + it * THREADS, p = x / GJB_TILE, c = x % GJB_TILE;
    sN[p * LD + c] = i0 + c < n ? NTb[(long long)p * n + i0 + c] : T(0);
    sR[p * LD + c] = j0 + c < n ? RTb[(long long)p * n + j0 + c] : T(0);
  }
}

__device__ __forceinline__ bool gjb_in_panel(int i, int k0, int bt) {
  return i >= k0 && i < k0 + bt;
}

__device__ __forceinline__ void gjb_dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// float64 update: tile (blockIdx.y, blockIdx.x) of block blockIdx.z; four
// warps of 32 x 32, each 4 x 4 DMMA tiles of 8 x 8.  Fragments (PTX ISA,
// m8n8k4 .f64): A row g = lane / 4, column t = lane % 4; B row t, column g;
// C/D row g, columns 2 t, 2 t + 1.  The shared stride of 68 doubles puts the
// 16 lanes of a half-warp's fragment load on distinct banks.
template <int BP>
__global__ void __launch_bounds__(128) gauss_jordan_blocked_update_f64_kernel(
    double* __restrict__ W, const double* __restrict__ NT, const double* __restrict__ RT, int n,
    int k0, int bt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = GJB_LD;
  double* sN = reinterpret_cast<double*>(smem_raw);  // [BP][LD]: N'[p][i0 + c]
  double* sR = sN + BP * LD;                          // [BP][LD]: R'[p][j0 + c]
  const int j0 = blockIdx.x * GJB_TILE, i0 = blockIdx.y * GJB_TILE;
  const long long blk = blockIdx.z;
  double* Wb = W + blk * n * (long long)n;
  gjb_stage<double, BP, 128>(sN, sR, NT + blk * BP * (long long)n, RT + blk * BP * (long long)n,
                             n, i0, j0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wi = (warp / 2) * 32, wj = (warp % 2) * 32, g = lane >> 2, t = lane & 3;
  double acc[4][4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wi + mi * 8 + g, j = j0 + wj + ni * 8 + 2 * t + h;
        const bool base = i < n && j < n && !gjb_in_panel(i, k0, bt) && !gjb_in_panel(j, k0, bt);
        acc[mi][ni][h] = base ? Wb[(long long)i * n + j] : 0.0;
      }
  __syncthreads();
#pragma unroll 4
  for (int kk = 0; kk < BP; kk += 4) {
    double a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = sN[(kk + t) * LD + wi + q * 8 + g];
      b[q] = sR[(kk + t) * LD + wj + q * 8 + g];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) gjb_dmma(acc[mi][ni], a[mi], b[ni]);
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wi + mi * 8 + g, j = j0 + wj + ni * 8 + 2 * t + h;
        if (i < n && j < n) Wb[(long long)i * n + j] = acc[mi][ni][h];
      }
}

// float32 update: 256 threads, a 4 x 4 register tile a thread (rows
// 4 (tid / 16) .., columns 4 (tid % 16) ..), FFMA over the b pivots; each
// step reads one 16-byte vector of N' and one of R'.
template <int BP>
__global__ void __launch_bounds__(256) gauss_jordan_blocked_update_f32_kernel(
    float* __restrict__ W, const float* __restrict__ NT, const float* __restrict__ RT, int n,
    int k0, int bt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = GJB_LD;
  float* sN = reinterpret_cast<float*>(smem_raw);
  float* sR = sN + BP * LD;
  const int j0 = blockIdx.x * GJB_TILE, i0 = blockIdx.y * GJB_TILE;
  const long long blk = blockIdx.z;
  float* Wb = W + blk * n * (long long)n;
  gjb_stage<float, BP, 256>(sN, sR, NT + blk * BP * (long long)n, RT + blk * BP * (long long)n, n,
                            i0, j0);
  const int ri = 4 * (threadIdx.x / 16), cj = 4 * (threadIdx.x % 16);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + ri + a, j = j0 + cj + b;
      const bool base = i < n && j < n && !gjb_in_panel(i, k0, bt) && !gjb_in_panel(j, k0, bt);
      acc[a][b] = base ? Wb[(long long)i * n + j] : 0.0f;
    }
  __syncthreads();
#pragma unroll 8
  for (int p = 0; p < BP; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(sN + p * LD + ri);
    const float4 y = *reinterpret_cast<const float4*>(sR + p * LD + cj);
    const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += xs[a] * ys[b];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + ri + a, j = j0 + cj + b;
      if (i < n && j < n) Wb[(long long)i * n + j] = acc[a][b];
    }
}

template <typename T, int BP>
static int gjb_attrs() {
  static bool done = false;  // the caps only: a launch takes the bytes it asks for
  if (done) return 0;
  cudaError_t a = cudaFuncSetAttribute(gauss_jordan_blocked_panel_kernel<T, BP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, GJW_SMEM_MAX);
  if (a == cudaSuccess) {
    if constexpr (sizeof(T) == 8)
      a = cudaFuncSetAttribute(gauss_jordan_blocked_update_f64_kernel<BP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, GJW_SMEM_MAX);
    else
      a = cudaFuncSetAttribute(gauss_jordan_blocked_update_f32_kernel<BP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, GJW_SMEM_MAX);
  }
  if (a != cudaSuccess) return (int)a;
  done = true;
  return 0;
}

template <typename T, int BP>
static int run_blocked(int n, const T* A, T* out, long long B, T* ws, int chunk, int smem,
                       int panel_smem, cudaStream_t st) {
  const int a = gjb_attrs<T, BP>();
  if (a) return a;
  const long long nn = (long long)n * n;
  const unsigned tiles = (unsigned)((n + GJB_TILE - 1) / GJB_TILE);
  for (long long c0 = 0; c0 < B; c0 += chunk) {
    const int m = (int)(B - c0 < chunk ? B - c0 : chunk);
    T* W = ws;
    T* NT = W + m * nn;
    T* RT = NT + (long long)m * BP * n;
    const dim3 copy_grid((unsigned)((nn + 31) / 32), (unsigned)((m + 31) / 32));
    gauss_jordan_blocked_copy_kernel<T, true><<<copy_grid, 256, 0, st>>>(A, W, nn, B, c0, m);
    for (int k0 = 0; k0 < n; k0 += BP) {
      const int bt = n - k0 < BP ? n - k0 : BP;
      gauss_jordan_blocked_panel_kernel<T, BP><<<m, GJB_PANEL_THREADS, panel_smem, st>>>(
          W, NT, RT, n, k0);
      const dim3 grid(tiles, tiles, m);
      if constexpr (sizeof(T) == 8)
        gauss_jordan_blocked_update_f64_kernel<BP><<<grid, 128, smem, st>>>(W, NT, RT, n, k0, bt);
      else
        gauss_jordan_blocked_update_f32_kernel<BP><<<grid, 256, smem, st>>>(W, NT, RT, n, k0, bt);
    }
    gauss_jordan_blocked_copy_kernel<T, false><<<copy_grid, 256, 0, st>>>(W, out, nn, B, c0, m);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
static int launch_blocked(int n, const void* A, void* out, long long B, void* ws, int b, int tile,
                          int chunk, int threads, int smem, int panel_threads, int panel_smem,
                          cudaStream_t st) {
  const long long size = sizeof(T);
  if (b != GJB_PANEL || tile != GJB_TILE || chunk < 1 || chunk > 65535 ||
      threads != (sizeof(T) == 8 ? 128 : 256) || smem != 2LL * b * GJB_LD * size ||
      panel_threads != GJB_PANEL_THREADS || panel_smem != (3LL * b * b + b) * size)
    return (int)cudaErrorInvalidValue;
  return run_blocked<T, GJB_PANEL>(n, (const T*)A, (T*)out, B, (T*)ws, chunk, smem, panel_smem,
                                   st);
}

// dtype: 0 float32, 1 float64.  A and out (n, n, B) contiguous, B >= 1; ws
// a workspace of chunk * (n^2 + 2 b n) scalars.  The plan
// (linalg/smallinv.py:wide_gj_plan, path "blocked"): b the panel (32),
// tile 64, chunk blocks a pass, `threads`/`smem` the update kernel's (128
// in float64, 256 in float32; 2 b 68 scalars), `panel_threads`/
// `panel_smem` the panel kernel's (256; 3 b^2 + b scalars).  A plan that does
// not match returns cudaErrorInvalidValue.
IEHDG_EXPORT int iehdg_gauss_jordan_blocked(int device, int dtype, int n, const void* A,
                                            void* out, long long B, void* ws, int b, int tile,
                                            int chunk, int threads, int smem, int panel_threads,
                                            int panel_smem, void* stream) {
  if (n < 1 || B < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? launch_blocked<float>(n, A, out, B, ws, b, tile, chunk, threads, smem,
                                            panel_threads, panel_smem, st)
                    : launch_blocked<double>(n, A, out, B, ws, b, tile, chunk, threads, smem,
                                             panel_threads, panel_smem, st);
}
