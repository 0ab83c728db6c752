// K3w: the fused facet-pair patch solve of one facet colour (K3) at a width
// d1 given at run time (the port launches it for every width from d1 = 21,
// k = 4, on; patch_solve.cu serves d1 <= 15).
//
// For every facet c of the colour (table column off + c) the exact 2x2
// block-Schur solve of the [plus cell, minus cell] patch, in K3's five
// phases:
//
//     w  = Dinv0 r0
//     t  = r1 - (I2 (x) K10 + Cp) w
//     y1 = Sinv t
//     u  = r0 - (I2 (x) K01 + Bp) y1
//     y0 = Dinv0 u
//
// Replaces the Pallas kernel incompressibleeulerhdg_tpu/linalg/preconditioners.py
// `_patch_pallas`, which the JAX package runs at any width.  Callers as K3:
// `_patch_color_structured` (the colored sweeps) and `_patch_apply_bl`
// (the additive preconditioner: one launch a colour and one for the
// boundary tail with zero penalty blocks).
//
// What bounds it on the card: table bytes.  At 128^2, k = 7, float32 one
// colour (16,256 facets) holds Dinv0 + Sinv = 2 * 90*90*16256*4 B = 1,053
// MB and K01 + K10 = 263 MB, plus 23 MB of fields: 1,340 MB, 0.400 ms at
// 3.35 TB/s.  The 5 nu^2 + 4 d1^2 FMAs a facet are about a fifth of that
// time in float32.  Every table must therefore be read once, Dinv0 too,
// which phases 1 and 5 both apply: one facet's Dinv0 (32 KB at d1 = 45)
// and Sinv exceed what one thread block can stage for enough facets.
//
// What the design does about it (the plan, F facets and a cluster of CS
// thread blocks, comes from linalg/preconditioners.py:patch_wide_plan):
// - a cluster of CS thread blocks on neighbouring SMs owns F consecutive
//   facets (table columns, aligned to F); rank r owns the scalar rows
//   i0 .. i1 - 1 of d1 (d1 split as evenly as CS allows) in both
//   components, rows i and d1 + i of every phase, so each row of K01 and
//   K10 has one owner too;
// - at the start one thread issues TMA box loads of the rank's rows of
//   Dinv0 for the F facets into shared memory (a box is one scalar row's
//   nu table rows by F columns, on its own mbarrier), where they stay from
//   phase 1 to phase 5: every table entry is read from device memory once;
// - a thread owns one row of one facet, lanes along facets (F x the
//   element size = 64 or 128 bytes of a table row a slot: two slots a warp,
//   or one); Dinv0's sums read shared memory (where two slots share a warp
//   the odd one walks j ^ 1, so the two read distinct banks), K10, Sinv and K01 stream from device
//   memory in groups of K3W_U loads, the next group in flight while the
//   last one's FMAs run, and each phase's first group is loaded before the
//   cluster barrier that precedes the phase (K10's before phase 1);
// - each phase writes the rank's rows of its vector (w, t, y1, u) into
//   every rank's copy of the whole vector through distributed shared
//   memory (cooperative_groups map_shared_rank), and one cluster barrier
//   (release/acquire) sits between phases;
// - Cp and Bp (nu x nu, one a colour) are read through L1, the same address
//   across a slot's lanes, while the K10 and K01 loads are in flight.
// Staging all four tables' rows with TMA instead (so every load is
// asynchronous), and a persistent cluster that double-buffers Dinv0's
// rows, were both slower at every width tried on the H100.  So were, at d1 =
// 91 .. 120 against the plan without a cluster below, non-portable
// clusters of up to 16 and 32-byte table rows, which would keep Dinv0 on
// chip to d1 = 128 but leave a rank too few rows to keep loads in flight.
//
// Past every cluster plan (from d1 = 81: a rank's rows of Dinv0 for 16
// facets no longer fit one SM on 8 ranks) the plan has CS = 0 and
// patch_solve_wide_kernel_dev runs instead: one thread block of 256
// threads owns F facets (32, or 16 or 8 where the vectors do not fit) and
// stages only their three vectors ([nu][F]: r0 then u, w then y1, t); F
// lanes by 256 / F row slots, a slot computing the rows slot, slot + 256 /
// F, ... of each phase, each row's table terms streamed in K3W_U load
// groups into eight sums; every table is read once from device memory but
// Dinv0, which phases 1 and 5 both read.  One __syncthreads between
// phases.  It takes any width whose vectors fit a block (float64 d1 <= 605).
// Tiles are aligned in table columns (TMA reads from a 16-byte aligned
// column; the colour's first and last tiles mask the facets outside it,
// and TMA fills columns past off + m with zeros).
//
// bfloat16 factors (IEHDG_PC_BF16=1, entry iehdg_patch_solve_wide_bf16):
// Dinv0 and Sinv are bfloat16 tables with a column stride of their own;
// both plans read them as bfloat16 and turn each entry into float32 at
// use, K01, K10, the penalty blocks and the vectors stay float32 and the
// sums accumulate in float32, as `_patch_pallas` does on bfloat16 tiles.
// The plans keep float32's facets a tile (F x 4 = 64 or 128 bytes of a
// vector row); a cluster rank's staged rows of Dinv0 take half the shared
// bytes (patch_wide_layout counts the table's element size apart from the
// vectors'), and a warp's loads of a factor row are 32 or 64 bytes.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

constexpr int PATCH_WIDE_SMEM_MAX = 232448;
constexpr int PATCH_WIDE_CLUSTER_MAX = 8;

// shared-memory layout, in bytes: 2 RS Dinv0 slots (nu table rows x F
// each, of `tsize` bytes an entry), two vectors (nu x F of `size` bytes:
// r0, then t, then u; w, then y1), every region 128-byte aligned; then an
// mbarrier a slot
struct PatchWideLayout {
  int sd;  // slot size, in table entries
  int off_d, off_x, off_w, off_bar;
  long long bytes;
};

__host__ __device__ inline PatchWideLayout patch_wide_layout(int d1, int F, int RS, int size,
                                                             int tsize) {
  PatchWideLayout L;
  const int slot = iehdg_round_up(2 * d1 * F * tsize, 128);
  const int vec = iehdg_round_up(2 * d1 * F * size, 128);
  L.sd = slot / tsize;
  L.off_d = 0;
  L.off_x = L.off_d + 2 * RS * slot;
  L.off_w = L.off_x + vec;
  L.off_bar = L.off_w + vec;
  L.bytes = (long long)L.off_bar + 2 * RS * 8;
  return L;
}

constexpr int K3W_U = 16;               // table loads a group (in flight a thread: two)
constexpr int K3W_THREADS_MAX = 512;    // 128 registers a thread
constexpr int PATCH_WIDE_DEV_THREADS = 256;  // the plan without a cluster

// sum_j A[j ^ jx][lane] x[j ^ jx][lane] over n (even) terms of a staged
// slot A (of T or bfloat16) and vector x ([j][F], from the thread's lane):
// with jx = 1 each pair of terms is read in swapped order (two base
// pointers)
template <typename T, int F, typename TA>
__device__ __forceinline__ T smem_dot(const TA* A, const T* x, int n, int jx) {
  const int s = jx * F;
  const TA *Ae = A + s, *Ao = A - s;
  const T *xe = x + s, *xo = x - s;
  T acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = T(0);
  int j = 0;
  for (; j + 8 <= n; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; u += 2) {
      acc[u] += tab_val(Ae[(j + u) * F]) * xe[(j + u) * F];
      acc[u + 1] += tab_val(Ao[(j + u + 1) * F]) * xo[(j + u + 1) * F];
    }
  }
  for (; j < n; j += 2) {
    acc[0] += tab_val(Ae[j * F]) * xe[j * F];
    acc[1] += tab_val(Ao[(j + 1) * F]) * xo[(j + 1) * F];
  }
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

// The loads of a table row at the thread's column, K3W_U terms a group:
// group j0 of the n terms A[j * ld] into v (rows past n read row n - 1),
// a bfloat16 table's entries as T
template <typename T, typename TA>
__device__ __forceinline__ void load_group(T (&v)[K3W_U], const TA* __restrict__ A, long long ld,
                                           int j0, int n) {
  const TA* q = A + (long long)j0 * ld;
#pragma unroll
  for (int u = 0; u < K3W_U; ++u) {
    v[u] = tab_val(__ldg(q));
    if (j0 + u + 1 < n) q += ld;
  }
}

// sum_j A[j * ld] x[j * F] over n terms, with group 0 already in v: each
// group's FMAs run while the next group's loads are in flight
template <typename T, typename TA>
__device__ __forceinline__ T stream_dot(T (&v)[K3W_U], const TA* __restrict__ A, long long ld,
                                        int n, const T* x, int F) {
  T acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = T(0);
  int j = 0;
  for (; j + K3W_U < n; j += K3W_U) {
    T w[K3W_U];
    load_group(w, A, ld, j + K3W_U, n);
#pragma unroll
    for (int u = 0; u < K3W_U; ++u) {
      acc[u % 8] += v[u] * x[(j + u) * F];
      v[u] = w[u];
    }
  }
#pragma unroll
  for (int u = 0; u < K3W_U; ++u) acc[u % 8] += j + u < n ? v[u] * x[(j + u) * F] : T(0);
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

// (I2 (x) K + P)[row, :] x for the thread's facet: K the thread's scalar
// row i at its column (stride ld), whose first group is already in v, P
// the colour's nu x nu block (through L1), summed while K's loads fly
template <typename T, int F>
__device__ __forceinline__ T cross_dot(T (&v)[K3W_U], const T* __restrict__ K, long long ld,
                                       const T* __restrict__ P, const T* x, int d1, int a,
                                       int row) {
  const int nu = 2 * d1;
  T acc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = T(0);
  const T* p = P + (long long)row * nu;
  int j = 0;
  for (; j + 4 <= nu; j += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += __ldg(p + j + u) * x[(j + u) * F];
  }
  for (; j < nu; ++j) acc[0] += __ldg(p + j) * x[j * F];
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + stream_dot(v, K, ld, d1, x + a * d1 * F, F);
}

// this thread's value of the rank's row `row` (of F facets) into every
// rank's copy of a vector
template <typename T>
__device__ __forceinline__ void push_row(cg::cluster_group& cl, T* v, int row, int lane, int F,
                                         int CS, T val) {
  for (int r = 0; r < CS; ++r) cl.map_shared_rank(v, r)[row * F + lane] = val;
}

// T the working type, TF the factors' (Si here, Dinv0 through mD): T, or
// bfloat16 with float32; ldf the factors' column stride, ld the others'
template <typename T, typename TF, int F>
__global__ void __launch_bounds__(K3W_THREADS_MAX) patch_solve_wide_kernel(
    const __grid_constant__ CUtensorMap mD, const TF* __restrict__ Si, const T* __restrict__ K01,
    const T* __restrict__ K10, long long ldf, long long ld, int d1, int RS, long long off,
    const T* __restrict__ Bp, const T* __restrict__ Cp, const T* __restrict__ r0,
    const T* __restrict__ r1, T* __restrict__ y0, T* __restrict__ y1, long long m) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int CS = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int nu = 2 * d1;
  // The layout's offsets: in entries of T where the factors are of T, in
  // bytes where they are bfloat16 (patch_wide_layout).  Each form keeps its
  // kernel at F = 32 in 64 registers, two thread blocks of 512 threads an SM
  // (the other form cost ptxas 74 registers or a 12-byte spill at float32,
  // 66 registers and a third of the speed at bfloat16, d1 = 45)
  int sd;  // a Dinv0 slot's table entries
  TF* sD;
  T *sx, *sw;  // r0, then t, then u; w, then y1
  uint64_t* bar;  // a slot each
  if constexpr (std::is_same<T, TF>::value) {
    sd = iehdg_round_up(2 * d1 * F, 128 / (int)sizeof(T));
    T* sm = reinterpret_cast<T*>(smem_raw);
    sD = sm;
    sx = sm + 2 * RS * sd;
    sw = sx + sd;
    bar = reinterpret_cast<uint64_t*>(smem_raw + (2 * RS + 2) * sd * sizeof(T));
  } else {
    const PatchWideLayout L = patch_wide_layout(d1, F, RS, (int)sizeof(T), (int)sizeof(TF));
    sd = L.sd;
    sD = reinterpret_cast<TF*>(smem_raw + L.off_d);
    sx = reinterpret_cast<T*>(smem_raw + L.off_x);
    sw = reinterpret_cast<T*>(smem_raw + L.off_w);
    bar = reinterpret_cast<uint64_t*>(smem_raw + L.off_bar);
  }
  const int i0 = (int)((long long)rank * d1 / CS), i1 = (int)((long long)(rank + 1) * d1 / CS);
  const int rs = i1 - i0;  // scalar rows of this rank (<= RS)
  // the cluster's tile: table columns col .. col + F - 1 (aligned), facets c = col - off
  const long long col0 = off - off % F + (long long)(blockIdx.x / CS) * F;
  const int tid = threadIdx.x, nt = blockDim.x;

  if (tid == 0) {
    for (int k = 0; k < 2 * RS; ++k) mbar_init(bar + k, 1);
    mbar_fence_init();
    const int c = (int)col0;
    for (int il = 0; il < rs; ++il)
      for (int a = 0; a < 2; ++a) {
        const int k = a * RS + il;
        mbar_expect_tx(bar + k, (uint32_t)(nu * F * sizeof(TF)));
        tma_load_2d(sD + k * sd, &mD, c, (a * d1 + i0 + il) * nu, bar + k);
      }
  }
  // the whole r0 of the F facets, and the thread's own row of r1
  for (int e = tid; e < nu * F; e += nt) {
    const int j = e / F, ln = e % F;
    const long long c = col0 + ln - off;
    sx[e] = c >= 0 && c < m ? r0[j * m + c] : T(0);
  }
  const int lane = tid % F, slot = tid / F;
  const int a = slot >= RS ? 1 : 0, il = slot - a * RS;
  const bool act = il < rs;
  const int i = i0 + il, row = a * d1 + i;  // the thread's rows of K and of every phase
  const long long c = col0 + lane - off;
  const bool in = act && c >= 0 && c < m;
  const long long tcol = in ? col0 + lane : off;  // a column of the colour for masked lanes
  const int jx = F * (int)sizeof(T) < 128 ? (slot & 1) : 0;  // two slots a warp: distinct banks
  const T r1v = in ? r1[row * m + c] : T(0);
  const TF* Dr = sD + (a * RS + il) * sd + lane;
  const T* K10r = K10 + (long long)i * d1 * ld + tcol;
  const TF* Sr = Si + (long long)row * nu * ldf + tcol;
  const T* K01r = K01 + (long long)i * d1 * ld + tcol;
  T v0[K3W_U];  // the first group of the next phase's table row, loaded ahead
  if (act) load_group(v0, K10r, ld, 0, d1);
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();  // barriers initialised, r0 staged

  // w = Dinv0 r0
  const T r0v = act ? sx[row * F + lane] : T(0);  // for phase 4: t and u take r0's place
  if (act) mbar_wait(bar + a * RS + il, 0);
  T v = act ? smem_dot<T, F>(Dr, sx + lane, nu, jx) : T(0);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank runs
  if (act) push_row(cl, sw, row, lane, F, CS, v);
  cl.sync();

  // t = r1 - (I2 (x) K10 + Cp) w (into r0: every rank has read r0)
  if (act) {
    v = r1v - cross_dot<T, F>(v0, K10r, ld, Cp, sw + lane, d1, a, row);
    load_group(v0, Sr, ldf, 0, nu);
    push_row(cl, sx, row, lane, F, CS, v);
  }
  cl.sync();

  // y1 = Sinv t (into w: every rank has read w)
  if (act) {
    v = stream_dot(v0, Sr, ldf, nu, sx + lane, F);
    load_group(v0, K01r, ld, 0, d1);
    if (in) y1[row * m + c] = v;
    push_row(cl, sw, row, lane, F, CS, v);
  }
  cl.sync();

  // u = r0 - (I2 (x) K01 + Bp) y1 (into t: every rank has read t)
  if (act) {
    v = r0v - cross_dot<T, F>(v0, K01r, ld, Bp, sw + lane, d1, a, row);
    push_row(cl, sx, row, lane, F, CS, v);
  }
  cl.sync();  // no rank touches another's shared memory after this

  // y0 = Dinv0 u
  if (act) {
    v = smem_dot<T, F>(Dr, sx + lane, nu, jx);
    if (in) y0[row * m + c] = v;
  }
}

// acc = sum_j A[row, j, col] x[j] over an nu x nu table (column stride ld,
// of T or bfloat16) and a staged vector x ([j][F], the thread's lane):
// K3W_U loads in flight and eight sums (stream_dot)
template <typename T, typename TA>
__device__ __forceinline__ T table_dot(const TA* __restrict__ A, long long ld, int nu, int row,
                                       const T* x, int F) {
  const TA* a = A + (long long)row * nu * ld;
  T v[K3W_U];
  load_group(v, a, ld, 0, nu);
  return stream_dot(v, a, ld, nu, x, F);
}

// (I2 (x) K + P)[row, :] x for the facet of the thread's lane (K the d1 x d1
// table at the facet's column, P the colour's nu x nu block, summed while
// K's first group of loads is in flight)
template <typename T>
__device__ __forceinline__ T cross_dot_dev(const T* __restrict__ K, long long ld,
                                           const T* __restrict__ P, int d1, int row, const T* x,
                                           int F) {
  const int a = row >= d1 ? 1 : 0;
  const T* k = K + (long long)(row - a * d1) * d1 * ld;
  T v[K3W_U];
  load_group(v, k, ld, 0, d1);
  const int nu = 2 * d1;
  T acc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = T(0);
  const T* p = P + (long long)row * nu;
  int j = 0;
  for (; j + 4 <= nu; j += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += __ldg(p + j + u) * x[(j + u) * F];
  }
  for (; j < nu; ++j) acc[0] += __ldg(p + j) * x[j * F];
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + stream_dot(v, k, ld, d1, x + a * d1 * F, F);
}

template <typename T, typename TF>
__global__ void __launch_bounds__(PATCH_WIDE_DEV_THREADS) patch_solve_wide_kernel_dev(
    int d1, const TF* __restrict__ Di, const TF* __restrict__ Si, const T* __restrict__ K01,
    const T* __restrict__ K10, long long ldf, long long ld, long long off,
    const T* __restrict__ Bp,
    const T* __restrict__ Cp, const T* __restrict__ r0, const T* __restrict__ r1,
    T* __restrict__ y0, T* __restrict__ y1, long long m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nu = 2 * d1;
  const int F = blockDim.x, slots = blockDim.y;
  const int lane = threadIdx.x, slot = threadIdx.y;
  T* su = reinterpret_cast<T*>(smem_raw);  // r0, later u
  T* sw = su + nu * F;                      // w, later y1
  T* st = sw + nu * F;                      // t
  // tile b: table columns col .. col + F - 1 (aligned), facets c = col - off
  const long long col = off - off % F + (long long)blockIdx.x * F + lane;
  const long long c = col - off;
  const bool in = c >= 0 && c < m;
  const long long tcol = in ? col : off;  // a valid column for masked lanes
  const TF* Dc = Di + tcol;
  const TF* Sc = Si + tcol;
  const T* K01c = K01 + tcol;
  const T* K10c = K10 + tcol;

  for (int row = slot; row < nu; row += slots) su[row * F + lane] = in ? r0[row * m + c] : T(0);
  __syncthreads();
  // w = Dinv0 r0
  for (int row = slot; row < nu; row += slots)
    sw[row * F + lane] = table_dot(Dc, ldf, nu, row, su + lane, F);
  __syncthreads();
  // t = r1 - (I2 (x) K10 + Cp) w
  for (int row = slot; row < nu; row += slots) {
    const T r = in ? r1[row * m + c] : T(0);
    st[row * F + lane] = r - cross_dot_dev(K10c, ld, Cp, d1, row, sw + lane, F);
  }
  __syncthreads();
  // y1 = Sinv t (kept in w)
  for (int row = slot; row < nu; row += slots) {
    const T v = table_dot(Sc, ldf, nu, row, st + lane, F);
    sw[row * F + lane] = v;
    if (in) y1[row * m + c] = v;
  }
  __syncthreads();
  // u = r0 - (I2 (x) K01 + Bp) y1 (each thread updates its own rows of u)
  for (int row = slot; row < nu; row += slots)
    su[row * F + lane] -= cross_dot_dev(K01c, ld, Bp, d1, row, sw + lane, F);
  __syncthreads();
  // y0 = Dinv0 u
  for (int row = slot; row < nu; row += slots) {
    const T v = table_dot(Dc, ldf, nu, row, su + lane, F);
    if (in) y0[row * m + c] = v;
  }
}

// the plan without a cluster (CS = 0): F facets a block of
// PATCH_WIDE_DEV_THREADS threads, `smem` = the three vectors' bytes
template <typename T, typename TF>
static int launch_dev(int d1, int F, int threads, long long smem, const void* Di,
                      const void* Si, const void* K01, const void* K10, long long ldf,
                      long long ld, long long off, const void* Bp, const void* Cp,
                      const void* r0, const void* r1, void* y0, void* y1, long long m,
                      cudaStream_t stream) {
  if ((F != 8 && F != 16 && F != 32) || threads != PATCH_WIDE_DEV_THREADS ||
      smem != 3LL * 2 * d1 * F * (long long)sizeof(T) || smem > PATCH_WIDE_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  static bool attr = false;  // the cap only: a launch takes the bytes it asks for
  if (!attr) {
    const cudaError_t a = cudaFuncSetAttribute(
        patch_solve_wide_kernel_dev<T, TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PATCH_WIDE_SMEM_MAX);
    if (a != cudaSuccess) return (int)a;
    attr = true;
  }
  const long long ntiles = off % F + m;  // columns from the aligned first tile
  const dim3 block(F, PATCH_WIDE_DEV_THREADS / F);
  patch_solve_wide_kernel_dev<T, TF><<<blocks_for(ntiles, F), block, smem, stream>>>(
      d1, (const TF*)Di, (const TF*)Si, (const T*)K01, (const T*)K10, ldf, ld, off,
      (const T*)Bp, (const T*)Cp, (const T*)r0, (const T*)r1, (T*)y0, (T*)y1, m);
  return (int)cudaGetLastError();
}

template <typename T, typename TF>
static int launch(int d1, int F, int CS, int threads, long long smem, const void* Di,
                  const void* Si, const void* K01, const void* K10, long long ldf, long long ld,
                  long long off, const void* Bp, const void* Cp, const void* r0, const void* r1,
                  void* y0, void* y1, long long m, cudaStream_t stream) {
  const int nu = 2 * d1;
  const int RS = (d1 + CS - 1) / CS;
  const PatchWideLayout L = patch_wide_layout(d1, F, RS, (int)sizeof(T), (int)sizeof(TF));
  if (smem != L.bytes || smem > PATCH_WIDE_SMEM_MAX || threads != 2 * RS * F ||
      threads > K3W_THREADS_MAX || nu > 256 || F > 256 ||
      (F * (int)sizeof(T) != 64 && F * (int)sizeof(T) != 128) ||
      off + m > 0x7fffffffLL)  // TMA boxes: at most 256 a side, int32 coordinates
    return (int)cudaErrorInvalidValue;
  const long long ncols = off + m;
  CUtensorMap mD;
  if (((uintptr_t)Di | (uintptr_t)Si | (uintptr_t)K01 | (uintptr_t)K10) % 16 ||
      (ld * (long long)sizeof(T)) % 16 || (ldf * (long long)sizeof(TF)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int e = encode_table_map(&mD, Di, (int)sizeof(TF), (long long)nu * nu, ldf, ncols, F, nu);
  if (e) return e;
  void (*kernel)(const CUtensorMap, const TF*, const T*, const T*, long long, long long, int,
                 int, long long, const T*, const T*, const T*, const T*, T*, T*, long long) =
      F * (int)sizeof(T) == 64 ? patch_solve_wide_kernel<T, TF, 64 / sizeof(T)>
                               : patch_solve_wide_kernel<T, TF, 128 / sizeof(T)>;
  static bool attr = false;  // the cap only: a launch takes the bytes it asks for
  if (!attr) {
    cudaError_t a = cudaFuncSetAttribute(patch_solve_wide_kernel<T, TF, 64 / sizeof(T)>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         PATCH_WIDE_SMEM_MAX);
    if (a == cudaSuccess)
      a = cudaFuncSetAttribute(patch_solve_wide_kernel<T, TF, 128 / sizeof(T)>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, PATCH_WIDE_SMEM_MAX);
    if (a != cudaSuccess) return (int)a;
    attr = true;
  }
  const long long ntiles = off % F + m;  // columns from the aligned first tile
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_for(ntiles, F) * CS);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CS;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, kernel, mD, (const TF*)Si, (const T*)K01, (const T*)K10, ldf, ld, d1, RS, off,
      (const T*)Bp, (const T*)Cp, (const T*)r0, (const T*)r1, (T*)y0, (T*)y1, m);
  return le != cudaSuccess ? (int)le : (int)cudaGetLastError();
}

// dtype: 0 float32, 1 float64.  Di/Si (nu, nu, ld-strided columns), K01/K10
// (d1, d1, ld-strided columns) with 16-byte aligned bases and rows, Bp/Cp
// (nu, nu), r0/r1/y0/y1 (nu, m), contiguous; the colour's table columns are
// off .. off + m - 1.  The plan (preconditioners.py:patch_wide_plan): F
// facets a cluster of CS thread blocks (F x the element size 64 or 128
// bytes), `threads` = 2 ceil(d1 / CS) F,
// `smem` the bytes of the layout above; or CS = 0, F = 8, 16 or 32 facets a
// thread block of 256 threads, `smem` = 3 nu F elements (the plan without a
// cluster); one that does not match returns cudaErrorInvalidValue.
IEHDG_EXPORT int iehdg_patch_solve_wide(int device, int dtype, int d1, int F, int CS,
                                        int threads, long long smem, const void* Di,
                                        const void* Si, const void* K01, const void* K10,
                                        long long ld, long long off, const void* Bp,
                                        const void* Cp, const void* r0, const void* r1,
                                        void* y0, void* y1, long long m, void* stream) {
  if (d1 < 1 || m < 1 || F < 1 || CS < 0 || CS > PATCH_WIDE_CLUSTER_MAX || CS > d1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (CS == 0 && dtype == 0)
    return launch_dev<float, float>(d1, F, threads, smem, Di, Si, K01, K10, ld, ld, off, Bp, Cp,
                                    r0, r1, y0, y1, m, st);
  if (CS == 0 && dtype == 1)
    return launch_dev<double, double>(d1, F, threads, smem, Di, Si, K01, K10, ld, ld, off, Bp,
                                      Cp, r0, r1, y0, y1, m, st);
  if (dtype == 0)
    return launch<float, float>(d1, F, CS, threads, smem, Di, Si, K01, K10, ld, ld, off, Bp, Cp,
                                r0, r1, y0, y1, m, st);
  if (dtype == 1)
    return launch<double, double>(d1, F, CS, threads, smem, Di, Si, K01, K10, ld, ld, off, Bp,
                                  Cp, r0, r1, y0, y1, m, st);
  return (int)cudaErrorInvalidValue;
}

// dtype 2 only (float32, bfloat16 factors): Di/Si bfloat16 with column
// stride ldf, K01/K10 float32 with ld, the plan's bytes counting the staged
// rows of Dinv0 in bfloat16; every other operand as
// iehdg_patch_solve_wide's.
IEHDG_EXPORT int iehdg_patch_solve_wide_bf16(int device, int dtype, int d1, int F, int CS,
                                             int threads, long long smem, const void* Di,
                                             const void* Si, const void* K01, const void* K10,
                                             long long ldf, long long ld, long long off,
                                             const void* Bp, const void* Cp, const void* r0,
                                             const void* r1, void* y0, void* y1, long long m,
                                             void* stream) {
  if (dtype != 2 || d1 < 1 || m < 1 || F < 1 || CS < 0 || CS > PATCH_WIDE_CLUSTER_MAX ||
      CS > d1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (CS == 0)
    return launch_dev<float, __nv_bfloat16>(d1, F, threads, smem, Di, Si, K01, K10, ldf, ld,
                                            off, Bp, Cp, r0, r1, y0, y1, m, st);
  return launch<float, __nv_bfloat16>(d1, F, CS, threads, smem, Di, Si, K01, K10, ldf, ld, off,
                                      Bp, Cp, r0, r1, y0, y1, m, st);
}
