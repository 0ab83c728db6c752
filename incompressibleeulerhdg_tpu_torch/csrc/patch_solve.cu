// K3: fused facet-pair patch solve of one facet colour
//
// For every facet c of the colour (table column off + c) the exact 2x2
// block-Schur solve of the [plus cell, minus cell] patch:
//
//     w  = Dinv0 r0
//     t  = r1 - (I2 (x) K10 + Cp) w
//     y1 = Sinv t
//     y0 = Dinv0 (r0 - (I2 (x) K01 + Bp) y1)
//
// Replaces the Pallas kernel incompressibleeulerhdg_tpu/linalg/preconditioners.py
// `_patch_pallas` (kernel body `_patch_kernel_factory`); its caller is
// `_patch_color_structured`, 2 * ncol - 1 = 5 times per symmetric sweep.
//
// What bounds it on the card: table bytes.  At 256^2, k=2, float32 one
// colour (65,280 facets) holds Dinv0 + Sinv = 2 * 20*20*65280*4 B = 209 MB
// and K01 + K10 = 52 MB, plus 21 MB of fields: 282 MB, 0.084 ms at 3.35 TB/s.
// The 4 nu^2 + 4 nu d1 FMAs per facet are far below the arithmetic rate.
//
// What the design does about it:
// - a block owns a tile of TC consecutive table columns (aligned: TMA reads
//   from a 16-byte aligned column; a colour's first and last tiles mask the
//   columns outside it); one thread starts TMA
//   loads of the tile's Dinv0, K10, Sinv and K01 (in the order the phases
//   need them, each on its own mbarrier), so every table is read from HBM
//   once: Dinv0 stays in shared memory from the first phase to the last;
// - the tiles are sized for three blocks an SM (about 70 KB each, 64-byte
//   table rows, dynamic shared memory), so while one block computes, the
//   others' loads are in flight, with no thread spending registers on them;
// - a thread owns one row of VEC facets (16 bytes) in every phase and reads
//   the table and the facet vectors (r0 and its update, w and then y1, t)
//   with 16-byte shared loads; its sum over j starts at j = row, so the
//   rows a warp reads together fall in distinct banks;
// - every thread loads its own row of r0 and r1 at the start, all loads in
//   flight together (a block otherwise waits out one global latency per
//   loop trip); Cp and Bp are read through L1.
// No tensor cores: every facet has its own matrices (no reuse).
//
// bfloat16 factors (IEHDG_PC_BF16=1, entry iehdg_patch_solve_bf16): Dinv0
// and Sinv are read as bfloat16 from their own ld-strided tables and turned
// into float32 as they leave shared memory, K01, K10, the penalty blocks
// and the vectors stay float32 and every sum accumulates in float32: what
// `_patch_pallas` computes on bfloat16 Di5/Si5 tiles.  The tile keeps the
// float32 TC (a thread still owns 4 facets of a row), so the factors' box
// rows are half as many bytes (32 or 16), their tables 2 nu^2 of the 2 nu^2
// + 2 d1^2 rows; each table's mbarrier expects its own box bytes.  The
// bytes bound falls from 40 d1^2 + 32 d1 to 24 d1^2 + 32 d1 a facet.
//
// Widths: the port dispatches d1 = 3 .. 15 (k = 0 .. 3) here.  Above d1 =
// 15 a tile is one 16-byte row of facets (TC = VEC, the TMA minimum), and
// the four tables of that tile take 2 nu^2 + 2 d1^2 rows of 16 bytes: at
// d1 = 21 a block has nu = 42 threads, its sums unroll 7 at a time to stay
// under 255 registers, and it reached 35% of the bytes bound against K3w's
// 59% in one process on the H100; from d1 = 28 (128,768 B) a block runs
// alone on its SM (29%, 19% at d1 = 28, 36), and d1 = 45 exceeds the
// 232,448 B a block may use.  Every wider d1 goes to K3w
// (csrc/patch_solve_wide.cu), which splits a facet tile's rows over a
// thread-block cluster; tools/ab_patch.py builds this template at d1 = 21,
// 28, 36 to time it against K3w.
#include "common.cuh"
#include "tma.cuh"

template <typename T>
__device__ __forceinline__ void vfma(T* acc, T a, const typename Vec<T>::type& v);
template <>
__device__ __forceinline__ void vfma<float>(float* acc, float a, const float4& v) {
  acc[0] += a * v.x; acc[1] += a * v.y; acc[2] += a * v.z; acc[3] += a * v.w;
}
template <>
__device__ __forceinline__ void vfma<double>(double* acc, double a, const double2& v) {
  acc[0] += a * v.x; acc[1] += a * v.y;
}
template <typename T>
__device__ __forceinline__ void vfma2(T* acc, const typename Vec<T>::type& a,
                                      const typename Vec<T>::type& v);
template <>
__device__ __forceinline__ void vfma2<float>(float* acc, const float4& a, const float4& v) {
  acc[0] += a.x * v.x; acc[1] += a.y * v.y; acc[2] += a.z * v.z; acc[3] += a.w * v.w;
}
template <>
__device__ __forceinline__ void vfma2<double>(double* acc, const double2& a, const double2& v) {
  acc[0] += a.x * v.x; acc[1] += a.y * v.y;
}

// T the working type, TF the factors' (Dinv0, Sinv): T, or bfloat16 with
// float32
template <typename T, typename TF, int D1>
struct PatchTile {
  static constexpr int NU = 2 * D1;
  static constexpr int VEC = Vec<T>::n;
  // facets a tile: 64-byte table rows up to d1 = 10, fewer above, so a
  // block's tables stay near 70 KB (three blocks an SM)
  static constexpr int TC = (64 / (int)sizeof(T)) / (D1 > 15 ? 4 : D1 > 10 ? 2 : 1);
  static constexpr int Q = TC / VEC;          // facet groups a tile
  static constexpr int THREADS = NU * Q;      // one row of one group each
  static constexpr TableBox BD = table_box<TF, TC>(NU * NU);
  static constexpr TableBox BK = table_box<T, TC>(D1 * D1);
  // shared memory, in bytes (every region a multiple of 128 bytes)
  static constexpr int DBYTES = BD.padded * TC * (int)sizeof(TF);
  static constexpr int KBYTES = BK.padded * TC * (int)sizeof(T);
  static constexpr int VBYTES = iehdg_round_up(NU * TC * (int)sizeof(T), 128);
  static constexpr int OFF_D = 0;
  static constexpr int OFF_K10 = OFF_D + DBYTES;
  static constexpr int OFF_S = OFF_K10 + KBYTES;
  static constexpr int OFF_K01 = OFF_S + DBYTES;
  static constexpr int OFF_U = OFF_K01 + KBYTES;
  static constexpr int OFF_W = OFF_U + VBYTES;
  static constexpr int OFF_T = OFF_W + VBYTES;
  static constexpr int END = OFF_T + VBYTES;
  static constexpr int SMEM = END + 4 * 8;  // + 4 mbarriers
};

// unroll factor of a sum over n terms: whole up to n = 20, 7 above (d1 =
// 15, 21), where the whole sums' hoisted loads need more than 255
// registers (ptxas spilled 52 bytes a thread at d1 = 21, float32); in
// float64 9 where 9 divides n (d1 = 36, where 7 spilled 8 bytes, and 9 in
// float32 12)
template <typename T, int n>
constexpr int UNROLL = n > 20 ? (sizeof(T) == 8 && n % 9 == 0 ? 9 : 7) : n;

// acc[v] = sum_j A[row, j] x[j] over the NU x NU tile table A ([row][TC],
// of T or of bfloat16) and the tile vector x ([j][TC]) for the thread's
// facets q * VEC ..
template <typename T, int NU, int TC, typename TA>
__device__ __forceinline__ void row_dot(T* acc, const TA* A, const T* x, int row, int q) {
  using V = typename Vec<T>::type;
  constexpr int VEC = Vec<T>::n;
#pragma unroll(UNROLL<T, NU>)
  for (int jj = 0; jj < NU; ++jj) {
    int j = jj + row;
    j = j >= NU ? j - NU : j;
    const V a = tab_vec(A + (row * NU + j) * TC + q * VEC);
    const V v = *reinterpret_cast<const V*>(x + j * TC + q * VEC);
    vfma2<T>(acc, a, v);
  }
}

// acc[v] += (I2 (x) K + P)[row, :] x for the thread's facets (K the D1 x D1
// tile table, P the colour's constant block, read through L1)
template <typename T, int D1, int TC>
__device__ __forceinline__ void cross_row(T* acc, const T* K, const T* P, const T* x, int row,
                                          int q) {
  using V = typename Vec<T>::type;
  constexpr int NU = 2 * D1;
  constexpr int VEC = Vec<T>::n;
  const int a = row >= D1 ? 1 : 0;
  const int i = row - a * D1;
#pragma unroll(UNROLL<T, NU>)
  for (int jj = 0; jj < NU; ++jj) {
    int j = jj + row;
    j = j >= NU ? j - NU : j;
    vfma<T>(acc, __ldg(P + row * NU + j), *reinterpret_cast<const V*>(x + j * TC + q * VEC));
  }
#pragma unroll(UNROLL<T, D1>)
  for (int jj = 0; jj < D1; ++jj) {
    int j = jj + i;
    j = j >= D1 ? j - D1 : j;
    const V k = *reinterpret_cast<const V*>(K + (i * D1 + j) * TC + q * VEC);
    const V v = *reinterpret_cast<const V*>(x + (a * D1 + j) * TC + q * VEC);
    vfma2<T>(acc, k, v);
  }
}

template <typename T, typename TF, int D1>
__global__ void __launch_bounds__(PatchTile<T, TF, D1>::THREADS) patch_solve_kernel(
    const __grid_constant__ CUtensorMap mD, const __grid_constant__ CUtensorMap mS,
    const __grid_constant__ CUtensorMap m01, const __grid_constant__ CUtensorMap m10,
    long long off, const T* __restrict__ Bp, const T* __restrict__ Cp,
    const T* __restrict__ r0, const T* __restrict__ r1, T* __restrict__ y0,
    T* __restrict__ y1, long long m) {
  using P = PatchTile<T, TF, D1>;
  constexpr int NU = P::NU, TC = P::TC, VEC = P::VEC, Q = P::Q;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  TF* sD = reinterpret_cast<TF*>(smem_raw + P::OFF_D);
  T* sK10 = reinterpret_cast<T*>(smem_raw + P::OFF_K10);
  TF* sS = reinterpret_cast<TF*>(smem_raw + P::OFF_S);
  T* sK01 = reinterpret_cast<T*>(smem_raw + P::OFF_K01);
  T* su = reinterpret_cast<T*>(smem_raw + P::OFF_U);  // r0, later r0 - (I2 (x) K01 + Bp) y1
  T* sw = reinterpret_cast<T*>(smem_raw + P::OFF_W);  // w, later y1
  T* st = reinterpret_cast<T*>(smem_raw + P::OFF_T);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + P::SMEM - 4 * 8);
  const int tid = threadIdx.x;
  // tiles are aligned in table columns (TMA needs a 16-byte aligned first
  // column): tile b holds table columns col .. col + TC - 1, facets c0 ..
  const int col = (int)(off - off % TC) + blockIdx.x * TC;
  const long long c0 = col - off;

  if (tid == 0) {
    for (int k = 0; k < 4; ++k) mbar_init(bar + k, 1);
    mbar_fence_init();
    tma_load_table<TF, TC>(sD, &mD, NU * NU, col, bar + 0);
    tma_load_table<T, TC>(sK10, &m10, D1 * D1, col, bar + 1);
    tma_load_table<TF, TC>(sS, &mS, NU * NU, col, bar + 2);
    tma_load_table<T, TC>(sK01, &m01, D1 * D1, col, bar + 3);
  }
  // the thread's row of r0 (to shared memory) and of r1 (kept for phase 2),
  // all loads in flight together
  const int row = tid / Q, q = tid % Q;
  T r1v[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const long long c = c0 + q * VEC + v;
    const bool in = c >= 0 && c < m;
    su[row * TC + q * VEC + v] = in ? r0[row * m + c] : T(0);
    r1v[v] = in ? r1[row * m + c] : T(0);
  }
  __syncthreads();  // barriers initialised, u staged
  T acc[VEC];

  // w = Dinv0 r0
  mbar_wait(bar + 0, 0);
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = T(0);
  row_dot<T, NU, TC>(acc, sD, su, row, q);
#pragma unroll
  for (int v = 0; v < VEC; ++v) sw[row * TC + q * VEC + v] = acc[v];
  __syncthreads();

  // t = r1 - (I2 (x) K10 + Cp) w
  mbar_wait(bar + 1, 0);
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = T(0);
  cross_row<T, D1, TC>(acc, sK10, Cp, sw, row, q);
#pragma unroll
  for (int v = 0; v < VEC; ++v) st[row * TC + q * VEC + v] = r1v[v] - acc[v];
  __syncthreads();

  // y1 = Sinv t (kept in w)
  mbar_wait(bar + 2, 0);
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = T(0);
  row_dot<T, NU, TC>(acc, sS, st, row, q);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const long long c = c0 + q * VEC + v;
    sw[row * TC + q * VEC + v] = acc[v];
    if (c >= 0 && c < m) y1[row * m + c] = acc[v];
  }
  __syncthreads();

  // u = r0 - (I2 (x) K01 + Bp) y1
  mbar_wait(bar + 3, 0);
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = T(0);
  cross_row<T, D1, TC>(acc, sK01, Bp, sw, row, q);
#pragma unroll
  for (int v = 0; v < VEC; ++v) su[row * TC + q * VEC + v] -= acc[v];
  __syncthreads();

  // y0 = Dinv0 u
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = T(0);
  row_dot<T, NU, TC>(acc, sD, su, row, q);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const long long c = c0 + q * VEC + v;
    if (c >= 0 && c < m) y0[row * m + c] = acc[v];
  }
}

// factors (Di, Si) of TF with column stride ldf, K01/K10 of T with ldt
template <typename T, typename TF, int D1>
static int launch_tables(const void* Di, const void* Si, const void* K01, const void* K10,
                         long long ldf, long long ldt, long long off, const void* Bp,
                         const void* Cp, const void* r0, const void* r1, void* y0, void* y1,
                         long long m, cudaStream_t stream) {
  using P = PatchTile<T, TF, D1>;
  static_assert(P::THREADS <= 1024 && P::SMEM <= 232448, "patch tile too large");
  static_assert(P::TC % P::VEC == 0, "tile not a whole number of vectors");
  static_assert(P::TC * sizeof(TF) % 16 == 0, "a TMA box row is a multiple of 16 bytes");
  const long long ncols = off + m;
  CUtensorMap mD, mS, m01, m10;
  int e = encode_table<TF, P::TC>(&mD, Di, P::NU * P::NU, ldf, ncols);
  if (!e) e = encode_table<TF, P::TC>(&mS, Si, P::NU * P::NU, ldf, ncols);
  if (!e) e = encode_table<T, P::TC>(&m01, K01, D1 * D1, ldt, ncols);
  if (!e) e = encode_table<T, P::TC>(&m10, K10, D1 * D1, ldt, ncols);
  if (e) return e;
  static bool attr = false;
  if (!attr) {
    const cudaError_t a = cudaFuncSetAttribute(
        patch_solve_kernel<T, TF, D1>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (a != cudaSuccess) return (int)a;
    attr = true;
  }
  const long long ntiles = off % P::TC + m;  // columns from the aligned first tile
  patch_solve_kernel<T, TF, D1><<<blocks_for(ntiles, P::TC), P::THREADS, P::SMEM, stream>>>(
      mD, mS, m01, m10, off, (const T*)Bp, (const T*)Cp, (const T*)r0, (const T*)r1, (T*)y0,
      (T*)y1, m);
  return (int)cudaGetLastError();
}

// all four tables of T, one column stride
template <typename T, int D1>
static int launch(const void* Di, const void* Si, const void* K01, const void* K10,
                  long long ldt, long long off, const void* Bp, const void* Cp, const void* r0,
                  const void* r1, void* y0, void* y1, long long m, cudaStream_t stream) {
  return launch_tables<T, T, D1>(Di, Si, K01, K10, ldt, ldt, off, Bp, Cp, r0, r1, y0, y1, m,
                                 stream);
}

template <typename T, typename TF>
static int dispatch_d1(int d1, const void* Di, const void* Si, const void* K01,
                       const void* K10, long long ldf, long long ldt, long long off,
                       const void* Bp, const void* Cp, const void* r0,
                       const void* r1, void* y0, void* y1, long long m,
                       cudaStream_t st) {
  switch (d1) {
#define IEHDG_K3_CASE(N)                                                                     \
  case N:                                                                                    \
    return launch_tables<T, TF, N>(Di, Si, K01, K10, ldf, ldt, off, Bp, Cp, r0, r1, y0, y1, \
                                   m, st);
    IEHDG_K3_CASE(3)
    IEHDG_K3_CASE(6)
    IEHDG_K3_CASE(10)
    IEHDG_K3_CASE(15)
#undef IEHDG_K3_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 float64.  Di/Si (nu, nu, ldt), K01/K10 (d1, d1, ldt)
// with ldt * sizeof(T) a multiple of 16 bytes and 16-byte aligned bases;
// Bp/Cp (nu, nu), r0/r1/y0/y1 (nu, m), contiguous; the colour's table
// columns are off .. off + m - 1.
IEHDG_EXPORT int iehdg_patch_solve(int device, int dtype, int d1, const void* Di,
                                   const void* Si, const void* K01,
                                   const void* K10, long long ldt, long long off,
                                   const void* Bp, const void* Cp, const void* r0,
                                   const void* r1, void* y0, void* y1,
                                   long long m, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (off + m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // TMA coordinates are int32
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d1<float, float>(d1, Di, Si, K01, K10, ldt, ldt, off, Bp, Cp, r0, r1, y0,
                                     y1, m, st);
  if (dtype == 1)
    return dispatch_d1<double, double>(d1, Di, Si, K01, K10, ldt, ldt, off, Bp, Cp, r0, r1, y0,
                                       y1, m, st);
  return (int)cudaErrorInvalidValue;
}

// dtype 2 only (float32, bfloat16 factors): Di/Si (nu, nu, ldf) bfloat16,
// K01/K10 (d1, d1, ldt) float32, each with rows of a multiple of 16 bytes
// and 16-byte aligned bases; every other operand as iehdg_patch_solve's.
IEHDG_EXPORT int iehdg_patch_solve_bf16(int device, int dtype, int d1, const void* Di,
                                        const void* Si, const void* K01, const void* K10,
                                        long long ldf, long long ldt, long long off,
                                        const void* Bp, const void* Cp, const void* r0,
                                        const void* r1, void* y0, void* y1, long long m,
                                        void* stream) {
  if (dtype != 2) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (off + m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // TMA coordinates are int32
  return dispatch_d1<float, __nv_bfloat16>(d1, Di, Si, K01, K10, ldf, ldt, off, Bp, Cp, r0, r1,
                                           y0, y1, m, (cudaStream_t)stream);
}
