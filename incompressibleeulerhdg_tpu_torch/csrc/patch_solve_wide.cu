// K3w: the fused facet-pair patch solve of one facet colour (K3) at a width
// d1 given at run time (every degree; the port launches it for the widths
// that patch_solve.cu is not instantiated for, d1 = 45 (k = 7) and up).
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
// time in float32.
//
// What the design does about it: K3 stages one tile of all four tables in
// shared memory, which from d1 = 45 exceeds the 232,448 B a block may use
// (Dinv0 and Sinv of one 16-byte row of facets alone take 259,200 B).
// Here only the three facet vectors are staged: a block owns F
// consecutive facets of the colour (F = 32, or 16 or 8 where the vectors
// would not fit; the wrapper chooses F and passes it), laid out [nu][F] in
// shared memory (r0 then u, w then y1, t: 69 KB at d1 = 45, F = 32,
// float64).  The block is F lanes by 256 / F row slots: lanes run along
// facets, so each table entry of the F facets is one coalesced read
// straight from device memory, and every table is read once but Dinv0,
// which phases 1 and 5 both read (the least time is then about 71% of the
// bound at d1 = 45).  A row slot's thread computes the rows slot, slot +
// 256 / F, ... of a phase; its vector reads are consecutive words across
// the lanes (no bank conflict); Cp and Bp are read through L1.  One
// __syncthreads between phases.  Tiles are aligned in table columns (the
// colour's first and last tiles mask the facets outside it), so a warp's
// read of a table entry starts a 128-byte line where the table's column
// stride allows.
#include "common.cuh"

constexpr int PATCH_WIDE_THREADS = 256;
constexpr int PATCH_WIDE_SMEM_MAX = 232448;

// acc = sum_j A[row, j, col] x[j] over an nu x nu table (column stride ld)
// and a staged vector x ([j][F], the thread's lane)
template <typename T>
__device__ __forceinline__ T table_dot(const T* __restrict__ A, long long ld, int nu, int row,
                                       const T* x, int F) {
  T acc = T(0);
  const T* a = A + (long long)row * nu * ld;
#pragma unroll 8
  for (int j = 0; j < nu; ++j) acc += __ldg(a + j * ld) * x[j * F];
  return acc;
}

// (I2 (x) K + P)[row, :] x for the facet of the thread's lane (K the d1 x d1
// table at the facet's column, P the colour's nu x nu block)
template <typename T>
__device__ __forceinline__ T cross_dot(const T* __restrict__ K, long long ld,
                                       const T* __restrict__ P, int d1, int row, const T* x,
                                       int F) {
  const int nu = 2 * d1;
  const int a = row >= d1 ? 1 : 0;
  const int i = row - a * d1;
  T acc = T(0);
  const T* p = P + (long long)row * nu;
#pragma unroll 8
  for (int j = 0; j < nu; ++j) acc += __ldg(p + j) * x[j * F];
  const T* k = K + (long long)i * d1 * ld;
  const T* xa = x + a * d1 * F;
#pragma unroll 8
  for (int j = 0; j < d1; ++j) acc += __ldg(k + j * ld) * xa[j * F];
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(PATCH_WIDE_THREADS) patch_solve_wide_kernel(
    int d1, const T* __restrict__ Di, const T* __restrict__ Si, const T* __restrict__ K01,
    const T* __restrict__ K10, long long ld, long long off, const T* __restrict__ Bp,
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
  const T* Dc = Di + tcol;
  const T* Sc = Si + tcol;
  const T* K01c = K01 + tcol;
  const T* K10c = K10 + tcol;

  for (int row = slot; row < nu; row += slots) su[row * F + lane] = in ? r0[row * m + c] : T(0);
  __syncthreads();
  // w = Dinv0 r0
  for (int row = slot; row < nu; row += slots)
    sw[row * F + lane] = table_dot(Dc, ld, nu, row, su + lane, F);
  __syncthreads();
  // t = r1 - (I2 (x) K10 + Cp) w
  for (int row = slot; row < nu; row += slots) {
    const T r = in ? r1[row * m + c] : T(0);
    st[row * F + lane] = r - cross_dot(K10c, ld, Cp, d1, row, sw + lane, F);
  }
  __syncthreads();
  // y1 = Sinv t (kept in w)
  for (int row = slot; row < nu; row += slots) {
    const T v = table_dot(Sc, ld, nu, row, st + lane, F);
    sw[row * F + lane] = v;
    if (in) y1[row * m + c] = v;
  }
  __syncthreads();
  // u = r0 - (I2 (x) K01 + Bp) y1 (each thread updates its own rows of u)
  for (int row = slot; row < nu; row += slots)
    su[row * F + lane] -= cross_dot(K01c, ld, Bp, d1, row, sw + lane, F);
  __syncthreads();
  // y0 = Dinv0 u
  for (int row = slot; row < nu; row += slots) {
    const T v = table_dot(Dc, ld, nu, row, su + lane, F);
    if (in) y0[row * m + c] = v;
  }
}

// shared bytes of the three facet vectors of F facets
static inline long long patch_wide_smem(int d1, int F, int size) {
  return 3LL * 2 * d1 * F * size;
}

template <typename T>
static int launch(int d1, int F, const void* Di, const void* Si, const void* K01,
                  const void* K10, long long ld, long long off, const void* Bp, const void* Cp,
                  const void* r0, const void* r1, void* y0, void* y1, long long m,
                  cudaStream_t stream) {
  const long long smem = patch_wide_smem(d1, F, (int)sizeof(T));
  if (smem > PATCH_WIDE_SMEM_MAX) return (int)cudaErrorInvalidValue;
  static bool attr = false;  // the cap only: a launch takes the bytes it asks for
  if (!attr) {
    const cudaError_t a = cudaFuncSetAttribute(
        patch_solve_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PATCH_WIDE_SMEM_MAX);
    if (a != cudaSuccess) return (int)a;
    attr = true;
  }
  const long long ntiles = off % F + m;  // columns from the aligned first tile
  const dim3 block(F, PATCH_WIDE_THREADS / F);
  patch_solve_wide_kernel<T><<<blocks_for(ntiles, F), block, smem, stream>>>(
      d1, (const T*)Di, (const T*)Si, (const T*)K01, (const T*)K10, ld, off, (const T*)Bp,
      (const T*)Cp, (const T*)r0, (const T*)r1, (T*)y0, (T*)y1, m);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 float64.  Di/Si (nu, nu, ld-strided columns), K01/K10
// (d1, d1, ld-strided columns), Bp/Cp (nu, nu), r0/r1/y0/y1 (nu, m),
// contiguous; the colour's table columns are off .. off + m - 1; F (8, 16
// or 32) facets a thread block, whose three vectors must fit the shared
// memory of a block.
IEHDG_EXPORT int iehdg_patch_solve_wide(int device, int dtype, int d1, int F, const void* Di,
                                        const void* Si, const void* K01, const void* K10,
                                        long long ld, long long off, const void* Bp,
                                        const void* Cp, const void* r0, const void* r1,
                                        void* y0, void* y1, long long m, void* stream) {
  if (d1 < 1 || m < 1 || (F != 8 && F != 16 && F != 32)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(d1, F, Di, Si, K01, K10, ld, off, Bp, Cp, r0, r1, y0, y1, m, st);
  if (dtype == 1)
    return launch<double>(d1, F, Di, Si, K01, K10, ld, off, Bp, Cp, r0, r1, y0, y1, m, st);
  return (int)cudaErrorInvalidValue;
}
