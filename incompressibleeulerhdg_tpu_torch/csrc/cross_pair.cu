// K2: fused pair of factored cross applies over a facet range
//
//     y0[:, c] = (I2 (x) K01[:, :, aoff + c] + Bp[s(c)]) x1[:, c]
//     y1[:, c] = (I2 (x) K10[:, :, aoff + c] + Cp[s(c)]) x0[:, c]
//
// Replaces the Pallas kernel incompressibleeulerhdg_tpu/linalg/preconditioners.py
// `_cross_pair_pallas` (kernel body `_cross_pair_kernel_factory`).  Callers:
// `_cross_pair_full` (both cross terms of every tentative matvec, segments =
// the facet colours, zero penalty on the boundary tail) and
// `_cross_pair_color` (one colour, addressed by its column offset, inside
// every off-colour residual update of the fused Schwarz sweep).
//
// What bounds it on the card: table bytes.  At 256^2, k=2, float32 a
// full-field pass streams the two (d1, d1, nf) scalar tables,
// 2 * 10*10*197120*4 B = 158 MB, plus 4 * 20*197120*4 B = 63 MB of fields:
// 221 MB, 0.066 ms at 3.35 TB/s.
//
// What the design does about it:
// - a block owns a tile of TC consecutive table columns (128-byte table
//   rows, 64 above d1 = 15; aligned, as TMA reads from a 16-byte aligned
//   column, so a range's first and last tiles mask the columns outside it);
//   one thread starts the TMA loads of the tile's K01 and
//   K10 while the block stages x0 and x1;
// - the penalty, the one part with reuse, is a (nu x nu) (nu x TC) product
//   per side: a thread computes rows i and d1 + i of VEC facets (16 bytes),
//   two L1-cached loads of P[s] and one 16-byte shared load of x per 2 VEC
//   FMAs; the scalar table K[i, j] of the same VEC facets then serves both
//   rows;
// - every thread stages rows i and d1 + i of its columns of x, all loads in
//   flight together (a loop of dependent trips would wait out one global
//   latency each);
// - the tile's segments are found once per block; a tile that straddles a
//   segment edge applies each segment's block to its own columns;
// - a thread holds 2 VEC sums, so no width spills; its sums over j unroll
//   whole up to 42 terms and 8 at a time above.
// Widths: the port dispatches d1 = 3 .. 15 (k = 0 .. 3) here.  From d1 = 21
// the tile's two tables take 56 KB of shared memory or more (at d1 = 28,
// 36: 100 and 166 KB, two blocks an SM, then one), the table phase waits
// on the whole tile's load, and on one 128^2 colour on the H100 K2 reached
// 52%, 36% and 32% of its bytes bound at d1 = 21, 28, 36, against K2c's
// 54%, 62% and 65% in the same process (csrc/cross_pair_cluster.cu, which
// the dispatch takes at d1 = 21 .. 45); from d1 = 45 the tables exceed a
// block's shared memory.  tools/ab_cross.py builds this template at d1 =
// 21, 28, 36 to time it against K2w and K2c in one process.
// No tensor cores: in float32 they would round the inputs to TF32.
#include "common.cuh"
#include "tma.cuh"

// unroll factor of a sum over n terms
template <int n>
constexpr int CROSS_UNROLL = n > 42 ? 8 : n;

template <typename T, int D1>
struct CrossTile {
  static constexpr int NU = 2 * D1;
  static constexpr int VEC = Vec<T>::n;
  static constexpr int TC = (D1 > 15 ? 64 : 128) / (int)sizeof(T);
  static constexpr int Q = TC / VEC;
  static constexpr int THREADS = 2 * D1 * Q;  // side, row pair i, facet group
  static constexpr TableBox BK = table_box<T, TC>(D1 * D1);
  // shared memory in elements of T, regions 128-byte aligned
  static constexpr int OFF_K01 = 0;
  static constexpr int OFF_K10 = BK.padded * TC;
  static constexpr int OFF_X = 2 * BK.padded * TC;  // x1 then x0, [j][TC]
  static constexpr int END = OFF_X + 2 * NU * TC;
  static constexpr int SMEM = END * (int)sizeof(T) + 2 * 8;  // + 2 mbarriers
};

template <typename T, int D1>
__global__ void __launch_bounds__(CrossTile<T, D1>::THREADS) cross_pair_kernel(
    const __grid_constant__ CUtensorMap m01, const __grid_constant__ CUtensorMap m10,
    long long aoff, const T* __restrict__ Bp, const T* __restrict__ Cp, Segs seg,
    const T* __restrict__ x0, const T* __restrict__ x1, T* __restrict__ y0,
    T* __restrict__ y1, long long m) {
  using P = CrossTile<T, D1>;
  using V = typename Vec<T>::type;
  constexpr int NU = P::NU, TC = P::TC, VEC = P::VEC, Q = P::Q;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + P::SMEM - 2 * 8);
  const int tid = threadIdx.x;
  // tiles aligned in table columns (TMA reads from a 16-byte aligned column)
  const int col = (int)(aoff - aoff % TC) + blockIdx.x * TC;
  const long long c0 = col - aoff;

  if (tid == 0) {
    mbar_init(bar + 0, 1);
    mbar_init(bar + 1, 1);
    mbar_fence_init();
    tma_load_table<T, TC>(sm + P::OFF_K01, &m01, D1 * D1, col, bar + 0);
    tma_load_table<T, TC>(sm + P::OFF_K10, &m10, D1 * D1, col, bar + 1);
  }
  const int side = tid / (D1 * Q);
  const int i = (tid / Q) % D1;
  const int q = tid % Q;
  T* xs = sm + P::OFF_X + side * NU * TC;
  // inputs: side 0 (y0) reads x1, side 1 (y1) x0; each thread stages rows i
  // and D1 + i of its columns, all loads in flight together
  {
    const T* x = side == 0 ? x1 : x0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const long long c = c0 + q * VEC + v;
      const bool in = c >= 0 && c < m;
      xs[i * TC + q * VEC + v] = in ? x[i * m + c] : T(0);
      xs[(D1 + i) * TC + q * VEC + v] = in ? x[(D1 + i) * m + c] : T(0);
    }
  }
  __syncthreads();  // x staged, barriers initialised
  const T* Pside = side == 0 ? Bp : Cp;
  T acc[2][VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[0][v] = acc[1][v] = T(0);

  // penalty: rows i and D1 + i of P[s] x for every segment s in the tile
  const long long tile_end = c0 + TC;
  for (int s = 0; s < seg.n; ++s) {
    const long long b0 = seg.b[s], b1 = seg.b[s + 1];
    if (b1 <= c0 || b0 >= tile_end || b1 <= b0) continue;
    const T* Pi = Pside + (long long)s * NU * NU + i * NU;  // rows i and D1 + i
    T pen[2][VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) pen[0][v] = pen[1][v] = T(0);
#pragma unroll(CROSS_UNROLL<NU>)
    for (int jj = 0; jj < NU; ++jj) {
      int j = jj + i;
      j = j >= NU ? j - NU : j;
      const T p0 = __ldg(Pi + j), p1 = __ldg(Pi + D1 * NU + j);
      const V x = *reinterpret_cast<const V*>(xs + j * TC + q * VEC);
      const T* xv = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        pen[0][v] += p0 * xv[v];
        pen[1][v] += p1 * xv[v];
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const long long c = c0 + q * VEC + v;
      if (c >= b0 && c < b1) {
        acc[0][v] += pen[0][v];
        acc[1][v] += pen[1][v];
      }
    }
  }

  // scalar table of the side, both components
  mbar_wait(bar + side, 0);
  const T* K = sm + (side == 0 ? P::OFF_K01 : P::OFF_K10);
#pragma unroll(CROSS_UNROLL<D1>)
  for (int jj = 0; jj < D1; ++jj) {
    int j = jj + i;
    j = j >= D1 ? j - D1 : j;
    const V k = *reinterpret_cast<const V*>(K + (i * D1 + j) * TC + q * VEC);
    const V xa = *reinterpret_cast<const V*>(xs + j * TC + q * VEC);
    const V xb = *reinterpret_cast<const V*>(xs + (D1 + j) * TC + q * VEC);
    const T* kv = reinterpret_cast<const T*>(&k);
    const T* av = reinterpret_cast<const T*>(&xa);
    const T* bv = reinterpret_cast<const T*>(&xb);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      acc[0][v] += kv[v] * av[v];
      acc[1][v] += kv[v] * bv[v];
    }
  }
  T* y = side == 0 ? y0 : y1;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const long long c = c0 + q * VEC + v;
    if (c >= 0 && c < m) {
      y[i * m + c] = acc[0][v];
      y[(D1 + i) * m + c] = acc[1][v];
    }
  }
}

template <typename T, int D1>
static int launch(const void* K01, const void* K10, long long ldk, long long aoff,
                  const void* Bp, const void* Cp, Segs seg, const void* x0, const void* x1,
                  void* y0, void* y1, long long m, cudaStream_t stream) {
  using P = CrossTile<T, D1>;
  static_assert(P::THREADS <= 1024 && P::SMEM <= 232448, "cross tile too large");
  CUtensorMap m01, m10;
  int e = encode_table<T, P::TC>(&m01, K01, D1 * D1, ldk, aoff + m);
  if (!e) e = encode_table<T, P::TC>(&m10, K10, D1 * D1, ldk, aoff + m);
  if (e) return e;
  static bool attr = false;
  if (!attr) {
    const cudaError_t a = cudaFuncSetAttribute(
        cross_pair_kernel<T, D1>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (a != cudaSuccess) return (int)a;
    attr = true;
  }
  const long long ntiles = aoff % P::TC + m;  // columns from the aligned first tile
  cross_pair_kernel<T, D1><<<blocks_for(ntiles, P::TC), P::THREADS, P::SMEM, stream>>>(
      m01, m10, aoff, (const T*)Bp, (const T*)Cp, seg, (const T*)x0, (const T*)x1, (T*)y0,
      (T*)y1, m);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_d1(int d1, const void* K01, const void* K10, long long ldk,
                       long long aoff, const void* Bp, const void* Cp, Segs seg,
                       const void* x0, const void* x1, void* y0, void* y1,
                       long long m, cudaStream_t st) {
  switch (d1) {
    case 3: return launch<T, 3>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st);
    case 6: return launch<T, 6>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st);
    case 10: return launch<T, 10>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st);
    case 15: return launch<T, 15>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 float64.  K01/K10 (d1, d1, ldk) with ldk * sizeof(T)
// a multiple of 16 bytes and 16-byte aligned bases; Bp/Cp (nseg, nu, nu),
// x0/x1/y0/y1 (nu, m), contiguous; seg_bounds: nseg + 1 host int64 values.
IEHDG_EXPORT int iehdg_cross_pair(int device, int dtype, int d1, const void* K01,
                                  const void* K10, long long ldk, long long aoff,
                                  const void* Bp, const void* Cp,
                                  const long long* seg_bounds, int nseg,
                                  const void* x0, const void* x1, void* y0,
                                  void* y1, long long m, void* stream) {
  if (nseg < 0 || nseg > IEHDG_MAX_SEG) return (int)cudaErrorInvalidValue;
  if (aoff + m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // TMA coordinates are int32
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Segs seg = make_segs(seg_bounds, nseg);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d1<float>(d1, K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st);
  if (dtype == 1)
    return dispatch_d1<double>(d1, K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st);
  return (int)cudaErrorInvalidValue;
}
