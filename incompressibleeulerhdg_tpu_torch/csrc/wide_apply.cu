// K1w and K2w: the factored block apply of K1 and the cross pair of K2 at a
// width d1 given at run time (every degree; the port launches K1w at the
// widths fact_apply.cu is not instantiated for, d1 = 45 (k = 7) and up, and
// K2w at the widths where neither cross_pair.cu (d1 <= 15) nor K2c
// (csrc/cross_pair_cluster.cu, which was faster at d1 = 21 .. 45 on the
// H100, preconditioners.CROSS_PAIR_MEASURED) takes the cross pair: d1 = 55
// (k = 8) and up):
//
//     K1w:  out[:, c] = (I2 (x) A[:, :, aoff + c] + P[s(c)]) x[:, c]
//     K2w:  y0[:, c]  = (I2 (x) K01[:, :, aoff + c] + Bp[s(c)]) x1[:, c]
//           y1[:, c]  = (I2 (x) K10[:, :, aoff + c] + Cp[s(c)]) x0[:, c]
//
// Replace the Pallas kernels incompressibleeulerhdg_tpu/linalg/preconditioners.py
// `_fact_pallas` (K1w) and `_cross_pair_pallas` (K2w; both sides in one
// launch, blockIdx.y = side), which the JAX package runs at any width.
// Callers as K1 and K2: the own-cell term of every tentative matvec
// (`_matvec_bl`), the full-field and the single-colour cross applies of the
// matvec and of the fused Schwarz sweep.
//
// What bounds it on the card, in both kernels: table bytes.  At 128^2,
// k = 7, float32 K1w streams the (45, 45, 32768) own-cell table, 265 MB,
// against 24 MB of field in and out (289 MB, 0.086 ms at 3.35 TB/s); K2w
// the two (45, 45, 49408) cross tables, 800 MB, and 71 MB of fields.  The
// 2 d1^2 + nu^2 FMAs a column and side are below the arithmetic rate
// (about a seventh of the bytes' time in float32).
//
// What the design does about it: one device function, `apply_rows`.  A
// thread owns one column c and a group of RB rows of A (both components,
// 2 RB sums in registers); the groups are ceil(d1 / RB), the last one masked
// by rows, so any d1 is covered.  Warp lanes run along columns, so each
// table entry A[i, j, aoff + c] is one coalesced read of the batch-last
// table, read by exactly one thread: every table entry moves once.  A
// thread block is one row group of a tile of 128 columns, and the groups of
// a tile are consecutive blocks, so the ceil(d1 / RB) reads of a column of x
// meet in L2.  The penalty block P[s] (nu x nu) is the same address across
// a warp (L1 broadcast, __ldg).  No shared memory and no TMA: the tables
// may have any column stride ld >= the column count (pad_table's padded
// stride or none), and segments come as in K1 (at most 8).
#include "common.cuh"

constexpr int WIDE_RB = 8;         // rows of A a thread
constexpr int WIDE_THREADS = 128;  // columns a thread block

// rows i0 .. i0 + RB - 1 (those < d1) of A, and of each component of the
// output, for column c (c < m).  The rows past d1 of the last group read
// row d1 - 1 again and are not stored: every load of a trip over j is
// unconditional, so the RB loads of A (and the 4 RB of P) go out together
// (a branch a row issued them one latency apart: 2.6x slower at d1 = 45 on
// the H100; RB = 4, 12 and unrolling j by 1 or 4 were slower than RB = 8
// unrolled by 2).
template <typename T, int RB>
__device__ __forceinline__ void apply_rows(const T* __restrict__ A, long long lda,
                                           long long aoff, const T* __restrict__ P,
                                           const Segs& seg, const T* __restrict__ x,
                                           T* __restrict__ out, long long m, int d1, int i0,
                                           long long c) {
  const int nu = 2 * d1;
  T acc[2][RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[0][i] = acc[1][i] = T(0);
  const int s = segment_of(seg, c);
  const T* Ac[RB];  // column c of row i0 + i of A (clamped to d1 - 1)
  const T* Pr[RB];  // row i0 + i of P[s], then row d1 + i0 + i at + d1 nu
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int row = i0 + i < d1 ? i0 + i : d1 - 1;
    Ac[i] = A + aoff + c + (long long)row * d1 * lda;
    Pr[i] = P + ((long long)(s < 0 ? 0 : s) * nu + row) * nu;
  }
#pragma unroll 2
  for (int j = 0; j < d1; ++j) {
    const T xa = x[j * m + c], xb = x[(d1 + j) * m + c];
    T a[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) a[i] = __ldg(Ac[i] + j * lda);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      acc[0][i] += a[i] * xa;
      acc[1][i] += a[i] * xb;
    }
    if (s >= 0) {
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const T* p0 = Pr[i];
        const T* p1 = p0 + (long long)d1 * nu;
        acc[0][i] += __ldg(p0 + j) * xa + __ldg(p0 + d1 + j) * xb;
        acc[1][i] += __ldg(p1 + j) * xa + __ldg(p1 + d1 + j) * xb;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    if (i0 + i < d1) {
      out[(i0 + i) * m + c] = acc[0][i];
      out[(d1 + i0 + i) * m + c] = acc[1][i];
    }
  }
}

// block b of the x grid: row group b % G of column tile b / G
__device__ __forceinline__ bool block_rows(int d1, long long m, int* i0, long long* c) {
  const int groups = (d1 + WIDE_RB - 1) / WIDE_RB;
  *i0 = (int)(blockIdx.x % groups) * WIDE_RB;
  *c = (long long)(blockIdx.x / groups) * blockDim.x + threadIdx.x;
  return *c < m;
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS) fact_apply_wide_kernel(
    int d1, const T* __restrict__ A, long long lda, long long aoff, const T* __restrict__ P,
    Segs seg, const T* __restrict__ x, T* __restrict__ out, long long m) {
  int i0;
  long long c;
  if (!block_rows(d1, m, &i0, &c)) return;
  apply_rows<T, WIDE_RB>(A, lda, aoff, P, seg, x, out, m, d1, i0, c);
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS) cross_pair_wide_kernel(
    int d1, const T* __restrict__ K01, const T* __restrict__ K10, long long ldk, long long aoff,
    const T* __restrict__ Bp, const T* __restrict__ Cp, Segs seg, const T* __restrict__ x0,
    const T* __restrict__ x1, T* __restrict__ y0, T* __restrict__ y1, long long m) {
  int i0;
  long long c;
  if (!block_rows(d1, m, &i0, &c)) return;
  if (blockIdx.y == 0)
    apply_rows<T, WIDE_RB>(K01, ldk, aoff, Bp, seg, x1, y0, m, d1, i0, c);
  else
    apply_rows<T, WIDE_RB>(K10, ldk, aoff, Cp, seg, x0, y1, m, d1, i0, c);
}

static inline unsigned int wide_blocks(int d1, long long m) {
  return (unsigned int)((d1 + WIDE_RB - 1) / WIDE_RB) * blocks_for(m, WIDE_THREADS);
}

// dtype: 0 float32, 1 float64.  A (d1, d1, lda-strided columns), P (nseg,
// nu, nu), x/out (nu, m), contiguous; seg_bounds: nseg + 1 host int64 values.
IEHDG_EXPORT int iehdg_fact_apply_wide(int device, int dtype, int d1, const void* A,
                                       long long lda, long long aoff, const void* P,
                                       const long long* seg_bounds, int nseg,
                                       const void* x, void* out, long long m,
                                       void* stream) {
  if (nseg < 0 || nseg > IEHDG_MAX_SEG || d1 < 1 || m < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Segs seg = make_segs(seg_bounds, nseg);
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int nb = wide_blocks(d1, m);
  if (dtype == 0)
    fact_apply_wide_kernel<float><<<nb, WIDE_THREADS, 0, st>>>(
        d1, (const float*)A, lda, aoff, (const float*)P, seg, (const float*)x, (float*)out, m);
  else if (dtype == 1)
    fact_apply_wide_kernel<double><<<nb, WIDE_THREADS, 0, st>>>(
        d1, (const double*)A, lda, aoff, (const double*)P, seg, (const double*)x, (double*)out,
        m);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 float64.  K01/K10 (d1, d1, ldk-strided columns), Bp/Cp
// (nseg, nu, nu), x0/x1/y0/y1 (nu, m), contiguous; seg_bounds: nseg + 1
// host int64 values.
IEHDG_EXPORT int iehdg_cross_pair_wide(int device, int dtype, int d1, const void* K01,
                                       const void* K10, long long ldk, long long aoff,
                                       const void* Bp, const void* Cp,
                                       const long long* seg_bounds, int nseg,
                                       const void* x0, const void* x1, void* y0,
                                       void* y1, long long m, void* stream) {
  if (nseg < 0 || nseg > IEHDG_MAX_SEG || d1 < 1 || m < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Segs seg = make_segs(seg_bounds, nseg);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(wide_blocks(d1, m), 2);
  if (dtype == 0)
    cross_pair_wide_kernel<float><<<grid, WIDE_THREADS, 0, st>>>(
        d1, (const float*)K01, (const float*)K10, ldk, aoff, (const float*)Bp,
        (const float*)Cp, seg, (const float*)x0, (const float*)x1, (float*)y0, (float*)y1, m);
  else if (dtype == 1)
    cross_pair_wide_kernel<double><<<grid, WIDE_THREADS, 0, st>>>(
        d1, (const double*)K01, (const double*)K10, ldk, aoff, (const double*)Bp,
        (const double*)Cp, seg, (const double*)x0, (const double*)x1, (double*)y0, (double*)y1,
        m);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
