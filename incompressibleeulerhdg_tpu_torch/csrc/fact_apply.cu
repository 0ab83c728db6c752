// K1: factored block apply  out[:, c] = (I2 (x) A[:, :, aoff + c] + P[s(c)]) x[:, c]
//
// Replaces the Pallas kernel incompressibleeulerhdg_tpu/linalg/preconditioners.py
// `_fact_pallas` (kernel body `_fact_kernel_factory`).  It is the own-cell
// term of every assembled tentative matvec (`_matvec_bl`, per="half": two
// segments, the lower and upper cell halves) and the single-colour cross
// apply of the flat factored path.
//
// What bounds it on the card: table bytes.  At 256^2, k=2, float32 the
// (d1, d1, nc) scalar table is 10*10*131072*4 B = 52 MB per full cell pass,
// against 2 * 20*131072*4 B = 21 MB of field in and out; the 2*d1*(d1 + nu)
// FMAs per column are far below the card's arithmetic rate.
//
// What the design does about it: one thread per column, so a warp reads 32
// consecutive columns of every table row (coalesced, batch-last layout); the
// column of x stays in registers and every table entry is read once for both
// velocity components (the I2 (x) A structure); the (nu, nu) segment constant
// is the same address across a warp and is served by the L1 broadcast.
//
// From d1 = 28 (k = 5) a thread cannot hold a whole column: xv[nu] and
// acc[nu] are 224 float64 registers at d1 = 28 and 288 at d1 = 36, past the
// 255 a thread may use.  There the output rows are split into four groups
// of RB rows of A (RB = d1 / 4, both components: 2 RB sums a thread), one
// thread block a (group, column tile), the groups of a tile in consecutive
// blocks, so the four reads of a column of x hit L2 together; a thread
// reads x[j] and x[d1 + j] once per j and every table entry still moves
// once, by the one thread of its row group.
#include "common.cuh"

template <typename T, int D1>
__global__ void __launch_bounds__(128) fact_apply_kernel(
    const T* __restrict__ A, long long lda, long long aoff,
    const T* __restrict__ P, Segs seg, const T* __restrict__ x,
    T* __restrict__ out, long long m) {
  constexpr int NU = 2 * D1;
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= m) return;
  T xv[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) xv[j] = x[j * m + c];
  T acc[NU];
#pragma unroll
  for (int r = 0; r < NU; ++r) acc[r] = T(0);
  const int s = segment_of(seg, c);
  if (s >= 0) {
    const T* Ps = P + (long long)s * NU * NU;
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      T a = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) a += __ldg(Ps + r * NU + j) * xv[j];
      acc[r] = a;
    }
  }
  const T* Ac = A + aoff + c;
#pragma unroll
  for (int i = 0; i < D1; ++i) {
#pragma unroll
    for (int j = 0; j < D1; ++j) {
      const T a = __ldg(Ac + (long long)(i * D1 + j) * lda);
      acc[i] += a * xv[j];
      acc[D1 + i] += a * xv[D1 + j];
    }
  }
#pragma unroll
  for (int r = 0; r < NU; ++r) out[r * m + c] = acc[r];
}

// d1 >= 28: rows i0 .. i0 + RB - 1 of A, and of each component of the
// output, for one column; block b is row group b % G of column tile b / G.
template <typename T, int D1, int RB>
__global__ void __launch_bounds__(128) fact_apply_kernel_rows(
    const T* __restrict__ A, long long lda, long long aoff,
    const T* __restrict__ P, Segs seg, const T* __restrict__ x,
    T* __restrict__ out, long long m) {
  constexpr int NU = 2 * D1;
  constexpr int G = D1 / RB;
  static_assert(G * RB == D1, "row groups must tile d1");
  const int i0 = (int)(blockIdx.x % G) * RB;
  const long long c = (long long)(blockIdx.x / G) * blockDim.x + threadIdx.x;
  if (c >= m) return;
  T acc[2][RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[0][i] = acc[1][i] = T(0);
  const int s = segment_of(seg, c);
  const T* Ps = P + (long long)(s < 0 ? 0 : s) * NU * NU;
  const T* Ac = A + aoff + c;
#pragma unroll 2
  for (int j = 0; j < D1; ++j) {
    const T xa = x[j * m + c], xb = x[(D1 + j) * m + c];
    if (s >= 0) {
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const T* p0 = Ps + (i0 + i) * NU;  // row i0 + i of P, then row d1 + i0 + i
        const T* p1 = p0 + D1 * NU;
        acc[0][i] += __ldg(p0 + j) * xa + __ldg(p0 + D1 + j) * xb;
        acc[1][i] += __ldg(p1 + j) * xa + __ldg(p1 + D1 + j) * xb;
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const T a = __ldg(Ac + (long long)((i0 + i) * D1 + j) * lda);
      acc[0][i] += a * xa;
      acc[1][i] += a * xb;
    }
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    out[(i0 + i) * m + c] = acc[0][i];
    out[(D1 + i0 + i) * m + c] = acc[1][i];
  }
}

template <typename T, int D1>
static void launch_rows(const void* A, long long lda, long long aoff, const void* P,
                        Segs seg, const void* x, void* out, long long m,
                        cudaStream_t stream) {
  constexpr int RB = D1 / 4;
  const int threads = 128;
  fact_apply_kernel_rows<T, D1, RB><<<4 * blocks_for(m, threads), threads, 0, stream>>>(
      (const T*)A, lda, aoff, (const T*)P, seg, (const T*)x, (T*)out, m);
}

template <typename T, int D1>
static void launch(const void* A, long long lda, long long aoff, const void* P,
                   Segs seg, const void* x, void* out, long long m,
                   cudaStream_t stream) {
  const int threads = 128;
  fact_apply_kernel<T, D1><<<blocks_for(m, threads), threads, 0, stream>>>(
      (const T*)A, lda, aoff, (const T*)P, seg, (const T*)x, (T*)out, m);
}

template <typename T>
static int dispatch_d1(int d1, const void* A, long long lda, long long aoff,
                       const void* P, Segs seg, const void* x, void* out,
                       long long m, cudaStream_t stream) {
  switch (d1) {
    case 3: launch<T, 3>(A, lda, aoff, P, seg, x, out, m, stream); break;
    case 6: launch<T, 6>(A, lda, aoff, P, seg, x, out, m, stream); break;
    case 10: launch<T, 10>(A, lda, aoff, P, seg, x, out, m, stream); break;
    case 15: launch<T, 15>(A, lda, aoff, P, seg, x, out, m, stream); break;
    case 21: launch<T, 21>(A, lda, aoff, P, seg, x, out, m, stream); break;
    case 28: launch_rows<T, 28>(A, lda, aoff, P, seg, x, out, m, stream); break;
    case 36: launch_rows<T, 36>(A, lda, aoff, P, seg, x, out, m, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 float64.  A (d1, d1, lda), P (nseg, nu, nu),
// x/out (nu, m), all contiguous; seg_bounds: nseg + 1 host int64 values.
IEHDG_EXPORT int iehdg_fact_apply(int device, int dtype, int d1, const void* A,
                                  long long lda, long long aoff, const void* P,
                                  const long long* seg_bounds, int nseg,
                                  const void* x, void* out, long long m,
                                  void* stream) {
  if (nseg < 0 || nseg > IEHDG_MAX_SEG) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Segs seg = make_segs(seg_bounds, nseg);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d1<float>(d1, A, lda, aoff, P, seg, x, out, m, st);
  if (dtype == 1) return dispatch_d1<double>(d1, A, lda, aoff, P, seg, x, out, m, st);
  return (int)cudaErrorInvalidValue;
}
