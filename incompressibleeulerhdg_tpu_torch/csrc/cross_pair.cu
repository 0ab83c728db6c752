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
// 2 * 10*10*197120*4 B = 158 MB, plus 4 * 20*197120*4 B = 63 MB of fields.
//
// What the design does about it: one thread per facet, coalesced batch-last
// reads, both tables and both side fields in one pass (the point of the
// fused TPU kernel), every table entry read once for both velocity
// components, and the per-colour (nu, nu) constants read through the L1
// broadcast (one address per warp).
//
// Registers: the fused pass keeps four nu-long vectors a thread (both
// sides' inputs and sums), 168 values at d1 = 21 -- above the 255 registers
// of a thread in float64.  Above d1 = 15 the two sides therefore go to two
// threads (blockIdx.y picks the side), each with two nu-vectors, the
// register budget of K1; they share no table, so nothing is read twice.
// (Running both sides one after the other in one thread made ptxas spill:
// 15 KB of spill stores a thread in float32, sm_90a.)
#include "common.cuh"

// y[:, c] = (I2 (x) K[:, :, c] + P) x[:, c] for one column; P null: no penalty
template <typename T, int D1>
__device__ __forceinline__ void cross_side(const T* __restrict__ Kc, long long ldk,
                                           const T* __restrict__ P,
                                           const T* __restrict__ x,
                                           T* __restrict__ y, long long m,
                                           long long c) {
  constexpr int NU = 2 * D1;
  T v[NU], a[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) v[j] = x[j * m + c];
#pragma unroll
  for (int r = 0; r < NU; ++r) a[r] = T(0);
  if (P != nullptr) {
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      T b = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) b += __ldg(P + r * NU + j) * v[j];
      a[r] = b;
    }
  }
#pragma unroll
  for (int i = 0; i < D1; ++i) {
#pragma unroll
    for (int j = 0; j < D1; ++j) {
      const T k = __ldg(Kc + (long long)(i * D1 + j) * ldk);
      a[i] += k * v[j];
      a[D1 + i] += k * v[D1 + j];
    }
  }
#pragma unroll
  for (int r = 0; r < NU; ++r) y[r * m + c] = a[r];
}

// both sides of one column in one pass (d1 <= 15)
template <typename T, int D1>
__device__ __forceinline__ void cross_fused(
    const T* __restrict__ K01, const T* __restrict__ K10, long long ldk,
    long long aoff, const T* __restrict__ Bp, const T* __restrict__ Cp,
    const Segs& seg, const T* __restrict__ x0, const T* __restrict__ x1,
    T* __restrict__ y0, T* __restrict__ y1, long long m, long long c) {
  constexpr int NU = 2 * D1;
  T v0[NU], v1[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    v0[j] = x0[j * m + c];
    v1[j] = x1[j * m + c];
  }
  T a0[NU], a1[NU];
#pragma unroll
  for (int r = 0; r < NU; ++r) {
    a0[r] = T(0);
    a1[r] = T(0);
  }
  const int s = segment_of(seg, c);
  if (s >= 0) {
    const T* B = Bp + (long long)s * NU * NU;
    const T* C = Cp + (long long)s * NU * NU;
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      T b = T(0), d = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        b += __ldg(B + r * NU + j) * v1[j];
        d += __ldg(C + r * NU + j) * v0[j];
      }
      a0[r] = b;
      a1[r] = d;
    }
  }
  const T* Ka = K01 + aoff + c;
  const T* Kb = K10 + aoff + c;
#pragma unroll
  for (int i = 0; i < D1; ++i) {
#pragma unroll
    for (int j = 0; j < D1; ++j) {
      const long long o = (long long)(i * D1 + j) * ldk;
      const T ka = __ldg(Ka + o);
      const T kb = __ldg(Kb + o);
      a0[i] += ka * v1[j];
      a0[D1 + i] += ka * v1[D1 + j];
      a1[i] += kb * v0[j];
      a1[D1 + i] += kb * v0[D1 + j];
    }
  }
#pragma unroll
  for (int r = 0; r < NU; ++r) {
    y0[r * m + c] = a0[r];
    y1[r * m + c] = a1[r];
  }
}

template <typename T, int D1>
__global__ void __launch_bounds__(128) cross_pair_kernel(
    const T* __restrict__ K01, const T* __restrict__ K10, long long ldk,
    long long aoff, const T* __restrict__ Bp, const T* __restrict__ Cp,
    Segs seg, const T* __restrict__ x0, const T* __restrict__ x1,
    T* __restrict__ y0, T* __restrict__ y1, long long m) {
  constexpr int NU = 2 * D1;
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= m) return;
  if constexpr (D1 > 15) {
    const int s = segment_of(seg, c);
    const bool side1 = blockIdx.y == 1;  // y1 from x0, else y0 from x1
    const T* P = side1 ? Cp : Bp;
    cross_side<T, D1>((side1 ? K10 : K01) + aoff + c, ldk,
                      s >= 0 ? P + (long long)s * NU * NU : nullptr,
                      side1 ? x0 : x1, side1 ? y1 : y0, m, c);
  } else {
    cross_fused<T, D1>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, c);
  }
}

template <typename T, int D1>
static void launch(const void* K01, const void* K10, long long ldk,
                   long long aoff, const void* Bp, const void* Cp, Segs seg,
                   const void* x0, const void* x1, void* y0, void* y1,
                   long long m, cudaStream_t stream) {
  const int threads = 128;
  const dim3 grid(blocks_for(m, threads), D1 > 15 ? 2 : 1);
  cross_pair_kernel<T, D1><<<grid, threads, 0, stream>>>(
      (const T*)K01, (const T*)K10, ldk, aoff, (const T*)Bp, (const T*)Cp, seg,
      (const T*)x0, (const T*)x1, (T*)y0, (T*)y1, m);
}

template <typename T>
static int dispatch_d1(int d1, const void* K01, const void* K10, long long ldk,
                       long long aoff, const void* Bp, const void* Cp, Segs seg,
                       const void* x0, const void* x1, void* y0, void* y1,
                       long long m, cudaStream_t st) {
  switch (d1) {
    case 3: launch<T, 3>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st); break;
    case 6: launch<T, 6>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st); break;
    case 10: launch<T, 10>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st); break;
    case 15: launch<T, 15>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st); break;
    case 21: launch<T, 21>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 float64.  K01/K10 (d1, d1, ldk), Bp/Cp (nseg, nu, nu),
// x0/x1/y0/y1 (nu, m), all contiguous; seg_bounds: nseg + 1 host int64 values.
IEHDG_EXPORT int iehdg_cross_pair(int device, int dtype, int d1, const void* K01,
                                  const void* K10, long long ldk, long long aoff,
                                  const void* Bp, const void* Cp,
                                  const long long* seg_bounds, int nseg,
                                  const void* x0, const void* x1, void* y0,
                                  void* y1, long long m, void* stream) {
  if (nseg < 0 || nseg > IEHDG_MAX_SEG) return (int)cudaErrorInvalidValue;
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
