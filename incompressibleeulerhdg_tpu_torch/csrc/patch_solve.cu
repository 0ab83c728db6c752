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
// colour (about 65k facets) holds Dinv0 + Sinv = 2 * 20*20*65.5k*4 B = 0.21 GB
// and K01 + K10 = 52 MB; a symmetric sweep streams about 1 GB of tables.
// The 4 nu^2 + 4 nu d1 FMAs per facet are well below the arithmetic rate.
//
// What the design does about it: one thread per facet, coalesced batch-last
// reads of every table, and the four nu-vectors of the solve (r0 and its
// update, w, t, y1) kept on chip, so the fields are read and written once.
// They live in shared memory, one column per thread (conflict-free), and
// not in registers: with the vectors in registers every row loop has to be
// unrolled, and at d1 = 10 ptxas then placed them in local memory (8 KB of
// stack and 14.6 KB of spill stores a thread for float32, sm_90a), which
// held the kernel to about a third of K1's bandwidth on an H100.  Here only
// the inner loops unroll, so each thread keeps one table row's loads in
// flight.  Dinv0 is applied twice and streamed twice.
#include "common.cuh"

// threads per block: the three nu-vectors of a block (3 nu BT values) stay
// below the 48 KB of static shared memory: 128 (float32) or 64 (float64)
// threads up to d1 = 15, half as many at d1 = 21 (32,256 bytes a block
// either way).  The shared memory a thread needs, not the block size, bounds
// the threads an SM holds, so the smaller blocks cost no occupancy.
template <typename T, int D1>
struct PatchThreads {
  static constexpr int value = (sizeof(T) == 4 ? 128 : 64) / (D1 > 15 ? 2 : 1);
};

template <typename T, int D1>
__global__ void patch_solve_kernel(
    const T* __restrict__ Di, const T* __restrict__ Si,
    const T* __restrict__ K01, const T* __restrict__ K10, long long ldt,
    long long off, const T* __restrict__ Bp, const T* __restrict__ Cp,
    const T* __restrict__ r0, const T* __restrict__ r1, T* __restrict__ y0,
    T* __restrict__ y1, long long m) {
  constexpr int NU = 2 * D1;
  constexpr int BT = PatchThreads<T, D1>::value;
  __shared__ T smem[3 * NU * BT];
  const int tid = threadIdx.x;
  T* u = smem + tid;            // r0, later r0 - (I2 (x) K01 + Bp) y1
  T* w = smem + NU * BT + tid;  // w, later y1
  T* t = smem + 2 * NU * BT + tid;
  const long long c = blockIdx.x * (long long)BT + tid;
  if (c >= m) return;
  const T* Dc = Di + off + c;
  const T* Sc = Si + off + c;
  const T* K01c = K01 + off + c;
  const T* K10c = K10 + off + c;

#pragma unroll
  for (int j = 0; j < NU; ++j) u[j * BT] = r0[j * m + c];

  // w = Dinv0 r0
#pragma unroll 1
  for (int i = 0; i < NU; ++i) {
    T a = T(0);
#pragma unroll
    for (int j = 0; j < NU; ++j) a += __ldg(Dc + (long long)(i * NU + j) * ldt) * u[j * BT];
    w[i * BT] = a;
  }

  // t = r1 - (I2 (x) K10 + Cp) w, rows i and D1 + i together
#pragma unroll 1
  for (int i = 0; i < D1; ++i) {
    T a0 = T(0), a1 = T(0);
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      a0 += __ldg(Cp + i * NU + j) * w[j * BT];
      a1 += __ldg(Cp + (D1 + i) * NU + j) * w[j * BT];
    }
#pragma unroll
    for (int j = 0; j < D1; ++j) {
      const T k = __ldg(K10c + (long long)(i * D1 + j) * ldt);
      a0 += k * w[j * BT];
      a1 += k * w[(D1 + j) * BT];
    }
    t[i * BT] = r1[i * m + c] - a0;
    t[(D1 + i) * BT] = r1[(D1 + i) * m + c] - a1;
  }

  // y1 = Sinv t (kept in w)
#pragma unroll 1
  for (int i = 0; i < NU; ++i) {
    T a = T(0);
#pragma unroll
    for (int j = 0; j < NU; ++j) a += __ldg(Sc + (long long)(i * NU + j) * ldt) * t[j * BT];
    w[i * BT] = a;
    y1[i * m + c] = a;
  }

  // u = r0 - (I2 (x) K01 + Bp) y1
#pragma unroll 1
  for (int i = 0; i < D1; ++i) {
    T a0 = T(0), a1 = T(0);
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      a0 += __ldg(Bp + i * NU + j) * w[j * BT];
      a1 += __ldg(Bp + (D1 + i) * NU + j) * w[j * BT];
    }
#pragma unroll
    for (int j = 0; j < D1; ++j) {
      const T k = __ldg(K01c + (long long)(i * D1 + j) * ldt);
      a0 += k * w[j * BT];
      a1 += k * w[(D1 + j) * BT];
    }
    u[i * BT] -= a0;
    u[(D1 + i) * BT] -= a1;
  }

  // y0 = Dinv0 u
#pragma unroll 1
  for (int i = 0; i < NU; ++i) {
    T a = T(0);
#pragma unroll
    for (int j = 0; j < NU; ++j) a += __ldg(Dc + (long long)(i * NU + j) * ldt) * u[j * BT];
    y0[i * m + c] = a;
  }
}

template <typename T, int D1>
static void launch(const void* Di, const void* Si, const void* K01,
                   const void* K10, long long ldt, long long off,
                   const void* Bp, const void* Cp, const void* r0,
                   const void* r1, void* y0, void* y1, long long m,
                   cudaStream_t stream) {
  constexpr int threads = PatchThreads<T, D1>::value;
  patch_solve_kernel<T, D1><<<blocks_for(m, threads), threads, 0, stream>>>(
      (const T*)Di, (const T*)Si, (const T*)K01, (const T*)K10, ldt, off,
      (const T*)Bp, (const T*)Cp, (const T*)r0, (const T*)r1, (T*)y0, (T*)y1, m);
}

template <typename T>
static int dispatch_d1(int d1, const void* Di, const void* Si, const void* K01,
                       const void* K10, long long ldt, long long off,
                       const void* Bp, const void* Cp, const void* r0,
                       const void* r1, void* y0, void* y1, long long m,
                       cudaStream_t st) {
  switch (d1) {
    case 3: launch<T, 3>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st); break;
    case 6: launch<T, 6>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st); break;
    case 10: launch<T, 10>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st); break;
    case 15: launch<T, 15>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st); break;
    case 21: launch<T, 21>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 float64.  Di/Si (nu, nu, ldt), K01/K10 (d1, d1, ldt),
// Bp/Cp (nu, nu), r0/r1/y0/y1 (nu, m), all contiguous; the colour's table
// columns are off .. off + m - 1.
IEHDG_EXPORT int iehdg_patch_solve(int device, int dtype, int d1, const void* Di,
                                   const void* Si, const void* K01,
                                   const void* K10, long long ldt, long long off,
                                   const void* Bp, const void* Cp, const void* r0,
                                   const void* r1, void* y0, void* y1,
                                   long long m, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d1<float>(d1, Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st);
  if (dtype == 1)
    return dispatch_d1<double>(d1, Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st);
  return (int)cudaErrorInvalidValue;
}
