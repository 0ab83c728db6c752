// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every kernel library exposes a plain C interface loaded with ctypes
// (incompressibleeulerhdg_tpu_torch/kernels.py): pointers and the stream
// arrive as void*, each entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#define IEHDG_MAX_SEG 8

// Column segments of a batch-last field: column c belongs to segment s
// when b[s] <= c < b[s + 1]; columns at or past b[n] belong to none.
struct Segs {
  int n;
  long long b[IEHDG_MAX_SEG + 1];
};

__device__ __forceinline__ int segment_of(const Segs& seg, long long c) {
  int s = -1;
#pragma unroll
  for (int k = 0; k < IEHDG_MAX_SEG; ++k) {
    if (k < seg.n && c >= seg.b[k] && c < seg.b[k + 1]) s = k;
  }
  return s;
}

static inline Segs make_segs(const long long* bounds, int nseg) {
  Segs s;
  s.n = nseg;
  for (int k = 0; k <= IEHDG_MAX_SEG; ++k) s.b[k] = k <= nseg ? bounds[k] : 0;
  return s;
}

static inline unsigned int blocks_for(long long m, int threads) {
  return (unsigned int)((m + threads - 1) / threads);
}

#define IEHDG_EXPORT extern "C" __attribute__((visibility("default")))

IEHDG_EXPORT const char* iehdg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
