// Tensor Memory Accelerator (TMA) helpers for the batch-last tables of the
// patch solve (K3) and the cross pair (K2), sm_90a.  Tables are float32,
// float64, or (the patch factors under IEHDG_PC_BF16=1) bfloat16.
//
// A table (n, n, ldt) with entry (i, j) of column c at (i * n + j) * ldt + c
// is a 2-D tensor of rows = n * n rows and ldt-strided columns.  A block
// stages a tile of TC consecutive columns of every row in shared memory
// (the first column 16-byte aligned: a box load from an unaligned column
// faults with an illegal instruction on the H100, so the kernels align their
// tiles in table columns and mask the columns outside their range),
// laid out [row][TC], with one or more TMA box loads of TC columns by R rows
// (at most 256 rows a box).  Each box lands 128-byte aligned: R is rounded up
// to a multiple of 128 / (TC * sizeof(T)) rows, and rows past the table's
// last are filled with zeros by the hardware, as are the columns at or past
// the map's column count (the caller's off + m), so a ragged last tile
// reads nothing of another colour.  TMA needs the row stride ldt * sizeof(T)
// to be a multiple of 16 bytes and the base 16-byte aligned: the tables are
// allocated with a padded stride (preconditioners.pad_table).
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled (driver
// API, linked with -lcuda), cached by (pointer, shape, stride, box), and
// passed to the kernel as __grid_constant__ parameters.  A failed encode
// returns IEHDG_TMA_ERROR + the CUresult, which the Python wrapper raises.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#define IEHDG_TMA_ERROR 100000

// the 16-byte vector of a tile row (VEC facets) a thread reads at once
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

// a table entry as the working type (bfloat16 factors read as float: exact)
__device__ __forceinline__ float tab_val(float v) { return v; }
__device__ __forceinline__ double tab_val(double v) { return v; }
__device__ __forceinline__ float tab_val(__nv_bfloat16 v) { return __bfloat162float(v); }

// Vec<T>::n consecutive table entries (a thread's facets of a tile row) as
// the working vector: 16 bytes of float32 or float64, 8 of bfloat16
__device__ __forceinline__ float4 tab_vec(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ double2 tab_vec(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}
__device__ __forceinline__ float4 tab_vec(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// rows per box and boxes per table for a tile of TC columns of `rows` rows
struct TableBox {
  int rows;     // R, rows per box
  int n;        // boxes per table
  int padded;   // n * R rows of shared memory
};

__host__ __device__ constexpr int iehdg_round_up(int a, int b) { return (a + b - 1) / b * b; }

template <typename T, int TC>
__host__ __device__ constexpr TableBox table_box(int rows) {
  // box rows keep every box 128-byte aligned in shared memory
  constexpr int align = (int)(TC * sizeof(T)) >= 128 ? 1 : 128 / (int)(TC * sizeof(T));
  const int n = (rows + 255) / 256;
  const int r = iehdg_round_up((rows + n - 1) / n, align);
  return TableBox{r, n, n * r};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int col, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// One thread: expect the table tile's bytes on `bar` and start its box loads
// (columns col .. col + TC - 1, every row) into `dst`.
template <typename T, int TC>
__device__ __forceinline__ void tma_load_table(T* dst, const CUtensorMap* map, int rows, int col,
                                               uint64_t* bar) {
  const TableBox b = table_box<T, TC>(rows);
  mbar_expect_tx(bar, (uint32_t)(b.padded * TC * sizeof(T)));
  for (int k = 0; k < b.n; ++k) tma_load_2d(dst + (long long)k * b.rows * TC, map, col, k * b.rows, bar);
}

// ---------------------------------------------------------------------------
// host side

struct TmaKey {
  const void* ptr;
  long long rows, ld, ncols;
  int box_cols, box_rows, elem;
  bool operator==(const TmaKey& o) const {
    return ptr == o.ptr && rows == o.rows && ld == o.ld && ncols == o.ncols &&
           box_cols == o.box_cols && box_rows == o.box_rows && elem == o.elem;
  }
};

// Encode (or fetch from the cache) the map of a (rows, ld)-strided table
// with ncols valid columns and boxes of box_cols x box_rows elements.
// Returns 0, or IEHDG_TMA_ERROR + CUresult.
static inline int encode_table_map(CUtensorMap* out, const void* ptr, int elem, long long rows,
                                   long long ld, long long ncols, int box_cols, int box_rows) {
  constexpr int kCache = 64;
  static std::mutex lock;
  static TmaKey keys[kCache];
  static CUtensorMap maps[kCache];
  static int used = 0, next = 0;
  const TmaKey key{ptr, rows, ld, ncols, box_cols, box_rows, elem};
  std::lock_guard<std::mutex> guard(lock);
  for (int k = 0; k < used; ++k) {
    if (keys[k] == key) {
      *out = maps[k];
      return 0;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)ncols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType type = elem == 2   ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
  const CUresult r = cuTensorMapEncodeTiled(
      out, type, 2,
      const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return IEHDG_TMA_ERROR + (int)r;
  keys[next] = key;
  maps[next] = *out;
  next = (next + 1) % kCache;
  if (used < kCache) ++used;
  return 0;
}

template <typename T, int TC>
static inline int encode_table(CUtensorMap* out, const void* ptr, int rows, long long ld,
                               long long ncols) {
  if (((uintptr_t)ptr) % 16 != 0 || (ld * (long long)sizeof(T)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  return encode_table_map(out, ptr, (int)sizeof(T), rows, ld, ncols, TC,
                          table_box<T, TC>(rows).rows);
}
