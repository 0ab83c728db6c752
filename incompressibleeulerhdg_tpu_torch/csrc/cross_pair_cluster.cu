// K2c: the fused pair of factored cross applies of K2 at a width d1 given at
// run time, on thread-block clusters (the port launches it where
// preconditioners.CROSS_PAIR_MEASURED names it, d1 = 21 .. 45: k = 4 .. 7):
//
//     y0[:, c] = (I2 (x) K01[:, :, aoff + c] + Bp[s(c)]) x1[:, c]
//     y1[:, c] = (I2 (x) K10[:, :, aoff + c] + Cp[s(c)]) x0[:, c]
//
// Replaces the Pallas kernel incompressibleeulerhdg_tpu/linalg/preconditioners.py
// `_cross_pair_pallas`, which the JAX package runs at any width.  Callers as
// K2: `_cross_pair_full` (every tentative matvec: segments = the facet
// colours, zero penalty on the boundary tail) and `_cross_pair_color` (one
// colour at its column offset, in every off-colour update of the fused
// Schwarz sweep).
//
// What bounds it on the card: table bytes.  At 128^2, k = 6, float32 one
// colour (16,256 facets) streams the two (36, 36) scalar tables, 2 * 36*36
// * 16256 * 4 B = 169 MB, and 19 MB of fields: 0.056 ms at 3.35 TB/s.  The
// 2 (2 d1^2 + nu^2) FMAs a facet take about a seventh of that in float32;
// two thirds of them are the penalty P[s] x, the one part with reuse.
//
// What the design does about it (the plan, F facets a tile and a cluster
// of CS thread blocks, comes from linalg/preconditioners.py:cross_pair_plan):
// - a cluster of CS thread blocks on neighbouring SMs owns a tile of F
//   consecutive facets (table columns, aligned to F); rank r owns the
//   scalar rows i0 .. i1 - 1 of d1 (r d1 / CS .. (r + 1) d1 / CS - 1, as
//   K3w splits them) of both sides and both components, so each row of K01
//   and K10 has one owner;
// - a thread owns one scalar row i of one side for VEC facets (16 bytes),
//   lanes along facets, and computes rows i and d1 + i of its side: every
//   table load is a 16-byte load, a warp's loads of one row one contiguous
//   run of F x the element size (64, 128 or 256 bytes), and it streams its
//   row in groups of K2C_U loads, the next group in flight while the last
//   one's FMAs run (K3w's pattern); the first group of a tile is issued
//   before the cluster barrier that precedes the tile;
// - x is read from device memory once a tile: each rank loads its own rows
//   of x0 and x1 for the tile and stores them into every rank's copy
//   through distributed shared memory (cooperative_groups map_shared_rank);
// - the clusters are persistent (as many as are resident, from
//   cudaOccupancyMaxActiveClusters), each walking the tiles t, t + G, ...;
//   x is double-buffered, so one cluster barrier a tile (arrive after the
//   tile, wait before the next, the next tile's table and x loads issued
//   in between) orders both the pushes and the reuse of a buffer;
// - the penalty P[s] (nu x nu, at most IEHDG_MAX_SEG segments) is staged in
//   shared memory once a segment a block (the rank's rows of Bp and Cp, rows
//   padded to 16 bytes), and P[s] x is an outer product of 2 rows x VEC
//   facets a thread: per VEC terms two 16-byte loads of P and VEC of x for
//   2 VEC^2 FMAs, no load of P through the load pipe; in a tile inside one
//   segment its terms run a share between each table group's loads and
//   FMAs, so they fill the wait for the loads;
// - a tile that straddles a segment edge applies each segment's block to
//   its own facets, restaging P between them; tiles are aligned in table
//   columns (the range's first and last tiles mask the facets outside it),
//   and the tables need 16-byte aligned rows and base (pad_table's layout).
// No tensor cores: in float32 they would round the inputs to TF32.
#include <cooperative_groups.h>

#include "common.cuh"
#include "tma.cuh"  // Vec<T>, iehdg_round_up

namespace cg = cooperative_groups;

constexpr int CROSS_CLUSTER_THREADS_MAX = 512;  // 128 registers a thread
constexpr int CROSS_CLUSTER_MAX = 8;            // the portable cluster size
constexpr int CROSS_CLUSTER_SMEM_MAX = 232448;
constexpr int K2C_U = 8;  // 16-byte table loads a group (in flight a thread: two groups)

// shared-memory layout, in elements of T: two buffers of both inputs
// ([buffer][input][NP][F]: input 0 is x1, side 0's, input 1 is x0), then
// the rank's rows of the penalty blocks ([side][2 RS][NP]: rows i0 + l,
// then d1 + i0 + l); NP = nu rounded up to 16 bytes, the pad rows and
// columns zero
struct CrossClusterLayout {
  int np, off_x, off_p;
  long long bytes;
};

__host__ __device__ inline CrossClusterLayout cross_cluster_layout(int d1, int F, int RS,
                                                                   int size) {
  CrossClusterLayout L;
  L.np = iehdg_round_up(2 * d1, 16 / size);
  L.off_x = 0;
  L.off_p = 4 * L.np * F;
  L.bytes = (long long)(L.off_p + 4 * RS * L.np) * size;
  return L;
}

// The loads of the thread's table row, K2C_U terms a group: group j0 of
// the n terms A[j * ld] (16 bytes each) into v (rows past n read row n - 1).
template <typename T>
__device__ __forceinline__ void load_group(typename Vec<T>::type (&v)[K2C_U],
                                           const T* __restrict__ A, long long ld, int j0,
                                           int n) {
  using V = typename Vec<T>::type;
  const T* q = A + (long long)j0 * ld;
#pragma unroll
  for (int u = 0; u < K2C_U; ++u) {
    v[u] = __ldg(reinterpret_cast<const V*>(q));
    if (j0 + u + 1 < n) q += ld;
  }
}

// component i of a 16-byte vector (i a constant once the loops unroll: no
// vector's address is taken, so none leaves the registers)
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ double comp(const double2& v, int i) { return i == 0 ? v.x : v.y; }

// acc[a][v] += k[v] * x[a d1 + j][v] for both components a, from the
// thread's VEC facets of row j of the side's input
template <typename T>
__device__ __forceinline__ void fma_pair(T (&acc)[2][Vec<T>::n], const typename Vec<T>::type k,
                                         const T* xa, const T* xb) {
  using V = typename Vec<T>::type;
  constexpr int VEC = Vec<T>::n;
  const V a = *reinterpret_cast<const V*>(xa);
  const V b = *reinterpret_cast<const V*>(xb);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    acc[0][v] += comp(k, v) * comp(a, v);
    acc[1][v] += comp(k, v) * comp(b, v);
  }
}

__device__ __forceinline__ float4 pack(const float (&a)[4]) {
  return make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ double2 pack(const double (&a)[2]) { return make_double2(a[0], a[1]); }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int F>
__global__ void __launch_bounds__(CROSS_CLUSTER_THREADS_MAX) cross_pair_cluster_kernel(
    int d1, int RS, const T* __restrict__ K01, const T* __restrict__ K10, long long ld,
    long long aoff, const T* __restrict__ Bp, const T* __restrict__ Cp, Segs seg,
    const T* __restrict__ x0, const T* __restrict__ x1, T* __restrict__ y0,
    T* __restrict__ y1, long long m, int ntiles) {
  using V = typename Vec<T>::type;
  constexpr int VEC = Vec<T>::n, Q = F / VEC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int CS = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int nu = 2 * d1;
  const CrossClusterLayout L = cross_cluster_layout(d1, F, RS, (int)sizeof(T));
  const int NP = L.np;
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* sx = sm + L.off_x;
  T* sp = sm + L.off_p;
  const int i0 = (int)((long long)rank * d1 / CS), i1 = (int)((long long)(rank + 1) * d1 / CS);
  const int rs = i1 - i0;  // scalar rows of this rank (<= RS)
  const int tid = threadIdx.x, nt = blockDim.x;
  const int q = tid % Q, slot = tid / Q;
  const int side = slot >= RS ? 1 : 0, il = slot - side * RS;
  const bool act = il < rs;
  const int i = i0 + (act ? il : 0);  // the thread's scalar row
  const T* Kr = (side == 0 ? K01 : K10) + (long long)i * d1 * ld;
  T* y = side == 0 ? y0 : y1;
  const long long base = aoff - aoff % F;       // table column of tile 0
  const long long gvalid = aoff - aoff % VEC;   // a 16-byte group of the range
  const int G = (int)(gridDim.x / CS);          // clusters
  int t = (int)(blockIdx.x / CS);               // this cluster's first tile

  // the pad rows of both buffers of both inputs stay zero
  const int pad = NP - nu;
  for (int e = tid; e < 4 * pad * F; e += nt) {
    const int r = e / F;
    sx[((r / pad) * NP + nu + r % pad) * F + e % F] = T(0);
  }
  // this thread's x groups of a tile: group g < 4 rs Q of the rank's rows
  // (input, component, row l, VEC facets), at most two a thread
  T xr[2][VEC];
  auto load_x = [&](int tile) {
    const long long c0 = base + (long long)tile * F - aoff;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int g = tid + u * nt;
      const int inp = g / (2 * rs * Q), r = (g / Q) % (2 * rs);
      const int row = (r / rs) * d1 + i0 + r % rs;
      const T* x = (inp == 0 ? x1 : x0) + (long long)row * m;
      const long long c = c0 + (g % Q) * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        xr[u][v] = g < 4 * rs * Q && c + v >= 0 && c + v < m ? __ldg(x + c + v) : T(0);
    }
  };
  auto push_x = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int g = tid + u * nt;
      if (g >= 4 * rs * Q) continue;
      const int inp = g / (2 * rs * Q), r = (g / Q) % (2 * rs);
      const int row = (r / rs) * d1 + i0 + r % rs;
      T* dst = sx + ((buf * 2 + inp) * NP + row) * F + (g % Q) * VEC;
      const V val = pack(xr[u]);
      for (int k = 0; k < CS; ++k) *reinterpret_cast<V*>(cl.map_shared_rank(dst, k)) = val;
    }
  };
  // the rank's rows of segment s's penalty blocks, both sides
  auto stage_p = [&](int s) {
    for (int e = tid; e < 4 * RS * NP; e += nt) {
      const int sd = e / (2 * RS * NP), r = (e / NP) % (2 * RS), j = e % NP;
      const int l = r % RS;
      T v = T(0);
      if (l < rs && j < nu)
        v = __ldg((sd == 0 ? Bp : Cp) + ((long long)s * nu + (r / RS) * d1 + i0 + l) * nu + j);
      sp[e] = v;
    }
  };

  cluster_arrive_relaxed();  // every rank runs before any pushes into it
  load_x(t);
  cluster_wait();
  push_x(0);
  cluster_arrive();
  int staged = -1;
  for (int k = 0;; ++k, t += G) {
    const int b = k & 1;
    const long long col = base + (long long)t * F;  // table column of the tile's first facet
    const long long c0 = col - aoff;
    const long long gcol = col + q * VEC;  // the thread's 16-byte group
    const T* K = Kr + (gcol + VEC > aoff && gcol < aoff + m ? gcol : gvalid);
    V kv[K2C_U];
    if (act) load_group<T>(kv, K, ld, 0, d1);
    const int tn = t + G;
    if (tn < ntiles) load_x(tn);
    cluster_wait();  // this tile's x in buffer b; every rank done with buffer b ^ 1
    if (tn < ntiles) push_x(b ^ 1);

    T acc[2][VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[0][v] = acc[1][v] = T(0);
    const T* xs = sx + (b * 2 + side) * NP * F + q * VEC;  // the side's input
    // the segment that holds every facet of the tile in the range, if one does
    const long long lo = c0 > 0 ? c0 : 0, hi = c0 + F < m ? c0 + F : m;
    int whole = -1;
    for (int s = 0; s < seg.n; ++s)
      if (seg.b[s] <= lo && hi <= seg.b[s + 1]) whole = s;
    // penalty rows i and d1 + i of segment s's block (staged, uniform across
    // the block: the tile is the cluster's)
    const T* p0 = sp + (side * 2 * RS + il) * NP;
    const T* p1 = p0 + RS * NP;
    auto stage = [&](int s) {
      if (s != staged) {
        __syncthreads();
        stage_p(s);
        __syncthreads();
        staged = s;
      }
    };
    // VEC terms j .. j + VEC - 1 of P[s] x into out, from the thread's facets
    auto pen_step = [&](T(&out)[2][VEC], int j) {
      const V pa = *reinterpret_cast<const V*>(p0 + j);
      const V pb = *reinterpret_cast<const V*>(p1 + j);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const V xv = *reinterpret_cast<const V*>(xs + (j + u) * F);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          out[0][v] += comp(pa, u) * comp(xv, v);
          out[1][v] += comp(pb, u) * comp(xv, v);
        }
      }
    };
    if (whole < 0) {  // a segment edge (or the penalty-free tail) in the tile
      for (int s = 0; s < seg.n; ++s) {
        const long long b0 = seg.b[s], b1 = seg.b[s + 1];
        if (b1 <= c0 || b0 >= c0 + F || b1 <= b0) continue;
        stage(s);
        T pen[2][VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) pen[0][v] = pen[1][v] = T(0);
        for (int j = 0; j < NP; j += VEC) pen_step(pen, j);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const long long c = c0 + q * VEC + v;
          if (c >= b0 && c < b1) {
            acc[0][v] += pen[0][v];
            acc[1][v] += pen[1][v];
          }
        }
      }
    } else {
      stage(whole);
    }
    // scalar table of the side, both components, streamed a group ahead;
    // a tile inside one segment runs its penalty's terms a share a group,
    // between issuing the next group's loads and the FMAs of this one
    const int groups = (d1 + K2C_U - 1) / K2C_U;
    const int share = whole < 0 ? 0 : (NP / VEC + groups - 1) / groups * VEC;
    int jp = whole < 0 ? NP : 0;  // the penalty's next term
    if (act) {
      int j = 0;
      for (; j + K2C_U < d1; j += K2C_U) {
        V w[K2C_U];
        load_group<T>(w, K, ld, j + K2C_U, d1);
        for (const int je = jp + share < NP ? jp + share : NP; jp < je; jp += VEC)
          pen_step(acc, jp);
#pragma unroll
        for (int u = 0; u < K2C_U; ++u) {
          fma_pair<T>(acc, kv[u], xs + (j + u) * F, xs + (d1 + j + u) * F);
          kv[u] = w[u];
        }
      }
      for (; jp < NP; jp += VEC) pen_step(acc, jp);
#pragma unroll
      for (int u = 0; u < K2C_U; ++u)
        if (j + u < d1) fma_pair<T>(acc, kv[u], xs + (j + u) * F, xs + (d1 + j + u) * F);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const long long c = c0 + q * VEC + v;
        if (c >= 0 && c < m) {
          y[(long long)i * m + c] = acc[0][v];
          y[(long long)(d1 + i) * m + c] = acc[1][v];
        }
      }
    }
    cluster_arrive();  // done with buffer b; the next tile's x pushed
    if (tn >= ntiles) break;
  }
  cluster_wait();  // no rank leaves while another may still touch its memory
}

// resident clusters of a plan (cudaOccupancyMaxActiveClusters), cached by plan
template <typename T, int F>
static int resident_clusters(const cudaLaunchConfig_t& cfg, int CS) {
  constexpr int kCache = 32;
  static int keys[kCache][3];
  static int vals[kCache];
  static int used = 0;
  const int key[3] = {(int)cfg.blockDim.x, (int)cfg.dynamicSmemBytes, CS};
  for (int k = 0; k < used; ++k)
    if (keys[k][0] == key[0] && keys[k][1] == key[1] && keys[k][2] == key[2]) return vals[k];
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (void*)cross_pair_cluster_kernel<T, F>, &cfg) !=
      cudaSuccess)
    n = 0;
  if (n > 0 && used < kCache) {
    keys[used][0] = key[0];
    keys[used][1] = key[1];
    keys[used][2] = key[2];
    vals[used++] = n;
  }
  return n;
}

template <typename T, int F>
static int launch_f(int d1, int CS, int threads, long long smem, const void* K01,
                    const void* K10, long long ld, long long aoff, const void* Bp,
                    const void* Cp, Segs seg, const void* x0, const void* x1, void* y0, void* y1,
                    long long m, cudaStream_t stream) {
  static bool attr = false;  // the cap only: a launch takes the bytes it asks for
  if (!attr) {
    const cudaError_t a = cudaFuncSetAttribute(cross_pair_cluster_kernel<T, F>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               CROSS_CLUSTER_SMEM_MAX);
    if (a != cudaSuccess) return (int)a;
    attr = true;
  }
  const int RS = (d1 + CS - 1) / CS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS);
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
  const int clusters = resident_clusters<T, F>(cfg, CS);
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = blocks_for(aoff % F + m, F);  // from the aligned first tile
  cfg.gridDim = dim3((unsigned int)(ntiles < clusters ? ntiles : clusters) * CS);
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, cross_pair_cluster_kernel<T, F>, d1, RS, (const T*)K01, (const T*)K10, ld, aoff,
      (const T*)Bp, (const T*)Cp, seg, (const T*)x0, (const T*)x1, (T*)y0, (T*)y1, m,
      (int)ntiles);
  return le != cudaSuccess ? (int)le : (int)cudaGetLastError();
}

template <typename T>
static int launch(int d1, int F, int CS, int threads, long long smem, const void* K01,
                  const void* K10, long long ld, long long aoff, const void* Bp, const void* Cp,
                  Segs seg, const void* x0, const void* x1, void* y0, void* y1, long long m,
                  cudaStream_t st) {
  constexpr int VEC = Vec<T>::n;
  const int RS = (d1 + CS - 1) / CS;
  const CrossClusterLayout L = cross_cluster_layout(d1, F, RS, (int)sizeof(T));
  const int rows = F * (int)sizeof(T);
  if ((rows != 64 && rows != 128 && rows != 256) || threads != 2 * RS * (F / VEC) ||
      threads > CROSS_CLUSTER_THREADS_MAX || smem != L.bytes || smem > CROSS_CLUSTER_SMEM_MAX ||
      aoff % F + m > 0x7fffffffLL)  // tiles are counted in int
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)K01 | (uintptr_t)K10) % 16 || (ld * (long long)sizeof(T)) % 16)
    return (int)cudaErrorMisalignedAddress;  // 16-byte table loads
#define K2C_LAUNCH(FF)                                                                        \
  if (F == FF)                                                                                \
    return launch_f<T, FF>(d1, CS, threads, smem, K01, K10, ld, aoff, Bp, Cp, seg, x0, x1, y0, \
                           y1, m, st);
  K2C_LAUNCH(64 / (int)sizeof(T))
  K2C_LAUNCH(128 / (int)sizeof(T))
  K2C_LAUNCH(256 / (int)sizeof(T))
#undef K2C_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 float64.  K01/K10 (d1, d1, ldk-strided columns) with
// 16-byte aligned bases and rows, Bp/Cp (nseg, nu, nu), x0/x1/y0/y1 (nu, m),
// contiguous; seg_bounds: nseg + 1 host int64 values.  The plan
// (preconditioners.py:cross_pair_plan): F facets a cluster of CS thread
// blocks (F x the element size 64, 128 or 256 bytes), `threads` = 2
// ceil(d1 / CS) F / VEC, `smem` the bytes of the layout above; one that does
// not match returns cudaErrorInvalidValue.
IEHDG_EXPORT int iehdg_cross_pair_cluster(int device, int dtype, int d1, int F, int CS,
                                          int threads, long long smem, const void* K01,
                                          const void* K10, long long ldk, long long aoff,
                                          const void* Bp, const void* Cp,
                                          const long long* seg_bounds, int nseg,
                                          const void* x0, const void* x1, void* y0, void* y1,
                                          long long m, void* stream) {
  if (nseg < 0 || nseg > IEHDG_MAX_SEG || d1 < 1 || m < 1 || CS < 1 ||
      CS > CROSS_CLUSTER_MAX || CS > d1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Segs seg = make_segs(seg_bounds, nseg);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(d1, F, CS, threads, smem, K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0,
                         y1, m, st);
  if (dtype == 1)
    return launch<double>(d1, F, CS, threads, smem, K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0,
                          y1, m, st);
  return (int)cudaErrorInvalidValue;
}
