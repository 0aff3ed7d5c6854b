// K2's layout on the H100, shared by its forward (group_norm.cu) and its
// backward (group_norm_bwd.cu).
//
// One thread-block cluster of k blocks a batch row: grid (k, B), cluster
// (k, 1, 1). Block q of a row takes the tokens [q ts, min(N, (q + 1) ts));
// the first rt of them (rt <= ts) are staged into shared memory once by
// 16-byte cp.async, the rest (the re-read mode of a row larger than the
// cluster's shared memory) are read from global memory in every pass, from
// L2 after the first. A block reduces its slice to per-channel or
// per-group partials in shared memory; after cluster.sync() every block
// reads the k partials of its row through distributed shared memory and
// merges them in rank order, so that all blocks of the row hold the same
// result and no sum depends on timing (no atomics).
//
// Threads visit the slice as [tokens, C / V] vectors of V elements (16
// bytes; V = 1 on the scalar edge of a C or an address that does not allow
// 16-byte vectors): thread t takes vector column j = t % cols of the rows
// r = t / cols, r + R, ... (R = kThreads / cols), or with more columns
// than threads the columns t, t + kThreads, ... of every row. Per-channel
// partials of the R row lanes go to shared memory and are folded in lane
// order.
//
// The launch plan (k, ts, rt and the shared memory) is computed by the
// caller, ops/group_norm.py `k2_plan`; launch_cluster() checks it and, at
// the first launch of a configuration, that the card can schedule it.

#pragma once

#include <cooperative_groups.h>

#include <mutex>
#include <set>
#include <tuple>
#include <type_traits>

#include "common.cuh"

namespace pidm {
namespace gn {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;  // 227 KB, the most shared memory a block may use
constexpr int kClusterMax = 16;   // above 8 the cluster size is non-portable

// Floats of one per-(row lane, channel) scratch array.
__host__ __device__ inline int red_floats(int C, int elt) {
  const int tv = kThreads * (16 / elt);
  return C > tv ? C : tv;
}

// Bytes of the staged slice of one tensor, rounded up to 16.
__host__ __device__ inline long long slice_bytes(int rt, int C, int elt) {
  return ((long long)rt * C * elt + 15) / 16 * 16;
}

// Bytes of shared memory a block takes besides its staged slices
// (ops/group_norm.py `_aux_bytes` computes the same).
__host__ __device__ inline long long aux_bytes(int C, int G, int elt, bool backward) {
  const long long rc = red_floats(C, elt);
  return 4 * (backward ? 2 * rc + 4LL * C + 2LL * G : rc + C + 4LL * G);
}

__device__ __forceinline__ int rows_of(int q, int N, int ts) {
  const int n0 = q * ts;
  return max(0, min(N, n0 + ts) - n0);
}

// V elements at p (aligned to them when V > 1) to fp32.
template <typename T, int V>
__device__ __forceinline__ void load_vec(float (&f)[V], const T* p) {
  if constexpr (std::is_same<T, float>::value && V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 u = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = u.x;
      f[4 * i + 1] = u.y;
      f[4 * i + 2] = u.z;
      f[4 * i + 3] = u.w;
    }
  } else if constexpr (!std::is_same<T, float>::value && V % 8 == 0) {
#pragma unroll
    for (int i = 0; i < V / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 t = __bfloat1622float2(h[e]);
        f[8 * i + 2 * e] = t.x;
        f[8 * i + 2 * e + 1] = t.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f32(p[i]);
  }
}

// V fp32 values to T at p (aligned as in load_vec), each rounded once.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (std::is_same<T, float>::value && V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  } else if constexpr (!std::is_same<T, float>::value && V % 8 == 0) {
#pragma unroll
    for (int i = 0; i < V / 8; ++i) {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(f[8 * i + 2 * e], f[8 * i + 2 * e + 1]);
      reinterpret_cast<uint4*>(p)[i] = u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<T>(f[i]);
  }
}

// Start copying `count` elements from global src to shared dst: 16-byte
// cp.async when V > 1 (both 16-byte aligned, count a multiple of V), else
// element by element. stage_wait() completes every copy of the block.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src, int count) {
  if constexpr (V > 1) {
    for (int i = threadIdx.x; i < count / V; i += kThreads) {
      const unsigned s = (unsigned)__cvta_generic_to_shared(dst + (long long)i * V);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src + (long long)i * V)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The two halves of cluster.sync(): after cluster_arrive() a block reads no
// other block's shared memory; cluster_wait() returns once every block of
// the cluster has arrived, so none exits while another still reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The vector columns a thread visits and its row lane.
struct Lanes {
  int R, r, j0, js;
  __device__ explicit Lanes(int cols) {
    const int t = threadIdx.x;
    if (cols <= kThreads) {
      R = kThreads / cols;
      r = t / cols;
      j0 = r < R ? t % cols : cols;  // threads past the last lane visit nothing
      js = cols;
    } else {
      R = 1;
      r = 0;
      j0 = t;
      js = kThreads;
    }
  }
};

// Calls f(o, resident) for the rows r, r + R, ... of the slice in vector
// column j, o the offset of the vector in the slice: with resident a
// std::true_type below the staged rows (read it from shared memory), a
// std::false_type above them (read it from global memory).
template <int V, typename F>
__device__ __forceinline__ void for_rows(const Lanes& L, int j, int C, int res, int rows, F&& f) {
  int t = L.r, o = L.r * C + j * V;
  const int step = L.R * C;
#pragma unroll 4
  for (; t < res; t += L.R, o += step) f(o, std::true_type{});
  for (; t < rows; t += L.R, o += step) f(o, std::false_type{});
}

// Per-channel sums of the R row lanes' partials red[R][C], in lane order.
__device__ __forceinline__ void fold_lanes(float* dst, const float* red, int R, int C) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += red[r * C + c];
    dst[c] = s;
  }
}

// Lets `kernel` take up to kSmemMax bytes of dynamic shared memory and
// clusters of up to kClusterMax blocks.
template <typename... Params>
cudaError_t set_attributes(void (*kernel)(Params...)) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Checks a plan against the shape and launches `kernel` on grid (k, B) in
// clusters of k blocks, kThreads each, with `smem` bytes of dynamic shared
// memory. The first launch of a (kernel, k, smem) on a device sets the
// kernel's shared-memory and cluster-size attributes and asks the card how
// many such clusters it can hold at once: none, and the launch is refused.
// Returns the CUDA error (a refused plan: cudaErrorInvalidValue, or
// cudaErrorInvalidConfiguration when it cannot be scheduled).
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int k, int B, int N, int C, int elt, int ts,
                   int rt, int smem, long long need, cudaStream_t st, Args... args) {
  if (k < 1 || k > kClusterMax || ts < 1 || (long long)k * ts < N || rt < 0 || rt > ts ||
      smem > kSmemMax || smem < need || B < 1 || B > 65535 || C < 1)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static std::mutex mu;
  static std::set<std::tuple<const void*, int, int, int>> checked;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple((const void*)kernel, dev, k, smem);
    if (!checked.count(key)) {
      err = set_attributes(kernel);
      int clusters = 0;
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
      checked.insert(key);
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

// How many clusters of k blocks with `smem` bytes each the card holds at
// once for `kernel` (0: the plan cannot be scheduled), or minus the CUDA
// error.
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int k, int smem) {
  if (k < 1 || k > kClusterMax || smem < 0 || smem > kSmemMax) return -(int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes(kernel);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // namespace gn
}  // namespace pidm
