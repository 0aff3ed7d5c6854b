// Shared helpers for the port's kernels: element loads/stores in fp32 or
// bf16, block-wide reductions, and the token-tile LayerNorm of K1's
// forward and backward (skipped in K3's mode).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pidm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; every thread gets the result. `scratch` holds one
// float per warp. blockDim.x must be a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < n_warps; ++w) t += scratch[w];  // same order in every thread
  return t;
}

// Copy `tile` token rows starting at n0 into xs[tile][C] as fp32; rows at or
// beyond N are zero.
template <typename T>
__device__ inline void load_tile(float* xs, const T* __restrict__ xb, int n0, int tile, int N,
                          int C) {
  const int valid = min(tile, N - n0) * C;
  const T* src = xb + (long long)n0 * C;
  for (int i = threadIdx.x; i < tile * C; i += blockDim.x)
    xs[i] = i < valid ? to_f32(src[i]) : 0.f;
}

// In-place LayerNorm over C of the first `rows` rows of xs, one warp per row.
__device__ inline void ln_rows(float* xs, int rows, int C, const float* __restrict__ gamma,
                        float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += n_warps) {
    float* row = xs + r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mu;
      v = fmaf(d, d, v);
    }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
    for (int c = lane; c < C; c += 32) row[c] = (row[c] - mu) * rstd * gamma[c];
  }
}

}  // namespace pidm
