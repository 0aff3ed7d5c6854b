// K5: GroupNorm -> FiLM -> SiLU on a bf16 [B, N, C] activation, with the
// affine and FiLM folded by the caller into a per-(row, channel) scale a =
// gamma (scale + 1) and shift b = beta (scale + 1) + shift (fp32). Per
// (row, group), over its N x C/G values: mean and E[x^2] in fp32, inv =
// rsqrt(E[x^2] - mean^2 + eps) (the one-pass variance, not K2's shifted
// sums), then out = y sigmoid(y) with y = x (a inv) + (b - mean a inv),
// rounded to bf16.
//
// Replaces scripts/profile_gn.py `_fwd_kernel_packed` (launched by
// `gn_packed` through pl.pallas_call). The TPU kernel views the row as
// [N C / 128, 128] lanes so that a vreg row is dense, and sums each group's
// lanes with a 128 x 128 0/1 mask matmul on the MXU; both are how the TPU
// lays lanes out, not part of what it computes. Here a thread reads 16
// bytes (8 bf16 values of 8 neighbouring channels) at a time, so a warp
// reads 512 contiguous bytes; with 128 % C == 0 and C % 8 == 0 a thread
// meets the same 8 channels in every vector it reads, and keeps their sums
// in registers.
//
// Bound on the H100: memory. About 10 flops per element against 4 bytes
// (bf16 read and written once). The TPU kernel held 8 rows in VMEM and read
// them once; a row at the Darcy top level (4096 x 32 bf16, 256 KB) does not
// fit a block, so this takes two launches and reads x twice, the second read
// mostly from the 50 MB L2:
//   1. gnp_stats, grid (S, B): each block sums its split of the row's
//      vectors per channel (registers, then a warp-shuffle fold of the lanes
//      that share channels, then the warps in order in shared memory), then
//      per group, into a [B, S, G, 2] scratch. No atomics: the sums run in
//      one fixed order, so the result repeats exactly.
//   2. gnp_apply, grid (tiles, B): each block folds the S partials of every
//      group in order into per-channel coefficients a inv and b - mean a inv,
//      then streams its tile once, 16 bytes a thread.
// Any N; C in {8, 16, 32, 64, 128} (C % 8 == 0, 128 % C == 0), G | C.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;      // bf16 values per 16-byte vector
constexpr int kApplyVecs = 4;  // vectors per thread in the apply pass
constexpr int kMaxC = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// Vectors [s * chunk, min(nvec, (s + 1) * chunk)) of row b; chunk is a
// multiple of kThreads, so thread t's vectors all start at channel
// (t * 8) % C.
__global__ void __launch_bounds__(kThreads)
gnp_stats_kernel(const uint4* __restrict__ x, float* __restrict__ partials, int nvec, int chunk,
                 int C, int G) {
  __shared__ float red[2][kWarps][kMaxC];
  __shared__ float chan[2][kMaxC];
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint4* xb = x + (long long)b * nvec;
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
  const int v_end = min(nvec, (s + 1) * chunk);
  for (int v = s * chunk + tid; v < v_end; v += kThreads) {
    float f[kVec];
    unpack(xb[v], f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s1[j] += f[j];
      s2[j] = fmaf(f[j], f[j], s2[j]);
    }
  }
  // lanes l and l + C/8 start at the same channel: fold them, in a fixed
  // order, down to lanes [0, C/8)
  const int period = C / kVec;
  for (int o = 16; o >= period; o >>= 1) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], o);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], o);
    }
  }
  if (lane < period) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      red[0][warp][lane * kVec + j] = s1[j];
      red[1][warp][lane * kVec + j] = s2[j];
    }
  }
  __syncthreads();
  if (tid < C) {
    float a = 0.f, q = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[0][w][tid];
      q += red[1][w][tid];
    }
    chan[0][tid] = a;
    chan[1][tid] = q;
  }
  __syncthreads();
  const int cg = C / G;
  if (tid < G) {
    float a = 0.f, q = 0.f;
    for (int c = tid * cg; c < (tid + 1) * cg; ++c) {
      a += chan[0][c];
      q += chan[1][c];
    }
    float* p = partials + (((long long)b * gridDim.x + s) * G + tid) * 2;
    p[0] = a;
    p[1] = q;
  }
}

__global__ void __launch_bounds__(kThreads)
gnp_apply_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                 const float* __restrict__ a, const float* __restrict__ bias,
                 const float* __restrict__ partials, int nvec, int C, int G, int S, float eps) {
  __shared__ float coef[2][kMaxC];  // a inv, b - mean a inv
  const int b = blockIdx.y, tid = threadIdx.x, cg = C / G;
  if (tid < C) {
    const int g = tid / cg;
    float s1 = 0.f, s2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* p = partials + (((long long)b * S + s) * G + g) * 2;
      s1 += p[0];
      s2 += p[1];
    }
    const float cnt = (float)nvec * kVec / G;  // N x C/G values per group
    const float mean = s1 / cnt;
    const float inv = rsqrtf(s2 / cnt - mean * mean + eps);
    const float ai = a[(long long)b * C + tid] * inv;
    coef[0][tid] = ai;
    coef[1][tid] = bias[(long long)b * C + tid] - mean * ai;
  }
  __syncthreads();
  const int c0 = (tid * kVec) % C;  // the same for each of this thread's vectors
  float m[kVec], o[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    m[j] = coef[0][c0 + j];
    o[j] = coef[1][c0 + j];
  }
  const uint4* xb = x + (long long)b * nvec;
  uint4* ob = out + (long long)b * nvec;
  const int base = blockIdx.x * kThreads * kApplyVecs;
#pragma unroll
  for (int k = 0; k < kApplyVecs; ++k) {
    const int v = base + k * kThreads + tid;
    if (v < nvec) {
      float f[kVec];
      unpack(xb[v], f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float y = fmaf(f[j], m[j], o[j]);
        f[j] = y / (1.f + expf(-y));
      }
      ob[v] = pack(f);
    }
  }
}

}  // namespace

// x, out: [B, N, C] bf16, 16-byte aligned; a, b: [B, C] fp32, the folded
// scale and shift; partials: [B, S, G, 2] fp32 scratch. C % 8 == 0,
// 128 % C == 0, C % G == 0. Launches on `stream`, allocates nothing,
// returns the CUDA error.
extern "C" int pidm_gn_film_silu_packed(const void* x, void* out, const void* a, const void* b,
                                        void* partials, int B, int N, int C, int G, int S,
                                        float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % kVec || kMaxC % C || C % G) return (int)cudaErrorInvalidValue;
  const int nvec = N * C / kVec;
  const int per = (nvec + S - 1) / S;
  const int chunk = (per + kThreads - 1) / kThreads * kThreads;
  gnp_stats_kernel<<<dim3(S, B), kThreads, 0, st>>>(static_cast<const uint4*>(x),
                                                    static_cast<float*>(partials), nvec, chunk,
                                                    C, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_block = kThreads * kApplyVecs;
  gnp_apply_kernel<<<dim3((nvec + per_block - 1) / per_block, B), kThreads, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(partials), nvec, C, G, S, eps);
  return (int)cudaGetLastError();
}
