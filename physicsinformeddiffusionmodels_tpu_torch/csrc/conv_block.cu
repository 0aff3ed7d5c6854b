// K4: the channel-major Block, 3x3 conv (SAME, zero padding) + bias ->
// GroupNorm -> affine -> FiLM -> SiLU, on x [B, Ci, P*P] -> [B, Co, P*P]:
//   z = conv3x3(x) + bias                        (fp32)
//   y = (z - mean) rstd gamma (scale + 1) + beta (scale + 1) + shift
//   out = y sigmoid(y)                           (x's type)
// with mean and rstd per (row, group) over all P*P pixels and Co/G
// channels (biased variance, eps).
//
// Replaces physicsinformeddiffusionmodels_tpu/ops/pallas_conv.py
// `_fwd_kernel` (launched by `_fwd_call` through pl.pallas_call, :348),
// the forward of `conv_gn_film_silu_cm`. The weight is the TPU kernel's
// `wflat` [Co, 9 Ci] (tap-major columns, in x's type); the products run
// in fp32 (fp32 FMA for fp32 x, TF32 off; bf16 x and weights widened
// exactly), summed in fp32, as the TPU kernel's `_mmf` multiplies in x's
// type with an fp32 result.
//
// Bound on the H100: fp32 x, operations (2 Co 9 Ci flops a pixel against
// 4 (Ci + Co) bytes: 18x more flops than the card's 20 flop/byte fp32
// balance at Ci = Co = 32); bf16 x, bytes (the same flops at the bf16
// tensor-core rate the TPU kernel's bf16 matmul would get take half the
// time of the bytes).
//
// Design. The TPU kernel holds a whole row's z in VMEM ([Co, N] fp32, 512 KB
// at level 0), well beyond the 227 KB of shared memory of a block, so this
// takes three launches with z in an fp32 workspace that the backward reuses:
//   1. conv_fwd, grid (pixel tiles of 128, Co tiles of 32, B): the
//      implicit-GEMM tile of conv_tile.cuh (M = Co, K = 9 Ci), plus bias,
//      written to z; and for each (row, channel, tile) the tile's sum and
//      its sum of squares about the tile's own mean, from the registers (a
//      warp holds four channels of the whole tile).
//   2. conv_stats, one thread per (row, group): folds its channels' tiles
//      in a fixed order into the mean and the variance by Chan's parallel
//      formula, M2 = sum(m2_i + n_i (mean_i - mean)^2). This is a two-pass
//      variance per tile joined exactly, so it does not cancel the way the
//      TPU kernel's E[z^2] - mean^2 (:159-161) can when |mean| >> std, and
//      it costs no second read of z, which a centred pass over the
//      workspace would. No atomics: the result repeats exactly.
//   3. conv_apply, grid (chunks, Co, B): one (row, channel) scale and
//      shift a block, then z -> out in the centred form (z - mean) a + b.

#include "conv_tile.cuh"

namespace {

using pidm::from_f32;
using pidm::to_f32;
using namespace pidm::conv;

constexpr int kApplyItems = 4;  // pixels per thread in conv_apply

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ z,
                float* __restrict__ part, int Ci, int Co, int P) {
  const int N = P * P, tiles = gridDim.x;
  const int tile = blockIdx.x, n0 = tile * kBN, m0 = blockIdx.y * kBM, b = blockIdx.z;
  float acc[kTM][kTN];
  conv_tile<T, false>(acc, w, Co, m0, x + (long long)b * Ci * N, Ci, P, n0);
  const int w_id = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = min(kBN, N - n0);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int co = m0 + w_id * kTM + i;
    if (co >= Co) break;  // the same for the whole warp
    const float bi = bias[co];
    float* zrow = z + ((long long)b * Co + co) * N;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + lane + 32 * j;
      acc[i][j] += bi;
      if (n < N) {
        zrow[n] = acc[i][j];
        s += acc[i][j];
      }
    }
    s = pidm::warp_sum(s);
    const float mt = s / nt;
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const float d = acc[i][j] - mt;
      if (n0 + lane + 32 * j < N) m2 = fmaf(d, d, m2);
    }
    m2 = pidm::warp_sum(m2);
    if (lane == 0) {
      float* p = part + (((long long)b * Co + co) * tiles + tile) * 2;
      p[0] = s;
      p[1] = m2;
    }
  }
}

__global__ void conv_stats_kernel(const float* __restrict__ part, float* __restrict__ stats,
                                  int B, int Co, int G, int tiles, int N, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (row, group)
  if (i >= B * G) return;
  const int cg = Co / G;
  // the group's channels are consecutive: [cg, tiles, 2] from here
  const float* p = part + (long long)i * cg * tiles * 2;
  const int count = cg * tiles;
  const float cnt = (float)N * (float)cg;
  float s = 0.f;
  for (int j = 0; j < count; ++j) s += p[2 * j];
  const float mean = s / cnt;
  float m2 = 0.f;
  for (int j = 0; j < count; ++j) {
    const float nt = (float)min(kBN, N - (j % tiles) * kBN);
    const float d = p[2 * j] / nt - mean;
    m2 += p[2 * j + 1] + nt * d * d;
  }
  stats[2 * i] = mean;
  stats[2 * i + 1] = rsqrtf(m2 / cnt + eps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_apply_kernel(const float* __restrict__ z, const float* __restrict__ stats,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  T* __restrict__ out, int Co, int G, int N) {
  const int co = blockIdx.y, b = blockIdx.z, g = co / (Co / G);
  const float mean = stats[2 * (b * G + g)], rstd = stats[2 * (b * G + g) + 1];
  const float sc1 = scale[b * Co + co] + 1.f;
  const float a = rstd * gamma[co] * sc1;
  const float bb = beta[co] * sc1 + shift[b * Co + co];
  const long long row = ((long long)b * Co + co) * N;
  const int base = blockIdx.x * kThreads * kApplyItems;
#pragma unroll
  for (int k = 0; k < kApplyItems; ++k) {
    const int n = base + k * kThreads + threadIdx.x;
    if (n < N) {
      const float y = fmaf(z[row + n] - mean, a, bb);
      out[row + n] = from_f32<T>(y / (1.f + expf(-y)));
    }
  }
}

template <typename T>
int forward(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
            const void* scale, const void* shift, void* out, void* z, void* part, void* stats,
            int B, int Ci, int Co, int P, int G, float eps, cudaStream_t st) {
  const int N = P * P, tiles = (N + kBN - 1) / kBN;
  conv_fwd_kernel<T><<<dim3(tiles, (Co + kBM - 1) / kBM, B), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<float*>(z), static_cast<float*>(part), Ci, Co, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv_stats_kernel<<<(B * G + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(stats), B, Co, G, tiles, N, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int per_block = kThreads * kApplyItems;
  conv_apply_kernel<T><<<dim3((N + per_block - 1) / per_block, Co, B), kThreads, 0, st>>>(
      static_cast<const float*>(z), static_cast<const float*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(scale), static_cast<const float*>(shift), static_cast<T*>(out),
      Co, G, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Pixel tiles of the forward's statistics partials for an image of N pixels.
extern "C" int pidm_conv_gn_film_silu_tiles(int N) { return (N + kBN - 1) / kBN; }

// x: [B, Ci, P*P] fp32 (bf16 when `bf16` is 1); w: [Co, 9 Ci] tap-major in
// x's type; bias, gamma, beta: [Co] fp32; scale, shift: [B, Co] fp32 (zeros
// for no FiLM); out: [B, Co, P*P] in x's type; z: [B, Co, P*P] fp32
// workspace (conv + bias, read again by the backward); part: [B, Co, tiles,
// 2] fp32 scratch; stats: [B, G, 2] fp32 (mean, rstd; read by the
// backward). Ci and Co multiples of 16, Co/G channels a group. Launches on
// `stream`, allocates nothing, returns the CUDA error.
extern "C" int pidm_conv_gn_film_silu(const void* x, const void* w, const void* bias,
                                      const void* gamma, const void* beta, const void* scale,
                                      const void* shift, void* out, void* z, void* part,
                                      void* stats, int B, int Ci, int Co, int P, int G,
                                      float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return forward<__nv_bfloat16>(x, w, bias, gamma, beta, scale, shift, out, z, part, stats,
                                  B, Ci, Co, P, G, eps, st);
  return forward<float>(x, w, bias, gamma, beta, scale, shift, out, z, part, stats, B, Ci, Co,
                        P, G, eps, st);
}
