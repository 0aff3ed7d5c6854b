// The implicit-GEMM tile of K4's 3x3 convolutions (conv_block.cu, the
// forward; conv_block_bwd.cu, dx): one block computes a [kBM, kBN] tile of
//   out[m, n] = sum_k A[m, k] im2col(src)[k, n],   k = t * C + c,
// A row-major [M, 9 C] in the input's type, src one batch row [C, P*P] of
// a P x P image, tap t = (dr + 1) * 3 + (dc + 1) as in the TPU kernel's
// `_TAPS` (pallas_conv.py:42) and `wflat` (`_flatten_w`, :331). The forward
// reads x at pixel n + s, s = dr * P + dc; the transposed form (dx) reads dz
// at pixel n - s. Products and sums are fp32 on the CUDA cores (fp32 FMA;
// bf16 inputs are widened exactly, as the tensor cores would take them, and
// accumulated in fp32).
//
// Edges: the linear index n +- s must lie in [0, P*P) (the TPU kernel's
// zero halo above and below the image) and the column must not wrap: for
// the forward, x's column col + dc in [0, P) (`_col_masks`, :98); for the
// transposed form, dz's own column col - dc in [0, P) (the masked `dzp_l`
// and `dzp_r` buffers, :265-280). Without the column test a tap would read
// the neighbouring row's pixel, never memory outside the tensor.
//
// The tile: 256 threads, warp w holds rows 4w..4w+3 and lane l the columns
// l + 32 j (j < 4), 16 fp32 accumulators a thread. A chunk of kBK = 16
// columns of A lies inside one tap because C % 16 == 0, so a thread finds
// its pixel's source once per chunk. Both operands go through shared
// memory as fp32; no double buffering, no tensor cores (a later PR's work).
#pragma once

#include "common.cuh"

namespace pidm {
namespace conv {

constexpr int kThreads = 256;
constexpr int kBM = 32, kBN = 128, kBK = 16, kTM = 4, kTN = 4;

template <typename T, bool kTransposed>
__device__ __forceinline__ void conv_tile(float (&acc)[kTM][kTN], const T* __restrict__ a,
                                          int M, int m0, const T* __restrict__ src, int C,
                                          int P, int n0) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN + 1];
  const int N = P * P, K = 9 * C;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  // the pixel of this thread's B column, and its image column
  const int bn = tid % kBN;
  const int n = n0 + bn;
  const int col = n % P;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A: consecutive threads along k, contiguous in a row of A
    for (int e = tid; e < kBK * kBM; e += kThreads) {
      const int kk = e % kBK, m = e / kBK;
      As[kk][m] = m0 + m < M ? to_f32(a[(long long)(m0 + m) * K + k0 + kk]) : 0.f;
    }
    // B: the chunk's 16 rows of im2col are channels c0..c0+15 of one tap
    const int t = k0 / C, c0 = k0 - t * C;
    const int dr = t / 3 - 1, dc = t % 3 - 1;
    int idx;
    bool ok;
    if (kTransposed) {  // dx: dz at pixel n - s, masked at its own column zc
      const int zc = col - dc;
      idx = n - dr * P - dc;
      ok = idx >= 0 && idx < N && zc >= 0 && zc < P;
    } else {  // z: x at pixel n + s; the column masks of dc = -1 and dc = +1
      const int xc = col + dc;
      idx = n + dr * P + dc;
      ok = idx >= 0 && idx < N && xc >= 0 && xc < P;
    }
    ok = ok && n < N;
    const T* s = src + (long long)c0 * N + idx;
    for (int kk = tid / kBN; kk < kBK; kk += kThreads / kBN)
      Bs[kk][bn] = ok ? to_f32(s[(long long)kk * N]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = As[kk][w * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = Bs[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace conv
}  // namespace pidm
