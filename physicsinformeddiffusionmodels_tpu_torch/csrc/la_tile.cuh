// The building blocks of K1 and K3 (linear_attention.cu, linear_attention_bwd.cu):
// a warp's 32 x 32 fp32 product tile on operands in shared memory, the
// staging of token tiles and weight slices into shared memory, and the
// per-token LayerNorm statistics.
//
// Every product of the two kernels is C[M, N] += A[M, K] B[K, N] with M and
// N cut into 32 x 32 warp tiles and both operands fp32 in shared memory. Two
// routes compute it, chosen at compile time by the caller's x type:
//   - fp32 x (kTc false): FFMA in full fp32, each lane a 4 x 8 register
//     block, operands read as 16-byte vectors. No tensor-core instruction.
//   - bf16 x (kTc true): the tensor cores, mma.sync m16n8k16 in bf16 with
//     fp32 accumulation. Each operand is rounded to bf16 (round to nearest
//     even) as its fragment is loaded, as the TPU kernel's `_mm` rounds the
//     operands of its products (pallas_attention.py:104-115); or, for an
//     operand the kernels' bf16 forward does not round (a gradient, or M:
//     linear_attention.cu), split into a bf16 pair hi + lo (about 16 bits)
//     and multiplied twice (kSplit).
// A is stored [K][M] ("k-major", kAK) or [M][K]; B [K][N] (kBK) or [N][K].
// Leading dimensions: a multiple of 4 floats; 8 (mod 32) for a k-major
// operand and 4 (mod 32) for the other layout keep the FFMA loads free of
// bank conflicts. K is a multiple of 16.
//
// Lane l holds acc[i][j] at row row<>(l, i), i < 4, and column col<>(l, j),
// j < 8. In both routes the four lanes that share a row differ only in the
// low two bits of the lane (so a row reduction is two xor shuffles).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace pidm {
namespace la {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;   // tokens per tile
constexpr int kKC = 32;  // channels per slice of C

template <bool kTc, bool kAK>
__device__ __forceinline__ int row(int lane, int i) {
  if constexpr (kTc) return (i >> 1) * 16 + (i & 1) * 8 + (lane >> 2);
  else if constexpr (kAK) return (lane >> 2) * 4 + i;
  else return (lane >> 2) + 8 * i;
}

template <bool kTc, bool kBK>
__device__ __forceinline__ int col(int lane, int j) {
  if constexpr (kTc) return (j >> 1) * 8 + 2 * (lane & 3) + (j & 1);
  else if constexpr (kBK) return (lane & 3) * 4 + (j & 3) + (j >> 2) * 16;
  else return (lane & 3) + 4 * j;
}

// Which operand of a bf16 product keeps about 16 bits (a bf16 pair) rather
// than being rounded to bf16.
enum Split { kRoundBoth = 0, kSplitA = 1, kSplitB = 2 };

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 pair register of (v.x, v.y): v.x in the low half, as mma.sync
// wants the element of the lower k.
__device__ __forceinline__ uint32_t bf16x2(float2 v) {
  return bits(__floats2bfloat162_rn(v.x, v.y));
}

// v = hi + lo: hi the bf16 rounding of v, lo that of the rest.
__device__ __forceinline__ void bf16x2_split(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v.x - f.x, v.y - f.y));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// (A[m][k], A[m][k + 1]), k even: one 8-byte load where the two are adjacent.
template <bool kAK>
__device__ __forceinline__ float2 pair_a(const float* A, int lda, int m, int k) {
  if constexpr (kAK) return make_float2(A[k * lda + m], A[(k + 1) * lda + m]);
  else return *reinterpret_cast<const float2*>(A + m * lda + k);
}

// (B[k][n], B[k + 1][n]), k even.
template <bool kBK>
__device__ __forceinline__ float2 pair_b(const float* B, int ldb, int k, int n) {
  if constexpr (kBK) return make_float2(B[k * ldb + n], B[(k + 1) * ldb + n]);
  else return *reinterpret_cast<const float2*>(B + n * ldb + k);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[q] += A[0:32, 0:K] B[0:K, 32q : 32q + 32] for q < NT: one warp, A
// and B pointing at the tile's origin. Sums over k in increasing order (on
// the bf16 route, the hi part of a split operand before its lo part).
template <bool kTc, bool kAK, bool kBK, int NT, Split kSplit = kRoundBoth>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4][8], const float* __restrict__ A,
                                          int lda, const float* __restrict__ B, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  if constexpr (kTc) {
    const int g = lane >> 2, q2 = 2 * (lane & 3);
    for (int k = 0; k < K; k += 16) {
      uint32_t a[2][4], al[2][4];  // rows g, g + 8 at k 2q, 2q + 8 (+1 in the high half)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = mt * 16 + g;
        const float2 v[4] = {pair_a<kAK>(A, lda, r, k + q2), pair_a<kAK>(A, lda, r + 8, k + q2),
                             pair_a<kAK>(A, lda, r, k + q2 + 8),
                             pair_a<kAK>(A, lda, r + 8, k + q2 + 8)};
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if constexpr (kSplit == kSplitA) bf16x2_split(v[f], a[mt][f], al[mt][f]);
          else a[mt][f] = bf16x2(v[f]);
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float* Bt = kBK ? B + 32 * t : B + 32 * t * ldb;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = nt * 8 + g;
          const float2 v0 = pair_b<kBK>(Bt, ldb, k + q2, n);
          const float2 v1 = pair_b<kBK>(Bt, ldb, k + q2 + 8, n);
          uint32_t b0, b1, bl0 = 0, bl1 = 0;
          if constexpr (kSplit == kSplitB) {
            bf16x2_split(v0, b0, bl0);
            bf16x2_split(v1, b1, bl1);
          } else {
            b0 = bf16x2(v0), b1 = bf16x2(v1);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float c[4] = {acc[t][2 * mt][2 * nt], acc[t][2 * mt][2 * nt + 1],
                          acc[t][2 * mt + 1][2 * nt], acc[t][2 * mt + 1][2 * nt + 1]};
            mma_bf16(c, a[mt], b0, b1);
            if constexpr (kSplit == kSplitA) mma_bf16(c, al[mt], b0, b1);
            if constexpr (kSplit == kSplitB) mma_bf16(c, a[mt], bl0, bl1);
            acc[t][2 * mt][2 * nt] = c[0], acc[t][2 * mt][2 * nt + 1] = c[1];
            acc[t][2 * mt + 1][2 * nt] = c[2], acc[t][2 * mt + 1][2 * nt + 1] = c[3];
          }
        }
      }
    }
  } else {
    const int ly = lane >> 2, lx = lane & 3;
    for (int k = 0; k < K; k += 4) {
      float a[4][4];  // [row slot][k]
      if constexpr (kAK) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = *reinterpret_cast<const float4*>(A + (k + kk) * lda + ly * 4);
          a[0][kk] = v.x, a[1][kk] = v.y, a[2][kk] = v.z, a[3][kk] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(A + (ly + 8 * i) * lda + k);
          a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float b[8][4];  // [column slot][k]
        if constexpr (kBK) {
          const float* Bt = B + 32 * t;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 v0 = *reinterpret_cast<const float4*>(Bt + (k + kk) * ldb + lx * 4);
            const float4 v1 = *reinterpret_cast<const float4*>(Bt + (k + kk) * ldb + 16 + lx * 4);
            b[0][kk] = v0.x, b[1][kk] = v0.y, b[2][kk] = v0.z, b[3][kk] = v0.w;
            b[4][kk] = v1.x, b[5][kk] = v1.y, b[6][kk] = v1.z, b[7][kk] = v1.w;
          }
        } else {
          const float* Bt = B + 32 * t * ldb;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(Bt + (lx + 4 * j) * ldb + k);
            b[j][0] = v.x, b[j][1] = v.y, b[j][2] = v.z, b[j][3] = v.w;
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[t][i][j] = fmaf(a[i][kk], b[j][kk], acc[t][i][j]);
      }
    }
  }
}

template <bool kTc, bool kAK, bool kBK, Split kSplit = kRoundBoth>
__device__ __forceinline__ void warp_gemm(float (&acc)[4][8], const float* __restrict__ A,
                                          int lda, const float* __restrict__ B, int ldb, int K) {
  warp_gemm<kTc, kAK, kBK, 1, kSplit>(reinterpret_cast<float(&)[1][4][8]>(acc), A, lda, B, ldb,
                                      K);
}

template <int NT, int I, int J>
__device__ __forceinline__ void zero(float (&acc)[NT][I][J]) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[t][i][j] = 0.f;
}

__device__ __forceinline__ void zero(float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// Sum and max over a row of the warp tile: the lane's 8 columns, then the
// 3 other lanes of the row.
__device__ __forceinline__ float row_sum(const float (&v)[8]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += v[j];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

__device__ __forceinline__ float row_max(const float (&v)[8]) {
  float m = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) m = fmaxf(m, v[j]);
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}

// In place: each row of the warp tile softmaxed over its 32 columns.
__device__ __forceinline__ void row_softmax(float (&v)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float m = row_max(v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = expf(v[i][j] - m);
    const float s = row_sum(v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = v[i][j] / s;
  }
}

// dst[r][j] = src[r * src_ld + j] for r < R, j < J, as fp32; zero where
// r >= r_valid or j >= j_valid. A thread issues up to 8 loads before it
// stores them, so that they are in flight together (GPU threads issue in
// order: a store waiting on its load holds back the next load).
template <int R, int J, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* __restrict__ src,
                                      long long src_ld, int r_valid, int j_valid) {
  constexpr int kPer = R * J / kThreads, kBatch = kPer < 8 ? kPer : 8;
  static_assert(R * J % kThreads == 0 && kPer % kBatch == 0, "stage shape");
#pragma unroll
  for (int k0 = 0; k0 < kPer; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = threadIdx.x + (k0 + k) * kThreads, r = i / J, j = i % J;
      v[k] = r < r_valid && j < j_valid ? to_f32(src[r * src_ld + j]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = threadIdx.x + (k0 + k) * kThreads;
      dst[i / J * ld + i % J] = v[k];
    }
  }
}

// The same for an fp32 source, through cp.async: every copy of the thread
// in flight at once and none held in registers (16 bytes a copy where the
// source rows allow it, else 4), zero-filled outside the valid block. The
// copies have landed when it returns; the caller syncs the block.
template <int R, int J>
__device__ __forceinline__ void stage(float* dst, int ld, const float* __restrict__ src,
                                      long long src_ld, int r_valid, int j_valid) {
  static_assert(J % 4 == 0 && R * J % (4 * kThreads) == 0, "stage shape");
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && src_ld % 4 == 0) {
#pragma unroll
    for (int k = 0; k < R * J / (4 * kThreads); ++k) {
      const int i = threadIdx.x + k * kThreads, r = i / (J / 4), j = i % (J / 4) * 4;
      const int n = r < r_valid ? min(4, max(0, j_valid - j)) : 0;
      const float* from = n > 0 ? src + r * src_ld + j : src;
      const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ld + j));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(to), "l"(from), "r"(4 * n));
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < R * J / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads, r = i / J, j = i % J;
      const bool ok = r < r_valid && j < j_valid;
      const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ld + j));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(to), "l"(ok ? src + r * src_ld + j : src), "r"(ok ? 4 : 0));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tokens t = warp + 8 k (k < 4) of a tile that one warp handles.
constexpr int kRowsPerWarp = kT / kWarps;

// mr[2t], mr[2t + 1] = the mean and 1/std of token n0 + t over its C
// channels (one warp per token, a warp's 4 tokens at once), for the
// LayerNorm of K1; 0 and 1 in K3's mode (no LayerNorm) and for the tile's
// rows past N.
template <typename T>
__device__ __forceinline__ void row_stats(float* mr, const T* __restrict__ xb, int n0, int rows,
                                          int C, float eps, bool block) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float mu[kRowsPerWarp], rstd[kRowsPerWarp];
  bool on[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    on[k] = block && w + kWarps * k < rows;
    mu[k] = 0.f, rstd[k] = 0.f;
  }
  const T* xr = xb + (long long)(n0 + w) * C;
  const long long step = (long long)kWarps * C;
  for (int c = lane; c < C; c += 32) {
    float v[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) v[k] = on[k] ? to_f32(xr[k * step + c]) : 0.f;
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) mu[k] += v[k];
  }
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) mu[k] = warp_sum(mu[k]) / C;
  for (int c = lane; c < C; c += 32) {
    float v[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) v[k] = on[k] ? to_f32(xr[k * step + c]) : 0.f;
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const float d = v[k] - mu[k];
      rstd[k] = fmaf(d, d, rstd[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const float r = rsqrtf(warp_sum(rstd[k]) / C + eps);
    if (lane == 0) {
      mr[2 * (w + kWarps * k)] = on[k] ? mu[k] : 0.f;
      mr[2 * (w + kWarps * k) + 1] = on[k] ? r : 1.f;
    }
  }
}

// dst[t][c] = the LayerNorm'd token n0 + t at channel c0 + c (x itself in
// K3's mode: mr = (0, 1), no gamma), for t < kT, c < kKC; zero past N or C.
template <typename T>
__device__ __forceinline__ void stage_xln(float* dst, int ld, const T* __restrict__ xb,
                                          const float* mr, const float* __restrict__ gamma,
                                          int n0, int rows, int c0, int C) {
  constexpr int kPer = kT * kKC / kThreads;
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads, t = i / kKC, cc = c0 + i % kKC;
    v[k] = t < rows && cc < C ? to_f32(xb[(long long)(n0 + t) * C + cc]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads, t = i / kKC, c = i % kKC, cc = c0 + c;
    float y = 0.f;
    if (t < rows && cc < C) {
      y = (v[k] - mr[2 * t]) * mr[2 * t + 1];
      if (gamma != nullptr) y *= gamma[cc];
    }
    dst[t * ld + c] = y;
  }
}

// For C <= kKC: the whole tile's x-ln (x itself in K3's mode) staged into
// dst[t][c] in one pass over x, with mr as row_stats writes it. The mean
// and variance are summed in row_stats' order, so the results are the same.
template <typename T>
__device__ __forceinline__ void stage_ln_tile(float* dst, int ld, const T* __restrict__ xb,
                                              float* mr, const float* __restrict__ gamma,
                                              int n0, int rows, int C, float eps, bool block) {
  stage<kT, kKC>(dst, ld, xb + (long long)n0 * C, C, rows, C);  // zero past N and C
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < kT; t += kWarps) {
    const float v = dst[t * ld + lane];
    float mu = 0.f, rstd = 1.f;
    if (block && t < rows) {
      mu = warp_sum(v) / C;
      const float d = lane < C ? v - mu : 0.f;
      rstd = rsqrtf(warp_sum(fmaf(d, d, 0.f)) / C + eps);
    }
    if (t < rows && lane < C) {
      float y = (v - mu) * rstd;
      if (gamma != nullptr) y *= gamma[lane];
      dst[t * ld + lane] = y;
    }
    if (lane == 0) mr[2 * t] = mu, mr[2 * t + 1] = rstd;
  }
  __syncthreads();
}

// How the token tiles of a row are shared among blocks: `ranges` blocks a
// row, block r taking tiles [r * tiles / ranges, (r + 1) * tiles / ranges).
// About one block an SM in all (132 SMs, one resident block each): a single
// wave, which also keeps the backward's partial sums few.
struct Ranges {
  int tiles, ranges;
  __host__ __device__ int begin(int r) const { return r * tiles / ranges; }
};

inline Ranges make_ranges(int B, int N) {
  Ranges p;
  p.tiles = (N + kT - 1) / kT;
  const int want = (132 + B / 2) / B;
  p.ranges = want < 1 ? 1 : (want > p.tiles ? p.tiles : want);
  return p;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace la
}  // namespace pidm
