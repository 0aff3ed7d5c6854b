// K2 backward: the VJP of GroupNorm -> FiLM -> SiLU (group_norm.cu) on a
// [B, N, C] fp32 or bf16 activation: dx, dgamma, dbeta and, with FiLM,
// dscale and dshift from dy. With bf16 x (the `bf16` flag), dy is bf16 and
// dx is written as bf16, rounded once; every read of x and dy goes through
// pidm::to_f32, and the sums and parameter gradients stay fp32.
//
// Replaces the backward of physicsinformeddiffusionmodels_tpu/ops/
// pallas_kernels.py's `_gn_film_silu_pallas`, `_gn_bwd`, which the JAX
// package leaves to XLA (it has no Pallas body). Its formula, with
// x-hat = (x - mean) * rstd, pre = x-hat gamma + beta, z = pre (scale + 1)
// + shift:
//   dz = dy sig(z) (1 + z (1 - sig(z)));
//   dshift = sum_n dz;  dscale = sum_n dz pre;  (per batch row and channel)
//   dgamma = sum_{b,n} dz (scale + 1) x-hat;  dbeta = sum_{b,n} dz (scale + 1);
//   dx-hat = dz (scale + 1) gamma;  t1, t2 = sum over (n, c in g) of dx-hat
//   and dx-hat x-hat;  dx = rstd (dx-hat - (t1 + x-hat t2) / (N C/G)).
// Every sum over the tokens reduces to two per-(row, channel) sums,
// S0 = sum_n dz and S1 = sum_n dz x-hat: dshift = S0, dscale = gamma S1 +
// beta S0, dgamma and dbeta sum (scale + 1) S1 and (scale + 1) S0 over the
// rows, and t1, t2 sum gamma (scale + 1) S0 and S1 over a group's channels.
//
// Bound on the H100: memory. About 25 flops per element against 12 bytes
// (x and dy read, dx written, fp32; 6 in bf16). Like the forward, a row does not fit a
// block, so this takes four launches, each summing in a fixed order with no
// atomics (the results repeat exactly):
//   1. gn_bwd_partial, grid (token splits, channel chunks of 256, B): S0 and
//      S1 of one split into a [B, splits, C, 2] scratch. The group mean and
//      rstd are folded from the forward's own statistics partials (saved by
//      the autograd Function), exactly as gn_apply folds them.
//   2. gn_bwd_fold, grid B: the splits in order -> S0, S1 per (row,
//      channel); dshift and dscale.
//   3. gn_bwd_params: dgamma and dbeta, the rows in order.
//   4. gn_bwd_apply, grid (tiles, B): t1, t2 per group in shared memory,
//      then dx elementwise (x and dy read a second time, mostly from L2).
// Any N and any C divisible by G (C <= 4096) are handled.

#include <math.h>

#include "common.cuh"

namespace {

using pidm::from_f32;
using pidm::to_f32;

constexpr int kThreads = 256;
constexpr int kItems = 8;        // elements per thread in the apply pass
constexpr int kSplitIters = 16;  // tokens each thread visits in the partial pass

struct Plan {
  int s2, rows_per_split;
  long long part, sums, total;
};

Plan make_plan(int B, int N, int C) {
  Plan w;
  const int ct = C < kThreads ? C : kThreads;
  w.rows_per_split = (kThreads / ct) * kSplitIters;
  w.s2 = (N + w.rows_per_split - 1) / w.rows_per_split;
  w.part = 0;
  w.sums = (long long)B * w.s2 * C * 2;
  w.total = w.sums + (long long)B * C * 2;
  return w;
}

// Mean and rstd of group g of row b, from the forward's [B, G, S, 2]
// partials of shifted sums (shift: the group's first value), as gn_apply.
template <typename T>
__device__ inline void group_stats(const T* __restrict__ xb,
                                   const float* __restrict__ fwd_part, int b, int g, int G,
                                   int S, int cg, float cnt, float eps, float* mean,
                                   float* rstd) {
  const float* p = fwd_part + ((long long)b * G + g) * S * 2;
  float s1 = 0.f, s2 = 0.f;
  for (int s = 0; s < S; ++s) {
    s1 += p[2 * s];
    s2 += p[2 * s + 1];
  }
  const float m1 = s1 / cnt;
  *rstd = rsqrtf(fmaxf(s2 / cnt - m1 * m1, 0.f) + eps);
  *mean = to_f32(xb[g * cg]) + m1;
}

// d silu(z) / dz
__device__ inline float silu_grad(float z) {
  const float sig = 1.f / (1.f + expf(-z));
  return sig * (1.f + z * (1.f - sig));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const float* __restrict__ fwd_part, float* __restrict__ part, int N,
                      int C, int G, int S, int rows_per_split, float eps) {
  __shared__ float coef[6][kThreads];  // mean, rstd, gamma, beta, scale + 1, shift
  __shared__ float red[2][kThreads];
  const int s = blockIdx.x, c0 = blockIdx.y * kThreads, b = blockIdx.z, tid = threadIdx.x;
  const int ct = min(kThreads, C - c0);  // channels of this chunk
  const int R = kThreads / ct;           // tokens visited side by side
  const int cg = C / G;
  const long long row = (long long)b * N * C;
  if (tid < ct) {
    const int c = c0 + tid;
    group_stats(x + row, fwd_part, b, c / cg, G, S, cg, (float)N * (float)cg, eps,
                &coef[0][tid], &coef[1][tid]);
    coef[2][tid] = gamma[c];
    coef[3][tid] = beta[c];
    coef[4][tid] = scale ? scale[(long long)b * C + c] + 1.f : 1.f;
    coef[5][tid] = shift ? shift[(long long)b * C + c] : 0.f;
  }
  __syncthreads();
  const int r = tid / ct, ci = tid % ct;
  float a0 = 0.f, a1 = 0.f;
  if (r < R) {
    const int n_end = min(N, (s + 1) * rows_per_split);
    for (int n = s * rows_per_split + r; n < n_end; n += R) {
      const long long i = row + (long long)n * C + c0 + ci;
      const float xhat = (to_f32(x[i]) - coef[0][ci]) * coef[1][ci];
      const float z = fmaf(fmaf(xhat, coef[2][ci], coef[3][ci]), coef[4][ci], coef[5][ci]);
      const float dz = to_f32(dy[i]) * silu_grad(z);
      a0 += dz;
      a1 = fmaf(dz, xhat, a1);
    }
  }
  red[0][tid] = a0;
  red[1][tid] = a1;
  __syncthreads();
  if (tid < ct) {
    float s0 = 0.f, s1 = 0.f;
    for (int q = 0; q < R; ++q) {
      s0 += red[0][q * ct + tid];
      s1 += red[1][q * ct + tid];
    }
    float* p = part + (((long long)b * gridDim.x + s) * C + c0 + tid) * 2;
    p[0] = s0;
    p[1] = s1;
  }
}

__global__ void __launch_bounds__(kThreads)
gn_bwd_fold_kernel(const float* __restrict__ part, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ sums,
                   float* __restrict__ dscale, float* __restrict__ dshift, int C, int S2) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float* p = part + ((long long)b * S2 * C + c) * 2;
    float s0 = 0.f, s1 = 0.f;
    for (int s = 0; s < S2; ++s) {
      s0 += p[(long long)s * C * 2];
      s1 += p[(long long)s * C * 2 + 1];
    }
    sums[((long long)b * C + c) * 2] = s0;
    sums[((long long)b * C + c) * 2 + 1] = s1;
    if (dshift != nullptr) {
      dshift[(long long)b * C + c] = s0;
      dscale[(long long)b * C + c] = fmaf(gamma[c], s1, beta[c] * s0);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gn_bwd_params_kernel(const float* __restrict__ sums, const float* __restrict__ scale,
                     float* __restrict__ dgamma, float* __restrict__ dbeta, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float dg = 0.f, db = 0.f;
  for (int b = 0; b < B; ++b) {
    const float sc1 = scale ? scale[(long long)b * C + c] + 1.f : 1.f;
    const float* sm = sums + ((long long)b * C + c) * 2;
    db = fmaf(sc1, sm[0], db);
    dg = fmaf(sc1, sm[1], dg);
  }
  dgamma[c] = dg;
  dbeta[c] = db;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    const float* __restrict__ fwd_part, const float* __restrict__ sums,
                    T* __restrict__ dx, int N, int C, int G, int S, float eps) {
  extern __shared__ float sm[];
  float* mean = sm;          // [C] each
  float* rstd = mean + C;
  float* gam = rstd + C;
  float* bet = gam + C;
  float* sc = bet + C;       // scale + 1
  float* sh = sc + C;
  float* u1 = sh + C;        // gamma (scale + 1) S0
  float* u2 = u1 + C;        // gamma (scale + 1) S1
  float* t1 = u2 + C;        // [G] each
  float* t2 = t1 + G;
  const int b = blockIdx.y, cg = C / G, tid = threadIdx.x;
  const long long row = (long long)b * N * C;
  const float cnt = (float)N * (float)cg;
  for (int c = tid; c < C; c += blockDim.x) {
    group_stats(x + row, fwd_part, b, c / cg, G, S, cg, cnt, eps, &mean[c], &rstd[c]);
    const float sc1 = scale ? scale[(long long)b * C + c] + 1.f : 1.f;
    const float* s = sums + ((long long)b * C + c) * 2;
    gam[c] = gamma[c];
    bet[c] = beta[c];
    sc[c] = sc1;
    sh[c] = shift ? shift[(long long)b * C + c] : 0.f;
    u1[c] = gamma[c] * sc1 * s[0];
    u2[c] = gamma[c] * sc1 * s[1];
  }
  __syncthreads();
  for (int g = tid; g < G; g += blockDim.x) {
    float a = 0.f, a2 = 0.f;
    for (int q = 0; q < cg; ++q) {
      a += u1[g * cg + q];
      a2 += u2[g * cg + q];
    }
    t1[g] = a;
    t2[g] = a2;
  }
  __syncthreads();
  const int total = N * C;
  const int base = blockIdx.x * (blockDim.x * kItems);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * blockDim.x + tid;
    if (i < total) {
      const int c = i % C, g = c / cg;
      const float xhat = (to_f32(x[row + i]) - mean[c]) * rstd[c];
      const float z = fmaf(fmaf(xhat, gam[c], bet[c]), sc[c], sh[c]);
      const float dxhat = to_f32(dy[row + i]) * silu_grad(z) * sc[c] * gam[c];
      dx[row + i] = from_f32<T>(rstd[c] * (dxhat - (t1[g] + xhat * t2[g]) / cnt));
    }
  }
}

template <typename T>
int backward(const void* x, const void* dy, const void* gamma, const void* beta,
             const void* scale, const void* shift, const void* fwd_part, void* dx, void* dgamma,
             void* dbeta, void* dscale, void* dshift, void* work, int B, int N, int C, int G,
             int S, float eps, cudaStream_t st) {
  const Plan w = make_plan(B, N, C);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* fp = static_cast<const float*>(fwd_part);
  float* ws = static_cast<float*>(work);
  cudaError_t err;

  gn_bwd_partial_kernel<T><<<dim3(w.s2, (C + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(
      xt, dyt, g, be, sc, sh, fp, ws + w.part, N, C, G, S, w.rows_per_split, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gn_bwd_fold_kernel<<<B, kThreads, 0, st>>>(ws + w.part, g, be, ws + w.sums,
                                             static_cast<float*>(dscale),
                                             static_cast<float*>(dshift), C, w.s2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gn_bwd_params_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ws + w.sums, sc, static_cast<float*>(dgamma), static_cast<float*>(dbeta), B, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = (8 * C + 2 * G) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gn_bwd_apply_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_block = kThreads * kItems;
  gn_bwd_apply_kernel<T><<<dim3((N * C + per_block - 1) / per_block, B), kThreads, smem, st>>>(
      xt, dyt, g, be, sc, sh, fp, ws + w.sums, static_cast<T*>(dx), N, C, G, S, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of workspace that pidm_gn_film_silu_bwd needs.
extern "C" long long pidm_gn_film_silu_bwd_workspace(int B, int N, int C) {
  return make_plan(B, N, C).total;
}

// x, dy, dx: [B, N, C] fp32 (bf16 when `bf16` is 1); gamma, beta, dgamma,
// dbeta: [C] fp32; scale, shift, dscale, dshift: [B, C] fp32, or all four
// null for no FiLM; fwd_part: the forward's [B, G, S, 2] statistics
// partials; work: the workspace above. Launches on `stream`, allocates
// nothing, returns the CUDA error.
extern "C" int pidm_gn_film_silu_bwd(const void* x, const void* dy, const void* gamma,
                                     const void* beta, const void* scale, const void* shift,
                                     const void* fwd_part, void* dx, void* dgamma, void* dbeta,
                                     void* dscale, void* dshift, void* work, int B, int N,
                                     int C, int G, int S, float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return backward<__nv_bfloat16>(x, dy, gamma, beta, scale, shift, fwd_part, dx, dgamma,
                                   dbeta, dscale, dshift, work, B, N, C, G, S, eps, st);
  return backward<float>(x, dy, gamma, beta, scale, shift, fwd_part, dx, dgamma, dbeta, dscale,
                         dshift, work, B, N, C, G, S, eps, st);
}
