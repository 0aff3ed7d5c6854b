// K4 backward: the VJP of the channel-major Block (conv_block.cu) from dy
// [B, Co, P*P]: dx [B, Ci, P*P] (x's type), dW [Co, 9 Ci], dbias, dgamma,
// dbeta [Co], dscale, dshift [B, Co] (fp32; the wrapper rounds dW to the
// weight's type, bf16 under bf16 compute, as the TPU kernel's VJP does).
//
// Replaces physicsinformeddiffusionmodels_tpu/ops/pallas_conv.py
// `_bwd_kernel` (launched by `_bwd_call` through pl.pallas_call, :385),
// phase by phase, with x-hat = (z - mean) rstd, u = x-hat gamma + beta,
// y = u (scale + 1) + shift:
//   A. the TPU kernel replays conv -> z -> statistics; here the forward's
//      fp32 z and its (mean, rstd) are saved and read instead.
//   B. dy_pre = dy sig(y) (1 + y (1 - sig(y))); per (row, channel) the two
//      sums S0 = sum_n dy_pre and S1 = sum_n dy_pre x-hat give every
//      parameter sum: dshift = S0, dscale = gamma S1 + beta S0, and over
//      the rows dbeta = sum (scale + 1) S0, dgamma = sum (scale + 1) S1;
//      per group t1 = sum_c gamma (scale + 1) S0, t2 = the same of S1.
//   C1. dz = rstd (dx-hat - (t1 + x-hat t2) / (N Co/G)), dx-hat = dy_pre
//      (scale + 1) gamma; dbias = sum dz (fp32); dz is stored in x's type
//      (the TPU kernel's `dzm = dz.astype(md)`) for the two products:
//      dW[co, t Ci + ci] = sum over rows and pixels of dz[co, n]
//      im2col(x)[t Ci + ci, n] (K = B P^2, split into fixed chunks whose
//      partials are summed in order, no atomics); and
//   C2. dx[ci, m] = sum_t sum_co W[co, t, ci] dz[co, m - s_t], the
//      forward-form transposed conv over the weights `wdx` [Ci, 9 Co]
//      (wdx[ci, t Co + co] = wflat[co, t Ci + ci], made by the wrapper as
//      the TPU kernel's `_cb_bwd` makes it), with dz masked at its own
//      column: conv_tile.cuh's transposed mode, the forward's tile code.
//
// Bound on the H100: fp32 x, operations (dW and dx each do the forward's
// flops); bf16 x, bytes (at the bf16 tensor-core rate).
//
// Launches: (1) conv_bwd_dz, grid (G, B): a block holds one (row, group)
// and reads z and dy twice, the second time mostly from L2; (2)
// conv_bwd_params: dgamma, dbeta, dbias, the rows in order; (3) conv_dw,
// grid (9 Ci / 128, Co / 32, chunks): the dW partials; (4) conv_dw_reduce,
// their sum in chunk order; (5) conv_dx, grid (pixel tiles, Ci / 32, B).
// Every sum runs in one fixed order, so the result repeats exactly.

#include "conv_tile.cuh"

namespace {

using pidm::from_f32;
using pidm::to_f32;
using namespace pidm::conv;

constexpr int kMaxCg = 64;         // channels a group (Co / G) the dz kernel takes
constexpr int kDwChunk = 1024;     // pixels of one row per dW partial
constexpr int kDwCols = kBN / 16;  // columns of dW a thread loads (8)

struct Plan {
  int chunks_per_row, splits;
  long long sums, dw_part, total;  // float offsets in the workspace
};

Plan make_plan(int B, int N, int Ci, int Co) {
  Plan p;
  p.chunks_per_row = (N + kDwChunk - 1) / kDwChunk;
  p.splits = B * p.chunks_per_row;
  p.sums = 0;
  p.dw_part = (long long)B * Co * 3;
  p.total = p.dw_part + (long long)p.splits * Co * 9 * Ci;
  return p;
}

// d silu(y) / dy
__device__ inline float silu_grad(float y) {
  const float sig = 1.f / (1.f + expf(-y));
  return sig * (1.f + y * (1.f - sig));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bwd_dz_kernel(const float* __restrict__ z, const T* __restrict__ dy,
                   const float* __restrict__ stats, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ scale,
                   const float* __restrict__ shift, T* __restrict__ dz,
                   float* __restrict__ sums, float* __restrict__ dscale,
                   float* __restrict__ dshift, int Co, int G, int N) {
  __shared__ float s01[2][kMaxCg];
  __shared__ float red[kThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y, cg = Co / G;
  const float mean = stats[2 * (b * G + g)], rstd = stats[2 * (b * G + g) + 1];
  // B: S0, S1 of each channel of the group
  for (int q = 0; q < cg; ++q) {
    const int c = g * cg + q;
    const long long row = ((long long)b * Co + c) * N;
    const float ga = gamma[c], be = beta[c];
    const float sc1 = scale[b * Co + c] + 1.f, sh = shift[b * Co + c];
    float a0 = 0.f, a1 = 0.f;
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const float xhat = (z[row + n] - mean) * rstd;
      const float y = fmaf(fmaf(xhat, ga, be), sc1, sh);
      const float d = to_f32(dy[row + n]) * silu_grad(y);
      a0 += d;
      a1 = fmaf(d, xhat, a1);
    }
    a0 = pidm::block_sum(a0, red);
    a1 = pidm::block_sum(a1, red);
    if (threadIdx.x == 0) {
      s01[0][q] = a0;
      s01[1][q] = a1;
      dshift[b * Co + c] = a0;
      dscale[b * Co + c] = fmaf(ga, a1, be * a0);
      sums[((long long)b * Co + c) * 3] = a0;
      sums[((long long)b * Co + c) * 3 + 1] = a1;
    }
  }
  __syncthreads();
  float t1 = 0.f, t2 = 0.f;
  for (int q = 0; q < cg; ++q) {  // the same order in every thread
    const int c = g * cg + q;
    const float u = gamma[c] * (scale[b * Co + c] + 1.f);
    t1 = fmaf(u, s01[0][q], t1);
    t2 = fmaf(u, s01[1][q], t2);
  }
  const float inv_cnt = 1.f / ((float)N * (float)cg);
  // C1: dz, and dbias's sum of the row
  for (int q = 0; q < cg; ++q) {
    const int c = g * cg + q;
    const long long row = ((long long)b * Co + c) * N;
    const float ga = gamma[c], be = beta[c];
    const float sc1 = scale[b * Co + c] + 1.f, sh = shift[b * Co + c];
    float db = 0.f;
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const float xhat = (z[row + n] - mean) * rstd;
      const float y = fmaf(fmaf(xhat, ga, be), sc1, sh);
      const float dxhat = to_f32(dy[row + n]) * silu_grad(y) * sc1 * ga;
      const float d = rstd * (dxhat - (t1 + xhat * t2) * inv_cnt);
      dz[row + n] = from_f32<T>(d);
      db += d;
    }
    db = pidm::block_sum(db, red);
    if (threadIdx.x == 0) sums[((long long)b * Co + c) * 3 + 2] = db;
  }
}

__global__ void conv_bwd_params_kernel(const float* __restrict__ sums,
                                       const float* __restrict__ scale,
                                       float* __restrict__ dgamma, float* __restrict__ dbeta,
                                       float* __restrict__ dbias, int B, int Co) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Co) return;
  float dg = 0.f, dbe = 0.f, dbi = 0.f;
  for (int b = 0; b < B; ++b) {
    const float sc1 = scale[b * Co + c] + 1.f;
    const float* s = sums + ((long long)b * Co + c) * 3;
    dbe = fmaf(sc1, s[0], dbe);
    dg = fmaf(sc1, s[1], dg);
    dbi += s[2];
  }
  dgamma[c] = dg;
  dbeta[c] = dbe;
  dbias[c] = dbi;
}

// The dW partial of one chunk of one row's pixels: part[split][co][k] =
// sum over the chunk's pixels n of dz[co, n] im2col(x)[k, n], on the tile
// [kBM co, kBN k] of conv_tile.cuh's shape (here K runs over pixels).
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ dz, float* __restrict__ part,
               int Ci, int Co, int P, int chunks_per_row) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN + 1];
  const int N = P * P, K9 = 9 * Ci;
  const int k0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, split = blockIdx.z;
  const int b = split / chunks_per_row;
  const int p0 = (split - b * chunks_per_row) * kDwChunk, p1 = min(N, p0 + kDwChunk);
  const T* xb = x + (long long)b * Ci * N;
  const T* dzb = dz + (long long)b * Co * N;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  // this thread's dW columns (taps and channels) for the B loads: fixed for
  // the whole kernel; its pixel within a chunk is kk = tid % kBK
  const int kk_b = tid % kBK;
  int c_off[kDwCols], shift[kDwCols], dcs[kDwCols];
#pragma unroll
  for (int i = 0; i < kDwCols; ++i) {
    const int k = k0 + tid / kBK + kBK * i;
    const int t = k / Ci, c = k - t * Ci;
    dcs[i] = k < K9 ? t % 3 - 1 : P;  // P: no such column, never valid (xc >= P)
    shift[i] = (t / 3 - 1) * P + (t % 3 - 1);
    c_off[i] = c * N;
  }
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int q0 = p0; q0 < p1; q0 += kBK) {
    for (int e = tid; e < kBK * kBM; e += kThreads) {
      const int kk = e % kBK, m = e / kBK;
      As[kk][m] = (m0 + m < Co && q0 + kk < p1)
                      ? to_f32(dzb[(long long)(m0 + m) * N + q0 + kk]) : 0.f;
    }
    const int q = q0 + kk_b, col = q % P;
#pragma unroll
    for (int i = 0; i < kDwCols; ++i) {
      const int idx = q + shift[i], xc = col + dcs[i];
      const bool ok = q < p1 && idx >= 0 && idx < N && xc >= 0 && xc < P;
      Bs[kk_b][tid / kBK + kBK * i] = ok ? to_f32(xb[c_off[i] + idx]) : 0.f;
    }
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
  float* out = part + (long long)split * Co * K9;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int co = m0 + w * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int k = k0 + lane + 32 * j;
      if (co < Co && k < K9) out[(long long)co * K9 + k] = acc[i][j];
    }
  }
}

__global__ void conv_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                      int splits, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long long)k * count + i];
  dw[i] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dx_kernel(const T* __restrict__ wdx, const T* __restrict__ dz, T* __restrict__ dx, int Ci,
               int Co, int P) {
  const int N = P * P;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, b = blockIdx.z;
  float acc[kTM][kTN];
  conv_tile<T, true>(acc, wdx, Ci, m0, dz + (long long)b * Co * N, Co, P, n0);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int ci = m0 + w * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + lane + 32 * j;
      if (ci < Ci && n < N) dx[((long long)b * Ci + ci) * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int backward(const void* x, const void* wdx, const void* gamma, const void* beta,
             const void* scale, const void* shift, const void* dy, const void* z,
             const void* stats, void* dx, void* dw, void* dbias, void* dgamma, void* dbeta,
             void* dscale, void* dshift, void* dz, void* work, int B, int Ci, int Co, int P,
             int G, cudaStream_t st) {
  const int N = P * P;
  const Plan plan = make_plan(B, N, Ci, Co);
  float* ws = static_cast<float*>(work);
  const float* sc = static_cast<const float*>(scale);
  cudaError_t err;
  conv_bwd_dz_kernel<T><<<dim3(G, B), kThreads, 0, st>>>(
      static_cast<const float*>(z), static_cast<const T*>(dy), static_cast<const float*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), sc,
      static_cast<const float*>(shift), static_cast<T*>(dz), ws + plan.sums,
      static_cast<float*>(dscale), static_cast<float*>(dshift), Co, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  conv_bwd_params_kernel<<<(Co + 127) / 128, 128, 0, st>>>(
      ws + plan.sums, sc, static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<float*>(dbias), B, Co);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  conv_dw_kernel<T><<<dim3((9 * Ci + kBN - 1) / kBN, (Co + kBM - 1) / kBM, plan.splits),
                      kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(dz),
                                         ws + plan.dw_part, Ci, Co, P, plan.chunks_per_row);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int count = Co * 9 * Ci;
  conv_dw_reduce_kernel<<<(count + 255) / 256, 256, 0, st>>>(
      ws + plan.dw_part, static_cast<float*>(dw), plan.splits, count);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  conv_dx_kernel<T><<<dim3((N + kBN - 1) / kBN, (Ci + kBM - 1) / kBM, B), kThreads, 0, st>>>(
      static_cast<const T*>(wdx), static_cast<const T*>(dz), static_cast<T*>(dx), Ci, Co, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of workspace that pidm_conv_gn_film_silu_bwd needs.
extern "C" long long pidm_conv_gn_film_silu_bwd_workspace(int B, int N, int Ci, int Co) {
  return make_plan(B, N, Ci, Co).total;
}

// x: [B, Ci, P*P] and dy: [B, Co, P*P] fp32 (bf16 when `bf16` is 1); wdx:
// [Ci, 9 Co] in x's type; gamma, beta: [Co] fp32;
// scale, shift: [B, Co] fp32; z, stats: the forward's workspace and
// statistics; out: dx [B, Ci, P*P] in x's type, dw [Co, 9 Ci] fp32, dbias,
// dgamma, dbeta [Co] fp32, dscale, dshift [B, Co] fp32; dz: [B, Co, P*P]
// scratch in x's type; work: the workspace above. Co / G <= 64. Launches on
// `stream`, allocates nothing, returns the CUDA error.
extern "C" int pidm_conv_gn_film_silu_bwd(const void* x, const void* wdx,
                                          const void* gamma, const void* beta,
                                          const void* scale, const void* shift, const void* dy,
                                          const void* z, const void* stats, void* dx, void* dw,
                                          void* dbias, void* dgamma, void* dbeta, void* dscale,
                                          void* dshift, void* dz, void* work, int B, int Ci,
                                          int Co, int P, int G, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return backward<__nv_bfloat16>(x, wdx, gamma, beta, scale, shift, dy, z, stats, dx, dw,
                                   dbias, dgamma, dbeta, dscale, dshift, dz, work, B, Ci, Co, P,
                                   G, st);
  return backward<float>(x, wdx, gamma, beta, scale, shift, dy, z, stats, dx, dw, dbias,
                         dgamma, dbeta, dscale, dshift, dz, work, B, Ci, Co, P, G, st);
}
