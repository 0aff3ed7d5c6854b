// K1 backward: the VJP of the fused pre-norm linear-attention block
// out = x + b_out + LA(LN_gamma(x)) (linear_attention.cu), on a token-major
// [B, N, C] fp32 activation, 8 heads x 32 dims: dx, dgamma, dW_qkv, dW_out
// and db_out from dy. K3 backward, the VJP of out = LA(x), is a mode of the
// same passes (`block` false): no LayerNorm VJP, no dgamma and no db_out;
// the q and k/v passes read x where K1 reads x-ln, and dx = dxln.
// x and dy may be bf16 (the `bf16` flag; dx is then bf16 too, rounded once
// when it is written): every read of them goes through pidm::to_f32, and all
// arithmetic and every partial sum stay fp32 in the same fixed order. The
// parameter gradients are fp32 either way.
//
// K1 replaces physicsinformeddiffusionmodels_tpu/ops/pallas_attention.py
// `_lab_bwd_kernel` (launched by `_lab_bwd_call` through pl.pallas_call);
// K3 replaces `_bwd_kernel` of the same file (launched by `_bwd_call`).
// With P the q softmax (unscaled), K' the k softmax over the tokens,
// vn = v / N, ctx_h = K'^T vn and M = 32^-1/2 ctx_h W_out,h (the forward's
// scratch, kept for the backward):
//   db_out = sum dy;  dM = P^T dy (per batch row);  dP = M dy;
//   dA = P (dP - sum_d dP P);  dctx = 32^-1/2 dM W_out^T;
//   dW_out = 32^-1/2 sum_b ctx^T dM;  row = rowsum(dctx * ctx);
//   dk = K' (dctx vn - row);  dv = dctx^T K' / N;
//   dxln = [dA dk dv] W_qkv^T;  dW_qkv = sum_tokens xln^T [dA dk dv];
//   dx = dy + the LayerNorm VJP of dxln;  dgamma = sum dxln * x-hat.
//
// Bound on the H100: operations. Per token it does the qkv projection
// again (2 * C * 768 flops), dP (2 * C * 256), dxln and dW_qkv (2 * C * 768
// each) and dM (2 * C * 256), about 170 flops per byte of fp32 x and dy (340
// in bf16), far above the fp32 balance of ~20; in full fp32 on the CUDA cores
// (no TF32).
//
// The TPU kernel walked the batch rows in order and carried dM and the
// weight gradients across grid steps in VMEM. A CUDA grid has no order, and
// three sums cross blocks: dM (over the tokens of a row, needed before dctx
// and so before the k/v path), and the weight/bias/gamma gradients (over all
// B x N tokens). So this takes separate passes, each summing in a fixed
// order, with no atomics, so results repeat exactly:
//   1. lab_bwd_q, grid (token tiles of 16, B): LN, the q softmax P and dA
//      (one thread per hidden column, one warp per head); writes x-ln (x in
//      K3's mode) as fp32, P and dA to the workspace and this tile's column
//      sum of dy. Passes 4 and 5 read the tokens from there, so x is read in
//      its own type only in passes 1 and 4 (the LayerNorm VJP's x-hat).
//   2. gemm_atb (split over tokens) + reduce_splits: dM = P^T dy per row.
//   3. lab_bwd_ctx, grid (heads, B): dctx, row and the row's share of dW_out.
//   4. lab_bwd_kv, grid (token tiles, B): k, v again from x-ln, then dk, dv
//      (warp shuffles within the head), dxln = [dA dk dv] W_qkv^T (each warp
//      a slice of the 768 columns, each W_qkv element read once per block),
//      the LayerNorm VJP into dx, and the tile's share of dgamma.
//   5. gemm_atb + reduce_splits: dW_qkv = x-ln^T [dA dk dv] over all tokens;
//      reduce_splits folds the per-row dW_out and the per-tile db_out/dgamma.
// The forward saves, per (row, head), the normalised context and the k
// softmax's max m and normaliser z (`stats`), so no pass streams the tokens
// to rebuild them. The workspace keeps x-ln, P and [dA dk dv] for every
// token in fp32, whatever x's type: (C + 1024) floats a token, about 1.1 GB
// at B=64, N=4096, C=32 (the Darcy top level), which an 80 GB card holds; a
// faster kernel would keep them on chip. Any N (the ragged tile is masked);
// C <= 1024.

#include <math.h>

#include "common.cuh"

namespace {

using pidm::from_f32;
using pidm::load_tile;
using pidm::ln_rows;
using pidm::to_f32;

constexpr int kThreads = 256;
constexpr int kDh = 32;                     // dims per head
constexpr int kDhP = kDh + 1;               // padded row of dctx in shared memory
constexpr int kHeads = 8;
constexpr int kH = kHeads * kDh;            // hidden width
constexpr int kQKV = 3 * kH;
constexpr int kStats = kDh * kDh + 2 * kDh; // ctx, m, z of one (row, head)
constexpr int kTile = 16;                   // tokens per block of passes 1 and 4
constexpr int kGT = 64;                     // output tile edge of gemm_atb
constexpr int kGK = 16;                     // tokens per shared-memory stage
constexpr int kSplitRows = 256;             // least tokens per split of a product
constexpr float kQScale = 0.17677669529663687f;  // 32^-1/2
static_assert(kH == kThreads, "passes 1 and 4 map one thread to each hidden column");

// Offsets (in floats) of the workspace's parts, and the split plans.
struct Plan {
  int nt;            // token tiles per row
  int sm, rows_m;    // splits (and tokens per split) of dM's product
  int sw, rows_w;    // splits of dW_qkv's product
  long long xln, p, dqkv, dm_part, dm, dctx, row, dwout_part, vec_part, vec_b, dwqkv_part;
  long long total;
};

Plan make_plan(int B, int N, int C) {
  Plan w;
  const long long tokens = (long long)B * N;
  w.nt = (N + kTile - 1) / kTile;
  w.rows_m = kSplitRows;
  w.sm = (N + w.rows_m - 1) / w.rows_m;
  const long long rows_w = (tokens + 127) / 128;  // at most 128 splits
  w.rows_w = rows_w > kSplitRows ? (int)rows_w : kSplitRows;
  w.sw = (int)((tokens + w.rows_w - 1) / w.rows_w);
  long long at = 0;
  auto take = [&at](long long n) {
    const long long here = at;
    at += (n + 63) / 64 * 64;  // 256-byte aligned parts
    return here;
  };
  w.xln = take(tokens * C);
  w.p = take(tokens * kH);
  w.dqkv = take(tokens * kQKV);
  w.dm_part = take((long long)B * w.sm * kH * C);
  w.dm = take((long long)B * kH * C);
  w.dctx = take((long long)B * kHeads * kDh * kDh);
  w.row = take((long long)B * kH);
  w.dwout_part = take((long long)B * kH * C);
  w.vec_part = take((long long)B * w.nt * 2 * C);
  w.vec_b = take((long long)B * 2 * C);
  w.dwqkv_part = take((long long)w.sw * C * kQKV);
  w.total = at;
  return w;
}

// Pass 1. Thread j = h * 32 + d owns hidden column j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lab_bwd_q_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ gamma, const float* __restrict__ w_qkv,
                 const float* __restrict__ M, float* __restrict__ xln, float* __restrict__ P,
                 float* __restrict__ dqkv, float* __restrict__ vec_part, int N, int C,
                 float eps, bool block) {
  extern __shared__ float sm[];
  float* xs = sm;                // [kTile, C] LN'd (K1) or raw (K3) tokens
  float* dys = xs + kTile * C;   // [kTile, C] dy
  const int b = blockIdx.y, tile = blockIdx.x, n0 = tile * kTile, tid = threadIdx.x;
  const int rows = min(kTile, N - n0);
  const long long base = (long long)b * N + n0;  // first token of the tile

  load_tile(xs, x + (long long)b * N * C, n0, kTile, N, C);
  load_tile(dys, dy + (long long)b * N * C, n0, kTile, N, C);
  __syncthreads();
  if (block) ln_rows(xs, rows, C, gamma, eps);  // K3 reads the tokens as they are
  __syncthreads();
  // the tokens as passes 4 and 5 read them, fp32: x-ln (K1) or x (K3)
  for (int i = tid; i < rows * C; i += kThreads) xln[base * C + i] = xs[i];
  if (block) {
    float* vp = vec_part + ((long long)b * gridDim.x + tile) * 2 * C;
    for (int c = tid; c < C; c += kThreads) {  // this tile's share of db_out
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += dys[r * C + c];
      vp[c] = s;
    }
  }

  float p[kTile], dp[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) p[r] = dp[r] = 0.f;
  const float* Mj = M + ((long long)b * kH + tid) * C;
  for (int c = 0; c < C; ++c) {
    const float w = w_qkv[(long long)c * kQKV + tid];
    const float m = Mj[c];
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      p[r] = fmaf(xs[r * C + c], w, p[r]);
      dp[r] = fmaf(dys[r * C + c], m, dp[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    const float e = expf(p[r] - pidm::warp_max(p[r]));
    p[r] = e / pidm::warp_sum(e);
    // M carries the q scale, so dp is the cotangent of the unscaled softmax
    dp[r] = p[r] * (dp[r] - pidm::warp_sum(dp[r] * p[r]));
    if (r < rows) {
      P[(base + r) * kH + tid] = p[r];
      dqkv[(base + r) * kQKV + tid] = dp[r];
    }
  }
}

// part[z, s] = A_z[k, :]^T Bm_z[k, :] summed over the tokens k of split s:
// [I, J] from A [K, I] (row stride lda) and Bm [K, J] (row stride ldb).
// Grid (J tiles, I tiles, Z * S); each thread owns a 4 x 4 block of the
// 64 x 64 output tile. Bm is fp32 or bf16 (dy).
template <typename TB>
__global__ void __launch_bounds__(kThreads)
gemm_atb_kernel(const float* __restrict__ A, const TB* __restrict__ Bm,
                float* __restrict__ part, int K, int I, int J, int lda, int ldb,
                long long stride_a, long long stride_b, int rows_per_split, int S) {
  __shared__ float as[kGK][kGT];
  __shared__ float bs[kGK][kGT];
  const int j0 = blockIdx.x * kGT, i0 = blockIdx.y * kGT;
  const int z = blockIdx.z / S, s = blockIdx.z % S;
  const int k_begin = s * rows_per_split, k_end = min(K, k_begin + rows_per_split);
  A += z * stride_a;
  Bm += z * stride_b;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kGK) {
    for (int e = tid; e < kGK * kGT; e += kThreads) {
      const int kk = e / kGT, ii = e % kGT, k = k0 + kk;
      as[kk][ii] = (k < k_end && i0 + ii < I) ? A[(long long)k * lda + i0 + ii] : 0.f;
      bs[kk][ii] = (k < k_end && j0 + ii < J) ? to_f32(Bm[(long long)k * ldb + j0 + ii]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = as[kk][ty * 4 + q];
        bv[q] = bs[kk][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }
  float* out = part + ((long long)z * S + s) * I * J;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (i < I && j < J) out[(long long)i * J + j] = acc[p][q];
    }
  }
}

// out[z, e] = sum_{s < S} part[z * stride_z + s * stride_s + e], s in order.
__global__ void __launch_bounds__(kThreads)
reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out, int S, int E,
                     long long stride_s, long long stride_z) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, z = blockIdx.y;
  if (e >= E) return;
  const float* p = part + z * stride_z + e;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += p[s * stride_s];
  out[(long long)z * E + e] = acc;
}

// Pass 3, one block per (head, row).
__global__ void __launch_bounds__(kThreads)
lab_bwd_ctx_kernel(const float* __restrict__ stats, const float* __restrict__ w_out,
                   const float* __restrict__ dM, float* __restrict__ dctx,
                   float* __restrict__ row, float* __restrict__ dwout_part, int C) {
  __shared__ float ctx_s[kDh * kDh];
  __shared__ float dctx_s[kDh * kDh];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* st = stats + ((long long)b * kHeads + h) * kStats;
  const float* dMh = dM + ((long long)b * kH + h * kDh) * C;  // [32 (d), C]
  const float* wo = w_out + (long long)h * kDh * C;            // [32 (e), C]
  for (int i = tid; i < kDh * kDh; i += kThreads) {
    const int d = i / kDh, e = i % kDh;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(dMh[(long long)d * C + c], wo[(long long)e * C + c], acc);
    ctx_s[i] = st[i];
    dctx_s[i] = acc * kQScale;
  }
  __syncthreads();
  float* dc = dctx + ((long long)b * kHeads + h) * kDh * kDh;
  for (int i = tid; i < kDh * kDh; i += kThreads) dc[i] = dctx_s[i];
  if (tid < kDh) {
    float acc = 0.f;
    for (int e = 0; e < kDh; ++e) acc = fmaf(dctx_s[tid * kDh + e], ctx_s[tid * kDh + e], acc);
    row[(long long)b * kH + h * kDh + tid] = acc;
  }
  // this row's share of dW_out,h[e, c] = 32^-1/2 sum_d ctx[d, e] dM_h[d, c]
  float* dwo = dwout_part + ((long long)b * kH + h * kDh) * C;
  for (int i = tid; i < kDh * C; i += kThreads) {
    const int e = i / C, c = i % C;
    float acc = 0.f;
    for (int d = 0; d < kDh; ++d) acc = fmaf(ctx_s[d * kDh + e], dMh[(long long)d * C + c], acc);
    dwo[i] = acc * kQScale;
  }
}

// Pass 4. Thread j = h * 32 + lane owns hidden column j of k and v. `xln`
// holds x itself in K3's mode.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lab_bwd_kv_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, const float* __restrict__ w_qkv,
                  const float* __restrict__ stats, const float* __restrict__ xln,
                  const float* __restrict__ dctx, const float* __restrict__ row,
                  float* __restrict__ dqkv, T* __restrict__ dx,
                  float* __restrict__ vec_part, int N, int C, float eps, bool block) {
  extern __shared__ float sm[];
  float* xs = sm;                     // [kTile, C] x-ln, then dxln
  float* xh = xs + kTile * C;         // [kTile, C] x, then x-hat
  float* dq = xh + kTile * C;         // [kTile, 768] dA | dk | dv
  float* dctx_s = dq + kTile * kQKV;  // [8, 32 (d), 33 (e)] this row's dctx, padded
  const int b = blockIdx.y, tile = blockIdx.x, n0 = tile * kTile, tid = threadIdx.x;
  const int lane = tid & 31, h = tid >> 5;
  const int rows = min(kTile, N - n0);
  const long long base = (long long)b * N + n0;

  load_tile(xs, xln + (long long)b * N * C, n0, kTile, N, C);
  if (block) load_tile(xh, x + (long long)b * N * C, n0, kTile, N, C);
  for (int i = tid; i < kHeads * kDh * kDh; i += kThreads)
    dctx_s[i / kDh * kDhP + i % kDh] = dctx[(long long)b * kHeads * kDh * kDh + i];
  __syncthreads();

  float kp[kTile], vn[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) kp[r] = vn[r] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float wk = w_qkv[(long long)c * kQKV + kH + tid];
    const float wv = w_qkv[(long long)c * kQKV + 2 * kH + tid];
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      kp[r] = fmaf(xs[r * C + c], wk, kp[r]);
      vn[r] = fmaf(xs[r * C + c], wv, vn[r]);
    }
  }
  const float* st = stats + ((long long)b * kHeads + h) * kStats;
  const float m = st[kDh * kDh + lane], z = st[kDh * kDh + kDh + lane];
  const float rj = row[(long long)b * kH + tid];
  // rows padded to 33 floats, so that lanes reading a column (dK') and lanes
  // reading a row (dvn) both fall on 32 distinct banks
  const float* dch = dctx_s + h * kDh * kDhP;
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    kp[r] = expf(kp[r] - m) / z;  // K'
    vn[r] = vn[r] / (float)N;
  }
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    // this thread is dim `lane` of head h: d of dK' = dctx vn, e of dvn = dctx^T K'
    float dkp = 0.f, dvn = 0.f;
#pragma unroll
    for (int e = 0; e < kDh; ++e) {
      dkp = fmaf(dch[lane * kDhP + e], __shfl_sync(0xffffffffu, vn[r], e), dkp);
      dvn = fmaf(dch[e * kDhP + lane], __shfl_sync(0xffffffffu, kp[r], e), dvn);
    }
    const bool valid = r < rows;
    const float dk = valid ? kp[r] * (dkp - rj) : 0.f;
    const float dv = valid ? dvn / (float)N : 0.f;
    dq[r * kQKV + tid] = valid ? dqkv[(base + r) * kQKV + tid] : 0.f;  // dA of pass 1
    dq[r * kQKV + kH + tid] = dk;
    dq[r * kQKV + 2 * kH + tid] = dv;
    if (valid) {
      dqkv[(base + r) * kQKV + kH + tid] = dk;
      dqkv[(base + r) * kQKV + 2 * kH + tid] = dv;
    }
  }
  __syncthreads();

  // dxln[r, c] = sum_j dq[r, j] W_qkv[c, j]. Warp h takes the 96 j of
  // [96 h, 96 h + 96) and lane l the channel cc + l of a 32-channel chunk,
  // so the block reads each W_qkv element once; the 8 warps' partial sums
  // meet in shared memory (in dctx_s, no longer read) and add in warp order.
  constexpr int kJ = kQKV / (kThreads / 32);
  float* part = dctx_s;  // [8 warps, kTile, 32]
  for (int cc = 0; cc < C; cc += 32) {
    float acc[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
    if (cc + lane < C) {
      const float* wr = w_qkv + (long long)(cc + lane) * kQKV + h * kJ;
      const float* dqh = dq + h * kJ;
      for (int j = 0; j < kJ; ++j) {
        const float w = wr[j];
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[r] = fmaf(dqh[r * kQKV + j], w, acc[r]);
      }
    }
    __syncthreads();  // dctx_s, then the previous chunk's partials, are read
#pragma unroll
    for (int r = 0; r < kTile; ++r) part[(h * kTile + r) * 32 + lane] = acc[r];
    __syncthreads();
    for (int i = tid; i < rows * 32; i += kThreads) {
      const int r = i / 32, l = i % 32;
      if (cc + l < C) {
        float sum = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) sum += part[(w * kTile + r) * 32 + l];
        xs[r * C + cc + l] = sum;
      }
    }
  }
  __syncthreads();
  if (!block) {  // K3: dx = dxln
    for (int i = tid; i < rows * C; i += kThreads) dx[base * C + i] = from_f32<T>(xs[i]);
    return;
  }

  // LayerNorm VJP, one warp per token; x-hat is recomputed as pass A did it
  for (int r = h; r < rows; r += kThreads / 32) {
    float* xr = xh + r * C;
    const float* du = xs + r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += xr[c];
    const float mu = pidm::warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mu;
      v = fmaf(d, d, v);
    }
    const float rstd = rsqrtf(pidm::warp_sum(v) / C + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (xr[c] - mu) * rstd;
      const float g = du[c] * gamma[c];
      xr[c] = xhat;
      s1 += g;
      s2 = fmaf(g, xhat, s2);
    }
    s1 = pidm::warp_sum(s1) / C;
    s2 = pidm::warp_sum(s2) / C;
    T* dxr = dx + (base + r) * C;
    const T* dyr = dy + (base + r) * C;
    for (int c = lane; c < C; c += 32)
      dxr[c] = from_f32<T>(rstd * (du[c] * gamma[c] - s1 - xr[c] * s2) + to_f32(dyr[c]));
  }
  __syncthreads();
  float* vp = vec_part + ((long long)b * gridDim.x + tile) * 2 * C + C;
  for (int c = tid; c < C; c += kThreads) {  // this tile's share of dgamma
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s = fmaf(xs[r * C + c], xh[r * C + c], s);
    vp[c] = s;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename TB>
cudaError_t gemm_atb(const float* A, const TB* Bm, float* part, int Z, int K, int I, int J,
                     int lda, int ldb, long long stride_a, long long stride_b, int rows,
                     int S, cudaStream_t st) {
  if ((long long)Z * S > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((J + kGT - 1) / kGT, (I + kGT - 1) / kGT, Z * S);
  gemm_atb_kernel<TB><<<grid, kThreads, 0, st>>>(A, Bm, part, K, I, J, lda, ldb, stride_a,
                                                  stride_b, rows, S);
  return cudaGetLastError();
}

cudaError_t reduce_splits(const float* part, float* out, int Z, int S, int E, long long stride_s,
                          long long stride_z, cudaStream_t st) {
  reduce_splits_kernel<<<dim3((E + kThreads - 1) / kThreads, Z), kThreads, 0, st>>>(
      part, out, S, E, stride_s, stride_z);
  return cudaGetLastError();
}

template <typename T>
int typed_backward(const void* x, const void* dy, const void* gamma, const void* w_qkv,
             const void* w_out, const void* M, const void* stats, void* dx, void* dgamma,
             void* dw_qkv, void* dw_out, void* db_out, void* work, int B, int N, int C,
             float eps, bool block, cudaStream_t st) {
  const Plan w = make_plan(B, N, C);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* g = static_cast<const float*>(gamma);
  const float* wqkv = static_cast<const float*>(w_qkv);
  const float* wout = static_cast<const float*>(w_out);
  const float* stf = static_cast<const float*>(stats);
  float* ws = static_cast<float*>(work);
  const long long tokens = (long long)B * N;
  const float* xln = ws + w.xln;  // what passes 4 and 5 read, written by pass 1

  const size_t smem_q = 2 * kTile * C * sizeof(float);
  const size_t smem_kv = (2 * kTile * C + kTile * kQKV + kHeads * kDh * kDhP) * sizeof(float);
  cudaError_t err = allow_smem(lab_bwd_q_kernel<T>, smem_q);
  if (err == cudaSuccess) err = allow_smem(lab_bwd_kv_kernel<T>, smem_kv);
  if (err != cudaSuccess) return (int)err;

  lab_bwd_q_kernel<T><<<dim3(w.nt, B), kThreads, smem_q, st>>>(
      xt, dyt, g, wqkv, static_cast<const float*>(M), ws + w.xln, ws + w.p, ws + w.dqkv,
      ws + w.vec_part, N, C, eps, block);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dM[b] = P[b]^T dy[b]
  err = gemm_atb(ws + w.p, dyt, ws + w.dm_part, B, N, kH, C, kH, C, (long long)N * kH,
                 (long long)N * C, w.rows_m, w.sm, st);
  if (err == cudaSuccess)
    err = reduce_splits(ws + w.dm_part, ws + w.dm, B, w.sm, kH * C, (long long)kH * C,
                        (long long)w.sm * kH * C, st);
  if (err != cudaSuccess) return (int)err;
  lab_bwd_ctx_kernel<<<dim3(kHeads, B), kThreads, 0, st>>>(
      stf, wout, ws + w.dm, ws + w.dctx, ws + w.row, ws + w.dwout_part, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lab_bwd_kv_kernel<T><<<dim3(w.nt, B), kThreads, smem_kv, st>>>(
      xt, dyt, g, wqkv, stf, xln, ws + w.dctx, ws + w.row, ws + w.dqkv,
      static_cast<T*>(dx), ws + w.vec_part, N, C, eps, block);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dW_qkv = x-ln^T [dA dk dv] over all tokens
  err = gemm_atb(xln, ws + w.dqkv, ws + w.dwqkv_part, 1, (int)tokens, C, kQKV, C, kQKV,
                 0, 0, w.rows_w, w.sw, st);
  if (err == cudaSuccess)
    err = reduce_splits(ws + w.dwqkv_part, static_cast<float*>(dw_qkv), 1, w.sw, C * kQKV,
                        (long long)C * kQKV, 0, st);
  if (err == cudaSuccess)
    err = reduce_splits(ws + w.dwout_part, static_cast<float*>(dw_out), 1, B, kH * C,
                        (long long)kH * C, 0, st);
  if (!block) return (int)err;
  // db_out | dgamma: tiles -> rows -> total
  if (err == cudaSuccess)
    err = reduce_splits(ws + w.vec_part, ws + w.vec_b, B, w.nt, 2 * C, 2 * C,
                        (long long)w.nt * 2 * C, st);
  if (err == cudaSuccess)
    err = reduce_splits(ws + w.vec_b, static_cast<float*>(db_out), 1, B, C, 2 * C, 0, st);
  if (err == cudaSuccess)
    err = reduce_splits(ws + w.vec_b + C, static_cast<float*>(dgamma), 1, B, C, 2 * C, 0, st);
  return (int)err;
}

int backward(const void* x, const void* dy, const void* gamma, const void* w_qkv,
             const void* w_out, const void* M, const void* stats, void* dx, void* dgamma,
             void* dw_qkv, void* dw_out, void* db_out, void* work, int B, int N, int C,
             float eps, bool block, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return typed_backward<__nv_bfloat16>(x, dy, gamma, w_qkv, w_out, M, stats, dx, dgamma,
                                         dw_qkv, dw_out, db_out, work, B, N, C, eps, block, st);
  return typed_backward<float>(x, dy, gamma, w_qkv, w_out, M, stats, dx, dgamma, dw_qkv,
                               dw_out, db_out, work, B, N, C, eps, block, st);
}

}  // namespace

// Floats of workspace that pidm_linear_attention_block_bwd and
// pidm_linear_attention_bwd need.
extern "C" long long pidm_linear_attention_block_bwd_workspace(int B, int N, int C) {
  return make_plan(B, N, C).total;
}

// x, dy, dx: [B, N, C] fp32 (bf16 when `bf16` is 1); gamma, dgamma, b_out's
// db_out: [C] fp32; w_qkv, dw_qkv: [C, 768]; w_out, dw_out: [256, C]; M:
// [B, 256, C] and stats: [B, 8, 1088], both as the forward wrote them; work:
// the workspace of pidm_linear_attention_block_bwd_workspace.
// Launches on `stream`, allocates nothing, returns the CUDA error.
extern "C" int pidm_linear_attention_block_bwd(const void* x, const void* dy, const void* gamma,
                                               const void* w_qkv, const void* w_out,
                                               const void* M, const void* stats, void* dx,
                                               void* dgamma, void* dw_qkv, void* dw_out,
                                               void* db_out, void* work, int B, int N, int C,
                                               float eps, int bf16, void* stream) {
  return backward(x, dy, gamma, w_qkv, w_out, M, stats, dx, dgamma, dw_qkv, dw_out, db_out,
                  work, B, N, C, eps, true, bf16, stream);
}

// K3 backward: x, dy, dx: [B, N, C] fp32 (bf16 when `bf16` is 1); w_qkv,
// dw_qkv: [C, 768]; w_out,
// dw_out: [256, C]; M and stats as K3's forward wrote them; work: the
// workspace of pidm_linear_attention_block_bwd_workspace. Launches on
// `stream`, allocates nothing, returns the CUDA error.
extern "C" int pidm_linear_attention_bwd(const void* x, const void* dy, const void* w_qkv,
                                         const void* w_out, const void* M, const void* stats,
                                         void* dx, void* dw_qkv, void* dw_out, void* work,
                                         int B, int N, int C, int bf16, void* stream) {
  return backward(x, dy, nullptr, w_qkv, w_out, M, stats, dx, nullptr, dw_qkv, dw_out,
                  nullptr, work, B, N, C, 0.f, false, bf16, stream);
}
