// K1 backward: the VJP of the fused pre-norm linear-attention block
// out = x + b_out + LA(LN_gamma(x)) (linear_attention.cu), on a token-major
// [B, N, C] activation, 8 heads x 32 dims: dx, dgamma, dW_qkv, dW_out
// and db_out from dy. K3 backward, the VJP of out = LA(x), is a mode of the
// same launches (`block` false): no LayerNorm VJP, no dgamma and no db_out;
// the passes read x where K1 reads x-ln, and dx = dxln.
// x and dy may be bf16 (the `bf16` flag; dx is then bf16 too, rounded once
// when it is written); the parameter gradients are fp32 either way. fp32 x
// multiplies in full fp32 on the CUDA cores; every sum is fp32, in a fixed
// order. bf16 x multiplies on the tensor cores in bf16 (la_tile.cuh), and
// the backward is the VJP of the forward as it rounds (linear_attention.cu,
// and the plain version): the forward's operands enter rounded to bf16 as
// they did there (x-ln, W_qkv, P, v, exp(k - m), ctx and W_out), and M and
// the gradients, which the forward does not round, enter as bf16 pairs
// (about 16 bits; M in dP, [dA dk dv] in dxln and dW_qkv, dctx in dk and
// dv) or in fp32 (dM in dctx and dW_out). dy is bf16 already.
//
// K1 replaces physicsinformeddiffusionmodels_tpu/ops/pallas_attention.py
// `_lab_bwd_kernel` (launched by `_lab_bwd_call` through pl.pallas_call);
// K3 replaces `_bwd_kernel` of the same file (launched by `_bwd_call`).
// With P the q softmax (unscaled), K' the k softmax over the tokens,
// vn = v / N, ctx_h = K'^T vn and M = 32^-1/2 ctx_h W_out,h (the forward's
// scratch, kept for the backward):
//   db_out = sum dy;  dM = P^T dy (per batch row);  dP = dy M^T;
//   dA = P (dP - sum_d dP P);  dctx = 32^-1/2 dM W_out^T;
//   dW_out = 32^-1/2 sum_b ctx^T dM;  row = rowsum(dctx * ctx);
//   dk = K' (vn dctx^T - row);  dv = K' dctx / N;
//   dxln = [dA dk dv] W_qkv^T;  dW_qkv = sum_tokens xln^T [dA dk dv];
//   dx = dy + the LayerNorm VJP of dxln;  dgamma = sum dxln * x-hat.
//
// Bound on the H100: operations. Per token: the qkv projection again
// (2 * C * 768 flops), dP (2 * C * 256), dxln and dW_qkv (2 * C * 768 each),
// dM (2 * C * 256) and the k/v path within the heads (2 * 2 * 256 * 32),
// about 170 flops a byte of fp32 x and dy (340 in bf16), far above the
// card's balance.
//
// The TPU kernel walked the batch rows in order and carried dM and the
// weight gradients across grid steps in VMEM. A CUDA grid has no order, and
// dctx needs the whole row's dM before any token's dk. So four launches, no
// per-token workspace (P, dA, dk and dv live only in the shared memory and
// registers of the block that makes them), and no atomics:
//   1. lab_bwd_q: grid (token ranges, B, 64-channel groups of C). Per
//      32-token tile: the LayerNorm, the q projection and softmax, and the
//      block's share of dM[:, group] = P^T dy (registers across its range)
//      and of db_out; each written once to a partial buffer.
//   2. lab_bwd_ctx: grid (heads, B). Sums the row's dM partials in order;
//      dctx, row and the row's dW_out.
//   3. lab_bwd_kv: grid (token ranges, B). Per tile: the qkv projection
//      again (three [32, C] x [C, 256] products), P, K', vn; dP = dy M^T and
//      dA; dk and dv from this row's dctx; dxln = [dA dk dv] W_qkv^T (each
//      warp a head's share, summed over the heads in order); the LayerNorm
//      VJP into dx; and the block's shares of dW_qkv (accumulated across its
//      range in its own partial, L2-resident) and dgamma.
//   4. lab_bwd_reduce: each output element sums its partials in block order.
// The workspace (pidm_linear_attention_block_bwd_workspace) is sized by the
// number of blocks, not tokens: 20.6 MiB at B = 64, N = 4096, C = 32
// (dominated by one [C, 768] dW_qkv partial a block); the ranges a row
// shrink so that the dW_qkv partials stay under 256 MiB at any B and
// C <= 1024 (one range a row at B = 64, C = 1024). Any N (the ragged tile is
// masked) and any C <= 1024 (the last 32-channel slice zero-padded).

#include <math.h>

#include "la_tile.cuh"

namespace {

using namespace pidm::la;
using pidm::from_f32;
using pidm::to_f32;

constexpr int kDh = 32;                      // dims per head
constexpr int kHeads = 8;
constexpr int kH = kHeads * kDh;             // hidden width
constexpr int kQKV = 3 * kH;
constexpr int kStats = kDh * kDh + 2 * kDh;  // ctx, m, z of one (row, head)
constexpr int kCG = 64;                      // dM columns a block of pass 1 owns
constexpr float kQScale = 0.17677669529663687f;  // 32^-1/2
constexpr long long kPartialBytes = 256ll << 20;  // bound of the dW_qkv partials
// shared-memory leading dimensions (floats), see la_tile.cuh
constexpr int kLdX = kKC + 4;      // [t][c] x-ln or dy slice (A, m-major)
constexpr int kLdXB = kKC + 8;     // [t][c] x-ln slice (B, k-major)
constexpr int kLdQ = kH + 8;       // [c][j] a 256-column slice of W_qkv (B, k-major)
constexpr int kLdPT = kH + 8;      // [t][j] P (A of dM, k-major)
constexpr int kLdDy = kCG + 8;     // [t][c] dy group (B, k-major)
constexpr int kLdS = kQKV + 4;     // [t][j] q|k|v -> P|K'|vn -> dA|dk|dv (A, both layouts)
constexpr int kLdMt = kKC + 4;     // [j][c] M slice (B = M^T, n-major)
constexpr int kLdWt = kH + 4;      // [c][j] W_qkv slice (B = W^T, n-major)
constexpr int kLdDc = kDh + 4;     // [h][d][e] dctx
constexpr int kLdRed = kKC + 1;    // [warp][t][c] per-head shares of dxln
constexpr int kLdSlot = 36;        // a lane's 32 dW_qkv partial values in u (step 5)

// C rounded up to whole 32-channel slices.
__host__ __device__ constexpr int padded(int C) { return (C + kKC - 1) / kKC * kKC; }

// Offsets (in floats) of the workspace's parts.
struct Plan {
  Ranges rg;
  int n_blk;  // blocks of passes 1 and 3: B * rg.ranges
  long long dm_part, db_part, dctx, row, dwo_part, dw_part, dg_part, dxl, total;
};

Plan make_plan(int B, int N, int C) {
  Plan w;
  w.rg = make_ranges(B, N);
  // one [C, 768] fp32 dW_qkv partial a block of pass 3
  while (w.rg.ranges > 1 && (long long)B * w.rg.ranges * padded(C) * kQKV * 4 > kPartialBytes)
    --w.rg.ranges;
  w.n_blk = B * w.rg.ranges;
  long long at = 0;
  auto take = [&at](long long n) {
    const long long here = at;
    at += (n + 63) / 64 * 64;  // 256-byte aligned parts
    return here;
  };
  w.dm_part = take((long long)w.n_blk * kH * C);
  w.db_part = take((long long)w.n_blk * C);
  w.dctx = take((long long)B * kHeads * kDh * kDh);
  w.row = take((long long)B * kH);
  w.dwo_part = take((long long)B * kH * C);
  w.dw_part = take((long long)w.n_blk * padded(C) * kQKV);
  w.dg_part = take((long long)w.n_blk * C);
  w.dxl = take((long long)w.n_blk * kT * C);
  w.total = at;
  return w;
}

// The q projection of one tile (or the k or v one, from that section's
// columns w_sec of W_qkv): warp w gets head w's q (rows t, columns d). x-ln
// is staged slice by slice into xs (row stride ldx), unless C <= 32, where
// the caller staged the whole tile's (stage_ln_tile); W_q is staged into ws
// unless `stage_w` is false (already there, C <= 32).
template <typename T, bool kTc>
__device__ __forceinline__ void q_projection(float (&q)[4][8], float* xs, int ldx, float* ws,
                                             const T* __restrict__ xb, const float* mr,
                                             const float* __restrict__ gam,
                                             const float* __restrict__ w_sec, int n0, int rows,
                                             int C, bool stage_w) {
  const int w = threadIdx.x >> 5;
  zero(q);
  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();  // mr is written; the previous slice is read
    if (C > kKC) stage_xln(xs, ldx, xb, mr, gam, n0, rows, c0, C);
    if (stage_w) stage<kKC, kH>(ws, kLdQ, w_sec + (long long)c0 * kQKV, kQKV, C - c0, kH);
    __syncthreads();
    warp_gemm<kTc, false, true>(q, xs, ldx, ws + w * kDh, kLdQ, kKC);
  }
}

// Pass 1.
template <typename T, bool kTc>
__global__ void __launch_bounds__(kThreads, 1)
lab_bwd_q_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ gamma, const float* __restrict__ w_qkv,
                 float* __restrict__ dm_part, float* __restrict__ db_part, int N, int C,
                 float eps, bool block, Ranges plan) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [kKC][kLdQ]  W_q slice
  float* ps = ws + kKC * kLdQ;                  // [kT][kLdPT]  P
  float* dys = ps + kT * kLdPT;                 // [kT][kLdDy]  dy, this block's columns
  float* xs = dys + kT * kLdDy;                 // [kT][kLdX]   x-ln slice
  float* mr = xs + kT * kLdX;                   // [kT][2]
  const int b = blockIdx.y, r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g0 = blockIdx.z * kCG;
  const T* xb = x + (long long)b * N * C;
  const T* dyb = dy + (long long)b * N * C;
  const float* gam = block ? gamma : nullptr;

  float dm[2][4][8];  // warp w: dM rows 32 w + row, columns g0 + 32 q + col
  zero(dm);
  float db = 0.f;     // thread tid < kCG: column g0 + tid of db_out
  for (int tile = plan.begin(r); tile < plan.begin(r + 1); ++tile) {
    const int n0 = tile * kT, rows = min(kT, N - n0);
    __syncthreads();  // ps and dys of the previous tile are read
    if (C <= kKC)  // the tile's x-ln in one pass
      stage_ln_tile(xs, kLdX, xb, mr, gam, n0, rows, C, eps, block);
    else
      row_stats(mr, xb, n0, rows, C, eps, block);
    float q[4][8];
    q_projection<T, kTc>(q, xs, kLdX, ws, xb, mr, gam, w_qkv, n0, rows, C,
                         C > kKC || tile == plan.begin(r));
    row_softmax(q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ps[row<kTc, false>(lane, i) * kLdPT + w * kDh + col<kTc, true>(lane, j)] = q[i][j];
    stage<kT, kCG>(dys, kLdDy, dyb + (long long)n0 * C + g0, C, rows, C - g0);
    __syncthreads();
    if (block && tid < kCG)
      for (int t = 0; t < kT; ++t) db += dys[t * kLdDy + tid];
    // dM[32w : 32w + 32, group] += P[:, 32w : 32w + 32]^T dy[:, group]
    warp_gemm<kTc, true, true, 2>(dm, ps + w * kDh, kLdPT, dys, kLdDy, kT);
  }
  const long long p = (long long)b * plan.ranges + r;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = g0 + q * 32 + col<kTc, true>(lane, j);
        if (c < C) dm_part[(p * kH + w * kDh + row<kTc, true>(lane, i)) * C + c] = dm[q][i][j];
      }
  if (block && tid < kCG && g0 + tid < C) db_part[p * C + g0 + tid] = db;
}

// Pass 2, one block per (head, row).
__global__ void __launch_bounds__(kThreads)
lab_bwd_ctx_kernel(const float* __restrict__ stats, const float* __restrict__ w_out,
                   const float* __restrict__ dm_part, float* __restrict__ dctx,
                   float* __restrict__ row, float* __restrict__ dwo_part, int C, int ranges,
                   bool bf16) {
  __shared__ float ctx_s[kDh][kDh + 1];
  __shared__ float dm_s[kDh][kKC + 1];   // dM_h[d][c0 + c]
  __shared__ float wo_s[kDh][kKC + 1];   // W_out[h*32 + e][c0 + c]
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int d = tid >> 3, c4 = (tid & 7) * 4;
  const float* st = stats + ((long long)b * kHeads + h) * kStats;
  for (int i = tid; i < kDh * kDh; i += kThreads) ctx_s[i / kDh][i % kDh] = st[i];
  float dc[4] = {0.f, 0.f, 0.f, 0.f};  // dctx[d][c4 + k] / 32^-1/2
  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();  // the previous slice is read
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + c4 + k;
      float s = 0.f;
      if (c < C)
        for (int r = 0; r < ranges; ++r)  // in order
          s += dm_part[(((long long)b * ranges + r) * kH + h * kDh + d) * C + c];
      dm_s[d][c4 + k] = s;
      const float wo = c < C ? w_out[(long long)(h * kDh + d) * C + c] : 0.f;
      wo_s[d][c4 + k] = bf16 ? round_bf16(wo) : wo;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      for (int c = 0; c < kKC; ++c) dc[k] = fmaf(dm_s[d][c], wo_s[c4 + k][c], dc[k]);
    // this row's share of dW_out,h[e, c] = 32^-1/2 sum_d ctx[d, e] dM_h[d, c], e = d here
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + c4 + k;
      if (c >= C) continue;
      float s = 0.f;
      for (int dd = 0; dd < kDh; ++dd) {
        const float cx = ctx_s[dd][d];
        s = fmaf(bf16 ? round_bf16(cx) : cx, dm_s[dd][c4 + k], s);
      }
      dwo_part[((long long)b * kH + h * kDh + d) * C + c] = s * kQScale;
    }
  }
  __syncthreads();
  float* dch = dctx + ((long long)b * kHeads + h) * kDh * kDh;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dc[k] *= kQScale;
    dch[d * kDh + c4 + k] = dc[k];
    dm_s[d][c4 + k] = dc[k];  // dctx, for row
  }
  __syncthreads();
  if (tid < kDh) {
    float acc = 0.f;
    for (int e = 0; e < kDh; ++e) acc = fmaf(dm_s[tid][e], ctx_s[tid][e], acc);
    row[(long long)b * kH + h * kDh + tid] = acc;
  }
}

// Pass 3.
template <typename T, bool kTc>
__global__ void __launch_bounds__(kThreads, 1)
lab_bwd_kv_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, const float* __restrict__ w_qkv,
                  const float* __restrict__ M, const float* __restrict__ stats,
                  const float* __restrict__ dctx, const float* __restrict__ row_g,
                  T* __restrict__ dx, float* __restrict__ dw_part, float* __restrict__ dg_part,
                  float* __restrict__ dxl_all, int N, int C, float eps, bool block,
                  Ranges plan) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);  // [kT][kLdS]   q|k|v -> P|K'|vn -> dA|dk|dv
  float* u = s + kT * kLdS;                    // ws [kKC][kLdQ] | ms [kH][kLdMt] |
                                               // wt [kKC][kLdWt] | red [kWarps][kT][kLdRed] |
                                               // [kThreads][kLdSlot] dW partial slots
  float* dcs = u + kH * kLdMt;                 // [kHeads * kDh][kLdDc] dctx of this row
  float* xs = dcs + kH * kLdDc;                // [kT][kLdXB]  x-ln slice
  float* dys = xs + kT * kLdXB;                // [kT][kLdX]   dy slice
  float* mz = dys + kT * kLdX;                 // [2][kH]      k-softmax max, normaliser
  float* rowv = mz + 2 * kH;                   // [kH]
  float* mr = rowv + kH;                       // [kT][2]
  float* dcz = mr + 2 * kT;                    // bf16: [kHeads * kDh][kLdDc] dctx / z
  const int b = blockIdx.y, r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const T* xb = x + (long long)b * N * C;
  const T* dyb = dy + (long long)b * N * C;
  const float* Mb = M + (long long)b * kH * C;
  const float* gam = block ? gamma : nullptr;
  const long long blk = (long long)b * plan.ranges + r;
  float* dwp = dw_part + blk * padded(C) * kQKV;  // this block's dW_qkv partial (step 5)
  float* dxl = dxl_all + blk * kT * C;    // this block's dxln of the current tile, [kT][C]

  stage<kH, kDh>(dcs, kLdDc, dctx + (long long)b * kHeads * kDh * kDh, kDh, kH, kDh);
  for (int j = tid; j < kH; j += kThreads) {
    const float* st = stats + ((long long)b * kHeads + j / kDh) * kStats + kDh * kDh;
    mz[j] = st[j % kDh];
    mz[kH + j] = st[kDh + j % kDh];
    rowv[j] = row_g[(long long)b * kH + j];
  }
  if constexpr (kTc) {  // dctx / z by rows, the B of dv = exp(k - m) (dctx / z) / N
    __syncthreads();
    for (int i = tid; i < kH * kDh; i += kThreads)
      dcz[i / kDh * kLdDc + i % kDh] = dcs[i / kDh * kLdDc + i % kDh] / mz[kH + i / kDh];
  }
  float dg[4] = {0.f, 0.f, 0.f, 0.f};  // dgamma of columns tid + 256 k
  for (int tile = plan.begin(r); tile < plan.begin(r + 1); ++tile) {
    const int n0 = tile * kT, rows = min(kT, N - n0);
    const bool first = tile == plan.begin(r);
    __syncthreads();  // the previous tile is done with s, u, xs and mr
    if (C <= kKC)  // the tile's x-ln in one pass, for steps 1 and 5
      stage_ln_tile(xs, kLdXB, xb, mr, gam, n0, rows, C, eps, block);
    else
      row_stats(mr, xb, n0, rows, C, eps, block);
    // 1. q, k, v of head w (warp w), one section at a time. s holds P, K'
    // and vn; on bf16 x exp(k - m) and v, which the products round as the
    // forward's did
    for (int sec = 0; sec < 3; ++sec) {
      float a[4][8];
      q_projection<T, kTc>(a, xs, kLdXB, u, xb, mr, gam, w_qkv + sec * kH, n0, rows, C, true);
      if (sec == 0) row_softmax(a);  // P
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = row<kTc, false>(lane, i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jj = w * kDh + col<kTc, true>(lane, j);
          float v = a[i][j];
          if (sec == 1) v = kTc ? expf(v - mz[jj]) : expf(v - mz[jj]) / mz[kH + jj];  // K'
          if (sec == 2 && !kTc) v = v / (float)N;                                   // vn
          s[t * kLdS + sec * kH + jj] = v;
        }
      }
    }
    // 2. dP = dy M^T (warp w: head w's columns), then dA
    float dp[4][8];
    zero(dp);
    for (int c0 = 0; c0 < C; c0 += kKC) {
      __syncthreads();
      stage<kT, kKC>(dys, kLdX, dyb + (long long)n0 * C + c0, C, rows, C - c0);
      stage<kH, kKC>(u, kLdMt, Mb + c0, C, kH, C - c0);
      __syncthreads();
      warp_gemm<kTc, false, false, kSplitB>(dp, dys, kLdX, u + w * kDh * kLdMt, kLdMt, kKC);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = row<kTc, false>(lane, i);
      float p[8], pd[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[j] = s[t * kLdS + w * kDh + col<kTc, false>(lane, j)];
        pd[j] = p[j] * dp[i][j];
      }
      const float sum = row_sum(pd);
#pragma unroll
      for (int j = 0; j < 8; ++j)  // M carries the q scale: dP is the unscaled softmax's
        s[t * kLdS + w * kDh + col<kTc, false>(lane, j)] =
            t < rows ? p[j] * (dp[i][j] - sum) : 0.f;
    }
    // 3. dK' = vn dctx^T and dvn = K' dctx within head w, then dk and dv
    __syncwarp();
    float dk[4][8], dv[4][8];
    zero(dk);
    zero(dv);
    warp_gemm<kTc, false, false, kSplitB>(dk, s + 2 * kH + w * kDh, kLdS,
                                          dcs + w * kDh * kLdDc, kLdDc, kDh);
    warp_gemm<kTc, false, true, kSplitB>(dv, s + kH + w * kDh, kLdS,
                                         (kTc ? dcz : dcs) + w * kDh * kLdDc, kLdDc, kDh);
    __syncwarp();  // every lane has read K' and vn
    // each lane reads K' and writes dk at its own (t, d) only
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = row<kTc, false>(lane, i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int jd = w * kDh + col<kTc, false>(lane, j);  // d of dk
        const int je = w * kDh + col<kTc, true>(lane, j);   // e of dv
        float kp = s[t * kLdS + kH + jd];
        if constexpr (kTc) kp /= mz[kH + jd], dk[i][j] /= (float)N;  // K'; v dctx^T / N
        s[t * kLdS + kH + jd] = t < rows ? kp * (dk[i][j] - rowv[jd]) : 0.f;
        s[t * kLdS + 2 * kH + je] = t < rows ? dv[i][j] / (float)N : 0.f;
      }
    }
    // 4. dxln = [dA dk dv] W_qkv^T, 32 channels at a time, into dxl
    for (int c0 = 0; c0 < C; c0 += kKC) {
      float o[4][8];
      zero(o);
      for (int sec = 0; sec < 3; ++sec) {
        __syncthreads();  // s is complete; u is read
        stage<kKC, kH>(u, kLdWt, w_qkv + (long long)c0 * kQKV + sec * kH, kQKV, C - c0, kH);
        __syncthreads();
        warp_gemm<kTc, false, false, kSplitA>(o, s + sec * kH + w * kDh, kLdS, u + w * kDh,
                                              kLdWt, kDh);
      }
      __syncthreads();  // u is read; red takes its place
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          u[(w * kT + row<kTc, false>(lane, i)) * kLdRed + col<kTc, false>(lane, j)] = o[i][j];
      __syncthreads();
      for (int i = tid; i < kT * kKC; i += kThreads) {
        const int t = i / kKC, c = i % kKC;
        if (t >= rows || c0 + c >= C) continue;
        float acc = 0.f;
#pragma unroll
        for (int h = 0; h < kWarps; ++h) acc += u[(h * kT + t) * kLdRed + c];  // in order
        dxl[t * C + c0 + c] = acc;
      }
    }
    // 5. this block's dW_qkv[c, j] += sum_t x-ln[t, c] [dA dk dv][t, j], kept in
    // the warp tiles' own order (each lane 32 contiguous floats: 32-channel
    // tile, 32-column tile of the 768, lane, element), so that the update
    // of the partial moves whole lines; lab_bwd_reduce puts it in place.
    // Each lane copies its next 32 partial values into its own slot of u
    // (cp.async) while it computes and stores the current ones.
    float* slot = u + (w * 32 + lane) * kLdSlot;
    auto fetch = [&](int c0, int sec) {  // this lane's partial values of (c0, sec)
      const float* from =
          dwp + (((long long)(c0 / kKC) * (kQKV / 32) + sec * kHeads + w) * 32 + lane) * 32;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(slot + 4 * q))),
                        "l"(from + 4 * q));
    };
    __syncthreads();  // u is no longer read by step 4
    if (!first) fetch(0, 0);
    for (int c0 = 0; c0 < C; c0 += kKC) {
      if (C > kKC) {  // else xs still holds the tile's x-ln
        __syncthreads();
        stage_xln(xs, kLdXB, xb, mr, gam, n0, rows, c0, C);
        __syncthreads();
      }
      for (int sec = 0; sec < 3; ++sec) {
        float4 old[8];
        if (!first) {
          asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
          for (int q = 0; q < 8; ++q) old[q] = *reinterpret_cast<const float4*>(slot + 4 * q);
          if (sec < 2) fetch(c0, sec + 1);
          else if (c0 + kKC < C) fetch(c0 + kKC, 0);
        }
        float g[4][8];
        zero(g);
        warp_gemm<kTc, true, true, kSplitA>(g, s + sec * kH + w * kDh, kLdS, xs, kLdXB, kT);
        if (!first) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            float* gq = &g[q >> 1][(q & 1) * 4];
            gq[0] += old[q].x, gq[1] += old[q].y, gq[2] += old[q].z, gq[3] += old[q].w;
          }
        }
        float4* at = reinterpret_cast<float4*>(
            dwp + (((long long)(c0 / kKC) * (kQKV / 32) + sec * kHeads + w) * 32 + lane) * 32);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float* gq = &g[q >> 1][(q & 1) * 4];
          at[q] = make_float4(gq[0], gq[1], gq[2], gq[3]);
        }
      }
    }
    // 6. dx: the LayerNorm VJP of dxln plus dy (K1), or dxln (K3); dgamma.
    // Loads are gathered before they are used, so that they overlap.
    __syncthreads();  // dxl is written
    const long long tok0 = (long long)b * N + n0;  // the tile's first token
    if (!block) {
      for (int i0 = 0; i0 < rows * C; i0 += 4 * kThreads) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + tid + k * kThreads;
          v[k] = i < rows * C ? dxl[i] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + tid + k * kThreads;
          if (i < rows * C) dx[tok0 * C + i] = from_f32<T>(v[k]);
        }
      }
      continue;
    }
    {  // warp w: tokens w + 8 k, k < 4
      bool on[kRowsPerWarp];
      float mu[kRowsPerWarp], rstd[kRowsPerWarp], s1[kRowsPerWarp], s2[kRowsPerWarp];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int t = w + kWarps * k;
        on[k] = t < rows;
        mu[k] = mr[2 * t], rstd[k] = mr[2 * t + 1], s1[k] = 0.f, s2[k] = 0.f;
      }
      const float* du0 = dxl + w * C;
      const T* xr0 = xb + (long long)(n0 + w) * C;
      const T* dyr0 = dyb + (long long)(n0 + w) * C;
      const long long step = (long long)kWarps * C;
      for (int c = lane; c < C; c += 32) {
        float du[kRowsPerWarp], xv[kRowsPerWarp];
        const float gc = gamma[c];
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          du[k] = on[k] ? du0[k * kWarps * C + c] : 0.f;
          xv[k] = on[k] ? to_f32(xr0[k * step + c]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          const float g = du[k] * gc;
          s1[k] += g;
          s2[k] = fmaf(g, (xv[k] - mu[k]) * rstd[k], s2[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        s1[k] = pidm::warp_sum(s1[k]) / C;
        s2[k] = pidm::warp_sum(s2[k]) / C;
      }
      for (int c = lane; c < C; c += 32) {
        float du[kRowsPerWarp], xv[kRowsPerWarp], dyv[kRowsPerWarp];
        const float gc = gamma[c];
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          du[k] = on[k] ? du0[k * kWarps * C + c] : 0.f;
          xv[k] = on[k] ? to_f32(xr0[k * step + c]) : 0.f;
          dyv[k] = on[k] ? to_f32(dyr0[k * step + c]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          const float xhat = (xv[k] - mu[k]) * rstd[k];
          if (on[k])
            dx[(tok0 + w + kWarps * k) * C + c] =
                from_f32<T>(rstd[k] * (du[k] * gc - s1[k] - xhat * s2[k]) + dyv[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // dgamma of column c, over the tile's tokens in order
      const int c = tid + k * kThreads;
      if (c >= C) break;
      for (int t0 = 0; t0 < rows; t0 += 8) {
        float du[8], xv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int t = t0 + u;
          du[u] = t < rows ? dxl[t * C + c] : 0.f;
          xv[u] = t < rows ? to_f32(xb[(long long)(n0 + t) * C + c]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int t = t0 + u;
          if (t < rows) dg[k] = fmaf(du[u], (xv[u] - mr[2 * t]) * mr[2 * t + 1], dg[k]);
        }
      }
    }
  }
  if (block)
    for (int k = 0; k < 4 && tid + k * kThreads < C; ++k)
      dg_part[blk * C + tid + k * kThreads] = dg[k];
}

// Pass 4: each output element sums its partials in block order:
// dW_qkv over the n_blk blocks of pass 3 (its partials in the warp tiles'
// order of pass 3's step 5, put back in place here), dW_out [256, C] over
// the B rows, and (K1) db_out over pass 1's and dgamma over pass 3's.
template <bool kTc>
__global__ void __launch_bounds__(kThreads)
lab_bwd_reduce_kernel(const float* __restrict__ dw_part, const float* __restrict__ dwo_part,
                      const float* __restrict__ db_part, const float* __restrict__ dg_part,
                      float* __restrict__ dw_qkv, float* __restrict__ dw_out,
                      float* __restrict__ db_out, float* __restrict__ dgamma, int B, int C,
                      int n_blk, bool block) {
  const long long e_w = (long long)padded(C) * kQKV, e_o = (long long)kH * C;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float* src;
  float* dst;
  long long stride;
  int n;
  if (i < e_w) {
    // i = ((c tile * 24 + j tile) * 32 + lane) * 32 + 8 * row slot + column slot
    const int lane = (int)(i >> 5) & 31, v = (int)i & 31;
    const long long tile = i >> 10;
    const int c = (int)(tile / (kQKV / 32)) * kKC + col<kTc, true>(lane, v & 7);
    const int j = (int)(tile % (kQKV / 32)) * 32 + row<kTc, true>(lane, v >> 3);
    if (c >= C) return;
    src = dw_part + i, dst = dw_qkv + (long long)c * kQKV + j, stride = e_w, n = n_blk;
  } else if ((i -= e_w) < e_o) {
    src = dwo_part + i, dst = dw_out + i, stride = e_o, n = B;
  } else if (!block) {
    return;
  } else if ((i -= e_o) < C) {
    src = db_part + i, dst = db_out + i, stride = C, n = n_blk;
  } else if ((i -= C) < C) {
    src = dg_part + i, dst = dgamma + i, stride = C, n = n_blk;
  } else {
    return;
  }
  float acc = 0.f;
  for (int p = 0; p < n; ++p) acc += src[p * stride];
  *dst = acc;
}

constexpr size_t kSmemQ = (kKC * kLdQ + kT * kLdPT + kT * kLdDy + kT * kLdX + 2 * kT) * sizeof(float);
constexpr int kUnion = kH * kLdMt;  // the largest of ws, ms, wt and red
static_assert(kKC * kLdQ <= kUnion && kKC * kLdWt <= kUnion && kWarps * kT * kLdRed <= kUnion &&
                  kThreads * kLdSlot <= kUnion,
              "pass 3's union region");
template <bool kTc>
constexpr size_t kSmemKV = (kT * kLdS + kUnion + (kTc ? 2 : 1) * kH * kLdDc + kT * kLdXB +
                            kT * kLdX + 3 * kH + 2 * kT) * sizeof(float);

template <typename T, bool kTc>
int typed_backward(const void* x, const void* dy, const void* gamma, const void* w_qkv,
                   const void* w_out, const void* M, const void* stats, void* dx, void* dgamma,
                   void* dw_qkv, void* dw_out, void* db_out, void* work, int B, int N, int C,
                   float eps, bool block, cudaStream_t st) {
  const Plan w = make_plan(B, N, C);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* g = static_cast<const float*>(gamma);
  const float* wqkv = static_cast<const float*>(w_qkv);
  const float* stf = static_cast<const float*>(stats);
  float* ws = static_cast<float*>(work);

  cudaError_t err = allow_smem(lab_bwd_q_kernel<T, kTc>, kSmemQ);
  if (err == cudaSuccess) err = allow_smem(lab_bwd_kv_kernel<T, kTc>, kSmemKV<kTc>);
  if (err != cudaSuccess) return (int)err;

  lab_bwd_q_kernel<T, kTc><<<dim3(w.rg.ranges, B, (C + kCG - 1) / kCG), kThreads, kSmemQ, st>>>(
      xt, dyt, g, wqkv, ws + w.dm_part, ws + w.db_part, N, C, eps, block, w.rg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lab_bwd_ctx_kernel<<<dim3(kHeads, B), kThreads, 0, st>>>(
      stf, static_cast<const float*>(w_out), ws + w.dm_part, ws + w.dctx, ws + w.row,
      ws + w.dwo_part, C, w.rg.ranges, kTc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lab_bwd_kv_kernel<T, kTc><<<dim3(w.rg.ranges, B), kThreads, kSmemKV<kTc>, st>>>(
      xt, dyt, g, wqkv, static_cast<const float*>(M), stf, ws + w.dctx, ws + w.row,
      static_cast<T*>(dx), ws + w.dw_part, ws + w.dg_part, ws + w.dxl, N, C, eps, block, w.rg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = (long long)padded(C) * kQKV + (long long)kH * C + (block ? 2 * C : 0);
  lab_bwd_reduce_kernel<kTc><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      ws + w.dw_part, ws + w.dwo_part, ws + w.db_part, ws + w.dg_part,
      static_cast<float*>(dw_qkv), static_cast<float*>(dw_out), static_cast<float*>(db_out),
      static_cast<float*>(dgamma), B, C, w.n_blk, block);
  return (int)cudaGetLastError();
}

int backward(const void* x, const void* dy, const void* gamma, const void* w_qkv,
             const void* w_out, const void* M, const void* stats, void* dx, void* dgamma,
             void* dw_qkv, void* dw_out, void* db_out, void* work, int B, int N, int C,
             float eps, bool block, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return typed_backward<__nv_bfloat16, true>(x, dy, gamma, w_qkv, w_out, M, stats, dx, dgamma,
                                               dw_qkv, dw_out, db_out, work, B, N, C, eps, block,
                                               st);
  return typed_backward<float, false>(x, dy, gamma, w_qkv, w_out, M, stats, dx, dgamma, dw_qkv,
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
// dw_qkv: [C, 768]; w_out, dw_out: [256, C]; M and stats as K3's forward
// wrote them; work: the workspace of
// pidm_linear_attention_block_bwd_workspace. Launches on `stream`,
// allocates nothing, returns the CUDA error.
extern "C" int pidm_linear_attention_bwd(const void* x, const void* dy, const void* w_qkv,
                                         const void* w_out, const void* M, const void* stats,
                                         void* dx, void* dw_qkv, void* dw_out, void* work,
                                         int B, int N, int C, int bf16, void* stream) {
  return backward(x, dy, nullptr, w_qkv, w_out, M, stats, dx, nullptr, dw_qkv, dw_out,
                  nullptr, work, B, N, C, 0.f, false, bf16, stream);
}
