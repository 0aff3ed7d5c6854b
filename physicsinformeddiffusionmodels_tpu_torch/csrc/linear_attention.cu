// K1: the fused pre-norm linear-attention block, out = x + b_out + LA(LN(x)),
// on a token-major [B, N, C] activation, 8 heads x 32 dims; and, as a mode
// of the same launches, K3: the linear attention alone, out = LA(x).
//
// K1 replaces physicsinformeddiffusionmodels_tpu/ops/pallas_attention.py
// `_lab_fwd_kernel` (launched by `_lab_fwd_call` through pl.pallas_call),
// the forward of `linear_attention_block`. K3 (`block` false: no LN, no
// b_out, no residual) replaces `_fwd_kernel` of the same file (launched by
// `_fwd_call`), the forward of `linear_attention`. Per token, LN over C (biased
// variance, eps, scale only); qkv = LN(x) W_qkv with H = 256 hidden; q is
// softmaxed over the head's 32 dims and scaled by 32^-1/2; k is softmaxed
// over the tokens; v is divided by N; ctx_h = K'^T v ([32, 32] per head);
// out = x + b_out + P M with P the q softmax and M = 32^-1/2 ctx W_out
// (M_h = 32^-1/2 ctx_h W_out,h, [256, C] per batch row).
//
// Bound on the H100: operations. Per token the qkv projection and P M do
// 2 C (768 + 256) flops and the context 2 * 256 * 32, against 8 C bytes of
// fp32 activation (about 256 flops a byte at C = 32), far above the card's
// balance. fp32 x multiplies in full fp32 on the CUDA cores (no TF32: the
// fp32 sampling path is held to 1e-4); bf16 x on the tensor cores in bf16
// (la_tile.cuh), each product's operands rounded to bf16 where the TPU
// kernel's `_mm`/`_dg` round them: x-ln and W_qkv, exp(k - m) and v, ctx and
// W_out (in the merge), and P, with fp32 sums. M, which the TPU kernel also
// rounds, enters P M as a bf16 pair (about 16 bits): it multiplies every
// token of its row, so a bf16 rounding of it that falls the other way in
// the plain version, on fp32 noise, moves a whole row's output by a bf16
// step (2 of them at B = 64, past the card's bf16 tolerance).
//
// The TPU kernel walked one batch row per grid step, carried the running
// max, normaliser and context across token tiles in VMEM, and kept a [H, N]
// scratch of the q softmax. Here three launches, each with about a block
// an SM at B = 64 (128 blocks), and every product a register-tiled warp
// product on operands in shared memory (la_tile.cuh):
//   a. lab_fwd_chunk: grid (token ranges, B). A block walks its range in
//      32-token tiles: the LayerNorm once per token, the k|v projection of
//      all 8 heads as one [32, C] x [C, 512] product (W staged in 32-channel
//      slices; kept for the whole range when C <= 32), the streamed token
//      softmax of k (running max and normaliser per k column, flash
//      rescale) and the unnormalised context of each head in registers. It
//      writes its range's per-column max and normaliser and the 8 [32, 32]
//      contexts to a small scratch (`work`, 8704 floats a block).
//   b. lab_fwd_merge: grid (heads, B). Folds the ranges of a row in order
//      (rescaled by exp(m_range - m)), writes the normalised context, max
//      and normaliser to `stats` ([B, 8, 32*32 + 2*32] fp32, which the
//      backward reads) and M to a [B, 256, C] fp32 scratch.
//   c. lab_fwd_out: grid (token ranges, B). Per tile: the q projection
//      ([32, C] x [C, 256]), the softmax over each head's 32 dims (a warp a
//      head, two shuffles a row), then P M in 32-channel slices of the
//      output, each warp its head's share, summed over the 8 heads in a
//      fixed order, and the epilogue x + b_out (nothing in K3's mode).
// On bf16 x a fourth launch comes first:
//   0. lab_fwd_kmax: grid (token ranges, B). The k projection of the
//      block's range and each k column's max over it. The chunk pass then
//      starts every range at the row's max, so that it rounds exp(k - m)
//      to bf16 against the row's max, as the plain version does: bf16
//      rounding does not commute with the flash rescale of exp(k - m_run),
//      and a context rounded against running maxima drifts from the plain
//      version's far enough that the parameter gradients leave the card's
//      bf16 tolerance (1e-3 of their max).
// Sums run in a fixed order, with no atomics, so results repeat exactly.
// Any N is handled (the ragged last tile is masked); C up to 1024.

#include <math.h>

#include "la_tile.cuh"

namespace {

using namespace pidm::la;
using pidm::from_f32;
using pidm::to_f32;

constexpr int kDh = 32;                // dims per head
constexpr int kHeads = 8;
constexpr int kH = kHeads * kDh;       // hidden width
constexpr int kQKV = 3 * kH;
constexpr int kStats = kDh * kDh + 2 * kDh;          // ctx, m, z of one (row, head)
constexpr int kRangeFloats = 2 * kH + kHeads * kDh * kDh;  // m, z, ctx of one block's range
constexpr float kQScale = 0.17677669529663687f;      // 32^-1/2
// shared-memory leading dimensions (floats), see la_tile.cuh
constexpr int kLdX = kKC + 4;          // [t][c]  x-ln slice (A, m-major)
constexpr int kLdKV = 2 * kH + 8;      // [c][j]  W_kv slice; [t][j] k|v of a tile
constexpr int kLdQ = kH + 8;           // [c][j]  W_q slice
constexpr int kLdP = kH + 4;           // [t][j]  P (A, m-major)
constexpr int kLdM = kKC + 8;          // [j][c]  M slice (B, k-major)
constexpr int kLdRed = kKC + 1;        // [warp][t][c] per-head shares of P M

// Launch 0 (bf16 x): kmax[b, r, j] = the max of k column j over range r of
// row b.
template <typename T, bool kTc>
__global__ void __launch_bounds__(kThreads, 1)
lab_fwd_kmax_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ w_qkv, float* __restrict__ kmax, int N, int C,
                    float eps, bool block, Ranges plan) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [kKC][kLdQ] W_k slice
  float* xs = ws + kKC * kLdQ;                  // [kT][kLdX]  x-ln slice
  float* mr = xs + kT * kLdX;                   // [kT][2]
  const int b = blockIdx.y, r = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int slices = (C + kKC - 1) / kKC;
  const T* xb = x + (long long)b * N * C;
  const float* gam = block ? gamma : nullptr;

  float mx[8];  // the lane's 8 columns of head w (warp w)
#pragma unroll
  for (int j = 0; j < 8; ++j) mx[j] = -INFINITY;
  for (int tile = plan.begin(r); tile < plan.begin(r + 1); ++tile) {
    const int n0 = tile * kT, rows = min(kT, N - n0);
    __syncthreads();  // the previous tile's xs is read
    if (slices == 1)
      stage_ln_tile(xs, kLdX, xb, mr, gam, n0, rows, C, eps, block);
    else
      row_stats(mr, xb, n0, rows, C, eps, block);
    float k[4][8];
    zero(k);
    for (int s = 0; s < slices; ++s) {
      __syncthreads();
      if (slices > 1) stage_xln(xs, kLdX, xb, mr, gam, n0, rows, s * kKC, C);
      if (slices > 1 || tile == plan.begin(r))
        stage<kKC, kH>(ws, kLdQ, w_qkv + (long long)s * kKC * kQKV + kH, kQKV, C - s * kKC, kH);
      __syncthreads();
      warp_gemm<kTc, false, true>(k, xs, kLdX, ws + w * kDh, kLdQ, kKC);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (row<kTc, false>(lane, i) < rows)
#pragma unroll
        for (int j = 0; j < 8; ++j) mx[j] = fmaxf(mx[j], k[i][j]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // over the lanes of a column: those of equal lane & 3
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
    if (lane < 4)
      kmax[((long long)b * plan.ranges + r) * kH + w * kDh + col<kTc, true>(lane, j)] = mx[j];
  }
}

template <typename T, bool kTc>
__global__ void __launch_bounds__(kThreads, 1)
lab_fwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ w_qkv, const float* __restrict__ kmax,
                     float* __restrict__ part, int N, int C, float eps, bool block,
                     Ranges plan) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [kKC][kLdKV] W_kv slice
  float* kv = ws + kKC * kLdKV;                 // [kT][kLdKV]  k | v, then exp(k - m) | v
  float* xs = kv + kT * kLdKV;                  // [kT][kLdX]   x-ln slice
  float* mr = xs + kT * kLdX;                   // [kT][2]      mean, 1/std
  float* alpha = mr + 2 * kT;                   // [kH]         this tile's rescale
  const int b = blockIdx.y, r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int slices = (C + kKC - 1) / kKC;
  const T* xb = x + (long long)b * N * C;
  const float* gam = block ? gamma : nullptr;

  float ctx[4][8];  // warp w: head w's unnormalised context, rows d, columns e
  zero(ctx);
  float m_run = -INFINITY, z_run = 0.f;  // thread tid: k column tid
  if constexpr (kTc)  // bf16: the row's max (launch 0), so every rescale below is exp(0) = 1
    for (int q = 0; q < plan.ranges; ++q)
      m_run = fmaxf(m_run, kmax[((long long)b * plan.ranges + q) * kH + tid]);
  for (int tile = plan.begin(r); tile < plan.begin(r + 1); ++tile) {
    const int n0 = tile * kT, rows = min(kT, N - n0);
    __syncthreads();  // the previous tile's kv and alpha are read
    if (slices == 1)  // the tile's x-ln in one pass
      stage_ln_tile(xs, kLdX, xb, mr, gam, n0, rows, C, eps, block);
    else
      row_stats(mr, xb, n0, rows, C, eps, block);
    float acc[2][4][8];  // warp w: columns 64 w .. 64 w + 63 of k | v
    zero(acc);
    for (int s = 0; s < slices; ++s) {
      __syncthreads();  // mr is written; the previous slice is read
      if (slices > 1) stage_xln(xs, kLdX, xb, mr, gam, n0, rows, s * kKC, C);
      if (slices > 1 || tile == plan.begin(r))
        stage<kKC, 2 * kH>(ws, kLdKV, w_qkv + (long long)s * kKC * kQKV + kH, kQKV,
                           C - s * kKC, 2 * kH);
      __syncthreads();
      warp_gemm<kTc, false, true, 2>(acc, xs, kLdX, ws + w * 64, kLdKV, kKC);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kv[row<kTc, false>(lane, i) * kLdKV + w * 64 + q * 32 + col<kTc, true>(lane, j)] =
              acc[q][i][j];
    __syncthreads();
    {  // streamed token softmax of k column tid
      float mx = m_run;
      for (int t = 0; t < rows; ++t) mx = fmaxf(mx, kv[t * kLdKV + tid]);
      const float a = expf(m_run - mx);  // 0 on the first tile
      float zs = 0.f;
      for (int t = 0; t < kT; ++t) {
        const float e = t < rows ? expf(kv[t * kLdKV + tid] - mx) : 0.f;
        kv[t * kLdKV + tid] = e;
        zs += e;
      }
      z_run = z_run * a + zs;
      m_run = mx;
      alpha[tid] = a;
    }
    __syncthreads();
    // ctx_h = ctx_h * alpha[d] + exp(k_h - m)^T v_h over the tile's tokens
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha[w * kDh + row<kTc, true>(lane, i)];
#pragma unroll
      for (int j = 0; j < 8; ++j) ctx[i][j] *= a;
    }
    warp_gemm<kTc, true, true>(ctx, kv + w * kDh, kLdKV, kv + kH + w * kDh, kLdKV, kT);
  }
  float* p = part + ((long long)b * plan.ranges + r) * kRangeFloats;
  p[tid] = m_run;
  p[kH + tid] = z_run;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      p[2 * kH + (w * kDh + row<kTc, true>(lane, i)) * kDh + col<kTc, true>(lane, j)] = ctx[i][j];
}

__global__ void __launch_bounds__(kThreads)
lab_fwd_merge_kernel(const float* __restrict__ part, const float* __restrict__ w_out,
                     float* __restrict__ M, float* __restrict__ stats, int N, int C, int ranges,
                     bool bf16) {
  __shared__ float ctx_s[kDh][kDh + 1];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int d = tid >> 3, e0 = (tid & 7) * 4, j = h * kDh + d;
  float m = -INFINITY, z = 0.f, c4[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < ranges; ++r) {  // in order
    const float* p = part + ((long long)b * ranges + r) * kRangeFloats;
    const float mr = p[j], mn = fmaxf(m, mr);
    const float a = expf(m - mn), ar = expf(mr - mn);  // a = 0 for the first range
    z = z * a + p[kH + j] * ar;
#pragma unroll
    for (int k = 0; k < 4; ++k) c4[k] = c4[k] * a + p[2 * kH + j * kDh + e0 + k] * ar;
    m = mn;
  }
  // stats of (b, h): [ctx (32 x 32), m (32), z (32)]
  float* st = stats + ((long long)b * kHeads + h) * kStats;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = c4[k] / (z * (float)N);
    ctx_s[d][e0 + k] = bf16 ? round_bf16(v) : v;  // an operand of M
    st[d * kDh + e0 + k] = v;
  }
  if ((tid & 7) == 0) {
    st[kDh * kDh + d] = m;
    st[kDh * kDh + kDh + d] = z;
  }
  __syncthreads();
  // M[b, h*32 + d, c] = 32^-1/2 * sum_e ctx[d, e] W_out[h*32 + e, c] (on
  // bf16 x, both operands rounded to bf16)
  float* Mb = M + (long long)b * kH * C;
  for (int i = tid; i < kDh * C; i += kThreads) {
    const int dd = i / C, c = i % C;
    float acc = 0.f;
    for (int e = 0; e < kDh; ++e) {
      const float wo = w_out[(long long)(h * kDh + e) * C + c];
      acc = fmaf(ctx_s[dd][e], bf16 ? round_bf16(wo) : wo, acc);
    }
    Mb[(long long)(h * kDh + dd) * C + c] = acc * kQScale;
  }
}

template <typename T, bool kTc>
__global__ void __launch_bounds__(kThreads, 1)
lab_fwd_out_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ gamma,
                   const float* __restrict__ w_qkv, const float* __restrict__ M,
                   const float* __restrict__ b_out, int N, int C, float eps, bool block,
                   Ranges plan) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [kKC][kLdQ]       W_q slice
  float* ms = ws + kKC * kLdQ;                  // [kH][kLdM]        M slice
  float* ps = ms + kH * kLdM;                   // [kT][kLdP]        P
  float* red = ps + kT * kLdP;                  // [kWarps][kT][kLdRed]
  float* xs = red + kWarps * kT * kLdRed;       // [kT][kLdX]        x-ln slice
  float* mr = xs + kT * kLdX;                   // [kT][2]
  const int b = blockIdx.y, r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int slices = (C + kKC - 1) / kKC;
  const T* xb = x + (long long)b * N * C;
  const float* Mb = M + (long long)b * kH * C;
  const float* gam = block ? gamma : nullptr;

  for (int tile = plan.begin(r); tile < plan.begin(r + 1); ++tile) {
    const int n0 = tile * kT, rows = min(kT, N - n0);
    const bool first = tile == plan.begin(r);
    __syncthreads();  // the previous tile's red is read
    if (slices == 1)  // the tile's x-ln in one pass
      stage_ln_tile(xs, kLdX, xb, mr, gam, n0, rows, C, eps, block);
    else
      row_stats(mr, xb, n0, rows, C, eps, block);
    float q[4][8];  // warp w: head w's q, rows t, columns d
    zero(q);
    for (int s = 0; s < slices; ++s) {
      __syncthreads();
      if (slices > 1) stage_xln(xs, kLdX, xb, mr, gam, n0, rows, s * kKC, C);
      if (slices > 1 || first)
        stage<kKC, kH>(ws, kLdQ, w_qkv + (long long)s * kKC * kQKV, kQKV, C - s * kKC, kH);
      __syncthreads();
      warp_gemm<kTc, false, true>(q, xs, kLdX, ws + w * kDh, kLdQ, kKC);
    }
    row_softmax(q);  // P, unscaled: M carries the q scale
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ps[row<kTc, false>(lane, i) * kLdP + w * kDh + col<kTc, true>(lane, j)] = q[i][j];
    for (int s = 0; s < slices; ++s) {
      const int c0 = s * kKC;
      __syncthreads();  // red (and ms) of the previous slice are read
      if (slices > 1 || first) {
        stage<kH, kKC>(ms, kLdM, Mb + c0, C, kH, C - c0);
        __syncthreads();
      }
      // head w's share: P[:, 32w : 32w + 32] M[32w : 32w + 32, c0 : c0 + 32]
      float o[4][8];
      zero(o);
      warp_gemm<kTc, false, true, kSplitB>(o, ps + w * kDh, kLdP, ms + w * kDh * kLdM, kLdM,
                                           kDh);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          red[(w * kT + row<kTc, false>(lane, i)) * kLdRed + col<kTc, true>(lane, j)] = o[i][j];
      __syncthreads();
      constexpr int kPer = kT * kKC / kThreads;
      float bo[kPer], xv[kPer];  // b_out and x, gathered first so that the loads overlap
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * kThreads, t = i / kKC, c = i % kKC;
        const bool on = block && t < rows && c0 + c < C;
        bo[k] = on ? b_out[c0 + c] : 0.f;
        xv[k] = on ? to_f32(x[((long long)b * N + n0 + t) * C + c0 + c]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * kThreads, t = i / kKC, c = i % kKC;
        if (t >= rows || c0 + c >= C) continue;
        float acc = 0.f;
#pragma unroll
        for (int h = 0; h < kWarps; ++h) acc += red[(h * kT + t) * kLdRed + c];
        out[((long long)b * N + n0 + t) * C + c0 + c] =
            from_f32<T>(block ? acc + bo[k] + xv[k] : acc);
      }
    }
  }
}

constexpr size_t kSmemKmax = (kKC * kLdQ + kT * kLdX + 2 * kT) * sizeof(float);
constexpr size_t kSmemChunk = (kKC * kLdKV + kT * kLdKV + kT * kLdX + 2 * kT + kH) * sizeof(float);
constexpr size_t kSmemOut =
    (kKC * kLdQ + kH * kLdM + kT * kLdP + kWarps * kT * kLdRed + kT * kLdX + 2 * kT) *
    sizeof(float);

template <typename T, bool kTc>
int launch(const void* x, void* out, const void* gamma, const void* w_qkv, const void* w_out,
           const void* b_out, void* M, void* stats, void* work, int B, int N, int C, float eps,
           bool block, cudaStream_t stream) {
  const Ranges plan = make_ranges(B, N);
  cudaError_t err = allow_smem(lab_fwd_chunk_kernel<T, kTc>, kSmemChunk);
  if (err == cudaSuccess) err = allow_smem(lab_fwd_out_kernel<T, kTc>, kSmemOut);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(plan.ranges, B);
  float* part = static_cast<float*>(work);
  float* kmax = part + (long long)B * plan.ranges * kRangeFloats;
  if constexpr (kTc) {
    lab_fwd_kmax_kernel<T, kTc><<<grid, kThreads, kSmemKmax, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(w_qkv), kmax, N, C, eps, block, plan);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  lab_fwd_chunk_kernel<T, kTc><<<grid, kThreads, kSmemChunk, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(w_qkv), kmax, part, N, C, eps, block, plan);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lab_fwd_merge_kernel<<<dim3(kHeads, B), kThreads, 0, stream>>>(
      part, static_cast<const float*>(w_out), static_cast<float*>(M),
      static_cast<float*>(stats), N, C, plan.ranges, kTc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lab_fwd_out_kernel<T, kTc><<<grid, kThreads, kSmemOut, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(gamma),
      static_cast<const float*>(w_qkv), static_cast<const float*>(M),
      static_cast<const float*>(b_out), N, C, eps, block, plan);
  return (int)cudaGetLastError();
}

int forward(const void* x, void* out, const void* gamma, const void* w_qkv, const void* w_out,
            const void* b_out, void* M, void* stats, void* work, int B, int N, int C, float eps,
            bool block, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, true>(x, out, gamma, w_qkv, w_out, b_out, M, stats, work, B, N,
                                       C, eps, block, st);
  return launch<float, false>(x, out, gamma, w_qkv, w_out, b_out, M, stats, work, B, N, C, eps,
                              block, st);
}

}  // namespace

// Floats of scratch that pidm_linear_attention_block and
// pidm_linear_attention need (each block's range statistics, and on bf16 x
// its k maxima).
extern "C" long long pidm_linear_attention_block_fwd_workspace(int B, int N, int C) {
  (void)C;
  return (long long)B * make_ranges(B, N).ranges * (kRangeFloats + kH);
}

// x, out: [B, N, C] fp32 (bf16 when `bf16` is 1); gamma, b_out: [C] fp32;
// w_qkv: [C, 768] fp32; w_out: [256, C] fp32; M: [B, 256, C] fp32 scratch;
// stats: [B, 8, 1088] fp32 (see lab_fwd_merge); work: the scratch of
// pidm_linear_attention_block_fwd_workspace. Launches on `stream`, allocates
// nothing, returns the CUDA error.
extern "C" int pidm_linear_attention_block(const void* x, void* out, const void* gamma,
                                           const void* w_qkv, const void* w_out,
                                           const void* b_out, void* M, void* stats, void* work,
                                           int B, int N, int C, float eps, int bf16,
                                           void* stream) {
  return forward(x, out, gamma, w_qkv, w_out, b_out, M, stats, work, B, N, C, eps, true, bf16,
                 stream);
}

// K3, out = LA(x): the arguments of pidm_linear_attention_block without
// gamma, b_out and eps. M and stats are written as K1 writes them.
extern "C" int pidm_linear_attention(const void* x, void* out, const void* w_qkv,
                                     const void* w_out, void* M, void* stats, void* work, int B,
                                     int N, int C, int bf16, void* stream) {
  return forward(x, out, nullptr, w_qkv, w_out, nullptr, M, stats, work, B, N, C, 0.f, false,
                 bf16, stream);
}
