// K1: the fused pre-norm linear-attention block, out = x + b_out + LA(LN(x)),
// on a token-major [B, N, C] activation, 8 heads x 32 dims; and, as a mode
// of the same two passes, K3: the linear attention alone, out = LA(x).
//
// K1 replaces physicsinformeddiffusionmodels_tpu/ops/pallas_attention.py
// `_lab_fwd_kernel` (launched by `_lab_fwd_call` through pl.pallas_call),
// the forward of `linear_attention_block`. K3 (`block` false: no LN, no
// b_out, no residual) replaces `_fwd_kernel` of the same file (launched by
// `_fwd_call`), the forward of `linear_attention`. Per token, LN over C (biased
// variance, eps, scale only); qkv = LN(x) W_qkv with H = 256 hidden; q is
// softmaxed over the head's 32 dims and scaled by 32^-1/2; k is softmaxed
// over the tokens; v is divided by N; ctx_h = K'^T v ([32, 32] per head);
// out = x + b_out + sum_h (ctx_h W_out,h)^T q~_h.
//
// Bound on the H100: operations. At the Darcy shapes the qkv and output
// projections do 2*C*(768 + 256) flops per token against 8*C bytes of
// activation traffic (256 flop/byte), well above the fp32 balance of ~20,
// and the flops run on the CUDA cores in full fp32 (no tensor cores: the
// fp32 sampling path must not round to TF32).
//
// The TPU kernel walked one batch row per grid step and carried the running
// max, normaliser and context across token tiles in VMEM, with a [H, N]
// scratch of the q softmax. A CUDA grid has no order, and that scratch would
// be 256 MB at N = 4096, B = 64, so this design takes two launches:
//   A. lab_ctx: grid (heads, B). Each block streams its row's tokens in
//      tiles of 32: it recomputes LN, forms this head's k and v, and keeps
//      the running max and normaliser (one per k dim) and the 32x32 context
//      in registers and shared memory (flash-style rescaling). It then folds
//      the normalised context into M_h = 32^-1/2 ctx_h W_out,h, written to a
//      [B, 256, C] fp32 scratch the caller allocates. The block also writes
//      its normalised context and the k softmax's max and normaliser to a
//      `stats` buffer, [B, 8, 32*32 + 2*32] fp32, for the backward
//      (linear_attention_bwd.cu) to reuse instead of streaming the tokens
//      again (2.2 MB at B = 64, written on every call).
//   B. lab_out: grid (token tiles of 16, B). Each block recomputes LN and
//      the q softmax for its tokens (one warp per head, so the softmax over
//      32 dims is a warp shuffle) and writes x + b_out + P M.
// Sums run in a fixed order, with no atomics, so results repeat exactly.
// Any N is handled (the ragged last tile is masked); C up to 1024. K3 runs
// the same passes and saves the same stats; only the LN and the epilogue
// differ, so the two kernels are held against each other on the card
// (K1(x) = x + b_out + K3(LN(x))).

#include <math.h>

#include "common.cuh"

namespace {

using pidm::from_f32;
using pidm::load_tile;
using pidm::ln_rows;
using pidm::to_f32;

constexpr int kThreads = 256;
constexpr int kDh = 32;                // dims per head
constexpr int kHeads = 8;
constexpr int kH = kHeads * kDh;       // hidden width, one thread per q column
constexpr int kTileA = 32;             // tokens per tile in pass A
constexpr int kTileB = 16;             // tokens per block in pass B
constexpr float kQScale = 0.17677669529663687f;  // 32^-1/2
static_assert(kH == kThreads, "pass B maps one thread to each hidden column");

template <typename T>
__global__ void __launch_bounds__(kThreads)
lab_ctx_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ w_qkv, const float* __restrict__ w_out,
               float* __restrict__ M, float* __restrict__ stats, int N, int C, float eps,
               bool block) {
  extern __shared__ float sm[];
  float* xs = sm;                       // [kTileA, C]   LN'd (K1) or raw (K3) tokens
  float* ks = xs + kTileA * C;          // [kTileA, kDh] k, then exp(k - m)
  float* vs = ks + kTileA * kDh;        // [kTileA, kDh] v
  float* alpha = vs + kTileA * kDh;     // [kDh] rescale of this tile, then z
  float* ctx_s = alpha + kDh;           // [kDh, kDh]    normalised context
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* xb = x + (long long)b * N * C;

  // projection: thread -> one of the 64 k/v columns of this head, and every
  // fourth token of the tile
  const int col = tid & 63, grp = tid >> 6;
  const int wcol = col < kDh ? kH + h * kDh + col : 2 * kH + h * kDh + (col - kDh);
  float ctx[kDh * kDh / kThreads] = {};  // entries tid + k * kThreads of [d, e]
  float m_run = -INFINITY, z_run = 0.f;  // per k dim d = tid, in threads tid < kDh

  for (int n0 = 0; n0 < N; n0 += kTileA) {
    const int rows = min(kTileA, N - n0);
    __syncthreads();  // the previous tile is no longer read
    load_tile(xs, xb, n0, kTileA, N, C);
    __syncthreads();
    if (block) ln_rows(xs, rows, C, gamma, eps);  // K3 reads the tokens as they are
    __syncthreads();
    for (int r = grp; r < rows; r += kThreads / 64) {
      const float* xr = xs + r * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc = fmaf(xr[c], w_qkv[(long long)c * 3 * kH + wcol], acc);
      if (col < kDh) ks[r * kDh + col] = acc;
      else vs[r * kDh + col - kDh] = acc;
    }
    __syncthreads();
    if (tid < kDh) {  // streamed token softmax of k, per dim
      float mx = m_run;
      for (int r = 0; r < rows; ++r) mx = fmaxf(mx, ks[r * kDh + tid]);
      const float a = expf(m_run - mx);  // 0 on the first tile
      float zs = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float e = expf(ks[r * kDh + tid] - mx);
        ks[r * kDh + tid] = e;
        zs += e;
      }
      z_run = z_run * a + zs;
      m_run = mx;
      alpha[tid] = a;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDh * kDh / kThreads; ++k) {
      const int idx = tid + k * kThreads, d = idx / kDh, e = idx % kDh;
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc = fmaf(ks[r * kDh + d], vs[r * kDh + e], acc);
      ctx[k] = ctx[k] * alpha[d] + acc;
    }
  }

  __syncthreads();
  if (tid < kDh) alpha[tid] = z_run;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kDh * kDh / kThreads; ++k) {
    const int idx = tid + k * kThreads;
    ctx_s[idx] = ctx[k] / (alpha[idx / kDh] * (float)N);
  }
  __syncthreads();
  // stats of (b, h): [ctx (32 x 32), m (32), z (32)]
  float* st = stats + ((long long)b * kHeads + h) * (kDh * kDh + 2 * kDh);
  for (int i = tid; i < kDh * kDh; i += kThreads) st[i] = ctx_s[i];
  if (tid < kDh) {
    st[kDh * kDh + tid] = m_run;
    st[kDh * kDh + kDh + tid] = z_run;
  }
  // M[b, h*32 + d, c] = 32^-1/2 * sum_e ctx[d, e] W_out[h*32 + e, c]
  float* Mb = M + (long long)b * kH * C;
  for (int i = tid; i < kDh * C; i += kThreads) {
    const int d = i / C, c = i % C;
    float acc = 0.f;
    for (int e = 0; e < kDh; ++e)
      acc = fmaf(ctx_s[d * kDh + e], w_out[(long long)(h * kDh + e) * C + c], acc);
    Mb[(long long)(h * kDh + d) * C + c] = acc * kQScale;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lab_out_kernel(const T* __restrict__ x, T* __restrict__ out,
               const float* __restrict__ gamma, const float* __restrict__ w_qkv,
               const float* __restrict__ M, const float* __restrict__ b_out, int N, int C,
               float eps, bool block) {
  extern __shared__ float sm[];
  float* xs = sm;                  // [kTileB, C]  LN'd (K1) or raw (K3) tokens
  float* ps = xs + kTileB * C;     // [kTileB, kH] q softmax
  const int b = blockIdx.y, n0 = blockIdx.x * kTileB, tid = threadIdx.x;
  const int rows = min(kTileB, N - n0);
  const T* xb = x + (long long)b * N * C;

  load_tile(xs, xb, n0, kTileB, N, C);
  __syncthreads();
  if (block) ln_rows(xs, rows, C, gamma, eps);  // K3 reads the tokens as they are
  __syncthreads();

  float q[kTileB];
#pragma unroll
  for (int r = 0; r < kTileB; ++r) q[r] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float w = w_qkv[(long long)c * 3 * kH + tid];
#pragma unroll
    for (int r = 0; r < kTileB; ++r) q[r] = fmaf(xs[r * C + c], w, q[r]);
  }
  // warp w holds head w: softmax over its 32 lanes
#pragma unroll
  for (int r = 0; r < kTileB; ++r) {
    const float e = expf(q[r] - pidm::warp_max(q[r]));
    ps[r * kH + tid] = e / pidm::warp_sum(e);
  }
  __syncthreads();

  const float* Mb = M + (long long)b * kH * C;
  const long long base = (long long)b * N * C + (long long)n0 * C;
  for (int i = tid; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    float acc = 0.f;
    for (int j = 0; j < kH; ++j) acc = fmaf(ps[r * kH + j], Mb[(long long)j * C + c], acc);
    if (block)
      out[base + i] = from_f32<T>(acc + b_out[c] + to_f32(x[base + i]));
    else
      out[base + i] = from_f32<T>(acc);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch(const void* x, void* out, const void* gamma, const void* w_qkv,
           const void* w_out, const void* b_out, void* M, void* stats, int B, int N, int C,
           float eps, bool block, cudaStream_t stream) {
  const size_t smem_a = (kTileA * C + 2 * kTileA * kDh + kDh + kDh * kDh) * sizeof(float);
  const size_t smem_b = (kTileB * C + kTileB * kH) * sizeof(float);
  cudaError_t err = allow_smem(lab_ctx_kernel<T>, smem_a);
  if (err == cudaSuccess) err = allow_smem(lab_out_kernel<T>, smem_b);
  if (err != cudaSuccess) return (int)err;
  lab_ctx_kernel<T><<<dim3(kHeads, B), kThreads, smem_a, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(w_qkv), static_cast<const float*>(w_out),
      static_cast<float*>(M), static_cast<float*>(stats), N, C, eps, block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lab_out_kernel<T><<<dim3((N + kTileB - 1) / kTileB, B), kThreads, smem_b, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(gamma),
      static_cast<const float*>(w_qkv), static_cast<const float*>(M),
      static_cast<const float*>(b_out), N, C, eps, block);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [B, N, C] fp32 (bf16 when `bf16` is 1); gamma, b_out: [C] fp32;
// w_qkv: [C, 768] fp32; w_out: [256, C] fp32; M: [B, 256, C] fp32 scratch;
// stats: [B, 8, 1088] fp32 (see pass A). Launches on `stream`,
// allocates nothing, returns the CUDA error.
extern "C" int pidm_linear_attention_block(const void* x, void* out, const void* gamma,
                                           const void* w_qkv, const void* w_out,
                                           const void* b_out, void* M, void* stats, int B,
                                           int N, int C, float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, out, gamma, w_qkv, w_out, b_out, M, stats, B, N, C, eps,
                                 true, st);
  return launch<float>(x, out, gamma, w_qkv, w_out, b_out, M, stats, B, N, C, eps, true, st);
}

// K3, out = LA(x): the arguments of pidm_linear_attention_block without
// gamma, b_out and eps. M and stats are written as K1 writes them.
extern "C" int pidm_linear_attention(const void* x, void* out, const void* w_qkv,
                                     const void* w_out, void* M, void* stats, int B, int N,
                                     int C, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, out, nullptr, w_qkv, w_out, nullptr, M, stats, B, N, C,
                                 0.f, false, st);
  return launch<float>(x, out, nullptr, w_qkv, w_out, nullptr, M, stats, B, N, C, 0.f, false,
                       st);
}
