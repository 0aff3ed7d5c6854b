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
// the forward of `conv_gn_film_silu_cm`. The products are the TPU kernel's
// `_mmf`: in x's type with an fp32 sum (bf16 on the tensor cores; fp32 in
// full fp32, TF32 off), over its tap-major `wflat` [Co, 9 Ci].
//
// Bound on the H100: fp32 x, operations (2 Co 9 Ci flops a pixel against
// 4 (Ci + Co) bytes, 18x the card's fp32 balance at Ci = Co = 32); bf16 x,
// bytes (the flops take half the bytes' time at the bf16 tensor-core rate).
//
// Design. The TPU kernel holds a row's z in VMEM (`body1`, `body2`, :145-
// 183); a row's fp32 z (512 KB at level 0) is more than a block's shared
// memory, so here one thread-block cluster of k blocks holds a batch row
// (grid (k, B), one launch): block q computes the conv tiles q, q + k, ...
// of its row (conv_tile.cuh, x staged once with its halo), writes a tile's
// z (conv + bias) once from its accumulators to shared memory, over the
// conv's staging buffers, and from there
//   1. reduces it to per-channel (count, mean, M2 about that mean), merged
//      over its tiles by Chan's formula, M2 = M2_a + M2_b + d^2 n_a n_b / n:
//      the centred two-pass variance, not the TPU kernel's E[z^2] - mean^2
//      (:159-161), which cancels when |mean| >> std;
//   2. merges its channels into per-group partials, in channel order; after
//      cluster.sync() reads the k blocks' group partials through distributed
//      shared memory, all at once, and merges them in rank order, so that
//      every block holds the row's statistics and no sum depends on timing
//      (no atomics);
//   3. applies them to the z it holds and writes out once, coalesced.
// The elementwise passes read shared memory with few live registers: run
// from the accumulators, they spilled and ran latency-bound (PERF.md §6).
// When the row's tiles outnumber kClusterMax blocks (large P), each block
// computes its tiles again for step 3 instead of holding them (the TPU
// backward's replay). z goes to device memory only when the caller keeps it
// for the backward (grad on); rank 0 writes the row's [G, 2] (mean, rstd).

#include "conv_tile.cuh"

namespace {

using namespace pidm::conv;
using pidm::from_f32;

// Bytes of the forward's staging region: the conv's buffers, then the
// tile's z [BM][TPX + 8] fp32 over them.
__host__ __device__ inline int fwd_stage_bytes(const Geom& g, bool tc) {
  const int zs = g.bm * (g.tpx + 8) * 4, conv = conv_smem(g, tc);
  return conv > zs ? conv : zs;
}

// Floats of the forward's shared memory past it: per channel (count, mean,
// M2) of the block, the row's [G][2] statistics and the block's [G][3]
// group partials (ops/conv_block.py `k4_plan`).
__host__ __device__ inline int fwd_aux_floats(const Geom& g, int G) {
  return 3 * g.cout + 5 * G;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
k4_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const float* __restrict__ scale, const float* __restrict__ shift,
              T* __restrict__ out, float* __restrict__ z, float* __restrict__ stats, int P,
              int Ci, int Co, int G, float eps) {
  constexpr bool kTc = kIsTc<T>;
  using F = Frag<kTc>;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks(), q = (int)cluster.block_rank(), b = blockIdx.y;
  const Geom g = geom(P, Ci, Co);
  extern __shared__ __align__(16) unsigned char smem[];
  float* zs = reinterpret_cast<float*>(smem);  // [bm][tpx + 8]: the tile's z
  float* chs = reinterpret_cast<float*>(smem + fwd_stage_bytes(g, kTc));  // [3][Co]
  float* gstat = chs + 3 * Co;                                            // [G][2]
  float* gpart = gstat + 2 * G;                                           // [G][3]
  const T* xb = x + (long long)b * Ci * g.N;
  const long long ob = (long long)b * Co * g.N;
  const int cg_n = Co / G;
  const bool vec = P % 4 == 0;
  for (int c = threadIdx.x; c < 3 * Co; c += kThreads) chs[c] = 0.f;

  // the conv tile's z (conv + bias) into zs
  auto conv_z = [&](int tile) {
    const Place<kTc> pl(g, tile);
    float acc[F::NI][F::NJ];
    conv_tile<T>(acc, pl, g, xb, w, smem);
    dump_tile<kTc>(zs, pl, g, acc, bias);
    return pl;
  };

  for (int tile = q; tile < g.tiles; tile += k) {
    const Place<kTc> pl = conv_z(tile);
    const Runs r(g, pl.t0);
    const int co = pl.m0 + r.cl;
    float* zrow = z != nullptr ? z + ob + (long long)min(co, Co - 1) * g.N : nullptr;
    // the tile's channel mean, then M2 about it, merged into chs; z kept
    // for the backward when asked
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const float4 v = r.at(zs, g, i);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) s += r.col[i] + u < P ? e[u] : 0.f;
      if (z != nullptr && co < Co) {
        if (vec && r.col[i] < P) {
          *reinterpret_cast<float4*>(zrow + r.n[i]) = v;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r.col[i] + u < P) zrow[r.n[i] + u] = e[u];
        }
      }
    }
    const float n_t = (float)real_pixels(pl.t0, min(pl.t0 + g.tpx, P * g.rp), g.rp, P);
    const float mean = n_t > 0.f ? r.sum(s) / n_t : 0.f;
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const float4 v = r.at(zs, g, i);
      const float e[4] = {v.x - mean, v.y - mean, v.z - mean, v.w - mean};
#pragma unroll
      for (int u = 0; u < 4; ++u) m2 += r.col[i] + u < P ? e[u] * e[u] : 0.f;
    }
    m2 = r.sum(m2);
    if (r.lane == 0 && co < Co) chan_merge(chs[co], chs[Co + co], chs[2 * Co + co], n_t, mean, m2);
  }

  // the block's partial of each group: its channels merged in order
  __syncthreads();
  for (int gi = threadIdx.x; gi < G; gi += kThreads) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int c = gi * cg_n; c < (gi + 1) * cg_n; ++c)
      chan_merge(n, mean, m2, chs[c], chs[Co + c], chs[2 * Co + c]);
    gpart[3 * gi] = n, gpart[3 * gi + 1] = mean, gpart[3 * gi + 2] = m2;
  }
  // the row's statistics: the k blocks' group partials merged in rank order,
  // all k read from distributed shared memory before the first merge
  cluster.sync();
  for (int gi = threadIdx.x; gi < G; gi += kThreads) {
    float pn[kClusterMax], pm[kClusterMax], pq[kClusterMax];
#pragma unroll
    for (int p = 0; p < kClusterMax; ++p) {
      const float* rp = cluster.map_shared_rank(gpart, p < k ? p : 0);
      pn[p] = p < k ? rp[3 * gi] : 0.f, pm[p] = rp[3 * gi + 1], pq[p] = rp[3 * gi + 2];
    }
    float n = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
    for (int p = 0; p < kClusterMax; ++p) chan_merge(n, mean, m2, pn[p], pm[p], pq[p]);
    gstat[2 * gi] = mean;
    gstat[2 * gi + 1] = rsqrtf(m2 / n + eps);
  }
  cluster_arrive();  // this block reads no other block's partials from here on
  __syncthreads();
  if (q == 0)
    for (int i = threadIdx.x; i < 2 * G; i += kThreads) stats[(long long)b * G * 2 + i] = gstat[i];

  // y = (z - mean) a + c, out = y sigmoid(y)
  for (int tile = q; tile < g.tiles; tile += k) {
    // a tile not held (more tiles than blocks) is computed again
    const Place<kTc> pl = g.tiles > k ? conv_z(tile) : Place<kTc>(g, tile);
    const Runs r(g, pl.t0);
    const int co = min(pl.m0 + r.cl, Co - 1), gr = co / cg_n;
    const float sc1 = scale[(long long)b * Co + co] + 1.f;
    const float a = gstat[2 * gr + 1] * gamma[co] * sc1;
    const float c0 = fmaf(beta[co], sc1, shift[(long long)b * Co + co]);
    const float mean = gstat[2 * gr];
    T* orow = out + ob + (long long)co * g.N;
    if (pl.m0 + r.cl >= Co) continue;
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const float4 v = r.at(zs, g, i);
      float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) y[u] = silu(fmaf(y[u] - mean, a, c0));
      if (vec && r.col[i] < P) {
        store_v<T, 4>(orow + r.n[i], y);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r.col[i] + u < P) orow[r.n[i] + u] = from_f32<T>(y[u]);
      }
    }
  }
  cluster_wait();
}

template <typename T>
int forward(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
            const void* scale, const void* shift, void* out, void* z, void* stats, int B, int Ci,
            int Co, int P, int G, float eps, int k, int smem, cudaStream_t st) {
  const Geom g = geom(P, Ci, Co);
  const int need = fwd_stage_bytes(g, kIsTc<T>) + 4 * fwd_aux_floats(g, G);
  if (k != (g.tiles < kClusterMax ? g.tiles : kClusterMax) || smem != need || B < 1 ||
      B > 65535 || Ci % 16 || Co % 16 || Co % G)
    return (int)cudaErrorInvalidValue;
  return launch(k4_fwd_kernel<T>, dim3(k, B), kThreads, k, smem, st, static_cast<const T*>(x),
                static_cast<const T*>(w), static_cast<const float*>(bias),
                static_cast<const float*>(gamma), static_cast<const float*>(beta),
                static_cast<const float*>(scale), static_cast<const float*>(shift),
                static_cast<T*>(out), static_cast<float*>(z), static_cast<float*>(stats), P, Ci,
                Co, G, eps);
}

}  // namespace

// x: [B, Ci, P*P] fp32 (bf16 when `bf16` is 1); w: the weight in the
// route's layout, in x's type: bf16 `wflat` [Co, 9 Ci] (tap-major columns),
// fp32 its transpose [9 Ci, Co]; bias, gamma, beta: [Co] fp32; scale,
// shift: [B, Co] fp32 (zeros for no FiLM); out: [B, Co, P*P] in x's type;
// z: [B, Co, P*P] fp32, written with conv + bias when not null (with grad:
// what the backward reads); stats: [B, G, 2] fp32, each row's (mean,
// rstd) per group. The plan (k blocks a row, smem bytes a block) comes from
// ops/conv_block.py `k4_plan` and is checked here. Ci and Co multiples of
// 16. Launches on `stream`, allocates nothing, returns the CUDA error.
extern "C" int pidm_conv_gn_film_silu(const void* x, const void* w, const void* bias,
                                      const void* gamma, const void* beta, const void* scale,
                                      const void* shift, void* out, void* z, void* stats, int B,
                                      int Ci, int Co, int P, int G, float eps, int k, int smem,
                                      int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return forward<__nv_bfloat16>(x, w, bias, gamma, beta, scale, shift, out, z, stats, B, Ci,
                                  Co, P, G, eps, k, smem, st);
  return forward<float>(x, w, bias, gamma, beta, scale, shift, out, z, stats, B, Ci, Co, P, G,
                        eps, k, smem, st);
}

// How many clusters of the forward's plan (k blocks of smem bytes) the card
// holds at once; minus the CUDA error on failure.
extern "C" int pidm_conv_gn_film_silu_max_clusters(int k, int smem, int bf16) {
  return bf16 ? max_clusters(k4_fwd_kernel<__nv_bfloat16>, k, smem)
              : max_clusters(k4_fwd_kernel<float>, k, smem);
}
