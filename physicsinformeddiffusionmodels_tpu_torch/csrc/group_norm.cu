// K2: GroupNorm -> FiLM -> SiLU on a [B, N, C] activation, fp32 or bf16.
//
// Replaces physicsinformeddiffusionmodels_tpu/ops/pallas_kernels.py
// `_fwd_kernel` (launched by `_fwd_call` through pl.pallas_call), the body
// behind `group_norm_film_silu`. Per (batch, group): mean and biased
// variance over N x C/G values (eps 1e-5), then, with the affine and FiLM
// folded into one multiply-add per channel as the TPU kernel folds them
// (pallas_kernels.py:106-112),
//   a = rstd gamma (scale + 1),  b = (beta - mean rstd gamma) (scale + 1) + shift,
//   y = x a + b,  out = y sigmoid(y),
// with the FiLM term absent when scale/shift are null. bf16 x is read as
// bf16 and out rounded once; every sum and statistic is fp32.
//
// Bound on the H100: memory. About 10 flops an element against 8 bytes
// (fp32 x read, out written; 4 in bf16). The TPU kernel keeps a batch row
// in VMEM and reads x once. Here a row is held by a thread-block cluster
// (gn_cluster.cuh): one launch, grid (k, B), and each block
//   1. stages its token slice in shared memory (16-byte cp.async);
//   2. computes per group over its slice the mean, then M2 = sum (x -
//      mean)^2 from shared memory: the centred two-pass variance of the
//      plain version, not E[x^2] - mean^2;
//   3. after cluster.sync() merges the k slices' (count, mean, M2) of its
//      row in rank order by Chan's formula, M2 = M2_a + M2_b + d^2 n_a n_b /
//      n, reading them through distributed shared memory;
//   4. applies y = x a + b from shared memory with 16-byte stores; rank 0
//      writes the row's [G, 2] (mean, rstd), which the backward reads;
//   5. waits at the cluster barrier before it exits, so that no block's
//      partials vanish while another block still reads them.
// x is read from device memory once where the row fits the cluster's
// shared memory; otherwise each block re-reads the tokens past its
// resident part from L2 in every pass. The sigmoid takes __expf and
// __fdividef: with expf and an IEEE division the apply pass was bound by
// its instructions, not its bytes.

#include "gn_cluster.cuh"

namespace {

using namespace pidm::gn;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 4)
gn_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ gamma,
              const float* __restrict__ beta, const float* __restrict__ scale,
              const float* __restrict__ shift, float* __restrict__ stats, int N, int C, int G,
              int ts, int rt, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks(), q = (int)cluster.block_rank(), b = blockIdx.y;
  const int cgs = C / G, cols = C / V;
  const int rows = rows_of(q, N, ts), res = min(rows, rt);
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + slice_bytes(rt, C, sizeof(T)));  // [R][C]
  float* chs = red + red_floats(C, sizeof(T));  // [C] per-channel sums of the slice
  float* gpart = chs + C;                       // [G][2] the slice's mean and M2
  float* gstat = gpart + 2 * G;                 // [G][2] the row's mean and rstd
  const long long off = ((long long)b * N + (long long)q * ts) * C;
  const T* xr = x + off;
  T* outr = out + off;

  stage<T, V>(xs, xr, res * C);
  stage_wait();
  const Lanes L(cols);
  // x at offset o of the slice
  auto at = [&](int o, auto resident) -> const T* {
    return decltype(resident)::value ? xs + o : xr + o;
  };

  // the slice's per-group means
  for (int j = L.j0; j < cols; j += L.js) {
    float acc[V] = {};
    for_rows<V>(L, j, C, res, rows, [&](int o, auto resident) {
      float f[V];
      load_vec<T, V>(f, at(o, resident));
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += f[v];
    });
#pragma unroll
    for (int v = 0; v < V; ++v) red[L.r * C + j * V + v] = acc[v];
  }
  __syncthreads();
  fold_lanes(chs, red, L.R, C);
  __syncthreads();
  const float cnt = (float)rows * (float)cgs;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s = 0.f;
    for (int i = 0; i < cgs; ++i) s += chs[g * cgs + i];
    gpart[2 * g] = rows > 0 ? s / cnt : 0.f;
  }
  __syncthreads();

  // the slice's per-group M2 about those means
  for (int j = L.j0; j < cols; j += L.js) {
    float m[V], acc[V] = {};
#pragma unroll
    for (int v = 0; v < V; ++v) m[v] = gpart[2 * ((j * V + v) / cgs)];
    for_rows<V>(L, j, C, res, rows, [&](int o, auto resident) {
      float f[V];
      load_vec<T, V>(f, at(o, resident));
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = f[v] - m[v];
        acc[v] = fmaf(d, d, acc[v]);
      }
    });
#pragma unroll
    for (int v = 0; v < V; ++v) red[L.r * C + j * V + v] = acc[v];
  }
  __syncthreads();
  fold_lanes(chs, red, L.R, C);
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s = 0.f;
    for (int i = 0; i < cgs; ++i) s += chs[g * cgs + i];
    gpart[2 * g + 1] = s;
  }

  // the row's statistics: the k slices merged in rank order (Chan)
  cluster.sync();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float n_a = 0.f, mean_a = 0.f, m2_a = 0.f;
    for (int p = 0; p < k; ++p) {
      const float n_b = (float)rows_of(p, N, ts) * (float)cgs;
      if (n_b == 0.f) continue;
      const float* rp = cluster.map_shared_rank(gpart, p);
      const float n = n_a + n_b, d = rp[2 * g] - mean_a;
      mean_a += d * (n_b / n);
      m2_a += rp[2 * g + 1] + d * d * (n_a * n_b / n);
      n_a = n;
    }
    gstat[2 * g] = mean_a;
    gstat[2 * g + 1] = rsqrtf(m2_a / n_a + eps);
  }
  cluster_arrive();  // this block reads no other block's partials from here on
  __syncthreads();
  if (q == 0)
    for (int i = threadIdx.x; i < 2 * G; i += kThreads) stats[(long long)b * G * 2 + i] = gstat[i];

  // y = x a + b, out = y sigmoid(y)
  for (int j = L.j0; j < cols; j += L.js) {
    float a[V], c0[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = j * V + v, g = c / cgs;
      const float sc1 = scale ? scale[(long long)b * C + c] + 1.f : 1.f;
      const float sh = shift ? shift[(long long)b * C + c] : 0.f;
      const float ig = gstat[2 * g + 1] * gamma[c];
      a[v] = ig * sc1;
      c0[v] = fmaf(beta[c] - gstat[2 * g] * ig, sc1, sh);
    }
    for_rows<V>(L, j, C, res, rows, [&](int o, auto resident) {
      float f[V];
      load_vec<T, V>(f, at(o, resident));
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float y = fmaf(f[v], a[v], c0[v]);
        f[v] = __fdividef(y, 1.f + __expf(-y));
      }
      store_vec<T, V>(outr + o, f);
    });
  }
  cluster_wait();
}

template <typename T>
int launch(const void* x, void* out, const void* gamma, const void* beta, const void* scale,
           const void* shift, void* stats, int B, int N, int C, int G, int k, int ts, int rt,
           int smem, int vec, float eps, cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  const int elt = sizeof(T);
  const long long need = slice_bytes(rt, C, elt) + aux_bytes(C, G, elt, false);
  if (vec && (C % kV || (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out)) % 16))
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto kernel) {
    return launch_cluster(kernel, k, B, N, C, elt, ts, rt, smem, need, st,
                          static_cast<const T*>(x), static_cast<T*>(out),
                          static_cast<const float*>(gamma), static_cast<const float*>(beta),
                          static_cast<const float*>(scale), static_cast<const float*>(shift),
                          static_cast<float*>(stats), N, C, G, ts, rt, eps);
  };
  return vec ? args(gn_fwd_kernel<T, kV>) : args(gn_fwd_kernel<T, 1>);
}

}  // namespace

// x, out: [B, N, C] fp32 (bf16 when `bf16` is 1); gamma, beta: [C] fp32;
// scale, shift: [B, C] fp32 or both null; stats: [B, G, 2] fp32, written
// with each row's (mean, rstd) per group. The plan (k blocks a row, ts
// tokens a block, rt of them staged, smem bytes a block, 16-byte vectors
// when `vec`) comes from ops/group_norm.py `k2_plan`. Launches on `stream`,
// allocates nothing, returns the CUDA error.
extern "C" int pidm_gn_film_silu(const void* x, void* out, const void* gamma, const void* beta,
                                 const void* scale, const void* shift, void* stats, int B,
                                 int N, int C, int G, int k, int ts, int rt, int smem, int vec,
                                 float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, out, gamma, beta, scale, shift, stats, B, N, C, G, k, ts,
                                 rt, smem, vec, eps, st);
  return launch<float>(x, out, gamma, beta, scale, shift, stats, B, N, C, G, k, ts, rt, smem,
                       vec, eps, st);
}

// How many clusters of k forward blocks with `smem` bytes each the card
// holds at once (0: none), or minus the CUDA error.
extern "C" int pidm_gn_film_silu_max_clusters(int k, int smem, int vec, int bf16) {
  if (bf16)
    return vec ? max_clusters(gn_fwd_kernel<__nv_bfloat16, 8>, k, smem)
               : max_clusters(gn_fwd_kernel<__nv_bfloat16, 1>, k, smem);
  return vec ? max_clusters(gn_fwd_kernel<float, 4>, k, smem)
             : max_clusters(gn_fwd_kernel<float, 1>, k, smem);
}
