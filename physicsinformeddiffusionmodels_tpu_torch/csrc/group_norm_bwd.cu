// K2 backward: the VJP of GroupNorm -> FiLM -> SiLU (group_norm.cu) on a
// [B, N, C] fp32 or bf16 activation: dx, dgamma, dbeta and, with FiLM,
// dscale and dshift from dy. With bf16 x (the `bf16` flag), dy is bf16 and
// dx is written as bf16, rounded once; x and dy are read as bf16, and the
// sums and parameter gradients stay fp32.
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
// Bound on the H100: memory. About 25 flops an element against 12 bytes
// (x and dy read, dx written, fp32; 6 in bf16). Two launches, each summing
// in a fixed order with no atomics (the results repeat exactly):
//   1. gn_bwd_kernel, one thread-block cluster a batch row as in the
//      forward (gn_cluster.cuh): each block stages its slice of x and dy in
//      shared memory, computes x-hat from the forward's saved (mean, rstd),
//      dz and its per-channel S0, S1; after cluster.sync() it merges the k
//      blocks' S0, S1 of its row in rank order through distributed shared
//      memory, forms t1, t2 per group and writes dx from shared memory.
//      Rank 0 writes dshift, dscale and the row's [C, 2] (S0, S1) to a
//      [B, C, 2] scratch, the whole workspace.
//   2. gn_bwd_params_kernel: dgamma and dbeta from that scratch, the rows
//      of each channel summed in a fixed order.
// x and dy are read from device memory once where the row fits the
// cluster's shared memory, else the tokens past a block's resident part
// are read again from L2 for dx.

#include "gn_cluster.cuh"

namespace {

using namespace pidm::gn;

constexpr int kRowLanes = 8;  // rows summed side by side in the parameter pass

// d silu(z) / dz, with the forward's fast __expf and __fdividef
__device__ inline float silu_grad(float z) {
  const float sig = __fdividef(1.f, 1.f + __expf(-z));
  return sig * (1.f + z * (1.f - sig));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 3)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const float* __restrict__ scale, const float* __restrict__ shift,
              const float* __restrict__ stats, T* __restrict__ dx, float* __restrict__ dscale,
              float* __restrict__ dshift, float* __restrict__ sums, int N, int C, int G, int ts,
              int rt) {
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks(), q = (int)cluster.block_rank(), b = blockIdx.y;
  const int cgs = C / G, cols = C / V;
  const int rows = rows_of(q, N, ts), res = min(rows, rt);
  extern __shared__ __align__(16) unsigned char smem[];
  const long long sb = slice_bytes(rt, C, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem);
  T* dys = reinterpret_cast<T*>(smem + sb);
  float* red0 = reinterpret_cast<float*>(smem + 2 * sb);  // [R][C] each
  float* red1 = red0 + red_floats(C, sizeof(T));
  float* part = red1 + red_floats(C, sizeof(T));  // [2][C] the slice's S0, S1
  float* tot = part + 2 * C;                      // [2][C] the row's S0, S1
  float* tg = tot + 2 * C;                        // [2][G] t1, t2
  const long long off = ((long long)b * N + (long long)q * ts) * C;
  const T* xr = x + off;
  const T* dyr = dy + off;
  T* dxr = dx + off;
  const float* st = stats + (long long)b * G * 2;

  stage<T, V>(xs, xr, res * C);
  stage<T, V>(dys, dyr, res * C);
  stage_wait();
  const Lanes L(cols);
  // x and dy at offset o of the slice
  auto read = [&](float (&fx)[V], float (&fd)[V], int o, auto resident) {
    constexpr bool sm = decltype(resident)::value;
    load_vec<T, V>(fx, sm ? xs + o : xr + o);
    load_vec<T, V>(fd, sm ? dys + o : dyr + o);
  };
  // the per-channel constants of column j: z = x-hat gs + bs
  float mean[V], rstd[V], gs[V], bs[V];
  auto constants = [&](int j) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = j * V + v, g = c / cgs;
      const float sc1 = scale ? scale[(long long)b * C + c] + 1.f : 1.f;
      mean[v] = st[2 * g];
      rstd[v] = st[2 * g + 1];
      gs[v] = gamma[c] * sc1;
      bs[v] = fmaf(beta[c], sc1, shift ? shift[(long long)b * C + c] : 0.f);
    }
  };

  // the slice's S0 = sum dz and S1 = sum dz x-hat per channel
  for (int j = L.j0; j < cols; j += L.js) {
    constants(j);
    float a0[V] = {}, a1[V] = {};
    for_rows<V>(L, j, C, res, rows, [&](int o, auto resident) {
      float fx[V], fd[V];
      read(fx, fd, o, resident);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xhat = (fx[v] - mean[v]) * rstd[v];
        const float dz = fd[v] * silu_grad(fmaf(xhat, gs[v], bs[v]));
        a0[v] += dz;
        a1[v] = fmaf(dz, xhat, a1[v]);
      }
    });
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red0[L.r * C + j * V + v] = a0[v];
      red1[L.r * C + j * V + v] = a1[v];
    }
  }
  __syncthreads();
  fold_lanes(part, red0, L.R, C);
  fold_lanes(part + C, red1, L.R, C);

  // the row's S0, S1: the k slices summed in rank order
  cluster.sync();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s0 = 0.f, s1 = 0.f;
    for (int p = 0; p < k; ++p) {
      const float* rp = cluster.map_shared_rank(part, p);
      s0 += rp[c];
      s1 += rp[C + c];
    }
    tot[c] = s0;
    tot[C + c] = s1;
    if (q == 0) {
      sums[((long long)b * C + c) * 2] = s0;
      sums[((long long)b * C + c) * 2 + 1] = s1;
      if (dshift != nullptr) {
        dshift[(long long)b * C + c] = s0;
        dscale[(long long)b * C + c] = fmaf(gamma[c], s1, beta[c] * s0);
      }
    }
  }
  cluster_arrive();  // this block reads no other block's partials from here on
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float a = 0.f, a2 = 0.f;
    for (int i = 0; i < cgs; ++i) {
      const int c = g * cgs + i;
      const float u = gamma[c] * (scale ? scale[(long long)b * C + c] + 1.f : 1.f);
      a += u * tot[c];
      a2 += u * tot[C + c];
    }
    tg[g] = a;
    tg[G + g] = a2;
  }
  __syncthreads();

  // dx = rstd (dx-hat - (t1 + x-hat t2) / (N C/G))
  const float inv_cnt = 1.f / ((float)N * (float)cgs);
  for (int j = L.j0; j < cols; j += L.js) {
    constants(j);
    float t1[V], t2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      t1[v] = tg[(j * V + v) / cgs];
      t2[v] = tg[G + (j * V + v) / cgs];
    }
    for_rows<V>(L, j, C, res, rows, [&](int o, auto resident) {
      float fx[V], fd[V];
      read(fx, fd, o, resident);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xhat = (fx[v] - mean[v]) * rstd[v];
        const float dxhat = fd[v] * silu_grad(fmaf(xhat, gs[v], bs[v])) * gs[v];
        fx[v] = rstd[v] * (dxhat - (t1[v] + xhat * t2[v]) * inv_cnt);
      }
      store_vec<T, V>(dxr + o, fx);
    });
  }
  cluster_wait();
}

// dgamma, dbeta from the rows' (S0, S1): kRowLanes lanes of rows for each
// of 32 channels a block, each lane's rows in order, then the lanes in
// order.
__global__ void __launch_bounds__(kRowLanes * 32)
gn_bwd_params_kernel(const float* __restrict__ sums, const float* __restrict__ scale,
                     float* __restrict__ dgamma, float* __restrict__ dbeta, int B, int C) {
  __shared__ float red[2][kRowLanes][32];
  const int r = threadIdx.x / 32, ci = threadIdx.x % 32, c = blockIdx.x * 32 + ci;
  float dg = 0.f, db = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int b = r; b < B; b += kRowLanes) {
      const float sc1 = scale ? scale[(long long)b * C + c] + 1.f : 1.f;
      const float* sm = sums + ((long long)b * C + c) * 2;
      db = fmaf(sc1, sm[0], db);
      dg = fmaf(sc1, sm[1], dg);
    }
  }
  red[0][r][ci] = db;
  red[1][r][ci] = dg;
  __syncthreads();
  if (r == 0 && c < C) {
    for (int l = 1; l < kRowLanes; ++l) {
      db += red[0][l][ci];
      dg += red[1][l][ci];
    }
    dgamma[c] = dg;
    dbeta[c] = db;
  }
}

template <typename T>
int backward(const void* x, const void* dy, const void* gamma, const void* beta,
             const void* scale, const void* shift, const void* stats, void* dx, void* dgamma,
             void* dbeta, void* dscale, void* dshift, void* sums, int B, int N, int C, int G,
             int k, int ts, int rt, int smem, int vec, cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  const int elt = sizeof(T);
  const long long need = 2 * slice_bytes(rt, C, elt) + aux_bytes(C, G, elt, true);
  if (vec && (C % kV || (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(dy) |
                         reinterpret_cast<size_t>(dx)) % 16))
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto kernel) {
    return launch_cluster(kernel, k, B, N, C, elt, ts, rt, smem, need, st,
                          static_cast<const T*>(x), static_cast<const T*>(dy),
                          static_cast<const float*>(gamma), static_cast<const float*>(beta),
                          static_cast<const float*>(scale), static_cast<const float*>(shift),
                          static_cast<const float*>(stats), static_cast<T*>(dx),
                          static_cast<float*>(dscale), static_cast<float*>(dshift),
                          static_cast<float*>(sums), N, C, G, ts, rt);
  };
  const int err = vec ? args(gn_bwd_kernel<T, kV>) : args(gn_bwd_kernel<T, 1>);
  if (err != 0) return err;
  gn_bwd_params_kernel<<<(C + 31) / 32, kRowLanes * 32, 0, st>>>(
      static_cast<const float*>(sums), static_cast<const float*>(scale),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), B, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: [B, N, C] fp32 (bf16 when `bf16` is 1); gamma, beta, dgamma,
// dbeta: [C] fp32; scale, shift, dscale, dshift: [B, C] fp32, or all four
// null for no FiLM; stats: the forward's [B, G, 2] (mean, rstd); sums: a
// [B, C, 2] fp32 scratch. The plan (k, ts, rt, smem, vec) comes from
// ops/group_norm.py `k2_plan(..., backward=True)`. Launches on `stream`,
// allocates nothing, returns the CUDA error.
extern "C" int pidm_gn_film_silu_bwd(const void* x, const void* dy, const void* gamma,
                                     const void* beta, const void* scale, const void* shift,
                                     const void* stats, void* dx, void* dgamma, void* dbeta,
                                     void* dscale, void* dshift, void* sums, int B, int N, int C,
                                     int G, int k, int ts, int rt, int smem, int vec, int bf16,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return backward<__nv_bfloat16>(x, dy, gamma, beta, scale, shift, stats, dx, dgamma, dbeta,
                                   dscale, dshift, sums, B, N, C, G, k, ts, rt, smem, vec, st);
  return backward<float>(x, dy, gamma, beta, scale, shift, stats, dx, dgamma, dbeta, dscale,
                         dshift, sums, B, N, C, G, k, ts, rt, smem, vec, st);
}

// How many clusters of k backward blocks with `smem` bytes each the card
// holds at once (0: none), or minus the CUDA error.
extern "C" int pidm_gn_film_silu_bwd_max_clusters(int k, int smem, int vec, int bf16) {
  if (bf16)
    return vec ? max_clusters(gn_bwd_kernel<__nv_bfloat16, 8>, k, smem)
               : max_clusters(gn_bwd_kernel<__nv_bfloat16, 1>, k, smem);
  return vec ? max_clusters(gn_bwd_kernel<float, 4>, k, smem)
             : max_clusters(gn_bwd_kernel<float, 1>, k, smem);
}
