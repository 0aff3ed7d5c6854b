// K4 backward: the VJP of the channel-major Block (conv_block.cu) from dy
// [B, Co, P*P]: dx [B, Ci, P*P] (x's type), dW [Co, 9 Ci], dbias, dgamma,
// dbeta [Co], dscale, dshift [B, Co] (fp32; the wrapper rounds dW to the
// weight's type, bf16 under bf16 compute, as the TPU kernel's VJP does).
//
// Replaces physicsinformeddiffusionmodels_tpu/ops/pallas_conv.py
// `_bwd_kernel` (launched by `_bwd_call` through pl.pallas_call, :385),
// phase by phase, with x-hat = (z - mean) rstd, u = x-hat gamma + beta,
// y = u (scale + 1) + shift:
//   A. z: the forward's fp32 z, kept when grad is on (the TPU kernel's
//      `body_a` replays the conv instead; replaying it here, on the tensor
//      cores for bf16 x, measured slower than z's round trip: PERF.md). The
//      row's (mean, rstd) are the forward's.
//   B. dy_pre = dy sig(y) (1 + y (1 - sig(y))); per (row, channel) the two
//      sums S0 = sum_n dy_pre and S1 = sum_n dy_pre x-hat give every
//      parameter sum: dshift = S0, dscale = gamma S1 + beta S0, and over
//      the rows dbeta = sum (scale + 1) S0, dgamma = sum (scale + 1) S1;
//      per group t1 = sum_c gamma (scale + 1) S0, t2 = the same of S1.
//   C1. dz = rstd (dx-hat - (t1 + x-hat t2) / (N Co/G)), dx-hat = dy_pre
//      (scale + 1) gamma; dbias = sum dz (fp32); dz is stored in x's type
//      (the TPU kernel's `dzm = dz.astype(md)`) for the two products:
//      dW[co, t Ci + ci] = sum over rows and pixels of dz[co, n]
//      im2col(x)[t Ci + ci, n]; and
//   C2. dx[ci, m] = sum_t sum_co W[co, t, ci] dz[co, m - s_t]: the forward's
//      conv tile over dz with the tap-flipped weights the wrapper makes
//      (`_cb_bwd`'s `wdx`, taps reversed), whose zero-bordered window is the
//      mask of dz at its own column.
//
// Bound on the H100: fp32 x, operations (dW and dx each do the forward's
// flops); bf16 x, bytes (at the bf16 tensor-core rate).
//
// Three launches, every sum in one fixed order (the result repeats exactly):
//   1. k4_bwd_dz_kernel: one cluster of k blocks a batch row, each a slice
//      of the row's pixels in every channel, read from z and dy twice (the
//      second time from L2), with few registers, so that many warps hide the
//      latency of the elementwise chain: S0 and S1 per channel, the k
//      blocks' sums merged in rank order through distributed shared memory,
//      then dz, dscale, dshift, the row's (S0, S1) and the dbias partials.
//   2. k4_bwd_dw_kernel: dW partials. Grid (dW tiles of 32 x 32 channels x 9
//      taps, splits): about one block an SM (16 warps on fp32 x), each
//      summing a fixed run of pixel chunks (dz chunk and x window staged once
//      a chunk).
//   3. k4_bwd_dx_kernel: dx, grid (conv tiles, B); then all its threads
//      share the final sums of dW's partials and of dgamma, dbeta, dbias,
//      each in a fixed order.

#include "conv_tile.cuh"

namespace {

using namespace pidm::conv;
using pidm::from_f32;
using pidm::to_f32;

// The dz kernel's layout: k blocks a batch row (one cluster), block q taking
// pixels [q ts, min(N, (q + 1) ts)) of every channel; tpc consecutive threads
// share a channel (a power of two, at most 32, tpc Co <= kThreads), each
// walking the slice V pixels at a time.
struct DzPlan {
  int k, ts, tpc;
};

__host__ __device__ inline DzPlan dz_plan(int N, int Co) {
  DzPlan d;
  d.k = cdiv(N, 256);
  if (d.k > kClusterMax) d.k = kClusterMax;
  d.ts = cdiv(cdiv(N, d.k), 4) * 4;
  d.tpc = 32;
  while (d.tpc > 1 && d.tpc * Co > kThreads) d.tpc >>= 1;
  return d;
}

// Bytes of the dz kernel's shared memory: the block's S0, S1 and the row's
// per channel, and the groups' (t1, t2).
__host__ __device__ inline int dz_smem(int Co, int G) { return 4 * (4 * Co + 2 * G); }

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
k4_bwd_dz_kernel(const float* __restrict__ z, const T* __restrict__ dy,
                 const float* __restrict__ stats, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ scale,
                 const float* __restrict__ shift, T* __restrict__ dz, float* __restrict__ sums,
                 float* __restrict__ dbp, float* __restrict__ dscale,
                 float* __restrict__ dshift, int N, int Co, int G) {
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks(), q = (int)cluster.block_rank(), b = blockIdx.y;
  const DzPlan d = dz_plan(N, Co);
  extern __shared__ __align__(16) unsigned char smem[];
  float* s0 = reinterpret_cast<float*>(smem);  // [Co] the block's S0, S1
  float* s1 = s0 + Co;
  float* r0 = s1 + Co;  // [Co] the row's
  float* r1 = r0 + Co;
  float* gt = r1 + Co;  // [G][2] (t1, t2)
  const int n0 = q * d.ts, n1 = min(N, n0 + d.ts), cg_n = Co / G, lane = threadIdx.x % d.tpc;
  const float* st = stats + (long long)b * G * 2;

  // the constants of channel c
  struct Chan {
    float mean, rstd, ga, be, sc1, sh;
  };
  auto chan = [&](int c) {
    const int gr = c / cg_n;
    return Chan{st[2 * gr], st[2 * gr + 1], gamma[c], beta[c],
                scale[(long long)b * Co + c] + 1.f, shift[(long long)b * Co + c]};
  };

  // B: the block's S0, S1 per channel over its slice
  for (int c = threadIdx.x / d.tpc; c < Co; c += kThreads / d.tpc) {
    const Chan h = chan(c);
    const long long row = ((long long)b * Co + c) * N;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 2
    for (int n = n0 + V * lane; n < n1; n += V * d.tpc) {
      float zv[V], dv[V];
      load_v<float, V>(zv, z + row + n);
      load_v<T, V>(dv, dy + row + n);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (zv[e] - h.mean) * h.rstd;
        const float dp = dv[e] * silu_grad(fmaf(fmaf(xhat, h.ga, h.be), h.sc1, h.sh));
        a0 += dp;
        a1 = fmaf(dp, xhat, a1);
      }
    }
    a0 = lane_sum(a0, d.tpc);
    a1 = lane_sum(a1, d.tpc);
    if (lane == 0) s0[c] = a0, s1[c] = a1;
  }

  // the row's S0, S1: the k blocks' sums in rank order
  cluster.sync();
  for (int c = threadIdx.x; c < Co; c += kThreads) {
    float v0[kClusterMax], v1[kClusterMax];  // all k read before the first add
#pragma unroll
    for (int p = 0; p < kClusterMax; ++p) {
      v0[p] = p < k ? cluster.map_shared_rank(s0, p)[c] : 0.f;
      v1[p] = p < k ? cluster.map_shared_rank(s1, p)[c] : 0.f;
    }
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int p = 0; p < kClusterMax; ++p) a0 += v0[p], a1 += v1[p];
    r0[c] = a0;
    r1[c] = a1;
  }
  cluster_arrive();  // this block reads no other block's sums from here on
  __syncthreads();
  for (int gi = threadIdx.x; gi < G; gi += kThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int c = gi * cg_n; c < (gi + 1) * cg_n; ++c) {  // the same order in every block
      const float u = gamma[c] * (scale[(long long)b * Co + c] + 1.f);
      t1 = fmaf(u, r0[c], t1);
      t2 = fmaf(u, r1[c], t2);
    }
    gt[2 * gi] = t1;
    gt[2 * gi + 1] = t2;
  }
  if (q == 0)
    for (int c = threadIdx.x; c < Co; c += kThreads) {
      const long long bc = (long long)b * Co + c;
      dshift[bc] = r0[c];
      dscale[bc] = fmaf(gamma[c], r1[c], beta[c] * r0[c]);
      sums[2 * bc] = r0[c];
      sums[2 * bc + 1] = r1[c];
    }
  __syncthreads();

  // C1: dz over the slice, and the block's dbias partial per channel
  const float inv_cnt = 1.f / ((float)N * (float)cg_n);
  for (int c = threadIdx.x / d.tpc; c < Co; c += kThreads / d.tpc) {
    const Chan h = chan(c);
    const float t1 = gt[2 * (c / cg_n)], t2 = gt[2 * (c / cg_n) + 1];
    const long long row = ((long long)b * Co + c) * N;
    float a = 0.f;
#pragma unroll 2
    for (int n = n0 + V * lane; n < n1; n += V * d.tpc) {
      float zv[V], dv[V];
      load_v<float, V>(zv, z + row + n);
      load_v<T, V>(dv, dy + row + n);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (zv[e] - h.mean) * h.rstd;
        const float y = fmaf(fmaf(xhat, h.ga, h.be), h.sc1, h.sh);
        const float dxhat = dv[e] * silu_grad(y) * h.sc1 * h.ga;
        dv[e] = h.rstd * (dxhat - (t1 + xhat * t2) * inv_cnt);
        a += dv[e];
      }
      store_v<T, V>(dz + row + n, dv);
    }
    a = lane_sum(a, d.tpc);
    if (lane == 0) dbp[((long long)b * k + q) * Co + c] = a;
  }
  cluster_wait();
}

// ---- dW ---------------------------------------------------------------------

// The dW kernel's plan: pixel chunks of a batch row and window rows a chunk.
struct DwGeom {
  int rp, px, cpi, wr, cot, cit;
};

__host__ __device__ inline DwGeom dw_geom(int P, int Ci, int Co, bool tc) {
  DwGeom d;
  d.rp = cdiv(P, 8) * 8;
  d.px = tc ? kDwPxTc : kDwPxF;
  d.cpi = cdiv(P * d.rp, d.px);
  d.wr = window_rows(d.px, d.rp, P);
  d.cot = cdiv(Co, kDwCo);
  d.cit = cdiv(Ci, kDwCi);
  return d;
}

__host__ __device__ inline int dw_plane(const DwGeom& d) { return d.wr * (d.rp + 8) + 4; }

__host__ __device__ inline int dw_smem(int P, int Ci, int Co, bool tc) {
  const DwGeom d = dw_geom(P, Ci, Co, tc);
  if (tc) return d.wr * (d.rp + 2) * kXp * 2 + kDwCo * (d.px + 8) * 2;
  const int staged = 2 * (kDwCi * dw_plane(d) + kDwCo * d.px) * 4;
  const int reduce = 3 * (kDwCo / 8) * kDwCi * 72 * 4;  // three pixel lanes' sums
  return staged > reduce ? staged : reduce;
}

template <typename T>
__global__ void __launch_bounds__(kIsTc<T> ? kDwThreadsTc : kDwThreadsF, 1)
k4_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ dz, float* __restrict__ part,
                 int B, int P, int Ci, int Co, int splits) {
  constexpr bool kTc = kIsTc<T>;
  const DwGeom d = dw_geom(P, Ci, Co, kTc);
  const int N = P * P, total = B * d.cpi, last = P * d.rp - 1;
  const int co0 = (blockIdx.x % d.cot) * kDwCo, ci0 = (blockIdx.x / d.cot) * kDwCi;
  const int s = blockIdx.y;
  const int c_begin = (int)((long long)s * total / splits);
  const int c_end = (int)((long long)(s + 1) * total / splits);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  float* out = part + (long long)s * Co * 9 * Ci;
  if constexpr (kTc) {
    // warp (wm, wn): output channels co0 + 16 wm + [0, 16), input channels
    // ci0 + 8 wn + [0, 8), all 9 taps: acc[t] one m16n8 tile
    const int wm = w >> 2, wn = w & 3, dp = d.px + 8;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* dzs = xs + d.wr * (d.rp + 2) * kXp;  // [32][px + 8]
    float acc[9][4];
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
    for (int ch = c_begin; ch < c_end; ++ch) {
      const int b = ch / d.cpi, t0 = (ch - b * d.cpi) * d.px, wr0 = t0 / d.rp - 1;
      const __nv_bfloat16* dzb = dz + ((long long)b * Co + co0) * N;
      __syncthreads();  // the previous chunk is read
      // dz chunk [32 channels][px padded pixels], zero past Co and off the image
      for (int it = threadIdx.x; it < kDwCo * d.px / 8; it += kThreads) {
        const int co = it / (d.px / 8), p8 = it - co * (d.px / 8), gp = t0 + 8 * p8;
        __nv_bfloat16* dst = dzs + co * dp + 8 * p8;
        if (P % 8 == 0) {  // rp == P: a run of 8 is 8 real pixels or none
          const bool ok = co0 + co < Co && gp <= last;
          cp_async16(dst, ok ? dzb + (long long)co * N + gp : dz, ok);
        } else {
          uint32_t v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t h[2];
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              const int p = gp + 2 * e + f, row = p / d.rp, col = p - row * d.rp;
              const bool ok = co0 + co < Co && p <= last && col < P;
              h[f] = ok ? (uint32_t)reinterpret_cast<const unsigned short*>(dzb)[
                              (long long)co * N + row * P + col] : 0u;
            }
            v[e] = h[0] | (h[1] << 16);
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      cp_commit();
      stage_window_tc(xs, x + (long long)b * Ci * N, Ci, ci0, P, d.rp, wr0, d.wr);
      cp_wait<0>();
      __syncthreads();
      for (int ks = 0; ks < d.px / 16 && t0 + 16 * ks <= last; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, dzs + (wm * 16 + (lane & 15)) * dp + 16 * ks + (lane >> 4) * 8);
        const int gp = min(t0 + 16 * ks + kr, last), row = gp / d.rp;
        const __nv_bfloat16* xb =
            xs + ((row - wr0) * (d.rp + 2) + gp - row * d.rp + 1) * kXp + 8 * wn;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, xb + ((t / 3 - 1) * (d.rp + 2) + t % 3 - 1) * kXp);
          mma(acc[t], a, b0, b1);
        }
      }
    }
    const int ci = ci0 + 8 * wn + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + 16 * wm + 8 * h + (lane >> 2);
      if (co < Co && ci < Ci)
#pragma unroll
        for (int t = 0; t < 9; ++t)
          *reinterpret_cast<float2*>(out + (long long)co * 9 * Ci + t * Ci + ci) =
              make_float2(acc[t][2 * h], acc[t][2 * h + 1]);
    }
  } else {
    // warp (c8, half): output channels co0 + 8 c8 + [0, 8) for input channel
    // ci0 + lane, all 9 taps, over the runs of 4 pixels half, half + 4, ...
    const int c8 = w & 3, half = w >> 2, rpp = d.rp + 8, plane = dw_plane(d);
    float* xs = reinterpret_cast<float*>(smem);      // [2][32][plane]
    float* dzs = xs + 2 * kDwCi * plane;             // [2][32][px]
    float acc[8][9];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[i][t] = 0.f;
    auto stage = [&](int ch, int buf) {
      const int b = ch / d.cpi, t0 = (ch - b * d.cpi) * d.px;
      const float* dzb = dz + ((long long)b * Co + co0) * N;
      float* dst0 = dzs + buf * kDwCo * d.px;
      for (int it = threadIdx.x; it < kDwCo * d.px / 4; it += kDwThreadsF) {
        const int co = it / (d.px / 4), p4 = it - co * (d.px / 4), gp = t0 + 4 * p4;
        const int row = gp / d.rp, col = gp - row * d.rp;
        float* dst = dst0 + co * d.px + 4 * p4;
        if (P % 4 == 0) {  // a run of 4 is 4 real pixels or none
          const bool ok = co0 + co < Co && gp <= last && col < P;
          cp_async16(dst, ok ? dzb + (long long)co * N + row * P + col : dz, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = co0 + co < Co && gp + e <= last && col + e < P;
            cp_async4(dst + e, ok ? dzb + (long long)co * N + row * P + col + e : dz, ok);
          }
        }
      }
      stage_window_f<kDwThreadsF>(xs + buf * kDwCi * plane, x + (long long)b * Ci * N, ci0, P,
                                  d.rp, t0 / d.rp - 1, d.wr, plane, kDwCi, Ci);
      cp_commit();
    };
    if (c_begin < c_end) stage(c_begin, 0);
    for (int ch = c_begin; ch < c_end; ++ch) {
      const int buf = (ch - c_begin) & 1;
      if (ch + 1 < c_end) {
        stage(ch + 1, buf ^ 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int b = ch / d.cpi, t0 = (ch - b * d.cpi) * d.px, wr0 = t0 / d.rp - 1;
      const float* xl = xs + buf * kDwCi * plane + lane * plane;
      const float* zl = dzs + buf * kDwCo * d.px + (8 * c8) * d.px;
#pragma unroll 1
      for (int p4 = half; p4 < d.px / 4; p4 += 4) {
        const int gp = t0 + 4 * p4;
        if (gp > last) break;
        const int row = gp / d.rp, col = gp - row * d.rp;
        if (col >= P) continue;  // padding: dz is zero there
        const float* xr = xl + (row - wr0) * rpp + col + 4;
        float v[3][6];
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
          const float* sp = xr + (dr - 1) * rpp;
          const float4 qv = *reinterpret_cast<const float4*>(sp);
          v[dr][0] = sp[-1], v[dr][1] = qv.x, v[dr][2] = qv.y, v[dr][3] = qv.z, v[dr][4] = qv.w;
          v[dr][5] = sp[4];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(zl + i * d.px + 4 * p4);
#pragma unroll
          for (int dr = 0; dr < 3; ++dr)
#pragma unroll
            for (int dc = 0; dc < 3; ++dc) {
              float s = acc[i][3 * dr + dc];
              s = fmaf(a.x, v[dr][dc], s);
              s = fmaf(a.y, v[dr][dc + 1], s);
              s = fmaf(a.z, v[dr][dc + 2], s);
              acc[i][3 * dr + dc] = fmaf(a.w, v[dr][dc + 3], s);
            }
        }
      }
      __syncthreads();  // this buffer is read before it is staged again
    }
    // the four pixel lanes' sums, in lane order
    float* red = reinterpret_cast<float*>(smem);  // [3 lanes][4 c8][32 lanes][72]
    const int stride = (kDwCo / 8) * 32 * 72;
    if (half > 0) {
      float* mine = red + (half - 1) * stride + (c8 * 32 + lane) * 72;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int t = 0; t < 9; ++t) mine[i * 9 + t] = acc[i][t];
    }
    __syncthreads();
    if (half == 0 && ci0 + lane < Ci) {
      const float* r = red + (c8 * 32 + lane) * 72;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int co = co0 + 8 * c8 + i;
        if (co < Co)
#pragma unroll
          for (int t = 0; t < 9; ++t)
            out[(long long)co * 9 * Ci + t * Ci + ci0 + lane] =
                acc[i][t] + r[i * 9 + t] + r[stride + i * 9 + t] + r[2 * stride + i * 9 + t];
      }
    }
  }
}

// ---- dx, then the final sums ---------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
k4_bwd_dx_kernel(const T* __restrict__ dz, const T* __restrict__ wdx, T* __restrict__ dx, int P,
                 int Ci, int Co, const float* __restrict__ part, int splits,
                 float* __restrict__ dw, const float* __restrict__ sums,
                 const float* __restrict__ dbp, int k, const float* __restrict__ scale,
                 float* __restrict__ dgamma, float* __restrict__ dbeta, float* __restrict__ dbias,
                 int B) {
  constexpr bool kTc = kIsTc<T>;
  using F = Frag<kTc>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g = geom(P, Co, Ci);  // the conv over dz: Co in, Ci out
  const int b = blockIdx.y;
  {
    Place<kTc> pl(g, blockIdx.x);
    float acc[F::NI][F::NJ];
    conv_tile<T>(acc, pl, g, dz + (long long)b * Co * g.N, wdx, smem);
    pl.locate(g);
    store_tile<kTc>(dx + (long long)b * Ci * g.N, pl, acc, Ci, g.N, vec_ok<kTc>(P));
  }
  // the final sums, spread over every thread of the grid, 4 lanes an
  // element: dW = its partials (lane l sums splits l, l + 4, ...), dbeta,
  // dgamma = sum over the rows of (scale + 1) S0 or S1, dbias = the rows'
  // and ranks' partials (lane l: rows l, l + 4, ...); then the 4 lanes' sums
  // in a fixed order
  const long long e_dw = (long long)Co * 9 * Ci, total = e_dw + 3LL * Co;
  const long long threads = (long long)gridDim.x * gridDim.y * kThreads;
  const unsigned quad = 0xfu << (threadIdx.x & 28);
  for (long long it = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + threadIdx.x;
       it < 4 * total; it += threads) {
    const long long e = it >> 2;
    const int l = (int)(it & 3);
    float s = 0.f;
    if (e < e_dw) {
#pragma unroll 4
      for (int sp = l; sp < splits; sp += 4) s += part[sp * e_dw + e];
    } else {
      const int which = (int)((e - e_dw) / Co), c = (int)((e - e_dw) % Co);
      for (int r = l; r < B; r += 4) {
        if (which < 2) {
          s = fmaf(scale[(long long)r * Co + c] + 1.f, sums[((long long)r * Co + c) * 2 + which], s);
        } else {
          for (int p = 0; p < k; ++p) s += dbp[((long long)r * k + p) * Co + c];
        }
      }
    }
    s += __shfl_xor_sync(quad, s, 1);
    s += __shfl_xor_sync(quad, s, 2);
    if (l == 0) {
      if (e < e_dw) dw[e] = s;
      else if (e < e_dw + Co) dbeta[e - e_dw] = s;
      else if (e < e_dw + 2 * Co) dgamma[e - e_dw - Co] = s;
      else dbias[e - e_dw - 2 * Co] = s;
    }
  }
}

// The plan's numbers, recomputed from the shape: the cluster (k), the dW
// splits, each kernel's shared memory, the workspace floats.
struct BwdPlan {
  int k, splits, smem_dz, smem_dw, smem_dx;
  long long sums, dbp, part, total;
};

BwdPlan bwd_plan(int B, int P, int Ci, int Co, int G, bool tc) {
  const Geom gx = geom(P, Co, Ci);
  const DwGeom d = dw_geom(P, Ci, Co, tc);
  BwdPlan p;
  p.k = dz_plan(P * P, Co).k;
  const int tiles = d.cot * d.cit, chunks = B * d.cpi;
  p.splits = cdiv(kDwBlocks, tiles);
  if (p.splits > chunks) p.splits = chunks;
  p.smem_dz = dz_smem(Co, G);
  p.smem_dw = dw_smem(P, Ci, Co, tc);
  p.smem_dx = conv_smem(gx, tc);
  p.sums = 0;
  p.dbp = 2LL * B * Co;
  p.part = p.dbp + (long long)B * p.k * Co;
  p.total = p.part + (long long)p.splits * Co * 9 * Ci;
  return p;
}

template <typename T>
int backward(const void* x, const void* wdx, const void* gamma, const void* beta,
             const void* scale, const void* shift, const void* dy, const void* z,
             const void* stats, void* dx, void* dw, void* dbias, void* dgamma, void* dbeta,
             void* dscale, void* dshift, void* dz, void* work, int B, int Ci, int Co, int P,
             int G, int k, int splits, int smem_dz, int smem_dw, int smem_dx, cudaStream_t st) {
  constexpr bool kTc = kIsTc<T>;
  const BwdPlan p = bwd_plan(B, P, Ci, Co, G, kTc);
  if (k != p.k || splits != p.splits || smem_dz != p.smem_dz || smem_dw != p.smem_dw ||
      smem_dx != p.smem_dx || B < 1 || B > 65535 || Ci % 16 || Co % 16 || Co % G)
    return (int)cudaErrorInvalidValue;
  float* ws = static_cast<float*>(work);
  const float* sc = static_cast<const float*>(scale);
  auto dz_args = [&](auto kernel) {
    return launch(kernel, dim3(k, B), kThreads, k, smem_dz, st, static_cast<const float*>(z),
                  static_cast<const T*>(dy), static_cast<const float*>(stats),
                  static_cast<const float*>(gamma), static_cast<const float*>(beta), sc,
                  static_cast<const float*>(shift), static_cast<T*>(dz), ws + p.sums, ws + p.dbp,
                  static_cast<float*>(dscale), static_cast<float*>(dshift), P * P, Co, G);
  };
  int err = (P * P) % 4 == 0 ? dz_args(k4_bwd_dz_kernel<T, 4>) : dz_args(k4_bwd_dz_kernel<T, 1>);
  if (err) return err;
  const DwGeom d = dw_geom(P, Ci, Co, kTc);
  err = launch(k4_bwd_dw_kernel<T>, dim3(d.cot * d.cit, splits),
               kTc ? kDwThreadsTc : kDwThreadsF, 0, smem_dw, st,
               static_cast<const T*>(x), static_cast<const T*>(dz), ws + p.part, B, P, Ci, Co,
               splits);
  if (err) return err;
  const Geom gx = geom(P, Co, Ci);
  return launch(k4_bwd_dx_kernel<T>, dim3(gx.tiles, B), kThreads, 0, smem_dx, st,
                static_cast<const T*>(dz),
                static_cast<const T*>(wdx), static_cast<T*>(dx), P, Ci, Co,
                static_cast<const float*>(ws + p.part), splits, static_cast<float*>(dw),
                static_cast<const float*>(ws + p.sums), static_cast<const float*>(ws + p.dbp), k,
                sc, static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                static_cast<float*>(dbias), B);
}

}  // namespace

// Floats of workspace that pidm_conv_gn_film_silu_bwd needs: each row's (S0,
// S1) per channel, each (row, cluster rank)'s dbias partials, and the dW
// partials of every split.
extern "C" long long pidm_conv_gn_film_silu_bwd_workspace(int B, int P, int Ci, int Co, int G,
                                                          int bf16) {
  return bwd_plan(B, P, Ci, Co, G, bf16 != 0).total;
}

// x: [B, Ci, P*P] and dy: [B, Co, P*P] fp32 (bf16 when `bf16` is 1); wdx:
// dx's weights in the route's layout, in x's type (bf16: the tap-flipped
// [Ci, 9 Co], wdx[ci, t Co + co] = wflat[co, (8 - t) Ci + ci]; fp32: its
// transpose [9 Co, Ci]); gamma, beta: [Co] fp32; scale, shift: [B, Co] fp32;
// z: the forward's fp32 z [B, Co, P*P]; stats: the forward's [B, G, 2];
// out: dx [B, Ci, P*P] in x's type, dw [Co, 9 Ci] fp32, dbias, dgamma, dbeta
// [Co] fp32, dscale, dshift [B, Co] fp32; dz: [B, Co, P*P] scratch in x's
// type; work: the workspace above. The plan (k, splits, each kernel's shared
// memory) comes from ops/conv_block.py `k4_plan` and is checked here.
// Launches on `stream`, allocates nothing, returns the CUDA error.
extern "C" int pidm_conv_gn_film_silu_bwd(const void* x, const void* wdx, const void* gamma,
                                          const void* beta, const void* scale, const void* shift,
                                          const void* dy, const void* z, const void* stats,
                                          void* dx, void* dw, void* dbias, void* dgamma,
                                          void* dbeta, void* dscale, void* dshift, void* dz,
                                          void* work, int B, int Ci, int Co, int P, int G, int k,
                                          int splits, int smem_dz, int smem_dw, int smem_dx,
                                          int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return backward<__nv_bfloat16>(x, wdx, gamma, beta, scale, shift, dy, z, stats, dx, dw,
                                   dbias, dgamma, dbeta, dscale, dshift, dz, work, B, Ci, Co, P,
                                   G, k, splits, smem_dz, smem_dw, smem_dx, st);
  return backward<float>(x, wdx, gamma, beta, scale, shift, dy, z, stats, dx, dw, dbias, dgamma,
                         dbeta, dscale, dshift, dz, work, B, Ci, Co, P, G, k, splits, smem_dz,
                         smem_dw, smem_dx, st);
}

// How many clusters of the dz kernel's plan (k blocks of smem bytes) the
// card holds at once; minus the CUDA error on failure.
extern "C" int pidm_conv_gn_film_silu_bwd_max_clusters(int k, int smem, int bf16) {
  return bf16 ? max_clusters(k4_bwd_dz_kernel<__nv_bfloat16, 4>, k, smem)
              : max_clusters(k4_bwd_dz_kernel<float, 4>, k, smem);
}
