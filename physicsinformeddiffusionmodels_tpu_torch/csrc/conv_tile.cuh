// The 3x3 convolution tiles of K4 (conv_block.cu, the forward; conv_block_bwd.cu,
// the backward), their layout on the card, and the shared-memory plan that
// ops/conv_block.py `k4_plan` mirrors.
//
// A conv tile is out[m, n] = sum_k W[m, k] im2col(src)[k, n], k = t * C + c,
// for BM output channels m and TPX pixels n of one batch row, src [C, P*P]
// channel-major, tap t = (dr + 1) * 3 + (dc + 1) as in the TPU kernel's
// `_TAPS` (pallas_conv.py:42) and `wflat` (`_flatten_w`, :331): zero-padded
// SAME, the tap reading src at (row + dr, col + dc).
//
// Pixels. A block's pixels are a range of a padded image whose rows have a
// pitch of rp = P rounded up to 8: the padded pixel gp is image pixel (gp /
// rp, gp % rp), real where the column is below P. Runs of 8 (bf16) or 4
// (fp32) padded pixels never cross a row, so a thread's run is contiguous
// in the image. Tile i of a row covers [i TPX, (i + 1) TPX).
//
// The input window. A block stages the rows its pixels span plus one halo
// row above and below, with a zero column on each side of every row, once
// per channel chunk: all nine taps read it from shared memory, and the zero
// border is the conv's padding, so no tap needs a mask (the TPU kernel's
// `_col_masks` and zero halo, :98).
//
// Two routes, chosen by x's type:
//   - bf16 x: the tensor cores, mma.sync m16n8k16 bf16 with fp32
//     accumulators (products of bf16 are exact in fp32, as the TPU's `_mmf`
//     takes them). The window is staged pixel-major, [pixel][32 channels]
//     (80-byte pitch: any 8 consecutive pixels are free of bank conflicts),
//     through registers (the global tensor is channel-major). ldmatrix reads
//     the B fragments straight from it, each lane addressing its own pixel,
//     shifted by the tap; W [BM][9 x 32] (592-byte pitch) gives the A
//     fragments. Warp tile 32 channels x 64 pixels.
//   - fp32 x: FFMA in full fp32 (TF32 off). The window is staged
//     channel-major, [8 channels][rows][rp + 8] (column c at index c + 4),
//     by cp.async, double-buffered with the weights [8][9][BM] (k-major,
//     from the wrapper's transposed weight). A lane holds 8 channels x two
//     runs of 4 pixels: per channel and tap row it loads one 16-byte run and
//     its two neighbours and uses them for the three taps of that row.
// Both give a thread 64 accumulators.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <tuple>
#include <type_traits>

#include "common.cuh"

namespace pidm {
namespace conv {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;  // 227 KB, the most shared memory a block may use
constexpr int kClusterMax = 8;    // blocks a batch row, at most (portable clusters)
constexpr int kKcTc = 32;         // channels a stage, bf16 route
constexpr int kKcF = 8;           // channels a stage, fp32 route
constexpr int kXp = kKcTc + 8;    // elements a staged pixel takes, bf16 route
constexpr int kWp = 9 * kKcTc + 8;  // elements a staged weight row takes, bf16 route
// the dW tile: 32 output channels x 32 input channels x 9 taps, over chunks
// of kDwPx padded pixels; about one block an SM in all
constexpr int kDwCo = 32, kDwCi = 32, kDwPxTc = 256, kDwPxF = 128, kDwBlocks = 132;
// the dW kernel's threads: 8 warps on bf16 x, 16 on fp32 x (4 pixel lanes)
constexpr int kDwThreadsTc = kThreads, kDwThreadsF = 2 * kThreads;

template <typename T>
constexpr bool kIsTc = std::is_same<T, __nv_bfloat16>::value;

// The geometry of a conv over cin -> cout channels on a P x P image.
struct Geom {
  int P, N, rp, cin, cout, bm, wm, wn, tpx, pt, ct, tiles, wr;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Window rows (halo included) that `px` consecutive padded pixels need.
__host__ __device__ inline int window_rows(int px, int rp, int P) {
  const int span = (px - 1) / rp + 2;
  return (span < P ? span : P) + 2;
}

__host__ __device__ inline Geom geom(int P, int cin, int cout) {
  Geom g;
  g.P = P;
  g.N = P * P;
  g.rp = cdiv(P, 8) * 8;
  g.cin = cin;
  g.cout = cout;
  g.bm = cout % 64 == 0 ? 64 : 32;
  g.wm = g.bm / 32;
  g.wn = kWarps / g.wm;
  g.tpx = g.wn * 64;
  g.pt = cdiv(P * g.rp, g.tpx);
  g.ct = cdiv(cout, g.bm);
  g.tiles = g.pt * g.ct;
  g.wr = window_rows(g.tpx, g.rp, P);
  return g;
}

// Bytes of the conv tile's staging buffers.
__host__ __device__ inline int conv_smem(const Geom& g, bool tc) {
  if (tc) return g.wr * (g.rp + 2) * kXp * 2 + g.bm * kWp * 2;
  return 2 * kKcF * g.wr * (g.rp + 8) * 4 + 2 * kKcF * 9 * g.bm * 4;
}

// Real pixels among the padded pixels [t0, t1).
__device__ inline int real_pixels(int t0, int t1, int rp, int P) {
  int n = 0;
  for (int r = t0 / rp; r * rp < t1; ++r) n += max(0, min(t1, r * rp + P) - max(t0, r * rp));
  return n;
}

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, or zeros when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the accumulator layouts --------------------------------------------
//
// A thread holds acc[i][j]: channel co(i) and pixel px(j) of its warp's 32 x
// 64 tile. Warp w of a block takes channel rows 32 (w / wn) and pixels 64
// (w % wn) of the block's BM x TPX tile.
template <bool kTc>
struct Frag;

template <>
struct Frag<true> {  // mma.sync m16n8k16: 2 x 8 tiles of 16 x 8 a warp
  static constexpr int NI = 4, NJ = 16, kVec = 2;
  __device__ static int co(int i) { return (i >> 1) * 16 + (i & 1) * 8 + ((threadIdx.x & 31) >> 2); }
  __device__ static int px(int j) { return (j >> 1) * 8 + 2 * (threadIdx.x & 3) + (j & 1); }
};

template <>
struct Frag<false> {  // FFMA: lane (c8 = lane / 8, q = lane % 8): 8 channels x 2 runs of 4
  static constexpr int NI = 8, NJ = 8, kVec = 4;
  __device__ static int co(int i) { return ((threadIdx.x & 31) >> 3) * 8 + i; }
  __device__ static int px(int j) { return (j >> 2) * 32 + 4 * (threadIdx.x & 7) + (j & 3); }
};

// Where this thread's accumulators lie: a block tile of a batch row. The
// constructor places the tile (what conv_tile needs); locate() then finds
// each accumulator's image pixel, after the conv, so that the per-pixel
// state is not held in registers through it.
template <bool kTc>
struct Place {
  using F = Frag<kTc>;
  int m0, t0, wr0;        // first channel, first padded pixel, first window row
  int cw, pw;             // the warp's first channel and pixel in the tile
  int gi[F::NJ];          // image pixel of each j (valid where vmask has it)
  uint32_t vmask;         // j -> a real pixel
  __device__ Place(const Geom& g, int tile) {
    const int i = tile / g.ct, j = tile - i * g.ct, w = threadIdx.x >> 5;
    m0 = j * g.bm;
    t0 = i * g.tpx;
    wr0 = t0 / g.rp - 1;
    cw = (w / g.wn) * 32;
    pw = (w % g.wn) * 64;
  }
  __device__ void locate(const Geom& g) {
    const int end = min(t0 + g.tpx, g.P * g.rp);
    vmask = 0;
#pragma unroll
    for (int jj = 0; jj < F::NJ; ++jj) {
      const int gp = t0 + pw + F::px(jj), row = gp / g.rp, col = gp - row * g.rp;
      const bool ok = gp < end && col < g.P;
      gi[jj] = ok ? row * g.P + col : 0;
      vmask |= (ok ? 1u : 0u) << jj;
    }
  }
  __device__ int channel(int i) const { return m0 + cw + F::co(i); }
};

// ---- staging ---------------------------------------------------------------

// bf16 window, pixel-major: xs[(rr (rp + 2) + cc) kXp + c] = src[c0 + c][(wr0 +
// rr) P + cc - 1] for rr < wr, cc < rp + 2, c < kKcTc; zero outside the image
// and past cin. A thread takes a pixel pair and 8 channels: 8 loads of 4
// bytes (2 bytes when P is odd), consecutive threads on consecutive pairs,
// kBatch items' loads all issued before their stores.
template <int kBatch = 2>
__device__ inline void stage_window_tc(__nv_bfloat16* xs, const __nv_bfloat16* __restrict__ src,
                                       int cin, int c0, int P, int rp, int wr0, int wr) {
  const int pitch = rp + 2, half = rp / 2, pairs = wr * half, total = 4 * pairs;
  const long long N = (long long)P * P;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  // the zero columns cc = 0 and cc = rp + 1 (image columns -1 and >= P)
  for (int it = threadIdx.x; it < 8 * wr; it += kThreads)
    *reinterpret_cast<uint4*>(xs + ((it >> 3) * pitch + ((it >> 2) & 1) * (rp + 1)) * kXp +
                              8 * (it & 3)) = make_uint4(0u, 0u, 0u, 0u);
  for (int it0 = threadIdx.x; it0 < total; it0 += kBatch * kThreads) {
    uint32_t v[kBatch][8];  // channel e's pixels (2m, 2m + 1), the first in the low half
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = it0 + u * kThreads, o = it / pairs, pp = it - o * pairs;
      const int rr = pp / half, row = wr0 + rr, col = 2 * (pp - rr * half), c = c0 + 8 * o;
      const bool ok = it < total && row >= 0 && row < P && col < P && c < cin;
      const long long at = ok ? c * N + row * P + col : 0;
      if (P % 2 == 0) {  // the pair is 4-byte aligned and both pixels are real
        const uint32_t* p = reinterpret_cast<const uint32_t*>(s16 + at);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = ok ? p[e * (N / 2)] : 0u;
      } else {
        const bool ok1 = ok && col + 1 < P;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[u][e] = (ok ? (uint32_t)s16[at + e * N] : 0u) |
                    ((ok1 ? (uint32_t)s16[at + e * N + 1] : 0u) << 16);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = it0 + u * kThreads, o = it / pairs, pp = it - o * pairs;
      if (it >= total) break;
      const int rr = pp / half, px = rr * pitch + 2 * (pp - rr * half) + 1;
      uint4 lo, hi;
      lo.x = __byte_perm(v[u][0], v[u][1], 0x5410), hi.x = __byte_perm(v[u][0], v[u][1], 0x7632);
      lo.y = __byte_perm(v[u][2], v[u][3], 0x5410), hi.y = __byte_perm(v[u][2], v[u][3], 0x7632);
      lo.z = __byte_perm(v[u][4], v[u][5], 0x5410), hi.z = __byte_perm(v[u][4], v[u][5], 0x7632);
      lo.w = __byte_perm(v[u][6], v[u][7], 0x5410), hi.w = __byte_perm(v[u][6], v[u][7], 0x7632);
      *reinterpret_cast<uint4*>(xs + px * kXp + 8 * o) = lo;
      *reinterpret_cast<uint4*>(xs + (px + 1) * kXp + 8 * o) = hi;
    }
  }
}

// bf16 weights of a chunk: ws[co kWp + t kKcTc + c] = w[m0 + co][t cin + c0 + c]
// (w row-major [cout][9 cin]); zero past cout and cin. cp.async, not waited.
__device__ inline void stage_weights_tc(__nv_bfloat16* ws, const __nv_bfloat16* __restrict__ w,
                                        int cin, int cout, int bm, int m0, int c0) {
  for (int it = threadIdx.x; it < bm * 36; it += kThreads) {
    const int piece = it & 3, t = (it >> 2) % 9, co = it / 36, c = c0 + 8 * piece;
    const bool ok = m0 + co < cout && c < cin;
    cp_async16(ws + co * kWp + t * kKcTc + 8 * piece,
               ok ? w + (long long)(m0 + co) * 9 * cin + t * cin + c : w, ok);
  }
}

// fp32 window, channel-major: xs[c plane + rr (rp + 8) + 4 + col] = src[c0 +
// c][(wr0 + rr) P + col] for c < kKcF, rr < wr, col in [-4, rp + 4); zero
// outside the image and past cin. cp.async (16 bytes when P % 4 == 0), not
// waited. kT threads take part.
template <int kT = kThreads>
__device__ inline void stage_window_f(float* xs, const float* __restrict__ src, int c0, int P,
                                      int rp, int wr0, int wr, int plane, int nch = kKcF,
                                      int cin = 1 << 30) {
  const int rpp = rp + 8, q4 = rpp / 4;
  const long long N = (long long)P * P;
  for (int it = threadIdx.x; it < nch * wr * q4; it += kT) {
    const int qd = it % q4, rest = it / q4, rr = rest % wr, c = rest / wr;
    const int row = wr0 + rr, col0 = 4 * qd - 4;
    float* dst = xs + c * plane + rr * rpp + 4 * qd;
    const float* s = src + (c0 + c) * N + (long long)row * P;
    const bool row_ok = row >= 0 && row < P && c0 + c < cin;
    if (P % 4 == 0) {
      const bool ok = row_ok && col0 >= 0 && col0 < P;
      cp_async16(dst, ok ? s + col0 : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && col0 + e >= 0 && col0 + e < P;
        cp_async4(dst + e, ok ? s + col0 + e : src, ok);
      }
    }
  }
}

// fp32 weights of a chunk: ws[(c 9 + t) bm + co] = wt[t cin + c0 + c][m0 + co]
// (wt k-major [9 cin][cout]); zero past cout. cp.async, not waited.
__device__ inline void stage_weights_f(float* ws, const float* __restrict__ wt, int cin,
                                       int cout, int bm, int m0, int c0) {
  const int q = bm / 4;
  for (int it = threadIdx.x; it < kKcF * 9 * q; it += kThreads) {
    const int piece = it % q, ct = it / q, c = ct / 9, t = ct - c * 9;
    const bool ok = m0 + 4 * piece < cout;
    cp_async16(ws + ct * bm + 4 * piece,
               ok ? wt + (long long)(t * cin + c0 + c) * cout + m0 + 4 * piece : wt, ok);
  }
}

// ---- the conv tile ----------------------------------------------------------

// acc = W[m0 : m0 + BM] im2col(src)[:, pixels of the tile] for this thread's
// accumulators; w in the route's layout (bf16: [cout][9 cin]; fp32: [9 cin]
// [cout]). smem holds conv_smem() bytes. Returns with the block synced.
template <typename T>
__device__ void conv_tile(float (&acc)[Frag<kIsTc<T>>::NI][Frag<kIsTc<T>>::NJ],
                          const Place<kIsTc<T>>& pl, const Geom& g, const T* __restrict__ src,
                          const T* __restrict__ w, unsigned char* smem) {
  constexpr bool kTc = kIsTc<T>;
  using F = Frag<kTc>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < F::NI; ++i)
#pragma unroll
    for (int j = 0; j < F::NJ; ++j) acc[i][j] = 0.f;
  const int last = g.P * g.rp - 1;
  if constexpr (kTc) {
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* ws = xs + g.wr * (g.rp + 2) * kXp;
    // this lane's pixel row of each ldmatrix.x4 (two n-tiles): its window pixel
    int base[4];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int gp = min(pl.t0 + pl.pw + (2 * np + (lane >> 4)) * 8 + (lane & 7), last);
      const int row = gp / g.rp;
      base[np] = ((row - pl.wr0) * (g.rp + 2) + gp - row * g.rp + 1) * kXp + ((lane >> 3) & 1) * 8;
    }
    const __nv_bfloat16* wrow = ws + (pl.cw + (lane & 15)) * kWp + (lane >> 4) * 8;
    for (int c0 = 0; c0 < g.cin; c0 += kKcTc) {
      __syncthreads();  // the previous chunk is read
      stage_weights_tc(ws, w, g.cin, g.cout, g.bm, pl.m0, c0);
      cp_commit();
      stage_window_tc(xs, src, g.cin, c0, g.P, g.rp, pl.wr0, g.wr);
      cp_wait<0>();
      __syncthreads();
      const int ks_n = min(kKcTc, g.cin - c0) / 16;
#pragma unroll 1
      for (int t = 0; t < 9; ++t) {
        const int toff = ((t / 3 - 1) * (g.rp + 2) + t % 3 - 1) * kXp;
        for (int ks = 0; ks < ks_n; ++ks) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) ldsm_x4(a[mt], wrow + mt * 16 * kWp + t * kKcTc + ks * 16);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            ldsm_x4(b, xs + base[np] + toff + ks * 16);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int nt = 2 * np + h;
                float c[4] = {acc[2 * mt][2 * nt], acc[2 * mt][2 * nt + 1],
                              acc[2 * mt + 1][2 * nt], acc[2 * mt + 1][2 * nt + 1]};
                mma(c, a[mt], b[2 * h], b[2 * h + 1]);
                acc[2 * mt][2 * nt] = c[0], acc[2 * mt][2 * nt + 1] = c[1];
                acc[2 * mt + 1][2 * nt] = c[2], acc[2 * mt + 1][2 * nt + 1] = c[3];
              }
          }
        }
      }
    }
    __syncthreads();
  } else {
    const int rpp = g.rp + 8, plane = g.wr * rpp;
    float* xs = reinterpret_cast<float*>(smem);              // [2][kKcF][plane]
    float* ws = xs + 2 * kKcF * plane;                        // [2][kKcF][9][bm]
    int xoff[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gp = min(pl.t0 + pl.pw + h * 32 + 4 * (lane & 7), last - 3);
      const int row = gp / g.rp;
      xoff[h] = (row - pl.wr0) * rpp + gp - row * g.rp + 4;
    }
    const int wco = pl.cw + (lane >> 3) * 8;
    const int chunks = g.cin / kKcF;
    __syncthreads();  // the buffers may still be read by an earlier tile
    stage_weights_f(ws, w, g.cin, g.cout, g.bm, pl.m0, 0);
    stage_window_f(xs, src, 0, g.P, g.rp, pl.wr0, g.wr, plane);
    cp_commit();
    for (int ch = 0; ch < chunks; ++ch) {
      const int buf = ch & 1;
      if (ch + 1 < chunks) {
        stage_weights_f(ws + (buf ^ 1) * kKcF * 9 * g.bm, w, g.cin, g.cout, g.bm, pl.m0,
                        (ch + 1) * kKcF);
        stage_window_f(xs + (buf ^ 1) * kKcF * plane, src, (ch + 1) * kKcF, g.P, g.rp, pl.wr0,
                       g.wr, plane);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const float* xb = xs + buf * kKcF * plane;
      const float* wb = ws + buf * kKcF * 9 * g.bm + wco;
#pragma unroll 1
      for (int kc = 0; kc < kKcF; ++kc) {
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
          float v[2][6];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* s = xb + kc * plane + xoff[h] + (dr - 1) * rpp;
            const float4 q = *reinterpret_cast<const float4*>(s);
            v[h][0] = s[-1], v[h][1] = q.x, v[h][2] = q.y, v[h][3] = q.z, v[h][4] = q.w;
            v[h][5] = s[4];
          }
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            const float* wt = wb + (kc * 9 + dr * 3 + dc) * g.bm;
            const float4 a0 = *reinterpret_cast<const float4*>(wt);
            const float4 a1 = *reinterpret_cast<const float4*>(wt + 4);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[i][4 * h + e] = fmaf(a[i], v[h][e + dc], acc[i][4 * h + e]);
          }
        }
      }
      __syncthreads();  // this buffer is read before it is staged again
    }
  }
}

// ---- loads and stores of a tile's pixels -----------------------------------

// dst[channel(i)][gi[j]] = v[j] in T, at real pixels and channels < cout.
template <bool kTc, typename T>
__device__ inline void store_row(T* __restrict__ dst, const Place<kTc>& pl, int i,
                                 const float (&v)[Frag<kTc>::NJ], int cout, long long N, bool vec) {
  using F = Frag<kTc>;
  constexpr uint32_t kRun = (1u << F::kVec) - 1;
  const int co = pl.channel(i);
  if (co >= cout) return;
  T* row = dst + (long long)co * N;
#pragma unroll
  for (int j = 0; j < F::NJ; j += F::kVec) {
    const uint32_t run = (pl.vmask >> j) & kRun;
    if (vec && run == kRun) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value && F::kVec == 2) {
        *reinterpret_cast<__nv_bfloat162*>(row + pl.gi[j]) = __floats2bfloat162_rn(v[j], v[j + 1]);
      } else if constexpr (std::is_same<T, float>::value && F::kVec == 4) {
        *reinterpret_cast<float4*>(row + pl.gi[j]) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < F::kVec; ++e) row[pl.gi[j + e]] = from_f32<T>(v[j + e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < F::kVec; ++e)
        if ((run >> e) & 1u) row[pl.gi[j + e]] = from_f32<T>(v[j + e]);
    }
  }
}

template <bool kTc, typename T>
__device__ inline void store_tile(T* __restrict__ dst, const Place<kTc>& pl,
                                  const float (&v)[Frag<kTc>::NI][Frag<kTc>::NJ], int cout,
                                  long long N, bool vec) {
#pragma unroll
  for (int i = 0; i < Frag<kTc>::NI; ++i) store_row<kTc>(dst, pl, i, v[i], cout, N, vec);
}

// V consecutive elements at p to fp32 (V = 4: an aligned vector).
template <typename T, int V>
__device__ __forceinline__ void load_v(float (&f)[V], const T* __restrict__ p) {
  if constexpr (V == 4 && std::is_same<T, float>::value) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  } else if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x, f[1] = a.y, f[2] = c.x, f[3] = c.y;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = to_f32(p[e]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V == 4 && std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else if constexpr (V == 4) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(f[0], f[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(f[2], f[3]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = from_f32<T>(f[e]);
  }
}

// Sum over the tpc lanes that share a channel (all lanes of a warp take part).
__device__ __forceinline__ float lane_sum(float v, int tpc) {
  for (int o = 1; o < tpc; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether the vector loads and stores of load_tile / store_tile are aligned.
template <bool kTc>
__device__ inline bool vec_ok(int P) {
  return P % Frag<kTc>::kVec == 0;
}

// ---- a tile's z in shared memory ----------------------------------------------

// zs[c][p] = acc + bias for the tile's local channel c and padded pixel p
// (zs [BM][TPX + 8] fp32 over the staging buffers; the block is synced
// before and after).
template <bool kTc>
__device__ inline void dump_tile(float* zs, const Place<kTc>& pl, const Geom& g,
                                 float (&acc)[Frag<kTc>::NI][Frag<kTc>::NJ],
                                 const float* __restrict__ bias) {
  using F = Frag<kTc>;
  const int zp = g.tpx + 8;
#pragma unroll
  for (int i = 0; i < F::NI; ++i) {
    const int c = pl.cw + F::co(i);
    const float bi = pl.m0 + c < g.cout ? bias[pl.m0 + c] : 0.f;
    float* row = zs + c * zp + pl.pw;
#pragma unroll
    for (int j = 0; j < F::NJ; j += F::kVec) {
      if constexpr (kTc) {
        *reinterpret_cast<float2*>(row + F::px(j)) = make_float2(acc[i][j] + bi, acc[i][j + 1] + bi);
      } else {
        *reinterpret_cast<float4*>(row + F::px(j)) = make_float4(
            acc[i][j] + bi, acc[i][j + 1] + bi, acc[i][j + 2] + bi, acc[i][j + 3] + bi);
      }
    }
  }
  __syncthreads();
}

// The shared-memory loops over a tile's z: kThreads / BM consecutive threads
// (tpc) share channel `cl` of the tile; lane l takes the runs of 4 padded
// pixels l, l + tpc, ... (kRuns of them), consecutive lanes on consecutive
// runs. A run lies in one image row: its first pixel's image index and
// column, or column P where the run is past the image.
constexpr int kRuns = 16;  // BM TPX = 16384 = kThreads 4 kRuns

struct Runs {
  int tpc, cl, lane;
  int n[kRuns], col[kRuns];
  __device__ Runs(const Geom& g, int t0) {
    tpc = kThreads / g.bm;
    cl = threadIdx.x / tpc;
    lane = threadIdx.x - cl * tpc;
    const int end = min(t0 + g.tpx, g.P * g.rp);
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const int gp = t0 + 4 * (lane + tpc * i), row = gp / g.rp, c = gp - row * g.rp;
      n[i] = row * g.P + c;
      col[i] = gp < end ? c : g.P;
    }
  }
  __device__ const float4& at(const float* zs, const Geom& g, int i) const {
    return *reinterpret_cast<const float4*>(zs + cl * (g.tpx + 8) + 4 * (lane + tpc * i));
  }
  __device__ float sum(float v) const { return lane_sum(v, tpc); }
};

// ---- statistics and activations ----------------------------------------------

// Chan's parallel merge of (n_b, mean_b, m2_b) into (n_a, mean_a, m2_a).
__device__ inline void chan_merge(float& n_a, float& mean_a, float& m2_a, float n_b, float mean_b,
                                  float m2_b) {
  if (n_b == 0.f) return;
  const float n = n_a + n_b, d = mean_b - mean_a;
  mean_a += d * (n_b / n);
  m2_a += m2_b + d * d * (n_a * n_b / n);
  n_a = n;
}

__device__ __forceinline__ float silu(float y) { return __fdividef(y, 1.f + __expf(-y)); }

// d silu(y) / dy
__device__ __forceinline__ float silu_grad(float y) {
  const float sig = 1.f / (1.f + expf(-y));
  return sig * (1.f + y * (1.f - sig));
}

// The two halves of cluster.sync(): after cluster_arrive() a block reads no
// other block's shared memory; cluster_wait() returns once every block of
// the cluster has arrived, so none exits while another still reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- launches ----------------------------------------------------------------

template <typename... Params>
cudaError_t allow(void (*kernel)(Params...), bool cluster) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemMax);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

inline cudaLaunchConfig_t config(dim3 grid, int smem, cudaStream_t st, cudaLaunchAttribute* attr,
                                 int k, int threads = kThreads) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  if (k > 0) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// How many clusters of k blocks with `smem` bytes each the card holds at
// once for `kernel` (0: it cannot schedule them), or minus the CUDA error.
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int k, int smem) {
  if (k < 1 || k > kClusterMax || smem < 0 || smem > kSmemMax) return -(int)cudaErrorInvalidValue;
  cudaError_t err = allow(kernel, true);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(dim3(k, 1, 1), smem, 0, attr, k);
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// Launches `kernel` on `grid` of blocks of `threads`, with `smem` bytes of
// dynamic shared memory, in clusters of k blocks along x when k > 0. The
// first launch of a (kernel,
// device, k, smem) sets the kernel's attributes and, for a cluster, asks the
// card how many such clusters it holds at once: none, and the launch is
// refused (cudaErrorInvalidConfiguration). Returns the CUDA error.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, int k, int smem, cudaStream_t st,
           Args... args) {
  if (smem < 0 || smem > kSmemMax || k > kClusterMax) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(grid, smem, st, attr, k, threads);
  static std::mutex mu;
  static std::set<std::tuple<const void*, int, int, int>> checked;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple((const void*)kernel, dev, k, smem);
    if (!checked.count(key)) {
      err = allow(kernel, k > 0);
      if (err != cudaSuccess) return (int)err;
      if (k > 0) {
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
      }
      checked.insert(key);
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // namespace conv
}  // namespace pidm
