// K5: GroupNorm -> affine -> FiLM -> SiLU on a bf16 [B, N, C] activation,
// forward only. Per (row, group), over its N x C/G values: the sums of x
// and x^2 in fp32, inv = rsqrt(E[x^2] - mean^2 + eps) (the one-pass
// variance, not K2's centred sums), then, with the affine and FiLM folded
// into a = gamma (scale + 1) and b = beta (scale + 1) + shift,
//   y = x (a inv) + (b - mean a inv),  out = y sigmoid(y),
// rounded to bf16.
//
// Replaces scripts/profile_gn.py `_fwd_kernel_packed` (launched by
// `gn_packed` through pl.pallas_call). The TPU kernel views the row as
// [N C / 128, 128] lanes so that a vreg row is dense, and sums each group's
// lanes with a 128 x 128 0/1 mask matmul on the MXU; both are how the TPU
// lays lanes out, not part of what it computes. It holds 8 rows in VMEM and
// reads x once.
//
// Bound on the H100: memory. About 10 flops an element against 4 bytes
// (bf16 read and written once). One launch a call, with nothing around it:
// the FiLM fold is done by each thread for its own 8 channels (gamma, beta
// and the row's scale and shift, C <= 128 values each), and no scratch
// leaves the chip. One thread-block cluster of k blocks a batch row, grid
// (k, B), 256 threads a block (launched by gn_cluster.cuh's
// launch_cluster; the plan comes from ops/group_norm.py `k5_plan`). Block q
// takes tokens [q ts, min(N, (q + 1) ts)) and
//   1. copies the first rt of them (its resident part) into shared memory
//      with Hopper's bulk asynchronous copy (cp.async.bulk), in chunks of
//      kChunkVecs 16-byte vectors, each completed on its own mbarrier, so
//      the sums start on the first chunk while the others arrive;
//   2. sums x and x^2 per channel, a thread always meeting the same 8
//      channels (256 x 8 is a multiple of C), then folds lanes, warps and
//      the group's channels in a fixed order into the slice's [G, 2] sums;
//   3. after the cluster barrier adds the k slices' sums in rank order,
//      read through distributed shared memory (no atomics: a result
//      repeats bit for bit);
//   4. applies y from shared memory and writes with 16-byte stores;
//   5. waits at the cluster barrier before it exits, so that no block's
//      sums vanish while another block still reads them.
// x is read from device memory once. A row larger than the cluster's
// shared memory is the plan's re-read mode: the tokens past rt are read
// from global memory in the sums and again (from L2) in the apply.
// Any N; C in {8, 16, 32, 64, 128} (C % 8 == 0, 128 % C == 0), G | C.

#include <vector>

#include "gn_cluster.cuh"

namespace {

using namespace pidm::gn;

constexpr int kVec = 8;             // bf16 values per 16-byte vector
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 128;
constexpr int kChunkVecs = 2048;    // 32 KB a bulk copy, a multiple of kThreads
constexpr int kMaxChunks = 8;       // mbarriers a block: 256 KB, more than a block holds

// Shared memory besides the resident slice (ops/group_norm.py `_k5_aux`):
// the mbarriers, the warps' per-channel sums, the channel and group sums.
__host__ __device__ inline long long k5_aux_bytes(int C, int G) {
  return 8LL * kMaxChunks + 4LL * (2 * kWarps * C + 2 * C + 4 * G);
}

__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of transactions, then a bulk copy
// of `bytes` from global src to shared dst that completes them.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Spins until the mbarrier's phase 0 has completed (its one copy landed).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

__global__ void __launch_bounds__(kThreads)
gnp_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, const float* __restrict__ gamma,
           const float* __restrict__ beta, const float* __restrict__ scale,
           const float* __restrict__ shift, int N, int C, int G, int ts, int rt, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks(), q = (int)cluster.block_rank(), b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, cgs = C / G;
  const int rows = rows_of(q, N, ts);
  const int nv = rows * C / kVec, rv = min(rows, rt) * C / kVec;  // vectors: all, resident
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xs = reinterpret_cast<uint4*>(smem);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + slice_bytes(rt, C, sizeof(__nv_bfloat16)));
  float* red = reinterpret_cast<float*>(bars + kMaxChunks);  // [2][kWarps][C]
  float* chan = red + 2 * kWarps * C;                        // [2][C]
  float* part = chan + 2 * C;                                // [G][2] the slice's sums
  float* gstat = part + 2 * G;                               // [G][2] the row's mean, inv
  const long long v0 = ((long long)b * N + (long long)q * ts) * C / kVec;
  const uint4* xr = x + v0;
  uint4* outr = out + v0;
  const int nchunks = (rv + kChunkVecs - 1) / kChunkVecs;

  if (tid == 0) {
    for (int i = 0; i < nchunks; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < nchunks; ++i) {
      const int c0 = i * kChunkVecs, cn = min(rv - c0, kChunkVecs);
      bulk_load(xs + c0, xr + c0, (unsigned)cn * 16u, bars + i);
    }

  // the FiLM fold of this thread's 8 channels, while the copies land
  const int c0 = (tid * kVec) % C;  // the same for every vector this thread visits
  float a[kVec], bb[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float sc1 = scale[(long long)b * C + c0 + j] + 1.f;
    a[j] = gamma[c0 + j] * sc1;
    bb[j] = beta[c0 + j] * sc1 + shift[(long long)b * C + c0 + j];
  }

  // per-channel sums of x and x^2 over the slice
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
  auto add = [&](const uint4& u) {
    float f[kVec];
    unpack(u, f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s1[j] += f[j];
      s2[j] = fmaf(f[j], f[j], s2[j]);
    }
  };
  for (int i = 0; i < nchunks; ++i) {
    mbar_wait(bars + i);
    const int end = min(rv, (i + 1) * kChunkVecs);
    for (int v = i * kChunkVecs + tid; v < end; v += kThreads) add(xs[v]);
  }
  for (int v = rv + ((tid - rv) % kThreads + kThreads) % kThreads; v < nv; v += kThreads)
    add(xr[v]);  // the re-read mode's tokens past the resident part
  // lanes l and l + C/8 start at the same channel: fold them, in a fixed
  // order, down to lanes [0, C/8); then the warps, then the group's channels
  const int period = C / kVec;
  for (int o = 16; o >= period; o >>= 1) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], o);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], o);
    }
  }
  if (lane < period) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      red[warp * C + lane * kVec + j] = s1[j];
      red[(kWarps + warp) * C + lane * kVec + j] = s2[j];
    }
  }
  __syncthreads();
  if (tid < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      t1 += red[w * C + tid];
      t2 += red[(kWarps + w) * C + tid];
    }
    chan[tid] = t1;
    chan[C + tid] = t2;
  }
  __syncthreads();
  if (tid < G) {
    float t1 = 0.f, t2 = 0.f;
    for (int c = tid * cgs; c < (tid + 1) * cgs; ++c) {
      t1 += chan[c];
      t2 += chan[C + c];
    }
    part[2 * tid] = t1;
    part[2 * tid + 1] = t2;
  }

  // the row's statistics: the k slices' sums added in rank order
  cluster.sync();
  if (tid < G) {
    float t1 = 0.f, t2 = 0.f;
    for (int p = 0; p < k; ++p) {
      const float* rp = cluster.map_shared_rank(part, p);
      t1 += rp[2 * tid];
      t2 += rp[2 * tid + 1];
    }
    const float cnt = (float)N * (float)cgs;
    const float mean = t1 / cnt;
    gstat[2 * tid] = mean;
    gstat[2 * tid + 1] = rsqrtf(t2 / cnt - mean * mean + eps);
  }
  cluster_arrive();  // this block reads no other block's sums from here on
  __syncthreads();

  // y = x (a inv) + (b - mean a inv), out = y sigmoid(y)
  float m[kVec], o[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int g = (c0 + j) / cgs;
    m[j] = a[j] * gstat[2 * g + 1];
    o[j] = bb[j] - gstat[2 * g] * m[j];
  }
  auto apply = [&](const uint4& u, uint4* dst) {
    float f[kVec];
    unpack(u, f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float y = fmaf(f[j], m[j], o[j]);
      f[j] = __fdividef(y, 1.f + __expf(-y));
    }
    *dst = pack(f);
  };
  for (int v = tid; v < rv; v += kThreads) apply(xs[v], outr + v);
  for (int v = rv + ((tid - rv) % kThreads + kThreads) % kThreads; v < nv; v += kThreads)
    apply(xr[v], outr + v);
  cluster_wait();
}

}  // namespace

// x, out: [B, N, C] bf16, 16-byte aligned; gamma, beta: [C] fp32; scale,
// shift: [B, C] fp32. The plan (k blocks a row, ts tokens a block, rt of
// them resident, smem bytes a block) comes from ops/group_norm.py
// `k5_plan`. C % 8 == 0, 128 % C == 0, C % G == 0. Launches on `stream`,
// allocates nothing, returns the CUDA error.
extern "C" int pidm_gn_film_silu_packed(const void* x, void* out, const void* gamma,
                                        const void* beta, const void* scale, const void* shift,
                                        int B, int N, int C, int G, int k, int ts, int rt,
                                        int smem, float eps, void* stream) {
  if (C % kVec || kMaxC % C || C % G ||
      (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out)) % 16 ||
      (long long)rt * C * 2 > (long long)kMaxChunks * kChunkVecs * 16)
    return (int)cudaErrorInvalidValue;
  const long long need = slice_bytes(rt, C, 2) + k5_aux_bytes(C, G);
  return launch_cluster(gnp_kernel, k, B, N, C, 2, ts, rt, smem, need,
                        static_cast<cudaStream_t>(stream), static_cast<const uint4*>(x),
                        static_cast<uint4*>(out), static_cast<const float*>(gamma),
                        static_cast<const float*>(beta), static_cast<const float*>(scale),
                        static_cast<const float*>(shift), N, C, G, ts, rt, eps);
}

// How many clusters of k blocks with `smem` bytes each the card holds at
// once (0: it cannot schedule the plan), or minus the CUDA error.
extern "C" int pidm_gn_film_silu_packed_max_clusters(int k, int smem) {
  return max_clusters(gnp_kernel, k, smem);
}

// The nodes of a CUDA graph (cudaGraph_t), and in *kernels its kernel
// nodes, or minus the CUDA error: how chip_smoke.py and profile_gn show that
// one K5 call is one kernel and nothing else.
extern "C" int pidm_graph_nodes(void* graph, int* kernels) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  std::vector<cudaGraphNode_t> nodes(n);
  if (err == cudaSuccess && n) err = cudaGraphGetNodes(g, nodes.data(), &n);
  int k = 0;
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    k += type == cudaGraphNodeTypeKernel;
  }
  if (err != cudaSuccess) return -(int)err;
  *kernels = k;
  return (int)n;
}
