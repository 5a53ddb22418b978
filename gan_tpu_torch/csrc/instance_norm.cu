// Instance norm forward (+ optional activation epilogue) and backward for
// Hopper (sm_90a), with H*W split over a thread-block cluster.
//
// instance_norm_fwd_kernel replaces gan_tpu/ops/pallas_kernels.py:_in_fwd_kernel
// (K1, with its K3 activation epilogue). Same math: per (sample, channel)
// statistics over H*W in fp32, y = (x - mean) * rsqrt(var + eps) * gamma + beta,
// then optional LeakyReLU(0.3) / ReLU, cast back to the input type once. The
// variance is a two-pass sum of squares about the mean, not the Pallas
// kernel's E[x^2] - mean^2, which loses precision (and can go negative) on
// activations with a large mean.
//
// instance_norm_bwd_kernel replaces pallas_kernels.py:_in_bwd_kernel (K2), the
// backward of the norm without an activation: with x^ = (x - mean) * inv,
//   dx = inv * (dy*gamma - mean(dy*gamma) - x^ * mean(dy*gamma*x^)),
//   dgamma = sum over N, H*W of dy*x^,   dbeta = sum over N, H*W of dy.
// It recomputes mean and inv with the forward's code (band_mean, merge_bands)
// and plan, so x^ is bit for bit the forward's. dgamma and dbeta leave the
// kernel as per-sample partials (N, C) in fp32, which the caller sums over N,
// as _in_backward does; no atomics, so the sums do not change from run to run.
//
// Layout: x (and dy, dx, y) is NHWC, contiguous, viewed as (N, HW, C) -- the
// Pallas kernels' own view. gamma and beta are fp32 (C,).
//
// What bounds them: bytes. K1 must read x once and write y once; K2 must read
// x and dy once and write dx once; both do a handful of flops per element.
//
// The design. One cluster of k blocks owns one (sample, channel tile); block
// `rank` of it owns a band of `rows` consecutive rows of H*W. The geometry
// (block size, k, channel tile, rows, staging) is chosen on the host
// (gan_tpu_torch/ops/kernels.py:norm_plan) so that the large sites put a few
// hundred blocks, two or three to an SM, on the 132 SMs. A thread loads 16
// bytes at a time (8 bf16 or 4 fp32 consecutive channels; 1 channel where C
// is not a multiple of that or a tensor is not 16-byte aligned). Each block
// copies its band of x (and, in K2, of dy where both fit) into shared memory
// with cp.async, so x leaves HBM once. It takes the band's mean and then its
// sum of squares about that mean from shared memory (a multiply by 1/rows per
// channel, no per-element division), summed in a fixed order (warp shuffles,
// then the warps in order). Every block stores its band's (mean, M2) into
// every block of the cluster through distributed shared memory; after
// cluster.sync() each thread merges the k bands in rank order 0..k-1 (Chan et
// al.: mean = sum(n_q mean_q) / HW, M2 = sum(M2_q + n_q (mean_q - mean)^2)),
// so every block holds the same bits of mean and inv, and so does a rerun.
// K2 takes sum(dy) and sum(dy * (x - band mean)) in the pass that takes the
// band's M2 and merges them in the same exchange; rank 0 writes the sample's
// dgamma, dbeta partial. The output leaves as 16-byte stores. With
// k = 1 there is no exchange. After its last cluster barrier no block touches
// another's shared memory, so none waits for the others to exit.
//
// Where it still re-reads: where dy's band does not fit beside x's, K2
// prefetches dy into L2 as it starts and reads it from there twice (sums,
// then dx; x plus dy is 32 MB at the path's largest site, under the 50 MB
// L2). A band that does not fit in shared memory at all (H*W above about
// 56,000) or a one-channel load is read from global memory in every pass.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

extern __shared__ __align__(16) unsigned char dyn_smem[];
// Per-block timeline, off unless gan_instance_norm_trace() set a buffer:
// thread 0 of each block stores clock64() at point i (0 start, 1 band
// staged, 3 band sums done, 12 cluster's sums merged, 6 output stored) into
// trace[block * 16 + i], the global
// timer at the start and end into slots 14 and 13, and its SM into slot 15.
// Off, it costs one load and one branch per point.
__device__ unsigned long long* g_trace;
#define TRACE(i)                                                                         \
  do {                                                                                   \
    if (g_trace != nullptr && threadIdx.x == 0) {                                        \
      const size_t b_ = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 16;              \
      g_trace[b_ + (i)] = clock64();                                                     \
      if ((i) == 0 || (i) == 6) {                                                        \
        unsigned long long t_;                                                           \
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                           \
        g_trace[b_ + ((i) == 0 ? 14 : 13)] = t_;                                         \
        unsigned sm_;                                                                    \
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                                 \
        g_trace[b_ + 15] = sm_;                                                          \
      }                                                                                  \
    }                                                                                    \
  } while (0)

namespace {

constexpr int kMaxThreads = 256;  // threads per block; the plan may take fewer
constexpr int kMaxCluster = 16;   // blocks per cluster (above 8: non-portable)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use (227 KB)

enum Act { kNone = 0, kLeakyRelu = 1, kRelu = 2 };
enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ void unpack(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// VEC consecutive values as fp32, in 16-byte loads where VEC allows
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&f)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      f[j] = v.x; f[j + 1] = v.y; f[j + 2] = v.z; f[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = p[j];
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    unpack(v.x, f[0], f[1]); unpack(v.y, f[2], f[3]);
    unpack(v.z, f[4], f[5]); unpack(v.w, f[6], f[7]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = __bfloat162float(p[j]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&f)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = f[j];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&f)[VEC]) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack(f[0], f[1]), pack(f[2], f[3]),
                                              pack(f[4], f[5]), pack(f[6], f[7]));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = __float2bfloat16(f[j]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Cluster barrier halves. A block arrives (relaxed) as it starts and waits
// before its first store into another block's shared memory, which must have
// started by then; cluster.sync() orders the exchanges themselves.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Where a thread sits: lane `lane` of the channel tile (VEC channels from ch0),
// row thread `prow` of P, in band `rank` = rows [r0, r1) of H*W.
struct Geo {
  int lanes, lane, prow, P, warps, ct, k, rank, rows, r0, r1, ch0, hw, c;
  bool active;     // a thread whose channels exist
  int64_t base;    // element index of (sample, row 0, ch0)
};

template <int VEC>
__device__ __forceinline__ Geo make_geo(int hw, int c, int ct, int rows, unsigned k, unsigned rank) {
  Geo g;
  g.lanes = ct / VEC;
  g.lane = threadIdx.x % g.lanes;
  g.prow = threadIdx.x / g.lanes;
  g.P = blockDim.x / g.lanes;
  g.warps = blockDim.x / 32;
  g.ct = ct;
  g.k = (int)k;
  g.rank = (int)rank;
  g.rows = rows;
  g.r0 = min(hw, (int)rank * rows);
  g.r1 = min(hw, g.r0 + rows);
  g.ch0 = (int)(blockIdx.x / k) * ct + g.lane * VEC;
  g.hw = hw;
  g.c = c;
  g.active = g.ch0 < c;
  g.base = (int64_t)blockIdx.y * hw * c + g.ch0;
  return g;
}

// Rows of band q (the last bands may be short or empty).
__device__ __forceinline__ int band_rows(const Geo& g, int q) {
  return max(0, min(g.rows, g.hw - q * g.rows));
}

// Row r's VEC values of a tensor: from its staged band in shared memory, or
// from global memory.
template <typename T>
struct Src {
  const T* p;
  int64_t stride;
  int rbase;
  __device__ __forceinline__ const T* row(int r) const { return p + (int64_t)(r - rbase) * stride; }
};

template <typename T>
__device__ __forceinline__ Src<T> src(const T* global, const T* band, bool staged, const Geo& g,
                                      int vec) {
  if (staged) return Src<T>{band + g.lane * vec, g.ct, g.r0};
  return Src<T>{global + g.base, g.c, 0};
}

// Copy this thread's rows of its band of `global` into `band` (cp.async).
template <typename T, int VEC>
__device__ __forceinline__ void stage(const T* global, T* band, const Geo& g) {
  if (!g.active) return;
  for (int r = g.r0 + g.prow; r < g.r1; r += g.P)
    cp_async16(band + (int64_t)(r - g.r0) * g.ct + g.lane * VEC, global + g.base + (int64_t)r * g.c);
}

// The row threads of one lane in a warp are threadIdx.x ^ (lanes << i); the
// first `lanes` threads of the warp lead them.
__device__ __forceinline__ bool warp_leader(const Geo& g) { return threadIdx.x % 32 < g.lanes; }

// Sum NS values per channel over the block's row threads: xor shuffles in
// the warp, the warp leaders' sums to red[(warp * NS + s) * ct + ch], and a
// barrier. Then any thread reads the block's sums with warp_total().
template <int NS, int VEC>
__device__ __forceinline__ void warp_sums(float (&v)[NS][VEC], const Geo& g, float* red) {
  for (int off = g.lanes; off < 32; off <<= 1)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[s][j] += __shfl_xor_sync(0xffffffffu, v[s][j], off);
  if (warp_leader(g)) {
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int s = 0; s < NS; ++s) store_vec<VEC>(red + (w * NS + s) * g.ct + g.lane * VEC, v[s]);
  }
  __syncthreads();
}

// Sum s of warp_sums over the block's warps, in warp order.
template <int NS, int VEC>
__device__ __forceinline__ void warp_total(const float* red, int s, const Geo& g,
                                           float (&out)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = 0.f;
#pragma unroll
  for (int w = 0; w < g.warps; ++w) {
    float t[VEC];
    load_vec<VEC>(red + (w * NS + s) * g.ct + g.lane * VEC, t);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] += t[j];
  }
}

// Store this block's NS partials of the thread's channels into slot `rank`
// (NS * ct floats) of `gath` in blocks q = prow, prow + P, ... of the cluster.
template <int NS, int VEC>
__device__ __forceinline__ void scatter(cg::cluster_group& cluster, float* gath,
                                        const float (&v)[NS][VEC], const Geo& g) {
  for (int q = g.prow; q < g.k; q += g.P) {
    float* dst = cluster.map_shared_rank(gath, q) + (g.rank * NS * g.ct + g.lane * VEC);
#pragma unroll
    for (int s = 0; s < NS; ++s) store_vec<VEC>(dst + s * g.ct, v[s]);
  }
}

// Float scratch after the staged bands: `red`, the warp sums (2 * warps *
// ct), and `gath`, the k blocks' partials (K1: band
// mean and M2, 2 * ct each; K2: also sum(dy) and sum(dy * (x - band mean)),
// 4 * ct). ops/kernels.py:_plan_smem mirrors this.
struct Scratch {
  float *red, *gath;
};

__device__ __forceinline__ Scratch scratch(float* f, const Geo& g) {
  return Scratch{f, f + 2 * g.warps * g.ct};
}

// The band's mean of the thread's VEC channels (pass A), summed in a fixed
// order: warp shuffles, then the warps in order; 1/rows per band, no
// per-element division. Ends with a barrier after every thread has read red.
template <typename T, int VEC>
__device__ __forceinline__ void band_mean(const Src<T>& x, float* red, const Geo& g,
                                          float (&bm)[VEC]) {
  float v[1][VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[0][j] = 0.f;
  if (g.active) {
#pragma unroll 4
    for (int r = g.r0 + g.prow; r < g.r1; r += g.P) {
      float f[VEC];
      load_vec<VEC>(x.row(r), f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[0][j] += f[j];
    }
  }
  warp_sums<1, VEC>(v, g, red);
  const int nb = g.r1 - g.r0;
  const float rnb = nb > 0 ? 1.f / (float)nb : 0.f;
  warp_total<1, VEC>(red, 0, g, bm);
#pragma unroll
  for (int j = 0; j < VEC; ++j) bm[j] *= rnb;
  __syncthreads();   // red is written again next
}

// Sum over the cluster of NS band partials v (v[0] the band mean, v[1] its
// M2, the rest sums taken about it), the same bits in every thread: with
// k = 1 they are the instance's; else every block stores them into every
// block (distributed shared memory), and after cluster.sync() each thread
// merges the k bands in rank order (Chan et al.): mean = sum(n_q mean_q) / HW,
// M2 = sum(M2_q + n_q (mean_q - mean)^2); v[2] = sum(v_q[2]); v[3] (a sum of
// dy (x - mean_q)) = sum(v_q[3] + (mean_q - mean) v_q[2]). No block touches
// another's shared memory after it returns.
template <int NS, int VEC>
__device__ __forceinline__ void merge_bands(cg::cluster_group& cluster, float* gath,
                                            float (&v)[NS][VEC], const Geo& g) {
  if (g.k == 1) return;
  cluster_wait();   // every block of the cluster has started
  scatter<NS, VEC>(cluster, gath, v, g);
  cluster.sync();
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[s][j] = 0.f;
  for (int q = 0; q < g.k; ++q) {
    float mq[VEC];
    load_vec<VEC>(gath + q * NS * g.ct + g.lane * VEC, mq);
    const float nq = (float)band_rows(g, q);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[0][j] += nq * mq[j];
  }
  const float rhw = 1.f / (float)g.hw;
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[0][j] *= rhw;
  for (int q = 0; q < g.k; ++q) {
    float pq[NS][VEC];
#pragma unroll
    for (int s = 0; s < NS; ++s) load_vec<VEC>(gath + (q * NS + s) * g.ct + g.lane * VEC, pq[s]);
    const float nq = (float)band_rows(g, q);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = pq[0][j] - v[0][j];
      v[1][j] += pq[1][j] + nq * d * d;
      if constexpr (NS == 4) {
        v[2][j] += pq[2][j];
        v[3][j] += pq[3][j] + d * pq[2][j];
      }
    }
  }
}

// Mean and rsqrt(var + eps) of the thread's VEC channels over H*W from the
// merged band mean and M2.
template <int NS, int VEC>
__device__ __forceinline__ void stats(const float (&v)[NS][VEC], const Geo& g, float eps,
                                      float (&mu)[VEC], float (&inv)[VEC]) {
  const float rhw = 1.f / (float)g.hw;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = v[0][j];
    inv[j] = rsqrtf(v[1][j] * rhw + eps);
  }
}

// staged: 1 when x's band is in shared memory, 0 when it is read from global.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         int hw, int c, int ct, int rows, int staged, float eps) {
  TRACE(0);
  cg::cluster_group cluster = cg::this_cluster();
  const Geo g = make_geo<VEC>(hw, c, ct, rows, cluster.num_blocks(), cluster.block_rank());
  if (g.k > 1) cluster_arrive_relaxed();
  T* band = reinterpret_cast<T*>(dyn_smem);
  const int64_t band_bytes = staged ? (int64_t)rows * ct * sizeof(T) : 0;
  const Scratch sc = scratch(reinterpret_cast<float*>(dyn_smem + band_bytes), g);
  if (staged) {
    stage<T, VEC>(x, band, g);
    cp_async_wait_all();   // each thread reads back only its own rows
  }
  TRACE(1);
  const Src<T> xs = src(x, band, staged, g, VEC);

  // the band's mean, then its sum of squares about it, then the cluster's
  float v[2][VEC];
  band_mean<T, VEC>(xs, sc.red, g, v[0]);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[1][j] = 0.f;
  if (g.active) {
#pragma unroll 4
    for (int r = g.r0 + g.prow; r < g.r1; r += g.P) {
      float f[VEC];
      load_vec<VEC>(xs.row(r), f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = f[j] - v[0][j];
        v[1][j] += d * d;
      }
    }
  }
  {
    float w[1][VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) w[0][j] = v[1][j];
    warp_sums<1, VEC>(w, g, sc.red);
    warp_total<1, VEC>(sc.red, 0, g, v[1]);
  }
  TRACE(3);
  merge_bands<2, VEC>(cluster, sc.gath, v, g);
  float mu[VEC], inv[VEC];
  stats<2, VEC>(v, g, eps, mu, inv);
  TRACE(12);

  if (g.active) {
    float gm[VEC], bt[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      gm[j] = gamma[g.ch0 + j];
      bt[j] = beta[g.ch0 + j];
    }
    // normalise, activation epilogue, one rounding to the input type
#pragma unroll 4
    for (int r = g.r0 + g.prow; r < g.r1; r += g.P) {
      float f[VEC];
      load_vec<VEC>(xs.row(r), f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float v = (f[j] - mu[j]) * inv[j] * gm[j] + bt[j];
        if (ACT == kLeakyRelu) v = v >= 0.f ? v : 0.3f * v;
        if (ACT == kRelu) v = fmaxf(v, 0.f);
        f[j] = v;
      }
      store_vec<VEC>(y + g.base + (int64_t)r * c, f);
    }
  }
  TRACE(6);
}

// staged: 0 neither band in shared memory, 1 x's (dy is prefetched into L2),
// 2 x's and dy's.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 3)   // registers for three blocks to an SM
instance_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
                         int hw, int c, int ct, int rows, int staged, float eps) {
  TRACE(0);
  cg::cluster_group cluster = cg::this_cluster();
  const Geo g = make_geo<VEC>(hw, c, ct, rows, cluster.num_blocks(), cluster.block_rank());
  if (g.k > 1) cluster_arrive_relaxed();
  const int64_t band_elems = (int64_t)rows * ct;
  T* xband = reinterpret_cast<T*>(dyn_smem);
  T* dyband = xband + (staged >= 1 ? band_elems : 0);
  const Scratch sc =
      scratch(reinterpret_cast<float*>(dyn_smem + staged * band_elems * (int64_t)sizeof(T)), g);
  if (staged >= 1) stage<T, VEC>(x, xband, g);
  if (staged >= 2) {
    stage<T, VEC>(dy, dyband, g);
  } else if (g.active && g.lane == 0) {   // one prefetch per row segment (128 bytes or less)
    for (int r = g.r0 + g.prow; r < g.r1; r += g.P) prefetch_l2(dy + g.base + (int64_t)r * c);
  }
  if (staged >= 1) cp_async_wait_all();
  TRACE(1);
  const Src<T> xs = src(x, xband, staged >= 1, g, VEC);
  const Src<T> dys = src(dy, dyband, staged >= 2, g, VEC);

  // The band's mean, then in one pass its sum of squares about it, sum(dy)
  // and sum(dy * (x - band mean)); one exchange merges all of them. With
  // x^ = (x - mean) * inv, sum(dy * x^) = inv * sum(dy * (x - mean)), and the
  // cluster's statistics are K1's bit for bit (the same partials, merged alike).
  float v[4][VEC];
  band_mean<T, VEC>(xs, sc.red, g, v[0]);
  float w[3][VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) w[0][j] = w[1][j] = w[2][j] = 0.f;
  if (g.active) {
#pragma unroll 4
    for (int r = g.r0 + g.prow; r < g.r1; r += g.P) {
      float fx[VEC], fd[VEC];
      load_vec<VEC>(xs.row(r), fx);
      load_vec<VEC>(dys.row(r), fd);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = fx[j] - v[0][j];
        w[0][j] += d * d;
        w[1][j] += fd[j];
        w[2][j] += fd[j] * d;
      }
    }
  }
  // two of the sums, then the third, in the space of two (three blocks to an SM)
  {
    float w01[2][VEC], w2[1][VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      w01[0][j] = w[0][j];
      w01[1][j] = w[1][j];
      w2[0][j] = w[2][j];
    }
    warp_sums<2, VEC>(w01, g, sc.red);
    warp_total<2, VEC>(sc.red, 0, g, v[1]);
    warp_total<2, VEC>(sc.red, 1, g, v[2]);
    __syncthreads();
    warp_sums<1, VEC>(w2, g, sc.red);
    warp_total<1, VEC>(sc.red, 0, g, v[3]);
  }
  TRACE(3);
  merge_bands<4, VEC>(cluster, sc.gath, v, g);
  float mu[VEC], inv[VEC], sdy[VEC], sdyx[VEC];
  stats<4, VEC>(v, g, eps, mu, inv);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sdy[j] = v[2][j];
    sdyx[j] = inv[j] * v[3][j];
  }
  TRACE(12);

  if (g.active) {
    if (g.rank == 0 && g.prow == 0) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        dgamma_part[(int64_t)blockIdx.y * c + g.ch0 + j] = sdyx[j];
        dbeta_part[(int64_t)blockIdx.y * c + g.ch0 + j] = sdy[j];
      }
    }
    const float rhw = 1.f / (float)hw;
    float gm[VEC], m1[VEC], m2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      gm[j] = gamma[g.ch0 + j];
      m1[j] = gm[j] * sdy[j] * rhw;     // mean(dy * gamma)
      m2[j] = gm[j] * sdyx[j] * rhw;    // mean(dy * gamma * x^)
    }
    // dx in the input type. dy * gamma is rounded before m1 is taken off (no
    // fused multiply-add), as m1 was rounded: at H*W = 1 the two are equal
    // and dx is exactly 0, as it is in exact arithmetic.
#pragma unroll 8
    for (int r = g.r0 + g.prow; r < g.r1; r += g.P) {
      float fx[VEC], fd[VEC];
      load_vec<VEC>(xs.row(r), fx);
      load_vec<VEC>(dys.row(r), fd);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (fx[j] - mu[j]) * inv[j];
        fx[j] = inv[j] * (__fmul_rn(fd[j], gm[j]) - m1[j] - xh * m2[j]);
      }
      store_vec<VEC>(dx + g.base + (int64_t)r * c, fx);
    }
  }
  TRACE(6);
}

// The dynamic shared memory a plan needs; ops/kernels.py:norm_plan mirrors it.
int64_t plan_smem(int ns, int threads, int k, int ct, int rows, int staged, int elt) {
  const int64_t floats = (int64_t)(2 * (threads / 32) + (ns == 1 ? 2 : 4) * k) * ct;
  return (int64_t)staged * rows * ct * elt + floats * 4;
}

std::mutex g_mutex;
std::map<std::tuple<const void*, int, int, int>, int> g_checked;   // (kernel, threads, k, smem) -> cudaError

// Per kernel and (k, smem), once: allow up to 227 KB of shared memory and a
// non-portable cluster, and check that the card can schedule at least one
// such cluster.
template <typename Kernel>
int prepare(Kernel kernel, const cudaLaunchConfig_t& cfg, int k, int smem) {
  std::lock_guard<std::mutex> lock(g_mutex);
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel),
                                   (int)cfg.blockDim.x, k, smem);
  const auto it = g_checked.find(key);
  if (it != g_checked.end()) return it->second;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && k > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e == cudaSuccess && clusters == 0) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) cudaGetLastError();   // do not leave it for the next launch
  g_checked[key] = (int)e;
  return (int)e;
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(int threads, int k, int tiles, int n, int smem, cudaStream_t stream) : cfg{} {
    cfg.gridDim = dim3(k * tiles, n);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, int k, int tiles, int n, int smem, cudaStream_t stream,
           Args... args) {
  Launch l(threads, k, tiles, n, smem, stream);
  const int e = prepare(kernel, l.cfg, k, smem);
  if (e != 0) return e;
  const cudaError_t le = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

template <typename Kernel>
int max_clusters(Kernel kernel, int threads, int k, int tiles, int n, int smem) {
  Launch l(threads, k, tiles, n, smem, nullptr);
  const int e = prepare(kernel, l.cfg, k, smem);
  if (e != 0) return -e;
  int clusters = 0;
  const cudaError_t q = cudaOccupancyMaxActiveClusters(&clusters, kernel, &l.cfg);
  return q == cudaSuccess ? clusters : -(int)q;
}

// The fwd kernel for (dtype, vec, act), or nullptr.
template <typename T, int VEC>
auto fwd_kernel(int act) -> decltype(&instance_norm_fwd_kernel<T, VEC, kNone>) {
  switch (act) {
    case kLeakyRelu: return instance_norm_fwd_kernel<T, VEC, kLeakyRelu>;
    case kRelu: return instance_norm_fwd_kernel<T, VEC, kRelu>;
    default: return instance_norm_fwd_kernel<T, VEC, kNone>;
  }
}

// Checks of a plan common to both directions; 0 when it is valid.
int check_plan(int n, int hw, int c, int threads, int k, int ct, int rows, int vec, int staged,
               int smem, int dtype, int ns) {
  const int elt = dtype == kFloat32 ? 4 : 2;
  const int wide = 16 / elt;
  if (n <= 0 || hw <= 0 || c <= 0 || k < 1 || k > kMaxCluster || ct <= 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != kFloat32 && dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  if (vec != 1 && (vec != wide || c % vec != 0)) return (int)cudaErrorInvalidValue;
  const int lanes = ct / vec;
  if (ct % vec != 0 || lanes > 32 || (lanes & (lanes - 1)) != 0 || (int64_t)k * rows < hw)
    return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (staged < 0 || staged > ns || (staged > 0 && vec == 1)) return (int)cudaErrorInvalidValue;
  if (smem > kMaxSmem || plan_smem(ns, threads, k, ct, rows, staged, elt) != smem)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// K1. Returns the launch's cudaError_t (0 on success). dtype: 0 fp32, 1 bf16;
// act: 0 none, 1 leaky_relu(0.3), 2 relu. The plan: k blocks of `threads`
// per cluster, each holding `rows` rows of H*W and `ct` channels, loading `vec` channels
// at a time (16 bytes, or 1), `staged` 1 when x's band goes through shared
// memory, `smem` dynamic shared memory bytes. cudaErrorInvalidConfiguration
// when the card can schedule no such cluster.
extern "C" int gan_instance_norm_fwd(const void* x, const void* gamma, const void* beta,
                                     void* y, int n, int hw, int c, float eps, int act,
                                     int dtype, int threads, int k, int ct, int rows, int vec,
                                     int staged, int smem, void* stream) {
  if (act < kNone || act > kRelu) return (int)cudaErrorInvalidValue;
  const int bad = check_plan(n, hw, c, threads, k, ct, rows, vec, staged, smem, dtype, 1);
  if (bad) return bad;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (c + ct - 1) / ct;
  if (dtype == kFloat32) {
    const float* xp = static_cast<const float*>(x);
    float* yp = static_cast<float*>(y);
    return vec == 1 ? launch(fwd_kernel<float, 1>(act), threads, k, tiles, n, smem, s, xp, g, b, yp, hw, c, ct, rows, staged, eps)
                    : launch(fwd_kernel<float, 4>(act), threads, k, tiles, n, smem, s, xp, g, b, yp, hw, c, ct, rows, staged, eps);
  }
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  return vec == 1 ? launch(fwd_kernel<__nv_bfloat16, 1>(act), threads, k, tiles, n, smem, s, xp, g, b, yp, hw, c, ct, rows, staged, eps)
                  : launch(fwd_kernel<__nv_bfloat16, 8>(act), threads, k, tiles, n, smem, s, xp, g, b, yp, hw, c, ct, rows, staged, eps);
}

// K2: the backward of gan_instance_norm_fwd with act 0, with the forward's
// plan (staged may be 2: dy's band too). x, dy, dx share x's dtype;
// dgamma_part and dbeta_part are fp32 (n, c). Returns the launch's cudaError_t.
extern "C" int gan_instance_norm_bwd(const void* x, const void* gamma, const void* dy,
                                     void* dx, void* dgamma_part, void* dbeta_part,
                                     int n, int hw, int c, float eps, int dtype, int threads,
                                     int k, int ct, int rows, int vec, int staged, int smem,
                                     void* stream) {
  const int bad = check_plan(n, hw, c, threads, k, ct, rows, vec, staged, smem, dtype, 2);
  if (bad) return bad;
  const float* g = static_cast<const float*>(gamma);
  float* dg = static_cast<float*>(dgamma_part);
  float* db = static_cast<float*>(dbeta_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (c + ct - 1) / ct;
  if (dtype == kFloat32) {
    const float* xp = static_cast<const float*>(x);
    const float* dyp = static_cast<const float*>(dy);
    float* dxp = static_cast<float*>(dx);
    return vec == 1 ? launch(instance_norm_bwd_kernel<float, 1>, threads, k, tiles, n, smem, s, xp, g, dyp, dxp, dg, db, hw, c, ct, rows, staged, eps)
                    : launch(instance_norm_bwd_kernel<float, 4>, threads, k, tiles, n, smem, s, xp, g, dyp, dxp, dg, db, hw, c, ct, rows, staged, eps);
  }
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* dyp = static_cast<const __nv_bfloat16*>(dy);
  __nv_bfloat16* dxp = static_cast<__nv_bfloat16*>(dx);
  return vec == 1 ? launch(instance_norm_bwd_kernel<__nv_bfloat16, 1>, threads, k, tiles, n, smem, s, xp, g, dyp, dxp, dg, db, hw, c, ct, rows, staged, eps)
                  : launch(instance_norm_bwd_kernel<__nv_bfloat16, 8>, threads, k, tiles, n, smem, s, xp, g, dyp, dxp, dg, db, hw, c, ct, rows, staged, eps);
}

// Sets (or, with nullptr, clears) the buffer of the kernels' timeline: 16
// uint64 per block of the next launches. Returns a cudaError_t.
extern "C" int gan_instance_norm_trace(void* buffer) {
  return (int)cudaMemcpyToSymbol(g_trace, &buffer, sizeof(void*));
}

// cudaOccupancyMaxActiveClusters for a plan of K1 (backward 0, act 0) or K2
// (backward 1): the number of such clusters the card runs at once, or minus
// the cudaError_t.
extern "C" int gan_instance_norm_max_clusters(int backward, int n, int c, int dtype, int threads,
                                              int k, int ct, int vec, int smem) {
  const int tiles = (c + ct - 1) / ct;
  if (dtype == kFloat32) {
    if (backward) return vec == 1 ? max_clusters(instance_norm_bwd_kernel<float, 1>, threads, k, tiles, n, smem)
                                  : max_clusters(instance_norm_bwd_kernel<float, 4>, threads, k, tiles, n, smem);
    return vec == 1 ? max_clusters(fwd_kernel<float, 1>(kNone), threads, k, tiles, n, smem)
                    : max_clusters(fwd_kernel<float, 4>(kNone), threads, k, tiles, n, smem);
  }
  if (backward) return vec == 1 ? max_clusters(instance_norm_bwd_kernel<__nv_bfloat16, 1>, threads, k, tiles, n, smem)
                                : max_clusters(instance_norm_bwd_kernel<__nv_bfloat16, 8>, threads, k, tiles, n, smem);
  return vec == 1 ? max_clusters(fwd_kernel<__nv_bfloat16, 1>(kNone), threads, k, tiles, n, smem)
                  : max_clusters(fwd_kernel<__nv_bfloat16, 8>(kNone), threads, k, tiles, n, smem);
}
