// Instance norm forward (+ optional activation epilogue) and backward for
// Hopper (sm_90a).
//
// instance_norm_fwd_kernel replaces gan_tpu/ops/pallas_kernels.py:_in_fwd_kernel
// (K1, with its K3 activation epilogue). Same math: per (sample, channel)
// statistics over H*W in fp32, y = (x - mean) * rsqrt(var + eps) * gamma + beta,
// then optional LeakyReLU(0.3) / ReLU, cast back to the input type. The
// variance is taken with Welford's update per thread and Chan's merge across
// threads, not the Pallas kernel's E[x^2] - mean^2, which loses precision (and
// can go negative) on activations with a large mean.
//
// instance_norm_bwd_kernel replaces pallas_kernels.py:_in_bwd_kernel (K2), the
// backward of the norm without an activation: with x^ = (x - mean) * inv,
//   dx = inv * (dy*gamma - mean(dy*gamma) - x^ * mean(dy*gamma*x^)),
//   dgamma = sum over N, H*W of dy*x^,   dbeta = sum over N, H*W of dy.
// It recomputes mean and inv with the same code as the forward (block_stats),
// so x^ is bit for bit the forward's. dgamma and dbeta leave the kernel as
// per-sample partials (N, C) in fp32, which the caller sums over N, as
// _in_backward does; no atomics, so the sums do not change from run to run.
//
// Layout: x (and dy, dx, y) is NHWC, contiguous, viewed as (N, HW, C) -- the
// Pallas kernels' own view. gamma and beta are fp32 (C,).
//
// What bounds them: memory. K1 reads x twice (statistics, then normalise) and
// writes y once; K2 reads x three times (statistics, sums, dx) and dy twice
// and writes dx once, with a handful of flops per element; all but the first
// read of a block's slice (at most 16384 x 32 x 4 B = 2 MB per tensor) mostly
// hit L2. One block owns one (sample, 32-channel tile): the 32 threads of a
// warp sit on 32 neighbouring channels, so each row load is one coalesced
// segment, and the block's kRows warps stride over H*W.
// Known weakness: only N * C/32 blocks run -- at 128^2 x 64 and batch 8 that
// is 16 blocks on the card's 132 SMs. Splitting H*W across blocks needs a
// second pass or atomics and is left for later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;  // channels per block (one warp wide)
constexpr int kRows = 16;      // warps per block, striding over H*W

enum Act { kNone = 0, kLeakyRelu = 1, kRelu = 2 };
enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Mean and rsqrt(var + eps) of the column x[base + r * c], r < hw: Welford
// per thread over rows ty, ty + kRows, ..., then a tree merge over the
// block's rows (Chan et al.). Every thread of the block must call it (it
// synchronises); the result is that of the thread's own channel.
template <typename T>
__device__ __forceinline__ void block_stats(const T* __restrict__ x, int64_t base, int hw,
                                            int c, bool active, float eps,
                                            float* mu, float* inv) {
  __shared__ float s_cnt[kRows][kChannels];
  __shared__ float s_mean[kRows][kChannels];
  __shared__ float s_m2[kRows][kChannels];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  if (active) {
    for (int r = ty; r < hw; r += kRows) {
      const float v = to_float(x[base + (int64_t)r * c]);
      cnt += 1.f;
      const float d = v - mean;
      mean += d / cnt;
      m2 += d * (v - mean);
    }
  }
  s_cnt[ty][tx] = cnt;
  s_mean[ty][tx] = mean;
  s_m2[ty][tx] = m2;
  __syncthreads();

  for (int stride = kRows / 2; stride > 0; stride >>= 1) {
    if (ty < stride) {
      const float na = s_cnt[ty][tx], nb = s_cnt[ty + stride][tx];
      const float n = na + nb;
      if (nb > 0.f) {
        const float ma = s_mean[ty][tx], mb = s_mean[ty + stride][tx];
        const float d = mb - ma;
        s_mean[ty][tx] = ma + d * (nb / n);
        s_m2[ty][tx] = s_m2[ty][tx] + s_m2[ty + stride][tx] + d * d * (na * nb / n);
        s_cnt[ty][tx] = n;
      }
    }
    __syncthreads();
  }
  *mu = s_mean[0][tx];
  *inv = rsqrtf(s_m2[0][tx] / (float)hw + eps);
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kChannels * kRows)
instance_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         int hw, int c, float eps) {
  const int ch = blockIdx.x * kChannels + threadIdx.x;
  const bool active = ch < c;
  const int64_t base = (int64_t)blockIdx.y * hw * c + ch;

  float mu, inv;
  block_stats(x, base, hw, c, active, eps, &mu, &inv);
  if (!active) return;
  const float g = gamma[ch];
  const float b = beta[ch];

  // normalise, activation epilogue, store in the input type
  for (int r = threadIdx.y; r < hw; r += kRows) {
    const int64_t i = base + (int64_t)r * c;
    float v = (to_float(x[i]) - mu) * inv * g + b;
    if (ACT == kLeakyRelu) v = v >= 0.f ? v : 0.3f * v;
    if (ACT == kRelu) v = fmaxf(v, 0.f);
    store(&y[i], v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kChannels * kRows)
instance_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
                         int hw, int c, float eps) {
  __shared__ float s_dy[kRows][kChannels];
  __shared__ float s_dyx[kRows][kChannels];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int ch = blockIdx.x * kChannels + tx;
  const bool active = ch < c;
  const int64_t base = (int64_t)blockIdx.y * hw * c + ch;

  float mu, inv;
  block_stats(x, base, hw, c, active, eps, &mu, &inv);

  // Pass 1: per-thread sums of dy and dy * x^, then a tree sum over the rows
  float sdy = 0.f, sdyx = 0.f;
  if (active) {
    for (int r = ty; r < hw; r += kRows) {
      const int64_t i = base + (int64_t)r * c;
      const float d = to_float(dy[i]);
      sdy += d;
      sdyx += d * ((to_float(x[i]) - mu) * inv);
    }
  }
  s_dy[ty][tx] = sdy;
  s_dyx[ty][tx] = sdyx;
  __syncthreads();
  for (int stride = kRows / 2; stride > 0; stride >>= 1) {
    if (ty < stride) {
      s_dy[ty][tx] += s_dy[ty + stride][tx];
      s_dyx[ty][tx] += s_dyx[ty + stride][tx];
    }
    __syncthreads();
  }
  if (!active) return;
  const float sum_dy = s_dy[0][tx];
  const float sum_dyx = s_dyx[0][tx];
  if (ty == 0) {
    dgamma_part[(int64_t)blockIdx.y * c + ch] = sum_dyx;
    dbeta_part[(int64_t)blockIdx.y * c + ch] = sum_dy;
  }
  const float g = gamma[ch];
  const float m1 = g * sum_dy / (float)hw;    // mean(dy * gamma)
  const float m2 = g * sum_dyx / (float)hw;   // mean(dy * gamma * x^)

  // Pass 2: dx in the input type. dy * gamma is rounded before m1 is taken
  // off (no fused multiply-add), as m1 was rounded: at H*W = 1 the two are
  // equal and dx is exactly 0, as it is in exact arithmetic.
  for (int r = ty; r < hw; r += kRows) {
    const int64_t i = base + (int64_t)r * c;
    const float xh = (to_float(x[i]) - mu) * inv;
    store(&dx[i], inv * (__fmul_rn(to_float(dy[i]), g) - m1 - xh * m2));
  }
}

template <typename T>
void launch_fwd(const void* x, const float* gamma, const float* beta, void* y,
                int n, int hw, int c, float eps, int act, cudaStream_t stream) {
  const dim3 grid((c + kChannels - 1) / kChannels, n);
  const dim3 block(kChannels, kRows);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  switch (act) {
    case kLeakyRelu:
      instance_norm_fwd_kernel<T, kLeakyRelu><<<grid, block, 0, stream>>>(xp, gamma, beta, yp, hw, c, eps);
      break;
    case kRelu:
      instance_norm_fwd_kernel<T, kRelu><<<grid, block, 0, stream>>>(xp, gamma, beta, yp, hw, c, eps);
      break;
    default:
      instance_norm_fwd_kernel<T, kNone><<<grid, block, 0, stream>>>(xp, gamma, beta, yp, hw, c, eps);
  }
}

template <typename T>
void launch_bwd(const void* x, const float* gamma, const void* dy, void* dx,
                float* dgamma_part, float* dbeta_part, int n, int hw, int c, float eps,
                cudaStream_t stream) {
  const dim3 grid((c + kChannels - 1) / kChannels, n);
  const dim3 block(kChannels, kRows);
  instance_norm_bwd_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<T*>(dx),
      dgamma_part, dbeta_part, hw, c, eps);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). dtype: 0 fp32, 1 bf16;
// act: 0 none, 1 leaky_relu(0.3), 2 relu.
extern "C" int gan_instance_norm_fwd(const void* x, const void* gamma, const void* beta,
                                     void* y, int n, int hw, int c, float eps,
                                     int act, int dtype, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || act < kNone || act > kRelu) return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    launch_fwd<float>(x, g, b, y, n, hw, c, eps, act, s);
  } else if (dtype == kBFloat16) {
    launch_fwd<__nv_bfloat16>(x, g, b, y, n, hw, c, eps, act, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Backward of gan_instance_norm_fwd with act 0. x, dy, dx share x's dtype
// (0 fp32, 1 bf16); dgamma_part and dbeta_part are fp32 (n, c). Returns the
// launch's cudaError_t (0 on success).
extern "C" int gan_instance_norm_bwd(const void* x, const void* gamma, const void* dy,
                                     void* dx, void* dgamma_part, void* dbeta_part,
                                     int n, int hw, int c, float eps, int dtype,
                                     void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  float* dg = static_cast<float*>(dgamma_part);
  float* db = static_cast<float*>(dbeta_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    launch_bwd<float>(x, g, dy, dx, dg, db, n, hw, c, eps, s);
  } else if (dtype == kBFloat16) {
    launch_bwd<__nv_bfloat16>(x, g, dy, dx, dg, db, n, hw, c, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
