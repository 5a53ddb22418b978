// Instance norm forward (+ optional activation epilogue) for Hopper (sm_90a).
//
// Replaces gan_tpu/ops/pallas_kernels.py:_in_fwd_kernel (K1, with its K3
// activation epilogue). Same math: per (sample, channel) statistics over H*W
// in fp32, y = (x - mean) * rsqrt(var + eps) * gamma + beta, then optional
// LeakyReLU(0.3) / ReLU, cast back to the input type. The variance is taken
// with Welford's update per thread and Chan's merge across threads, not the
// Pallas kernel's E[x^2] - mean^2, which loses precision (and can go negative)
// on activations with a large mean.
//
// Layout: x is NHWC, contiguous, viewed as (N, HW, C) -- the Pallas kernel's
// own view. gamma and beta are fp32 (C,).
//
// What bounds it: memory. It reads x twice (statistics, then normalise) and
// writes y once, with a handful of flops per element. One block owns one
// (sample, 32-channel tile): the 32 threads of a warp sit on 32 neighbouring
// channels, so each row load is one coalesced segment, and the block's ROWS
// warps stride over H*W. The statistics come from one read; the second read
// of the block's slice (at most 16384 x 32 x 4 B = 2 MB) mostly hits L2.
// Known weakness: at large H*W and small C (128^2 x 64) only N * C/32 blocks
// run, far fewer than the card's 132 SMs can hold; splitting H*W across blocks
// needs a second pass or atomics and is left for later.

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

template <typename T, int ACT>
__global__ void __launch_bounds__(kChannels * kRows)
instance_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         int hw, int c, float eps) {
  __shared__ float s_cnt[kRows][kChannels];
  __shared__ float s_mean[kRows][kChannels];
  __shared__ float s_m2[kRows][kChannels];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int ch = blockIdx.x * kChannels + tx;
  const bool active = ch < c;
  const int64_t base = (int64_t)blockIdx.y * hw * c + ch;

  // Pass 1: per-thread Welford over rows ty, ty + kRows, ...
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

  // Tree merge over the rows of the block (Chan et al.).
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
  if (!active) return;

  const float mu = s_mean[0][tx];
  const float var = s_m2[0][tx] / (float)hw;
  const float inv = rsqrtf(var + eps);
  const float g = gamma[ch];
  const float b = beta[ch];

  // Pass 2: normalise, activation epilogue, store in the input type.
  for (int r = ty; r < hw; r += kRows) {
    const int64_t i = base + (int64_t)r * c;
    float v = (to_float(x[i]) - mu) * inv * g + b;
    if (ACT == kLeakyRelu) v = v >= 0.f ? v : 0.3f * v;
    if (ACT == kRelu) v = fmaxf(v, 0.f);
    store(&y[i], v);
  }
}

template <typename T>
void launch(const void* x, const float* gamma, const float* beta, void* y,
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
    launch<float>(x, g, b, y, n, hw, c, eps, act, s);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16>(x, g, b, y, n, hw, c, eps, act, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
