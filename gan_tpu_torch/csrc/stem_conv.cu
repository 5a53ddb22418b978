// Fused stem convolution for Hopper (sm_90a): y = LeakyReLU_0.3(conv(x, w)),
// the conv 4x4, stride 2, TF-'same' padding (1 on each side for even H, W), no
// bias, 64 filters.
//
// stem_conv_kernel replaces benchmarks/pallas_stem_proto.py:_stem_kernel
// (stem_conv_pallas): the first Downsample block of every U-Net and PatchGAN,
// which has no norm. Same math: 16 * C_in taps per output, fp32 accumulation,
// the LeakyReLU taken in fp32 before the one rounding to the output type. The
// taps come in the compute type, as the plain version casts them, so in bf16
// every product is exact in fp32.
//
// Layout: x is NHWC (N, H, W, C_in), contiguous; w is OHWI (64, 4, 4, C_in),
// the channels-last memory of PyTorch's OIHW weight, in x's type; y is NHWC
// (N, H/2, W/2, 64), contiguous, which the next conv reads as channels-last.
// The TPU kernel wrote NHCW, a Mosaic workaround its caller transposed back;
// nothing here needs it.
//
// What bounds it: writing y. With C_in <= 6 the output is 64 / C_in * 4 times
// the input's size (4x fewer pixels, 64 channels), so the kernel reads x about
// once and spends its bytes on the 16-byte stores of y. The products come
// next: at C_in = 2 and bf16 they take longer on the CUDA cores' fp32 FMAs
// than the write does on device memory, and moving the 16*C_in-deep product
// onto tensor cores is left for later.
//
// Design: one block owns `rows` output rows of one sample. It stages the
// 2*rows+2 zero-padded input rows it needs, and all the weights, in shared
// memory as fp32. Eight threads share an output pixel, each computing 8
// consecutive filters, so a warp covers 4 neighbouring pixels and writes
// them as 32 16-byte stores of 512 contiguous bytes (bf16). Each thread
// accumulates kPixelsPerThread pixels at once, so one load of its 8 weights
// from shared memory serves that many pixels' FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kFilters = 64;
constexpr int kTaps = 16;                                  // 4 x 4
constexpr int kThreads = 256;
constexpr int kThreadsPerPixel = 8;                        // 8 filters each
constexpr int kPixelGroups = kThreads / kThreadsPerPixel;  // 32 pixels side by side
constexpr int kPixelsPerThread = 4;
constexpr float kSlope = 0.3f;
constexpr size_t kSmemTarget = 64 * 1024;    // shrink `rows` above this
constexpr size_t kSmemMax = 232448;          // what one block may take on an H100

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 consecutive outputs: two 16-byte stores (fp32) or one (bf16)
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  union { __nv_bfloat162 h[4]; uint4 u; } pack;
#pragma unroll
  for (int k = 0; k < 4; ++k) pack.h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = pack.u;
}

__host__ __device__ constexpr size_t smem_bytes(int c_in, int rows, int wd) {
  return (size_t)(kTaps * c_in * kFilters + (2 * rows + 2) * (wd + 2) * c_in) * sizeof(float);
}

template <typename T, int CIN>
__global__ void __launch_bounds__(kThreads)
stem_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                 int h, int wd, int rows_per_block) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);   // [tap][half][thread][4]
  float* x_s = w_s + kTaps * CIN * kFilters;      // [row][padded col][channel]
  const int ho = h / 2, wo = wd / 2;
  const int n = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, ho - row0);
  const int pitch = (wd + 2) * CIN;               // floats per staged row

  // Weights, [f][tap] in global memory with tap = (a * 4 + b) * CIN + c.
  // Thread t reads filters 8t..8t+7 as two float4s; they sit at
  // [tap][half][t], so the 8 threads of a pixel read 8 neighbouring float4s,
  // free of bank conflicts.
  for (int i = threadIdx.x; i < kTaps * CIN * kFilters; i += kThreads) {
    const int f = i / (kTaps * CIN), tap = i % (kTaps * CIN);
    w_s[tap * kFilters + ((f >> 2) & 1) * 32 + (f >> 3) * 4 + (f & 3)] = to_float(w[i]);
  }
  // Input rows 2*row0 - 1 .. 2*(row0 + rows), each with one zero column on
  // either side; rows outside the image are zero.
  const int64_t x_n = (int64_t)n * h * wd * CIN;
  for (int i = threadIdx.x; i < (2 * rows + 2) * pitch; i += kThreads) {
    const int r = i / pitch, col = i % pitch;
    const int hi = 2 * row0 - 1 + r;
    const int wi = col / CIN - 1;
    float v = 0.f;
    if (hi >= 0 && hi < h && wi >= 0 && wi < wd)
      v = to_float(x[x_n + ((int64_t)hi * wd + wi) * CIN + col % CIN]);
    x_s[i] = v;
  }
  __syncthreads();

  const int t = threadIdx.x % kThreadsPerPixel;
  const int g = threadIdx.x / kThreadsPerPixel;
  const int pixels = rows * wo;
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  T* y_blk = y + ((int64_t)n * ho + row0) * wo * kFilters + t * 8;

  for (int base = 0; base < pixels; base += kPixelGroups * kPixelsPerThread) {
    float acc[kPixelsPerThread][8];
    int off[kPixelsPerThread];   // the pixel's top-left tap in x_s
#pragma unroll
    for (int p = 0; p < kPixelsPerThread; ++p) {
      const int q = min(base + p * kPixelGroups + g, pixels - 1);
      off[p] = 2 * (q / wo) * pitch + 2 * (q % wo) * CIN;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[p][k] = 0.f;
    }
    // one (a, b) position per iteration, not unrolled: unrolling all 16 * CIN
    // taps let the compiler hoist their loads into 255 registers and spill
#pragma unroll 1
    for (int ab = 0; ab < 16; ++ab) {
      const int a = ab >> 2, b = ab & 3;
#pragma unroll
      for (int c = 0; c < CIN; ++c) {
        const int tap = ab * CIN + c;
        const float4 w0 = w4[tap * 16 + t];
        const float4 w1 = w4[tap * 16 + 8 + t];
#pragma unroll
        for (int p = 0; p < kPixelsPerThread; ++p) {
          const float v = x_s[off[p] + a * pitch + b * CIN + c];
          acc[p][0] = fmaf(v, w0.x, acc[p][0]);
          acc[p][1] = fmaf(v, w0.y, acc[p][1]);
          acc[p][2] = fmaf(v, w0.z, acc[p][2]);
          acc[p][3] = fmaf(v, w0.w, acc[p][3]);
          acc[p][4] = fmaf(v, w1.x, acc[p][4]);
          acc[p][5] = fmaf(v, w1.y, acc[p][5]);
          acc[p][6] = fmaf(v, w1.z, acc[p][6]);
          acc[p][7] = fmaf(v, w1.w, acc[p][7]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPixelsPerThread; ++p) {
      const int pix = base + p * kPixelGroups + g;
      if (pix < pixels) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[p][k] = acc[p][k] >= 0.f ? acc[p][k] : kSlope * acc[p][k];
        store8(y_blk + (int64_t)pix * kFilters, acc[p]);
      }
    }
  }
}

template <typename T, int CIN>
int launch(const void* x, const void* w, void* y, int n, int h, int wd, cudaStream_t stream) {
  int rows = 4;
  while (rows > 1 && smem_bytes(CIN, rows, wd) > kSmemTarget) rows /= 2;
  const size_t bytes = smem_bytes(CIN, rows, wd);
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = stem_conv_kernel<T, CIN>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((h / 2 + rows - 1) / rows, n);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                            static_cast<T*>(y), h, wd, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cin(const void* x, const void* w, void* y, int n, int h, int wd, int c_in,
               cudaStream_t stream) {
  switch (c_in) {
    case 1: return launch<T, 1>(x, w, y, n, h, wd, stream);
    case 2: return launch<T, 2>(x, w, y, n, h, wd, stream);
    case 3: return launch<T, 3>(x, w, y, n, h, wd, stream);
    case 6: return launch<T, 6>(x, w, y, n, h, wd, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (n, h, wd, c_in) NHWC, dtype 0 fp32 / 1 bf16; w: (64, 4, 4, c_in) OHWI
// and y: (n, h/2, wd/2, 64) NHWC, both in x's dtype. c_in in {1, 2, 3, 6}, h and wd even.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gan_stem_conv(const void* x, const void* w, void* y, int n, int h, int wd,
                             int c_in, int dtype, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || wd <= 0 || h % 2 || wd % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_cin<float>(x, w, y, n, h, wd, c_in, s);
  if (dtype == kBFloat16) return launch_cin<__nv_bfloat16>(x, w, y, n, h, wd, c_in, s);
  return (int)cudaErrorInvalidValue;
}
