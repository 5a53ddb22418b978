// Fused stem convolution for Hopper (sm_90a): y = LeakyReLU_0.3(conv(x, w)),
// the conv 4x4, stride 2, TF-'same' padding (1 on each side for even H, W), no
// bias, 64 filters.
//
// It replaces benchmarks/pallas_stem_proto.py:_stem_kernel (stem_conv_pallas):
// the first Downsample block of every U-Net and PatchGAN, which has no norm.
// Same math: 16 * C_in taps per output, fp32 accumulation, the LeakyReLU taken
// in fp32 before the one rounding to the output type. The taps come in the
// compute type, as the plain version casts them, so in bf16 every product is
// exact in fp32.
//
// Layout: x is NHWC (N, H, W, C_in), contiguous; w is OHWI (64, 4, 4, C_in),
// the channels-last memory of PyTorch's OIHW weight, in x's type; y is NHWC
// (N, H/2, W/2, 64), contiguous, which the next conv reads as channels-last.
// The TPU kernel wrote NHCW, a Mosaic workaround its caller transposed back;
// nothing here needs it.
//
// What bounds it: writing y. With C_in <= 6 the output is 64 / C_in * 4 times
// the input's size (4x fewer pixels, 64 channels): at batch 32 and C_in 1 or
// 2, y is 89-94% of the bytes. The product is small (2 * 64 * 16 * C_in
// flops per pixel) but too deep for the CUDA cores' fp32 FMAs: at C_in 2 in
// bf16 they alone took longer than the write. On the tensor cores it takes a
// few percent of the write's time, so the bf16 design is about the write:
// every store is 16 bytes, each warp instruction 512 contiguous bytes, and
// the staging of a block's inputs is one round of cp.async.
//
// bf16: stem_conv_mma_kernel, an implicit GEMM on the tensor cores
// (mma.sync.m16n8k16, fp32 accumulators). M = output pixels, N = 64 filters,
// K = 16 * C_in ordered k = (a * 4 + b) * C_in + c (window row a, column b,
// channel c), which is the OHWI weight as it lies in memory.
// - One block owns `rows` output rows of one sample. It stages the 2 * rows
//   + 2 zero-padded input rows it needs in shared memory (cp.async of 16
//   bytes where the rows allow, else 4), and the weights in the order of
//   the B fragments.
// - A fragments: for one window row a, the 4 * C_in values of K of an
//   output pixel are contiguous in its staged input row, so each pair
//   (k, k + 1) is one aligned 32-bit shared load (at odd C_in the pairs
//   start on odd elements: two loads and a byte permute). No im2col buffer.
// - Each warp takes 16-pixel M tiles (consecutive pixels of the block's
//   span) by all 64 filters: C_in k-steps of 8 mma each. B stays in
//   registers (at C_in 6, where that would take 96 registers, it is loaded
//   from shared memory at every k-step).
// - The epilogue takes the LeakyReLU in fp32 and rounds once to bf16 into a
//   per-warp staging tile (16-byte chunks XOR-swizzled by row, free of bank
//   conflicts both ways), then stores the tile as 16-byte stores of 512
//   contiguous bytes: the block's pixels are one contiguous span of y.
// The geometry (rows, warps, row pitch, load width, shared bytes) comes from
// ops/kernels.py:stem_plan.
//
// fp32: stem_conv_kernel on the CUDA cores (TF32 would break fp32's 1e-5
// tolerance). It stages the rows and the weights as fp32; eight threads share
// an output pixel, each computing 8 consecutive filters, so a warp covers 4
// neighbouring pixels and writes them as 32 16-byte stores of 512 contiguous
// bytes. Each thread accumulates kPixelsPerThread pixels at once, so one load
// of its 8 weights from shared memory serves that many pixels' FMAs.

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
constexpr size_t kSmemMax = 232448;          // what one block may take on an H100

enum DType { kFloat32 = 0, kBFloat16 = 1 };

// ---- bf16: tensor cores -------------------------------------------------

constexpr int kTile = 16;                    // pixels of a warp's M tile
constexpr int kTileBytes = kTile * kFilters * 2;   // its bf16 staging tile
constexpr int kMaxWarps = kThreads / 32;

// element offset of padded column 0 in a staged row, such that the image's
// first column starts on 16 bytes for cp.async; with an odd C_in the A pairs
// then start on odd elements
__host__ __device__ constexpr int stem_lead(int c_in) { return (8 - c_in % 8) % 8; }

__host__ __device__ constexpr size_t mma_smem_bytes(int c_in, int rows, int pitch, int warps) {
  return (size_t)kTaps * c_in * kFilters * 2 + (size_t)warps * kTileBytes +
         (size_t)(2 * rows + 2) * pitch * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes global -> shared, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// the bf16 pair at elements e, e + 1 of shared memory as one word: one load
// where e is even, else the two aligned words around it
template <bool kOdd>
__device__ __forceinline__ uint32_t pair_at(const uint16_t* x_s, int e) {
  if constexpr (kOdd) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(x_s + e - 1);
    return __byte_perm(w[0], w[1], 0x5432);   // the high half of one, the low half of the next
  } else {
    return *reinterpret_cast<const uint32_t*>(x_s + e);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t leaky_pack(float lo, float hi) {
  lo = lo >= 0.f ? lo : kSlope * lo;
  hi = hi >= 0.f ? hi : kSlope * hi;
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo at the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One k-step of a warp's 16 x 64 tile: the A fragment from the staged rows
// (lane l: pixels l / 4 and l / 4 + 8, k = 16 * ks + 2 * (l % 4) + {0, 1}
// and + {8, 9}; k's window row is k / (4 C_in), its offset in the staged row
// k % (4 C_in)), then 8 mma, one per 8 filters.
template <int CIN>
__device__ __forceinline__ void mma_step(float (&acc)[8][4], const uint16_t* x_s, int base_lo,
                                         int base_hi, int pitch, int ks, int t,
                                         const uint4 (&b)[4]) {
  constexpr int kRowK = 4 * CIN;
  const int k0 = ks * 16 + 2 * t, k1 = k0 + 8;
  const int off0 = (k0 / kRowK) * pitch + k0 % kRowK;
  const int off1 = (k1 / kRowK) * pitch + k1 % kRowK;
  constexpr bool kOdd = CIN % 2;
  const uint32_t a[4] = {pair_at<kOdd>(x_s, base_lo + off0), pair_at<kOdd>(x_s, base_hi + off0),
                         pair_at<kOdd>(x_s, base_lo + off1), pair_at<kOdd>(x_s, base_hi + off1)};
#pragma unroll
  for (int pair = 0; pair < 4; ++pair) {
    mma_bf16(acc[2 * pair], a, b[pair].x, b[pair].y);
    mma_bf16(acc[2 * pair + 1], a, b[pair].z, b[pair].w);
  }
}

// Shared memory: the B fragments [k-step][filter-tile pair][lane] as uint4,
// one staging tile per warp [16 pixels][8 chunks of 16 bytes], then the
// staged input rows, `pitch` elements apart (a multiple of 8), padded column 0
// at element `stem_lead(CIN)` of each.
template <int CIN>
__global__ void __launch_bounds__(kThreads, 2)
stem_conv_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ y, int h, int wd, int rows_per_block, int pitch,
                     int vec) {
  constexpr int kSteps = CIN;                // K = 16 * CIN: one m16n8k16 step per 16
  constexpr bool kBInRegs = CIN <= 3;        // 16 * CIN registers of B
  constexpr int kLead = stem_lead(CIN);
  extern __shared__ uint4 smem[];
  const uint4* w_s = smem;
  uint32_t* tiles_s = reinterpret_cast<uint32_t*>(smem + kSteps * 4 * 32);
  const int warps = blockDim.x / 32;
  uint16_t* x_s = reinterpret_cast<uint16_t*>(tiles_s + warps * kTileBytes / 4);
  const int ho = h / 2, wo = wd / 2;
  const int n = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, ho - row0);
  const int staged = 2 * rows + 2;           // input rows 2*row0 - 1 .. 2*(row0 + rows)
  const int row_elems = wd * CIN;

  // Input rows; rows outside the image are zero. cp.async of 16 bytes (vec
  // 8: each row's W * C_in elements a multiple of 8 and x on 16 bytes) or 4.
  const uint16_t* x_n = reinterpret_cast<const uint16_t*>(x) + (int64_t)n * h * row_elems;
  const int chunks = row_elems / vec;
  for (int i = threadIdx.x; i < staged * chunks; i += blockDim.x) {
    const int r = i / chunks, q = i - r * chunks;
    const int hi = 2 * row0 - 1 + r;
    const bool inside = hi >= 0 && hi < h;
    uint16_t* dst = x_s + r * pitch + kLead + CIN + q * vec;
    const uint16_t* src = x_n + (int64_t)(inside ? hi : 0) * row_elems + q * vec;
    if (vec == 8)
      cp_async16(dst, src, inside ? 16 : 0);
    else
      cp_async4(dst, src, inside ? 4 : 0);
  }
  // the zero columns on either side
  for (int i = threadIdx.x; i < staged * 2 * CIN; i += blockDim.x) {
    const int r = i / (2 * CIN), e = i - r * 2 * CIN;
    x_s[r * pitch + kLead + (e < CIN ? e : (wd + 1) * CIN + e - CIN)] = 0;
  }
  // B fragments of m16n8k16 (B is K x 8 filters): lane l holds filter
  // 8 * tile + l / 4 at k = 16 * step + 2 * (l % 4) + {0, 1} and {8, 9}; each
  // pair is one 32-bit word of the OHWI weight, w[f][k].
  {
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(w);
    uint32_t* ws32 = reinterpret_cast<uint32_t*>(smem);
    for (int i = threadIdx.x; i < kSteps * 4 * 32 * 4; i += blockDim.x) {
      const int e = i & 3, l = (i >> 2) & 31, pair = (i >> 7) & 3, ks = i >> 9;
      const int f = (2 * pair + (e >> 1)) * 8 + (l >> 2);
      const int k = ks * 16 + 2 * (l & 3) + 8 * (e & 1);
      cp_async4(ws32 + i, w32 + ((f * kTaps * CIN + k) >> 1), 4);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint4 b_regs[kBInRegs ? kSteps : 1][4];
  if constexpr (kBInRegs) {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int pair = 0; pair < 4; ++pair) b_regs[ks][pair] = w_s[(ks * 4 + pair) * 32 + lane];
  }
  uint32_t* tile_s = tiles_s + warp * kTileBytes / 4;
  const int pixels = rows * wo;
  __nv_bfloat16* y_blk = y + ((int64_t)n * ho + row0) * wo * kFilters;

  for (int p0 = warp * kTile; p0 < pixels; p0 += warps * kTile) {
    // A fragments: lane l holds pixels p0 + l / 4 and p0 + l / 4 + 8 (the
    // last tile repeats the span's last pixel and stores nothing of it)
    const int p_lo = min(p0 + g, pixels - 1), p_hi = min(p0 + g + 8, pixels - 1);
    const int base_lo = 2 * (p_lo / wo) * pitch + 2 * (p_lo % wo) * CIN + kLead;
    const int base_hi = 2 * (p_hi / wo) * pitch + 2 * (p_hi % wo) * CIN + kLead;
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

    if constexpr (kBInRegs) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        mma_step<CIN>(acc, x_s, base_lo, base_hi, pitch, ks, t, b_regs[ks]);
    } else {
#pragma unroll 1
      for (int ks = 0; ks < kSteps; ++ks) {
        uint4 b[4];
#pragma unroll
        for (int pair = 0; pair < 4; ++pair) b[pair] = w_s[(ks * 4 + pair) * 32 + lane];
        mma_step<CIN>(acc, x_s, base_lo, base_hi, pitch, ks, t, b);
      }
    }

    // C fragment: lane l holds rows l / 4 and l / 4 + 8, filters 8 * nt +
    // 2 * (l % 4) + {0, 1}. Row r's 16-byte chunk c sits at chunk c ^ (r % 8).
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int word = ((nt ^ g) << 2) + t;
      tile_s[g * 32 + word] = leaky_pack(acc[nt][0], acc[nt][1]);
      tile_s[(g + 8) * 32 + word] = leaky_pack(acc[nt][2], acc[nt][3]);
    }
    __syncwarp();
    // 4 rows of 128 bytes per store instruction, 512 contiguous bytes of y
    const int valid = min(kTile, pixels - p0);
#pragma unroll
    for (int it = 0; it < kTile / 4; ++it) {
      const int r = it * 4 + (lane >> 3), q = lane & 7;
      if (r < valid)
        *reinterpret_cast<uint4*>(y_blk + (int64_t)(p0 + r) * kFilters + q * 8) =
            reinterpret_cast<const uint4*>(tile_s)[r * 8 + (q ^ (r & 7))];
    }
    __syncwarp();
  }
}

template <int CIN>
int launch_mma(const void* x, const void* w, void* y, int n, int h, int wd, int rows, int warps,
               int pitch, int vec, int smem, cudaStream_t stream) {
  const int ho = h / 2;
  const bool aligned = vec == 2 || (vec == 8 && (wd * CIN) % 8 == 0);
  if (rows < 1 || warps < 1 || warps > kMaxWarps || !aligned || pitch % 8 ||
      pitch < stem_lead(CIN) + (wd + 2) * CIN || reinterpret_cast<uintptr_t>(x) % (2 * vec) ||
      reinterpret_cast<uintptr_t>(w) % 4 || reinterpret_cast<uintptr_t>(y) % 16 ||
      (size_t)smem != mma_smem_bytes(CIN, rows, pitch, warps) || (size_t)smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  auto kernel = stem_conv_mma_kernel<CIN>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((ho + rows - 1) / rows, n);
  kernel<<<grid, warps * 32, smem, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const __nv_bfloat16*>(w),
                                             static_cast<__nv_bfloat16*>(y), h, wd, rows, pitch,
                                             vec);
  return (int)cudaGetLastError();
}

// ---- fp32: CUDA cores ---------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }

// 8 consecutive outputs: two 16-byte stores
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
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
int launch(const void* x, const void* w, void* y, int n, int h, int wd, int rows, int smem,
           cudaStream_t stream) {
  if (rows < 1 || (size_t)smem != smem_bytes(CIN, rows, wd) || (size_t)smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  auto kernel = stem_conv_kernel<T, CIN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((h / 2 + rows - 1) / rows, n);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                           static_cast<T*>(y), h, wd, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, h, wd, c_in) NHWC, dtype 0 fp32 / 1 bf16; w: (64, 4, 4, c_in) OHWI
// and y: (n, h/2, wd/2, 64) NHWC, both in x's dtype. c_in in {1, 2, 3, 6}, h and wd even.
// The plan (ops/kernels.py:stem_plan): output rows per block, warps per block,
// and shared-memory bytes; in bf16 also the staged row pitch in elements and
// the load width of x (8 or 2 elements). fp32 takes 8 warps and the unpadded
// pitch. Returns the launch's cudaError_t (0 on success).
extern "C" int gan_stem_conv(const void* x, const void* w, void* y, int n, int h, int wd,
                             int c_in, int dtype, int rows, int warps, int pitch, int vec,
                             int smem, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || wd <= 0 || h % 2 || wd % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (warps * 32 != kThreads || pitch != (wd + 2) * c_in || vec != 1)
      return (int)cudaErrorInvalidValue;
    switch (c_in) {
      case 1: return launch<float, 1>(x, w, y, n, h, wd, rows, smem, s);
      case 2: return launch<float, 2>(x, w, y, n, h, wd, rows, smem, s);
      case 3: return launch<float, 3>(x, w, y, n, h, wd, rows, smem, s);
      case 6: return launch<float, 6>(x, w, y, n, h, wd, rows, smem, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == kBFloat16) {
    switch (c_in) {
      case 1: return launch_mma<1>(x, w, y, n, h, wd, rows, warps, pitch, vec, smem, s);
      case 2: return launch_mma<2>(x, w, y, n, h, wd, rows, warps, pitch, vec, smem, s);
      case 3: return launch_mma<3>(x, w, y, n, h, wd, rows, warps, pitch, vec, smem, s);
      case 6: return launch_mma<6>(x, w, y, n, h, wd, rows, warps, pitch, vec, smem, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
