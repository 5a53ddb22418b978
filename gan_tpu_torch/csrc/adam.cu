// Adam's update of many fp32 tensors for Hopper (sm_90a), one pass over each
// parameter's state: read p, g, m, v once, write p, m, v once.
//
// It replaces no Pallas kernel: gan_tpu's Adam is optax's (gan_tpu/train/
// optim.py:adam) under XLA, which fuses the update into the step. In the port
// torch.optim.Adam(capturable=True) took the foreach path: eight full-size
// passes (lerp_, mul_, addcmul_, a sqrt into a new tensor, three div_/add_,
// addcdiv_), 80 bytes a parameter.
//
// What bounds it: 28 bytes a parameter at 3.35 TB/s (57.17 M parameters of a
// Pix2Pix step: 0.478 ms; 114.3 M of a CycleGAN step: 0.955 ms). There are a
// few dozen flops an element, far below the card's rate. So the design is
// about the bytes: each block streams one chunk of kChunk elements of one
// tensor with 16-byte loads and stores where all four of its tensors allow
// it (a scalar tail where the length is not a multiple of 4, and a scalar
// path for a tensor off the 16-byte grid), each thread keeping kUnroll
// float4s of each tensor in flight. Nothing of a parameter's size is
// written besides p, m and v, and nothing is allocated.
//
// The arithmetic is torch's capturable foreach form in fp32, term for term:
//   m <- lerp(m, g, 1 - beta1)   (ATen's two-sided lerp, Lerp.h)
//   v <- (v * beta2) + (1 - beta2) * (g * g)
//   step_size = 1 / ((beta1^t - 1) / lr)        = -lr / (1 - beta1^t)
//   bc2_sqrt  = sqrt(-(beta2^t - 1))
//   p <- p + m / (((sqrt(v) / bc2_sqrt) + eps) / step_size)
// with t the step after its increment. The fused multiply-adds are written
// out (fmaf), so the compiler cannot contract the update another way; the
// divisions and square roots are IEEE-rounded (nvcc's defaults).
//
// The tensor table (pointers, lengths, the first block of each tensor) is a
// __grid_constant__ kernel parameter within the classic 4-KB limit, so a
// CUDA-graph capture keeps its own copy and nothing outlives the call: up to
// kMaxTensors tensors a launch. A block finds its tensor by a binary search
// of the first blocks.
//
// Step counts: every block of a tensor reads its step, so none of them may
// advance it. The update launches read step and use step + 1; after them, a
// one-block launch (adam_steps_multi_tensor_apply_kernel) adds one to every
// step. Stream order keeps it behind every block of the updates.
//
// Each update launch, a CUDA-graph replay's included, adds one to a counter
// on the card (the first thread of its first block), which
// gan_adam_launches() reads; the count launches are not counted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;         // elements of one tensor a block updates
constexpr int kUnroll = 2;           // float4s of each tensor a thread loads before it computes
constexpr int kMaxTensors = 80;      // tensors of one update launch
constexpr int kMaxSteps = 500;       // step counts of one count launch
constexpr int kParamBytes = 4096;    // kernel parameter space on any CUDA version

struct Hyper {
  float lr, beta1, beta2, eps;
  float weight;            // 1 - beta1, lerp's weight
  float one_minus_beta2;
};

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  const float* step[kMaxTensors];
  int numel[kMaxTensors];
  int first_chunk[kMaxTensors + 1];   // tensor i owns blocks [first_chunk[i], first_chunk[i + 1])
  int n;
  Hyper h;
};
static_assert(sizeof(Table) <= kParamBytes, "the update's table exceeds the parameter space");

struct Steps {
  float* step[kMaxSteps];
  int n;
};
static_assert(sizeof(Steps) <= kParamBytes, "the count table exceeds the parameter space");

__device__ unsigned long long g_adam_launches;

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, const Hyper& h,
                                     float step_size, float bc2_sqrt) {
  const float d = g - m;
  m = fabsf(h.weight) < 0.5f ? fmaf(h.weight, d, m) : fmaf(-d, 1.0f - h.weight, g);
  v = fmaf(h.one_minus_beta2, __fmul_rn(g, g), __fmul_rn(v, h.beta2));
  float den = sqrtf(v) / bc2_sqrt;
  den = (den + h.eps) / step_size;
  p = p + m / den;
}

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m, float4& v,
                                      const Hyper& h, float step_size, float bc2_sqrt) {
  adam(p.x, g.x, m.x, v.x, h, step_size, bc2_sqrt);
  adam(p.y, g.y, m.y, v.y, h, step_size, bc2_sqrt);
  adam(p.z, g.z, m.z, v.z, h, step_size, bc2_sqrt);
  adam(p.w, g.w, m.w, v.w, h, step_size, bc2_sqrt);
}

__global__ void __launch_bounds__(kThreads)
adam_multi_tensor_apply_kernel(const __grid_constant__ Table t) {
  const int b = blockIdx.x;
  if ((b | threadIdx.x) == 0) atomicAdd(&g_adam_launches, 1ull);
  int lo = 0, hi = t.n - 1;   // the last tensor whose first block is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int i = lo;
  const int64_t start = (int64_t)(b - t.first_chunk[i]) * kChunk;
  const int64_t rest = t.numel[i] - start;
  const int len = rest < kChunk ? (int)rest : kChunk;
  float* __restrict__ p = t.p[i] + start;
  const float* __restrict__ g = t.g[i] + start;
  float* __restrict__ m = t.m[i] + start;
  float* __restrict__ v = t.v[i] + start;

  const Hyper& h = t.h;
  const float step = *t.step[i] + 1.0f;
  const float step_size = 1.0f / ((powf(h.beta1, step) - 1.0f) / h.lr);
  const float bc2_sqrt = sqrtf(-(powf(h.beta2, step) - 1.0f));

  int done = 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  if ((addr & 15) == 0) {
    const int n4 = len / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int j = threadIdx.x; j < n4; j += kThreads * kUnroll) {
      float4 pr[kUnroll], gr[kUnroll], mr[kUnroll], vr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = j + u * kThreads;
        if (k < n4) {
          gr[u] = g4[k];
          mr[u] = m4[k];
          vr[u] = v4[k];
          pr[u] = p4[k];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = j + u * kThreads;
        if (k < n4) {
          adam4(pr[u], gr[u], mr[u], vr[u], h, step_size, bc2_sqrt);
          p4[k] = pr[u];
          m4[k] = mr[u];
          v4[k] = vr[u];
        }
      }
    }
    done = n4 * 4;
  }
  for (int j = done + threadIdx.x; j < len; j += kThreads) {
    float pj = p[j], mj = m[j], vj = v[j];
    adam(pj, g[j], mj, vj, h, step_size, bc2_sqrt);
    p[j] = pj;
    m[j] = mj;
    v[j] = vj;
  }
}

__global__ void __launch_bounds__(kThreads)
adam_steps_multi_tensor_apply_kernel(const __grid_constant__ Steps s) {
  for (int i = threadIdx.x; i < s.n; i += kThreads) *s.step[i] += 1.0f;
}

}  // namespace

// One Adam update of n fp32 tensors on `stream`. rows: n rows of six int64:
// the addresses of p, g, exp_avg, exp_avg_sq and the 0-dim fp32 step, and
// the element count (1 to 2^31 - 1). p, g, m and v of a row are dense with
// the same strides (the kernel walks their memory as one flat array). weight
// is 1 - beta1 and one_minus_beta2 is 1 - beta2, each rounded once from
// double as torch rounds its scalars. Launches ceil(n / kMaxTensors) updates
// of about equal counts of tensors, then ceil(n / kMaxSteps) count launches;
// *launches gets the number of updates made. Returns the first launch's error that is
// not cudaSuccess, else cudaSuccess.
extern "C" int gan_adam_update(const int64_t* rows, int n, float lr, float beta1, float beta2,
                               float eps, float weight, float one_minus_beta2, void* stream,
                               int* launches) {
  *launches = 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    const int64_t numel = rows[6 * i + 5];
    if (numel <= 0 || numel > INT32_MAX) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < 5; ++k)
      if (rows[6 * i + k] == 0) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{lr, beta1, beta2, eps, weight, one_minus_beta2};
  const int parts = (n + kMaxTensors - 1) / kMaxTensors;
  const int per = (n + parts - 1) / parts;
  for (int lo = 0; lo < n; lo += per) {
    Table t{};
    t.n = n - lo < per ? n - lo : per;
    t.h = h;
    int64_t blocks = 0;
    for (int i = 0; i < t.n; ++i) {
      const int64_t* r = rows + 6 * (int64_t)(lo + i);
      t.p[i] = reinterpret_cast<float*>(r[0]);
      t.g[i] = reinterpret_cast<const float*>(r[1]);
      t.m[i] = reinterpret_cast<float*>(r[2]);
      t.v[i] = reinterpret_cast<float*>(r[3]);
      t.step[i] = reinterpret_cast<const float*>(r[4]);
      t.numel[i] = (int)r[5];
      t.first_chunk[i] = (int)blocks;
      blocks += (r[5] + kChunk - 1) / kChunk;
      if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    }
    t.first_chunk[t.n] = (int)blocks;
    adam_multi_tensor_apply_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches;
  }
  for (int lo = 0; lo < n; lo += kMaxSteps) {
    Steps st{};
    st.n = n - lo < kMaxSteps ? n - lo : kMaxSteps;
    for (int i = 0; i < st.n; ++i) st.step[i] = reinterpret_cast<float*>(rows[6 * (lo + i) + 4]);
    adam_steps_multi_tensor_apply_kernel<<<1, kThreads, 0, s>>>(st);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// Copies the update launches the card has run since the library was loaded.
// Returns a cudaError_t.
extern "C" int gan_adam_launches(unsigned long long* count) {
  return (int)cudaMemcpyFromSymbol(count, g_adam_launches, sizeof(g_adam_launches));
}
