// The producers of the Q80 activations, with the quantization as their
// epilogue, for Hopper (sm_90a), bound to Python through ctypes
// (nano_tpu_torch/ops/norm_quant.py).
//
// Replaces the TPU path's XLA fusions next to the Pallas K1 kernel
// (nano_tpu/ops/qmatmul.py::_q80_kernel): the residual add and RMSNorm of
// nano_tpu/models/gpt.py (rms_norm, block), SwiGLU's silu(h1) * h3
// (feed_forward), and act_quant_q80 (nano_tpu/ops/qmatmul.py), which
// q80_matmul_int8 applies to their rounded output:
//
//   rms_norm_q80  h = x + a rounded to the activation type (when a is
//                 given: the one rounding of the eager add), hn =
//                 rms_norm(h) = h * rsqrt(mean(h^2) + eps) * w in f32,
//                 rounded to the activation type; with gs > 0 also the
//                 Q80 quantization of the rounded hn (int8 xq, f32 sa).
//   swiglu_q80    y = silu(h1) * h3 of h13 = [h1 | h3]: silu as PyTorch's
//                 CUDA silu computes it (x / (1 + expf(-x)) in f32,
//                 rounded), the product of the two rounded values rounded
//                 once more; with gs > 0 also y's Q80 quantization.
//
// The quantization is q80_quant.cuh's, the code of q80_act_quant and
// q80_matvec_fq: the integer decisions are those of q80_act_quant on the
// rounded output.  IEEE division and expf, no contraction of the eager
// ops' separate roundings: never built with --use_fast_math.
//
// Design.  A launch of q80_act_quant alone costs ~2 us on the H100 for
// ~48 KB of work; the only way to remove it is to not launch it, so the
// quantization runs where its input is made, while the row is in
// registers.  One block a row (T threads, a multiple of 32, up to 1024),
// the row in registers: thread t holds values [4 c, 4 c + 4) of chunk c =
// p T + t for p < P (8-byte loads of bf16, 16-byte of f32).  The norm's
// sum of squares: each thread over its chunks in order, a warp's xor
// shuffle (every lane ends with the same bits), the warps' sums in
// shared memory added in warp order.  A group of gs values is gs / 4
// consecutive threads (a power of two): its absmax is a shuffle over
// them, and where a group spans warps (gs > 128) one exchange of the
// warps' maxima in shared memory.  Each value is read once and each
// output written once.  T and P come from the row width alone
// (ops/norm_quant.py:plan), never from the row count, so a row gets the
// same bits in a launch of 1 row as in one of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q80_quant.cuh"

namespace {

constexpr int kNV = 4;          // values of a chunk
constexpr int kMaxWarps = 32;   // 1024 threads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to T, as a float
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the chunk p[i, i + 4): one vector load where `vec` (the row aligned and
// the chunk inside it), else element by element, 0 past n
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, int i, int n, bool vec,
                                           float v[kNV]) {
  if (vec && i + kNV <= n) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(p + i);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
      v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kNV; ++j) v[j] = i + j < n ? to_f(p[i + j]) : 0.f;
  }
}

// values already representable in T
template <typename T>
__device__ __forceinline__ void store_chunk(T* __restrict__ p, int i, int n, bool vec,
                                            const float v[kNV]) {
  if (vec && i + kNV <= n) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint2 q;
      *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(p + i) = q;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kNV; ++j)
      if (i + j < n) from_f(p + i + j, v[j]);
  }
}

// The Q80 quantization of the chunk v at value i of a row of n values
// (n % gs == 0, gs / 4 = tpg a power of two, every thread of the block
// calling): the group's absmax over its tpg threads, then the chunk's
// int8 values into xq[i, i + 4) and, from the group's first thread, its
// scale into sa[i / gs].  wmax: kMaxWarps floats of shared memory.
__device__ __forceinline__ void quantize_chunk(const float v[kNV], int i, int n, int gs,
                                               int8_t* __restrict__ xq, float* __restrict__ sa,
                                               float* wmax) {
  const int tpg = gs / kNV;
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kNV; ++j) m = fmaxf(m, fabsf(v[j]));
  for (int off = min(tpg, 32) >> 1; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (tpg > 32) {   // the group spans tpg / 32 warps
    const int warp = threadIdx.x >> 5, nw = tpg >> 5;
    if ((threadIdx.x & 31) == 0) wmax[warp] = m;
    __syncthreads();
    const int w0 = warp - warp % nw;
    for (int w = w0; w < w0 + nw; ++w) m = fmaxf(m, wmax[w]);
    __syncthreads();   // wmax is free for the next chunk
  }
  if (i >= n) return;
  const float s = q80q::scale(m);
  const float div = q80q::divisor(s);
  char4 q;
  q.x = q80q::value(v[0], div);
  q.y = q80q::value(v[1], div);
  q.z = q80q::value(v[2], div);
  q.w = q80q::value(v[3], div);
  *reinterpret_cast<char4*>(xq + i) = q;
  if (i % gs == 0) sa[i / gs] = s;
}

// One block a row of x (B, E): h = x + a (when a), hn = rms_norm(h) * w,
// and with gs > 0 hn's Q80 quantization.  h, hn, xq / sa may each be null.
template <typename XT, int P>
__global__ void __launch_bounds__(1024) rms_norm_q80_kernel(const XT* __restrict__ x, const XT* __restrict__ a,
                                    const float* __restrict__ w, XT* __restrict__ h,
                                    XT* __restrict__ hn, int8_t* __restrict__ xq,
                                    float* __restrict__ sa, int E, float eps, int gs, int vec) {
  __shared__ float wsum[kMaxWarps];
  __shared__ float wmax[kMaxWarps];
  const size_t row = blockIdx.x;
  const int T = blockDim.x, t = threadIdx.x;
  x += row * E;
  if (a) a += row * E;
  float v[P][kNV];
  float ss = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = (p * T + t) * kNV;
    load_chunk(x, i, E, vec, v[p]);
    if (a) {
      float r[kNV];
      load_chunk(a, i, E, vec, r);
#pragma unroll
      for (int j = 0; j < kNV; ++j) v[p][j] = round_to<XT>(__fadd_rn(v[p][j], r[j]));
      if (h && i < E) store_chunk(h + row * E, i, E, vec, v[p]);
    }
#pragma unroll
    for (int j = 0; j < kNV; ++j) ss = __fadd_rn(ss, __fmul_rn(v[p][j], v[p][j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if ((t & 31) == 0) wsum[t >> 5] = ss;
  __syncthreads();
  ss = 0.f;
  for (int k = 0; k < (T >> 5); ++k) ss = __fadd_rn(ss, wsum[k]);
  // torch.mean's sum times 1 / E, + eps, CUDA's rsqrtf as torch.rsqrt's
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / (float)E), eps));
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = (p * T + t) * kNV;
    float wv[kNV];
    load_chunk(w, i, E, vec, wv);
#pragma unroll
    for (int j = 0; j < kNV; ++j) v[p][j] = round_to<XT>(__fmul_rn(__fmul_rn(v[p][j], r), wv[j]));
    if (hn && i < E) store_chunk(hn + row * E, i, E, vec, v[p]);
    if (gs) quantize_chunk(v[p], i, E, gs, xq + row * E, sa + row * (E / gs), wmax);
  }
}

// One block a row of h13 (B, 2F) = [h1 | h3]: y = silu(h1) * h3 (B, F),
// and with gs > 0 y's Q80 quantization.  y, xq / sa may each be null.
template <typename XT, int P>
__global__ void __launch_bounds__(1024) swiglu_q80_kernel(const XT* __restrict__ h13, XT* __restrict__ y,
                                  int8_t* __restrict__ xq, float* __restrict__ sa, int F, int gs,
                                  int vec) {
  __shared__ float wmax[kMaxWarps];
  const size_t row = blockIdx.x;
  const int T = blockDim.x, t = threadIdx.x;
  const XT* h1 = h13 + row * 2 * F;
  const XT* h3 = h1 + F;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = (p * T + t) * kNV;
    float g[kNV], u[kNV];
    load_chunk(h1, i, F, vec, g);
    load_chunk(h3, i, F, vec, u);
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      const float s = round_to<XT>(g[j] / __fadd_rn(1.0f, expf(-g[j])));
      g[j] = round_to<XT>(__fmul_rn(s, u[j]));
    }
    if (y && i < F) store_chunk(y + row * F, i, F, vec, g);
    if (gs) quantize_chunk(g, i, F, gs, xq + row * F, sa + row * (F / gs), wmax);
  }
}

#define NANO_NQ_PASSES(MACRO) \
  MACRO(1)                    \
  MACRO(2)                    \
  MACRO(4)                    \
  MACRO(8)                    \
  MACRO(16)

template <typename XT>
cudaError_t launch_norm(int P, int B, int T, cudaStream_t st, const XT* x, const XT* a,
                        const float* w, XT* h, XT* hn, int8_t* xq, float* sa, int E, float eps,
                        int gs, int vec) {
  switch (P) {
#define NANO_NQ_CASE(PP)                                                                     \
  case PP:                                                                                   \
    rms_norm_q80_kernel<XT, PP><<<B, T, 0, st>>>(x, a, w, h, hn, xq, sa, E, eps, gs, vec);   \
    break;
    NANO_NQ_PASSES(NANO_NQ_CASE)
#undef NANO_NQ_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_swiglu(int P, int B, int T, cudaStream_t st, const XT* h13, XT* y,
                          int8_t* xq, float* sa, int F, int gs, int vec) {
  switch (P) {
#define NANO_NQ_CASE(PP)                                                         \
  case PP:                                                                       \
    swiglu_q80_kernel<XT, PP><<<B, T, 0, st>>>(h13, y, xq, sa, F, gs, vec);      \
    break;
    NANO_NQ_PASSES(NANO_NQ_CASE)
#undef NANO_NQ_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// T threads (a multiple of 32, at most 1024) and P passes cover n values;
// a quantized row: gs a power of two from 4 up, dividing n, whose gs / 4
// threads divide T, so that a group is whole in one pass
bool shape_ok(int n, int gs, int T, int P) {
  if (n < 1 || T < 32 || T > 1024 || T % 32 || (long long)P * T * kNV < n) return false;
  if (gs == 0) return true;
  return gs >= kNV && (gs & (gs - 1)) == 0 && T % (gs / kNV) == 0 && n % gs == 0;
}

}  // namespace

// Every entry point launches on the caller's stream, never synchronises,
// and returns cudaGetLastError() (0 on success).  x_bf16 selects bf16
// activations (else f32); `vec` that every row of every activation
// pointer is aligned to 4 values (8 bytes of bf16, 16 of f32).

// x (B, E), a (B, E) or null, w (E) f32 -> h (B, E) or null (written only
// with a), hn (B, E) or null, and with gs > 0 xq (B, E) int8 and sa
// (B, E / gs) f32; T threads and P passes of ops/norm_quant.py:plan(E).
extern "C" int rms_norm_q80(const void* x, const void* a, const void* w, void* h, void* hn,
                            void* xq, void* sa, int x_bf16, int B, int E, float eps, int gs,
                            int T, int P, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || !shape_ok(E, gs, T, P) || (gs && (!xq || !sa)))
    return (int)cudaErrorInvalidValue;
  const float* w_ = static_cast<const float*>(w);
  int8_t* xq_ = gs ? static_cast<int8_t*>(xq) : nullptr;
  float* sa_ = gs ? static_cast<float*>(sa) : nullptr;
  if (x_bf16) {
    using XT = __nv_bfloat16;
    return (int)launch_norm<XT>(P, B, T, st, static_cast<const XT*>(x), static_cast<const XT*>(a),
                                w_, static_cast<XT*>(h), static_cast<XT*>(hn), xq_, sa_, E, eps,
                                gs, vec);
  }
  return (int)launch_norm<float>(P, B, T, st, static_cast<const float*>(x),
                                 static_cast<const float*>(a), w_, static_cast<float*>(h),
                                 static_cast<float*>(hn), xq_, sa_, E, eps, gs, vec);
}

// h13 (B, 2F) -> y (B, F) or null, and with gs > 0 xq (B, F) int8 and sa
// (B, F / gs) f32; T threads and P passes of ops/norm_quant.py:plan(F).
extern "C" int swiglu_q80(const void* h13, void* y, void* xq, void* sa, int x_bf16, int B, int F,
                          int gs, int T, int P, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || !shape_ok(F, gs, T, P) || (gs && (!xq || !sa))) return (int)cudaErrorInvalidValue;
  int8_t* xq_ = gs ? static_cast<int8_t*>(xq) : nullptr;
  float* sa_ = gs ? static_cast<float*>(sa) : nullptr;
  if (x_bf16) {
    using XT = __nv_bfloat16;
    return (int)launch_swiglu<XT>(P, B, T, st, static_cast<const XT*>(h13), static_cast<XT*>(y),
                                  xq_, sa_, F, gs, vec);
  }
  return (int)launch_swiglu<float>(P, B, T, st, static_cast<const float*>(h13),
                                   static_cast<float*>(y), xq_, sa_, F, gs, vec);
}
