// The producers of the quantized activations, with the quantization as
// their epilogue, for Hopper (sm_90a), bound to Python through ctypes
// (nano_tpu_torch/ops/norm_quant.py).
//
// Replaces the TPU path's XLA fusions next to the Pallas K1 and K3 kernels
// (nano_tpu/ops/qmatmul.py::_q80_kernel, nano_tpu/ops/q4k.py::_q4k_kernel):
// the residual add and RMSNorm of nano_tpu/models/gpt.py (rms_norm,
// block), SwiGLU's silu(h1) * h3 (feed_forward), and the activation
// quantization the products apply to their rounded output: act_quant_q80
// (nano_tpu/ops/qmatmul.py) before a W8A8 product, act_quant_q4k
// (nano_tpu/ops/q4k.py:459, inside fake_quant_act) before a Q4K one:
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
//   rms_norm_q4k, swiglu_q4k
//                 the same with the Q4K epilogue instead: the rounded
//                 output's Q4K integer form (vp, sa, ba, c, as
//                 q4k_act_quant writes it), at every row count: the form
//                 q4k_matvec_fq (one row) and q4k_matmul_w4a4 (more) take.
//   rms_norm_q4k_fq
//                 rms_norm_q4k with the Q4K fake-quant as its epilogue
//                 instead: the values rebuilt from the rounded hn's Q4K
//                 quantization, f32 (B, n_pad), 0 at and past E, as
//                 q4k_fake_quant writes them (nano_tpu/ops/q4k.py:644
//                 fake_quant_act): the final norm of a Q4K model whose
//                 head is the Q80 table requantized from its embedding,
//                 which the C engine feeds that row (infer/infer.c:1012).
//
// The quantizations are q80_quant.cuh's and q4k_quant.cuh's, the code of
// q80_act_quant and q4k_act_quant: the integer decisions are those of the
// standalone kernels on the rounded output.  IEEE division and expf, no
// contraction of the eager ops' separate roundings: never built with
// --use_fast_math.
//
// Design.  A launch of an act quant alone costs ~2 us on the H100 for
// ~48 KB of work; the only way to remove it is to not launch it, so the
// quantization runs where its input is made.  One block a row (T
// threads, a multiple of 32, up to 1024), the row in registers: thread t
// holds values [4 c, 4 c + 4) of chunk c = p T + t for p < P (8-byte
// loads of bf16, 16-byte of f32).  The norm's sum of squares: each thread
// over its chunks in order, a warp's xor shuffle (every lane ends with
// the same bits), the warps' sums in shared memory added in warp order.
// Q80: a group of gs values is gs / 4 consecutive threads (a power of
// two): its absmax is a shuffle over them, and where a group spans warps
// (gs > 128) one exchange of the warps' maxima in shared memory.  Q4K: a
// 256-value block spans 64 threads and needs its 8 groups' maxima for
// the second level, so the rounded row goes to shared memory (as f32, n
// floats of dynamic shared memory) and each warp quantizes whole blocks
// from there as q4k_act_quant does (2 x 16-byte reads a lane): the
// epilogue adds ~0.8 us a launch at B = 1 (chip_smoke.py phase 3: a Q4K
// step's 56 + 28 launches 0.221 ms, a Q80 step's 57 + 28 without it 0.155
// ms, NVIDIA H100 80GB HBM3).  The fake-quant epilogue is the same walk
// with q4k_fake_quant's rebuild (q4k_quant.cuh:fq_block_by_warp) in place
// of the packing: it saves a Q4K decode step the launch of
// q4k_fake_quant (~1.9 us) on the final norm's output.  The integer-form
// kernels let
// their programmatic dependents (q4k_matvec_fq) launch at entry.  Each
// value is read once and each output written once.  T and P come from
// the row width alone (ops/norm_quant.py:plan), never from the row count,
// so a row gets the same bits in a launch of 1 row as in one of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q4k_quant.cuh"
#include "q80_quant.cuh"

namespace {

constexpr int kNV = 4;          // values of a chunk
constexpr int kMaxWarps = 32;   // 1024 threads
// dynamic shared memory of a Q4K instance at most (224 KB of the H100's 227
// KB, the rest for the static arrays): a row of up to 57344 values
constexpr int kMaxRowSmem = 229376;

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

// The chunk v of a row of n values at value i into the row xs in shared
// memory (16-byte aligned).
__device__ __forceinline__ void stash_chunk(float* xs, int i, int n, const float v[kNV]) {
  if (i + kNV <= n) {
    *reinterpret_cast<float4*>(xs + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kNV; ++j)
      if (i + j < n) xs[i + j] = v[j];
  }
}

// The Q4K epilogue: the block's row of n values, rounded to the activation
// type and left in shared memory (xs), quantized 256 values a warp as
// q4k_act_quant quantizes them (q4k_quant.cuh:act_quant_block_by_warp)
// into the row's vp (n_pad / 2), sa, ba and c (n_pad / 32).  Every thread
// of the block calling, after the row is in xs.
__device__ __forceinline__ void quantize_row_q4k(const float* xs, int n, uint8_t* __restrict__ vp,
                                                 float* __restrict__ sa, float* __restrict__ ba,
                                                 float* __restrict__ c) {
  __syncthreads();   // the row is in xs
  const int nblk = (n + 255) >> 8, nw = blockDim.x >> 5;
  for (int blk = threadIdx.x >> 5; blk < nblk; blk += nw)
    q4kq::act_quant_block_by_warp(xs, blk, n, threadIdx.x & 31, vp, sa, ba, c);
}

// The Q4K fake-quant epilogue: the block's row of n values in xs as
// quantize_row_q4k takes it, quantized and rebuilt 256 values a warp as
// q4k_fake_quant does (q4k_quant.cuh:fq_block_by_warp) into the row's fq
// (n_pad f32, 0 at and past n).  Every thread of the block calling.
__device__ __forceinline__ void fake_quant_row_q4k(const float* xs, int n, float* __restrict__ fq) {
  __syncthreads();   // the row is in xs
  const int nblk = (n + 255) >> 8, nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int blk = threadIdx.x >> 5; blk < nblk; blk += nw) {
    float o[8];
    q4kq::fq_block_by_warp(xs, blk, n, lane, o);
    float4* dst = reinterpret_cast<float4*>(fq + (blk << 8) + 8 * lane);
    dst[0] = make_float4(o[0], o[1], o[2], o[3]);
    dst[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
}

// The outputs a norm or SwiGLU kernel quantizes its row into: none, the
// Q80 form (xq, sa at gs), the Q4K integer form (vp, sa, ba, c) or the Q4K
// fake-quant (fq; both Q4K forms with the row also in the dynamic shared
// memory xs).
struct Quant {
  int gs;                    // Q80 group size, 0 for none
  int8_t* xq;                // Q80 values (B, n)
  float* sa;                 // Q80 scales (B, n / gs), or Q4K sa (B, n_pad / 32)
  uint8_t* vp;               // Q4K packed values (B, n_pad / 2), null for none
  float* ba;                 // Q4K ba
  float* c;                  // Q4K c
  float* fq;                 // Q4K fake-quant (B, n_pad), null for none
};

// what a norm kernel's epilogue writes
enum { kOutQ80, kOutQ4k, kOutQ4kFq };

// One block a row of x (B, E): h = x + a (when a), hn = rms_norm(h) * w,
// and hn's quantization (q) in the form OUT says.  h, hn may each be null.
template <typename XT, int P, int OUT>
__device__ __forceinline__ void rms_norm_row(const XT* __restrict__ x, const XT* __restrict__ a,
                                             const float* __restrict__ w, XT* __restrict__ h,
                                             XT* __restrict__ hn, Quant q, int E, float eps,
                                             int vec) {
  __shared__ float wsum[kMaxWarps];
  __shared__ float wmax[kMaxWarps];
  extern __shared__ float xs[];   // a Q4K form: the rounded row
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
    if (OUT != kOutQ80) {
      stash_chunk(xs, i, E, v[p]);
    } else if (q.gs) {
      quantize_chunk(v[p], i, E, q.gs, q.xq + row * E, q.sa + row * (E / q.gs), wmax);
    }
  }
  const int G = ((E + 255) >> 8) << 3;
  if (OUT == kOutQ4k)
    quantize_row_q4k(xs, E, q.vp + row * G * 16, q.sa + row * G, q.ba + row * G, q.c + row * G);
  if (OUT == kOutQ4kFq) fake_quant_row_q4k(xs, E, q.fq + row * G * 32);
}

template <typename XT, int P>
__global__ void __launch_bounds__(1024)
    rms_norm_q80_kernel(const XT* __restrict__ x, const XT* __restrict__ a,
                        const float* __restrict__ w, XT* __restrict__ h, XT* __restrict__ hn,
                        Quant q, int E, float eps, int vec) {
  rms_norm_row<XT, P, kOutQ80>(x, a, w, h, hn, q, E, eps, vec);
}

// Its dependents may launch at once (programmatic dependent launch:
// q4k_matvec_fq streams its weights while this runs, and reads the Q4K
// outputs only after this kernel has ended; `bench q4k step` measured a
// trigger at entry ahead of one after the inputs are read).
template <typename XT, int P>
__global__ void __launch_bounds__(1024)
    rms_norm_q4k_kernel(const XT* __restrict__ x, const XT* __restrict__ a,
                        const float* __restrict__ w, XT* __restrict__ h, XT* __restrict__ hn,
                        Quant q, int E, float eps, int vec) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  rms_norm_row<XT, P, kOutQ4k>(x, a, w, h, hn, q, E, eps, vec);
}

// The final norm of a Q4K model with the requantized Q80 head: the row the
// head reads, fake-quantized.
template <typename XT, int P>
__global__ void __launch_bounds__(1024)
    rms_norm_fq_kernel(const XT* __restrict__ x, const XT* __restrict__ a,
                       const float* __restrict__ w, XT* __restrict__ h, XT* __restrict__ hn,
                       Quant q, int E, float eps, int vec) {
  rms_norm_row<XT, P, kOutQ4kFq>(x, a, w, h, hn, q, E, eps, vec);
}

// One block a row of h13 (B, 2F) = [h1 | h3]: y = silu(h1) * h3 (B, F),
// and y's quantization (q).  y may be null.
template <typename XT, int P, bool Q4>
__device__ __forceinline__ void swiglu_row(const XT* __restrict__ h13, XT* __restrict__ y, Quant q,
                                           int F, int vec) {
  __shared__ float wmax[kMaxWarps];
  extern __shared__ float xs[];   // Q4: the rounded row
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
    if (Q4) {
      stash_chunk(xs, i, F, g);
    } else if (q.gs) {
      quantize_chunk(g, i, F, q.gs, q.xq + row * F, q.sa + row * (F / q.gs), wmax);
    }
  }
  if (Q4) {
    const int G = ((F + 255) >> 8) << 3;
    quantize_row_q4k(xs, F, q.vp + row * G * 16, q.sa + row * G, q.ba + row * G, q.c + row * G);
  }
}

template <typename XT, int P>
__global__ void __launch_bounds__(1024)
    swiglu_q80_kernel(const XT* __restrict__ h13, XT* __restrict__ y, Quant q, int F, int vec) {
  swiglu_row<XT, P, false>(h13, y, q, F, vec);
}

// Its dependents may launch at once, as rms_norm_q4k's.
template <typename XT, int P>
__global__ void __launch_bounds__(1024)
    swiglu_q4k_kernel(const XT* __restrict__ h13, XT* __restrict__ y, Quant q, int F, int vec) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  swiglu_row<XT, P, true>(h13, y, q, F, vec);
}

#define NANO_NQ_PASSES(MACRO) \
  MACRO(1)                    \
  MACRO(2)                    \
  MACRO(4)                    \
  MACRO(8)                    \
  MACRO(16)

template <typename XT>
cudaError_t launch_norm(int out, int P, int B, int T, size_t smem, cudaStream_t st, const XT* x,
                        const XT* a, const float* w, XT* h, XT* hn, Quant q, int E, float eps,
                        int vec) {
  switch (P) {
#define NANO_NQ_CASE(PP)                                                                    \
  case PP:                                                                                  \
    if (out == kOutQ4kFq)                                                                   \
      rms_norm_fq_kernel<XT, PP><<<B, T, smem, st>>>(x, a, w, h, hn, q, E, eps, vec);       \
    else if (out == kOutQ4k)                                                                \
      rms_norm_q4k_kernel<XT, PP><<<B, T, smem, st>>>(x, a, w, h, hn, q, E, eps, vec);      \
    else                                                                                    \
      rms_norm_q80_kernel<XT, PP><<<B, T, 0, st>>>(x, a, w, h, hn, q, E, eps, vec);         \
    break;
    NANO_NQ_PASSES(NANO_NQ_CASE)
#undef NANO_NQ_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_swiglu(bool q4, int P, int B, int T, size_t smem, cudaStream_t st,
                          const XT* h13, XT* y, Quant q, int F, int vec) {
  switch (P) {
#define NANO_NQ_CASE(PP)                                                  \
  case PP:                                                                \
    if (q4)                                                               \
      swiglu_q4k_kernel<XT, PP><<<B, T, smem, st>>>(h13, y, q, F, vec);   \
    else                                                                  \
      swiglu_q80_kernel<XT, PP><<<B, T, 0, st>>>(h13, y, q, F, vec);      \
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

template <typename K, typename... Rest>
cudaError_t allow_smem(K* kernel, Rest*... rest) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxRowSmem);
  if constexpr (sizeof...(rest) == 0) {
    return e;
  } else {
    return e != cudaSuccess ? e : allow_smem(rest...);
  }
}

template <typename XT>
cudaError_t allow_q4k_smem() {
  return allow_smem(rms_norm_q4k_kernel<XT, 1>, rms_norm_q4k_kernel<XT, 2>,
                    rms_norm_q4k_kernel<XT, 4>, rms_norm_q4k_kernel<XT, 8>,
                    rms_norm_q4k_kernel<XT, 16>, rms_norm_fq_kernel<XT, 1>,
                    rms_norm_fq_kernel<XT, 2>, rms_norm_fq_kernel<XT, 4>,
                    rms_norm_fq_kernel<XT, 8>, rms_norm_fq_kernel<XT, 16>,
                    swiglu_q4k_kernel<XT, 1>, swiglu_q4k_kernel<XT, 2>,
                    swiglu_q4k_kernel<XT, 4>, swiglu_q4k_kernel<XT, 8>,
                    swiglu_q4k_kernel<XT, 16>);
}

// A Q4K epilogue's outputs, and its row within the dynamic shared memory a
// block may have
bool q4k_ok(int n, const void* vp, const void* sa, const void* ba, const void* c) {
  return vp && sa && ba && c && (size_t)n * sizeof(float) <= (size_t)kMaxRowSmem;
}

// rms_norm_q80 / rms_norm_q4k / rms_norm_q4k_fq by q: a Q4K kernel where
// q.vp or q.fq, with the row's E floats of dynamic shared memory
int norm(const void* x, const void* a, const void* w, void* h, void* hn, const Quant& q,
         int x_bf16, int B, int E, float eps, int T, int P, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int out = q.fq ? kOutQ4kFq : q.vp ? kOutQ4k : kOutQ80;
  const size_t smem = out != kOutQ80 ? (size_t)E * sizeof(float) : 0;
  const float* w_ = static_cast<const float*>(w);
  if (x_bf16) {
    using XT = __nv_bfloat16;
    return (int)launch_norm<XT>(out, P, B, T, smem, st, static_cast<const XT*>(x),
                                static_cast<const XT*>(a), w_, static_cast<XT*>(h),
                                static_cast<XT*>(hn), q, E, eps, vec);
  }
  return (int)launch_norm<float>(out, P, B, T, smem, st, static_cast<const float*>(x),
                                 static_cast<const float*>(a), w_, static_cast<float*>(h),
                                 static_cast<float*>(hn), q, E, eps, vec);
}

// swiglu_q80 / swiglu_q4k by q, as `norm`
int swiglu(const void* h13, void* y, const Quant& q, int x_bf16, int B, int F, int T, int P,
           int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool q4 = q.vp != nullptr;
  const size_t smem = q4 ? (size_t)F * sizeof(float) : 0;
  if (x_bf16) {
    using XT = __nv_bfloat16;
    return (int)launch_swiglu<XT>(q4, P, B, T, smem, st, static_cast<const XT*>(h13),
                                  static_cast<XT*>(y), q, F, vec);
  }
  return (int)launch_swiglu<float>(q4, P, B, T, smem, st, static_cast<const float*>(h13),
                                   static_cast<float*>(y), q, F, vec);
}

}  // namespace

// Every entry point launches on the caller's stream, never synchronises,
// and returns cudaGetLastError() (0 on success).  x_bf16 selects bf16
// activations (else f32); `vec` that every row of every activation
// pointer is aligned to 4 values (8 bytes of bf16, 16 of f32).

// The dynamic shared memory of the Q4K instances raised to a row of
// kMaxRowSmem / 4 values on the current device: once, before any launch (a
// CUDA-graph capture must not be the first to meet an instance).
extern "C" int norm_quant_init() {
  const cudaError_t e = allow_q4k_smem<float>();
  return (int)(e != cudaSuccess ? e : allow_q4k_smem<__nv_bfloat16>());
}

// x (B, E), a (B, E) or null, w (E) f32 -> h (B, E) or null (written only
// with a), hn (B, E) or null, and with gs > 0 xq (B, E) int8 and sa
// (B, E / gs) f32; T threads and P passes of ops/norm_quant.py:plan(E).
extern "C" int rms_norm_q80(const void* x, const void* a, const void* w, void* h, void* hn,
                            void* xq, void* sa, int x_bf16, int B, int E, float eps, int gs,
                            int T, int P, int vec, void* stream) {
  if (B < 1 || !shape_ok(E, gs, T, P) || (gs && (!xq || !sa)))
    return (int)cudaErrorInvalidValue;
  const Quant q{gs, gs ? static_cast<int8_t*>(xq) : nullptr,
                gs ? static_cast<float*>(sa) : nullptr, nullptr, nullptr, nullptr, nullptr};
  return norm(x, a, w, h, hn, q, x_bf16, B, E, eps, T, P, vec, stream);
}

// The same with hn's Q4K quantization: vp (B, n_pad / 2) u8 and sa, ba, c
// (B, n_pad / 32) f32, n_pad = E rounded up to 256 (E at most
// kMaxRowSmem / 4; norm_quant_init first).
extern "C" int rms_norm_q4k(const void* x, const void* a, const void* w, void* h, void* hn,
                            void* vp, void* sa, void* ba, void* c, int x_bf16, int B, int E,
                            float eps, int T, int P, int vec, void* stream) {
  if (B < 1 || !shape_ok(E, 0, T, P) || !q4k_ok(E, vp, sa, ba, c))
    return (int)cudaErrorInvalidValue;
  const Quant q{0, nullptr, static_cast<float*>(sa), static_cast<uint8_t*>(vp),
                static_cast<float*>(ba), static_cast<float*>(c), nullptr};
  return norm(x, a, w, h, hn, q, x_bf16, B, E, eps, T, P, vec, stream);
}

// The same with hn's Q4K fake-quant instead of its integer form: fq (B,
// n_pad) f32, the values rebuilt from hn's Q4K quantization, 0 at and past
// E, as q4k_fake_quant gives them (E at most kMaxRowSmem / 4;
// norm_quant_init first).
extern "C" int rms_norm_q4k_fq(const void* x, const void* a, const void* w, void* h, void* hn,
                               void* fq, int x_bf16, int B, int E, float eps, int T, int P,
                               int vec, void* stream) {
  if (B < 1 || !shape_ok(E, 0, T, P) || !fq || (size_t)E * sizeof(float) > (size_t)kMaxRowSmem)
    return (int)cudaErrorInvalidValue;
  const Quant q{0, nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<float*>(fq)};
  return norm(x, a, w, h, hn, q, x_bf16, B, E, eps, T, P, vec, stream);
}

// h13 (B, 2F) -> y (B, F) or null, and with gs > 0 xq (B, F) int8 and sa
// (B, F / gs) f32; T threads and P passes of ops/norm_quant.py:plan(F).
extern "C" int swiglu_q80(const void* h13, void* y, void* xq, void* sa, int x_bf16, int B, int F,
                          int gs, int T, int P, int vec, void* stream) {
  if (B < 1 || !shape_ok(F, gs, T, P) || (gs && (!xq || !sa))) return (int)cudaErrorInvalidValue;
  const Quant q{gs, gs ? static_cast<int8_t*>(xq) : nullptr,
                gs ? static_cast<float*>(sa) : nullptr, nullptr, nullptr, nullptr, nullptr};
  return swiglu(h13, y, q, x_bf16, B, F, T, P, vec, stream);
}

// The same with y's Q4K quantization: vp (B, n_pad / 2) u8 and sa, ba, c
// (B, n_pad / 32) f32, n_pad = F rounded up to 256 (F at most
// kMaxRowSmem / 4; norm_quant_init first).
extern "C" int swiglu_q4k(const void* h13, void* y, void* vp, void* sa, void* ba, void* c,
                          int x_bf16, int B, int F, int T, int P, int vec, void* stream) {
  if (B < 1 || !shape_ok(F, 0, T, P) || !q4k_ok(F, vp, sa, ba, c))
    return (int)cudaErrorInvalidValue;
  const Quant q{0, nullptr, static_cast<float*>(sa), static_cast<uint8_t*>(vp),
                static_cast<float*>(ba), static_cast<float*>(c), nullptr};
  return swiglu(h13, y, q, x_bf16, B, F, T, P, vec, stream);
}
