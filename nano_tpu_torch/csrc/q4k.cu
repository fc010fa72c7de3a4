// Q4K kernels for Hopper (sm_90a), bound to Python through ctypes
// (nano_tpu_torch/ops/q4k.py).  Weights stay in the loader's packed layout:
// uint8 (N, n_pad / 2) where byte g*16+j of a row holds value g*32+j in its
// low nibble and value g*32+16+j in its high nibble, with f32 group scales
// s and biases b (N, n_pad / 32); the weight is w = v * s - b.
//
//   q4k_fake_quant  replaces the XLA fusion nano_tpu/ops/q4k.py::fake_quant_act
//                   (_fake_quant_aligned_lean and the masked act_quant_q4k
//                   path), which ran before every Q4K matmul: the C engine's
//                   Q4K quantize->dequantize of the activation, bit for bit.
//   q4k_matmul      replaces the TPU kernel nano_tpu/ops/q4k.py::_q4k_kernel
//                   (launched by _q4k_matmul_2d): f32 dequant v * s - b and
//                   an f32 dot with the fake-quantized activation.
//   q4k_matvec_fq   the two at B = 1 (a decode step's Q4K matmuls) in one
//                   launch, equal to the pair bit for bit.
//
// Bit-exactness of q4k_fake_quant.  Every float operation is written as
// the IEEE operation the JAX package and PyTorch round separately:
// __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn are never contracted into
// FMAs (nvcc contracts a * b - c by default) and the divisions by 15 and 63
// stay IEEE divisions.  Rounding is the C engine's magic-number trick on
// the bits of x + 1.5 * 2^23 (never rintf / roundf).  Denormals are kept
// (no fast-math): the FLT_TRUE_MIN clamps stay what they are in PyTorch;
// an all-zero group ends with s = FLT_TRUE_MIN and values 0, a constant
// group with s = |c| / 15, as in the plain version.
//
// Bound on the H100: bytes.  At decode (B = 1) every weight byte is read
// once per step for one multiply-add per 4-bit value (0.75 B per value with
// the f32 scales and biases), far below the ~20 f32 operations per byte
// the card needs before compute limits it.  Design of q4k_matmul: a
// 32-group is one 16-byte load for one thread, with its s and b, so no
// nibble ever crosses lanes; a nibble becomes a float with one byte permute
// under the exponent of 2^23 and one subtraction (no int-to-float
// conversion, a quarter-rate instruction).  A decode step's matrices are
// 1.5-4.5 MB, so the kernel is as long as one memory latency plus the
// launch: what counts is having every load in flight at once.
//   B = 1:  each block takes 4 output rows and splits their groups over
//           its threads (one group per thread at in <= 8192), so each
//           thread has 4 independent 16-byte loads in flight and reads its
//           32 activation values once for the 4 rows; warp shuffles and a
//           shared-memory sum combine the partials.
//   B > 1:  one warp per output row reads the row once per tile of 8
//           activation rows; the activation (f32, n_pad per row, shared by
//           every warp) is read through L1/L2, so B = 64 prefill needs no
//           shared memory.
//   fused:  a block of 8 warps fake-quantizes the raw row (f32 or bf16)
//           into shared memory while the weight loads of up to 32 output
//           rows are in flight, then takes the B = 1 dot for them.  Each
//           block repeats the fake-quant (up to 3072 values, 13 IEEE
//           divisions a lane), which still adds ~2 us a launch.
// Not yet done: wgmma tiles for prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr float kFltMax = 3.402823466e+38f;

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// The C engine's nearest_int (infer/tensor.c:4-9), exact for every input.
__device__ __forceinline__ int nearest_int(float x) {
  return (__float_as_int(__fadd_rn(x, kMagic)) & 0x007FFFFF) - 0x00400000;
}

// Nibble k (the low 4 bits of byte k) of a word whose bytes are already
// masked to 4 bits, as an exact float: 0x4B0000vv is 2^23 + vv.
__device__ __forceinline__ float nibble(uint32_t masked, int k) {
  return __int_as_float(__byte_perm(masked, 0x4B000000u, 0x7440 | k)) - 8388608.f;
}

// The 32 dequantized weights w = v * s - b of one 16-byte group.
__device__ __forceinline__ void dequant_group(uint4 pv, float s, float nb, float* w) {
  const uint32_t words[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo = words[q] & 0x0F0F0F0Fu, hi = (words[q] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[4 * q + k] = fmaf(nibble(lo, k), s, nb);
      w[16 + 4 * q + k] = fmaf(nibble(hi, k), s, nb);
    }
  }
}

// The 32 activation values of the group starting at xr, 0 at positions
// >= valid (only positions < in_dim are read).
__device__ __forceinline__ void load_group(const float* __restrict__ xr, int valid, float* xv) {
  if (valid == 32) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(xr) + q);
      xv[4 * q] = t.x;
      xv[4 * q + 1] = t.y;
      xv[4 * q + 2] = t.z;
      xv[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) xv[e] = e < valid ? __ldg(xr + e) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The fake-quant of the 256-value block blk of one activation row x (n
// values), by one warp: lane l takes the 8 values from 8 l, so 4 lanes hold
// a 32-group.  Max and min over the group's valid values, s and bias, the
// 6-bit second level over the block's 8 groups, nearest_int, then
// v * s_eff - b_eff; a group's max and min over its 4 lanes and the block's
// s_max and b_max over the groups are xor-shuffles, exact in any order.
// o[e] is value 8 l + e of the block, 0 at or past n.
template <typename XT>
__device__ __forceinline__ void fq_block_by_warp(const XT* __restrict__ x, int blk, int n, int lane,
                                                 float (&o)[8]) {
  const float true_min = __int_as_float(1);  // FLT_TRUE_MIN, a denormal
  const int k0 = (blk << 8) + 8 * lane;
  float vmax = -kFltMax, vmin = kFltMax;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool valid = k0 + e < n;
    o[e] = valid ? load_f(x, k0 + e) : 0.f;
    vmax = valid ? fmaxf(vmax, o[e]) : vmax;
    vmin = valid ? fminf(vmin, o[e]) : vmin;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
    vmin = fminf(vmin, __shfl_xor_sync(0xffffffffu, vmin, off));
  }
  vmax = fmaxf(vmax, true_min);
  const bool neg = vmin <= 0.f;
  const float s = neg ? __fdiv_rn(__fsub_rn(vmax, vmin), 15.f) : __fdiv_rn(vmax, 15.f);
  const float bias = neg ? -vmin : 0.f;
  float s_max = s, b_max = bias;
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    s_max = fmaxf(s_max, __shfl_xor_sync(0xffffffffu, s_max, off));
    b_max = fmaxf(b_max, __shfl_xor_sync(0xffffffffu, b_max, off));
  }
  const float s_scale = __fdiv_rn(fmaxf(s_max, true_min), 63.f);
  const float s_bias = __fdiv_rn(fmaxf(b_max, true_min), 63.f);
  const int sq = s_scale == 0.f ? 0 : nearest_int(__fdiv_rn(s, s_scale)) & 0x3F;
  const int bq = s_bias == 0.f ? 0 : nearest_int(__fdiv_rn(bias, s_bias)) & 0x3F;
  const float s_eff = __fmul_rn((float)sq, s_scale);
  const float b_eff = __fmul_rn((float)bq, s_bias);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int v = s == 0.f ? 0 : nearest_int(__fdiv_rn(__fadd_rn(o[e], bias), s)) & 0x0F;
    o[e] = k0 + e < n ? __fsub_rn(__fmul_rn((float)v, s_eff), b_eff) : 0.f;
  }
}

// One warp per (row b, 256-value block): x (B, n) f32 or bf16 -> out
// (B, n_pad) f32, 0 at k >= n.
template <typename XT>
__global__ void fake_quant_kernel(const XT* __restrict__ x, float* __restrict__ out, int B,
                                  int n, int n_pad) {
  const int nbpl = n_pad >> 8;
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= B * nbpl) return;
  const int b = wid / nbpl, blk = wid - b * nbpl;
  float o[8];
  fq_block_by_warp(x + (size_t)b * n, blk, n, lane, o);
  float4* dst = reinterpret_cast<float4*>(out + (size_t)b * n_pad + (blk << 8) + 8 * lane);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// B = 1: block b takes output rows [R*b, R*b + R); its threads split the
// rows' 32-groups (g = threadIdx.x, g += blockDim.x).
template <int R, typename OT>
__global__ void q4k_matvec_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                                  const float* __restrict__ sc, const float* __restrict__ bi,
                                  OT* __restrict__ y, int n_pad, int in_dim, int N) {
  __shared__ float part[8][R];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * R;
  const int G = n_pad >> 5;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int g = threadIdx.x; g < G && g * 32 < in_dim; g += blockDim.x) {
    uint4 pv[R];
    float s[R], nb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {  // rows past N repeat row N-1, never stored
      const size_t row = min(row0 + r, N - 1);
      pv[r] = __ldg(reinterpret_cast<const uint4*>(packed + row * (n_pad >> 1)) + g);
      s[r] = __ldg(sc + row * G + g);
      nb[r] = -__ldg(bi + row * G + g);
    }
    float xv[32], w[32];
    load_group(x + g * 32, min(32, in_dim - g * 32), xv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dequant_group(pv[r], s[r], nb[r], w);
      float a = acc[r];
#pragma unroll
      for (int e = 0; e < 32; ++e) a = fmaf(xv[e], w[e], a);
      acc[r] = a;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) part[warp][r] = v;
  }
  __syncthreads();
  if (threadIdx.x < R && row0 + threadIdx.x < N) {
    float v = 0.f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) v += part[i][threadIdx.x];
    store_f(y, row0 + threadIdx.x, v);
  }
}

// B > 1: one warp per output row n, BT activation rows per block row of the
// grid.  Lane l takes 32-groups l, l + 32, ...
template <int BT, typename OT>
__global__ void q4k_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                                  const float* __restrict__ sc, const float* __restrict__ bi,
                                  OT* __restrict__ y, int B, int n_pad, int in_dim, int N) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int b0 = blockIdx.y * BT;
  const int G = n_pad >> 5;
  const uint4* prow = reinterpret_cast<const uint4*>(packed + (size_t)n * (n_pad >> 1));
  const float* srow = sc + (size_t)n * G;
  const float* brow = bi + (size_t)n * G;
  float acc[BT];
#pragma unroll
  for (int j = 0; j < BT; ++j) acc[j] = 0.f;
  for (int g = lane; g < G && g * 32 < in_dim; g += 32) {
    float w[32];
    dequant_group(__ldg(prow + g), __ldg(srow + g), -__ldg(brow + g), w);
    const int valid = min(32, in_dim - g * 32);
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (b0 + j < B) {
        float xv[32];
        load_group(x + (size_t)(b0 + j) * n_pad + g * 32, valid, xv);
        float a = acc[j];
#pragma unroll
        for (int e = 0; e < 32; ++e) a = fmaf(xv[e], w[e], a);
        acc[j] = a;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    const float v = warp_sum(acc[j]);
    if (lane == 0 && b0 + j < B) store_f(y, (size_t)(b0 + j) * N + n, v);
  }
}

constexpr int kFqThreads = 256;   // threads of a q4k_matvec_fq block

// q4k_matvec_kernel on the raw activation x (1, in_dim), for 256 / T sets
// of R output rows at once, T = `dot_threads` = q4k_matvec_kernel's block.
// The T threads of set j issue their weight loads first; then the block's
// 8 warps fake-quantize the row into shared memory, a 256-value block per
// warp (32-groups padded to 33 floats, so that a thread reading its own
// group hits no other's banks); then each set takes the dot of its rows
// exactly as q4k_matvec_kernel does: the same groups on the same threads,
// the same products in the same order, the same sums (a named barrier per
// set).  So the result equals q4k_fake_quant + q4k_matmul bit for bit, and
// the fake-quant, repeated by every block, runs once per 256 / T * R rows,
// on 8 warps, under the loads' latency.
template <int R, typename XT, typename OT>
__global__ void __launch_bounds__(kFqThreads)
    q4k_matvec_fq_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
                         const float* __restrict__ sc, const float* __restrict__ bi,
                         OT* __restrict__ y, int n_pad, int in_dim, int N, int dot_threads) {
  __shared__ float part[kFqThreads / 32][R];
  extern __shared__ float sx[];   // [n_pad / 32][33]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_sets = kFqThreads / dot_threads, set = threadIdx.x / dot_threads;
  const int t = threadIdx.x - set * dot_threads;   // q4k_matvec_kernel's threadIdx.x
  const int row0 = (blockIdx.x * n_sets + set) * R;
  const int G = n_pad >> 5;
  uint4 pv[R];
  float s[R], nb[R];
  auto load_w = [&](int g) {
#pragma unroll
    for (int r = 0; r < R; ++r) {  // rows past N repeat row N-1, never stored
      const size_t row = min(row0 + r, N - 1);
      pv[r] = __ldg(reinterpret_cast<const uint4*>(packed + row * (n_pad >> 1)) + g);
      s[r] = __ldg(sc + row * G + g);
      nb[r] = -__ldg(bi + row * G + g);
    }
  };
  const bool dotter = set < n_sets && row0 < N;
  if (dotter && t * 32 < in_dim) load_w(t);
  for (int blk = warp; (blk << 8) < in_dim; blk += kFqThreads / 32) {
    float o[8];
    fq_block_by_warp(x, blk, in_dim, lane, o);
    float* dst = sx + (8 * blk + (lane >> 2)) * 33 + 8 * (lane & 3);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = o[e];
  }
  __syncthreads();
  if (!dotter) return;   // a whole set: its threads share row0
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int g = t; g < G && g * 32 < in_dim; g += dot_threads) {
    if (g != t) load_w(g);
    float xv[32], w[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) xv[e] = sx[g * 33 + e];   // 0 at or past in_dim
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dequant_group(pv[r], s[r], nb[r], w);
      float a = acc[r];
#pragma unroll
      for (int e = 0; e < 32; ++e) a = fmaf(xv[e], w[e], a);
      acc[r] = a;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) part[warp][r] = v;
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + set), "r"(dot_threads) : "memory");
  if (t < R && row0 + t < N) {
    const int w0 = set * dot_threads / 32;
    float v = 0.f;
    for (int i = 0; i < dot_threads >> 5; ++i) v += part[w0 + i][t];
    store_f(y, row0 + t, v);
  }
}

constexpr int kWarps = 8;  // warps per block

constexpr int kRows = 4;   // output rows per block at B = 1

// threads of a B = 1 block: one 32-group each, up to kWarps warps
int matvec_threads(int n_pad, int in_dim) {
  const int groups = (min(n_pad, in_dim) + 31) / 32;
  return min(kWarps, (groups + 31) / 32) * 32;
}

template <typename OT>
void launch_matmul(const float* x, const uint8_t* p, const float* s, const float* b, OT* y, int B,
                   int n_pad, int in_dim, int N, cudaStream_t st) {
  if (B == 1) {
    q4k_matvec_kernel<kRows, OT><<<(N + kRows - 1) / kRows, matvec_threads(n_pad, in_dim), 0, st>>>(
        x, p, s, b, y, n_pad, in_dim, N);
  } else {
    const unsigned gx = (N + kWarps - 1) / kWarps;
    q4k_matmul_kernel<8, OT><<<dim3(gx, (B + 7) / 8), kWarps * 32, 0, st>>>(x, p, s, b, y, B,
                                                                            n_pad, in_dim, N);
  }
}

}  // namespace

// Every entry point launches on the caller's stream, never synchronises,
// and returns cudaGetLastError() (0 on success).

extern "C" int q4k_fake_quant(const void* x, int x_bf16, void* out, int B, int n, int n_pad,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = B * (n_pad >> 8);
  const unsigned blocks = (warps + kWarps - 1) / kWarps;
  if (x_bf16) {
    fake_quant_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), B, n, n_pad);
  } else {
    fake_quant_kernel<float><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), B, n, n_pad);
  }
  return (int)cudaGetLastError();
}

extern "C" int q4k_matmul(const void* x, const void* packed, const void* scales,
                          const void* biases, void* y, int y_bf16, int B, int n_pad, int in_dim,
                          int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x_ = static_cast<const float*>(x);
  const uint8_t* p_ = static_cast<const uint8_t*>(packed);
  const float* s_ = static_cast<const float*>(scales);
  const float* b_ = static_cast<const float*>(biases);
  if (y_bf16) {
    launch_matmul(x_, p_, s_, b_, static_cast<__nv_bfloat16*>(y), B, n_pad, in_dim, N, st);
  } else {
    launch_matmul(x_, p_, s_, b_, static_cast<float*>(y), B, n_pad, in_dim, N, st);
  }
  return (int)cudaGetLastError();
}

// x (1, in_dim) f32 or bf16, raw -> y (1, N): q4k_fake_quant + q4k_matmul at
// B = 1 in one launch, each row's dot on the threads of q4k_matmul's B = 1
// kernel.
extern "C" int q4k_matvec_fq(const void* x, int x_bf16, const void* packed, const void* scales,
                             const void* biases, void* y, int y_bf16, int n_pad, int in_dim, int N,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* p_ = static_cast<const uint8_t*>(packed);
  const float* s_ = static_cast<const float*>(scales);
  const float* b_ = static_cast<const float*>(biases);
  const int dot_threads = matvec_threads(n_pad, in_dim);
  const size_t smem = sizeof(float) * (n_pad / 32) * 33;
  const int rows = kFqThreads / dot_threads * kRows;   // output rows a block
  const dim3 grid((N + rows - 1) / rows);
#define NANO_FQ(XT, OT)                                                                        \
  do {                                                                                         \
    if (smem > 48 * 1024) {                                                                    \
      const cudaError_t err = cudaFuncSetAttribute(q4k_matvec_fq_kernel<kRows, XT, OT>,        \
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                                   (int)smem);                                 \
      if (err != cudaSuccess) return (int)err;                                                 \
    }                                                                                          \
    q4k_matvec_fq_kernel<kRows, XT, OT><<<grid, kFqThreads, smem, st>>>(                       \
        static_cast<const XT*>(x), p_, s_, b_, static_cast<OT*>(y), n_pad, in_dim, N,          \
        dot_threads);                                                                          \
  } while (0)
  if (x_bf16 && y_bf16) NANO_FQ(__nv_bfloat16, __nv_bfloat16);
  else if (x_bf16) NANO_FQ(__nv_bfloat16, float);
  else if (y_bf16) NANO_FQ(float, __nv_bfloat16);
  else NANO_FQ(float, float);
#undef NANO_FQ
  return (int)cudaGetLastError();
}
