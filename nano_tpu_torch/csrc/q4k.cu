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
//   q4k_act_quant   the same quantization decisions at B > 1 (a batched
//                   step, a prefill), kept as integers: the values packed
//                   in the weights' layout, s_eff, b_eff and c per group.
//   q4k_matmul_w4a4 _q4k_kernel's product at B > 1 as the C engine expands
//                   it (infer/tensor.c:359-434; nano_tpu/ops/q4k.py::
//                   q4k_matmul_int8): y = sum_g sa s P - c m - ba s Q with
//                   P the exact int dot of the 4-bit values of a group on
//                   the int8 tensor cores: every Q4K product of more than
//                   one row (q4k_matmul is then on no main path).
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
//   w4a4:   at B slots the f32 dot is 2 B multiply-adds a weight value, too
//           many for the CUDA cores at 64 slots (56 GFLOP for a prefill's
//           112 products), and bf16 or TF32 tensor cores would round the
//           fake-quantized activation.  The int8 tensor cores compute the
//           function exactly: a group (K = 32) is one mma.sync m16n8k32
//           whose operands are the packed words as they lie (a 4-byte word
//           of a group's 16 bytes is a fragment register once its nibbles
//           are split by two AND and a shift: no ldmatrix, no permutation,
//           no unpack to memory).  What is left on the CUDA cores is the
//           f32 combine, 5 instructions per (slot, row, group), which at 64
//           slots, not the bytes, bounds the kernel.  The rest is K1's
//           design, shared with q80_matmul.cu through int8_mma.cuh: weight
//           rows on M, slots on N, a cp.async ring, chunks of K split over
//           a cluster for the N = 1024 products, the plan from the shapes
//           (ops/int8_mma.py), no atomics.
// Not yet done: wgmma tiles.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma8;

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

// The Q4K quantization of the 256-value block blk of one activation row x
// (n values), by one warp: lane l takes the 8 values from 8 l, so 4 lanes
// hold a 32-group.  Max and min over the group's valid values, s and bias,
// the 6-bit second level over the block's 8 groups, nearest_int; a group's
// max and min over its 4 lanes and the block's s_max and b_max over the
// groups are xor-shuffles, exact in any order.  v[e] is value 8 l + e of
// the block in [0, 15] (0 at or past n, and where the group's s is 0);
// s_eff and b_eff are the lane's group's, the dequantized value v * s_eff
// - b_eff.
template <typename XT>
__device__ __forceinline__ void quant_block_by_warp(const XT* __restrict__ x, int blk, int n,
                                                    int lane, int (&v)[8], float& s_eff,
                                                    float& b_eff) {
  const float true_min = __int_as_float(1);  // FLT_TRUE_MIN, a denormal
  const int k0 = (blk << 8) + 8 * lane;
  float xv[8];
  float vmax = -kFltMax, vmin = kFltMax;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool valid = k0 + e < n;
    xv[e] = valid ? load_f(x, k0 + e) : 0.f;
    vmax = valid ? fmaxf(vmax, xv[e]) : vmax;
    vmin = valid ? fminf(vmin, xv[e]) : vmin;
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
  s_eff = __fmul_rn((float)sq, s_scale);
  b_eff = __fmul_rn((float)bq, s_bias);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = (k0 + e < n && s != 0.f) ? nearest_int(__fdiv_rn(__fadd_rn(xv[e], bias), s)) & 0x0F : 0;
}

// The fake-quant of the same block: o[e] = v * s_eff - b_eff for value
// 8 l + e, 0 at or past n.
template <typename XT>
__device__ __forceinline__ void fq_block_by_warp(const XT* __restrict__ x, int blk, int n, int lane,
                                                 float (&o)[8]) {
  int v[8];
  float s_eff, b_eff;
  quant_block_by_warp(x, blk, n, lane, v, s_eff, b_eff);
  const int k0 = (blk << 8) + 8 * lane;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    o[e] = k0 + e < n ? __fsub_rn(__fmul_rn((float)v[e], s_eff), b_eff) : 0.f;
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

// One warp per (row b, 256-value block): x (B, n) f32 or bf16 -> the
// block's values packed in the weights' layout into vp (B, n_pad / 2)
// (byte g*16+j: value g*32+j low, g*32+16+j high), and for each of its 8
// groups sa = s_eff, ba = b_eff and c = sa * A - n_g * ba (B, n_pad / 32),
// A the group's value sum and n_g its positions < n, each product and the
// difference rounded to f32.  Lanes 4 i and 4 i + 1 write group i's 16
// bytes, the high nibbles from lanes 4 i + 2 and 4 i + 3.
template <typename XT>
__global__ void q4k_act_quant_kernel(const XT* __restrict__ x, uint8_t* __restrict__ vp,
                                     float* __restrict__ sa, float* __restrict__ ba,
                                     float* __restrict__ c, int B, int n, int n_pad) {
  const int nbpl = n_pad >> 8;
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= B * nbpl) return;   // a whole warp
  const int b = wid / nbpl, blk = wid - b * nbpl;
  int v[8];
  float s_eff, b_eff;
  quant_block_by_warp(x + (size_t)b * n, blk, n, lane, v, s_eff, b_eff);
  uint32_t mine = 0;
  int sum = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mine |= (uint32_t)v[e] << (4 * e);
    sum += v[e];
  }
  const uint32_t high = __shfl_down_sync(0xffffffffu, mine, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  const int quarter = lane & 3, g = (blk << 3) + (lane >> 2);
  if (quarter < 2) {
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      word[e >> 2] |= (((mine >> (4 * e)) & 0xFu) | (((high >> (4 * e)) & 0xFu) << 4))
                      << (8 * (e & 3));
    *reinterpret_cast<uint2*>(vp + (size_t)b * (n_pad >> 1) + g * 16 + 8 * quarter) =
        make_uint2(word[0], word[1]);
  }
  if (quarter == 0) {
    const size_t i = (size_t)b * (n_pad >> 5) + g;
    const int n_g = min(32, max(0, n - 32 * g));
    sa[i] = s_eff;
    ba[i] = b_eff;
    c[i] = __fsub_rn(__fmul_rn(s_eff, (float)sum), __fmul_rn((float)n_g, b_eff));
  }
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

// ---- q4k_matmul_w4a4 ----

constexpr int kW4MaxWarps = 8;     // a block: 4 or 8 warps of 16 weight rows
// A stage's rows lie 144 bytes apart in shared memory (a packed row's 128
// and a pad), their 8 scales (or biases) 12 floats apart: 36 and 12 words,
// so that the 8 rows a fragment load reads at one group fall in 8
// different groups of 4 banks (their scales in 8 different banks), and
// every offset in the unrolled loop is a constant.
constexpr int kW4Row = 144;
constexpr int kW4SRow = 12;

// Bytes of one stage (256 values of K, 8 groups) of a block of MB weight
// rows and BN slots: the packed weight tile, its s and m, the packed slot
// tile, its sa, ba and c (128 bytes a slot).
__host__ __device__ __forceinline__ size_t w4_stage(int MB, int BN) {
  return (size_t)(kW4Row + 8 * kW4SRow) * MB + (size_t)(kW4Row + 128) * BN;
}

__host__ __device__ __forceinline__ size_t w4_smem(int MB, int BN, int CS, int S) {
  return ring_smem(w4_stage(MB, BN), MB, BN, CS, S);
}

// The bytes of a word whose positions p .. p + 3 (p = 4 tig or 16 + 4 tig)
// lie below `valid` (lim = valid - p).
__device__ __forceinline__ uint32_t byte_mask(int lim) {
  return lim >= 4 ? 0xFFFFFFFFu : lim <= 0 ? 0u : (1u << (8 * lim)) - 1u;
}

// An int below 2^23 as an exact float: 0x4B000000 + q is 2^23 + q.
__device__ __forceinline__ float exact_float(int q) {
  return __int_as_float(0x4B000000 + q) - 8388608.f;
}

// y (B, N) = sum_g sa s P - c m - ba s Q over the groups below in_dim, P
// the exact int dots of the 4-bit values (one mma.sync m16n8k32 a group),
// Q the weight row's value sum.  MB weight rows a block on M (16 a warp),
// BN slots on N; the packed layouts are the fragments' own: lane (gid,
// tig) reads the word at byte 4 tig of its row's group, whose low nibbles
// are values 4 tig .. 4 tig + 3 (a0 / b0) and high nibbles 16 + 4 tig ..
// (a2 / b1).  A block (blockIdx.x / CS, rank blockIdx.x % CS of its
// cluster, blockIdx.y) takes rows n0 .., slots b0 .. and the 256-value
// chunks [nck rank / CS, nck (rank + 1) / CS), walking them round a ring
// of S stages filled by cp.async (rows and slots past the end read as
// zeros).  Each mma starts its int32 fragment at 0x4B000000, so that its
// result reads as the float 2^23 + P and one subtraction gives P.  The CS
// blocks of a cluster then add their partial tiles through distributed
// shared memory in rank order (int8_mma.cuh, as q80_matmul_w8a8 does): no
// atomics.
template <int BN, typename OT>
__global__ void __launch_bounds__(kW4MaxWarps * 32)
    w4a4_kernel(const uint8_t* __restrict__ vp, const float* __restrict__ sa,
                const float* __restrict__ ba, const float* __restrict__ cq,
                const uint8_t* __restrict__ packed, const float* __restrict__ sc,
                const float* __restrict__ bi, OT* __restrict__ y, int B, int n_pad, int in_dim,
                int N, int CS, int S) {
  constexpr int NF = BN / 8;   // 8-slot fragments a warp
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = n_pad >> 5, nck = n_pad >> 8, rowb = n_pad >> 1;
  const int nt = blockDim.x, MB = nt / 2;
  const int rank = blockIdx.x % CS;
  const int n0 = (blockIdx.x / CS) * MB, b0 = blockIdx.y * BN;
  const int c_lo = nck * rank / CS;
  const int nch = nck * (rank + 1) / CS - c_lo;
  const size_t stage = w4_stage(MB, BN);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // chunk c_lo + t into stage t % S: the weight rows' 128 bytes, their s
  // and m, the slots' 128 bytes, their sa, ba, c (one float at a time,
  // into [group][slot pair][sa0 sa1 ba0 ba1 c0 c1 - -])
  auto load = [&](int t) {
    unsigned char* wt = smem + (size_t)(t % S) * stage;
    float* ws = reinterpret_cast<float*>(wt + MB * kW4Row);
    unsigned char* at = wt + MB * (kW4Row + 8 * kW4SRow);
    float* ap = reinterpret_cast<float*>(at + BN * kW4Row);
    const int kc = c_lo + t, g0 = kc * 8;
    const size_t koff = (size_t)kc * 128;
    for (int i = tid; i < MB * 8; i += nt) {
      const int r = i >> 3, g = i & 7, n = n0 + r;
      cp_async16(wt + r * kW4Row + g * 16,
                 n < N ? packed + (size_t)n * rowb + koff + g * 16 : packed, n < N ? 16 : 0);
    }
    for (int i = tid; i < MB * 4; i += nt) {
      const int r = i >> 2, h = i & 1, m = (i >> 1) & 1, n = n0 + r;
      const float* src = m ? bi : sc;
      cp_async16(ws + (m * MB + r) * kW4SRow + 4 * h,
                 n < N ? src + (size_t)n * G + g0 + 4 * h : src, n < N ? 16 : 0);
    }
    for (int i = tid; i < BN * 8; i += nt) {
      const int r = i >> 3, g = i & 7, b = b0 + r;
      cp_async16(at + r * kW4Row + g * 16, b < B ? vp + (size_t)b * rowb + koff + g * 16 : vp,
                 b < B ? 16 : 0);
    }
    for (int i = tid; i < BN * 24; i += nt) {
      const int k = i / (BN * 8), rem = i - k * BN * 8, r = rem >> 3, g = rem & 7, b = b0 + r;
      const float* src = k == 0 ? sa : k == 1 ? ba : cq;
      cp_async4(ap + (g * (BN / 2) + (r >> 1)) * 8 + 2 * k + (r & 1),
                b < B ? src + (size_t)b * G + g0 + g : src, b < B ? 4 : 0);
    }
  };

  // every stage's chunk in flight before the first is consumed; one commit
  // group a chunk (empty past the end), so that "chunk t is in" is "at most
  // S - 1 groups pending" at every t
  for (int t = 0; t < S; ++t) {
    if (t < nch) load(t);
    cp_async_commit();
  }
  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + gid;   // this lane's rows r0 and r0 + 8
  for (int t = 0; t < nch; ++t) {
    cp_async_wait(S - 1);
    __syncthreads();   // every thread's copies of chunk t are in
    const unsigned char* wt = smem + (size_t)(t % S) * stage;
    const float* ws = reinterpret_cast<const float*>(wt + MB * kW4Row);
    const unsigned char* at = wt + MB * (kW4Row + 8 * kW4SRow);
    const float* ap = reinterpret_cast<const float*>(at + BN * kW4Row);
    const int g0 = (c_lo + t) * 8;
    const int ng = min(8, (in_dim - 32 * g0 + 31) >> 5);   // groups below in_dim
#pragma unroll
    for (int gg = 0; gg < 8; ++gg) {
      if (gg >= ng) continue;   // the same on every thread
      const int valid = in_dim - 32 * (g0 + gg);
      const unsigned char* wg = wt + r0 * kW4Row + gg * 16 + 4 * tig;
      const uint32_t wlo = *reinterpret_cast<const uint32_t*>(wg);
      const uint32_t whi = *reinterpret_cast<const uint32_t*>(wg + 8 * kW4Row);
      uint32_t a[4] = {wlo & 0x0F0F0F0Fu, whi & 0x0F0F0F0Fu, (wlo >> 4) & 0x0F0F0F0Fu,
                       (whi >> 4) & 0x0F0F0F0Fu};
      if (valid < 32) {   // the ragged group: the weight's positions >= in_dim
        const uint32_t ml = byte_mask(valid - 4 * tig), mh = byte_mask(valid - 16 - 4 * tig);
        a[0] &= ml;
        a[1] &= ml;
        a[2] &= mh;
        a[3] &= mh;
      }
      // the rows' s, m and s * Q (Q over the 4 lanes of the row: exact)
      const float* sg = ws + r0 * kW4SRow + gg;
      const float s0 = sg[0], s1 = sg[8 * kW4SRow];
      const float m0 = sg[MB * kW4SRow], m1 = sg[(MB + 8) * kW4SRow];
      int q0 = __dp4a((int)a[0], 0x01010101, __dp4a((int)a[2], 0x01010101, 0));
      int q1 = __dp4a((int)a[1], 0x01010101, __dp4a((int)a[3], 0x01010101, 0));
      q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
      q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
      const float sq0 = s0 * exact_float(q0), sq1 = s1 * exact_float(q1);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const uint32_t bw =
            *reinterpret_cast<const uint32_t*>(at + (8 * j + gid) * kW4Row + gg * 16 + 4 * tig);
        int d[4] = {0x4B000000, 0x4B000000, 0x4B000000, 0x4B000000};
        mma_s8(d, a, bw & 0x0F0F0F0Fu, (bw >> 4) & 0x0F0F0F0Fu);
        const float* pp = ap + (gg * (BN / 2) + 4 * j + tig) * 8;
        const float4 p4 = *reinterpret_cast<const float4*>(pp);
        const float2 c2 = *reinterpret_cast<const float2*>(pp + 4);
        const float sas[2] = {p4.x, p4.y}, bas[2] = {p4.z, p4.w}, cs[2] = {c2.x, c2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // (row r0 + 8 (e >> 1), slot 8 j + 2 tig + (e & 1))
          const int q = e & 1;
          const float s = e < 2 ? s0 : s1, m = e < 2 ? m0 : m1, sq = e < 2 ? sq0 : sq1;
          float v = acc[j][e];
          v = fmaf(sas[q] * s, __int_as_float(d[e]) - 8388608.f, v);
          v = fmaf(-cs[q], m, v);
          v = fmaf(-bas[q], sq, v);
          acc[j][e] = v;
        }
      }
    }
    __syncthreads();   // stage t % S is free
    if (t + S < nch) load(t + S);
    cp_async_commit();
  }
  cp_async_wait(0);

  // the cluster's partial tiles summed in rank order (int8_mma.cuh)
  float* box = reinterpret_cast<float*>(smem + box_offset(stage, CS, S));
  leave_partials(acc, box, MB, BN, CS, rank, warp, lane);
  cluster.sync();
  sum_partials(box, MB, BN, CS, rank, [&](int r, int b, float v) {
    if (b0 + b < B && n0 + r < N) store_f(y, (size_t)(b0 + b) * N + n0 + r, v);
  });
}

template <typename OT>
cudaError_t launch_w4a4(int BN, const uint8_t* vp, const float* sa, const float* ba,
                        const float* cq, const uint8_t* p, const float* s, const float* b, OT* y,
                        int B, int n_pad, int in_dim, int N, int MB, int CS, int S,
                        cudaStream_t st) {
  const size_t smem = w4_smem(MB, BN, CS, S);
#define NANO_W4A4(BN_)                                                                       \
  launch_tiles(w4a4_kernel<BN_, OT>, B, N, MB, BN_, CS, smem, st, vp, sa, ba, cq, p, s, b, y, \
               B, n_pad, in_dim, N, CS, S)
  switch (BN) {
    case 8: return NANO_W4A4(8);
    case 16: return NANO_W4A4(16);
    case 32: return NANO_W4A4(32);
    default: return NANO_W4A4(64);
  }
#undef NANO_W4A4
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

// x (B, n) f32 or bf16 -> vp (B, n_pad / 2) u8, sa, ba, c (B, n_pad / 32)
// f32: the activation's Q4K quantization in integer form for
// q4k_matmul_w4a4, the integer decisions of q4k_fake_quant.
extern "C" int q4k_act_quant(const void* x, int x_bf16, void* vp, void* sa, void* ba, void* c,
                             int B, int n, int n_pad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = B * (n_pad >> 8);
  const unsigned blocks = (warps + kWarps - 1) / kWarps;
  uint8_t* vp_ = static_cast<uint8_t*>(vp);
  float* sa_ = static_cast<float*>(sa);
  float* ba_ = static_cast<float*>(ba);
  float* c_ = static_cast<float*>(c);
  if (x_bf16) {
    q4k_act_quant_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), vp_, sa_, ba_, c_, B, n, n_pad);
  } else {
    q4k_act_quant_kernel<float><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), vp_, sa_, ba_, c_, B, n, n_pad);
  }
  return (int)cudaGetLastError();
}

// Shared memory over 48 KB for every q4k_matmul_w4a4 instance on the
// current device: once, before any launch (a CUDA-graph capture must not be
// the first to meet an instance).
extern "C" int q4k_matmul_w4a4_init() {
  return (int)allow_smem(w4a4_kernel<8, float>, w4a4_kernel<16, float>, w4a4_kernel<32, float>,
                         w4a4_kernel<64, float>, w4a4_kernel<8, __nv_bfloat16>,
                         w4a4_kernel<16, __nv_bfloat16>, w4a4_kernel<32, __nv_bfloat16>,
                         w4a4_kernel<64, __nv_bfloat16>);
}

// vp, sa, ba, c from q4k_act_quant (B slots), the packed weight (N,
// n_pad / 2) with its scales and biases (N, n_pad / 32) -> y (B, N) f32 or
// bf16, with the weight rows a block (MB, 64 or 128), the slot tile (BN),
// the blocks a cluster splitting the chunks of K (CS) and the stages (S) of
// ops/q4k.py:w4a4_plan.  Every pointer 16-byte aligned.
extern "C" int q4k_matmul_w4a4(const void* vp, const void* sa, const void* ba, const void* c,
                               const void* packed, const void* scales, const void* biases,
                               void* y, int y_bf16, int B, int n_pad, int in_dim, int N, int MB,
                               int BN, int CS, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nck = n_pad / 256;
  if (B < 1 || N < 1 || n_pad < 256 || n_pad % 256 || in_dim < 1 || in_dim > n_pad ||
      !split_ok(MB, BN, CS, nck, S, w4_smem(MB, BN, CS, S)))
    return (int)cudaErrorInvalidValue;
  const uint8_t* vp_ = static_cast<const uint8_t*>(vp);
  const float* sa_ = static_cast<const float*>(sa);
  const float* ba_ = static_cast<const float*>(ba);
  const float* c_ = static_cast<const float*>(c);
  const uint8_t* p_ = static_cast<const uint8_t*>(packed);
  const float* s_ = static_cast<const float*>(scales);
  const float* b_ = static_cast<const float*>(biases);
  if (y_bf16)
    return (int)launch_w4a4(BN, vp_, sa_, ba_, c_, p_, s_, b_, static_cast<__nv_bfloat16*>(y), B,
                            n_pad, in_dim, N, MB, CS, S, st);
  return (int)launch_w4a4(BN, vp_, sa_, ba_, c_, p_, s_, b_, static_cast<float*>(y), B, n_pad,
                          in_dim, N, MB, CS, S, st);
}
