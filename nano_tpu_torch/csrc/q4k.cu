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
// Not yet done: the fake-quant fused into the matmul's prologue, wgmma
// tiles for prefill.

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

// One warp per (row b, 256-value block).  Lane l holds value g*32+l of each
// of the 8 groups, so a group's max and min are one xor-shuffle tree (exact
// in any order).  x (B, n) f32 or bf16 -> out (B, n_pad) f32, 0 at k >= n.
template <typename XT>
__global__ void fake_quant_kernel(const XT* __restrict__ x, float* __restrict__ out, int B,
                                  int n, int n_pad) {
  const int nbpl = n_pad >> 8;
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= B * nbpl) return;
  const int b = wid / nbpl, blk = wid - b * nbpl;
  const float true_min = __int_as_float(1);  // FLT_TRUE_MIN, a denormal
  float val[8], gmax[8], gmin[8];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int k = (blk << 8) + g * 32 + lane;
    const bool valid = k < n;
    val[g] = valid ? load_f(x, (size_t)b * n + k) : 0.f;
    gmax[g] = valid ? val[g] : -kFltMax;
    gmin[g] = valid ? val[g] : kFltMax;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      gmax[g] = fmaxf(gmax[g], __shfl_xor_sync(0xffffffffu, gmax[g], off));
      gmin[g] = fminf(gmin[g], __shfl_xor_sync(0xffffffffu, gmin[g], off));
    }
  }
  // group parameters (every lane holds all 8), then the 6-bit second level
  float s[8], bias[8];
  float s_max = 0.f, b_max = 0.f;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float vmax = fmaxf(gmax[g], true_min);
    const float vmin = gmin[g];
    const bool neg = vmin <= 0.f;
    s[g] = neg ? __fdiv_rn(__fsub_rn(vmax, vmin), 15.f) : __fdiv_rn(vmax, 15.f);
    bias[g] = neg ? -vmin : 0.f;
    s_max = g ? fmaxf(s_max, s[g]) : s[g];
    b_max = g ? fmaxf(b_max, bias[g]) : bias[g];
  }
  const float s_scale = __fdiv_rn(fmaxf(s_max, true_min), 63.f);
  const float s_bias = __fdiv_rn(fmaxf(b_max, true_min), 63.f);
  const size_t row = (size_t)b * n_pad + (blk << 8);
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int k = (blk << 8) + g * 32 + lane;
    if (k >= n) {
      out[row + g * 32 + lane] = 0.f;
      continue;
    }
    const int sq = s_scale == 0.f ? 0 : nearest_int(__fdiv_rn(s[g], s_scale)) & 0x3F;
    const int bq = s_bias == 0.f ? 0 : nearest_int(__fdiv_rn(bias[g], s_bias)) & 0x3F;
    const float s_eff = __fmul_rn((float)sq, s_scale);
    const float b_eff = __fmul_rn((float)bq, s_bias);
    const int v = s[g] == 0.f ? 0 : nearest_int(__fdiv_rn(__fadd_rn(val[g], bias[g]), s[g])) & 0x0F;
    out[row + g * 32 + lane] = __fsub_rn(__fmul_rn((float)v, s_eff), b_eff);
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

constexpr int kWarps = 8;  // warps per block

constexpr int kRows = 4;   // output rows per block at B = 1

template <typename OT>
void launch_matmul(const float* x, const uint8_t* p, const float* s, const float* b, OT* y, int B,
                   int n_pad, int in_dim, int N, cudaStream_t st) {
  if (B == 1) {
    const int groups = (min(n_pad, in_dim) + 31) / 32;
    const int warps = min(kWarps, (groups + 31) / 32);
    q4k_matvec_kernel<kRows, OT><<<(N + kRows - 1) / kRows, warps * 32, 0, st>>>(
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
