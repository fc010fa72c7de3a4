// Q80 matmul kernels for Hopper (sm_90a), bound to Python through ctypes
// (nano_tpu_torch/ops/qmatmul.py).  Weights stay in the .bin file's layout:
// int8 q (N, K) row-major with f32 scales (N, K / gs), one scale per group
// of gs consecutive inputs of a row.
//
// Replaces the TPU kernel nano_tpu/ops/qmatmul.py::_q80_kernel (launched
// by _q80_matmul_2d) and the XLA path it stood beside, q80_matmul_int8 +
// act_quant_q80, in two numerics forms:
//
//   q80_act_quant    act_quant_q80: per-group absmax/127 scale, values
//                    sign(v) * floor(|v| + 0.5) with v = x / scale, the C
//                    engine's rounding, bit for bit (IEEE division; this
//                    file must never be built with --use_fast_math).
//   q80_matmul_w8a8  q80_matmul_int8: int8 activation x int8 weight, an
//                    EXACT int32 partial per group (__dp4a), then the f32
//                    combine  y[b, n] = sum_g P[b, g, n] * sa[b, g] * sw[n, g].
//                    The default form at group size >= 256.
//   q80_matmul_rows  _q80_kernel's own math: f32 dequant q * s, f32 dot.
//                    Used below group size 256 (e.g. gs = 32 files).
//
// Bound on the H100: bytes.  At decode (B = 1) every weight byte is read
// once per step and used for one multiply-add, far below the ~600
// int8 operations per byte the card needs before compute limits it.
// Design: one warp per output row, 16-byte loads along K so a warp reads
// 512 contiguous bytes per iteration; the weight row is read once per
// batch tile of up to 8 activation rows, kept in registers while the tile
// is consumed.  The activation (K bytes a row) is shared by every warp and
// stays in L1/L2.  Not yet done: wgmma/TMA tiles for large B (prefill).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp per (row b, group g).  x (B, K) f32 or bf16 -> xq (B, K) int8,
// sa (B, K / gs) f32.  An all-zero group gets scale 0 and values 0.
template <typename XT>
__global__ void act_quant_kernel(const XT* __restrict__ x, int8_t* __restrict__ xq,
                                 float* __restrict__ sa, int B, int K, int gs) {
  const int G = K / gs;
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= B * G) return;
  const int b = wid / G, g = wid - b * G;
  const size_t base = (size_t)b * K + (size_t)g * gs;
  float amax = 0.f;
  for (int i = lane; i < gs; i += 32) amax = fmaxf(amax, fabsf(load_f(x, base + i)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = amax / 127.0f;
  const float safe = (s == 0.f) ? 1.f : s;
  for (int i = lane; i < gs; i += 32) {
    const float v = load_f(x, base + i) / safe;
    const float r = floorf(fabsf(v) + 0.5f);
    xq[base + i] = (int8_t)(int)copysignf(r, v);
  }
  if (lane == 0) sa[(size_t)b * G + g] = s;
}

// One warp per output row n, BT activation rows per block row of the grid.
// gs is 256 (a group is 16 lanes of one iteration) or a multiple of 512
// (a group spans whole iterations).
template <int BT, typename OT>
__global__ void w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sa,
                            const int8_t* __restrict__ w, const float* __restrict__ sw,
                            OT* __restrict__ y, int B, int K, int N, int gs) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int b0 = blockIdx.y * BT;
  const int G = K / gs;
  const int cpg = gs >> 4;  // 16-byte chunks per group
  const int4* wrow = reinterpret_cast<const int4*>(w + (size_t)n * K);
  const float* swrow = sw + (size_t)n * G;
  float acc[BT];
  int part[BT];
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    acc[j] = 0.f;
    part[j] = 0;
  }
  const int n_iter = (K + 511) >> 9;
  for (int it = 0; it < n_iter; ++it) {
    const int c = it * 32 + lane;
    const bool valid = c * 16 < K;
    int4 wv = make_int4(0, 0, 0, 0);
    if (valid) wv = __ldg(wrow + c);
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (valid && b0 + j < B) {
        const int4 xv = __ldg(reinterpret_cast<const int4*>(xq + (size_t)(b0 + j) * K) + c);
        int p = part[j];
        p = __dp4a(wv.x, xv.x, p);
        p = __dp4a(wv.y, xv.y, p);
        p = __dp4a(wv.z, xv.z, p);
        p = __dp4a(wv.w, xv.w, p);
        part[j] = p;
      }
    }
    if (cpg <= 32) {
      // the groups of this iteration are runs of cpg lanes: exact int sum
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        int p = part[j];
        for (int off = cpg >> 1; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        part[j] = 0;
        if (valid && (lane & (cpg - 1)) == 0 && b0 + j < B) {
          const int g = c / cpg;
          acc[j] += (float)p * sa[(size_t)(b0 + j) * G + g] * swrow[g];
        }
      }
    } else if (((it + 1) * 32) % cpg == 0) {
      // a group spans cpg / 32 iterations and ends with this one
      const int g = (it * 32) / cpg;
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        int p = part[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        part[j] = 0;
        if (lane == 0 && b0 + j < B) acc[j] += (float)p * sa[(size_t)(b0 + j) * G + g] * swrow[g];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    const float v = warp_sum(acc[j]);
    if (lane == 0 && b0 + j < B) store_f(y, (size_t)(b0 + j) * N + n, v);
  }
}

// One warp per output row n: f32 dequant w = q * s, f32 dot with x.
template <int BT, typename XT, typename OT>
__global__ void rows_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                            const float* __restrict__ sw, OT* __restrict__ y, int B, int K,
                            int N, int gs) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int b0 = blockIdx.y * BT;
  const int G = K / gs;
  const int4* wrow = reinterpret_cast<const int4*>(w + (size_t)n * K);
  const float* swrow = sw + (size_t)n * G;
  float acc[BT];
#pragma unroll
  for (int j = 0; j < BT; ++j) acc[j] = 0.f;
  for (int c = lane; c * 16 < K; c += 32) {
    const int4 wv = __ldg(wrow + c);
    const int8_t* wb = reinterpret_cast<const int8_t*>(&wv);
    const int k0 = c * 16;
    float wf[16];
    if (gs % 16 == 0) {
      const float s = swrow[k0 / gs];
#pragma unroll
      for (int e = 0; e < 16; ++e) wf[e] = (float)wb[e] * s;
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) wf[e] = (float)wb[e] * swrow[(k0 + e) / gs];
    }
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (b0 + j < B) {
        const size_t xb = (size_t)(b0 + j) * K + k0;
        float a = acc[j];
#pragma unroll
        for (int e = 0; e < 16; ++e) a = fmaf(load_f(x, xb + e), wf[e], a);
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

constexpr int kWarps = 8;  // output rows per block

template <typename OT>
void launch_w8a8(const int8_t* xq, const float* sa, const int8_t* w, const float* sw, OT* y,
                 int B, int K, int N, int gs, cudaStream_t st) {
  const unsigned gx = (N + kWarps - 1) / kWarps;
  if (B == 1) {
    w8a8_kernel<1, OT><<<dim3(gx, 1), kWarps * 32, 0, st>>>(xq, sa, w, sw, y, B, K, N, gs);
  } else {
    w8a8_kernel<8, OT><<<dim3(gx, (B + 7) / 8), kWarps * 32, 0, st>>>(xq, sa, w, sw, y, B, K,
                                                                       N, gs);
  }
}

template <typename XT, typename OT>
void launch_rows(const XT* x, const int8_t* w, const float* sw, OT* y, int B, int K, int N,
                 int gs, cudaStream_t st) {
  const unsigned gx = (N + kWarps - 1) / kWarps;
  if (B == 1) {
    rows_kernel<1, XT, OT><<<dim3(gx, 1), kWarps * 32, 0, st>>>(x, w, sw, y, B, K, N, gs);
  } else {
    rows_kernel<8, XT, OT><<<dim3(gx, (B + 7) / 8), kWarps * 32, 0, st>>>(x, w, sw, y, B, K, N,
                                                                          gs);
  }
}

}  // namespace

// Every entry point launches on the caller's stream, never synchronises,
// and returns cudaGetLastError() (0 on success).

extern "C" int q80_act_quant(const void* x, int x_bf16, void* xq, void* sa, int B, int K,
                             int gs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = B * (K / gs);
  const unsigned blocks = (warps + kWarps - 1) / kWarps;
  if (x_bf16) {
    act_quant_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(sa), B, K, gs);
  } else {
    act_quant_kernel<float><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sa), B, K,
        gs);
  }
  return (int)cudaGetLastError();
}

extern "C" int q80_matmul_w8a8(const void* xq, const void* sa, const void* w, const void* sw,
                               void* y, int y_bf16, int B, int K, int N, int gs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xq_ = static_cast<const int8_t*>(xq);
  const float* sa_ = static_cast<const float*>(sa);
  const int8_t* w_ = static_cast<const int8_t*>(w);
  const float* sw_ = static_cast<const float*>(sw);
  if (y_bf16) {
    launch_w8a8(xq_, sa_, w_, sw_, static_cast<__nv_bfloat16*>(y), B, K, N, gs, st);
  } else {
    launch_w8a8(xq_, sa_, w_, sw_, static_cast<float*>(y), B, K, N, gs, st);
  }
  return (int)cudaGetLastError();
}

extern "C" int q80_matmul_rows(const void* x, int x_bf16, const void* w, const void* sw,
                               void* y, int y_bf16, int B, int K, int N, int gs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w_ = static_cast<const int8_t*>(w);
  const float* sw_ = static_cast<const float*>(sw);
  if (x_bf16) {
    const __nv_bfloat16* x_ = static_cast<const __nv_bfloat16*>(x);
    if (y_bf16) launch_rows(x_, w_, sw_, static_cast<__nv_bfloat16*>(y), B, K, N, gs, st);
    else launch_rows(x_, w_, sw_, static_cast<float*>(y), B, K, N, gs, st);
  } else {
    const float* x_ = static_cast<const float*>(x);
    if (y_bf16) launch_rows(x_, w_, sw_, static_cast<__nv_bfloat16*>(y), B, K, N, gs, st);
    else launch_rows(x_, w_, sw_, static_cast<float*>(y), B, K, N, gs, st);
  }
  return (int)cudaGetLastError();
}
