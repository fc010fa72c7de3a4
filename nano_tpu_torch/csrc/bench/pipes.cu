// What one H100 SM sustains of the two instructions a bf16 flash-attention
// kernel at a small head width lives on, mma.sync m16n8k16 (tensor cores)
// and ex2.approx (the special-function unit), alone and together: register-
// only loops, no memory traffic.  Not a kernel of the port: a measuring
// tool, built and timed by `python3 chip_smoke.py bench pipes`.
//
//   mode 1  every warp runs independent mma.sync chains
//   mode 2  every warp runs independent ex2.approx chains
//   mode 3  every warp runs both, interleaved in one instruction stream
//   mode 4  the even warps run only mma, the odd warps only ex2
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kChains = 8;   // independent chains per warp of either kind

template <bool MMA, bool EX2>
__device__ __forceinline__ float work(int iters, uint32_t seed) {
  float c[kChains][4], e[kChains];
  uint32_t a[4] = {seed, seed + 1, seed + 2, seed + 3};
  for (int j = 0; j < kChains; ++j) {
    e[j] = -0.001f * (threadIdx.x + j);
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if (MMA) mma(c[j], a, seed + j, seed - j);
      if (EX2) e[j] = ex2(e[j]) - 1.5f;
      if (EX2 && !MMA) e[j] = ex2(e[j]) - 1.5f;   // alone: two per step, so the loop is not the limit
    }
  }
  float sum = 0.f;
  for (int j = 0; j < kChains; ++j) sum += e[j] + c[j][0] + c[j][1] + c[j][2] + c[j][3];
  return sum;
}

// mode: 1 = mma, 2 = ex2, 3 = both in every warp, 4 = mma in even warps, ex2 in odd
template <int MODE>
__global__ void pipes(float* out, int iters, uint32_t seed) {
  float sum;
  if (MODE == 1) sum = work<true, false>(iters, seed);
  if (MODE == 2) sum = work<false, true>(iters, seed);
  if (MODE == 3) sum = work<true, true>(iters, seed);
  if (MODE == 4)
    sum = (threadIdx.x >> 5) & 1 ? work<false, true>(iters, seed) : work<true, false>(iters, seed);
  if (sum == 12345.678f) out[0] = sum;
}

extern "C" int run(float* out, int blocks, int threads, int iters, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t seed = 0x3c003c00u;
  if (mode == 1) pipes<1><<<blocks, threads, 0, st>>>(out, iters, seed);
  if (mode == 2) pipes<2><<<blocks, threads, 0, st>>>(out, iters, seed);
  if (mode == 3) pipes<3><<<blocks, threads, 0, st>>>(out, iters, seed);
  if (mode == 4) pipes<4><<<blocks, threads, 0, st>>>(out, iters, seed);
  return (int)cudaGetLastError();
}
