// The Q80 quantization of an activation group, the C engine's rounding
// (nano_tpu/ops/qmatmul.py:act_quant_q80): scale = absmax / 127 in f32,
// values sign(v) * floor(|v| + 0.5) with v = x / scale, an all-zero group
// scale 0 and values 0.  Every kernel that quantizes an activation for
// q80_matmul_w8a8 takes its integer decisions from here:
// q80_matmul.cu's q80_act_quant and q80_matvec_fq, norm_quant.cu's
// rms_norm_q80 and swiglu_q80.  IEEE division: a file that includes this
// must never be built with --use_fast_math.
#pragma once

#include <stdint.h>

namespace {

namespace q80q {

// the group's scale from its absmax
__device__ __forceinline__ float scale(float amax) { return amax / 127.0f; }

// what the group's values are divided by: the scale, 1 for an all-zero group
__device__ __forceinline__ float divisor(float scale) { return scale == 0.f ? 1.f : scale; }

// one value, rounded half away from zero
__device__ __forceinline__ int8_t value(float x, float divisor) {
  const float v = x / divisor;
  return (int8_t)(int)copysignf(floorf(fabsf(v) + 0.5f), v);
}

}  // namespace q80q

}  // namespace
