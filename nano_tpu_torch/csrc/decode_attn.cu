// Single-token decode attention for Hopper (sm_90a), bound to Python
// through ctypes (nano_tpu_torch/ops/decode_attn.py).
//
// Replaces the TPU kernel nano_tpu/ops/decode_attn.py::_kernel (launched
// by decode_attention) and the XLA einsum chain it stood beside
// (nano_tpu/models/gpt.py attention, S = 1).  Same math, per query head
// h = kv * rep + r of batch row b:
//
//     s[t] = (K[b, t, kv] . q[b, h]) * (k_scale[b, t, kv] / sqrt(D)),  t <= pos[b]
//     p    = softmax(s)                                  (f32)
//     out  = sum_t p[t] * v_scale[b, t, kv] * V[b, t, kv]  (f32)
//
// GQA stays grouped: a block of one (batch row, KV head) holds that head's
// rep query rows, so each K/V row is read once for all of them.  Caches
// are f32, bf16 or int8 (B, T, KV, D); int8 scales fold into the score
// and the probability as on the TPU; bf16/f32 caches pass no scales.
//
// Bound on the H100: bytes — the K and V rows t <= pos, read once, at
// 2 * rep flops per byte.  Only rows up to pos are read (what attn_len
// bucketing bought on the TPU, exactly).  At batch 1 there are only KV
// (batch row, head) pairs, far fewer than the 132 SMs, and a row's load
// latency dominates, so the positions are split over the grid's y axis
// (flash-decoding): block (b*KV + kv, s) takes positions [s*chunk,
// (s+1)*chunk), each of its warps walks a strided subset of them with an
// online softmax (lanes hold D / 32 elements; the next row's loads are
// issued before the current row's math), the warps' partial (max, sum,
// acc) combine in shared memory into one partial per block in `part`,
// and the last block of a (batch row, head) to finish (an atomic ticket
// in `counter`, zeroed by the caller) combines the partials in a fixed
// order, so the result does not depend on which block came last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRep = 8;

__device__ __forceinline__ float load_c(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_c(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_c(const int8_t* p, size_t i) { return (float)p[i]; }

// Loads row t of one KV head: lane holds elements d = lane + 32 * e.
template <int EPL, typename CT>
__device__ __forceinline__ void load_row(const CT* __restrict__ kc, const CT* __restrict__ vc,
                                         const float* __restrict__ ks,
                                         const float* __restrict__ vs, int b, int t, int T,
                                         int KV, int h, int D, int lane, float (&kn)[EPL],
                                         float (&vn)[EPL], float& ksn, float& vsn) {
  const size_t row = (((size_t)b * T + t) * KV + h) * D;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane + 32 * e;
    kn[e] = d < D ? load_c(kc, row + d) : 0.f;
    vn[e] = d < D ? load_c(vc, row + d) : 0.f;
  }
  if (ks != nullptr) {
    const size_t si = ((size_t)b * T + t) * KV + h;
    ksn = ks[si];
    vsn = vs[si];
  }
}

template <int EPL, typename CT>
__global__ void __launch_bounds__(256)
    decode_attn_kernel(const float* __restrict__ q, const CT* __restrict__ kc,
                       const CT* __restrict__ vc, const float* __restrict__ ks,
                       const float* __restrict__ vs, const int* __restrict__ pos,
                       int pos_stride, float* __restrict__ out, float* __restrict__ part,
                       int* __restrict__ counter, int T, int KV, int rep, int D, float scale,
                       int chunk) {
  extern __shared__ float smem[];
  __shared__ int ticket;
  const int bk = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bk / KV, h = bk - (bk / KV) * KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int H = KV * rep;
  const int p_last = pos[(size_t)b * pos_stride];
  const int t0 = split * chunk;
  const int t1 = min(t0 + chunk, p_last + 1);   // may be <= t0: no work

  float qr[kMaxRep][EPL], acc[kMaxRep][EPL], m[kMaxRep], l[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      acc[r][e] = 0.f;
      qr[r][e] = (r < rep && d < D) ? q[((size_t)b * H + h * rep + r) * D + d] : 0.f;
    }
  }

  float kn[EPL], vn[EPL], ksn = 1.f, vsn = 1.f;
  if (t0 + warp < t1)
    load_row<EPL>(kc, vc, ks, vs, b, t0 + warp, T, KV, h, D, lane, kn, vn, ksn, vsn);
  for (int t = t0 + warp; t < t1; t += nw) {
    float kv[EPL], vv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kv[e] = kn[e];
      vv[e] = vn[e];
    }
    const float ksc = ksn * scale, vsc = vsn;
    if (t + nw < t1)
      load_row<EPL>(kc, vc, ks, vs, b, t + nw, T, KV, h, D, lane, kn, vn, ksn, vsn);
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(qr[r][e], kv[e], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= ksc;
        const float mn = fmaxf(m[r], s);
        const float corr = expf(m[r] - mn);
        const float pe = expf(s - mn);
        l[r] = l[r] * corr + pe;
        const float pv = pe * vsc;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * corr + pv * vv[e];
        m[r] = mn;
      }
    }
  }

  // the warps' partial softmax states -> one partial for this block
  float* sm_m = smem;                      // (nw, kMaxRep)
  float* sm_l = smem + nw * kMaxRep;       // (nw, kMaxRep)
  float* sm_acc = smem + 2 * nw * kMaxRep; // (nw, rep, D)
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      sm_m[warp * kMaxRep + r] = m[r];
      sm_l[warp * kMaxRep + r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        if (d < D) sm_acc[((size_t)warp * rep + r) * D + d] = acc[r][e];
      }
    }
  }
  __syncthreads();
  const int stride = D + 2;                // part row: m, l, acc[D]
  float* my_part = part + ((size_t)bk * n_split + split) * rep * stride;
  for (int i = threadIdx.x; i < rep * D; i += blockDim.x) {
    const int r = i / D, d = i - (i / D) * D;
    float M = -INFINITY;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, sm_m[w * kMaxRep + r]);
    float L = 0.f, O = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float mw = sm_m[w * kMaxRep + r];
      if (mw == -INFINITY) continue;       // this warp saw no position
      const float f = expf(mw - M);
      L += sm_l[w * kMaxRep + r] * f;
      O += sm_acc[((size_t)w * rep + r) * D + d] * f;
    }
    my_part[r * stride + 2 + d] = O;
    if (d == 0) {
      my_part[r * stride] = M;
      my_part[r * stride + 1] = L;
    }
  }

  // the last block of this (batch row, head) combines every block's part
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counter + bk, 1);
  __syncthreads();
  if (ticket != n_split - 1) return;
  __threadfence();
  const float* parts = part + (size_t)bk * n_split * rep * stride;
  for (int i = threadIdx.x; i < rep * D; i += blockDim.x) {
    const int r = i / D, d = i - (i / D) * D;
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, __ldcg(parts + ((size_t)s * rep + r) * stride));
    float L = 0.f, O = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = parts + ((size_t)s * rep + r) * stride;
      const float ms = __ldcg(ps);
      if (ms == -INFINITY) continue;       // a split past pos
      const float f = expf(ms - M);
      L += __ldcg(ps + 1) * f;
      O += __ldcg(ps + 2 + d) * f;
    }
    out[(size_t)b * H * D + (size_t)(h * rep + r) * D + d] = O / L;
  }
}

template <typename CT>
int launch(const float* q, const CT* kc, const CT* vc, const float* ks, const float* vs,
           const int* pos, int pos_stride, float* out, float* part, int* counter, int B, int T,
           int KV, int rep, int D, float scale, int chunk, cudaStream_t st) {
  // as many warps as the shared-memory combine fits in 48 KB, at most 8
  const int per_warp = (2 * kMaxRep + rep * D) * (int)sizeof(float);
  int nw = (48 * 1024) / per_warp;
  nw = nw < 1 ? 1 : (nw > 8 ? 8 : nw);
  const size_t smem = (size_t)nw * per_warp;
  const dim3 grid(B * KV, (T + chunk - 1) / chunk), block(nw * 32);
#define NANO_LAUNCH(E)                                                                       \
  decode_attn_kernel<E, CT><<<grid, block, smem, st>>>(q, kc, vc, ks, vs, pos, pos_stride, out, \
                                                       part, counter, T, KV, rep, D, scale,    \
                                                       chunk)
  if (D <= 32) {
    NANO_LAUNCH(1);
  } else if (D <= 64) {
    NANO_LAUNCH(2);
  } else if (D <= 128) {
    NANO_LAUNCH(4);
  } else {
    NANO_LAUNCH(8);
  }
#undef NANO_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// cache_type: 0 = f32, 1 = bf16, 2 = int8.  ks/vs may be null (unit
// scales).  pos holds int32 positions, read at b * pos_stride (a stride
// of 0 broadcasts one position to every row).  D <= 256, rep <= 8.
// part: f32 scratch of B * KV * ceil(T / chunk) * rep * (D + 2); counter:
// B * KV int32, zero at launch.  Launches on the caller's stream and
// returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* kc, const void* vc, const void* ks,
                                const void* vs, const void* pos, int pos_stride, void* out,
                                void* part, void* counter, int cache_type, int B, int T, int KV,
                                int rep, int D, float scale, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q_ = static_cast<const float*>(q);
  const float* ks_ = static_cast<const float*>(ks);
  const float* vs_ = static_cast<const float*>(vs);
  const int* pos_ = static_cast<const int*>(pos);
  float* out_ = static_cast<float*>(out);
  float* part_ = static_cast<float*>(part);
  int* counter_ = static_cast<int*>(counter);
  switch (cache_type) {
    case 0:
      return launch(q_, static_cast<const float*>(kc), static_cast<const float*>(vc), ks_, vs_,
                    pos_, pos_stride, out_, part_, counter_, B, T, KV, rep, D, scale, chunk, st);
    case 1:
      return launch(q_, static_cast<const __nv_bfloat16*>(kc),
                    static_cast<const __nv_bfloat16*>(vc), ks_, vs_, pos_, pos_stride, out_,
                    part_, counter_, B, T, KV, rep, D, scale, chunk, st);
    case 2:
      return launch(q_, static_cast<const int8_t*>(kc), static_cast<const int8_t*>(vc), ks_, vs_,
                    pos_, pos_stride, out_, part_, counter_, B, T, KV, rep, D, scale, chunk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
