// Q4K kernels for Hopper (sm_90a), bound to Python through ctypes
// (nano_tpu_torch/ops/q4k.py).  Weights stay in the loader's packed layout:
// uint8 (N, n_pad / 2) where byte g*16+j of a row holds value g*32+j in its
// low nibble and value g*32+16+j in its high nibble, with f32 group scales
// s and biases b (N, n_pad / 32); the weight is w = v * s - b.
//
//   q4k_fake_quant  replaces the XLA fusion nano_tpu/ops/q4k.py::fake_quant_act
//                   (_fake_quant_aligned_lean and the masked act_quant_q4k
//                   path), which ran before every Q4K matmul: the C engine's
//                   Q4K quantize->dequantize of the activation, bit for bit
//                   (now only the requantized Q80 head's input).
//   q4k_matmul      replaces the TPU kernel nano_tpu/ops/q4k.py::_q4k_kernel
//                   (launched by _q4k_matmul_2d): f32 dequant v * s - b and
//                   an f32 dot with the fake-quantized activation (on no
//                   main path: the reference of the two below).
//   q4k_matvec_fq   _q4k_kernel at B = 1 (every Q4K product of a decode
//                   step) on the activation's integer form: the
//                   fake-quantized values rebuilt as v * sa - ba (the bits
//                   of fake_quant_act), then q4k_matmul's f32 dot.
//   q4k_act_quant   the activation's Q4K quantization (act_quant_q4k, :459)
//                   kept as integers: the values packed in the weights'
//                   layout, s_eff, b_eff and c per group.  The norms and
//                   SwiGLU write the same form as their epilogue
//                   (norm_quant.cu: rms_norm_q4k, swiglu_q4k); this kernel
//                   is left with wo's input (the attention output).
//   q4k_matmul_w4a4 _q4k_kernel's product at B > 1 as the C engine expands
//                   it (infer/tensor.c:359-434; nano_tpu/ops/q4k.py::
//                   q4k_matmul_int8): y = sum_g sa s P - c m - ba s Q with
//                   P the exact int dot of the 4-bit values of a group on
//                   the int8 tensor cores: every Q4K product of more than
//                   one row.
//
// The quantization's arithmetic is q4k_quant.cuh's, shared with
// norm_quant.cu: the C engine's integer decisions bit for bit (IEEE
// divisions, no contraction, denormals kept: never built with
// --use_fast_math).
//
// Bound on the H100: bytes.  At decode (B = 1) every weight byte is read
// once per step for one multiply-add per 4-bit value (0.75 B per value with
// the f32 scales and biases; a step's 112 products 331 MB, 0.099 ms at
// 3.35 TB/s), far below the ~20 f32 operations per byte the card needs
// before compute limits it.  A product's matrix is 1.5-4.7 MB, about what
// the card has in flight in one memory latency, so a launch is one
// latency, its bytes, the dot of the last tile and the launch itself.
//   q4k_matvec_fq.  q80_matvec_fq's skeleton: block b owns rows
//           [N b / nb, N (b + 1) / nb) and walks them in tiles of R rows
//           round a ring of S stages; a tile's packed rows are one
//           contiguous R * n_pad / 2-byte range and its scales and biases
//           two R * G * 4-byte ranges, brought by thread 0's bulk copies
//           (cp.async.bulk, completion on an mbarrier; ends off a 16-byte
//           boundary by plain loads, CopyIn).  The split comes from the
//           shapes alone (ops/q4k.py:matvec_plan): T lanes a row, the
//           least whole warps that give every 32-group a lane (32, 64, 96
//           at in = 1024, 2048, 3072), 256 // T rows a pass and a tile,
//           up to two blocks an SM, every tile of a block in flight at
//           once.  Lane j owns groups j, j + T, ... of every row: it
//           rebuilds their fake-quantized values into registers once (no
//           division: 16 bytes and two floats of the integer form a
//           group), then for each row takes the dot of w = v s - b (one FMA
//           a weight) in four f32 partials, summed (0 + 1) + (2 + 3), over
//           the warp by xor shuffles, over the row's warps in warp order.
//           The fake-quant no block repeats (the fused kernel before
//           quantized the row in every block, ~2 us a launch) is written
//           once, by the kernel that makes the activation.  Launched as a
//           programmatic dependent of that kernel (cudaLaunchKernelEx,
//           kept as a programmatic edge by a CUDA-graph capture), whose
//           blocks trigger at entry: the weights are requested while it
//           runs (they never depend on it) and the activation is read
//           after griddepcontrol.wait.  Measured (chip_smoke.py bench
//           q4k [clocks], NVIDIA H100 80GB HBM3): a step's 112 launches
//           0.53 ms (the fused kernel before it 0.73); a launch alone waits
//           ~2 us for its first tile, the last tile's dot takes ~1.3 us.
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
//   q4k_matmul (B = 1: 4 rows a block, a group a thread; B > 1: a warp a
//           row over tiles of 8 activation rows) and q4k_fake_quant (a
//           warp a 256-value block) are the first designs.
// Not yet done: wgmma tiles; the weights of the next product into L2
// before its producer runs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "int8_mma.cuh"
#include "q4k_quant.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bulk;
using namespace mma8;
using namespace q4kq;

__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
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
// activation's integer form (q4k_quant.cuh:act_quant_block_by_warp): vp
// (B, n_pad / 2), sa, ba, c (B, n_pad / 32).  Its dependents may launch at
// once (programmatic dependent launch: q4k_matvec_fq streams its weights
// while this runs, and reads vp, sa and ba only after it has ended).
template <typename XT>
__global__ void q4k_act_quant_kernel(const XT* __restrict__ x, uint8_t* __restrict__ vp,
                                     float* __restrict__ sa, float* __restrict__ ba,
                                     float* __restrict__ c, int B, int n, int n_pad) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int nbpl = n_pad >> 8;
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= B * nbpl) return;   // a whole warp
  const int b = wid / nbpl, blk = wid - b * nbpl;
  act_quant_block_by_warp(x + (size_t)b * n, blk, n, lane, vp + (size_t)b * (n_pad >> 1),
                          sa + (size_t)b * (n_pad >> 5), ba + (size_t)b * (n_pad >> 5),
                          c + (size_t)b * (n_pad >> 5));
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

// ---- q4k_matvec_fq ----

constexpr int kMvThreads = 256;   // threads of a q4k_matvec_fq block at most
constexpr int kMvMaxGroups = 4;   // a lane's groups at most (n_pad <= 32768)
constexpr int kMvMaxStages = 16;  // ring stages at most (their barriers in 128 bytes)

// Where a block's time goes, only in a build with -DNANO_Q4K_CLOCKS
// (`chip_smoke.py bench q4k clocks` makes one beside the real library):
// thread 0 of each block of the last launch stamps %globaltimer (ns) and
// clock64 at entry, when the activation is in registers (after
// griddepcontrol.wait), when
// the first tile is in, when the last tile's dot is done and when the
// block's last row is stored.  Otherwise every stamp is empty.
#ifdef NANO_Q4K_CLOCKS
__device__ unsigned long long g_q4_clk[2048][10];   // [block][globaltimer x 5, clock64 x 5]
#define Q4_CLK(k)                                                                  \
  do {                                                                             \
    if (threadIdx.x == 0) {                                                        \
      unsigned long long t_;                                                       \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                      \
      g_q4_clk[blockIdx.x][k] = t_;                                                \
      g_q4_clk[blockIdx.x][5 + k] = clock64();                                     \
    }                                                                              \
  } while (0)
#else
#define Q4_CLK(k) \
  do {            \
  } while (0)
#endif

// Bytes of one stage of R weight rows: the packed rows, their scales and
// their biases (each of the two CopyIn buffers a 16-byte pad over).
__host__ __device__ __forceinline__ size_t mv4_stage(int R, int n_pad) {
  return (size_t)R * (n_pad / 2) + 2 * copy_in_bytes((size_t)R * (n_pad / 32) * 4);
}

// Shared memory of a block: S barriers (128 bytes), the row warps' partial
// sums (128 bytes), S stages.
__host__ __device__ __forceinline__ size_t mv4_smem(int R, int n_pad, int S) {
  return 256 + (size_t)S * mv4_stage(R, n_pad);
}

// y (1, N) = the f32 dot of the fake-quantized activation with w = v s - b,
// from the activation's integer form (vp (1, n_pad / 2), sa, ba (1, G)).
// Block b takes rows [N b / nb, N (b + 1) / nb) in tiles of R rows round a
// ring of S stages, each tile's packed rows, scales and biases brought by
// thread 0's bulk copies; T lanes a row (blockDim.x / T rows a pass), lane
// j owning groups j, j + T, ... (GPL at most) of every row, whose
// fake-quantized values it rebuilds once into registers.  Launched as a
// programmatic dependent of the kernel that wrote the activation: the
// weights are requested first and the activation read after
// griddepcontrol.wait.  Block 0
// also writes the rebuilt row to xf_out (1, n_pad) when it is not null.
template <int GPL, typename OT>
__global__ void __launch_bounds__(kMvThreads)
    q4k_matvec_fq_kernel(const uint8_t* vp, const float* sa, const float* ba,
                         const uint8_t* __restrict__ packed, const float* __restrict__ sc,
                         const float* __restrict__ bi, OT* __restrict__ y,
                         float* __restrict__ xf_out, int n_pad, int in_dim, int N, int R, int S,
                         int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = n_pad >> 5, rowb = n_pad >> 1;
  const size_t stage = mv4_stage(R, n_pad), wbytes = (size_t)R * rowb;
  const size_t sbytes = copy_in_bytes((size_t)R * G * 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // a barrier a stage
  float(*part)[kMvThreads / 32] = reinterpret_cast<float(*)[kMvThreads / 32]>(smem + 128);
  unsigned char* ring = smem + 256;
  const int r_begin = (int)((long long)N * blockIdx.x / gridDim.x);
  const int r_end = (int)((long long)N * (blockIdx.x + 1) / gridDim.x);
  const int ntiles = (r_end - r_begin + R - 1) / R;
  const int tid = threadIdx.x, lane = tid & 31;
  const int RP = blockDim.x / T, slot = tid / T, j = tid - slot * T;
  const int wr = j >> 5, nwr = T >> 5;   // this warp of the row's warps

  // tile t's scales (m = 0) or biases (m = 1): rows n0 .. into stage t % S
  auto params_in = [&](int t, int m) {
    const int n0 = r_begin + t * R;
    return CopyIn(ring + (size_t)(t % S) * stage + wbytes + m * sbytes,
                  (m ? bi : sc) + (size_t)n0 * G, (size_t)min(R, r_end - n0) * G * 4);
  };
  // thread 0: start tile t into stage t % S
  auto issue = [&](int t) {
    const int n0 = r_begin + t * R, rows = min(R, r_end - n0), s = t % S;
    const CopyIn cs = params_in(t, 0), cb = params_in(t, 1);
    cs.ends();
    cb.ends();
    mbar_arrive_expect_tx(&full[s], (uint32_t)(rows * rowb) + cs.bulk_bytes() + cb.bulk_bytes());
    bulk_copy(ring + (size_t)s * stage, packed + (size_t)n0 * rowb, (uint32_t)(rows * rowb),
              &full[s]);
    cs.bulk(&full[s]);
    cb.bulk(&full[s]);
  };

  Q4_CLK(0);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int t = 0; t < min(S, ntiles); ++t) issue(t);
  }
  // the activation's integer form of this lane's groups, once the kernel
  // that writes it has ended (plain loads: it may still be running when
  // this starts)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  uint4 xw[GPL];
  float xs[GPL], xb[GPL];
#pragma unroll
  for (int i = 0; i < GPL; ++i) {
    const int g = j + i * T;
    const bool on = g < G && g * 32 < in_dim;
    xw[i] = on ? reinterpret_cast<const uint4*>(vp)[g] : make_uint4(0u, 0u, 0u, 0u);
    xs[i] = on ? sa[g] : 0.f;
    xb[i] = on ? ba[g] : 0.f;
  }
  // value 32 g + e of the row: x[i][e], 0 at or past in_dim (a packed 0
  // there would rebuild to -ba)
  float x[GPL][32];
#pragma unroll
  for (int i = 0; i < GPL; ++i) {
    const int g = j + i * T;
    const bool on = g < G && g * 32 < in_dim;
    const uint32_t words[4] = {xw[i].x, xw[i].y, xw[i].z, xw[i].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo = words[q] & 0x0F0F0F0Fu, hi = (words[q] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * q + k;
        x[i][e] = on && g * 32 + e < in_dim ? rebuild(nibble(lo, k), xs[i], xb[i]) : 0.f;
        x[i][16 + e] = on && g * 32 + 16 + e < in_dim ? rebuild(nibble(hi, k), xs[i], xb[i]) : 0.f;
      }
    }
    if (xf_out != nullptr && blockIdx.x == 0 && slot == 0 && g < G) {
#pragma unroll
      for (int e = 0; e < 32; ++e) xf_out[g * 32 + e] = x[i][e];
    }
  }
  __syncthreads();   // the barriers are initialized
  Q4_CLK(1);

  // The dot.  A pass: row slot `slot` takes row base + slot of the tile;
  // lane j multiplies its groups' 32 rebuilt values with w = v s - b (one
  // FMA a weight, as q4k_matmul dequantizes) into four f32 partials, one a
  // 4-byte word of the group (its 4 low nibbles, then its 4 high, in
  // order), over its groups in order; the partials summed (0 + 1) + (2 +
  // 3), then over the warp by xor shuffles, then over the row's warps in
  // warp order.  Every loop that holds a shuffle or a barrier has the same
  // count on every thread: rows past the tile take part with zeros.
  int pbuf = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % S, n0 = r_begin + t * R, rows = min(R, r_end - n0);
    mbar_wait(&full[s], (uint32_t)((t / S) & 1));
    if (t == 0) Q4_CLK(2);
    const unsigned char* wt = ring + (size_t)s * stage;
    const float* st = reinterpret_cast<const float*>(params_in(t, 0).dst);
    const float* bt = reinterpret_cast<const float*>(params_in(t, 1).dst);
    for (int base = 0; base < rows; base += RP) {
      const int r = base + slot;
      const bool act = r < rows;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < GPL; ++i) {
        const int g = j + i * T;
        if (!act || g >= G || g * 32 >= in_dim) continue;
        const uint4 pw = *reinterpret_cast<const uint4*>(wt + (size_t)r * rowb + g * 16);
        const float sw = st[r * G + g], nb = -bt[r * G + g];
        const uint32_t words[4] = {pw.x, pw.y, pw.z, pw.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t lo = words[q] & 0x0F0F0F0Fu, hi = (words[q] >> 4) & 0x0F0F0F0Fu;
          float a = acc[q];
#pragma unroll
          for (int k = 0; k < 4; ++k) a = fmaf(x[i][4 * q + k], fmaf(nibble(lo, k), sw, nb), a);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            a = fmaf(x[i][16 + 4 * q + k], fmaf(nibble(hi, k), sw, nb), a);
          acc[q] = a;
        }
      }
      const float v = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
      if (nwr == 1) {
        if (act && lane == 0) store_f(y, (size_t)(n0 + r), v);
      } else {   // the row's warps meet on a named barrier of their own
        if (lane == 0) part[pbuf][slot * nwr + wr] = v;
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slot), "r"(T) : "memory");
        if (act && j == 0) {
          float sum = 0.f;
          for (int w = 0; w < nwr; ++w) sum += part[pbuf][slot * nwr + w];
          store_f(y, (size_t)(n0 + r), sum);
        }
        pbuf ^= 1;
      }
    }
    if (t == ntiles - 1) Q4_CLK(3);
    if (t + S < ntiles) {
      __syncthreads();   // every warp is done with stage s
      if (tid == 0) issue(t + S);
    }
  }
  Q4_CLK(4);
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

// One q4k_matvec_fq launch, as a programmatic dependent of the kernel before
// it on the stream (cudaLaunchKernelEx; a CUDA-graph capture keeps the
// programmatic edge).
template <int GPL, typename OT>
cudaError_t launch_mv4(dim3 grid, dim3 block, size_t smem, cudaStream_t st,
                       const uint8_t* vp, const float* sa, const float* ba, const uint8_t* p,
                       const float* s, const float* b, OT* y, float* xf_out, int n_pad,
                       int in_dim, int N, int R, int S, int T) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, q4k_matvec_fq_kernel<GPL, OT>, vp, sa, ba, p, s, b, y, xf_out,
                            n_pad, in_dim, N, R, S, T);
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

// The activation's integer form (vp (1, n_pad / 2) u8, sa, ba (1, n_pad /
// 32) f32: q4k_act_quant's, or rms_norm_q4k's / swiglu_q4k's) and the packed
// weight (N, n_pad / 2) with its scales and biases (N, n_pad / 32) -> y (1,
// N) f32 or bf16, the f32 dot of the fake-quantized row with the dequantized
// weight; with xf_out (1, n_pad) f32 not null also the rebuilt row.  The
// split (blocks, R, S, T) is ops/q4k.py:matvec_plan's; launched as a
// programmatic dependent of the kernel before it.  The packed weight 16-byte
// aligned.
extern "C" int q4k_matvec_fq(const void* vp, const void* sa, const void* ba, const void* packed,
                             const void* scales, const void* biases, void* y, int y_bf16,
                             void* xf_out, int n_pad, int in_dim, int N, int blocks, int R, int S,
                             int T, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = n_pad / 32;
  const int gpl = T > 0 ? (G + T - 1) / T : 0;
  const size_t smem = mv4_smem(R, n_pad, S);
  if (N < 1 || n_pad < 256 || n_pad % 256 || in_dim < 1 || in_dim > n_pad ||
      in_dim <= n_pad - 256 || T < 32 || T > kMvThreads || T % 32 || gpl > kMvMaxGroups ||
      blocks < 1 || blocks > N || R < 1 || S < 1 || S > kMvMaxStages || smem > (size_t)kMaxSmem ||
      ((uintptr_t)packed & 15) || ((uintptr_t)vp & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks), block(kMvThreads / T * T);
  const uint8_t* vp_ = static_cast<const uint8_t*>(vp);
  const float* sa_ = static_cast<const float*>(sa);
  const float* ba_ = static_cast<const float*>(ba);
  const uint8_t* p_ = static_cast<const uint8_t*>(packed);
  const float* s_ = static_cast<const float*>(scales);
  const float* b_ = static_cast<const float*>(biases);
  float* xf_ = static_cast<float*>(xf_out);
#define NANO_MV4(GPL_, OT)                                                                   \
  launch_mv4<GPL_, OT>(grid, block, smem, st, vp_, sa_, ba_, p_, s_, b_,                \
                       static_cast<OT*>(y), xf_, n_pad, in_dim, N, R, S, T)
#define NANO_MV4_OT(GPL_) \
  (y_bf16 ? NANO_MV4(GPL_, __nv_bfloat16) : NANO_MV4(GPL_, float))
  cudaError_t err;
  switch (gpl) {
    case 1: err = NANO_MV4_OT(1); break;
    case 2: err = NANO_MV4_OT(2); break;
    case 3: err = NANO_MV4_OT(3); break;
    default: err = NANO_MV4_OT(4); break;
  }
#undef NANO_MV4_OT
#undef NANO_MV4
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Shared memory over 48 KB for every q4k_matvec_fq instance on the current
// device: once, before any launch (a CUDA-graph capture must not be the
// first to meet an instance).
extern "C" int q4k_matvec_fq_init() {
  return (int)allow_smem(q4k_matvec_fq_kernel<1, float>, q4k_matvec_fq_kernel<2, float>,
                         q4k_matvec_fq_kernel<3, float>, q4k_matvec_fq_kernel<4, float>,
                         q4k_matvec_fq_kernel<1, __nv_bfloat16>,
                         q4k_matvec_fq_kernel<2, __nv_bfloat16>,
                         q4k_matvec_fq_kernel<3, __nv_bfloat16>,
                         q4k_matvec_fq_kernel<4, __nv_bfloat16>);
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

namespace {

// q[i] = a[i] / b[i] by q4k_quant.cuh's FastDiv and by __fdiv_rn, and
// whether FastDiv's check calls both operands moderate (b[i] > 0).
__global__ void fast_div_kernel(const float* a, const float* b, int n, float* fast, float* ieee,
                                int* exact) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    FastDiv fd;
    fast[i] = fd.div(a[i], b[i], fd.recip(b[i]));
    ieee[i] = __fdiv_rn(a[i], b[i]);
    fd.check(a[i]);
    fd.check(b[i]);
    exact[i] = fd.exact;
  }
}

}  // namespace

// FastDiv against __fdiv_rn over n pairs (the card tests hold the two
// bit-equal wherever FastDiv calls a pair exact).
extern "C" int q4k_fast_div_check(const void* a, const void* b, int n, void* fast, void* ieee,
                                  void* exact, void* stream) {
  fast_div_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), n, static_cast<float*>(fast),
      static_cast<float*>(ieee), static_cast<int*>(exact));
  return (int)cudaGetLastError();
}

#ifdef NANO_Q4K_CLOCKS
// The last q4k_matvec_fq launch's stamps: out[10 b + k] for block b < n_blocks.
extern "C" int q4k_matvec_fq_clocks(unsigned long long* out, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(out, g_q4_clk, sizeof(unsigned long long) * 10 * n_blocks);
}
#endif
