// Q80 matmul kernels for Hopper (sm_90a), bound to Python through ctypes
// (nano_tpu_torch/ops/qmatmul.py).  Weights stay in the .bin file's layout:
// int8 q (N, K) row-major with f32 scales (N, K / gs), one scale per group
// of gs consecutive inputs of a row.
//
// Replaces the TPU kernel nano_tpu/ops/qmatmul.py::_q80_kernel (launched
// by _q80_matmul_2d) and the XLA path it stood beside, q80_matmul_int8 +
// act_quant_q80, in three forms:
//
//   q80_act_quant    act_quant_q80: per-group absmax/127 scale, values
//                    sign(v) * floor(|v| + 0.5) with v = x / scale, the C
//                    engine's rounding, bit for bit (IEEE division; this
//                    file must never be built with --use_fast_math).  The
//                    arithmetic is q80_quant.cuh's, shared with
//                    q80_matvec_fq and norm_quant.cu, whose norm and SwiGLU
//                    kernels quantize their own output: this kernel is left
//                    with wo's input (the attention output) at B > 1.
//   q80_matmul_w8a8  q80_matmul_int8 (and _q80_kernel's product) on
//                    quantized rows: int8 activation x int8 weight on the
//                    int8 tensor cores, an EXACT int32 partial per group,
//                    then the f32 combine
//                    y[b, n] = sum_g P[b, g, n] * sa[b, g] * sw[n, g].
//                    The W8A8 form at B > 1: every batched decode step
//                    (B = slots) and every prefill's layer products
//                    (B = prompt length).
//   q80_matvec_fq    the two at B = 1 in one launch: every Q80 product of a
//                    decode step, and the head (one row at prefill too).
//                    The same integer decisions, and the same f32 sums
//                    (RangeSum): a row's output has the same bits here
//                    and in a batch.
//   the rows form    _q80_kernel's own math: f32 dequant w = q * s, each
//                    weight rounded to f32 before it meets x (never fused
//                    into the multiply-add), an f32 dot, no TF32, no bf16
//                    operand, no quantized activation.  Used below group
//                    size 256: every product of a GGUF Q8_0 (gs 32) or
//                    Q6_K (gs 16) file.  Three kernels, chosen by shape
//                    (ops/qmatmul.py:q80_rows):
//     q80_matvec_rows      B = 1 (every product of a decode step, the
//                          head at prefill), q80_matvec_fq's skeleton;
//     q80_matmul_rows      B > 1 (a prefill, a batched step, a verify
//                          round), a tiled SIMT f32 product;
//     q80_matmul_rows_warp the first rows kernel, a warp a row: group sizes that
//                          are not a power of two from 16 up, and a
//                          matvec row too long for shared memory.
//
// Bound on the H100: bytes.  At decode (B = 1) every weight byte is read
// once per step and used for one multiply-add, far below the ~600 int8
// operations per byte the card needs before compute limits it.
//
// q80_matvec_fq.  Rows n0 .. n0 + R - 1 of the row-major table are one
// contiguous R * K-byte range and their scales one R * G * 4-byte range,
// so one thread brings both into shared memory by bulk copy
// (cp.async.bulk, completion on an mbarrier; no tensor map, no registers
// or instructions spent on addresses), and the scales arrive with their
// tile: no dependent load in the loop.  Block b owns a contiguous range of
// rows and walks it in tiles of R rows round a ring of S stages, the next
// tiles' bytes in flight while one is consumed.  The grid, R and S come
// from the shapes alone (ops/qmatmul.py:matvec_plan): up to two blocks an
// SM, so the small products (N = 1024) spread over every SM with their
// whole range issued at once in tiles of 8 rows, and the head's 151 936
// rows stream through 32 KB stages.  The row x is loaded first, by every
// thread, before the first weight request: asked for after the weights it
// comes back after them.  While the tiles are in flight the block's 8
// warps quantize it (a warp a group, the arithmetic of q80_act_quant) into
// an int8 row and G scales in shared memory: once a block, not once a
// tile.  The dot: T lanes a row (8 in the head's 32-row tiles, so that a
// tile is one pass of the block; 16 at gs = 256 and K <= 1024; else a
// warp), a lane __dp4a-ing 16-byte chunks of the row against the int8
// row, a group's ints summed over the lanes that hold it (redux.sync or
// xor shuffles: exact) before they meet its two scales, the f32 sum over
// groups in q80_matmul_w8a8's order (RangeSum), so that a row gets the
// same bits here as in a batch.  A scale range that is not 16-byte aligned at
// either end (N * G not a multiple of 4, or a stacked layer's offset) has
// its < 16-byte ends read by plain loads.  Measured on the H100:
// chip_smoke.py bench q80 [clocks].
//
// q80_matmul_w8a8.  Bound on the H100 by bytes up to B = 64: a batched
// step's 113 products move ~600 MB of weights (0.18 ms at 3.35 TB/s) for
// 2 B multiply-adds a weight byte, and the card's int8 tensor cores need
// ~600 operations a byte before they, and not the memory, set the pace.
// But the multiply-adds are too many for the CUDA cores (__dp4a: ~0.5 ms
// at B = 64 however well issued), so they go to the tensor cores, and the
// design is about the bytes:
//   * each weight byte leaves device memory once: a block's slot tile
//     (BN = 8, 16, 32 or 64 columns of the mma, an instance each, the
//     ragged edge read as zeros) covers every row of a batched step, or,
//     for a weight that stays in L2 (a layer product, 2-6 MB), 32 of them,
//     the other tile's blocks reading it at the same time from L2;
//   * both operands in their natural layout: q (N, K) row-major is the
//     mma's row A operand (weight rows on M, 16 a warp, MB = 64 or 128 a
//     block) and xq (B, K) row-major its col B operand (slots on N), so
//     ldmatrix feeds both from tiles of 256 bytes of K, swizzled so that
//     its 8 rows fall in 8 bank groups, that stream through a ring of up to
//     4 stages by cp.async (the activation too: at B = 64, K = 3072 it is
//     192 KB);
//   * mma.sync m16n8k32 s8: a group of 256 is 8 k-steps into an int32
//     fragment (256 * 127^2 < 2^31, exact), folded into f32 accumulators
//     with the group's two scales when the group ends;
//   * 132 SMs at every product: N = 1024 has 16 row tiles, so the plan
//     (ops/int8_mma.py:plan, from the shapes alone) splits the groups
//     over a cluster of up to 8 blocks, which leave their partial tiles in
//     each other's shared memory and sum them in a fixed order (no atomics,
//     no second launch, the same bits every run);
//   * nothing allocated, one launch, and every instance's shared-memory
//     limit raised once when the library is first used
//     (q80_matmul_init), so that a CUDA-graph capture never meets one first.
// The ring, the mma, the cluster's sum and the launch are int8_mma.cuh's,
// shared with q4k.cu's q4k_matmul_w4a4.
// Where its time goes (chip_smoke.py bench q80 batched clocks, a layer
// product at B = 64): ~2-3 us until a block's first chunk is in (the
// weights come cold from device memory), ~1-2 us of products, ~2 us for
// the cluster's partial tiles to meet and be written; the plan's choices
// come from chip_smoke.py bench q80 batched sweep.
//
// The rows form.  Its weights are int8 with an f32 scale for every gs
// inputs: 1 + 4 / gs bytes a weight (12.5 % of them scales at gs 32, 25 %
// at gs 16).  Each weight is converted to f32 exactly without the I2F
// unit (a quarter of the FMA rate on sm_90): q ^ 0x80 is put into the low
// byte of 0x4B000000 (the float 2^23 + q + 128) by one byte permute and
// 2^23 + 128 subtracted, then multiplied by its scale (rounded, never
// fused), then fused into the dot.
//
// q80_matvec_rows (B = 1).  Bound by bytes: a decode step's 113 products
// of a Qwen3-0.6B GGUF Q8_0 file move 672 MB for one multiply-add a
// weight.  q80_matvec_fq's skeleton and plan (ops/qmatmul.py:
// matvec_rows_plan): block b owns a contiguous range of rows and streams
// tiles of R rows and their scales by bulk copy into a ring of S stages
// (a scale range off a 16-byte boundary has its ends read by plain
// loads, CopyIn); x is loaded once a block, before the first weight
// request, into shared memory as f32 (bf16 rows from the layers, f32 from
// the head); T lanes a row (8 in the head's 32-row tiles, where the 4 rows
// of a warp read each piece of x together; else a warp) take 16-byte
// chunks j, j + T, ... of it, 16 weights a chunk against 16 f32 of x, into
// two f32 partials a lane (even and odd weights), summed, then over the T
// lanes by xor shuffles.
//
// q80_matmul_rows (B > 1).  Bound by operations from ~32 rows on (a
// 64-token prefill's 112 products are 56.4 GFLOP of f32 FMA: 0.84 ms at
// 67 TFLOP/s, against 0.13 ms for their bytes), by bytes below.  A block
// of 2 MB threads takes MB weight rows (64 or 128) and BN activation rows
// (8, 16, 32 or 64: up to 64 rows one tile, so each weight byte leaves
// device memory once) and walks its share of K in chunks of kRowsKC
// inputs.  Each chunk's int8 weights, their scales (one for each half of
// a row's chunk, so any power-of-two gs from 16 is whole groups) and the
// raw activation rows arrive by cp.async into a ring of S stages; the
// block then dequantizes the weights once into shared memory as f32,
// transposed (k-major), converts the activation into f32 beside them, and
// every thread computes a register tile of TM x TN outputs from 16-byte
// shared-memory reads (k-major: the TM weights and TN activations of one
// k are contiguous), an FMA each.  Where the tiles are too few for the
// card (N = 1024 at B = 64: 16 tiles) the chunks split over a thread block
// cluster of CS blocks, each leaving its partial tile in its own shared
// memory and summing one CS-th of the rows from all of them in rank
// order: no atomics, the same bits every run.  The split (MB, BN, CS, S)
// comes from the shapes alone (ops/qmatmul.py:rows_plan).
//
// Order of summation: q80_matvec_rows adds a row's inputs lane-strided
// (16-value chunks j, j + T, ... per lane, even and odd partials, then the
// lanes' xor butterfly); q80_matmul_rows in ascending k within a block,
// then the cluster's partials in rank order.  So a row's output at B = 1
// and in a batch may differ in the last bits (f32 sums in another order).
//
// q80_matmul_rows_warp (the first rows kernel): one warp per output row, 16-byte loads
// along K so a warp reads 512 contiguous bytes per iteration; the weight
// row is read once per batch tile of up to 8 activation rows, kept in
// registers while the tile is consumed.  The activation is shared by every
// warp and stays in L1/L2.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "int8_mma.cuh"
#include "q80_quant.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bulk;
using namespace mma8;

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// The order in which both W8A8 kernels add a row's group terms, whatever
// the batch: the G groups fall into R ranges (R a power of two up to
// min(8, G), a product's own, ops/qmatmul.py:w8a8_ranges; range r holds
// groups [G r / R, G (r + 1) / R)), each group's term (P * sa) * sw
// rounded after each multiply, each range's terms added in group order,
// then the range sums added in range order.  q80_matmul_w8a8 gives each block of a cluster of
// R one range (ops/qmatmul.py:w8a8_plan) and adds the cluster's partials
// in rank order; q80_matvec_fq walks the ranges itself.  So a row's output
// has the same bits at every batch size: a batched decode step gives the
// single stream's logits.

// a group's term (P * sa) * sw, each multiply rounded (never fused)
__device__ __forceinline__ float group_term(int P, float sa, float sw) {
  return __fmul_rn(__fmul_rn((float)P, sa), sw);
}

// Bit g set: a range other than the first of R starts at group g (G <= 64).
__device__ __forceinline__ unsigned long long range_starts(int G, int R) {
  unsigned long long m = 0;
  for (int r = 1; r < R; ++r) m |= 1ull << (G * r / R);
  return m;
}

// One row's sum in that order, its group terms given in group order.
struct RangeSum {
  float outer = 0.f, inner = 0.f;
  bool first = true;            // no range has ended yet
  unsigned long long starts;    // range_starts(G)
  __device__ explicit RangeSum(unsigned long long starts_) : starts(starts_) {}
  __device__ void add(int g, float term) {
    if ((starts >> g) & 1ull) {   // a range ends: add its sum to those before it
      outer = first ? inner : __fadd_rn(outer, inner);
      first = false;
      inner = 0.f;
    }
    inner = __fadd_rn(inner, term);
  }
  __device__ float total() const { return first ? inner : __fadd_rn(outer, inner); }
};

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
  const float s = q80q::scale(amax);
  const float div = q80q::divisor(s);
  for (int i = lane; i < gs; i += 32) xq[base + i] = q80q::value(load_f(x, base + i), div);
  if (lane == 0) sa[(size_t)b * G + g] = s;
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

// ---- q80_matvec_fq ----

constexpr int kMvThreads = 256;   // threads of a q80_matvec_fq block (8 warps)
constexpr int kMvSteps = 2;       // a row's steps a lane holds at once (see the dot)
constexpr int kMvXVec = 4;        // 16-byte pieces of x a thread loads before any weight

// Where a block's time goes, only in a build with -DNANO_MV_CLOCKS
// (`chip_smoke.py bench q80 clocks` makes one beside the real library):
// thread 0 of each block of the last launch stamps %globaltimer (ns) and
// clock64 at entry, when x is in shared memory, when it is quantized, when
// the first tile is in and when the dot is done.  Otherwise every stamp is
// empty.
#ifdef NANO_MV_CLOCKS
__device__ unsigned long long g_mv_clk[2048][10];   // [block][globaltimer x 5, clock64 x 5]
#define MV_CLK(k)                                                                  \
  do {                                                                             \
    if (threadIdx.x == 0) {                                                        \
      unsigned long long t_;                                                       \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                      \
      g_mv_clk[blockIdx.x][k] = t_;                                                \
      g_mv_clk[blockIdx.x][5 + k] = clock64();                                     \
    }                                                                              \
  } while (0)
#else
#define MV_CLK(k) \
  do {            \
  } while (0)
#endif

// Bytes of a buffer for n bytes copied in by CopyIn, rounded to 16.
__host__ __device__ __forceinline__ size_t mv_buf(size_t n) { return copy_in_bytes(n); }

// Shared memory of a block: S barriers; S weight stages of R rows and S
// scale stages; the raw row x (xbytes); the int8 row and its G scales.
__host__ __device__ __forceinline__ size_t mv_smem(int K, int G, int R, int S, int xbytes) {
  return 128 + (size_t)S * ((size_t)R * K + mv_buf((size_t)R * G * 4)) + mv_buf(xbytes) + K +
         (size_t)G * 4;
}

// x (1, K) -> the int8 row xs and its G scales sas in shared memory, with
// q80_act_quant's arithmetic, a warp a group; block 0 also writes them to
// xq_out / sa_out when they are not null.
template <typename XT>
__device__ __forceinline__ void quantize_row(const XT* x, int8_t* xs, float* sas,
                                             int8_t* __restrict__ xq_out,
                                             float* __restrict__ sa_out, int K, int gs) {
  const int lane = threadIdx.x & 31, G = K / gs;
  const bool write_act = blockIdx.x == 0 && xq_out != nullptr;
  // a loop with the same count on every thread, so that the shuffles run
  // on converged warps (under a branch on the warp index the compiler
  // serializes them)
  for (int g0 = 0; g0 < G; g0 += kMvThreads / 32) {
    const int g = g0 + (threadIdx.x >> 5);
    const bool on = g < G;
    const XT* xg = x + (size_t)(on ? g : 0) * gs;
    float amax = 0.f;
    if (on)
      for (int i = lane; i < gs; i += 32) amax = fmaxf(amax, fabsf(load_f(xg, i)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (!on) continue;
    const float sc = q80q::scale(amax);
    const float div = q80q::divisor(sc);
    for (int i = lane; i < gs; i += 32) {
      const int8_t q = q80q::value(load_f(xg, i), div);
      xs[g * gs + i] = q;
      if (write_act) xq_out[g * gs + i] = q;
    }
    if (lane == 0) {
      sas[g] = sc;
      if (write_act) sa_out[g] = sc;
    }
  }
}

// y (1, N) = W8A8(x (1, K)) . w^T.  Block b takes rows [N b / nb, N (b + 1) / nb)
// in tiles of R rows round S stages; T lanes a row.  Block 0 also writes
// the int8 row and its scales to xq_out / sa_out when they are not null.
template <int T, typename XT, typename OT>
__global__ void __launch_bounds__(kMvThreads, 2)
    q80_matvec_fq_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ sw, OT* __restrict__ y,
                         int8_t* __restrict__ xq_out, float* __restrict__ sa_out, int K, int N,
                         int gs, int R, int S, int ranges) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = K / gs;
  const size_t wstage = (size_t)R * K, sstage = mv_buf((size_t)R * G * 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // a barrier a stage
  unsigned char* wbuf = smem + 128;
  unsigned char* sbuf = wbuf + S * wstage;
  unsigned char* xbuf = sbuf + S * sstage;
  int8_t* xs = reinterpret_cast<int8_t*>(xbuf + mv_buf(K * sizeof(XT)));
  float* sas = reinterpret_cast<float*>(xs + K);
  const int r_begin = (int)((long long)N * blockIdx.x / gridDim.x);
  const int r_end = (int)((long long)N * (blockIdx.x + 1) / gridDim.x);
  const int ntiles = (r_end - r_begin + R - 1) / R;
  const int tid = threadIdx.x;

  // tile t's scales: rows n0 .. of sw into stage t % S
  auto scales_in = [&](int t) {
    const int n0 = r_begin + t * R;
    return CopyIn(sbuf + (size_t)(t % S) * sstage, sw + (size_t)n0 * G,
                  (size_t)min(R, r_end - n0) * G * 4);
  };
  // thread 0: start tile t into stage t % S
  auto issue = [&](int t) {
    const int n0 = r_begin + t * R, rows = min(R, r_end - n0), s = t % S;
    const CopyIn sc = scales_in(t);
    sc.ends();
    mbar_arrive_expect_tx(&full[s], (uint32_t)(rows * K) + sc.bulk_bytes());
    bulk_copy(wbuf + s * wstage, w + (size_t)n0 * K, (uint32_t)(rows * K), &full[s]);
    sc.bulk(&full[s]);
  };

  MV_CLK(0);
  // The row first, by plain 16-byte loads of every thread, all issued
  // before thread 0 sends the first weight request: requested after the
  // weights, it comes back after them, and the quantization (and every dot
  // after it) waits for nearly all of the weights.
  const int xbytes = K * (int)sizeof(XT);
  const bool xvec = ((uintptr_t)x & 15) == 0;
  const int4* xg4 = reinterpret_cast<const int4*>(x);
  int4* xb4 = reinterpret_cast<int4*>(xbuf);
  int4 xv[kMvXVec];
#pragma unroll
  for (int u = 0; u < kMvXVec; ++u)
    if (xvec && (tid + u * kMvThreads) * 16 < xbytes) xv[u] = __ldg(xg4 + tid + u * kMvThreads);
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int t = 0; t < min(S, ntiles); ++t) issue(t);
  }
  if (xvec) {
#pragma unroll
    for (int u = 0; u < kMvXVec; ++u)
      if ((tid + u * kMvThreads) * 16 < xbytes) xb4[tid + u * kMvThreads] = xv[u];
    for (int i = tid + kMvXVec * kMvThreads; i * 16 < xbytes; i += kMvThreads) xb4[i] = __ldg(xg4 + i);
  } else {   // a row that starts off a 16-byte boundary
    for (int i = tid; i < K; i += kMvThreads) reinterpret_cast<XT*>(xbuf)[i] = x[i];
  }
  __syncthreads();   // the row is in; the barriers are initialized
  MV_CLK(1);
  quantize_row(reinterpret_cast<const XT*>(xbuf), xs, sas, xq_out, sa_out, K, gs);
  __syncthreads();
  MV_CLK(2);

  // The dot.  Lane j of row slot `slot` takes 16-byte chunks j, j + T, ...
  // of its row; a step is the chunks of one group (T = 8: 2 chunks a lane
  // at gs = 256; T = 32 at gs >= 512) or of two (T = 32 at gs = 256: lanes
  // 0-15 and 16-31), and its L lanes sum their ints.  A lane computes
  // kMvSteps steps' ints, then reduces them together (their reductions
  // overlap), then every lane of the row adds P * sa * sw for each group
  // of those steps in group order (RangeSum; at T = 32 and gs = 256 a
  // step's two groups are the two halves' sums, both in every lane).  Every loop
  // that holds a shuffle or a reduction has the same count on every thread,
  // and every one runs: rows and chunks past the end take part with zeros
  // (under a branch the compiler cannot prove uniform it serializes them).
  constexpr int RP = kMvThreads / T;   // rows a pass
  const int slot = tid / T, j = tid % T;
  const int nch = K >> 4, cpg = gs >> 4;
  const int L = cpg < T ? cpg : T;                // 8, 16 or 32
  const unsigned long long starts = range_starts(G, ranges);
  const int ips = cpg > T ? cpg / T : 1;          // chunks a lane takes of a step
  const int cps = T * ips;                        // chunks a step
  const int nsteps = (nch + cps - 1) / cps;
  const int gps = cps / cpg > 0 ? cps / cpg : 1;  // groups a step advances
  const int4* xr = reinterpret_cast<const int4*>(xs);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % S, n0 = r_begin + t * R, rows = min(R, r_end - n0);
    mbar_wait(&full[s], (uint32_t)((t / S) & 1));
    if (t == 0) MV_CLK(3);
    const int8_t* wt = reinterpret_cast<const int8_t*>(wbuf + s * wstage);
    const float* st = reinterpret_cast<const float*>(scales_in(t).dst);
    for (int base = 0; base < rows; base += RP) {
      const int r = base + slot;
      const bool act = r < rows;
      const int4* wr = reinterpret_cast<const int4*>(wt + (size_t)(act ? r : 0) * K);
      const float* srow = st + (act ? r : 0) * G;
      RangeSum sum(starts);
      for (int s0 = 0; s0 < nsteps; s0 += kMvSteps) {
        int p[kMvSteps], q[kMvSteps];   // q: a step's second group (T = 32, gs = 256)
#pragma unroll
        for (int u = 0; u < kMvSteps; ++u) {
          p[u] = 0;
          const int c0 = (s0 + u) * cps + j;
          if (act && c0 < nch) {
            for (int i = 0; i < ips; ++i) {
              const int4 wv = wr[c0 + i * T], xv = xr[c0 + i * T];
              p[u] = __dp4a(wv.x, xv.x, p[u]);
              p[u] = __dp4a(wv.y, xv.y, p[u]);
              p[u] = __dp4a(wv.z, xv.z, p[u]);
              p[u] = __dp4a(wv.w, xv.w, p[u]);
            }
          }
        }
        if (T == 32) {   // a warp's sum (redux.sync) for each half, or for the whole at gs >= 512
#pragma unroll
          for (int u = 0; u < kMvSteps; ++u) {
            const int lo = __reduce_add_sync(0xffffffffu, (j < 16 || L == 32) ? p[u] : 0);
            q[u] = __reduce_add_sync(0xffffffffu, j < 16 ? 0 : p[u]);
            p[u] = lo;
          }
        } else {   // the 8 or 16 lanes of a row
#pragma unroll
          for (int off = T / 2; off > 0; off >>= 1) {
#pragma unroll
            for (int u = 0; u < kMvSteps; ++u) p[u] += __shfl_xor_sync(0xffffffffu, p[u], off);
          }
        }
        // every lane of the row adds the step's group terms in group order
        // (at T = 32 and gs = 256 a step's two groups: both halves' sums)
#pragma unroll
        for (int u = 0; u < kMvSteps; ++u) {
          const int g = (s0 + u) * gps;
          if (act && g < G) sum.add(g, group_term(p[u], sas[g], srow[g]));
          if (T == 32 && L == 16 && act && g + 1 < G)
            sum.add(g + 1, group_term(q[u], sas[g + 1], srow[g + 1]));
        }
      }
      if (act && j == 0) store_f(y, (size_t)(n0 + r), sum.total());
    }
    if (t + S < ntiles) {
      __syncthreads();   // every warp is done with stage s
      if (tid == 0) issue(t + S);
    }
  }
  MV_CLK(4);
}

// ---- q80_matmul_w8a8 ----

constexpr int kMmaMaxWarps = 8;    // a q80_matmul_w8a8 block: 4 or 8 warps of 16 weight rows
constexpr int kMmaKC = 256;        // bytes of K a stage: 16 chunks of 16 a row
constexpr int kMmaCh = kMmaKC / 16;

// Bytes of one stage of a block of MB weight rows: the weight tile, the
// slot tile, then one scale a row and one a slot (the group of the
// stage's chunk).
__host__ __device__ __forceinline__ size_t mma_stage(int MB, int BN) {
  return (size_t)(MB + BN) * (kMmaKC + 4);
}

__host__ __device__ __forceinline__ size_t mma_smem(int MB, int BN, int CS, int S) {
  return ring_smem(mma_stage(MB, BN), MB, BN, CS, S);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// Where a q80_matmul_w8a8 block's time goes, only in a build with
// -DNANO_W8A8_CLOCKS (`chip_smoke.py bench q80 batched clocks` makes one
// beside the real library): thread 0 of each block of the last launch
// stamps %globaltimer (ns) at entry, when its first chunk is in, when its
// products are done, when the cluster's partial tiles meet and at exit.
#ifdef NANO_W8A8_CLOCKS
__device__ unsigned long long g_w8_clk[8192][5];
#define W8_CLK(k)                                                              \
  do {                                                                         \
    const unsigned b_ = blockIdx.y * gridDim.x + blockIdx.x;                   \
    if (threadIdx.x == 0 && b_ < 8192) {                                       \
      unsigned long long t_;                                                   \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \
      g_w8_clk[b_][k] = t_;                                                    \
    }                                                                          \
  } while (0)
#else
#define W8_CLK(k) \
  do {            \
  } while (0)
#endif

// Byte offset of 16-byte chunk c (0 .. 15) of row r in a tile of 256-byte
// rows: chunk c ^ (r & 7), so that the 8 rows one ldmatrix reads at one
// chunk lie in 8 different bank groups.
__device__ __forceinline__ int swz(int r, int c) { return r * kMmaKC + ((c ^ (r & 7)) << 4); }

// y (B, N) = sum_g P[b, g, n] * sa[b, g] * sw[n, g], P the exact int8 group
// dots, on the int8 tensor cores with the operands swapped: MB weight rows
// a block on M (A = q, row-major), BN slots on N (B = xq, row-major, the
// "col" operand), both fed by ldmatrix from swizzled tiles.  A block of
// MB / 16 warps (blockIdx.x / CS, rank blockIdx.x % CS of its cluster,
// blockIdx.y) takes rows n0 .. n0 + MB - 1, slots b0 .. b0 + BN - 1 and groups
// [G rank / CS, G (rank + 1) / CS), walking them in chunks of 256 bytes of
// K round a ring of S stages filled by cp.async (rows and slots past the
// end, and their scales, read as zeros).  Warp w holds rows 16 w .. 16 w +
// 15 against every slot: an int32 fragment a group (8 k-steps of 32 at gs
// = 256), folded into f32 as (P * sa) * sw when its group ends.  The CS
// blocks of a cluster then add their partial tiles through distributed
// shared memory, rank 0's first, each block summing and writing one CS-th
// of the tile's rows: a fixed order and no atomics.
template <int BN, typename OT>
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
    w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sa,
                const int8_t* __restrict__ w, const float* __restrict__ sw, OT* __restrict__ y,
                int B, int K, int N, int gs, int CS, int S) {
  constexpr int NF = BN / 8;   // 8-slot fragments a warp
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = K / gs, cpg = gs / kMmaKC;
  const int nt = blockDim.x, MB = nt / 2;   // 16 weight rows a warp
  const int rank = blockIdx.x % CS;
  const int n0 = (blockIdx.x / CS) * MB, b0 = blockIdx.y * BN;
  const int c_lo = (G * rank / CS) * cpg;
  const int nch = (G * (rank + 1) / CS) * cpg - c_lo;
  const size_t stage = mma_stage(MB, BN);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // chunk c_lo + t (its weights, slots and the scales of its group) into stage t % S
  auto load = [&](int t) {
    unsigned char* wt = smem + (size_t)(t % S) * stage;
    unsigned char* at = wt + MB * kMmaKC;
    float* sws = reinterpret_cast<float*>(at + BN * kMmaKC);
    float* sas = sws + MB;
    const int kc = c_lo + t, g = kc / cpg;
    const size_t k0 = (size_t)kc * kMmaKC;
    for (int i = tid; i < MB * kMmaCh; i += nt) {
      const int r = i / kMmaCh, c = i % kMmaCh, n = n0 + r;
      cp_async16(wt + swz(r, c), n < N ? w + (size_t)n * K + k0 + c * 16 : w, n < N ? 16 : 0);
    }
    for (int i = tid; i < BN * kMmaCh; i += nt) {
      const int r = i / kMmaCh, c = i % kMmaCh, b = b0 + r;
      cp_async16(at + swz(r, c), b < B ? xq + (size_t)b * K + k0 + c * 16 : xq, b < B ? 16 : 0);
    }
    for (int i = tid; i < MB + BN; i += nt) {
      if (i < MB) {
        const int n = n0 + i;
        cp_async4(sws + i, n < N ? sw + (size_t)n * G + g : sw, n < N ? 4 : 0);
      } else {
        const int b = b0 + i - MB;
        cp_async4(sas + i - MB, b < B ? sa + (size_t)b * G + g : sa, b < B ? 4 : 0);
      }
    }
  };

  W8_CLK(0);
  // every stage's chunk in flight before the first is consumed; one commit
  // group a chunk (empty past the end), so that "chunk t is in" is "at most
  // S - 1 groups pending" at every t
  for (int t = 0; t < S; ++t) {
    if (t < nch) load(t);
    cp_async_commit();
  }
  int ci[NF][4];
  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ci[j][e] = 0;
      acc[j][e] = 0.f;
    }
  const int gid = lane >> 2, tig = lane & 3;
  for (int t = 0; t < nch; ++t) {
    cp_async_wait(S - 1);
    __syncthreads();   // every thread's copies of chunk t are in
    if (t == 0) W8_CLK(1);
    const unsigned char* wt = smem + (size_t)(t % S) * stage;
    const unsigned char* at = wt + MB * kMmaKC;
#pragma unroll
    for (int ks = 0; ks < kMmaKC / 32; ++ks) {
      uint32_t a[4];
      {   // matrices (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31)
        const int m = lane >> 3;
        ldsm_x4(a, wt + swz(warp * 16 + (lane & 7) + (m & 1) * 8, 2 * ks + (m >> 1)));
      }
#pragma unroll
      for (int j = 0; j < NF; j += 2) {
        uint32_t b[4];
        if constexpr (NF == 1) {   // (slots 0-7, k 0-15), (0-7, 16-31)
          ldsm_x2(b, at + swz(lane & 7, 2 * ks + ((lane >> 3) & 1)));
        } else {   // the same for fragments j and j + 1
          const int m = lane >> 3;
          ldsm_x4(b, at + swz(8 * (j + (m >> 1)) + (lane & 7), 2 * ks + (m & 1)));
        }
        mma_s8(ci[j], a, b[0], b[1]);
        if constexpr (NF > 1) mma_s8(ci[j + 1], a, b[2], b[3]);
      }
    }
    if ((c_lo + t + 1) % cpg == 0) {   // the group ends with this chunk
      const float* sws = reinterpret_cast<const float*>(at + BN * kMmaKC);
      const float* sas = sws + MB;
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] = __fadd_rn(acc[j][e], group_term(ci[j][e], sas[8 * j + 2 * tig + (e & 1)],
                                                      sws[warp * 16 + gid + 8 * (e >> 1)]));
          ci[j][e] = 0;
        }
    }
    __syncthreads();   // stage t % S is free
    if (t + S < nch) load(t + S);
    cp_async_commit();
  }
  cp_async_wait(0);
  W8_CLK(2);

  // Each block leaves its partial sums of rows MB q / CS .. of its tile in
  // block q's box (remote stores: nothing waits for them), all in one
  // cluster barrier, and then sums its own rows' CS partials in rank order
  // from its own shared memory and writes them out.
  float* box = reinterpret_cast<float*>(smem + box_offset(stage, CS, S));
  leave_partials(acc, box, MB, BN, CS, rank, warp, lane);
  cluster.sync();
  W8_CLK(3);
  sum_partials(box, MB, BN, CS, rank, [&](int r, int b, float v) {
    if (b0 + b < B && n0 + r < N) store_f(y, (size_t)(b0 + b) * N + n0 + r, v);
  });
  W8_CLK(4);
}

template <typename OT>
cudaError_t launch_w8a8(int BN, const int8_t* xq, const float* sa, const int8_t* w,
                        const float* sw, OT* y, int B, int K, int N, int gs, int MB, int CS, int S,
                        cudaStream_t st) {
  const size_t smem = mma_smem(MB, BN, CS, S);
#define NANO_W8A8(BN_)                                                                          \
  launch_tiles(w8a8_kernel<BN_, OT>, B, N, MB, BN_, CS, smem, st, xq, sa, w, sw, y, B, K, N, gs, \
               CS, S)
  switch (BN) {
    case 8: return NANO_W8A8(8);
    case 16: return NANO_W8A8(16);
    case 32: return NANO_W8A8(32);
    default: return NANO_W8A8(64);
  }
#undef NANO_W8A8
}

// ---- the rows form: q80_matvec_rows, q80_matmul_rows ----

// Weight e (0 .. 3) of the word u = (4 int8 weights) ^ 0x80808080, as an
// exact f32 (2^23 + q + 128, less 2^23 + 128), times its scale s, rounded.
__device__ __forceinline__ float deq(uint32_t u, int e, float s) {
  const float f = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (unsigned)e));
  return __fmul_rn(__fsub_rn(f, 8388736.0f), s);
}

// 16 int8 weights (one 16-byte chunk, one scale) against 16 f32 of x,
// fused into two partials: even weights into a0, odd into a1.
__device__ __forceinline__ void dot16(const int4 wv, float s, const float* xs, float& a0,
                                      float& a1) {
  const uint32_t u[4] = {(uint32_t)wv.x ^ 0x80808080u, (uint32_t)wv.y ^ 0x80808080u,
                         (uint32_t)wv.z ^ 0x80808080u, (uint32_t)wv.w ^ 0x80808080u};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float4 xv = reinterpret_cast<const float4*>(xs)[p];
    a0 = fmaf(deq(u[p], 0, s), xv.x, a0);
    a1 = fmaf(deq(u[p], 1, s), xv.y, a1);
    a0 = fmaf(deq(u[p], 2, s), xv.z, a0);
    a1 = fmaf(deq(u[p], 3, s), xv.w, a1);
  }
}

// 16 bytes of x as f32 values: 4 of an f32 row, 8 of a bf16 row.
__device__ __forceinline__ void x_vals(const int4 v, const float*, float* f) {
  f[0] = __int_as_float(v.x);
  f[1] = __int_as_float(v.y);
  f[2] = __int_as_float(v.z);
  f[3] = __int_as_float(v.w);
}
__device__ __forceinline__ void x_vals(const int4 v, const __nv_bfloat16*, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// 16 bytes of x as f32 at dst (16-byte aligned shared memory).
template <typename XT>
__device__ __forceinline__ void x_to_f32(const int4 v, float* dst) {
  constexpr int XV = 16 / (int)sizeof(XT);
  float f[XV];
  x_vals(v, static_cast<const XT*>(nullptr), f);
#pragma unroll
  for (int i = 0; i < XV; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

// Shared memory of a q80_matvec_rows block: S barriers; S weight stages of
// R rows and S scale stages; the row x as f32.
__host__ __device__ __forceinline__ size_t mvr_smem(int K, int G, int R, int S) {
  return 128 + (size_t)S * ((size_t)R * K + mv_buf((size_t)R * G * 4)) + (size_t)K * 4;
}

// y (1, N) = x (1, K) . dequant(w)^T.  Block b takes rows
// [N b / nb, N (b + 1) / nb) in tiles of R rows round S stages; T lanes a
// row.  gs = 1 << gshift.
template <int T, typename XT, typename OT>
__global__ void __launch_bounds__(kMvThreads, 2)
    q80_matvec_rows_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ sw, OT* __restrict__ y, int K, int N,
                           int gshift, int R, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = K >> gshift;
  const size_t wstage = (size_t)R * K, sstage = mv_buf((size_t)R * G * 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // a barrier a stage
  unsigned char* wbuf = smem + 128;
  unsigned char* sbuf = wbuf + S * wstage;
  float* xs = reinterpret_cast<float*>(sbuf + S * sstage);
  const int r_begin = (int)((long long)N * blockIdx.x / gridDim.x);
  const int r_end = (int)((long long)N * (blockIdx.x + 1) / gridDim.x);
  const int ntiles = (r_end - r_begin + R - 1) / R;
  const int tid = threadIdx.x;

  auto scales_in = [&](int t) {
    const int n0 = r_begin + t * R;
    return CopyIn(sbuf + (size_t)(t % S) * sstage, sw + (size_t)n0 * G,
                  (size_t)min(R, r_end - n0) * G * 4);
  };
  auto issue = [&](int t) {
    const int n0 = r_begin + t * R, rows = min(R, r_end - n0), s = t % S;
    const CopyIn sc = scales_in(t);
    sc.ends();
    mbar_arrive_expect_tx(&full[s], (uint32_t)(rows * K) + sc.bulk_bytes());
    bulk_copy(wbuf + s * wstage, w + (size_t)n0 * K, (uint32_t)(rows * K), &full[s]);
    sc.bulk(&full[s]);
  };

  // The row first, by 16-byte loads of every thread issued before the
  // first weight request (asked for after the weights, it comes after
  // them), converted to f32 once the requests are out.
  constexpr int XV = 16 / (int)sizeof(XT);   // values a 16-byte piece
  const int npieces = K / XV;
  const bool xvec = ((uintptr_t)x & 15) == 0;
  const int4* xg4 = reinterpret_cast<const int4*>(x);
  int4 xv[kMvXVec];
#pragma unroll
  for (int u = 0; u < kMvXVec; ++u)
    if (xvec && tid + u * kMvThreads < npieces) xv[u] = __ldg(xg4 + tid + u * kMvThreads);
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int t = 0; t < min(S, ntiles); ++t) issue(t);
  }
  if (xvec) {
#pragma unroll
    for (int u = 0; u < kMvXVec; ++u) {
      const int i = tid + u * kMvThreads;
      if (i < npieces) x_to_f32<XT>(xv[u], xs + i * XV);
    }
    for (int i = tid + kMvXVec * kMvThreads; i < npieces; i += kMvThreads)
      x_to_f32<XT>(__ldg(xg4 + i), xs + i * XV);
  } else {   // a row that starts off a 16-byte boundary
    for (int i = tid; i < K; i += kMvThreads) xs[i] = load_f(x, i);
  }
  __syncthreads();   // the row is in; the barriers are initialized

  // Lane j of row slot `slot` takes chunks j, j + T, ... of its row.  The
  // shuffles run on every lane of every pass (rows past the end with
  // zeros), outside any branch.
  constexpr int RP = kMvThreads / T;   // rows a pass
  const int slot = tid / T, j = tid % T;
  const int nch = K >> 4, cshift = gshift - 4;   // chunks; chunk c is in group c >> cshift
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % S, n0 = r_begin + t * R, rows = min(R, r_end - n0);
    mbar_wait(&full[s], (uint32_t)((t / S) & 1));
    const int8_t* wt = reinterpret_cast<const int8_t*>(wbuf + s * wstage);
    const float* st = reinterpret_cast<const float*>(scales_in(t).dst);
    for (int base = 0; base < rows; base += RP) {
      const int r = base + slot;
      float a0 = 0.f, a1 = 0.f;
      if (r < rows) {
        const int4* wr = reinterpret_cast<const int4*>(wt + (size_t)r * K);
        const float* srow = st + r * G;
        for (int c = j; c < nch; c += T) dot16(wr[c], srow[c >> cshift], xs + c * 16, a0, a1);
      }
      float v = a0 + a1;
#pragma unroll
      for (int off = T / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (r < rows && j == 0) store_f(y, (size_t)(n0 + r), v);
    }
    if (t + S < ntiles) {
      __syncthreads();   // every warp is done with stage s
      if (tid == 0) issue(t + S);
    }
  }
}

constexpr int kRowsKC = 32;             // K values a q80_matmul_rows chunk
constexpr int kRowsPR = kRowsKC / 16;   // 16-byte pieces of a weight row a chunk

// Bytes of one q80_matmul_rows stage: MB weight rows of kRowsKC int8 (16
// bytes of padding a row, so that a warp's 16-byte reads of 32 rows fall
// in distinct bank groups), a scale for each 16-byte piece of a row, BN
// raw activation rows (padded the same way).
__host__ __device__ __forceinline__ size_t rows_stage(int MB, int BN, int xsize) {
  return (size_t)MB * (kRowsKC + 16) + (size_t)MB * kRowsPR * 4 +
         (size_t)BN * (kRowsKC * xsize + 16);
}

// Shared memory of a block: S stages, then two buffers of a chunk's
// weights and activations as f32, k-major (one filled while the other is
// used); the box of the cluster's partial tile (CS > 1, rows of BN + 4
// floats) lies over them once the products are done.
__host__ __device__ __forceinline__ size_t rows_smem(int MB, int BN, int CS, int S, int xsize) {
  const size_t body = (size_t)S * rows_stage(MB, BN, xsize) + 2 * (size_t)kRowsKC * (MB + BN) * 4;
  const size_t box = CS > 1 ? (size_t)MB * (BN + 4) * 4 : 0;
  return body > box ? body : box;
}

// Where a q80_matmul_rows block's time goes, only in a build with
// -DNANO_ROWS_CLOCKS (`chip_smoke.py bench rows clocks` makes one beside
// the real library): thread 0 of each block of the last launch stamps
// %globaltimer (ns) at entry, when its first chunk is ready, when its
// products are done, when the cluster's partial tiles are met and at exit.
#ifdef NANO_ROWS_CLOCKS
__device__ unsigned long long g_rows_clk[16384][5];
#define ROWS_CLK(k)                                                            \
  do {                                                                         \
    const unsigned b_ = blockIdx.y * gridDim.x + blockIdx.x;                   \
    if (threadIdx.x == 0 && b_ < 16384) {                                      \
      unsigned long long t_;                                                   \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \
      g_rows_clk[b_][k] = t_;                                                  \
    }                                                                          \
  } while (0)
#else
#define ROWS_CLK(k) \
  do {              \
  } while (0)
#endif

// y (B, N) = x (B, K) . dequant(w)^T, a block of 2 MB threads taking
// weight rows n0 .. n0 + MB - 1 (blockIdx.x / CS), activation rows b0 ..
// b0 + BN - 1 (blockIdx.y) and the chunks [nch rank / CS, nch (rank + 1) /
// CS) of K (rank = blockIdx.x % CS); rows, activation rows and inputs past
// the end read as zeros.  One barrier a chunk: while the block multiplies
// chunk t from one f32 buffer it dequantizes chunk t + 1 into the other,
// and the barrier that ends the step also frees the stage chunk t + 1 came
// in, which is refilled with chunk t + S at the next step.  Thread
// (tm, tn) holds outputs (n0 + TM tm + i, b0 + TN tn + jj); a warp covers
// 4 tm by 8 tn, so that its 16-byte reads of the weights and of the
// activation are each one wavefront.
template <int BN, typename XT, typename OT>
__global__ void __launch_bounds__(256)
    q80_matmul_rows_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ sw, OT* __restrict__ y, int B, int K, int N,
                           int gshift, int CS, int S) {
  constexpr int TM = BN == 64 ? 8 : 4;          // weight rows a thread
  constexpr int TN = BN / (2 * TM);             // activation rows a thread
  constexpr int TNW = BN / TN / 8;              // warps across the activation rows (1 or 2)
  constexpr int XSZ = (int)sizeof(XT);
  constexpr int XV = 16 / XSZ;                  // activation values a 16-byte piece
  constexpr int XP = kRowsKC / XV;              // 16-byte pieces of an activation row a chunk
  constexpr int XROW = kRowsKC * XSZ + 16;      // bytes of a raw activation row in a stage
  constexpr int WROW = kRowsKC + 16;            // bytes of a raw weight row in a stage
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nt = blockDim.x, MB = nt / 2;
  const int G = K >> gshift;
  const int rank = blockIdx.x % CS;
  const int n0 = (blockIdx.x / CS) * MB, b0 = blockIdx.y * BN;
  const int nch_all = (K + kRowsKC - 1) / kRowsKC;
  const int c_lo = nch_all * rank / CS, nch = nch_all * (rank + 1) / CS - c_lo;
  const size_t stage = rows_stage(MB, BN, XSZ);
  float* bufs = reinterpret_cast<float*>(smem + (size_t)S * stage);   // 2 x [Ws | Xs]
  const int buf_floats = kRowsKC * (MB + BN);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tn = (lane & 7) + 8 * (warp % TNW), tm = (lane >> 3) + 4 * (warp / TNW);
  ROWS_CLK(0);

  // chunk c_lo + t (its weights, their scales, the activation) into stage t % S
  auto load = [&](int t) {
    unsigned char* wq = smem + (size_t)(t % S) * stage;
    float* ss = reinterpret_cast<float*>(wq + MB * WROW);
    unsigned char* xr = reinterpret_cast<unsigned char*>(ss + kRowsPR * MB);
    const int k0 = (c_lo + t) * kRowsKC;
    for (int i = tid; i < kRowsPR * MB; i += nt) {
      const int r = i / kRowsPR, h = i % kRowsPR, n = n0 + r, k = k0 + 16 * h;
      const bool ok = n < N && k < K;
      cp_async16(wq + r * WROW + 16 * h, ok ? w + (size_t)n * K + k : w, ok ? 16 : 0);
      cp_async4(ss + i, ok ? sw + (size_t)n * G + (k >> gshift) : sw, ok ? 4 : 0);
    }
    for (int i = tid; i < BN * XP; i += nt) {
      const int b = i / XP, p = i % XP, k = k0 + p * XV;
      const bool ok = b0 + b < B && k < K;
      cp_async16(xr + b * XROW + 16 * p, ok ? x + (size_t)(b0 + b) * K + k : x, ok ? 16 : 0);
    }
  };
  // chunk t from its stage into f32 buffer t % 2: the weights dequantized
  // (thread (r, h): piece h of row r), the activation converted, k-major
  auto prepare = [&](int t) {
    const unsigned char* wq = smem + (size_t)(t % S) * stage;
    const float* ss = reinterpret_cast<const float*>(wq + MB * WROW);
    const unsigned char* xr = reinterpret_cast<const unsigned char*>(ss + kRowsPR * MB);
    float* Ws = bufs + (t & 1) * buf_floats;
    float* Xs = Ws + kRowsKC * MB;
    for (int i = tid; i < kRowsPR * MB; i += nt) {
      const int r = i % MB, h = i / MB;
      const int4 v = *reinterpret_cast<const int4*>(wq + r * WROW + 16 * h);
      const float s = ss[kRowsPR * r + h];
      const uint32_t u[4] = {(uint32_t)v.x ^ 0x80808080u, (uint32_t)v.y ^ 0x80808080u,
                             (uint32_t)v.z ^ 0x80808080u, (uint32_t)v.w ^ 0x80808080u};
      float* dst = Ws + 16 * h * MB + r;
#pragma unroll
      for (int e = 0; e < 16; ++e) dst[e * MB] = deq(u[e >> 2], e & 3, s);
    }
    for (int i = tid; i < BN * XP; i += nt) {
      const int b = i % BN, p = i / BN;
      float f[XV];
      x_vals(*reinterpret_cast<const int4*>(xr + b * XROW + 16 * p), x, f);
#pragma unroll
      for (int e = 0; e < XV; ++e) Xs[(p * XV + e) * BN + b] = f[e];
    }
  };

  for (int t = 0; t < S; ++t) {
    if (t < nch) load(t);
    cp_async_commit();
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;

  // Chunk c is commit group c: the prologue commits groups 0 .. S - 1,
  // step t >= 1 group S + t - 1 (chunk t - 1 + S, or none).  Step t needs
  // chunk t + 1, so at most S - 2 groups may be pending at step 0 and S - 3
  // after (S >= 3 where a rank has more than S chunks: the chunk prepared
  // at step t left device memory a step or more before).
  cp_async_wait(S > 1 ? S - 1 : 0);
  __syncthreads();
  if (nch > 0) prepare(0);
  for (int t = 0; t < nch; ++t) {
    const int pending = t == 0 ? S - 2 : S - 3;
    cp_async_wait(pending > 0 ? pending : 0);
    __syncthreads();   // chunk t is ready in f32, t + 1 in its stage; chunk t - 1 is done
    if (t == 0) ROWS_CLK(1);
    if (t > 0) {   // into the stage chunk t came in
      if (t - 1 + S < nch) load(t - 1 + S);
      cp_async_commit();
    }
    if (t + 1 < nch) prepare(t + 1);
    const float* Ws = bufs + (t & 1) * buf_floats;
    const float* Xs = Ws + kRowsKC * MB;
#pragma unroll
    for (int k = 0; k < kRowsKC; ++k) {
      float a[TM], bv[TN];
      const float* wk = Ws + k * MB + tm * TM;
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(wk + i);
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
      const float* xk = Xs + k * BN + tn * TN;
      if constexpr (TN == 4) {
        const float4 v = *reinterpret_cast<const float4*>(xk);
        bv[0] = v.x;
        bv[1] = v.y;
        bv[2] = v.z;
        bv[3] = v.w;
      } else if constexpr (TN == 2) {
        const float2 v = *reinterpret_cast<const float2*>(xk);
        bv[0] = v.x;
        bv[1] = v.y;
      } else {
        bv[0] = xk[0];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] = fmaf(a[i], bv[jj], acc[i][jj]);
    }
  }
  cp_async_wait(0);
  ROWS_CLK(2);

  auto put = [&](int r, int b, float v) {   // row r, activation row b of the tile
    if (n0 + r < N && b0 + b < B) store_f(y, (size_t)(b0 + b) * N + n0 + r, v);
  };
  if (CS == 1) {
    ROWS_CLK(3);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) put(tm * TM + i, tn * TN + jj, acc[i][jj]);
    ROWS_CLK(4);
    return;
  }
  // Each block leaves its partial tile in its own box, then sums one CS-th
  // of the tile's rows over the cluster's boxes in rank order, four
  // activation rows at a time, every rank's piece asked for before the sum.
  constexpr int LD = BN + 4;
  float* box = reinterpret_cast<float*>(smem);
  __syncthreads();   // every thread is done with the buffers
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) box[(tm * TM + i) * LD + tn * TN + jj] = acc[i][jj];
  cluster.sync();
  ROWS_CLK(3);
  const int own = MB / CS;
  for (int i = tid; i < own * (BN / 4); i += nt) {
    const int r = rank * own + i % own, b = 4 * (i / own);
    float4 part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < CS)
        part[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(box, q) + r * LD + b);
    float4 v = part[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < CS) {
        v.x += part[q].x;
        v.y += part[q].y;
        v.z += part[q].z;
        v.w += part[q].w;
      }
    put(r, b, v.x);
    put(r, b + 1, v.y);
    put(r, b + 2, v.z);
    put(r, b + 3, v.w);
  }
  cluster.sync();   // no block leaves while another reads its box
  ROWS_CLK(4);
}

template <typename XT, typename OT>
cudaError_t launch_rows_tiled(int BN, const XT* x, const int8_t* w, const float* sw, OT* y,
                              int B, int K, int N, int gshift, int MB, int CS, int S,
                              cudaStream_t st) {
  const size_t smem = rows_smem(MB, BN, CS, S, (int)sizeof(XT));
#define NANO_ROWS(BN_)                                                                       \
  launch_tiles(q80_matmul_rows_kernel<BN_, XT, OT>, B, N, MB, BN_, CS, smem, st, x, w, sw, y, \
               B, K, N, gshift, CS, S)
  switch (BN) {
    case 8: return NANO_ROWS(8);
    case 16: return NANO_ROWS(16);
    case 32: return NANO_ROWS(32);
    default: return NANO_ROWS(64);
  }
#undef NANO_ROWS
}

// Every instance of q80_matmul_rows (BN x activation type x output type)
// and q80_matvec_rows (T x the two types).
template <typename XT, typename OT>
cudaError_t allow_rows_smem() {
  return allow_smem(q80_matmul_rows_kernel<8, XT, OT>, q80_matmul_rows_kernel<16, XT, OT>,
                    q80_matmul_rows_kernel<32, XT, OT>, q80_matmul_rows_kernel<64, XT, OT>,
                    q80_matvec_rows_kernel<8, XT, OT>, q80_matvec_rows_kernel<32, XT, OT>);
}

// log2(gs) for a power of two from 16, else -1
inline int group_shift(int gs) {
  if (gs < 16 || (gs & (gs - 1))) return -1;
  int s = 0;
  while ((1 << s) < gs) ++s;
  return s;
}

constexpr int kWarps = 8;  // output rows per block

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

// Shared memory over 48 KB for every q80_matmul_w8a8, q80_matmul_rows and
// q80_matvec_rows instance on the current
// device: once, before any launch (a CUDA-graph capture must not be the
// first to meet an instance).
extern "C" int q80_matmul_init() {
  cudaError_t e = allow_smem(w8a8_kernel<8, float>, w8a8_kernel<16, float>, w8a8_kernel<32, float>,
                             w8a8_kernel<64, float>, w8a8_kernel<8, __nv_bfloat16>,
                             w8a8_kernel<16, __nv_bfloat16>, w8a8_kernel<32, __nv_bfloat16>,
                             w8a8_kernel<64, __nv_bfloat16>);
  if (e == cudaSuccess) e = allow_rows_smem<float, float>();
  if (e == cudaSuccess) e = allow_rows_smem<float, __nv_bfloat16>();
  if (e == cudaSuccess) e = allow_rows_smem<__nv_bfloat16, float>();
  if (e == cudaSuccess) e = allow_rows_smem<__nv_bfloat16, __nv_bfloat16>();
  return (int)e;
}

// xq (B, K) int8 and sa (B, K / gs) f32 from q80_act_quant, w (N, K) int8
// with sw (N, K / gs) f32 -> y (B, N) f32 or bf16, with the weight rows a
// block (MB, 64 or 128), the slot tile (BN), the blocks a cluster splitting
// the groups (CS) and the stages (S) of ops/qmatmul.py:w8a8_plan.  xq and w
// 16-byte aligned; gs a multiple of 256.
extern "C" int q80_matmul_w8a8(const void* xq, const void* sa, const void* w, const void* sw,
                               void* y, int y_bf16, int B, int K, int N, int gs, int MB, int BN,
                               int CS, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || gs < kMmaKC || gs % kMmaKC || K < gs || K % gs ||
      !split_ok(MB, BN, CS, K / gs, S, mma_smem(MB, BN, CS, S)))
    return (int)cudaErrorInvalidValue;
  const int8_t* xq_ = static_cast<const int8_t*>(xq);
  const float* sa_ = static_cast<const float*>(sa);
  const int8_t* w_ = static_cast<const int8_t*>(w);
  const float* sw_ = static_cast<const float*>(sw);
  if (y_bf16)
    return (int)launch_w8a8(BN, xq_, sa_, w_, sw_, static_cast<__nv_bfloat16*>(y), B, K, N, gs, MB,
                            CS, S, st);
  return (int)launch_w8a8(BN, xq_, sa_, w_, sw_, static_cast<float*>(y), B, K, N, gs, MB, CS, S,
                          st);
}

// The first rows kernel, a warp a row: x (B, K) f32 or bf16 -> y (B, N), any
// gs dividing K.
extern "C" int q80_matmul_rows_warp(const void* x, int x_bf16, const void* w, const void* sw,
                                    void* y, int y_bf16, int B, int K, int N, int gs,
                                    void* stream) {
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

// The rows form at any B: x (B, K) f32 or bf16 (16-byte aligned) -> y (B,
// N), gs a power of two from 16, K a multiple of 16, with the weight rows a
// block (MB, 64 or 128), the activation rows a tile (BN), the blocks a
// cluster splitting K's chunks (CS) and the stages (S) of
// ops/qmatmul.py:rows_plan.
extern "C" int q80_matmul_rows(const void* x, int x_bf16, const void* w, const void* sw,
                               void* y, int y_bf16, int B, int K, int N, int gs, int MB, int BN,
                               int CS, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gshift = group_shift(gs);
  const int chunks = (K + kRowsKC - 1) / kRowsKC;
  if (B < 1 || N < 1 || K < gs || K % gs || K % 16 || gshift < 0 ||
      (S < 3 && S < (chunks + CS - 1) / CS) ||
      !split_ok(MB, BN, CS, chunks, S, rows_smem(MB, BN, CS, S, x_bf16 ? 2 : 4)))
    return (int)cudaErrorInvalidValue;
  const int8_t* w_ = static_cast<const int8_t*>(w);
  const float* sw_ = static_cast<const float*>(sw);
#define NANO_RT(XT, OT)                                                                        \
  launch_rows_tiled(BN, static_cast<const XT*>(x), w_, sw_, static_cast<OT*>(y), B, K, N, gshift, \
                    MB, CS, S, st)
  cudaError_t e;
  if (x_bf16 && y_bf16) e = NANO_RT(__nv_bfloat16, __nv_bfloat16);
  else if (x_bf16) e = NANO_RT(__nv_bfloat16, float);
  else if (y_bf16) e = NANO_RT(float, __nv_bfloat16);
  else e = NANO_RT(float, float);
#undef NANO_RT
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The rows form at B = 1: x (1, K) f32 or bf16 -> y (1, N), gs a power of
// two from 16, K a multiple of 16, with the grid (`blocks`), the rows a
// stage (R), the stages (S) and the lanes a row (T, 8 or 32) of
// ops/qmatmul.py:matvec_rows_plan.
extern "C" int q80_matvec_rows(const void* x, int x_bf16, const void* w, const void* sw, void* y,
                               int y_bf16, int K, int N, int gs, int blocks, int R, int S, int T,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gshift = group_shift(gs);
  const size_t smem = gshift < 0 ? 0 : mvr_smem(K, K >> gshift, R, S);
  if ((T != 8 && T != 32) || blocks < 1 || R < 1 || S < 1 || S > 4 || gshift < 0 || K < gs ||
      K % gs || K % 16 || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int8_t* w_ = static_cast<const int8_t*>(w);
  const float* sw_ = static_cast<const float*>(sw);
#define NANO_MVR(TT, XT, OT)                                                                 \
  q80_matvec_rows_kernel<TT, XT, OT><<<blocks, kMvThreads, smem, st>>>(                      \
      static_cast<const XT*>(x), w_, sw_, static_cast<OT*>(y), K, N, gshift, R, S)
#define NANO_MVR_T(XT, OT)            \
  do {                                \
    if (T == 8) NANO_MVR(8, XT, OT);  \
    else NANO_MVR(32, XT, OT);        \
  } while (0)
  if (x_bf16 && y_bf16) NANO_MVR_T(__nv_bfloat16, __nv_bfloat16);
  else if (x_bf16) NANO_MVR_T(__nv_bfloat16, float);
  else if (y_bf16) NANO_MVR_T(float, __nv_bfloat16);
  else NANO_MVR_T(float, float);
#undef NANO_MVR_T
#undef NANO_MVR
  return (int)cudaGetLastError();
}

// x (1, K) f32 or bf16, raw -> y (1, N): q80_act_quant + q80_matmul_w8a8 at
// B = 1 in one launch, with the grid (`blocks`), the rows a stage (R), the
// stages (S) and the lanes a row (T, 8 or 32) of ops/qmatmul.py:matvec_plan,
// and the ranges of its sum (ops/qmatmul.py:w8a8_ranges: a power of two up
// to min(8, K / gs); K / gs <= 64).  xq_out (K int8) and sa_out (K / gs f32)
// may be null.
extern "C" int q80_matvec_fq(const void* x, int x_bf16, const void* w, const void* sw, void* y,
                             int y_bf16, void* xq_out, void* sa_out, int K, int N, int gs,
                             int blocks, int R, int S, int T, int ranges, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = mv_smem(K, K / gs, R, S, K * (x_bf16 ? 2 : 4));
  if ((T != 8 && T != 16 && T != 32) || blocks < 1 || R < 1 || S < 1 || S > 4 || smem > 232448 ||
      K / gs > 64 || ranges < 1 || ranges > 8 || ranges > K / gs || (ranges & (ranges - 1)))
    return (int)cudaErrorInvalidValue;
  const int8_t* w_ = static_cast<const int8_t*>(w);
  const float* sw_ = static_cast<const float*>(sw);
  int8_t* xq_ = static_cast<int8_t*>(xq_out);
  float* sa_ = static_cast<float*>(sa_out);
#define NANO_MV(TT, XT, OT)                                                                     \
  do {                                                                                          \
    if (smem > 48 * 1024) {                                                                     \
      const cudaError_t err = cudaFuncSetAttribute(q80_matvec_fq_kernel<TT, XT, OT>,            \
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                                   (int)smem);                                  \
      if (err != cudaSuccess) return (int)err;                                                  \
    }                                                                                           \
    q80_matvec_fq_kernel<TT, XT, OT><<<blocks, kMvThreads, smem, st>>>(                         \
        static_cast<const XT*>(x), w_, sw_, static_cast<OT*>(y), xq_, sa_, K, N, gs, R, S, ranges); \
  } while (0)
#define NANO_MV_T(XT, OT)           \
  do {                              \
    if (T == 8) NANO_MV(8, XT, OT);  \
    else if (T == 16) NANO_MV(16, XT, OT); \
    else NANO_MV(32, XT, OT);       \
  } while (0)
  if (x_bf16 && y_bf16) NANO_MV_T(__nv_bfloat16, __nv_bfloat16);
  else if (x_bf16) NANO_MV_T(__nv_bfloat16, float);
  else if (y_bf16) NANO_MV_T(float, __nv_bfloat16);
  else NANO_MV_T(float, float);
#undef NANO_MV_T
#undef NANO_MV
  return (int)cudaGetLastError();
}

#ifdef NANO_W8A8_CLOCKS
// The last q80_matmul_w8a8 launch's stamps: out[5 b + k] for block b < n_blocks.
extern "C" int q80_matmul_w8a8_clocks(unsigned long long* out, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(out, g_w8_clk, sizeof(unsigned long long) * 5 * n_blocks);
}
#endif

#ifdef NANO_ROWS_CLOCKS
// The last q80_matmul_rows launch's stamps: out[5 b + k] for block b < n_blocks.
extern "C" int q80_matmul_rows_clocks(unsigned long long* out, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(out, g_rows_clk, sizeof(unsigned long long) * 5 * n_blocks);
}
#endif

#ifdef NANO_MV_CLOCKS
// The last launch's stamps: out[10 b + k] for block b < n_blocks.
extern "C" int q80_matvec_fq_clocks(unsigned long long* out, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(out, g_mv_clk, sizeof(unsigned long long) * 10 * n_blocks);
}
#endif
