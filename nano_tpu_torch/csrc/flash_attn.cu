// Full-sequence causal GQA flash attention for Hopper (sm_90a), forward and
// backward, bound to Python through ctypes (nano_tpu_torch/ops/flash_attn.py).
//
// Replaces the TPU path nano_tpu/models/gpt.py::_flash_attend, which hands
// the no-cache (training) attention to the bundled Pallas flash_attention
// and its backward kernels.  Same function, per batch row b and query head
// h = kv * rep + r:
//
//     out[b, s, h] = softmax_t<=off+s( q[b, s, h] . k[b, t, kv] / sqrt(D) ) @ v[b, :, kv]
//
// and its gradient, without ever holding an (S, S) matrix in device memory.
// q holds Sq positions, k and v Skv >= off + Sq: off = 0 and Sq = Skv is
// the causal attention of a whole sequence; otherwise a block of queries
// at positions off .. off + Sq - 1 against every key of the sequence, as a
// rank of sequence parallelism holds them (the JAX package gets that form
// from GSPMD's partition of its einsum attention on S).  A tile of keys
// wholly visible to a tile of queries runs unmasked; one that the shifted
// diagonal crosses is masked.  Where off is a multiple of the 64-row tile
// the diagonal falls on tile corners as at off = 0, and the tile keeps the
// diagonal tile's skipping of what lies wholly above it; otherwise the
// diagonal crosses one or two tiles of each row of tiles inside them, and
// those run every 16-column pair, masked element by element.
// What the design takes from the function and not from the TPU kernel:
// GQA stays grouped (the TPU kernel wanted K/V repeated to H heads; here a
// query head reads its KV head's rows, and the backward sums dk, dv over the
// rep query heads inside one block), and q, k, v keep their (B, S, heads, D)
// layout, addressed through strides, instead of a transpose to (B, H, S, D).
//
// Bound on the H100 at the training shape (S = 512, D = 48): bytes — every
// q, k, v, out row once, 2 * S / 2 flops per byte of K against the card's
// 295, so with the products on the tensor cores the memory would be the
// limit.  Two paths share one structure (tiles of 64 rows in shared memory,
// a loop over the tiles of the other side of the product, f32 softmax
// state in registers):
//   bf16  mma.sync m16n8k16 tiles with f32 accumulators, each warp owning
//         blocks of 16 rows; P (and dS) go from the score accumulators
//         straight into the next product's A fragments, rounded to bf16 as
//         the plain version rounds its probabilities; no tile is ever
//         stored transposed (ldmatrix.trans where a product runs down a
//         tile's columns).  The forward takes a (query tile, KV head) per
//         block for all the query heads of that KV head, keeps Q in
//         registers, fetches K/V by cp.async into a ring of stages, takes
//         two 8-row blocks of B fragments per ldmatrix.x4 (for two row
//         blocks at once where D <= 64), and on the diagonal tile masks,
//         and skips what lies wholly above the diagonal.  At D = 48 a score
//         costs about as much on the exp2 unit and the CUDA cores as on
//         the tensor cores, and on this card the three overlap only
//         partly, so the kernel is faster for every instruction it
//         leaves out.  The backward is built the same way (cp.async rings,
//         A fragments held in registers where D <= 64, ldmatrix.x4 for B,
//         the diagonal tile masked and its wholly hidden 16-column pairs
//         skipped) and makes two passes, so that no sum crosses blocks.
//         What bounds it, read on the card at the training shape (D = 48,
//         `chip_smoke.py bench flash clocks`): clock64 per warp puts the dq
//         kernel's time 36% in its prologue (its first tiles and out
//         arriving: a block walks only mt + 1 <= 8 tiles), 15% at the
//         barrier, 26% in the S and dP products, 10% in P and dS, 9% in the
//         dQ product; the dk/dv kernel's 9% prologue, 24% barrier and
//         waits, 28% S and dP, 16% P and dS, 19% dV and dK.  Their static
//         SASS has ~800 integer multiply-adds, adds and address LEAs beside
//         252 mma (dq) and ~490 beside 336 (dk/dv).  So latency and issue,
//         not a pipe: 154 of mma.sync's ~646 TFLOP/s on the five products.
//         The route (ops/flash_attn.py:bwd_route) keeps these two passes
//         where the wgmma passes of csrc/flash_bwd_wgmma.cu (tiles by TMA
//         in the swizzled layouts of csrc/wgmma_tma.cuh, the dk/dv pass
//         chained to the dq pass by PDL) are not measured faster, and at
//         D = 128, which those passes do not take (`chip_smoke.py bench
//         flash`, NVIDIA H100 80GB HBM3).
//   f32   the oracle type: f32 tiles, products as CUDA-core FMAs from
//         shared memory with a 4 x (cols / 16) register tile per thread
//         (row-major tiles with an odd leading dimension: a walk along a
//         row or down a column is free of bank conflicts).
//
// flash_attn_fwd   one block per (query tile, head or group of heads of a
//                  KV head, batch row); loop over the K/V tiles up to the
//                  diagonal with an online softmax (running max and sum in
//                  f32); writes out and the row log-sum-exp lse (B, H, S).
// flash_attn_bwd   delta = rowsum(dout * out); then P = exp(S - lse) is
//                  recomputed tile by tile, twice: a block that owns a
//                  (query tile, head or two heads of a KV head, batch row)
//                  loops over the K tiles for dq (bf16: it computes delta
//                  too, and runs first); a block that owns a (K tile, KV
//                  head, batch row) loops over the rep query heads and the
//                  query tiles at or below the diagonal for dk, dv.  No
//                  atomics: every sum is taken in a fixed order, so two
//                  runs agree bit for bit.  (The wgmma passes of
//                  csrc/flash_bwd_wgmma.cu are the same two passes with the
//                  same sums in the same order: the two give the same bits.)
//
// Inputs f32 or bf16 (accumulation always f32); D in {16, 32, 48, 64,
// 128}; any S (the ragged last tile is masked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // f32 path, 16 x 16: thread (ty, tx) owns rows 4*ty.., columns tx + 16*j
constexpr int kTile = 64;       // rows of a query tile; key rows of a dk/dv block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// A ROWS x D tile of a tensor whose rows lie `row_stride` elements apart
// -> f32 shared memory [ROWS][D + 1]; rows at or past `valid` read as zero.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          int64_t row_stride, int valid) {
  constexpr int LD = D + 1, CH = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx - r * CH) * 8;
    float x[8];
    if (r < valid) {
      load8(src + (int64_t)r * row_stride + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * LD + c + j] = x[j];
  }
}

// acc[i][j] += sum_k A[i * a_i + k * a_k] * B[k * b_k + j * b_j]: A points at
// the thread's first row, B at its first column; the strides say whether an
// operand is walked along its rows or down its columns.
template <int NI, int NJ>
__device__ __forceinline__ void tile_fma(float (&acc)[NI][NJ], const float* __restrict__ A,
                                         int a_i, int a_k, const float* __restrict__ B, int b_k,
                                         int b_j, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[NI], b[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = A[i * a_i + k * a_k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * b_k + j * b_j];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// a row of a tile is spread over the 16 tx lanes of a half warp
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

struct Strides {   // elements between batch rows, positions and heads; D is contiguous
  int64_t b, s, h;
};

template <int D>
struct FwdCfg {
  static constexpr int BM = kTile, BN = D > 64 ? 32 : 64, NC = BN / 16, ND = D / 16;
  static constexpr int LD = D + 1, LP = BN + 1;
  static constexpr size_t smem = sizeof(float) * (BM * LD + 2 * BN * LD + BM * LP);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int off, int H,
                     int rep, Strides qs, Strides ks, Strides vs, float scale) {
  using C = FwdCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, NC = C::NC, ND = C::ND, LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * LD;
  float* sV = sK + BN * LD;
  float* sP = sV + BN * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // the tiles with the longest loops first
  const int mt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / rep, m0 = mt * BM;
  load_tile<BM, D>(sQ, q + b * qs.b + h * qs.h + (int64_t)m0 * qs.s, qs.s, Sq - m0);
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  float o[4][ND], mi[4], li[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mi[i] = -INFINITY;
    li[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) o[i][j] = 0.f;
  }

  // the key tiles up to the last key the block's last row sees
  const int n_tiles = (off + min(m0 + BM - 1, Sq - 1)) / BN + 1;
  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * BN;
    __syncthreads();   // the tile before is read to its end
    load_tile<BN, D>(sK, kb + (int64_t)n0 * ks.s, ks.s, Skv - n0);
    load_tile<BN, D>(sV, vb + (int64_t)n0 * vs.s, vs.s, Skv - n0);
    __syncthreads();
    float s[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = 0.f;
    tile_fma<4, NC>(s, sQ + ty * 4 * LD, LD, 1, sK + tx * LD, 1, 16 * LD, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = n0 + tx + 16 * j;
        const float x = (col > off + row || col >= Skv) ? -INFINITY : s[i][j] * scale;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(mi[i], half_warp_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(mi[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = expf(s[i][j] - m_safe);
        sum += p;
        sP[(ty * 4 + i) * LP + tx + 16 * j] = p;
      }
      li[i] = li[i] * corr + half_warp_sum(sum);
      mi[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) o[i][j] *= corr;
    }
    __syncthreads();
    tile_fma<4, ND>(o, sP + ty * 4 * LP, LP, 1, sV + tx, LD, 16, BN);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = 1.f / li[i];
    float* orow = out + (((int64_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) orow[tx + 16 * j] = o[i][j] * inv;
    if (tx == 0) lse[((int64_t)b * H + h) * Sq + row] = mi[i] + logf(li[i]);
  }
}

// delta[b, h, s] = sum_d dout[b, s, h, d] * out[b, s, h, d]; one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t n_rows, int S, int H, int D) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32)
    sum += to_f(out[row * D + d]) * to_f(dout[row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) {
    const int64_t bs = row / H;
    const int h = (int)(row - bs * H);
    const int64_t b = bs / S;
    const int s = (int)(bs - b * S);
    delta[(b * H + h) * S + s] = sum;
  }
}

template <int D>
struct DkvCfg {
  static constexpr int BM = kTile, BN = kTile, ND = D / 16, LD = D + 1, LP = BM + 1;
  static constexpr size_t smem = sizeof(float) * (2 * BN * LD + 2 * BM * LD + 2 * BN * LP + 2 * BM);
};

// f32 dk, dv of one (K tile, KV head, batch row): transposed tiles, rows = keys
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int off,
                          int H, int rep, Strides qs, Strides ks, Strides vs, float scale) {
  using C = DkvCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, ND = C::ND, LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BN * LD;
  float* sQ = sV + BN * LD;
  float* sdO = sQ + BM * LD;
  float* sPt = sdO + BM * LD;
  float* sdSt = sPt + BN * LP;
  float* sLse = sdSt + BN * LP;
  float* sDelta = sLse + BM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, KV = gridDim.y;
  const int n0 = nt * BN;
  load_tile<BN, D>(sK, k + b * ks.b + kvh * ks.h + (int64_t)n0 * ks.s, ks.s, Skv - n0);
  load_tile<BN, D>(sV, v + b * vs.b + kvh * vs.h + (int64_t)n0 * vs.s, vs.s, Skv - n0);

  float dka[4][ND], dva[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) dka[i][j] = dva[i][j] = 0.f;

  // the query tiles from the first that sees a key of this tile
  const int m_tiles = (Sq + BM - 1) / BM, mt0 = max(n0 - off, 0) / BM;
  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dout + (int64_t)b * Sq * H * D + (int64_t)h * D;
    const float* lse_b = lse + ((int64_t)b * H + h) * Sq;
    const float* delta_b = delta + ((int64_t)b * H + h) * Sq;
    for (int mt = mt0; mt < m_tiles; ++mt) {
      const int m0 = mt * BM;
      __syncthreads();   // the tile before is read to its end
      load_tile<BM, D>(sQ, qb + (int64_t)m0 * qs.s, qs.s, Sq - m0);
      load_tile<BM, D>(sdO, dob + (int64_t)m0 * H * D, (int64_t)H * D, Sq - m0);
      if (threadIdx.x < BM) {
        const int m = m0 + threadIdx.x;
        sLse[threadIdx.x] = m < Sq ? lse_b[m] : 0.f;
        sDelta[threadIdx.x] = m < Sq ? delta_b[m] : 0.f;
      }
      __syncthreads();
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      tile_fma<4, 4>(st, sK + ty * 4 * LD, LD, 1, sQ + tx * LD, 1, 16 * LD, D);
      tile_fma<4, 4>(dpt, sV + ty * 4 * LD, LD, 1, sdO + tx * LD, 1, 16 * LD, D);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int mc = tx + 16 * j, m = m0 + mc;
          const bool seen = off + m >= n && m < Sq && n < Skv;
          const float p = seen ? expf(st[i][j] * scale - sLse[mc]) : 0.f;
          sPt[(ty * 4 + i) * LP + mc] = p;
          sdSt[(ty * 4 + i) * LP + mc] = p * (dpt[i][j] - sDelta[mc]);
        }
      }
      __syncthreads();
      tile_fma<4, ND>(dva, sPt + ty * 4 * LP, LP, 1, sdO + tx, LD, 16, BM);
      tile_fma<4, ND>(dka, sdSt + ty * 4 * LP, LP, 1, sQ + tx, LD, 16, BM);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= Skv) continue;
    const int64_t base = (((int64_t)b * Skv + n) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dk[base + tx + 16 * j] = dka[i][j] * scale;
      dv[base + tx + 16 * j] = dva[i][j];
    }
  }
}

template <int D>
struct DqCfg {
  static constexpr int BM = kTile, BN = D > 64 ? 32 : 64, NC = BN / 16, ND = D / 16;
  static constexpr int LD = D + 1, LP = BN + 1;
  static constexpr size_t smem = sizeof(float) * (2 * BM * LD + 2 * BN * LD + BM * LP);
};

// f32 dq of one (query tile, head, batch row)
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Skv,
                        int off, int H, int rep, Strides qs, Strides ks, Strides vs, float scale) {
  using C = DqCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, NC = C::NC, ND = C::ND, LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BM * LD;
  float* sK = sdO + BM * LD;
  float* sV = sK + BN * LD;
  float* sdS = sV + BN * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int mt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / rep, m0 = mt * BM;
  load_tile<BM, D>(sQ, q + b * qs.b + h * qs.h + (int64_t)m0 * qs.s, qs.s, Sq - m0);
  load_tile<BM, D>(sdO, dout + ((int64_t)b * Sq + m0) * H * D + (int64_t)h * D, (int64_t)H * D,
                   Sq - m0);
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  float dqa[4][ND], lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    lse_r[i] = row < Sq ? lse[((int64_t)b * H + h) * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[((int64_t)b * H + h) * Sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) dqa[i][j] = 0.f;
  }

  const int n_tiles = (off + min(m0 + BM - 1, Sq - 1)) / BN + 1;
  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * BN;
    __syncthreads();   // the tile before is read to its end
    load_tile<BN, D>(sK, kb + (int64_t)n0 * ks.s, ks.s, Skv - n0);
    load_tile<BN, D>(sV, vb + (int64_t)n0 * vs.s, vs.s, Skv - n0);
    __syncthreads();
    float s[4][NC], dp[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_fma<4, NC>(s, sQ + ty * 4 * LD, LD, 1, sK + tx * LD, 1, 16 * LD, D);
    tile_fma<4, NC>(dp, sdO + ty * 4 * LD, LD, 1, sV + tx * LD, 1, 16 * LD, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = n0 + tx + 16 * j;
        const bool seen = col <= off + row && col < Skv && row < Sq;
        const float p = seen ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sdS[(ty * 4 + i) * LP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_fma<4, ND>(dqa, sdS + ty * 4 * LP, LP, 1, sK + tx, LD, 16, BN);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= Sq) continue;
    float* drow = dq + (((int64_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) drow[tx + 16 * j] = dqa[i][j] * scale;
  }
}

// =====================================================================
// bf16 path: mma.sync m16n8k16 tiles
// =====================================================================

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;                 // 4 warps x 16 rows of a 64-row tile
constexpr float kLog2e = 1.4426950408889634f;    // the softmax runs on exp2

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16): a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)
//   B (16 x 8):  b0 (k = 2t.., n = g), b1 (k = 2t + 8.., n = g)
//   C (16 x 8):  c0, c1 (g, 2t..), c2, c3 (g + 8, 2t..)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8 x 8 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {   // a row's columns lie in one quad
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// ---------------------------------------------------------------------
// Asynchronous tiles and fragment loaders
// ---------------------------------------------------------------------

// 16 bytes global -> shared without passing through registers; `ok` false
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// returns when at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A ROWS x D bf16 tile -> shared memory [ROWS][D + 8] (the 16 bytes of
// padding keep fragment loads off each other's banks) by cp.async, 16
// bytes a thread; rows at or past `valid` become zeros.  The caller commits
// the group and waits for it.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void cp_tile16(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                          int64_t row_stride, int valid) {
  constexpr int LDS = D + 8, CH = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx - r * CH) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LDS + c, src + (ok ? (int64_t)r * row_stride : 0) + c, ok);
  }
}

// cp_tile16 for a loop that copies many tiles of one shape: which chunks a
// thread copies never changes, so their offsets are worked out once and a
// copy costs a few integer instructions instead of a division and 64-bit
// products per chunk.  The offsets from the tile's first element are 32-bit:
// ROWS * row_stride must stay below 2^31 elements.
template <int ROWS, int D, int THREADS>
struct TileCopier {
  static constexpr int LDS = D + 8, CH = D / 8, N = (ROWS * CH + THREADS - 1) / THREADS;
  int row[N];      // the chunk's row; ROWS and more where the thread has no chunk
  int src_off[N];  // elements from the tile's first element
  int dst_off[N];  // bytes from the tile's first byte in shared memory

  __device__ __forceinline__ void init(int64_t row_stride) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * THREADS, r = idx / CH, c = (idx - r * CH) * 8;
      row[i] = idx < ROWS * CH ? r : (1 << 30);
      src_off[i] = r * (int)row_stride + c;
      dst_off[i] = (r * LDS + c) * (int)sizeof(bf16);
    }
  }
  // rows at or past `valid` become zeros
  __device__ __forceinline__ void copy(uint32_t dst, const bf16* __restrict__ src,
                                       int valid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (N * THREADS > ROWS * CH && row[i] >= ROWS) continue;
      const bool ok = row[i] < valid;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst + dst_off[i]),
                   "l"(src + (ok ? src_off[i] : 0)), "r"(ok ? 16 : 0)
                   : "memory");
    }
  }
};

// four 8 x 8 matrices, each handed out transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The A fragments of a warp's 16 rows (from row0 of sA, [rows][D + 8]),
// all D / 16 k-steps: loaded once where A does not change in a loop.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const bf16* __restrict__ sA,
                                             int row0, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(a[ks], sA + (row0 + (lane & 15)) * (D + 8) + 16 * ks + ((lane >> 4) << 3));
}

// How much of a 64-column tile a warp's row blocks have to look at.  XB =
// -1: a tile wholly below the diagonal, all four 16-column pairs for every
// row block, unmasked.  XB = -2: a tile that the diagonal crosses off its
// corners (an offset that is no multiple of the tile), all four pairs,
// masked.  XB >= 0: the tile on the diagonal, for a warp whose first row
// is 16 XB rows into it: its row block mb ends at row 16 (XB + mb) + 15, so
// only the first XB + mb + 1 pairs hold a column at or below the diagonal;
// the rest is skipped, products and softmax alike.
template <int XB>
__device__ __forceinline__ constexpr int pairs_of(int mb) {
  return XB < 0 ? 4 : XB + mb + 1;
}

// c[mb][j] += A_mb B^T for the A fragments of a warp's MB blocks of 16 rows,
// held in registers, against the 64 rows of sB walked along their rows
// (k = the D columns).  One ldmatrix.x4 brings the B fragments of two 8-row
// blocks of sB (matrices (rows 0-7, k 0-7), (rows 0-7, k 8-15), (rows 8-15,
// k 0-7), (rows 8-15, k 8-15)) and feeds up to 2 MB mma: a B fragment is
// loaded once for all of the warp's row blocks.
template <int D, int MB, int XB>
__device__ __forceinline__ void mma_frags_rows(float (&c)[MB][8][4],
                                               const uint32_t (&a)[MB][D / 16][4],
                                               const bf16* __restrict__ sB, int lane) {
  constexpr int NP = pairs_of<XB>(MB - 1);
  const bf16* bp = sB + ((lane & 7) + ((lane >> 4) << 3)) * (D + 8) + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int jp = 0; jp < NP; ++jp) {
      uint32_t bq[4];
      ldsm_x4(bq, bp + 16 * jp * (D + 8) + 16 * ks);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        if (jp < pairs_of<XB>(mb)) {
          mma_bf16(c[mb][2 * jp], a[mb][ks], bq[0], bq[1]);
          mma_bf16(c[mb][2 * jp + 1], a[mb][ks], bq[2], bq[3]);
        }
      }
    }
}

// acc[mb] += P_mb M for a warp's MB 16 x 64 blocks P, held in the
// accumulator layout of mma_frags_rows and rounded to bf16 here, against the
// 64 x D tile sM walked down its columns (k = its 64 rows), with one
// ldmatrix.x4.trans for two 8-column blocks of sM (matrices (k 0-7,
// cols 0-7), (k 8-15, cols 0-7), (k 0-7, cols 8-15), (k 8-15, cols 8-15)).
template <int D, int MB, int XB>
__device__ __forceinline__ void mma_regs_cols_x4(float (&acc)[MB][D / 8][4],
                                                 const float (&p)[MB][8][4],
                                                 const bf16* __restrict__ sM, int lane) {
  constexpr int NJ = D / 16, NP = pairs_of<XB>(MB - 1);
  const bf16* bp = sM + ((lane & 7) + (((lane >> 3) & 1) << 3)) * (D + 8) + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < NP; ++kk) {
    uint32_t a[MB][4];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      a[mb][0] = pack2(p[mb][2 * kk][0], p[mb][2 * kk][1]);
      a[mb][1] = pack2(p[mb][2 * kk][2], p[mb][2 * kk][3]);
      a[mb][2] = pack2(p[mb][2 * kk + 1][0], p[mb][2 * kk + 1][1]);
      a[mb][3] = pack2(p[mb][2 * kk + 1][2], p[mb][2 * kk + 1][3]);
    }
#pragma unroll
    for (int jp = 0; jp < NJ; ++jp) {
      uint32_t bq[4];
      ldsm_x4_trans(bq, bp + 16 * kk * (D + 8) + 16 * jp);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        if (kk < pairs_of<XB>(mb)) {
          mma_bf16(acc[mb][2 * jp], a[mb], bq[0], bq[1]);
          mma_bf16(acc[mb][2 * jp + 1], a[mb], bq[2], bq[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x; -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One step of the online softmax over the first NB 8-column blocks of a
// warp's 16 x 64 block of raw scores s (accumulator layout): afterwards s
// holds p = 2^((s - max) * sl) there, mi the running maximum of the raw
// scores, li this thread's share of the running row sums (the quad is summed
// once, after the loop), and o is rescaled.  MASKED: a tile the diagonal
// crosses, where column n0 + c may lie past the row's position row_lo
// (+ 8).
template <int D, int NB, bool MASKED>
__device__ __forceinline__ void softmax_step(float (&s)[8][4], float (&o)[D / 8][4],
                                             float (&mi)[2], float (&li)[2], float sl, int row_lo,
                                             int n0, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    // four partial maxima and sums: short dependent chains
    float mx[4] = {mi[hh], -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (MASKED && n0 + 8 * j + 2 * t + e > row_lo + 8 * hh) s[j][2 * hh + e] = -INFINITY;
        mx[j & 3] = fmaxf(mx[j & 3], s[j][2 * hh + e]);
      }
    // the maximum is finite: mi already holds one from tile 0, whose key 0
    // every row sees, or this is tile 0
    const float m_new = quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])));
    const float corr = fast_exp2((mi[hh] - m_new) * sl), shift = m_new * sl;
    mi[hh] = m_new;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp2(fmaf(s[j][2 * hh + e], sl, -shift));
        s[j][2 * hh + e] = p;
        part[j & 3] += p;
      }
    const float sum = (part[0] + part[1]) + (part[2] + part[3]);
    li[hh] = li[hh] * corr + sum;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      o[jd][2 * hh] *= corr;
      o[jd][2 * hh + 1] *= corr;
    }
  }
}

// One K/V tile for a warp: scores, softmax step, P V (XB as in pairs_of;
// row_lo: the position of the warp's first row, offset included).
template <int D, int MB, int XB>
__device__ __forceinline__ void attend_tile(float (&o)[MB][D / 8][4], float (&mi)[MB][2],
                                            float (&li)[MB][2],
                                            const uint32_t (&qf)[MB][D / 16][4],
                                            const bf16* __restrict__ sK,
                                            const bf16* __restrict__ sV, float sl, int row_lo,
                                            int n0, int lane) {
  float s[MB][8][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) zero(s[mb]);
  mma_frags_rows<D, MB, XB>(s, qf, sK, lane);
  softmax_step<D, 2 * pairs_of<XB>(0), XB != -1>(s[0], o[0], mi[0], li[0], sl, row_lo, n0,
                                                  lane & 3);
  if constexpr (MB == 2)
    softmax_step<D, 2 * pairs_of<XB>(1), XB != -1>(s[1], o[1], mi[1], li[1], sl, row_lo + 16, n0,
                                                    lane & 3);
  mma_regs_cols_x4<D, MB, XB>(o, s, sV, lane);
}

// Shapes of the bf16 forward: a block takes 64 query positions of HPB query
// heads of one KV head, MB blocks of 16 score rows a warp (two where the
// registers allow it, D <= 64); its K/V tiles go round a ring of NSTAGE
// stages.
template <int D, int HPB>
struct FwdMma {
  static_assert(D % 16 == 0, "k-steps of 16");
  static constexpr int MB = D <= 64 ? 2 : 1, WARPS = 4 * HPB / MB, THREADS = 32 * WARPS;
  static constexpr int LDS = D + 8, TILE = kTile * LDS, NSTAGE = 3;
  static constexpr size_t smem = sizeof(bf16) * (HPB * TILE + NSTAGE * 2 * TILE);
};

// bf16 forward.  Block (mt, hg, b): the 64 query positions from m0 = 64 * mt
// of the HPB query heads h0 = hg * HPB .. h0 + HPB - 1, which share the KV
// head h0 / rep (HPB divides rep), so each K/V tile is fetched once for all
// of them.  Score rows are laid out head-major: row R = r * 64 + x of the
// block is head h0 + r, position m0 + x; warp w owns the 16 MB rows from
// R = 16 MB w, all of one head, as MB blocks of 16 rows that share every B
// fragment they multiply with.
//
// Q is copied to shared memory once and from there into A fragments that
// stay in registers.  K/V tiles are fetched by cp.async into the ring, tile
// nt + NSTAGE - 1 while tile nt is multiplied; one __syncthreads per tile
// both publishes the tile that landed and frees the stage read before.  The
// loop runs over the tiles 0 .. mt; only the last, on the diagonal, is
// masked (tiles are aligned, so it is also the only one that can reach past
// S: its zero-filled rows lie above the diagonal of every row that is
// stored).  The output goes back through the warp's own Q rows in shared
// memory and leaves in 16-byte stores.
//
// With an offset the loop runs over the tiles up to the one that holds key
// off + m0 + 63 (or off + Sq - 1): those wholly visible to the block's
// first row unmasked, the rest (one or two) masked, the diagonal's
// skipping kept where the tile starts at the block's first position.
template <int D, int HPB>
__global__ void __launch_bounds__(FwdMma<D, HPB>::THREADS)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int Sq, int Skv, int off, int H, int rep,
                         Strides qs, Strides ks, Strides vs, float scale) {
  using C = FwdMma<D, HPB>;
  constexpr int BN = kTile, LDS = C::LDS, TILE = C::TILE, NSTAGE = C::NSTAGE, MB = C::MB;
  constexpr int THREADS = C::THREADS, CH = D / 8, ROWS = 16 * MB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [HPB * 64][LDS]
  bf16* ring = sQ + HPB * TILE;                   // stage i: K at 2 i TILE, V behind it
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the tiles with the longest loops first
  const int mt = gridDim.x - 1 - blockIdx.x, h0 = blockIdx.y * HPB, b = blockIdx.z;
  const int kvh = h0 / rep, m0 = mt * kTile;
  const int h = h0 + warp * ROWS / kTile, x0 = warp * ROWS % kTile;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  // tiles 0 .. n_full - 1 every row of the block sees whole
  const int n_tiles = (off + min(m0 + kTile - 1, Sq - 1)) / BN + 1;
  const int n_full = (off + m0 + 1) / BN;

  TileCopier<BN, D, THREADS> k_copy, v_copy;
  k_copy.init(ks.s);
  v_copy.init(vs.s);
  const uint32_t ring_u32 = smem_u32(ring);
  auto fetch = [&](int tile) {
    const uint32_t sK = ring_u32 + (tile % NSTAGE) * 2 * TILE * (int)sizeof(bf16);
    const int n0 = tile * BN;
    k_copy.copy(sK, kb + (int64_t)n0 * ks.s, Skv - n0);
    v_copy.copy(sK + TILE * (int)sizeof(bf16), vb + (int64_t)n0 * vs.s, Skv - n0);
  };

#pragma unroll
  for (int r = 0; r < HPB; ++r)
    cp_tile16<kTile, D, THREADS>(sQ + r * TILE, q + b * qs.b + (h0 + r) * qs.h + (int64_t)m0 * qs.s,
                                 qs.s, Sq - m0);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {   // one group per tile, empty past the last
    if (i < n_tiles) fetch(i);
    cp_async_commit();
  }
  cp_async_wait<NSTAGE - 1>();   // Q is in
  __syncthreads();
  uint32_t qf[MB][D / 16][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) load_a_frags<D>(qf[mb], sQ, warp * ROWS + 16 * mb, lane);

  const float sl = scale * kLog2e;
  const int row_lo = off + m0 + x0 + g;   // this thread's positions: row_lo + 16 mb + 8 hh
  float o[MB][D / 8][4], mi[MB][2], li[MB][2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    zero(o[mb]);
    mi[mb][0] = mi[mb][1] = -INFINITY;
    li[mb][0] = li[mb][1] = 0.f;
  }

  for (int nt = 0; nt < n_tiles; ++nt) {
    cp_async_wait<NSTAGE - 2>();   // this thread's part of tile nt is in
    __syncthreads();               // everybody's is, and tile nt - 1 is read to its end
    if (nt + NSTAGE - 1 < n_tiles) fetch(nt + NSTAGE - 1);   // into the stage of tile nt - 1
    cp_async_commit();
    const bf16* sK = ring + (nt % NSTAGE) * 2 * TILE;
    const bf16* sV = sK + TILE;
    if (nt < n_full) {
      attend_tile<D, MB, -1>(o, mi, li, qf, sK, sV, sl, row_lo, nt * BN, lane);
    } else if (nt * BN != off + m0) {   // crossed off its corners
      attend_tile<D, MB, -2>(o, mi, li, qf, sK, sV, sl, row_lo, nt * BN, lane);
    } else {   // the diagonal: what lies above it is skipped
#define NANO_DIAG(XB) attend_tile<D, MB, XB>(o, mi, li, qf, sK, sV, sl, row_lo, nt * BN, lane)
      if constexpr (MB == 2) {
        if (x0 == 0)
          NANO_DIAG(0);
        else
          NANO_DIAG(2);
      } else {
        switch (x0 / 16) {
          case 0: NANO_DIAG(0); break;
          case 1: NANO_DIAG(1); break;
          case 2: NANO_DIAG(2); break;
          default: NANO_DIAG(3); break;
        }
      }
#undef NANO_DIAG
    }
  }

  // out rows -> the warp's own rows of sQ (nobody else reads them) -> 16-byte stores
  bf16* so = sQ + warp * ROWS * LDS;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      li[mb][hh] = quad_sum(li[mb][hh]);
      inv[hh] = 1.f / li[mb][hh];
    }
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      *reinterpret_cast<uint32_t*>(so + (16 * mb + g) * LDS + 8 * jd + 2 * t) =
          pack2(o[mb][jd][0] * inv[0], o[mb][jd][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(so + (16 * mb + g + 8) * LDS + 8 * jd + 2 * t) =
          pack2(o[mb][jd][2] * inv[1], o[mb][jd][3] * inv[1]);
    }
  }
  __syncwarp();
  for (int idx = lane; idx < ROWS * CH; idx += 32) {
    const int rr = idx / CH, c = (idx - rr * CH) * 8, pos = m0 + x0 + rr;
    if (pos < Sq)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * Sq + pos) * H + h) * D + c) =
          *reinterpret_cast<const uint4*>(so + rr * LDS + c);
  }
  if (t == 0) {
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pos = row_lo - off + 16 * mb + 8 * hh;
        if (pos < Sq)
          lse[((int64_t)b * H + h) * Sq + pos] = mi[mb][hh] * scale + logf(li[mb][hh]);
      }
  }
}

// ---------------------------------------------------------------------
// bf16 backward
// ---------------------------------------------------------------------

// Cycle counts of the backward's phases, per warp, summed over the grid;
// only in a build with -DNANO_BWD_CLOCKS (`chip_smoke.py bench flash`
// makes one beside the real library).  Otherwise every call is empty.
enum { kClkPrologue, kClkWait, kClkScores, kClkSoftmax, kClkGrads, kClkEpilogue, kClkN };
#ifdef NANO_BWD_CLOCKS
__device__ unsigned long long g_bwd_clocks[2][kClkN];   // [dq, dkdv][phase]
struct Clk {
  long long last, acc[kClkN];
  __device__ __forceinline__ void start() {
    last = clock64();
#pragma unroll
    for (int i = 0; i < kClkN; ++i) acc[i] = 0;
  }
  __device__ __forceinline__ void mark(int phase) {
    const long long now = clock64();
    acc[phase] += now - last;
    last = now;
  }
  __device__ __forceinline__ void flush(int kernel) {
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < kClkN; ++i)
        atomicAdd(&g_bwd_clocks[kernel][i], (unsigned long long)acc[i]);
  }
};
#else
struct Clk {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

// c[j] += A B^T for the A fragments of a warp's 16 rows (registers) against
// the rows 16 P0 .. 16 P1 - 1 of sB, walked along their rows (k = the D
// columns); c[j] is the 8-column block 2 P0 + j.  One ldmatrix.x4 brings
// the B fragments of 16 rows (see mma_frags_rows).
template <int D, int P0, int P1>
__device__ __forceinline__ void mma_a_rows(float (&c)[2 * (P1 - P0)][4],
                                           const uint32_t (&a)[D / 16][4],
                                           const bf16* __restrict__ sB, int lane) {
  const bf16* bp = sB + ((lane & 7) + ((lane >> 4) << 3)) * (D + 8) + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int jp = P0; jp < P1; ++jp) {
      uint32_t bq[4];
      ldsm_x4(bq, bp + 16 * jp * (D + 8) + 16 * ks);
      mma_bf16(c[2 * (jp - P0)], a[ks], bq[0], bq[1]);
      mma_bf16(c[2 * (jp - P0) + 1], a[ks], bq[2], bq[3]);
    }
}

// acc += P M for a warp's 16 rows of P (the 8-column blocks 2 P0 .. 2 P1 - 1
// of a tile, held in accumulators, rounded to bf16 here) against the rows
// 16 P0 .. 16 P1 - 1 of sM walked down its columns (k = those rows).
template <int D, int P0, int P1>
__device__ __forceinline__ void mma_p_cols(float (&acc)[D / 8][4],
                                           const float (&p)[2 * (P1 - P0)][4],
                                           const bf16* __restrict__ sM, int lane) {
  const bf16* bp = sM + ((lane & 7) + (((lane >> 3) & 1) << 3)) * (D + 8) + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = P0; kk < P1; ++kk) {
    const int j = 2 * (kk - P0);
    const uint32_t a[4] = {pack2(p[j][0], p[j][1]), pack2(p[j][2], p[j][3]),
                           pack2(p[j + 1][0], p[j + 1][1]), pack2(p[j + 1][2], p[j + 1][3])};
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t bq[4];
      ldsm_x4_trans(bq, bp + 16 * kk * (D + 8) + 16 * jp);
      mma_bf16(acc[2 * jp], a, bq[0], bq[1]);
      mma_bf16(acc[2 * jp + 1], a, bq[2], bq[3]);
    }
  }
}

// mma_a_rows with the A fragments either held (KEEP) or loaded from the
// warp's 16 rows of sA just before the product (D = 128: no registers to
// hold them across the loop).
template <int D, int P0, int P1, bool KEEP>
__device__ __forceinline__ void mma_held_rows(float (&c)[2 * (P1 - P0)][4],
                                              const uint32_t (&a)[D / 16][4],
                                              const bf16* __restrict__ sA, int row0,
                                              const bf16* __restrict__ sB, int lane) {
  if constexpr (KEEP) {
    mma_a_rows<D, P0, P1>(c, a, sB, lane);
  } else {
    uint32_t f[D / 16][4];
    load_a_frags<D>(f, sA, row0, lane);
    mma_a_rows<D, P0, P1>(c, f, sB, lane);
  }
}

// A warp's 16 rows of a 64 x D accumulator block (scaled, rounded to bf16)
// -> its own 16 rows of the shared tile sT -> 16-byte stores to the rows
// row0 .. row0 + 15 of a tensor whose rows lie row_stride elements apart
// (rows at or past n_rows are not stored).  Nobody else reads those rows
// of sT any more.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, int64_t row_stride,
                                           bf16* __restrict__ sT, const float (&acc)[D / 8][4],
                                           float sc, int row0, int n_rows, int lane) {
  constexpr int LDS = D + 8, CH = D / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    *reinterpret_cast<uint32_t*>(sT + g * LDS + 8 * jd + 2 * t) =
        pack2(acc[jd][0] * sc, acc[jd][1] * sc);
    *reinterpret_cast<uint32_t*>(sT + (g + 8) * LDS + 8 * jd + 2 * t) =
        pack2(acc[jd][2] * sc, acc[jd][3] * sc);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int rr = idx / CH, c = (idx - rr * CH) * 8;
    if (row0 + rr < n_rows)
      *reinterpret_cast<uint4*>(dst + (int64_t)(row0 + rr) * row_stride + c) =
          *reinterpret_cast<const uint4*>(sT + rr * LDS + c);
  }
}

// ---- dq (and delta): a block per (query tile, HPB query heads of one KV
// head, batch row), the forward's layout: head-major rows, warp w owns the
// 16 rows from 16 w, K/V tiles round a cp.async ring, one barrier a tile.

template <int D, int HPB>
struct BwdQ {
  static constexpr int WARPS = 4 * HPB, THREADS = 32 * WARPS;
  // two blocks of 8 warps an SM: at most 128 registers a thread
  static constexpr int MIN_BLOCKS = HPB == 2 && D <= 64 ? 2 : 1;
  static constexpr int LDS = D + 8, TILE = kTile * LDS, NSTAGE = D <= 64 ? 3 : 2;
  static constexpr bool KEEP = D <= 64;   // Q and dO fragments held in registers
  static constexpr size_t smem = sizeof(bf16) * (2 * HPB * TILE + NSTAGE * 2 * TILE);
};

// The 16-key pairs [P0, P1) of one K/V tile for a warp's 16 query rows:
// S = Q K^T, dP = dO V^T, P = 2^(S sl - lse2), dS = P (dP - delta), then
// dQ += dS K.  MASKED: a tile the diagonal crosses, where key n0 + c may
// lie past the row's position row_lo (+ 8).
template <int D, int P0, int P1, bool MASKED, bool KEEP>
__device__ __forceinline__ void dq_chunk(float (&dqa)[D / 8][4], const uint32_t (&qf)[D / 16][4],
                                         const uint32_t (&df)[D / 16][4],
                                         const bf16* __restrict__ sQ, const bf16* __restrict__ sdO,
                                         int row0, const bf16* __restrict__ sK,
                                         const bf16* __restrict__ sV, const float (&lse2)[2],
                                         const float (&dl)[2], float sl, int row_lo, int n0,
                                         int lane, Clk& clk) {
  constexpr int NB = 2 * (P1 - P0);
  float s[NB][4], dp[NB][4];
  zero(s);
  zero(dp);
  mma_held_rows<D, P0, P1, KEEP>(s, qf, sQ, row0, sK, lane);
  mma_held_rows<D, P0, P1, KEEP>(dp, df, sdO, row0, sV, lane);
  clk.mark(kClkScores);
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      float p = fast_exp2(fmaf(s[j][e], sl, -lse2[hh]));
      if (MASKED && n0 + 16 * P0 + 8 * j + 2 * t + (e & 1) > row_lo + 8 * hh) p = 0.f;
      dp[j][e] = p * (dp[j][e] - dl[hh]);
    }
  clk.mark(kClkSoftmax);
  mma_p_cols<D, P0, P1>(dqa, dp, sK, lane);
  clk.mark(kClkGrads);
}

// One K/V tile for the dq block: the key pairs 0 .. NP - 1 (all four below
// the diagonal or where it crosses the tile off its corners; on it, those
// that hold a key at or below the warp's last row), in chunks of two pairs
// to keep the score blocks small.
template <int D, int NP, bool MASKED, bool KEEP>
__device__ __forceinline__ void dq_tile(float (&dqa)[D / 8][4], const uint32_t (&qf)[D / 16][4],
                                        const uint32_t (&df)[D / 16][4],
                                        const bf16* __restrict__ sQ, const bf16* __restrict__ sdO,
                                        int row0, const bf16* __restrict__ sK,
                                        const bf16* __restrict__ sV, const float (&lse2)[2],
                                        const float (&dl)[2], float sl, int row_lo, int n0,
                                        int lane, Clk& clk) {
  dq_chunk<D, 0, (NP < 2 ? NP : 2), MASKED, KEEP>(dqa, qf, df, sQ, sdO, row0, sK, sV, lse2, dl,
                                                  sl, row_lo, n0, lane, clk);
  if constexpr (NP > 2)
    dq_chunk<D, 2, NP, MASKED, KEEP>(dqa, qf, df, sQ, sdO, row0, sK, sV, lse2, dl, sl, row_lo, n0,
                                     lane, clk);
}

// bf16 dq and delta.  Block (mt, hg, b): the 64 query positions from m0 =
// 64 mt of the query heads h0 = hg HPB .. h0 + HPB - 1 (HPB divides rep).
// Prologue: Q and dO tiles by cp.async, their A fragments into registers
// (D <= 64), and delta = rowsum(dO * out) from the thread's dO fragments and
// the same elements of out read from global memory, summed over the quad in
// a fixed order; delta goes to global memory for the dk/dv kernel, which
// runs after this one.  Loop over the K/V tiles as the forward.
template <int D, int HPB>
__global__ void __launch_bounds__(BwdQ<D, HPB>::THREADS, BwdQ<D, HPB>::MIN_BLOCKS)
    flash_bwd_dq_v3_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ out,
                           const bf16* __restrict__ dout, const float* __restrict__ lse,
                           float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Skv,
                           int off, int H, int rep, Strides qs, Strides ks, Strides vs,
                           float scale) {
  using C = BwdQ<D, HPB>;
  constexpr int BN = kTile, TILE = C::TILE, NSTAGE = C::NSTAGE, THREADS = C::THREADS;
  constexpr bool KEEP = C::KEEP;
  Clk clk;
  clk.start();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [HPB * 64][LDS]
  bf16* sdO = sQ + HPB * TILE;                    // [HPB * 64][LDS]
  bf16* ring = sdO + HPB * TILE;                  // stage i: K at 2 i TILE, V behind it
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = gridDim.x - 1 - blockIdx.x, h0 = blockIdx.y * HPB, b = blockIdx.z;
  const int kvh = h0 / rep, m0 = mt * kTile;
  const int h = h0 + warp / 4, x0 = (warp & 3) * 16, row0 = warp * 16;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const int n_tiles = (off + min(m0 + kTile - 1, Sq - 1)) / BN + 1;
  const int n_full = (off + m0 + 1) / BN;

  TileCopier<BN, D, THREADS> k_copy, v_copy;
  k_copy.init(ks.s);
  v_copy.init(vs.s);
  const uint32_t ring_u32 = smem_u32(ring);
  auto fetch = [&](int tile) {
    const uint32_t sK = ring_u32 + (tile % NSTAGE) * 2 * TILE * (int)sizeof(bf16);
    const int n0 = tile * BN;
    k_copy.copy(sK, kb + (int64_t)n0 * ks.s, Skv - n0);
    v_copy.copy(sK + TILE * (int)sizeof(bf16), vb + (int64_t)n0 * vs.s, Skv - n0);
  };
#pragma unroll
  for (int r = 0; r < HPB; ++r) {
    cp_tile16<kTile, D, THREADS>(sQ + r * TILE, q + b * qs.b + (h0 + r) * qs.h + (int64_t)m0 * qs.s,
                                 qs.s, Sq - m0);
    cp_tile16<kTile, D, THREADS>(sdO + r * TILE, dout + ((int64_t)b * Sq + m0) * H * D + (h0 + r) * D,
                                 (int64_t)H * D, Sq - m0);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {   // one group per tile, empty past the last
    if (i < n_tiles) fetch(i);
    cp_async_commit();
  }

  // this thread's rows row_lo and row_lo + 8: lse (exp2 units), and out at
  // the places of its dO fragments (below), fetched from global memory
  // while the tiles are in flight
  const int row_lo = m0 + x0 + g, pos_lo = off + row_lo;   // row, and its position
  const int64_t bh = (int64_t)b * H + h;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + 8 * hh;
    lse2[hh] = row < Sq ? lse[bh * Sq + row] * kLog2e : 0.f;
  }
  uint32_t ov[D / 16][4];
#pragma unroll
  for (int ks_ = 0; ks_ < D / 16; ++ks_)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_lo + 8 * (e & 1);
      ov[ks_][e] = row < Sq ? __ldg(reinterpret_cast<const unsigned int*>(
                                  out + (((int64_t)b * Sq + row) * H + h) * D + 16 * ks_ +
                                 8 * (e >> 1) + 2 * t))
                           : 0u;
    }
  cp_async_wait<NSTAGE - 1>();   // Q and dO are in
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  {
    uint32_t f[D / 16][4];   // dO's fragments: delta here, the loop too where KEEP
    load_a_frags<D>(f, sdO, row0, lane);
    if constexpr (KEEP) {
      load_a_frags<D>(qf, sQ, row0, lane);
#pragma unroll
      for (int ks_ = 0; ks_ < D / 16; ++ks_)
#pragma unroll
        for (int e = 0; e < 4; ++e) df[ks_][e] = f[ks_][e];
    }
    // f[ks][e] holds dO at row row_lo + 8 (e & 1), columns 16 ks + 8 (e >> 1)
    // + 2 t and + 1; rows past Sq are zeros
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int ks_ = 0; ks_ < D / 16; ++ks_)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov[ks_][e]));
        const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&f[ks_][e]));
        part[e & 1] = fmaf(d.y, o.y, fmaf(d.x, o.x, part[e & 1]));
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dl[hh] = quad_sum(part[hh]);
      const int row = row_lo + 8 * hh;
      if (t == 0 && row < Sq) delta[bh * Sq + row] = dl[hh];
    }
  }

  const float sl = scale * kLog2e;
  float dqa[D / 8][4];
  zero(dqa);
  clk.mark(kClkPrologue);
  for (int nt = 0; nt < n_tiles; ++nt) {
    cp_async_wait<NSTAGE - 2>();   // this thread's part of tile nt is in
    __syncthreads();               // everybody's is, and tile nt - 1 is read to its end
    if (nt + NSTAGE - 1 < n_tiles) fetch(nt + NSTAGE - 1);   // into the stage of tile nt - 1
    cp_async_commit();
    clk.mark(kClkWait);
    const bf16* sK = ring + (nt % NSTAGE) * 2 * TILE;
    const bf16* sV = sK + TILE;
    const int n0 = nt * BN;
    if (nt < n_full) {
      dq_tile<D, 4, false, KEEP>(dqa, qf, df, sQ, sdO, row0, sK, sV, lse2, dl, sl, pos_lo, n0,
                                 lane, clk);
    } else if (n0 != off + m0) {   // crossed off its corners
      dq_tile<D, 4, true, KEEP>(dqa, qf, df, sQ, sdO, row0, sK, sV, lse2, dl, sl, pos_lo, n0,
                                lane, clk);
    } else {   // the diagonal: key pairs wholly past the warp's rows are skipped
#define NANO_DQ_DIAG(NP)                                                                      \
  dq_tile<D, NP, true, KEEP>(dqa, qf, df, sQ, sdO, row0, sK, sV, lse2, dl, sl, pos_lo, n0, lane, \
                             clk)
      switch (x0 / 16) {
        case 0: NANO_DQ_DIAG(1); break;
        case 1: NANO_DQ_DIAG(2); break;
        case 2: NANO_DQ_DIAG(3); break;
        default: NANO_DQ_DIAG(4); break;
      }
#undef NANO_DQ_DIAG
    }
  }
  store_rows<D>(dq + ((int64_t)b * Sq * H + h) * D, (int64_t)H * D,
                sQ + row0 * C::LDS, dqa, scale, m0 + x0, Sq, lane);
  clk.mark(kClkEpilogue);
  clk.flush(0);
}

// ---- dk, dv: a block per (K tile, KV head, batch row); warp w owns the
// 16 keys from 16 w.  Loop over the rep query heads and, for each, the
// query tiles from the first that sees a key of the tile on: the only sum
// across blocks that dk, dv need is over those, so it stays inside the
// block, in a fixed order.  A tile of keys that no query sees (past off +
// Sq - 1) loops over nothing and stores zeros.

template <int D>
struct BwdKV {
  static constexpr int LDS = D + 8, TILE = kTile * LDS, NSTAGE = D <= 64 ? 3 : 2;
  static constexpr bool KEEP = D <= 64;   // K and V fragments held in registers
  // a stage: Q tile, dO tile, then lse and delta of its 64 rows (f32)
  static constexpr int STAGE = 2 * TILE * (int)sizeof(bf16) + 2 * kTile * (int)sizeof(float);
  static constexpr size_t smem = sizeof(bf16) * 2 * TILE + NSTAGE * STAGE;
};

// The 16-query pairs [P0, P1) of one (head, query tile) for a warp's 16
// keys: S^T = K Q^T, dP^T = V dO^T, P^T, dS^T as in dq_chunk with the rows
// now keys, then dV += P^T dO and dK += dS^T Q.  MASKED: a tile the
// diagonal crosses, where the query at position m0 + c (m0: the position of
// the tile's first query, offset included) may lie before the key.
template <int D, int P0, int P1, bool MASKED, bool KEEP>
__device__ __forceinline__ void dkdv_chunk(float (&dka)[D / 8][4], float (&dva)[D / 8][4],
                                           const uint32_t (&kf)[D / 16][4],
                                           const uint32_t (&vf)[D / 16][4],
                                           const bf16* __restrict__ sK, const bf16* __restrict__ sV,
                                           int row0, const bf16* __restrict__ sQ,
                                           const bf16* __restrict__ sdO,
                                           const float* __restrict__ sLse,
                                           const float* __restrict__ sDelta, float sl, int key_lo,
                                           int m0, int lane, Clk& clk) {
  constexpr int NB = 2 * (P1 - P0);
  float st[NB][4], dpt[NB][4];
  zero(st);
  zero(dpt);
  mma_held_rows<D, P0, P1, KEEP>(st, kf, sK, row0, sQ, lane);
  mma_held_rows<D, P0, P1, KEEP>(dpt, vf, sV, row0, sdO, lane);
  clk.mark(kClkScores);
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int c = 16 * P0 + 8 * j + 2 * t;   // columns c, c + 1 of the tile
    const float2 ls = *reinterpret_cast<const float2*>(sLse + c);
    const float2 de = *reinterpret_cast<const float2*>(sDelta + c);
    const float l2[2] = {ls.x * kLog2e, ls.y * kLog2e}, dd[2] = {de.x, de.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf(st[j][e], sl, -l2[e & 1]));
      if (MASKED && m0 + c + (e & 1) < key_lo + 8 * (e >> 1)) p = 0.f;
      st[j][e] = p;
      dpt[j][e] = p * (dpt[j][e] - dd[e & 1]);
    }
  }
  clk.mark(kClkSoftmax);
  mma_p_cols<D, P0, P1>(dva, st, sdO, lane);
  mma_p_cols<D, P0, P1>(dka, dpt, sQ, lane);
  clk.mark(kClkGrads);
}

// One (head, query tile) for the dk/dv block: the query pairs PMIN .. 3
// (PMIN = 0 below the diagonal or where it crosses the tile off its
// corners; on it, the warp's own index: the pairs before it lie wholly
// before its keys), in chunks of two pairs.
template <int D, int PMIN, bool MASKED, bool KEEP>
__device__ __forceinline__ void dkdv_tile(float (&dka)[D / 8][4], float (&dva)[D / 8][4],
                                          const uint32_t (&kf)[D / 16][4],
                                          const uint32_t (&vf)[D / 16][4],
                                          const bf16* __restrict__ sK, const bf16* __restrict__ sV,
                                          int row0, const bf16* __restrict__ sQ,
                                          const bf16* __restrict__ sdO,
                                          const float* __restrict__ sLse,
                                          const float* __restrict__ sDelta, float sl, int key_lo,
                                          int m0, int lane, Clk& clk) {
  if constexpr (PMIN < 2)
    dkdv_chunk<D, PMIN, 2, MASKED, KEEP>(dka, dva, kf, vf, sK, sV, row0, sQ, sdO, sLse, sDelta, sl,
                                         key_lo, m0, lane, clk);
  dkdv_chunk<D, (PMIN > 2 ? PMIN : 2), 4, MASKED, KEEP>(dka, dva, kf, vf, sK, sV, row0, sQ, sdO,
                                                        sLse, sDelta, sl, key_lo, m0, lane, clk);
}

// bf16 dk, dv.  Block (nt, kvh, b).  K and V tiles by cp.async, their A
// fragments into registers (D <= 64); the (head, query tile) pairs go
// round a ring of NSTAGE stages, each fetched NSTAGE - 1 steps ahead (Q,
// dO, and lse, delta 4 bytes a thread), one barrier a step.  Rows past Sq
// arrive as zeros (lse and delta too), so their P is 1 and their dO, dS
// zero: they add exactly nothing, and only the tiles the diagonal crosses
// are masked.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkdv_v3_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
                             int off, int H, int rep, Strides qs, Strides ks, Strides vs,
                             float scale) {
  using C = BwdKV<D>;
  constexpr int BM = kTile, TILE = C::TILE, NSTAGE = C::NSTAGE, STAGE = C::STAGE;
  constexpr bool KEEP = C::KEEP;
  Clk clk;
  clk.start();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + TILE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int nt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, KV = gridDim.y;
  const int n0 = nt * kTile, row0 = warp * 16;
  // the query tiles mt0 .. m_tiles - 1 see a key of this tile
  const int m_tiles = (Sq + BM - 1) / BM, mt0 = max(n0 - off, 0) / BM;
  const int per_r = max(m_tiles - mt0, 0), n_iter = rep * per_r;

  cp_tile16<kTile, D, kMmaThreads>(sK, k + b * ks.b + kvh * ks.h + (int64_t)n0 * ks.s, ks.s, Skv - n0);
  cp_tile16<kTile, D, kMmaThreads>(sV, v + b * vs.b + kvh * vs.h + (int64_t)n0 * vs.s, vs.s, Skv - n0);
  cp_async_commit();

  TileCopier<BM, D, kMmaThreads> q_copy, do_copy;
  q_copy.init(qs.s);
  do_copy.init((int64_t)H * D);
  const uint32_t ring_u32 = smem_u32(ring);
  auto fetch = [&](int it) {
    const int r = it / per_r, m0 = (mt0 + it - r * per_r) * BM, h = kvh * rep + r;
    const uint32_t st = ring_u32 + (it % NSTAGE) * STAGE;
    q_copy.copy(st, q + b * qs.b + h * qs.h + (int64_t)m0 * qs.s, Sq - m0);
    do_copy.copy(st + TILE * (int)sizeof(bf16), dout + ((int64_t)b * Sq + m0) * H * D + h * D,
                 Sq - m0);
    // threads 0-63: lse of row m0 + i; 64-127: delta
    const int i = threadIdx.x & (BM - 1);
    const bool ok = m0 + i < Sq;
    const float* src = (threadIdx.x < BM ? lse : delta) + ((int64_t)b * H + h) * Sq + m0 + (ok ? i : 0);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     st + 2 * TILE * (int)sizeof(bf16) + threadIdx.x * (int)sizeof(float)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {   // one group per step, empty past the last
    if (i < n_iter) fetch(i);
    cp_async_commit();
  }
  cp_async_wait<NSTAGE - 1>();   // K and V are in
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  if constexpr (KEEP) {
    load_a_frags<D>(kf, sK, row0, lane);
    load_a_frags<D>(vf, sV, row0, lane);
  }
  const float sl = scale * kLog2e;
  const int key_lo = n0 + row0 + g;
  float dka[D / 8][4], dva[D / 8][4];
  zero(dka);
  zero(dva);
  clk.mark(kClkPrologue);

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<NSTAGE - 2>();   // this thread's part of step it is in
    __syncthreads();               // everybody's is, and step it - 1 is read to its end
    if (it + NSTAGE - 1 < n_iter) fetch(it + NSTAGE - 1);   // into the stage of step it - 1
    cp_async_commit();
    clk.mark(kClkWait);
    const unsigned char* st = ring + (it % NSTAGE) * STAGE;
    const bf16* sQ = reinterpret_cast<const bf16*>(st);
    const bf16* sdO = sQ + TILE;
    const float* sLse = reinterpret_cast<const float*>(sdO + TILE);
    const float* sDelta = sLse + BM;
    const int pos0 = off + (mt0 + it % per_r) * BM;   // the tile's first query position
    if (pos0 >= n0 + BM - 1) {   // every query of the tile sees every key
      dkdv_tile<D, 0, false, KEEP>(dka, dva, kf, vf, sK, sV, row0, sQ, sdO, sLse, sDelta, sl,
                                   key_lo, pos0, lane, clk);
    } else if (pos0 != n0) {   // crossed off its corners
      dkdv_tile<D, 0, true, KEEP>(dka, dva, kf, vf, sK, sV, row0, sQ, sdO, sLse, sDelta, sl,
                                  key_lo, pos0, lane, clk);
    } else {   // the diagonal: query pairs wholly before the warp's keys are skipped
#define NANO_KV_DIAG(PM)                                                                       \
  dkdv_tile<D, PM, true, KEEP>(dka, dva, kf, vf, sK, sV, row0, sQ, sdO, sLse, sDelta, sl, key_lo, \
                               pos0, lane, clk)
      switch (warp) {
        case 0: NANO_KV_DIAG(0); break;
        case 1: NANO_KV_DIAG(1); break;
        case 2: NANO_KV_DIAG(2); break;
        default: NANO_KV_DIAG(3); break;
      }
#undef NANO_KV_DIAG
    }
  }
  const int64_t base = ((int64_t)b * Skv * KV + kvh) * D;
  store_rows<D>(dk + base, (int64_t)KV * D, sK + row0 * C::LDS, dka, scale, n0 + row0, Skv, lane);
  store_rows<D>(dv + base, (int64_t)KV * D, sV + row0 * C::LDS, dva, 1.f, n0 + row0, Skv, lane);
  clk.mark(kClkEpilogue);
  clk.flush(1);
}

// =====================================================================
// launches
// =====================================================================

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// blocks of `kernel` that fit one SM at once, by the runtime's occupancy
// calculator; -1 where it fails
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  int n = -1;
  if (allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return -1;
  return n;
}

template <int D, int HPB>
int launch_fwd_mma(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int B, int Sq,
                   int Skv, int off, int H, int KV, Strides qs, Strides ks, Strides vs, float scale,
                   cudaStream_t st) {
  using C = FwdMma<D, HPB>;
  // the kernel's per-thread copy offsets are 32-bit
  if (ks.s * kTile >= (1ll << 31) || vs.s * kTile >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<D, HPB>, C::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kTile - 1) / kTile, H / HPB, B);
  flash_fwd_mma_kernel<D, HPB><<<grid, C::THREADS, C::smem, st>>>(q, k, v, out, lse, Sq, Skv, off,
                                                                   H, H / KV, qs, ks, vs, scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
               int Skv, int off, int H, int KV, Strides qs, Strides ks, Strides vs, float scale,
               cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  T* out_ = static_cast<T*>(out);
  float* lse_ = static_cast<float*>(lse);
  if constexpr (sizeof(T) == 2) {
    // query heads of one KV head that a block serves: all of them for rep 1,
    // 2 and (D <= 64: shared memory for the Q rows) 4; else the largest of
    // 4, 2, 1 that divides rep, and a KV head's heads take rep / HPB blocks
    const int rep = H / KV;
    if constexpr (D <= 64) {
      if (rep % 4 == 0)
        return launch_fwd_mma<D, 4>(q_, k_, v_, out_, lse_, B, Sq, Skv, off, H, KV, qs, ks, vs,
                                    scale, st);
    }
    if (rep % 2 == 0)
      return launch_fwd_mma<D, 2>(q_, k_, v_, out_, lse_, B, Sq, Skv, off, H, KV, qs, ks, vs, scale,
                                  st);
    return launch_fwd_mma<D, 1>(q_, k_, v_, out_, lse_, B, Sq, Skv, off, H, KV, qs, ks, vs, scale,
                                st);
  } else {
    const dim3 grid((Sq + kTile - 1) / kTile, H, B);
    cudaError_t err = allow_smem(flash_fwd_kernel<D>, FwdCfg<D>::smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<D><<<grid, kThreads, FwdCfg<D>::smem, st>>>(q_, k_, v_, out_, lse_, Sq, Skv,
                                                                 off, H, H / KV, qs, ks, vs, scale);
    return (int)cudaGetLastError();
  }
}

template <int D, int HPB>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* out, const bf16* dout,
              const float* lse, float* delta, bf16* dq, int B, int Sq, int Skv, int off, int H, int KV,
              Strides qs, Strides ks, Strides vs, float scale, cudaStream_t st) {
  using C = BwdQ<D, HPB>;
  cudaError_t err = allow_smem(flash_bwd_dq_v3_kernel<D, HPB>, C::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kTile - 1) / kTile, H / HPB, B);
  flash_bwd_dq_v3_kernel<D, HPB><<<grid, C::THREADS, C::smem, st>>>(
      q, k, v, out, dout, lse, delta, dq, Sq, Skv, off, H, H / KV, qs, ks, vs, scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* lse,
               const void* dout, void* dq, void* dk, void* dv, void* delta, int B, int Sq, int Skv,
               int off, int H, int KV, Strides qs, Strides ks, Strides vs, float scale,
               cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* out_ = static_cast<const T*>(out);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  T* dq_ = static_cast<T*>(dq);
  T* dk_ = static_cast<T*>(dk);
  T* dv_ = static_cast<T*>(dv);
  const dim3 grid_kv((Skv + kTile - 1) / kTile, KV, B);
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    // the copiers' per-thread offsets are 32-bit
    if ((qs.s > ks.s ? qs.s : ks.s) * kTile >= (1ll << 31) || vs.s * kTile >= (1ll << 31) ||
        (int64_t)H * D * kTile >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    // dq first: it writes delta, which the dk/dv kernel reads.  Two query
    // heads a block where rep is even (K/V tiles fetched once for both),
    // but at D = 128, where shared memory would allow only one block an SM.
    int rc;
    if (D <= 64 && (H / KV) % 2 == 0)
      rc = launch_dq<D, (D <= 64 ? 2 : 1)>(q_, k_, v_, out_, do_, lse_, delta_, dq_, B, Sq, Skv,
                                          off, H, KV, qs, ks, vs, scale, st);
    else
      rc = launch_dq<D, 1>(q_, k_, v_, out_, do_, lse_, delta_, dq_, B, Sq, Skv, off, H, KV, qs, ks,
                           vs, scale, st);
    if (rc != 0) return rc;
    err = allow_smem(flash_bwd_dkdv_v3_kernel<D>, BwdKV<D>::smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_v3_kernel<D><<<grid_kv, kMmaThreads, BwdKV<D>::smem, st>>>(
        q_, k_, v_, do_, lse_, delta_, dk_, dv_, Sq, Skv, off, H, H / KV, qs, ks, vs, scale);
  } else {
    const int64_t n_rows = (int64_t)B * Sq * H;
    const int per_block = kThreads / 32;
    flash_delta_kernel<T><<<(unsigned)((n_rows + per_block - 1) / per_block), kThreads, 0, st>>>(
        out_, do_, delta_, n_rows, Sq, H, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_q((Sq + kTile - 1) / kTile, H, B);
    err = allow_smem(flash_bwd_dkdv_kernel<D>, DkvCfg<D>::smem);
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(flash_bwd_dq_kernel<D>, DqCfg<D>::smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, DkvCfg<D>::smem, st>>>(
        q_, k_, v_, do_, lse_, delta_, dk_, dv_, Sq, Skv, off, H, H / KV, qs, ks, vs, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<D><<<grid_q, kThreads, DqCfg<D>::smem, st>>>(
        q_, k_, v_, do_, lse_, delta_, dq_, Sq, Skv, off, H, H / KV, qs, ks, vs, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, out and the gradients share it).
// q: (B, Sq, H, D), k / v: (B, Skv, KV, D), each with D contiguous and its
// batch / position / head strides given in elements (16-byte aligned
// rows); out: contiguous (B, Sq, H, D); lse: f32 (B, H, Sq); query i sees
// keys 0 .. off + i (0 <= off <= Skv - Sq, which the caller checks).  D in
// {16, 32, 48, 64, 128}.  Launches on the caller's stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for a D or dtype not built).
#define NANO_FLASH_DISPATCH(CALL)                     \
  switch (dtype * 1000 + D) {                         \
    case 16: return CALL(16, float);                  \
    case 32: return CALL(32, float);                  \
    case 48: return CALL(48, float);                  \
    case 64: return CALL(64, float);                  \
    case 128: return CALL(128, float);                \
    case 1016: return CALL(16, __nv_bfloat16);        \
    case 1032: return CALL(32, __nv_bfloat16);        \
    case 1048: return CALL(48, __nv_bfloat16);        \
    case 1064: return CALL(64, __nv_bfloat16);        \
    case 1128: return CALL(128, __nv_bfloat16);       \
    default: return (int)cudaErrorInvalidValue;       \
  }

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int dtype, int B, int Sq, int Skv, int off, int H, int KV, int D,
                              long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                              long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                              long long v_sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
#define NANO_FWD(DD, TT) \
  launch_fwd<DD, TT>(q, k, v, out, lse, B, Sq, Skv, off, H, KV, qs, ks, vs, scale, st)
  NANO_FLASH_DISPATCH(NANO_FWD)
#undef NANO_FWD
}

// The backward of flash_attn_fwd: out, lse as it wrote them; dout, dq, dk,
// dv contiguous in the layouts of out, q, k, v (dk, dv over all Skv keys);
// delta: f32 scratch (B, H, Sq).  bf16: two launches (dq with delta, then
// dk/dv); f32: three (delta, dk/dv, dq).  No atomics.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* lse, const void* dout, void* dq, void* dk, void* dv,
                              void* delta, int dtype, int B, int Sq, int Skv, int off, int H,
                              int KV, int D, long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                              long long v_ss, long long v_sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
#define NANO_BWD(DD, TT)                                                                         \
  launch_bwd<DD, TT>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, off, H, KV, qs, ks, vs, \
                     scale, st)
  NANO_FLASH_DISPATCH(NANO_BWD)
#undef NANO_BWD
}

// Blocks of the bf16 forward kernel for (D, heads per block) that fit one
// SM at once, by the runtime's occupancy calculator; -1 for a pair not built.
extern "C" int flash_attn_fwd_blocks_per_sm(int D, int hpb) {
#define NANO_OCC(DD, HH)                                                                      \
  if (D == DD && hpb == HH)                                                                   \
    return blocks_per_sm(flash_fwd_mma_kernel<DD, HH>, FwdMma<DD, HH>::THREADS,               \
                         FwdMma<DD, HH>::smem);
  NANO_OCC(16, 1) NANO_OCC(16, 2) NANO_OCC(16, 4) NANO_OCC(32, 1) NANO_OCC(32, 2)
  NANO_OCC(32, 4) NANO_OCC(48, 1) NANO_OCC(48, 2) NANO_OCC(48, 4) NANO_OCC(64, 1)
  NANO_OCC(64, 2) NANO_OCC(64, 4) NANO_OCC(128, 1) NANO_OCC(128, 2)
#undef NANO_OCC
  return -1;
}

// The same for the bf16 backward: the dq kernel with hpb query heads a
// block (1, or 2 for D <= 64), or with hpb = 0 the dk/dv kernel.
extern "C" int flash_attn_bwd_blocks_per_sm(int D, int hpb) {
#define NANO_OCC_D(DD)                                                                      \
  if (D == DD && hpb == 0)                                                                  \
    return blocks_per_sm(flash_bwd_dkdv_v3_kernel<DD>, kMmaThreads, BwdKV<DD>::smem);       \
  if (D == DD && hpb == 1)                                                                  \
    return blocks_per_sm(flash_bwd_dq_v3_kernel<DD, 1>, BwdQ<DD, 1>::THREADS,               \
                         BwdQ<DD, 1>::smem);                                                \
  if (D == DD && hpb == 2)                                                                   \
    return blocks_per_sm(flash_bwd_dq_v3_kernel<DD, 2>, BwdQ<DD, 2>::THREADS, BwdQ<DD, 2>::smem);
  NANO_OCC_D(16) NANO_OCC_D(32) NANO_OCC_D(48) NANO_OCC_D(64)
#undef NANO_OCC_D
  if (D == 128 && hpb == 0)
    return blocks_per_sm(flash_bwd_dkdv_v3_kernel<128>, kMmaThreads, BwdKV<128>::smem);
  if (D == 128 && hpb == 1)
    return blocks_per_sm(flash_bwd_dq_v3_kernel<128, 1>, BwdQ<128, 1>::THREADS,
                         BwdQ<128, 1>::smem);
  return -1;
}

#ifdef NANO_BWD_CLOCKS
// Reads and zeroes the phase cycle counts: out[0..5] dq, out[6..11] dk/dv
// (prologue, waits, score products, softmax, gradient products, epilogue).
extern "C" int flash_attn_bwd_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_bwd_clocks, sizeof(g_bwd_clocks));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zeros[2][kClkN] = {};
  return (int)cudaMemcpyToSymbol(g_bwd_clocks, zeros, sizeof(zeros));
}
#endif
