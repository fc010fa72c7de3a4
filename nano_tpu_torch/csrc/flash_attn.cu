// Full-sequence causal GQA flash attention for Hopper (sm_90a), forward and
// backward, bound to Python through ctypes (nano_tpu_torch/ops/flash_attn.py).
//
// Replaces the TPU path nano_tpu/models/gpt.py::_flash_attend, which hands
// the no-cache (training) attention to the bundled Pallas flash_attention
// and its backward kernels.  Same function, per batch row b and query head
// h = kv * rep + r:
//
//     out[b, s, h] = softmax_t<=s( q[b, s, h] . k[b, t, kv] / sqrt(D) ) @ v[b, :, kv]
//
// and its gradient, without ever holding an (S, S) matrix in device memory.
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
//   bf16  mma.sync m16n8k16 tiles with f32 accumulators: 4 warps, each
//         owning 16 rows of the block's 64; A fragments by ldmatrix, B
//         fragments by 32-bit loads where the product runs along a tile's
//         rows and by ldmatrix.trans where it runs down its columns, so no
//         tile is ever stored transposed; P (and dS) go from the score
//         accumulators straight into the next product's A fragments,
//         rounded to bf16 as the plain version rounds its probabilities.
//         Tiles are loaded synchronously; wgmma, TMA and a pipelined ring
//         of tiles are later work.
//   f32   the oracle type: f32 tiles, products as CUDA-core FMAs from
//         shared memory with a 4 x (cols / 16) register tile per thread
//         (row-major tiles with an odd leading dimension: a walk along a
//         row or down a column is free of bank conflicts).
//
// flash_attn_fwd   one block per (query tile, head, batch row); loop over
//                  the K/V tiles up to the diagonal with an online softmax
//                  (running max and sum in f32); writes out and the row
//                  log-sum-exp lse (B, H, S).
// flash_attn_bwd   delta = rowsum(dout * out); then P = exp(S - lse) is
//                  recomputed tile by tile, twice: a block that owns a
//                  (K tile, KV head, batch row) loops over the rep query
//                  heads and the query tiles at or below the diagonal for
//                  dk, dv; a block that owns a (query tile, head, batch row)
//                  loops over the K tiles for dq.  No atomics: every sum is
//                  taken in a fixed order, so two runs agree bit for bit.
//
// Inputs f32 or bf16 (accumulation always f32); D in {16, 48, 64, 128};
// any S (the ragged last tile is masked).

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
                     float* __restrict__ out, float* __restrict__ lse, int S, int H, int rep,
                     Strides qs, Strides ks, Strides vs, float scale) {
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
  load_tile<BM, D>(sQ, q + b * qs.b + h * qs.h + (int64_t)m0 * qs.s, qs.s, S - m0);
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

  const int n_tiles = min((S + BN - 1) / BN, (m0 + BM - 1) / BN + 1);
  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * BN;
    __syncthreads();   // the tile before is read to its end
    load_tile<BN, D>(sK, kb + (int64_t)n0 * ks.s, ks.s, S - n0);
    load_tile<BN, D>(sV, vb + (int64_t)n0 * vs.s, vs.s, S - n0);
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
        const float x = (col > row || col >= S) ? -INFINITY : s[i][j] * scale;
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
    if (row >= S) continue;
    const float inv = 1.f / li[i];
    float* orow = out + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) orow[tx + 16 * j] = o[i][j] * inv;
    if (tx == 0) lse[((int64_t)b * H + h) * S + row] = mi[i] + logf(li[i]);
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
                          float* __restrict__ dk, float* __restrict__ dv, int S, int H, int rep,
                          Strides qs, Strides ks, Strides vs, float scale) {
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
  load_tile<BN, D>(sK, k + b * ks.b + kvh * ks.h + (int64_t)n0 * ks.s, ks.s, S - n0);
  load_tile<BN, D>(sV, v + b * vs.b + kvh * vs.h + (int64_t)n0 * vs.s, vs.s, S - n0);

  float dka[4][ND], dva[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int m_tiles = (S + BM - 1) / BM;
  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dout + (int64_t)b * S * H * D + (int64_t)h * D;
    const float* lse_b = lse + ((int64_t)b * H + h) * S;
    const float* delta_b = delta + ((int64_t)b * H + h) * S;
    for (int mt = n0 / BM; mt < m_tiles; ++mt) {
      const int m0 = mt * BM;
      __syncthreads();   // the tile before is read to its end
      load_tile<BM, D>(sQ, qb + (int64_t)m0 * qs.s, qs.s, S - m0);
      load_tile<BM, D>(sdO, dob + (int64_t)m0 * H * D, (int64_t)H * D, S - m0);
      if (threadIdx.x < BM) {
        const int m = m0 + threadIdx.x;
        sLse[threadIdx.x] = m < S ? lse_b[m] : 0.f;
        sDelta[threadIdx.x] = m < S ? delta_b[m] : 0.f;
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
          const bool seen = m >= n && m < S && n < S;
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
    if (n >= S) continue;
    const int64_t base = (((int64_t)b * S + n) * KV + kvh) * D;
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
                        const float* __restrict__ delta, float* __restrict__ dq, int S, int H,
                        int rep, Strides qs, Strides ks, Strides vs, float scale) {
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
  load_tile<BM, D>(sQ, q + b * qs.b + h * qs.h + (int64_t)m0 * qs.s, qs.s, S - m0);
  load_tile<BM, D>(sdO, dout + ((int64_t)b * S + m0) * H * D + (int64_t)h * D, (int64_t)H * D,
                   S - m0);
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  float dqa[4][ND], lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    lse_r[i] = row < S ? lse[((int64_t)b * H + h) * S + row] : 0.f;
    delta_r[i] = row < S ? delta[((int64_t)b * H + h) * S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) dqa[i][j] = 0.f;
  }

  const int n_tiles = min((S + BN - 1) / BN, (m0 + BM - 1) / BN + 1);
  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * BN;
    __syncthreads();   // the tile before is read to its end
    load_tile<BN, D>(sK, kb + (int64_t)n0 * ks.s, ks.s, S - n0);
    load_tile<BN, D>(sV, vb + (int64_t)n0 * vs.s, vs.s, S - n0);
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
        const bool seen = col <= row && col < S && row < S;
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
    if (row >= S) continue;
    float* drow = dq + (((int64_t)b * S + row) * H + h) * D;
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

// two 8 x 8 matrices, each handed out transposed (lanes 0-15 give the rows)
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// A ROWS x D bf16 tile -> shared memory [ROWS][D + 8] (the 16 bytes of
// padding keep fragment loads off each other's banks); rows at or past
// `valid` read as zero.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile16(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                            int64_t row_stride, int valid) {
  constexpr int LDS = D + 8, CH = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = (idx - r * CH) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + (int64_t)r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = x;
  }
}

// c[j] += A B^T for the warp's 16 rows of sA (from row0) against the 64 rows
// of sB: both tiles are walked along their rows (k = the D columns).
template <int D>
__device__ __forceinline__ void mma_rows_rows(float (&c)[8][4], const bf16* __restrict__ sA,
                                              int row0, const bf16* __restrict__ sB, int lane) {
  constexpr int LDS = D + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, sA + (row0 + (lane & 15)) * LDS + 16 * ks + ((lane >> 4) << 3));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* bp = sB + (8 * j + g) * LDS + 16 * ks + 2 * t;
      mma_bf16(c[j], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[jd] += P M for the warp's 16 x 64 block P, held in the accumulator
// layout of mma_rows_rows and rounded to bf16 here, against the 64 x D tile
// sM walked down its columns (k = its 64 rows).
template <int D>
__device__ __forceinline__ void mma_regs_cols(float (&acc)[D / 8][4], const float (&p)[8][4],
                                              const bf16* __restrict__ sM, int lane) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack2(p[2 * kk][0], p[2 * kk][1]), pack2(p[2 * kk][2], p[2 * kk][3]),
                           pack2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, sM + (16 * kk + (lane & 15)) * LDS + 8 * jd);
      mma_bf16(acc[jd], a, b0, b1);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// the warp's 16 x D accumulator block, scaled, -> rows row0 + g and + 8 of a
// tensor whose rows lie row_stride elements apart
template <int D>
__device__ __forceinline__ void store_block(bf16* __restrict__ dst, int64_t row_stride,
                                            const float (&acc)[D / 8][4], float s_lo, float s_hi,
                                            int row_lo, int n_rows, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    if (row_lo < n_rows)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)row_lo * row_stride + 8 * jd + 2 * t) =
          pack2(acc[jd][0] * s_lo, acc[jd][1] * s_lo);
    if (row_lo + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)(row_lo + 8) * row_stride + 8 * jd + 2 * t) =
          pack2(acc[jd][2] * s_hi, acc[jd][3] * s_hi);
  }
}

template <int D>
struct MmaCfg {
  static constexpr int LDS = D + 8, TILE = kTile * LDS;   // elements of one 64-row tile
  static constexpr size_t fwd_smem = sizeof(bf16) * 3 * TILE;
  static constexpr size_t dq_smem = sizeof(bf16) * 4 * TILE;
  static constexpr size_t dkdv_smem = sizeof(bf16) * 4 * TILE + sizeof(float) * 2 * kTile;
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int S, int H, int rep, Strides qs, Strides ks,
                         Strides vs, float scale) {
  constexpr int BM = kTile, BN = kTile, TILE = MmaCfg<D>::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + TILE;
  bf16* sV = sK + TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / rep, m0 = mt * BM;
  load_tile16<BM, D>(sQ, q + b * qs.b + h * qs.h + (int64_t)m0 * qs.s, qs.s, S - m0);
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const float sl = scale * kLog2e;
  const int row_lo = m0 + warp * 16 + g;          // this thread's rows: row_lo, row_lo + 8

  float o[D / 8][4], mi[2] = {-INFINITY, -INFINITY}, li[2] = {0.f, 0.f};
  zero(o);

  const int n_tiles = min((S + BN - 1) / BN, (m0 + BM - 1) / BN + 1);
  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * BN;
    __syncthreads();   // the tile before is read to its end
    load_tile16<BN, D>(sK, kb + (int64_t)n0 * ks.s, ks.s, S - n0);
    load_tile16<BN, D>(sV, vb + (int64_t)n0 * vs.s, vs.s, S - n0);
    __syncthreads();
    float s[8][4];
    zero(s);
    mma_rows_rows<D>(s, sQ, warp * 16, sK, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_lo + 8 * hh;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * t + e;
          const float x = (col > row || col >= S) ? -INFINITY : s[j][2 * hh + e] * sl;
          s[j][2 * hh + e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(mi[hh], quad_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(mi[hh] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * hh + e] - m_safe);
          s[j][2 * hh + e] = p;
          sum += p;
        }
      li[hh] = li[hh] * corr + quad_sum(sum);
      mi[hh] = m_new;
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        o[jd][2 * hh] *= corr;
        o[jd][2 * hh + 1] *= corr;
      }
    }
    mma_regs_cols<D>(o, s, sV, lane);
  }

  store_block<D>(out + ((int64_t)b * S * H + h) * D, (int64_t)H * D, o, 1.f / li[0], 1.f / li[1],
                 row_lo, S, lane);
  if (t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (row_lo + 8 * hh < S)
        lse[((int64_t)b * H + h) * S + row_lo + 8 * hh] = mi[hh] / kLog2e + logf(li[hh]);
  }
}

// bf16 dk, dv of one (K tile, KV head, batch row): transposed blocks, the
// warp's rows are keys, the columns queries
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int rep,
                              Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int BM = kTile, BN = kTile, TILE = MmaCfg<D>::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;
  bf16* sdO = sQ + TILE;
  float* sLse = reinterpret_cast<float*>(sdO + TILE);   // in exp2 units
  float* sDelta = sLse + BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, KV = gridDim.y;
  const int n0 = nt * BN;
  load_tile16<BN, D>(sK, k + b * ks.b + kvh * ks.h + (int64_t)n0 * ks.s, ks.s, S - n0);
  load_tile16<BN, D>(sV, v + b * vs.b + kvh * vs.h + (int64_t)n0 * vs.s, vs.s, S - n0);
  const float sl = scale * kLog2e;
  const int key_lo = n0 + warp * 16 + g;

  float dka[D / 8][4], dva[D / 8][4];
  zero(dka);
  zero(dva);

  const int m_tiles = (S + BM - 1) / BM;
  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* dob = dout + (int64_t)b * S * H * D + (int64_t)h * D;
    const float* lse_b = lse + ((int64_t)b * H + h) * S;
    const float* delta_b = delta + ((int64_t)b * H + h) * S;
    for (int mt = n0 / BM; mt < m_tiles; ++mt) {
      const int m0 = mt * BM;
      __syncthreads();   // the tile before is read to its end
      load_tile16<BM, D>(sQ, qb + (int64_t)m0 * qs.s, qs.s, S - m0);
      load_tile16<BM, D>(sdO, dob + (int64_t)m0 * H * D, (int64_t)H * D, S - m0);
      if (threadIdx.x < BM) {
        const int m = m0 + threadIdx.x;
        sLse[threadIdx.x] = m < S ? lse_b[m] * kLog2e : 0.f;
        sDelta[threadIdx.x] = m < S ? delta_b[m] : 0.f;
      }
      __syncthreads();
      float st[8][4], dpt[8][4];
      zero(st);
      zero(dpt);
      mma_rows_rows<D>(st, sK, warp * 16, sQ, lane);
      mma_rows_rows<D>(dpt, sV, warp * 16, sdO, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_lo + 8 * (e >> 1), mc = 8 * j + 2 * t + (e & 1), m = m0 + mc;
          const bool seen = m >= key && m < S && key < S;
          const float p = seen ? exp2f(st[j][e] * sl - sLse[mc]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - sDelta[mc]);
        }
      mma_regs_cols<D>(dva, st, sdO, lane);
      mma_regs_cols<D>(dka, dpt, sQ, lane);
    }
  }
  const int64_t base = ((int64_t)b * S * KV + kvh) * D;
  store_block<D>(dk + base, (int64_t)KV * D, dka, scale, scale, key_lo, S, lane);
  store_block<D>(dv + base, (int64_t)KV * D, dva, 1.f, 1.f, key_lo, S, lane);
}

// bf16 dq of one (query tile, head, batch row)
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dq, int S, int H, int rep, Strides qs, Strides ks,
                            Strides vs, float scale) {
  constexpr int BM = kTile, BN = kTile, TILE = MmaCfg<D>::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + TILE;
  bf16* sK = sdO + TILE;
  bf16* sV = sK + TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / rep, m0 = mt * BM;
  load_tile16<BM, D>(sQ, q + b * qs.b + h * qs.h + (int64_t)m0 * qs.s, qs.s, S - m0);
  load_tile16<BM, D>(sdO, dout + ((int64_t)b * S + m0) * H * D + (int64_t)h * D, (int64_t)H * D,
                     S - m0);
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const float sl = scale * kLog2e;
  const int row_lo = m0 + warp * 16 + g;

  float dqa[D / 8][4], lse_r[2], delta_r[2];
  zero(dqa);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + 8 * hh;
    lse_r[hh] = row < S ? lse[((int64_t)b * H + h) * S + row] * kLog2e : 0.f;
    delta_r[hh] = row < S ? delta[((int64_t)b * H + h) * S + row] : 0.f;
  }

  const int n_tiles = min((S + BN - 1) / BN, (m0 + BM - 1) / BN + 1);
  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * BN;
    __syncthreads();   // the tile before is read to its end
    load_tile16<BN, D>(sK, kb + (int64_t)n0 * ks.s, ks.s, S - n0);
    load_tile16<BN, D>(sV, vb + (int64_t)n0 * vs.s, vs.s, S - n0);
    __syncthreads();
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_rows_rows<D>(s, sQ, warp * 16, sK, lane);
    mma_rows_rows<D>(dp, sdO, warp * 16, sV, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, row = row_lo + 8 * hh, col = n0 + 8 * j + 2 * t + (e & 1);
        const bool seen = col <= row && col < S && row < S;
        const float p = seen ? exp2f(s[j][e] * sl - lse_r[hh]) : 0.f;
        dp[j][e] = p * (dp[j][e] - delta_r[hh]);
      }
    mma_regs_cols<D>(dqa, dp, sK, lane);
  }
  store_block<D>(dq + ((int64_t)b * S * H + h) * D, (int64_t)H * D, dqa, scale, scale, row_lo, S,
                 lane);
}

// =====================================================================
// launches
// =====================================================================

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
               int H, int KV, Strides qs, Strides ks, Strides vs, float scale, cudaStream_t st) {
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  T* out_ = static_cast<T*>(out);
  float* lse_ = static_cast<float*>(lse);
  if constexpr (sizeof(T) == 2) {
    cudaError_t err = allow_smem(flash_fwd_mma_kernel<D>, MmaCfg<D>::fwd_smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_mma_kernel<D><<<grid, kMmaThreads, MmaCfg<D>::fwd_smem, st>>>(
        q_, k_, v_, out_, lse_, S, H, H / KV, qs, ks, vs, scale);
  } else {
    cudaError_t err = allow_smem(flash_fwd_kernel<D>, FwdCfg<D>::smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<D><<<grid, kThreads, FwdCfg<D>::smem, st>>>(q_, k_, v_, out_, lse_, S, H,
                                                                 H / KV, qs, ks, vs, scale);
  }
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* lse,
               const void* dout, void* dq, void* dk, void* dv, void* delta, int B, int S, int H,
               int KV, Strides qs, Strides ks, Strides vs, float scale, cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  T* dq_ = static_cast<T*>(dq);
  T* dk_ = static_cast<T*>(dk);
  T* dv_ = static_cast<T*>(dv);
  const int64_t n_rows = (int64_t)B * S * H;
  const int per_block = kThreads / 32;
  flash_delta_kernel<T><<<(unsigned)((n_rows + per_block - 1) / per_block), kThreads, 0, st>>>(
      static_cast<const T*>(out), do_, delta_, n_rows, S, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((S + kTile - 1) / kTile, KV, B), grid_q((S + kTile - 1) / kTile, H, B);
  if constexpr (sizeof(T) == 2) {
    err = allow_smem(flash_bwd_dkdv_mma_kernel<D>, MmaCfg<D>::dkdv_smem);
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(flash_bwd_dq_mma_kernel<D>, MmaCfg<D>::dq_smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_mma_kernel<D><<<grid_kv, kMmaThreads, MmaCfg<D>::dkdv_smem, st>>>(
        q_, k_, v_, do_, lse_, delta_, dk_, dv_, S, H, H / KV, qs, ks, vs, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_mma_kernel<D><<<grid_q, kMmaThreads, MmaCfg<D>::dq_smem, st>>>(
        q_, k_, v_, do_, lse_, delta_, dq_, S, H, H / KV, qs, ks, vs, scale);
  } else {
    err = allow_smem(flash_bwd_dkdv_kernel<D>, DkvCfg<D>::smem);
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(flash_bwd_dq_kernel<D>, DqCfg<D>::smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, DkvCfg<D>::smem, st>>>(
        q_, k_, v_, do_, lse_, delta_, dk_, dv_, S, H, H / KV, qs, ks, vs, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<D><<<grid_q, kThreads, DqCfg<D>::smem, st>>>(
        q_, k_, v_, do_, lse_, delta_, dq_, S, H, H / KV, qs, ks, vs, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, out and the gradients share it).
// q: (B, S, H, D), k / v: (B, S, KV, D), each with D contiguous and its
// batch / position / head strides given in elements (16-byte aligned
// rows); out: contiguous (B, S, H, D); lse: f32 (B, H, S).  D in
// {16, 48, 64, 128}.  Launches on the caller's stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for a D or dtype not built).
#define NANO_FLASH_DISPATCH(CALL)                     \
  switch (dtype * 1000 + D) {                         \
    case 16: return CALL(16, float);                  \
    case 48: return CALL(48, float);                  \
    case 64: return CALL(64, float);                  \
    case 128: return CALL(128, float);                \
    case 1016: return CALL(16, __nv_bfloat16);        \
    case 1048: return CALL(48, __nv_bfloat16);        \
    case 1064: return CALL(64, __nv_bfloat16);        \
    case 1128: return CALL(128, __nv_bfloat16);       \
    default: return (int)cudaErrorInvalidValue;       \
  }

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int dtype, int B, int S, int H, int KV, int D, long long q_sb,
                              long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
#define NANO_FWD(DD, TT) launch_fwd<DD, TT>(q, k, v, out, lse, B, S, H, KV, qs, ks, vs, scale, st)
  NANO_FLASH_DISPATCH(NANO_FWD)
#undef NANO_FWD
}

// The backward of flash_attn_fwd: out, lse as it wrote them; dout, dq, dk,
// dv contiguous in the layouts of out, q, k, v; delta: f32 scratch
// (B, H, S).  Three launches (delta, dk/dv, dq), no atomics.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* lse, const void* dout, void* dq, void* dk, void* dv,
                              void* delta, int dtype, int B, int S, int H, int KV, int D,
                              long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                              long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                              long long v_sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
#define NANO_BWD(DD, TT) \
  launch_bwd<DD, TT>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, S, H, KV, qs, ks, vs, scale, st)
  NANO_FLASH_DISPATCH(NANO_BWD)
#undef NANO_BWD
}
