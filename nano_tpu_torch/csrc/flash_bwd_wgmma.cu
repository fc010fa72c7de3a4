// K4's bf16 backward on Hopper's warpgroup products, its tiles brought in by
// TMA (sm_90a), bound to Python through ctypes (nano_tpu_torch/ops/
// flash_attn.py: flash_attn_bwd, its kernels chosen by bwd_route).
//
// Replaces the backward of nano_tpu/models/gpt.py::_flash_attend (the
// Pallas flash attention's custom_vjp) for bf16 at D <= 64: in the form a
// rank of sequence parallelism needs (Sq queries at positions off .. off +
// Sq - 1 against Skv >= off + Sq keys; the JAX package gets it from GSPMD's
// partition of its attention) and for the whole sequence (off = 0, Sq =
// Skv) at D >= 32, where it beats csrc/flash_attn.cu's two mma.sync passes
// (the first design).  Those keep D = 128 and the whole sequence at D = 16
// (the route, ops/flash_attn.py:bwd_route).  Per batch row b and query
// head h = kv * rep + r, with P = exp(S - lse) from the forward's lse:
//
//     dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta),  delta = rowsum(dO * out)
//     dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D)
//
// Bound on the H100 at phase 10d's rank (B = 8, Sq = 256 at offset 256,
// Skv = 512, H = 16, KV = 8, D = 48): 25.3 MB a call, 7.6 us; the five
// products 6.1 us at 989 TFLOP/s.  Two passes recompute S and dP (seven
// products), so ~8.6 us is this design's floor.  The mma.sync passes took
// ~54 us a call there: a block's prologue, barriers, and the issue of mma.sync,
// ldmatrix and per-thread cp.async addresses (flash_attn.cu's note).  Here:
//   * one thread of a block issues every copy by TMA (one instruction a
//     column block, no address arithmetic anywhere else) into a ring of
//     three stages on full / empty mbarriers, refilling a stage once every
//     warp has arrived on its empty barrier; a copy's wait that lasts ~17 s
//     traps (wgmma_tma.cuh), so a fault raises and never hangs the card;
//   * a warpgroup a 64-row tile runs wgmma m64nNk16 with f32 accumulators:
//     S and dP with both operands from shared memory, then P (and dS) from
//     the accumulators straight into the next product's A fragments in
//     registers (rounded to bf16 as the plain version rounds them), against
//     the same shared tile read transposed (MN-major) as B; the dV product
//     runs while dS is computed.  No producer warp: its registers would cost
//     a block an SM, and the warpgroups a block issue their copies ahead
//     themselves;
//   * the dq pass leaves each query tile's 64 lse (exp2 units) and delta in
//     one 512-byte row (stats_at), which the dk/dv pass takes by one bulk
//     copy a step; the dk/dv pass is a programmatic dependent of the dq pass
//     (PDL): its blocks start as the dq pass's retire and fetch K, V and
//     their first Q, dO tiles before griddepcontrol.wait, the statistics
//     after it;
//   * both grids are 1-D in block_order's order: where a grid fits two
//     waves, the tiles with the longest loops start first.
// Measured (chip_smoke.py bench routes, NVIDIA H100 80GB HBM3): 0.76 of the
// mma.sync passes' time at 10d's shape, 0.80 / 0.86 at the training
// shapes (D = 48 / 32), 0.74 at D = 64 on both, 0.98 at D = 16 on 10d's
// rank and 1.10 at the calculator's whole sequence of 64; clock64 puts the
// dq pass's time ~31% in its prologue (the inputs streaming from memory in
// one wave) and the dk/dv pass's ~37% in P and dS,
// ~21% waiting for its stages: latency, three warpgroups an SM (registers)
// being too few to hide it.  Tried and slower: a producer warp, four
// stages, four dk/dv blocks an SM (spills), each k-step's product issued as
// soon as its P is, the next step's S and dP issued behind dK.
// Shared layout per D (wgmma_tma.cuh: TileLayout): a 64-row tile in one
// column block of 16 (D = 16, 32-byte swizzle), 32 (D = 32, 64-byte) or 64
// elements (D = 48 and 64, 128-byte; at D = 48 the 96-byte rows padded to
// 128, the pad TMA's out-of-bounds zeros, which the products never read);
// one TMA box of E x 64 a block, and the descriptors' offsets (8 rows 8 W
// bytes apart; a K-major k-step 32 bytes along the row, an MN-major one 16
// rows down) are those of the same layout.  D = 128 stays on the mma.sync
// passes: dK and dV of 64 x 128 in f32 are 128 registers a thread, and S, dP 64
// more.
//
// flash_bwd_dq_wgmma    block (query tile, HPB heads of a KV head, batch
//                       row): a warpgroup a head over the K/V tiles that its
//                       queries see (their stages shared); delta = rowsum(dO
//                       * out) in its prologue, left with lse for the dk/dv
//                       pass.
// flash_bwd_dkdv_wgmma  block (key tile, KV head, batch row): one warpgroup
//                       over the (query head, query tile) steps that see a
//                       key of its tile, heads outer, tiles inner: every sum
//                       in a fixed order, no atomics, two runs bit-equal.  A
//                       key tile no query sees stores zeros.
// Rows past Sq (or Skv) arrive as zeros (TMA's out-of-bounds fill; lse and
// delta 0), so their P is 1 and their dO, dS zero: they add nothing.  Only
// the tiles the shifted diagonal crosses are masked, at any offset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using wg::block_order;
using wg::Clk;
using wg::fast_exp2;
using wg::kLog2e;
using wg::kTile;
using wg::quad_sum;

// the phases' cycle counts of the two passes (wgmma_tma.cuh: Clk), in a
// build with -DNANO_BWD_CLOCKS
#ifdef NANO_BWD_CLOCKS
__device__ unsigned long long g_wg_clocks[2][wg::kClkN];   // [dq, dkdv][phase]
#endif
__device__ __forceinline__ unsigned long long* clocks_of(int pass) {
#ifdef NANO_BWD_CLOCKS
  return g_wg_clocks[pass];
#else
  return nullptr;
#endif
}

// ---------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------

// The row statistics the dq pass leaves for the dk/dv pass: for each (batch
// row, head, query tile) 64 lse in exp2 units then 64 delta, f32, zeros
// past Sq, so that a step's 512 bytes come in one bulk copy.
__device__ __forceinline__ int64_t stats_at(int64_t bh, int m_tiles, int mt) {
  return (bh * m_tiles + mt) * 2 * kTile;
}

template <int D>
struct KvCfg {
  using L = wg::TileLayout<D>;
  static constexpr int TILE = L::TILE_BYTES, NSTAGE = 3, THREADS = 128;
  // K, V; NSTAGE x (Q, dO); NSTAGE x (lse2, delta) of 64 rows; the barriers
  // (full and empty a stage, K/V)
  static constexpr int STAGES = 2 * TILE;
  static constexpr int STATS = STAGES + NSTAGE * 2 * TILE;
  static constexpr int BARS = STATS + NSTAGE * 2 * kTile * (int)sizeof(float);
  static constexpr int SMEM = BARS + (2 * NSTAGE + 1) * 8 + 1024;
};

// One warpgroup a block; its thread 0 issues every copy: K and V once, a
// stage a step NSTAGE steps ahead (Q, dO, the step's statistics), each
// stage refilled once all four warps have arrived on its empty barrier.
template <int D>
__global__ void __launch_bounds__(KvCfg<D>::THREADS, 3)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const float* __restrict__ stats_g, bf16* __restrict__ dk,
                                bf16* __restrict__ dv, int Sq, int Skv, int off, int H, int KV,
                                int spread, float scale) {
  using C = KvCfg<D>;
  constexpr int TILE = C::TILE, NSTAGE = C::NSTAGE, NA = D / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + C::STATS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* empty = full + NSTAGE;
  uint64_t* kv_bar = empty + NSTAGE;
  // a 1-D grid in the order of block_order: key tile nt of the pair
  // (KV head, batch row) p
  const int rep = H / KV, n_kt = (Skv + kTile - 1) / kTile;
  int nt, p;
  block_order(blockIdx.x, n_kt, spread, nt, p);
  const int kvh = p % KV, b = p / KV;
  const int n0 = nt * kTile;
  // the query tiles mt0 .. m_tiles - 1 see a key of this tile; none where
  // its first key lies past the last query's position
  const int m_tiles = (Sq + kTile - 1) / kTile, mt0 = max(n0 - off, 0) / kTile;
  const int per_r = n0 > off + Sq - 1 ? 0 : m_tiles - mt0, n_iter = rep * per_r;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NSTAGE; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&empty[i], 4);   // the warps
    }
    wg::mbar_init(kv_bar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  // step it: head r = it / per_r, query tile mt0 + it % per_r; its tiles,
  // then (the dq pass's output) its statistics
  auto fill_tiles = [&](int it) {
    const int s = it % NSTAGE, r = it / per_r, mt = mt0 + it - r * per_r, h = kvh * rep + r;
    unsigned char* sq = smem + C::STAGES + s * 2 * TILE;
    wg::mbar_arrive_expect_tx(&full[s], 2 * TILE + 2 * kTile * (int)sizeof(float));
    wg::load_tile<D>(sq, &tq, &full[s], mt * kTile, h, b);
    wg::load_tile<D>(sq + TILE, &tdo, &full[s], mt * kTile, h, b);
  };
  auto fill_stats = [&](int it) {
    const int s = it % NSTAGE, r = it / per_r, mt = mt0 + it - r * per_r, h = kvh * rep + r;
    bulk::bulk_copy(stats + s * 2 * kTile, stats_g + stats_at((int64_t)b * H + h, m_tiles, mt),
                    2 * kTile * (int)sizeof(float), &full[s]);
  };
  if (threadIdx.x == 0 && n_iter > 0) {
    wg::mbar_arrive_expect_tx(kv_bar, 2 * TILE);
    wg::load_tile<D>(smem, &tk, kv_bar, n0, kvh, b);
    wg::load_tile<D>(smem + TILE, &tv, kv_bar, n0, kvh, b);
    const int first = min(NSTAGE, n_iter);
    for (int i = 0; i < first; ++i) fill_tiles(i);
    // launched as a programmatic dependent of the dq pass: what came so far
    // was its inputs' (in flight while it ends); the statistics are its own
    asm volatile("griddepcontrol.wait;" ::: "memory");
    for (int i = 0; i < first; ++i) fill_stats(i);
  }

  // warp w owns the keys n0 + 16 w .. n0 + 16 w + 15
  Clk clk;
  clk.start();
  const int g = lane >> 2, t = lane & 3;
  float dka[NA], dva[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
  if (n_iter > 0) {
    const float sl = scale * kLog2e;
    const int key_lo = n0 + 16 * warp + g;   // this thread's keys: key_lo, key_lo + 8
    const uint32_t sK = wg::shared_addr(smem), sV = sK + TILE;
    wg::mbar_wait(kv_bar, 0);
    clk.mark(wg::kClkPrologue);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % NSTAGE;
      // the stage of step it - 1, once every warp is done with it, takes
      // step it - 1 + NSTAGE
      if (threadIdx.x == 0 && it > 0 && it - 1 + NSTAGE < n_iter) {
        wg::mbar_wait(&empty[(it - 1) % NSTAGE], ((it - 1) / NSTAGE) & 1);
        fill_tiles(it - 1 + NSTAGE);
        fill_stats(it - 1 + NSTAGE);
      }
      wg::mbar_wait(&full[s], (it / NSTAGE) & 1);
      clk.mark(wg::kClkWait);
      const uint32_t sQ = sK + C::STAGES + s * 2 * TILE, sdO = sQ + TILE;
      const float* l2 = stats + s * 2 * kTile;
      const float* dl = l2 + kTile;
      const int r = it / per_r;
      const int pos0 = off + (mt0 + it - r * per_r) * kTile;   // the tile's first query
      // S^T = K Q^T and dP^T = V dO^T: rows keys, columns the tile's queries
      float st[32], dpt[32];
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wg::mma_ss_n64(st, wg::desc_k<D>(sK, ks), wg::desc_k<D>(sQ, ks), ks);
      wg::commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wg::mma_ss_n64(dpt, wg::desc_k<D>(sV, ks), wg::desc_k<D>(sdO, ks), ks);
      wg::commit();
      wg::wait<1>();
      wg::hold(st);
      clk.mark(wg::kClkScores);
      // P^T = 2^(S^T sl - lse2), zero where the query lies before the key
      // (only in a tile the diagonal crosses), into the A fragments of the
      // dV product
      const bool masked = pos0 < n0 + kTile - 1;
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 lv = *reinterpret_cast<const float2*>(l2 + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(fmaf(st[4 * j + e], sl, -((e & 1) ? lv.y : lv.x)));
            if (masked && pos0 + c + (e & 1) < key_lo + 8 * (e >> 1)) p = 0.f;
            st[4 * j + e] = p;
          }
        }
        wg::pack_a(pa[kk], st, kk);
      }
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::mma_rs<D>(dva, pa[kk], wg::desc_mn<D>(sdO, kk), 1);
      wg::commit();
      wg::wait<1>();   // dP^T is in
      wg::hold(dpt);
      // dS^T = P^T (dP^T - delta) while dV += P^T dO runs; then dK += dS^T Q
      uint32_t sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
        }
        wg::pack_a(sa[kk], dpt, kk);
      }
      clk.mark(wg::kClkSoftmax);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::mma_rs<D>(dka, sa[kk], wg::desc_mn<D>(sQ, kk), 1);
      wg::commit();
      wg::wait<0>();
      wg::hold(dva);
      wg::hold(dka);
      wg::hold(pa);
      wg::hold(sa);
      clk.mark(wg::kClkGrads);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&empty[s]);   // the warp is done with the stage
    }
  }
  // dK (scaled) and dV rounded to bf16, rows past Skv not stored
  const int64_t base = ((int64_t)b * Skv * KV + kvh) * D, rs = (int64_t)KV * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + 16 * warp + g + 8 * i;
    if (n >= Skv) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int64_t at = base + n * rs + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + at) =
          wg::pack_bf16(dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) = wg::pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  }
  clk.mark(wg::kClkEpilogue);
  clk.flush(clocks_of(1));
}

// ---------------------------------------------------------------------
// dq (and the row statistics)
// ---------------------------------------------------------------------

template <int D, int HPB>
struct QCfg {
  using L = wg::TileLayout<D>;
  static constexpr int TILE = L::TILE_BYTES, NSTAGE = 3;
  static constexpr int THREADS = 128 * HPB;   // a warpgroup a head
  static constexpr int MIN_BLOCKS = HPB == 1 ? 3 : D <= 48 ? 2 : 1;
  // Q of each head, dO of each head; NSTAGE x (K, V); the barriers (full
  // and empty a stage, Q and dO)
  static constexpr int RING = 2 * HPB * TILE;
  static constexpr int BARS = RING + NSTAGE * 2 * TILE;
  static constexpr int SMEM = BARS + (2 * NSTAGE + 1) * 8 + 1024;
};

// Thread 0 issues every copy: Q and dO of the HPB heads once, K and V a
// stage a tile NSTAGE tiles ahead, a stage refilled once every warp of
// the block has arrived on its empty barrier.
template <int D, int HPB>
__global__ void __launch_bounds__(QCfg<D, HPB>::THREADS, QCfg<D, HPB>::MIN_BLOCKS)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const bf16* __restrict__ out, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, float* __restrict__ stats_g,
                              bf16* __restrict__ dq, int Sq, int Skv, int off, int H, int rep,
                              int spread, float scale) {
  using C = QCfg<D, HPB>;
  constexpr int TILE = C::TILE, NSTAGE = C::NSTAGE, NA = D / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* empty = full + NSTAGE;
  uint64_t* qd_bar = empty + NSTAGE;
  // a 1-D grid in the order of block_order, the query tiles from the last
  // (the longest loops first): tile mt of the pair (head group, batch row) p
  const int m_tiles = (Sq + kTile - 1) / kTile, groups = H / HPB;
  int mt, p;
  block_order(blockIdx.x, m_tiles, spread, mt, p);
  mt = m_tiles - 1 - mt;
  const int h0 = p % groups * HPB, b = p / groups;
  const int kvh = h0 / rep, m0 = mt * kTile;
  // the dk/dv pass, a programmatic dependent of this one, may start its
  // blocks as this grid's retire (it waits for all of it before it reads
  // the statistics)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  // the key tiles up to the last key the block's last row sees; tiles
  // 0 .. n_full - 1 every row sees whole
  const int n_tiles = (off + min(m0 + kTile - 1, Sq - 1)) / kTile + 1;
  const int n_full = (off + m0 + 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NSTAGE; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&empty[i], 4 * HPB);   // every warp
    }
    wg::mbar_init(qd_bar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  auto fill = [&](int nt) {
    const int s = nt % NSTAGE;
    unsigned char* sk = smem + C::RING + s * 2 * TILE;
    wg::mbar_arrive_expect_tx(&full[s], 2 * TILE);
    wg::load_tile<D>(sk, &tk, &full[s], nt * kTile, kvh, b);
    wg::load_tile<D>(sk + TILE, &tv, &full[s], nt * kTile, kvh, b);
  };
  if (threadIdx.x == 0) {
    wg::mbar_arrive_expect_tx(qd_bar, 2 * HPB * TILE);
#pragma unroll
    for (int r = 0; r < HPB; ++r) {
      wg::load_tile<D>(smem + r * TILE, &tq, qd_bar, m0, h0 + r, b);
      wg::load_tile<D>(smem + (HPB + r) * TILE, &tdo, qd_bar, m0, h0 + r, b);
    }
    for (int i = 0; i < NSTAGE && i < n_tiles; ++i) fill(i);
  }

  // warpgroup wgi: head h; its warp w owns the rows 16 w .. 16 w + 15
  Clk clk;
  clk.start();
  const int wgi = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int h = h0 + wgi;
  const int64_t bh = (int64_t)b * H + h;
  // this thread's rows row_lo, row_lo + 8: lse (exp2 units) and delta =
  // rowsum(dO * out) from global memory while the tiles are in flight, the
  // quad's four parts summed in a fixed order; both left for the dk/dv pass
  const int x_lo = 16 * w + g, row_lo = m0 + x_lo;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    float part = 0.f;
    lse2[i] = 0.f;
    if (row < Sq) {
      lse2[i] = lse[bh * Sq + row] * kLog2e;
      const int64_t at = (((int64_t)b * Sq + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + at + 8 * j));
        const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + at + 8 * j));
        part = fmaf(d.y, o.y, fmaf(d.x, o.x, part));
      }
    }
    dl[i] = quad_sum(part);
    if (t == 0) {
      float* st = stats_g + stats_at(bh, m_tiles, mt);
      st[x_lo + 8 * i] = lse2[i];
      st[kTile + x_lo + 8 * i] = dl[i];
    }
  }
  const float sl = scale * kLog2e;
  const int pos_lo = off + row_lo;   // the position of this thread's first row
  const uint32_t base = wg::shared_addr(smem);
  const uint32_t sQ = base + wgi * TILE, sdO = base + (HPB + wgi) * TILE;
  float dqa[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dqa[i] = 0.f;
  wg::mbar_wait(qd_bar, 0);
  clk.mark(wg::kClkPrologue);
  for (int nt = 0; nt < n_tiles; ++nt) {
    const int s = nt % NSTAGE, n0 = nt * kTile;
    if (threadIdx.x == 0 && nt > 0 && nt - 1 + NSTAGE < n_tiles) {
      wg::mbar_wait(&empty[(nt - 1) % NSTAGE], ((nt - 1) / NSTAGE) & 1);
      fill(nt - 1 + NSTAGE);
    }
    wg::mbar_wait(&full[s], (nt / NSTAGE) & 1);
    clk.mark(wg::kClkWait);
    const uint32_t sK = base + C::RING + s * 2 * TILE, sV = sK + TILE;
    // S = Q K^T and dP = dO V^T
    float sc[32], dp[32];
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wg::mma_ss_n64(sc, wg::desc_k<D>(sQ, ks), wg::desc_k<D>(sK, ks), ks);
    wg::commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wg::mma_ss_n64(dp, wg::desc_k<D>(sdO, ks), wg::desc_k<D>(sV, ks), ks);
    wg::commit();
    wg::wait<1>();
    wg::hold(sc);
    clk.mark(wg::kClkScores);
    // P = 2^(S sl - lse2), zero past the row's position (only in a tile the
    // diagonal crosses)
    const bool masked = nt >= n_full;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(sc[4 * j + e], sl, -lse2[e >> 1]));
        if (masked && n0 + 8 * j + 2 * t + (e & 1) > pos_lo + 8 * (e >> 1)) p = 0.f;
        sc[4 * j + e] = p;
      }
    wg::wait<0>();
    wg::hold(dp);
    // dS = P (dP - delta), into the A fragments of dQ += dS K
    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 2 * kk; j < 2 * kk + 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]);
      wg::pack_a(sa[kk], dp, kk);
    }
    clk.mark(wg::kClkSoftmax);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::mma_rs<D>(dqa, sa[kk], wg::desc_mn<D>(sK, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::hold(dqa);
    wg::hold(sa);
    clk.mark(wg::kClkGrads);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[s]);   // the warp is done with the stage
  }
  // dQ (scaled) rounded to bf16, rows past Sq not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    if (row >= Sq) continue;
    bf16* drow = dq + (((int64_t)b * Sq + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(drow + 8 * j) =
          wg::pack_bf16(dqa[4 * j + 2 * i] * scale, dqa[4 * j + 2 * i + 1] * scale);
  }
  clk.mark(wg::kClkEpilogue);
  clk.flush(clocks_of(0));
}

// =====================================================================
// launches
// =====================================================================

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Strides {   // elements between batch rows, positions and heads; D is contiguous
  long long b, s, h;
};

// the four maps: q and dout (B, Sq, H, D), k and v (B, Skv, KV, D)
template <int D>
int encode_maps(CUtensorMap (&m)[4], const void* q, const void* dout, const void* k, const void* v,
                int B, int Sq, int Skv, int H, int KV, Strides qs, Strides ks, Strides vs) {
  int rc = wg::encode_rows<D>(&m[0], q, B, Sq, H, qs.b, qs.s, qs.h);
  if (rc == 0)
    rc = wg::encode_rows<D>(&m[1], dout, B, Sq, H, (long long)Sq * H * D, (long long)H * D, D);
  if (rc == 0) rc = wg::encode_rows<D>(&m[2], k, B, Skv, KV, ks.b, ks.s, ks.h);
  if (rc == 0) rc = wg::encode_rows<D>(&m[3], v, B, Skv, KV, vs.b, vs.s, vs.h);
  return rc;
}

// bit 0 of `passes`: the dq pass; bit 1: the dk/dv pass, launched as a
// programmatic dependent of the launch before it on the stream (the dq
// pass; a CUDA-graph capture keeps the edge).  The four tensor maps are
// encoded once for both.
template <int D, int HPB>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* stats, bf16* dq, bf16* dk, bf16* dv, int B, int Sq,
               int Skv, int off, int H, int KV, Strides qs, Strides ks, Strides vs, float scale,
               int spread_q, int spread_kv, int passes, cudaStream_t st) {
  using QC = QCfg<D, HPB>;
  using KC = KvCfg<D>;
  const int m_tiles = (Sq + kTile - 1) / kTile, q_pairs = H / HPB * B;
  const int n_tiles = (Skv + kTile - 1) / kTile, kv_pairs = KV * B;
  if (passes < 1 || passes > 3 || spread_q < 1 || q_pairs % spread_q || spread_kv < 1 ||
      kv_pairs % spread_kv)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  int rc = encode_maps<D>(m, q, dout, k, v, B, Sq, Skv, H, KV, qs, ks, vs);
  if (rc != 0) return rc;
  if (passes & 1) {
    cudaError_t err = allow_smem(flash_bwd_dq_wgmma_kernel<D, HPB>, QC::SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_wgmma_kernel<D, HPB><<<m_tiles * q_pairs, QC::THREADS, QC::SMEM, st>>>(
        m[0], m[1], m[2], m[3], static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
        lse, stats, dq, Sq, Skv, off, H, H / KV, spread_q, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    cudaError_t err = allow_smem(flash_bwd_dkdv_wgmma_kernel<D>, KC::SMEM);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_tiles * kv_pairs);
    cfg.blockDim = dim3(KC::THREADS);
    cfg.dynamicSmemBytes = KC::SMEM;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_wgmma_kernel<D>, m[0], m[1], m[2], m[3],
                             (const float*)stats, dk, dv, Sq, Skv, off, H, KV, spread_kv, scale);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// The head widths the passes are built for; others return
// cudaErrorInvalidValue.
#define NANO_WG_DISPATCH(CALL) \
  switch (D) {                 \
    case 16: return CALL(16);  \
    case 32: return CALL(32);  \
    case 48: return CALL(48);  \
    case 64: return CALL(64);  \
    default: return (int)cudaErrorInvalidValue; \
  }

// bf16 only.  q: (B, Sq, H, D), k / v: (B, Skv, KV, D), each with D
// contiguous and its batch / position / head strides given in elements
// (multiples of 8, 16-byte aligned base); out, dout, dq contiguous (B, Sq,
// H, D); lse f32 (B, H, Sq); dk, dv contiguous (B, Skv, KV, D), zero for
// keys no query sees; query i sees keys 0 .. off + i.  stats: f32 scratch
// of B * H * ceil(Sq / 64) * 128, which the dq pass writes (lse in exp2
// units and delta = rowsum(dout * out), 64 of each a query tile) and the
// dk/dv pass reads.  hpb: query heads a dq block (1, or 2 where it divides
// H / KV); spread_q, spread_kv: block_order's spread of each grid (a
// divisor of its pairs).  passes: 3 both passes, the dk/dv pass a
// programmatic dependent of the dq pass; 1 or 2 one of them alone, for a
// measurement's split (the dk/dv pass on stats an earlier dq pass left).
// Launches on the caller's stream and returns 0, a CUDA error, or
// cudaErrorInvalidValue for a D not built, an hpb, spread or passes out of
// range, or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int flash_bwd_wgmma(const void* q, const void* k, const void* v, const void* out,
                               const void* lse, const void* dout, void* dq, void* dk, void* dv,
                               void* stats, int B, int Sq, int Skv, int off, int H, int KV, int D,
                               int hpb, int spread_q, int spread_kv, int passes, long long q_sb,
                               long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  if ((hpb != 1 && hpb != 2) || (H / KV) % hpb) return (int)cudaErrorInvalidValue;
#define NANO_BWD(DD)                                                                             \
  (hpb == 2 ? launch_bwd<DD, 2>(q, k, v, out, dout, static_cast<const float*>(lse),             \
                                static_cast<float*>(stats), static_cast<bf16*>(dq),             \
                                static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, off, \
                                H, KV, qs, ks, vs, scale, spread_q, spread_kv, passes, st)     \
            : launch_bwd<DD, 1>(q, k, v, out, dout, static_cast<const float*>(lse),             \
                                static_cast<float*>(stats), static_cast<bf16*>(dq),             \
                                static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, off, \
                                H, KV, qs, ks, vs, scale, spread_q, spread_kv, passes, st))
  NANO_WG_DISPATCH(NANO_BWD)
#undef NANO_BWD
}

// Dynamic shared memory (bytes, with the 1024 of alignment slack) of a
// pass as built: pass 0 the dq pass with hpb heads a block, pass 1 the
// dk/dv pass; -1 for what is not built.
extern "C" int flash_bwd_wgmma_smem(int D, int pass, int hpb) {
#define NANO_SMEM(DD)                                                              \
  (pass == 1 ? KvCfg<DD>::SMEM                                                     \
             : hpb == 1 ? QCfg<DD, 1>::SMEM : hpb == 2 ? QCfg<DD, 2>::SMEM : -1)
  switch (D) {
    case 16: return NANO_SMEM(16);
    case 32: return NANO_SMEM(32);
    case 48: return NANO_SMEM(48);
    case 64: return NANO_SMEM(64);
    default: return -1;
  }
#undef NANO_SMEM
}

// Blocks of a pass that fit one SM at once, by the runtime's occupancy
// calculator (pass and hpb as above); -1 where it fails.
extern "C" int flash_bwd_wgmma_blocks_per_sm(int D, int pass, int hpb) {
  int n = -1;
#define NANO_OCC(KERNEL, THREADS, SMEM_)                                                    \
  if (allow_smem(KERNEL, SMEM_) != cudaSuccess ||                                           \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, KERNEL, THREADS, SMEM_) != cudaSuccess) \
    return -1;                                                                              \
  return n;
#define NANO_OCC_D(DD)                                                                      \
  if (D == DD && pass == 1) { NANO_OCC(flash_bwd_dkdv_wgmma_kernel<DD>, KvCfg<DD>::THREADS, KvCfg<DD>::SMEM) } \
  if (D == DD && pass == 0 && hpb == 1) {                                                    \
    NANO_OCC((flash_bwd_dq_wgmma_kernel<DD, 1>), (QCfg<DD, 1>::THREADS), (QCfg<DD, 1>::SMEM)) \
  }                                                                                          \
  if (D == DD && pass == 0 && hpb == 2) {                                                    \
    NANO_OCC((flash_bwd_dq_wgmma_kernel<DD, 2>), (QCfg<DD, 2>::THREADS), (QCfg<DD, 2>::SMEM)) \
  }
  NANO_OCC_D(16) NANO_OCC_D(32) NANO_OCC_D(48) NANO_OCC_D(64)
#undef NANO_OCC_D
#undef NANO_OCC
  return -1;
}

#ifdef NANO_BWD_CLOCKS
// Reads and zeroes the phase cycle counts: out[0..5] dq, out[6..11] dk/dv
// (prologue, waits, score products, softmax, gradient products, epilogue).
extern "C" int flash_bwd_wgmma_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_wg_clocks, sizeof(g_wg_clocks));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zeros[2][wg::kClkN] = {};
  return (int)cudaMemcpyToSymbol(g_wg_clocks, zeros, sizeof(zeros));
}
#endif
