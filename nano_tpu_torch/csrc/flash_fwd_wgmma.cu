// K4's bf16 forward on Hopper's warpgroup products, its tiles brought in by
// TMA (sm_90a), bound to Python through ctypes (nano_tpu_torch/ops/
// flash_attn.py: flash_attn_fwd, its kernel chosen by fwd_route).
//
// Replaces the forward of nano_tpu/models/gpt.py::_flash_attend (the
// bundled Pallas flash attention, :257) for bf16 at D <= 64: in the form a
// rank of sequence parallelism needs (Sq queries at positions off .. off +
// Sq - 1 against Skv >= off + Sq keys; the JAX package gets it from GSPMD's
// partition of its attention) and for the whole sequence (off = 0, Sq =
// Skv), wherever it beats csrc/flash_attn.cu's mma.sync kernel (the first
// design, which keeps D = 128 and what the route sends it).  Per batch row
// b and query head h = kv * rep + r:
//
//     out[b, s, h] = softmax_{t <= off + s}(q[b, s, h] . k[b, t, kv] / sqrt(D)) @ v[b, :, kv]
//     lse[b, h, s] = log sum_{t <= off + s} exp(q[b, s, h] . k[b, t, kv] / sqrt(D))
//
// Bound on the H100 at phase 10d's rank (B = 8, Sq = 256 at offset 256,
// Skv = 512, H = 16, KV = 8, D = 48): 12.7 MB a call, 3.8 us; the two
// products 1.9 us at 989 TFLOP/s.  The mma.sync kernel took ~19 us a call
// there: every thread copies its share of each K/V tile by cp.async (the
// addresses its own instructions), one __syncthreads a tile, and the
// softmax and both products of a warp in series (flash_attn.cu's note).
// Here:
//   * a block takes one 64-row query tile of HPB query heads of one KV
//     head, a consumer warpgroup a head, so each K/V tile is fetched once
//     for every head of the block;
//   * thread 0 issues every copy by TMA (one instruction a column block):
//     Q once a head, then the K and V tiles into a ring of NSTAGE stages,
//     K and V each on a barrier of its own (S waits for K alone),
//     refilling a stage once every warp has arrived on its empty barrier;
//     a wait that lasts ~17 s traps (wgmma_tma.cuh), so a fault raises and
//     never hangs the card;
//   * a warpgroup runs S = Q K^T as wgmma m64n64k16 with both operands
//     from shared memory (K-major), the online softmax on the accumulators
//     (exp2, running maximum and sum in f32), and O += P V as wgmma
//     m64nDk16 with P from the accumulators straight into the A fragments
//     in registers (rounded to bf16 as the plain version rounds its
//     probabilities) against the V tile read MN-major;
//   * the products and the softmax overlap in FA3's order: tile n's S is
//     issued, O is rescaled for tile n - 1 and its P V product issued, and
//     tile n's softmax runs while that product does; no product is in
//     flight across an iteration (ptxas serializes one that is: C7515);
//   * tiles wholly visible to the block's first row run unmasked; the one
//     or two that the shifted diagonal crosses are masked element by
//     element, the others never compared; the products themselves are
//     warpgroup-wide, so on the diagonal tile the part above the diagonal is
//     multiplied and masked, not skipped; a tile past Skv holds TMA's
//     out-of-bounds zeros, which the mask hides from every stored row;
//   * the epilogue stages a warpgroup's 64 output rows, row-major, in its
//     own Q tile and sends them out by one TMA store (rows past Sq dropped),
//     and writes lse (natural log) per row;
//   * the grid is 1-D in block_order's order: where it fits two waves, the
//     query tiles with the longest loops start first.  No atomics: two runs
//     give the same bits.
// Measured (chip_smoke.py bench routes, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.76 of the mma.sync kernel's time at 10d's rank, 0.81 at the training
// shape (D = 48), 0.76 / 0.84 at D = 64, 0.85 / 0.86 at D = 32, 0.88 at
// D = 16 on 10d's rank and 0.97 at the calculator's whole sequence of 64,
// so the route (ops/flash_attn.py:fwd_route) takes it for every bf16
// forward it is built for.  Two heads a block beat one wherever the heads
// of a KV head are even, but for the whole sequence at D = 32.  Slower,
// and gone: the softmax and the products in series (up to 1.07x this
// design's time), and a producer warp issuing the copies (up to 1.28x:
// nine warps a block hold two blocks an SM to 96 registers a thread, and
// spill).  The clock stamps of `bench routes clocks` put most of a warp's
// time in the softmax and in waiting for its tiles (at the training shape
// also in the prologue, a block's Q and first tiles arriving): latency,
// two blocks of two warpgroups an SM (registers) being too few to hide it.
// Shared layout per D as in flash_bwd_wgmma.cu (wgmma_tma.cuh: TileLayout).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using wg::kLog2e;
using wg::kTile;

// the phases' cycle counts (wgmma_tma.cuh: Clk), in a build with
// -DNANO_BWD_CLOCKS
#ifdef NANO_BWD_CLOCKS
__device__ unsigned long long g_fwd_clocks[wg::kClkN];
#endif
__device__ __forceinline__ unsigned long long* fwd_clocks() {
#ifdef NANO_BWD_CLOCKS
  return g_fwd_clocks;
#else
  return nullptr;
#endif
}

template <int D, int HPB>
struct FwdCfg {
  using L = wg::TileLayout<D>;
  static constexpr int TILE = L::TILE_BYTES, NSTAGE = 3;
  static constexpr int THREADS = 128 * HPB, MIN_BLOCKS = HPB == 2 ? 2 : 4;
  // Q of each head; NSTAGE x (K, V); the barriers (K full, V full and
  // empty a stage, Q a head)
  static constexpr int RING = HPB * TILE;
  static constexpr int BARS = RING + NSTAGE * 2 * TILE;
  static constexpr int SMEM = BARS + (3 * NSTAGE + HPB) * 8 + 1024;
  static_assert(64 * D * 2 <= TILE, "a head's 64 output rows fit in its Q tile");
};

// The online softmax step of a thread's two rows (row_lo + 8 i at position
// pos_lo + 8 i) over key tile n0 .. n0 + 63, its raw scores s in the
// accumulator layout.  MASKED (a tile the diagonal crosses): a key past
// the row's position scores -inf.  Afterwards s holds p = 2^((s - m) sl),
// 0 where masked (ex2 of -inf); mi the running maximum of the raw scores
// (finite from tile 0 on, whose key 0 every row sees), li this thread's
// share of the running sum, and corr the factor by which the O summed so
// far must be rescaled.
template <bool MASKED>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&mi)[2], float (&li)[2],
                                             float (&corr)[2], float sl, int n0, int pos_lo,
                                             int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[4] = {mi[i], -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * i + c];
        if (MASKED && n0 + 8 * j + 2 * t + c > pos_lo + 8 * i) x = -INFINITY;
        mx[j & 3] = fmaxf(mx[j & 3], x);
      }
    float m_new = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));
    corr[i] = wg::fast_exp2((mi[i] - m_new) * sl);
    const float shift = m_new * sl;
    mi[i] = m_new;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * i + c];
        x = wg::fast_exp2(fmaf(x, sl, -shift));
        part[j & 3] += x;
      }
    li[i] = li[i] * corr[i] + ((part[0] + part[1]) + (part[2] + part[3]));
  }
}

// softmax_step for key tile nt: masked from tile n_full on
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&mi)[2], float (&li)[2],
                                             float (&corr)[2], float sl, int nt, int n_full,
                                             int pos_lo, int t) {
  if (nt >= n_full)
    softmax_step<true>(s, mi, li, corr, sl, nt * kTile, pos_lo, t);
  else
    softmax_step<false>(s, mi, li, corr, sl, nt * kTile, pos_lo, t);
}

// o (an m64nD accumulator) *= corr of its row
template <int NA>
__device__ __forceinline__ void rescale(float (&o)[NA], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// S = Q K^T of the tiles at sQ, sK into d: issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_scores(float (&d)[32], uint32_t sQ, uint32_t sK) {
  wg::fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wg::mma_ss_n64(d, wg::desc_k<D>(sQ, ks), wg::desc_k<D>(sK, ks), ks);
  wg::commit();
}

// O += P V, P in the A fragments pa, V the tile at sV: issued and committed
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[4][4], uint32_t sV) {
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::mma_rs<D>(o, pa[kk], wg::desc_mn<D>(sV, kk), 1);
  wg::commit();
}

template <int D, int HPB>
__global__ void __launch_bounds__(FwdCfg<D, HPB>::THREADS, FwdCfg<D, HPB>::MIN_BLOCKS)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tout, float* __restrict__ lse,
                           int Sq, int off, int H, int rep, int spread, float scale) {
  using C = FwdCfg<D, HPB>;
  constexpr int TILE = C::TILE, NSTAGE = C::NSTAGE, NA = D / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* vfull = kfull + NSTAGE;
  uint64_t* empty = vfull + NSTAGE;
  uint64_t* qbar = empty + NSTAGE;
  // a 1-D grid in the order of block_order, the query tiles from the last
  // (the longest loops first): tile mt of the pair (head group, batch row) p
  const int m_tiles = (Sq + kTile - 1) / kTile, groups = H / HPB;
  int mt, p;
  wg::block_order(blockIdx.x, m_tiles, spread, mt, p);
  mt = m_tiles - 1 - mt;
  const int h0 = p % groups * HPB, b = p / groups;
  const int kvh = h0 / rep, m0 = mt * kTile;
  // the key tiles up to the last key the block's last row sees; tiles
  // 0 .. n_full - 1 every row sees whole
  const int n_tiles = (off + min(m0 + kTile - 1, Sq - 1)) / kTile + 1;
  const int n_full = (off + m0 + 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NSTAGE; ++i) {
      wg::mbar_init(&kfull[i], 1);
      wg::mbar_init(&vfull[i], 1);
      wg::mbar_init(&empty[i], 4 * HPB);   // every warp
    }
#pragma unroll
    for (int r = 0; r < HPB; ++r) wg::mbar_init(&qbar[r], 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  // key tile nt into its stage: K and V, each on its barrier
  auto load_kv = [&](int nt) {
    const int s = nt % NSTAGE;
    unsigned char* sk = smem + C::RING + s * 2 * TILE;
    wg::mbar_arrive_expect_tx(&kfull[s], TILE);
    wg::load_tile<D>(sk, &tk, &kfull[s], nt * kTile, kvh, b);
    wg::mbar_arrive_expect_tx(&vfull[s], TILE);
    wg::load_tile<D>(sk + TILE, &tv, &vfull[s], nt * kTile, kvh, b);
  };
  // Q of each head, then the first NSTAGE key tiles (the rest as stages
  // are freed: refill)
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < HPB; ++r) {
      wg::mbar_arrive_expect_tx(&qbar[r], TILE);
      wg::load_tile<D>(smem + r * TILE, &tq, &qbar[r], m0, h0 + r, b);
    }
    for (int nt = 0; nt < NSTAGE && nt < n_tiles; ++nt) load_kv(nt);
  }

  // warpgroup wgi: head h; its warp w owns the rows 16 w .. 16 w + 15
  wg::Clk clk;
  clk.start();
  const int wgi = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int h = h0 + wgi;
  const int row_lo = m0 + 16 * w + g;   // this thread's rows: row_lo, row_lo + 8
  const int pos_lo = off + row_lo;      // and their positions
  const float sl = scale * kLog2e;
  const uint32_t base = wg::shared_addr(smem);
  const uint32_t sQ = base + wgi * TILE, ring = base + C::RING;
  auto sK = [&](int nt) { return ring + (nt % NSTAGE) * 2 * TILE; };
  auto wait_k = [&](int nt) { wg::mbar_wait(&kfull[nt % NSTAGE], (nt / NSTAGE) & 1); };
  auto wait_v = [&](int nt) { wg::mbar_wait(&vfull[nt % NSTAGE], (nt / NSTAGE) & 1); };
  // the warp is done with key tile nt: its stage may take tile nt + NSTAGE
  auto release = [&](int nt) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[nt % NSTAGE]);
  };
  // thread 0 refills the stage of tile r (every warp has released it)
  // with tile r + NSTAGE
  auto refill = [&](int r) {
    if (threadIdx.x == 0 && r >= 0 && r + NSTAGE < n_tiles) {
      wg::mbar_wait(&empty[r % NSTAGE], (r / NSTAGE) & 1);
      load_kv(r + NSTAGE);
    }
  };
  float o[NA], mi[2] = {-INFINITY, -INFINITY}, li[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int i = 0; i < NA; ++i) o[i] = 0.f;
  uint32_t pa[4][4];   // P of a tile, the A fragments of its P V product
  wg::mbar_wait(&qbar[wgi], 0);
  clk.mark(wg::kClkPrologue);

  // Tile nt's S is issued before the P V product of tile nt - 1, and tile
  // nt's softmax runs while that product does; O is rescaled for tile
  // nt - 1 just before its product (the factor that tile's softmax left).
  // No product is in flight across an iteration.
  {
    wait_k(0);
    clk.mark(wg::kClkWait);
    float sc[32];
    issue_scores<D>(sc, sQ, sK(0));
    wg::wait<0>();
    wg::hold(sc);
    clk.mark(wg::kClkScores);
    softmax_tile(sc, mi, li, corr, sl, 0, n_full, pos_lo, t);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a(pa[kk], sc, kk);
    clk.mark(wg::kClkSoftmax);
  }
  for (int nt = 1; nt < n_tiles; ++nt) {
    refill(nt - 2);
    wait_k(nt);
    clk.mark(wg::kClkWait);
    float sc[32];
    issue_scores<D>(sc, sQ, sK(nt));
    rescale(o, corr);
    wait_v(nt - 1);
    clk.mark(wg::kClkWait);
    issue_pv<D>(o, pa, sK(nt - 1) + TILE);
    wg::wait<1>();
    wg::hold(sc);
    clk.mark(wg::kClkScores);
    softmax_tile(sc, mi, li, corr, sl, nt, n_full, pos_lo, t);
    clk.mark(wg::kClkSoftmax);
    wg::wait<0>();
    wg::hold(o);
    wg::hold(pa);
    clk.mark(wg::kClkGrads);
    release(nt - 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a(pa[kk], sc, kk);
  }
  rescale(o, corr);
  wait_v(n_tiles - 1);
  clk.mark(wg::kClkWait);
  issue_pv<D>(o, pa, sK(n_tiles - 1) + TILE);
  wg::wait<0>();
  wg::hold(o);
  wg::hold(pa);
  clk.mark(wg::kClkGrads);

  // out = O / l rounded to bf16, staged row-major [64][D] in the warpgroup's
  // Q tile (free: every product that read it has completed in every warp of
  // the warpgroup) and sent out by one TMA store; lse per row
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    li[i] = wg::quad_sum(li[i]);
    inv[i] = 1.f / li[i];
  }
  wg::bar_sync(1 + wgi, 128);
  bf16* so = reinterpret_cast<bf16*>(smem + wgi * TILE);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* srow = so + (16 * w + g + 8 * i) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(srow + 8 * j) =
          wg::pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
  }
  wg::fence_async_shared();
  wg::bar_sync(1 + wgi, 128);
  if ((threadIdx.x & 127) == 0) wg::store_tile(&tout, so, m0, h, b);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      if (row < Sq) lse[((int64_t)b * H + h) * Sq + row] = mi[i] * scale + logf(li[i]);
    }
  }
  clk.mark(wg::kClkEpilogue);
  clk.flush(fwd_clocks());
}

// =====================================================================
// launches
// =====================================================================

struct Strides {   // elements between batch rows, positions and heads; D is contiguous
  long long b, s, h;
};

template <int D, int HPB>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
               int Skv, int off, int H, int KV, Strides qs, Strides ks, Strides vs, float scale,
               int spread, cudaStream_t st) {
  using C = FwdCfg<D, HPB>;
  const int m_tiles = (Sq + kTile - 1) / kTile, pairs = H / HPB * B;
  if (spread < 1 || pairs % spread) return (int)cudaErrorInvalidValue;
  // q, k, v read through their strides; out contiguous (B, Sq, H, D)
  CUtensorMap m[4];
  int rc = wg::encode_rows<D>(&m[0], q, B, Sq, H, qs.b, qs.s, qs.h);
  if (rc == 0) rc = wg::encode_rows<D>(&m[1], k, B, Skv, KV, ks.b, ks.s, ks.h);
  if (rc == 0) rc = wg::encode_rows<D>(&m[2], v, B, Skv, KV, vs.b, vs.s, vs.h);
  if (rc == 0)
    rc = wg::encode_rows<D>(&m[3], out, B, Sq, H, (long long)Sq * H * D, (long long)H * D, D, true);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, HPB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wgmma_kernel<D, HPB><<<m_tiles * pairs, C::THREADS, C::SMEM, st>>>(
      m[0], m[1], m[2], m[3], lse, Sq, off, H, H / KV, spread, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// CALL(D, hpb) for the head widths and heads a block built (hpb 1 or
// 2); FAIL for others.
#define NANO_FWD_DISPATCH(CALL, FAIL)                   \
  switch ((hpb == 1 || hpb == 2) ? D * 4 + hpb : 0) {   \
    case 16 * 4 + 1: return CALL(16, 1);                \
    case 16 * 4 + 2: return CALL(16, 2);                \
    case 32 * 4 + 1: return CALL(32, 1);                \
    case 32 * 4 + 2: return CALL(32, 2);                \
    case 48 * 4 + 1: return CALL(48, 1);                \
    case 48 * 4 + 2: return CALL(48, 2);                \
    case 64 * 4 + 1: return CALL(64, 1);                \
    case 64 * 4 + 2: return CALL(64, 2);                \
    default: return FAIL;                               \
  }

// bf16 only.  q: (B, Sq, H, D), k / v: (B, Skv, KV, D), each with D
// contiguous and its batch / position / head strides given in elements
// (multiples of 8, 16-byte aligned base); out contiguous (B, Sq, H, D)
// bf16, lse f32 (B, H, Sq); query i sees keys 0 .. off + i (0 <= off <=
// Skv - Sq, which the caller checks).  hpb: query heads a block (1, or 2
// where it divides H / KV); spread: block_order's spread of the grid (a
// divisor of H / hpb * B).  Launches on the caller's stream and returns
// 0, a CUDA error, or cudaErrorInvalidValue for a D not built, an hpb or
// spread out of range, or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                               int B, int Sq, int Skv, int off, int H, int KV, int D, int hpb,
                               int spread, long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                               long long v_ss, long long v_sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  if (KV < 1 || H % KV || (hpb > 0 && (H / KV) % hpb)) return (int)cudaErrorInvalidValue;
#define NANO_FWD(DD, HH)                                                                      \
  launch_fwd<DD, HH>(q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, off, H, KV, qs, ks, vs, \
                     scale, spread, st)
  NANO_FWD_DISPATCH(NANO_FWD, (int)cudaErrorInvalidValue)
#undef NANO_FWD
}

// Dynamic shared memory (bytes, with the 1024 of alignment slack) of the
// kernel with hpb query heads a block; -1 for what is not built.
extern "C" int flash_fwd_wgmma_smem(int D, int hpb) {
#define NANO_SMEM(DD, HH) FwdCfg<DD, HH>::SMEM
  NANO_FWD_DISPATCH(NANO_SMEM, -1)
#undef NANO_SMEM
}

// Blocks of the kernel (D, hpb) that fit one SM at once, by the runtime's
// occupancy calculator; -1 where it fails or is not built.
extern "C" int flash_fwd_wgmma_blocks_per_sm(int D, int hpb) {
  int n = -1;
#define NANO_OCC(DD, HH)                                                                          \
  (cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DD, HH>,                                           \
                        cudaFuncAttributeMaxDynamicSharedMemorySize, FwdCfg<DD, HH>::SMEM) ||     \
           cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_wgmma_kernel<DD, HH>,      \
                                                         FwdCfg<DD, HH>::THREADS,                 \
                                                         FwdCfg<DD, HH>::SMEM)                    \
       ? -1                                                                                       \
       : n)
  NANO_FWD_DISPATCH(NANO_OCC, -1)
#undef NANO_OCC
}

#ifdef NANO_BWD_CLOCKS
// Reads and zeroes the phase cycle counts (prologue, waits, the S product,
// the softmax, the P V product, epilogue).
extern "C" int flash_fwd_wgmma_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_fwd_clocks, sizeof(g_fwd_clocks));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zeros[wg::kClkN] = {};
  return (int)cudaMemcpyToSymbol(g_fwd_clocks, zeros, sizeof(zeros));
}
#endif
