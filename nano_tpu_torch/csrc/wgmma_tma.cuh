// Hopper's warpgroup products and tensor-map copies, for the kernels that
// use them (flash_bwd_wgmma.cu: K4's backward on wgmma; flash_fwd_wgmma.cu:
// its forward):
//   * the shared-memory layout of a 64-row bf16 tile and its swizzle for
//     each head width D (TileLayout);
//   * a tensor map on the host for a (B, S, heads, D) tensor addressed
//     through its strides, the encoder looked up at run time (the
//     libraries link no libcuda);
//   * on the device: tile loads by TMA (cp.async.bulk.tensor) completing on
//     an mbarrier, tile stores by TMA from a plain row-major tile, the wgmma
//     descriptors of such a tile read K-major or MN-major, and the wgmma
//     products themselves, m64nNk16 bf16 -> f32, with A from shared memory
//     or from registers;
//   * what the kernels' loops share: the grid order (block_order), the
//     exp2 of the softmax, and the clock stamps of an instrumented build.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

namespace wg {

// A 64-row bf16 tile of a D-wide tensor in shared memory.  Its rows are cut
// into NB column blocks of E elements (W bytes: the narrowest of 32, 64 and
// 128 that holds the row's 2 D bytes, 128 where it holds more), a row
// padded to the block's width; each block holds its 64 rows W bytes apart,
// swizzled W bytes (the 16-byte chunks of a row XORed with the row's index
// within its atom of 8 rows), which is both what TMA writes for a box of E
// x 64 with that swizzle and a canonical wgmma layout.  At D = 48 (96 bytes
// a row) that is one block of 64 columns with the 128-byte swizzle, the
// last 16 read by TMA as out-of-bounds zeros and never by a product (one
// box a tile; three 32-byte-wide blocks with the 32-byte swizzle, unpadded,
// were slower); at D = 16, 32, 64 one block of 32, 64, 128 bytes; at D =
// 128 two of 128.
template <int D>
struct TileLayout {
  static_assert(D % 16 == 0, "k-steps of 16");
  static constexpr int ROW_BYTES = 2 * D;
  static constexpr int W = ROW_BYTES > 64 ? 128 : ROW_BYTES > 32 ? 64 : 32;
  static constexpr int E = W / 2, NB = (D + E - 1) / E;
  static constexpr int BLOCK_BYTES = 64 * W, TILE_BYTES = NB * BLOCK_BYTES;
  // the descriptor's layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t MODE = W == 128 ? 1 : W == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
               : W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time; nullptr where it is not there
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a bf16 tensor (B, S, heads, D) with D contiguous and the other
// strides in elements (multiples of 8, the base 16-byte aligned): its box
// is one column block of TileLayout<D> (E x 64 rows of one head of one batch
// row), swizzled as the layout says; rows at or past S and columns at or
// past D read as zeros.  `plain`: the box is a whole 64-row tile, D x 64,
// unswizzled (a row-major [64][D] tile in shared memory, as store_tile
// writes it out; rows at or past S are not written).
// -> 0, or cudaErrorInvalidValue where cuTensorMapEncodeTiled refuses the map.
template <int D>
int encode_rows(CUtensorMap* map, const void* base, int B, int S, int heads, long long sb,
                long long ss, long long sh, bool plain = false) {
  using L = TileLayout<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(plain ? D : L::E), 64, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        plain ? CU_TENSOR_MAP_SWIZZLE_NONE : L::SWIZZLE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---- device: barriers and copies ----

using bulk::mbar_arrive_expect_tx;
using bulk::mbar_init;
using bulk::mbar_init_fence;
using bulk::shared_addr;

// Waits for the phase of bar with this parity to complete.  A wait that
// lasts 2^35 cycles (~17 s) traps: a barrier that never completes becomes a
// launch error the caller sees, not a card that hangs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// arrive (release: this thread's earlier shared-memory stores become
// visible to the waiters)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_addr(bar)) : "memory");
}

// The 64-row tile of `map` from row `row0` of head `head`, batch row `b`
// into shared memory at dst (1024-byte aligned), one box a column block;
// TILE_BYTES complete on bar.  One thread issues it.
template <int D>
__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map, uint64_t* bar, int row0,
                                          int head, int b) {
  using L = TileLayout<D>;
#pragma unroll
  for (int cb = 0; cb < L::NB; ++cb)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(shared_addr(dst) + cb * L::BLOCK_BYTES),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(cb * L::E), "r"(row0), "r"(head), "r"(b),
        "r"(shared_addr(bar))
        : "memory");
}

// The row-major [64][D] bf16 tile at src (16-byte aligned) out to rows
// row0 .. row0 + 63 of head `head`, batch row `b` of `map` (encode_rows
// with `plain`), rows past its S dropped; one thread issues it and returns
// once the tile has been read (src may then be reused).  The threads that
// wrote src run fence_async_shared() and meet that thread at a barrier
// first.
__device__ __forceinline__ void store_tile(const CUtensorMap* map, const void* src, int row0, int head,
                                           int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(shared_addr(src)), "r"(0), "r"(row0), "r"(head), "r"(b)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's shared-memory stores made visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the named barrier `id` (1 .. 15) of `threads` threads (whole warps)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- device: what the kernels' loops share ----

constexpr int kTile = 64;                       // rows of a tile
constexpr float kLog2e = 1.4426950408889634f;   // the softmax runs on exp2

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x; -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the sum over the quad of lanes that holds one row of an accumulator
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle's atom)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024u - (shared_addr(raw) & 1023u)) & 1023u);
}

// Which (tile i of n, pair p) block `idx` of a 1-D grid takes.  The grid
// runs in chunks of `spread` pairs, tiles outer within a chunk: with
// spread = every pair (a grid of about two waves or less) all the tiles
// with the most steps start first and the short ones fill in behind them;
// with spread = 1 a pair's tiles run together, and the tiles they share
// are read from L2 while it still holds them.
__device__ __forceinline__ void block_order(int idx, int n, int spread, int& i, int& p) {
  const int chunk = idx / (n * spread), r = idx - chunk * n * spread;
  i = r / spread;
  p = chunk * spread + (r - i * spread);
}

// Cycle counts of a loop's phases, per consumer warp, summed over the grid
// into a kernel's counters (flush); only in a build with -DNANO_BWD_CLOCKS
// (`chip_smoke.py bench routes clocks`), else every call is empty.  The
// backward's phases: prologue, waits, the S and dP products, P and dS, the
// gradient products, epilogue; the forward's: prologue, waits, the S
// product, the softmax, the P V product, epilogue.
enum { kClkPrologue, kClkWait, kClkScores, kClkSoftmax, kClkGrads, kClkEpilogue, kClkN };
#ifdef NANO_BWD_CLOCKS
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
  __device__ __forceinline__ void flush(unsigned long long* counters) {
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < kClkN; ++i) atomicAdd(&counters[i], (unsigned long long)acc[i]);
  }
};
#else
struct Clk {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};
#endif

// ---- device: wgmma descriptors ----

__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// k-step ks (columns 16 ks .. 16 ks + 15) of a tile at `tile`, read K-major:
// its 64 rows are the product's M (as A) or N (as B) rows, 8-row groups
// 8 W bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  using L = TileLayout<D>;
  const uint32_t at = tile + (16 * ks / L::E) * L::BLOCK_BYTES + (16 * ks % L::E) * 2;
  return descriptor(at, 16, 8 * L::W, L::MODE);
}

// k-step kk (rows 16 kk .. 16 kk + 15) of a tile at `tile`, read MN-major
// as a B operand whose N is the tile's D columns: the column blocks lie
// BLOCK_BYTES apart (the leading offset), 8-row groups 8 W bytes (the
// stride offset).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using L = TileLayout<D>;
  return descriptor(tile + 16 * kk * L::W, L::BLOCK_BYTES, 8 * L::W, L::MODE);
}

// ---- device: wgmma ----
// Accumulators d of an m64nN product, per thread of the warpgroup (warp w,
// lane = 4 g + t): d[4 j + 2 i + c] is row 16 w + g + 8 i, column 8 j + 2 t
// + c.  A fragments in registers: the same rows, a[0] (g, 2t..), a[1]
// (g + 8, 2t..), a[2] (g, 2t + 8..), a[3] (g + 8, 2t + 8..) of 16 columns,
// bf16 pairs: an accumulator's columns 16 kk .. 16 kk + 15 are the next
// product's k-step kk (pack_a).

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// returns when at most N committed groups of the warpgroup are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// asynchronous product owns across the wait for it
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragments of k-step kk from an m64nN accumulator (rounded to bf16)
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d (m64n64, f32) = A B (+ d where scale_d): A and B by descriptor, both K-major
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64n16, f32) = A B (+ d where scale_d): A the bf16 fragments a in
// registers, B by descriptor, MN-major (transposed)
__device__ __forceinline__ void mma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (m64n32, f32) = A B (+ d where scale_d): A the bf16 fragments a in
// registers, B by descriptor, MN-major (transposed)
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (m64n48, f32) = A B (+ d where scale_d): A the bf16 fragments a in
// registers, B by descriptor, MN-major (transposed)
__device__ __forceinline__ void mma_rs_n48(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (m64n64, f32) = A B (+ d where scale_d): A the bf16 fragments a in
// registers, B by descriptor, MN-major (transposed)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  if constexpr (N == 16)
    mma_rs_n16(d, a, b, scale_d);
  else if constexpr (N == 32)
    mma_rs_n32(d, a, b, scale_d);
  else if constexpr (N == 48)
    mma_rs_n48(d, a, b, scale_d);
  else
    mma_rs_n64(d, a, b, scale_d);
}

}  // namespace wg

}  // namespace
