// What the two int8 tensor-core products share: q80_matmul_w8a8
// (q80_matmul.cu) and q4k_matmul_w4a4 (q4k.cu).  Both put MB weight rows
// a block on M (16 a warp) and BN slots on N, stream chunks of K through a
// ring of up to kMaxStages shared-memory stages filled by cp.async, take
// one mma.sync m16n8k32 s8 a 32-byte step of K, split K over a thread
// block cluster of CS blocks that add their partial tiles in distributed
// shared memory in rank order (no atomics: two runs give the same bits),
// and take their split (MB, BN, CS, S) from the shapes alone
// (ops/int8_mma.py:plan).  Each .cu file is its own library, so the
// helpers live in an anonymous namespace.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

namespace mma8 {

constexpr int kMaxStages = 4;      // ring stages at most (cp_async_wait's cases)
constexpr int kMaxCluster = 8;     // blocks a cluster at most (the portable size)
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may have (H100)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 .. kMaxStages - 1) of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// c (16 x 8 s32) += a (16 x 32 s8, row) . b (32 x 8 s8, col): exact
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of a block: S stages of `stage` bytes and the box where
// the CS blocks of a cluster leave a block their partial sums of its
// MB / CS rows, [rank][row][slot] with slot rows of BN + 2 floats: past
// the stages where CS > 1 (other blocks write into it while this one may
// still be reading its stages), over them where CS = 1 (the shared memory
// is then the larger of the two).
__host__ __device__ __forceinline__ size_t box_offset(size_t stage, int CS, int S) {
  return CS > 1 ? (size_t)S * stage : 0;
}

__host__ __device__ __forceinline__ size_t ring_smem(size_t stage, int MB, int BN, int CS, int S) {
  const size_t stages = (size_t)S * stage, box = (size_t)MB * (BN + 2) * 4;
  return CS > 1 ? stages + box : (stages > box ? stages : box);
}

// A split the kernels take: MB 64 or 128, BN 8 .. 64, CS a power of two up
// to kMaxCluster and the pieces of K it splits, 1 .. kMaxStages stages, a
// block's shared memory within kMaxSmem.
inline bool split_ok(int MB, int BN, int CS, int pieces, int S, size_t smem) {
  return (MB == 64 || MB == 128) && (BN == 8 || BN == 16 || BN == 32 || BN == 64) && CS >= 1 &&
         CS <= kMaxCluster && !(CS & (CS - 1)) && CS <= pieces && S >= 1 && S <= kMaxStages &&
         smem <= (size_t)kMaxSmem;
}

// Lane (gid, tig) of warp w holds, for 8-slot fragment j, the partial sums
// acc[j][2 h + q] of row 16 w + gid + 8 h and slot 8 j + 2 tig + q: it
// leaves them in the box of the block that sums that row (remote stores:
// nothing waits for them).  A cluster barrier must follow.
template <int NF>
__device__ __forceinline__ void leave_partials(float (&acc)[NF][4], float* box, int MB, int BN,
                                               int CS, int rank, int warp, int lane) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int own = MB / CS, ldo = BN + 2, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gid + 8 * h;
    float* dst = cluster.map_shared_rank(box, r / own) + (rank * own + r % own) * ldo;
#pragma unroll
    for (int j = 0; j < NF; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * tig) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// After the barrier: this block's MB / CS rows (rank * MB / CS ..), each
// (row, slot) the sum of the CS partials in rank order, given to
// store(row of the tile, slot of the tile, value).
template <typename Store>
__device__ __forceinline__ void sum_partials(const float* box, int MB, int BN, int CS, int rank,
                                             Store store) {
  const int own = MB / CS, ldo = BN + 2;
  for (int i = threadIdx.x; i < own * BN; i += blockDim.x) {
    const int r = i % own, b = i / own;
    float v = box[r * ldo + b];
    for (int q = 1; q < CS; ++q) v += box[(q * own + r) * ldo + b];
    store(rank * own + r, b, v);
  }
}

// One launch of a tile kernel: ceil(N / MB) tiles of weight rows of CS
// blocks each (a cluster) on x, ceil(B / BN) slot tiles on y, MB * 2
// threads a block.
template <typename... Params, typename... Args>
cudaError_t launch_tiles(void (*kernel)(Params...), int B, int N, int MB, int BN, int CS,
                         size_t smem, cudaStream_t st, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + MB - 1) / MB * CS), (unsigned)((B + BN - 1) / BN), 1);
  cfg.blockDim = dim3((unsigned)(MB * 2), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// Every kernel given may take all the shared memory a block can have: once
// a device, before any launch (a CUDA-graph capture must not be the first
// to meet an instance).
inline cudaError_t allow_smem() { return cudaSuccess; }

template <typename K, typename... Rest>
cudaError_t allow_smem(K* kernel, Rest*... rest) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return e != cudaSuccess ? e : allow_smem(rest...);
}

}  // namespace mma8

}  // namespace
