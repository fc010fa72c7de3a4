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
// and the probability as on the TPU; bf16/f32 caches pass no scales.  q is
// read in its own type (f32 or bf16).
//
// Bound on the H100: bytes — the K and V rows t <= pos, read once, at
// 2 * rep flops per byte.  At batch 1 those bytes are nothing (1.3 MB at
// the Qwen3-0.6B shape) and a call is a chain of latencies, so the design
// is about the length of that chain and about keeping everything else off
// the stream: one launch per call, no memset, no cast, no allocation.
//
//   grid     (B * KV, n_split): block (bk, s) takes positions
//            [s * chunk, (s + 1) * chunk) (flash-decoding); n_split is
//            chosen on the host from shapes alone, never from B, so that
//            one row's grid is one to two blocks per SM and a row gets the
//            same bits at every batch size (ops/decode_attn.py:
//            choose_splits).  Splits wholly past pos return at once and
//            take no part in anything: pos says how many are active.
//   loads    a row of D values is D / VEC lanes of 16 bytes (VEC = 4 f32,
//            8 bf16, 16 int8), padded to a power of two lanes (a "row
//            group"), so a warp's load instruction brings 32 / lanes whole
//            rows.  A thread starts the K and V loads (and scales) of four
//            rows (two where rep * VEC is large: registers) before the first
//            use, and the next tile's before it computes on the current one.
//   softmax  two passes over a tile, per row group: first the scores of
//            all of the group's rows for all rep heads (one short xor
//            reduction over the group's lanes per score), then one max,
//            one correction and one exp per score, then P.V with each lane
//            owning its fixed 16-byte slices of D and walking the rows: no
//            shuffle in the V pass.  v_scale multiplies p before that pass.
//   combine  row groups merge by shuffles inside a warp, warps through
//            shared memory, blocks through `part` in device memory: the
//            last block of a (batch row, KV head) to finish (an atomic
//            ticket in `counter`) combines the active partials in split
//            order, reading each once with 16-byte loads, so the result
//            does not depend on which block came last.  It then puts the
//            ticket back to zero: `counter` is zeroed once, when the
//            workspace is made, and every call leaves it zero.  With one
//            active split the block writes `out` itself.
//
// Templated on the cache type, D in {16, 32, 48, 64, 128, 256} and the query
// heads per KV head an instance holds, 1, 2, 4 or 8: rep = 3 runs in the
// instance for 4 and rep = 5 .. 7 in the one for 8, the missing heads as
// zero rows that are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 64;      // the host never asks for more
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of a cache row -> VEC floats
template <typename CT>
struct Cache;
template <>
struct Cache<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void unpack(const uint4& w, float (&x)[4]) {
    x[0] = __uint_as_float(w.x);
    x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z);
    x[3] = __uint_as_float(w.w);
  }
};
template <>
struct Cache<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ void unpack(const uint4& w, float (&x)[8]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // a bf16 is the upper half of an f32
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};
template <>
struct Cache<int8_t> {
  static constexpr int VEC = 16;
  static __device__ __forceinline__ void unpack(const uint4& w, float (&x)[16]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = (float)((int)(u[i] << (24 - 8 * j)) >> 24);
  }
};

__host__ __device__ constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// How the threads of a block lie over the rows of a tile.
template <typename CT, int REP, int D>
struct Geo {
  static constexpr int VEC = Cache<CT>::VEC;
  static constexpr int U = REP * VEC >= 64 ? 2 : 4;                // rows a thread holds of one tile
  static constexpr int LPR = D / VEC;                              // 16-byte slices of a row
  static constexpr int LPG = LPR >= 32 ? 32 : pow2_ceil(LPR);      // lanes of a row group
  static constexpr int NSEG = (LPR + LPG - 1) / LPG;               // slices a lane owns
  static constexpr int GPW = 32 / LPG;                             // row groups of a warp
  static constexpr int RPP = kWarps * GPW;                         // rows of one load pass
  static constexpr int TILE = RPP * U;
  static_assert(D % VEC == 0, "a row is whole 16-byte slices");
};

// floats of one block's partial in `part`: rep * D sums, then (max, sum) per
// query head, padded so that every partial starts on a 16-byte boundary
__host__ __device__ constexpr int part_stride(int rep, int D) { return rep * D + (2 * rep + 3) / 4 * 4; }

__device__ __forceinline__ float weight(float m, float M) {   // exp(m - M), 0 for an empty state
  return m == -INFINITY ? 0.f : expf(m - M);
}

template <typename CT, int REP, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const void* __restrict__ q, int q_bf16, long long q_stride,
                       const CT* __restrict__ kc, const CT* __restrict__ vc,
                       const float* __restrict__ ks, const float* __restrict__ vs,
                       const int* __restrict__ pos, int pos_stride, float* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counter, int T, int KV,
                       int rep, float scale, int chunk, int n_split, int per_block) {
  using G = Geo<CT, REP, D>;
  constexpr int VEC = G::VEC, LPR = G::LPR, LPG = G::LPG, NSEG = G::NSEG, GPW = G::GPW;
  constexpr int RPP = G::RPP, TILE = G::TILE, U = G::U;
  constexpr int STRIDE = part_stride(REP, D);
  __shared__ __align__(16) float sq[REP * D];
  __shared__ __align__(16) float sm_acc[kWarps][REP * D];
  __shared__ float sm_m[kWarps][REP], sm_l[kWarps][REP];
  __shared__ float sm_pm[kMaxSplit * REP];
  __shared__ int ticket;

  const int bk = blockIdx.x, first = blockIdx.y * per_block;
  const int b = bk / KV, h = bk - b * KV, H = KV * rep;   // rep <= REP heads are there
  const int p_last = min(max(pos[(size_t)b * pos_stride], 0), T - 1);
  const int n_active = min(n_split, p_last / chunk + 1);
  if (first >= n_active) return;   // wholly past pos: nothing to read, nobody waits for it
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = lane / LPG, lig = lane - group * LPG;
  const int row_in_pass = warp * GPW + group;
  float* out_b = out + (size_t)b * H * D + (size_t)h * rep * D;

  // rows t = base + u * RPP + row_in_pass (below lim), raw 16-byte slices
  // lig + j * LPG
  struct Rows {
    uint4 k[U][NSEG], v[U][NSEG];
    float ks[U], vs[U];
  };
  auto load_rows = [&](int base, int lim, Rows& R) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * RPP + row_in_pass;
      const size_t row = ((size_t)b * T + min(t, lim - 1)) * KV + h;
#pragma unroll
      for (int j = 0; j < NSEG; ++j) {
        const int seg = lig + j * LPG;
        R.k[u][j] = R.v[u][j] = make_uint4(0u, 0u, 0u, 0u);
        if (t < lim && seg < LPR) {
          R.k[u][j] = __ldg(reinterpret_cast<const uint4*>(kc + row * D + seg * VEC));
          R.v[u][j] = __ldg(reinterpret_cast<const uint4*>(vc + row * D + seg * VEC));
        }
      }
      R.ks[u] = R.vs[u] = 1.f;
      if (ks != nullptr && t < lim) {
        R.ks[u] = __ldg(ks + row);
        R.vs[u] = __ldg(vs + row);
      }
    }
  };
  auto split_end = [&](int s) { return min((s + 1) * chunk, p_last + 1); };

  // the block's splits, one partial each, computed alike whichever block
  // takes them; the first tile of the next split is loaded during the last
  // tile of this one
  const int last = min(first + per_block, n_active);
  Rows cur;
  load_rows(first * chunk, split_end(first), cur);   // in flight while q goes to shared memory
  for (int split = first; split < last; ++split) {
    const int t0 = split * chunk, t1 = split_end(split);

    if (split == first) {
      const size_t q0 = (size_t)b * q_stride + (size_t)h * rep * D;
      for (int i = tid; i < REP * D; i += kThreads)
        sq[i] = i >= rep * D ? 0.f
                : q_bf16    ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[q0 + i])
                            : static_cast<const float*>(q)[q0 + i];
    }
    __syncthreads();   // q is in; the last split's partial has been read out

    float m[REP], l[REP], acc[REP][NSEG][VEC];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int j = 0; j < NSEG; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][j][e] = 0.f;
    }

    for (int base = t0; base < t1; base += TILE) {
      Rows nxt;
      const bool more = base + TILE < t1, next_split = !more && split + 1 < last;
      if (more) load_rows(base + TILE, t1, nxt);
      if (next_split) load_rows(t1, split_end(split + 1), nxt);

      // pass 1: the scores of this group's U rows for every query head
      float s[U][REP];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < REP; ++r) s[u][r] = 0.f;
#pragma unroll
      for (int j = 0; j < NSEG; ++j) {
        const int seg = lig + j * LPG;
        if (seg < LPR) {
          float kf[U][VEC];
#pragma unroll
          for (int u = 0; u < U; ++u) Cache<CT>::unpack(cur.k[u][j], kf[u]);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            float qv[VEC];
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 x = *reinterpret_cast<const float4*>(sq + r * D + seg * VEC + e);
              qv[e] = x.x;
              qv[e + 1] = x.y;
              qv[e + 2] = x.z;
              qv[e + 3] = x.w;
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int e = 0; e < VEC; ++e) s[u][r] = fmaf(qv[e], kf[u][e], s[u][r]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool seen = base + u * RPP + row_in_pass < t1;
        const float sc = cur.ks[u] * scale;
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float x = s[u][r];
#pragma unroll
          for (int off = LPG / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
          s[u][r] = seen ? x * sc : -INFINITY;
        }
      }

      // pass 2: one max, one correction, one exp per score
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][r]);
        if (mx == -INFINITY) {   // this group has seen no row yet
#pragma unroll
          for (int u = 0; u < U; ++u) s[u][r] = 0.f;
          continue;
        }
        const float corr = expf(m[r] - mx);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = expf(s[u][r] - mx);
          sum += p;
          s[u][r] = p * cur.vs[u];
        }
        l[r] = l[r] * corr + sum;
#pragma unroll
        for (int j = 0; j < NSEG; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][j][e] *= corr;
      }
      // P.V: every lane walks the rows over its own slices of D
#pragma unroll
      for (int j = 0; j < NSEG; ++j) {
        if (lig + j * LPG < LPR) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float vf[VEC];
            Cache<CT>::unpack(cur.v[u][j], vf);
#pragma unroll
            for (int r = 0; r < REP; ++r)
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[r][j][e] = fmaf(s[u][r], vf[e], acc[r][j][e]);
          }
        }
      }
      if (more || next_split) cur = nxt;
    }

    // the row groups of a warp -> one state per warp (every lane ends with it)
#pragma unroll
    for (int off = LPG; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float mo = __shfl_xor_sync(kFull, m[r], off);
        const float lo = __shfl_xor_sync(kFull, l[r], off);
        const float M = fmaxf(m[r], mo);
        const float fa = weight(m[r], M), fb = weight(mo, M);
        l[r] = l[r] * fa + lo * fb;
        m[r] = M;
#pragma unroll
        for (int j = 0; j < NSEG; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float ao = __shfl_xor_sync(kFull, acc[r][j][e], off);
            acc[r][j][e] = acc[r][j][e] * fa + ao * fb;
          }
      }
    }
    if (group == 0) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (lig == 0) {
          sm_m[warp][r] = m[r];
          sm_l[warp][r] = l[r];
        }
#pragma unroll
        for (int j = 0; j < NSEG; ++j) {
          const int seg = lig + j * LPG;
          if (seg < LPR) {
#pragma unroll
            for (int e = 0; e < VEC; e += 4)
              *reinterpret_cast<float4*>(&sm_acc[warp][r * D + seg * VEC + e]) =
                  make_float4(acc[r][j][e], acc[r][j][e + 1], acc[r][j][e + 2], acc[r][j][e + 3]);
          }
        }
      }
    }
    __syncthreads();

    // the warps -> one partial for this split; a thread owns 4 values of one head
    float* my_part = part + ((size_t)bk * n_split + split) * STRIDE;
    for (int i = tid * 4; i < REP * D; i += kThreads * 4) {
      const int r = i / D;
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
      float L = 0.f;
      float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = weight(sm_m[w][r], M);
        const float4 a = *reinterpret_cast<const float4*>(&sm_acc[w][i]);
        L += sm_l[w][r] * f;
        O.x += a.x * f;
        O.y += a.y * f;
        O.z += a.z * f;
        O.w += a.w * f;
      }
      if (n_active == 1) {
        const float inv = 1.f / L;
        if (i < rep * D)
          *reinterpret_cast<float4*>(out_b + i) =
              make_float4(O.x * inv, O.y * inv, O.z * inv, O.w * inv);
      } else {
        *reinterpret_cast<float4*>(my_part + i) = O;
        if (i == r * D) {
          my_part[REP * D + 2 * r] = M;
          my_part[REP * D + 2 * r + 1] = L;
        }
      }
    }
  }
  if (n_active == 1) return;

  // the last of the active blocks of this (batch row, KV head) combines
  // the active splits' partials
  __threadfence();
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(counter + bk, 1);
  __syncthreads();
  if (ticket != (n_active + per_block - 1) / per_block - 1) return;
  if (tid == 0) counter[bk] = 0;   // left as it was found, for the next call
  __threadfence();
  const float* parts = part + (size_t)bk * n_split * STRIDE;
  for (int i = tid; i < n_active * REP; i += kThreads) {
    const int sp = i / REP, r = i - sp * REP;
    sm_pm[i] = __ldcg(parts + (size_t)sp * STRIDE + REP * D + 2 * r);
  }
  __syncthreads();
  for (int i = tid * 4; i < rep * D; i += kThreads * 4) {
    const int r = i / D;
    float M = -INFINITY;
    for (int sp = 0; sp < n_active; ++sp) M = fmaxf(M, sm_pm[sp * REP + r]);
    float L = 0.f;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < n_active; ++sp) {
      const float* ps = parts + (size_t)sp * STRIDE;
      const float f = expf(sm_pm[sp * REP + r] - M);
      const float4 a = __ldcg(reinterpret_cast<const float4*>(ps + i));
      L += __ldcg(ps + REP * D + 2 * r + 1) * f;
      O.x += a.x * f;
      O.y += a.y * f;
      O.z += a.z * f;
      O.w += a.w * f;
    }
    const float inv = 1.f / L;
    *reinterpret_cast<float4*>(out_b + i) = make_float4(O.x * inv, O.y * inv, O.z * inv, O.w * inv);
  }
}

template <typename CT, int REP, int D>
int launch(const void* q, int q_bf16, long long q_stride, const void* kc, const void* vc,
           const float* ks, const float* vs, const int* pos, int pos_stride, float* out,
           float* part, int* counter, int B, int T, int KV, int rep, float scale, int chunk,
           int per_block, cudaStream_t st) {
  const int n_split = (T + chunk - 1) / chunk;
  const dim3 grid(B * KV, (n_split + per_block - 1) / per_block);
  decode_attn_kernel<CT, REP, D><<<grid, kThreads, 0, st>>>(
      q, q_bf16, q_stride, static_cast<const CT*>(kc), static_cast<const CT*>(vc), ks, vs, pos,
      pos_stride, out, part, counter, T, KV, rep, scale, chunk, n_split, per_block);
  return (int)cudaGetLastError();
}

template <typename CT, int REP>
int launch_d(int D, const void* q, int q_bf16, long long q_stride, const void* kc,
             const void* vc, const float* ks, const float* vs, const int* pos, int pos_stride,
             float* out, float* part, int* counter, int B, int T, int KV, int rep, float scale,
             int chunk, int per_block, cudaStream_t st) {
#define NANO_D(DD)                                                                           \
  case DD:                                                                                   \
    return launch<CT, REP, DD>(q, q_bf16, q_stride, kc, vc, ks, vs, pos, pos_stride, out,    \
                               part, counter, B, T, KV, rep, scale, chunk, per_block, st)
  switch (D) {
    NANO_D(16);
    NANO_D(32);
    NANO_D(48);
    NANO_D(64);
    NANO_D(128);
    NANO_D(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NANO_D
}

template <typename CT>
int launch_rep(int rep, int D, const void* q, int q_bf16, long long q_stride, const void* kc,
               const void* vc, const float* ks, const float* vs, const int* pos, int pos_stride,
               float* out, float* part, int* counter, int B, int T, int KV, float scale,
               int chunk, int per_block, cudaStream_t st) {
#define NANO_REP(RR)                                                                          \
  case RR:                                                                                    \
    return launch_d<CT, RR>(D, q, q_bf16, q_stride, kc, vc, ks, vs, pos, pos_stride, out,     \
                            part, counter, B, T, KV, rep, scale, chunk, per_block, st)
  switch (rep <= 2 ? rep : rep <= 4 ? 4 : 8) {   // an instance holds up to RR heads
    NANO_REP(1);
    NANO_REP(2);
    NANO_REP(4);
    NANO_REP(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NANO_REP
}

}  // namespace

// q: (B, KV * rep, D), f32 (q_type 0) or bf16 (1), heads and D contiguous,
// batch rows q_stride elements apart.  cache_type: 0 = f32, 1 = bf16,
// 2 = int8; caches contiguous (B, T, KV, D) on 16-byte boundaries.  ks/vs
// may be null (unit scales).  pos holds int32 positions, read at
// b * pos_stride (a stride of 0 broadcasts one position to every row).
// rep in 1 .. 8, D in {16, 32, 48, 64, 128, 256}, ceil(T / chunk) <= 64
// splits, per_block of them a block (ops/decode_attn.py:choose_splits,
// per_block: never changing a row's arithmetic, only the grid).
// part: f32 scratch of B * KV * ceil(T / chunk) * decode_attention_part_stride
// floats; counter: B * KV int32, zero at launch and zero again when the
// kernel ends.  Launches on the caller's stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape not built).
extern "C" int decode_attention(const void* q, const void* kc, const void* vc, const void* ks,
                                const void* vs, const void* pos, int pos_stride, void* out,
                                void* part, void* counter, int q_type, long long q_stride,
                                int cache_type, int B, int T, int KV, int rep, int D,
                                float scale, int chunk, int per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || (T + chunk - 1) / chunk > kMaxSplit || q_type < 0 || q_type > 1 || rep < 1 ||
      rep > 8 || per_block < 1)
    return (int)cudaErrorInvalidValue;
#define NANO_TYPE(CT)                                                                        \
  return launch_rep<CT>(rep, D, q, q_type, q_stride, kc, vc, static_cast<const float*>(ks),  \
                        static_cast<const float*>(vs), static_cast<const int*>(pos),         \
                        pos_stride, static_cast<float*>(out), static_cast<float*>(part),     \
                        static_cast<int*>(counter), B, T, KV, scale, chunk, per_block, st)
  switch (cache_type) {
    case 0:
      NANO_TYPE(float);
    case 1:
      NANO_TYPE(__nv_bfloat16);
    case 2:
      NANO_TYPE(int8_t);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NANO_TYPE
}

// floats of one block's partial for (rep, D): what the workspace is sized by
extern "C" int decode_attention_part_stride(int rep, int D) {
  return part_stride(rep <= 2 ? rep : rep <= 4 ? 4 : 8, D);
}
