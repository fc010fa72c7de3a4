"""Q80 quantized matmul: int8 weights with f32 per-group scales.

Port of ``nano_tpu/ops/qmatmul.py``.  The weights keep the ``.bin`` file's
layout on every device: ``q`` int8 ``(..., out, in)`` with ``scales`` f32
``(..., out, in // group_size)``, groups running along the input
dimension.  (The JAX package re-laid W8A8 weights out as ``(G, out, gs)``
for the TPU's matrix unit; the card needs no such copy, so the tied LM
head reads the very int8 table that the embedding gather uses.)

Two numerics forms, chosen per tensor at load (``Q80Tensor.w8a8``):

* W8A8 (``q80_matmul_int8``), the default at group size >= 256: the
  activation is quantized per group with the C engine's rounding, then
  each group's int8 x int8 dot is an exact int32 and the f32 combine is
  ``sum_g P * sa * sw``.  One activation row (every product of a decode
  step, and the LM head, which runs on the last position only) takes one
  kernel with the quantization folded in (``q80_matvec_fq``); more rows
  (a batched decode step, prefill's layer products) take two,
  ``act_quant_q80`` then ``q80_w8a8`` on the int8 tensor cores.  An
  activation that arrives already quantized (``Q80Act``: the cached
  forward's norms and SwiGLU write it, ``ops/norm_quant.py``) goes
  straight to ``q80_w8a8``.
* rows (``q80_rows``), below group size 256: f32 dequant and an f32 dot —
  the math of the TPU kernel ``_q80_kernel``.  One activation row takes
  ``q80_matvec_rows``, more rows the tiled ``q80_matmul_rows``, both for a
  group size that is a power of two from 16 (GGUF Q8_0: 32, Q6_K: 16);
  other group sizes, and a row too long for the matvec's shared memory,
  the warp-a-row ``q80_matmul_rows_warp``.  The choice is made by shape.

Each wrapper runs its hand-written CUDA kernel (``csrc/q80_matmul.cu``)
for CUDA tensors and its plain PyTorch version (``*_plain``) only for
tensors on the CPU.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch

from nano_tpu_torch.ops import _build, int8_mma

# smallest group size that takes the W8A8 form (the JAX package's
# MIN_GROUPED_GS: the default load decision, binfmt._maybe_int8_layout)
MIN_W8A8_GS = 256


@dataclass
class Q80Tensor:
    """Per-group symmetric int8 tensor in the file's row layout.

    q:      int8, shape (..., out, in)
    scales: f32,  shape (..., out, in // group_size)
    w8a8:   True selects the int8-activation form of the matmul.
    """
    q: torch.Tensor
    scales: torch.Tensor
    group_size: int
    w8a8: bool = False

    @property
    def out_dim(self) -> int:
        return self.q.shape[-2]

    @property
    def in_dim(self) -> int:
        return self.q.shape[-1]

    def layer(self, i: int) -> "Q80Tensor":
        """The i-th matrix of a stacked (L, out, in) tensor (a view)."""
        return replace(self, q=self.q[i], scales=self.scales[i])

    def to(self, device) -> "Q80Tensor":
        return replace(self, q=self.q.to(device), scales=self.scales.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        *lead, out, inn = self.q.shape
        g = self.group_size
        w = self.q.to(dtype).reshape(*lead, out, inn // g, g)
        w = w * self.scales[..., None].to(dtype)
        return w.reshape(*lead, out, inn)


@dataclass
class Q80Act:
    """An activation (..., K) quantized as ``act_quant_q80`` quantizes it,
    by the kernel that produced it (``ops/norm_quant.py``).

    xq:    int8, shape (B, G, gs), B the rows of the activation
    sa:    f32,  shape (B, G)
    shape: the activation's shape (..., K)
    """
    xq: torch.Tensor
    sa: torch.Tensor
    shape: torch.Size

    @property
    def group_size(self) -> int:
        return self.xq.shape[-1]


# =====================================================================
# plain PyTorch versions (CPU path; on the card only for comparisons)
# =====================================================================

def c_round(x: torch.Tensor) -> torch.Tensor:
    """C round(): half away from zero (torch.round is half-to-even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def act_quant_q80_plain(x: torch.Tensor, group_size: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, K) -> (int8 (B, G, gs), scales f32 (B, G)).

    C semantics (reference: infer/tensor.c:21-47): scale = absmax/127 in
    f32, values = round(x / scale) half away from zero; an all-zero group
    gets scale 0 and values 0.  Both divisions divide by a tensor: PyTorch
    turns a division by a Python number on a CUDA tensor into a multiply
    by its reciprocal, which would move the int8 decisions."""
    B, K = x.shape
    xg = x.float().reshape(B, K // group_size, group_size)
    amax = xg.abs().amax(dim=-1)
    sa = amax / torch.full_like(amax, 127.0)
    safe = torch.where(sa == 0.0, torch.ones_like(sa), sa)
    aq = c_round(xg / safe[..., None])
    return aq.to(torch.int8), sa


def q80_w8a8_plain(aq: torch.Tensor, sa: torch.Tensor, w: Q80Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Quantized activations (int8 (B, G, gs), f32 (B, G)) x w -> (B, out):
    y = sum_g P[b, g, n] * sa[b, g] * sw[n, g] with P the exact int8 group
    dots.  They run as float products of integers: below 2^24 every
    partial sum is an integer that f32 holds exactly (f64 above that)."""
    B, G, gs = aq.shape
    exact = torch.float32 if gs * 127 * 127 < 2 ** 24 else torch.float64
    P = torch.einsum("bgk,ngk->bgn", aq.to(exact),
                     w.q.reshape(w.out_dim, G, gs).to(exact)).float()
    y = (P * sa[:, :, None] * w.scales.t()[None]).sum(dim=1)
    return y.to(dtype)


def q80_matmul_int8_plain(x: torch.Tensor, w: Q80Tensor,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """W8A8: x (B, K) -> (B, out), activations quantized per group."""
    aq, sa = act_quant_q80_plain(x, w.group_size)
    return q80_w8a8_plain(aq, sa, w, dtype)


def q80_matvec_fq_plain(x: torch.Tensor, w: Q80Tensor,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """What ``q80_matvec_fq`` computes, in plain PyTorch: the W8A8 form."""
    return q80_matmul_int8_plain(x, w, dtype)


def q80_matmul_rows_plain(x: torch.Tensor, w: Q80Tensor,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """rows: x (B, K) -> (B, out) with f32 dequant and an f32 dot."""
    return (x.float() @ w.dequantize(torch.float32).t()).to(dtype)


def q80_matmul_ref(x: torch.Tensor, w: Q80Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., in) @ dequant(w).T -> (..., out), dequantized in `dtype`."""
    return x.to(dtype) @ w.dequantize(dtype).transpose(-1, -2)


# =====================================================================
# kernel wrappers
# =====================================================================

_OUT_TYPES = (torch.float32, torch.bfloat16)


def _check_weight(x: torch.Tensor, w: Q80Tensor) -> None:
    if x.dim() != 2 or x.shape[1] != w.in_dim or w.q.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} does not match weight "
                         f"{tuple(w.q.shape)}")
    if (w.q.device != x.device or w.scales.device != x.device
            or w.q.dtype != torch.int8 or w.scales.dtype != torch.float32
            or not w.q.is_contiguous() or not w.scales.is_contiguous()):
        raise ValueError("Q80 weight must be contiguous int8 q and f32 "
                         "scales on the activation's device")
    if w.in_dim % 16 or w.q.data_ptr() % 16:
        raise ValueError(f"in_dim {w.in_dim} must be a multiple of 16 with "
                         "16-byte aligned rows")


def act_quant_q80(x: torch.Tensor, group_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, K) f32/bf16 -> (int8 (B, G, gs), scales f32 (B, G)) with the
    C engine's rounding; kernel ``q80_act_quant`` on the card."""
    if x.device.type == "cpu":
        return act_quant_q80_plain(x, group_size)
    B, K = x.shape
    if x.dtype not in _OUT_TYPES or not x.is_contiguous() or K % group_size:
        raise ValueError(f"act_quant_q80 takes contiguous f32/bf16 (B, K) "
                         f"with K % {group_size} == 0, got {x.dtype} "
                         f"{tuple(x.shape)}")
    G = K // group_size
    xq = torch.empty((B, G, group_size), dtype=torch.int8, device=x.device)
    sa = torch.empty((B, G), dtype=torch.float32, device=x.device)
    fn = _build.lib("q80_matmul").q80_act_quant
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), xq.data_ptr(),
            sa.data_ptr(), B, K, group_size, _build.stream(x))
    act_quant_q80.launches += 1
    _build.check(rc, "q80_act_quant")
    return xq, sa


act_quant_q80.launches = 0


# q80_matmul_w8a8's work split (csrc/q80_matmul.cu, ops/int8_mma.py):
# bytes of K a stage
W8A8_KC = 256


def _w8a8_stage(MB: int, BN: int) -> int:
    """Bytes of a q80_matmul_w8a8 stage: the weight tile, the slot tile and
    one scale a row and a slot (csrc/q80_matmul.cu:mma_stage)."""
    return (MB + BN) * (W8A8_KC + 4)


def w8a8_smem(MB: int, BN: int, CS: int, S: int) -> int:
    """Shared memory of a q80_matmul_w8a8 block of MB weight rows."""
    return int8_mma.smem(_w8a8_stage(MB, BN), MB, BN, CS, S)


# the slots at which int8_mma.plan's cluster fixes a product's ranges
RANGES_AT = 64


def w8a8_ranges(N: int, K: int, group_size: int,
                n_sm: int = _build.H100_SMS) -> int:
    """The ranges into which both W8A8 kernels split a row's groups when
    they add its group terms (csrc/q80_matmul.cu:RangeSum): the cluster
    ``int8_mma.plan`` picks for the product at RANGES_AT slots (a batched
    step at 64 slots, a 64-token prefill).  q80_matmul_w8a8 takes that
    cluster at every batch size, a block one range, and q80_matvec_fq
    walks the same ranges, so that a row gets the same bits in every
    batch and alone."""
    return int8_mma.plan(RANGES_AT, N, N * K, K // group_size,
                         group_size // W8A8_KC, _w8a8_stage, n_sm)[2]


def w8a8_plan(B: int, N: int, K: int, group_size: int,
              n_sm: int = _build.H100_SMS) -> Tuple[int, int, int, int]:
    """-> (MB, BN, CS, S) of ``q80_matmul_w8a8``: ``int8_mma.plan`` with the
    groups of K split over a cluster of ``w8a8_ranges`` blocks, each
    group_size / W8A8_KC stages."""
    return int8_mma.plan(B, N, N * K, K // group_size,
                         group_size // W8A8_KC, _w8a8_stage, n_sm,
                         cluster=w8a8_ranges(N, K, group_size, n_sm))


def q80_w8a8(xq: torch.Tensor, sa: torch.Tensor, w: Q80Tensor,
             dtype=torch.bfloat16) -> torch.Tensor:
    """Quantized activations (int8 (B, G, gs), f32 (B, G)) x w -> (B, out)
    in `dtype`; kernel ``q80_matmul_w8a8`` (int8 tensor cores, split by
    ``w8a8_plan``) on the card."""
    if xq.device.type == "cpu":
        return q80_w8a8_plain(xq, sa, w, dtype)
    B, G, gs = xq.shape
    _check_weight(xq.reshape(B, G * gs), w)
    if (gs != w.group_size or not (gs == 256 or gs % 512 == 0)
            or dtype not in _OUT_TYPES):
        raise ValueError(f"q80_matmul_w8a8 takes group size 256 or a "
                         f"multiple of 512 and f32/bf16 output, got gs={gs} "
                         f"(weight {w.group_size}), {dtype}")
    if (xq.dtype != torch.int8 or sa.dtype != torch.float32
            or sa.shape != (B, G) or not xq.is_contiguous()
            or not sa.is_contiguous() or xq.data_ptr() % 16 or B < 1):
        raise ValueError("quantized activations must be contiguous int8 "
                         "(B >= 1, G, gs), 16-byte aligned, with f32 (B, G) "
                         "scales")
    int8_mma.init(xq.device, "q80_matmul_init")
    K, N = G * gs, w.out_dim
    y = torch.empty((B, N), dtype=dtype, device=xq.device)
    plan = w8a8_plan(B, N, K, gs, _build.sm_count(xq.device))
    fn = _build.lib("q80_matmul").q80_matmul_w8a8
    rc = fn(xq.data_ptr(), sa.data_ptr(), w.q.data_ptr(), w.scales.data_ptr(),
            y.data_ptr(), int(dtype == torch.bfloat16), B, K, N, gs, *plan,
            _build.stream(xq))
    q80_w8a8.launches += 1
    _build.check(rc, "q80_matmul_w8a8")
    return y


q80_w8a8.launches = 0


# q80_matvec_fq's work split: weight bytes of one stage at most (or one
# row), stages a block at most, the shared memory a block may take so that
# two fit on an SM (of the H100's 227 KB), and the longest row it takes.
MATVEC_STAGE_BYTES = 32768
MATVEC_MAX_STAGES = 4
MATVEC_SMEM = 112 * 1024
MAX_MATVEC_K = 16384


def matvec_smem(K: int, G: int, R: int, S: int) -> int:
    """Shared memory of a q80_matvec_fq block for an f32 row (a bf16 row
    takes 2 K bytes less), as the kernel lays it out
    (csrc/q80_matmul.cu:mv_smem)."""
    buf = lambda n: (n + 31) & ~15
    return 128 + S * (R * K + buf(R * G * 4)) + buf(4 * K) + K + G * 4


def matvec_plan(N: int, K: int, group_size: int, n_sm: int = _build.H100_SMS
                ) -> Tuple[int, int, int, int]:
    """-> (blocks, R, S, T) of ``q80_matvec_fq``: block b takes rows
    [N b / blocks, N (b + 1) / blocks) in tiles of R rows round a ring of S
    stages filled by bulk copy, T lanes a row.  From shapes alone, never
    from a value on the device (so a launch can be captured in a CUDA
    graph): up to two blocks an SM and at least 4 rows a block; where a
    block walks many tiles (the head), 8 lanes a row and tiles of 32 rows,
    one pass of the block; else a warp a row and tiles of 8 rows, so that
    the dot of one tile runs while the next arrives, or at group size 256
    and K <= 1024 a half-warp a row (a group a step, so a row's terms need
    no exchange between halves: chip_smoke.py bench q80 on an H100, 0.87x
    and 0.96x the warp's time at wqkv and w13, 1.09x and 1.11x at wo and
    w2); at most
    MATVEC_STAGE_BYTES of weights a stage; as many stages as the block has
    tiles, up to MATVEC_MAX_STAGES and within MATVEC_SMEM."""
    G = K // group_size
    blocks = max(1, min(2 * n_sm, -(-N // 4)))
    per_block = -(-N // blocks)
    T = (8 if per_block >= 64 else 16 if group_size == 256 and K <= 1024
         else 32)
    R = max(1, min(256 // T, per_block, MATVEC_STAGE_BYTES // K))
    S = min(MATVEC_MAX_STAGES, -(-per_block // R))
    while S > 1 and matvec_smem(K, G, R, S) > MATVEC_SMEM:
        S -= 1
    return blocks, R, S, T


def q80_matvec_fq(x: torch.Tensor, w: Q80Tensor, dtype=torch.bfloat16,
                  with_act: bool = False):
    """One raw activation row x (1, K) f32/bf16 x w -> (1, out) in
    `dtype`: ``act_quant_q80`` then ``q80_w8a8`` in one kernel,
    ``q80_matvec_fq`` on the card (the same int8 decisions; f32 sums in
    another order).  with_act=True also returns the int8 row (1, G, gs)
    and its scales (1, G) as the kernel computed them."""
    if x.device.type == "cpu":
        y = q80_matvec_fq_plain(x, w, dtype)
        return (y, *act_quant_q80_plain(x, w.group_size)) if with_act else y
    _check_weight(x, w)
    K, N, gs = w.in_dim, w.out_dim, w.group_size
    if (x.shape[0] != 1 or x.dtype not in _OUT_TYPES
            or dtype not in _OUT_TYPES or K % gs
            or not (gs == 256 or gs % 512 == 0) or K > MAX_MATVEC_K):
        raise ValueError(f"q80_matvec_fq takes one f32/bf16 row of at most "
                         f"{MAX_MATVEC_K} values into f32/bf16, group size "
                         f"256 or a multiple of 512, got {x.dtype} "
                         f"{tuple(x.shape)} -> {dtype}, gs={gs}")
    x = x.contiguous()
    y = torch.empty((1, N), dtype=dtype, device=x.device)
    xq = sa = None
    if with_act:
        xq = torch.empty((1, K // gs, gs), dtype=torch.int8, device=x.device)
        sa = torch.empty((1, K // gs), dtype=torch.float32, device=x.device)
    n_sm = _build.sm_count(x.device)
    blocks, R, S, T = matvec_plan(N, K, gs, n_sm)
    fn = _build.lib("q80_matmul").q80_matvec_fq
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), w.q.data_ptr(),
            w.scales.data_ptr(), y.data_ptr(), int(dtype == torch.bfloat16),
            xq.data_ptr() if with_act else None,
            sa.data_ptr() if with_act else None, K, N, gs, blocks, R, S, T,
            w8a8_ranges(N, K, gs, n_sm), _build.stream(x))
    q80_matvec_fq.launches += 1
    _build.check(rc, "q80_matvec_fq")
    return (y, xq, sa) if with_act else y


q80_matvec_fq.launches = 0


def q80_matmul_int8(x, w: Q80Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """W8A8 form: x (B, K) -> (B, out) in `dtype`.  One row takes
    ``q80_matvec_fq`` (one kernel on the card); more rows ``act_quant_q80``
    then ``q80_w8a8`` (two); a ``Q80Act`` ``q80_w8a8`` alone."""
    if isinstance(x, Q80Act):
        if x.group_size != w.group_size:
            raise ValueError(f"activation quantized at group size "
                             f"{x.group_size}, weight at {w.group_size}")
        return q80_w8a8(x.xq, x.sa, w, dtype)
    if x.shape[0] == 1:
        return q80_matvec_fq(x, w, dtype)
    xq, sa = act_quant_q80(x.contiguous(), w.group_size)
    return q80_w8a8(xq, sa, w, dtype)


# The rows form's kernels (csrc/q80_matmul.cu).  q80_matvec_rows and
# q80_matmul_rows take a group size that is a power of two from 16;
# q80_matmul_rows walks K in chunks of ROWS_KC inputs.
ROWS_KC = 32
# dynamic shared memory a block may have (the H100's 227 KB)
MAX_SMEM = 232448


def rows_group_ok(group_size: int) -> bool:
    """A group size the two new rows-form kernels take."""
    return group_size >= 16 and group_size & (group_size - 1) == 0


def matvec_rows_smem(K: int, G: int, R: int, S: int) -> int:
    """Shared memory of a q80_matvec_rows block (csrc/q80_matmul.cu:
    mvr_smem): S barriers, S stages of R weight rows and their scales, the
    row x as f32."""
    buf = lambda n: (n + 31) & ~15
    return 128 + S * (R * K + buf(R * G * 4)) + 4 * K


def matvec_rows_plan(N: int, K: int, group_size: int,
                     n_sm: int = _build.H100_SMS) -> Tuple[int, int, int, int]:
    """-> (blocks, R, S, T) of ``q80_matvec_rows``, from shapes alone (a
    CUDA graph captures the launch): ``matvec_plan``'s rule with the row x
    held as f32 and no quantized copy: up to two blocks an SM and at least
    4 rows a block; where a block walks many tiles (the head), 8 lanes a
    row and tiles of 32 rows, else a warp a row and tiles of 8 rows; at
    most MATVEC_STAGE_BYTES of weights a stage; as many stages as the
    block has tiles, up to MATVEC_MAX_STAGES and within MATVEC_SMEM."""
    G = K // group_size
    blocks = max(1, min(2 * n_sm, -(-N // 4)))
    per_block = -(-N // blocks)
    T = 8 if per_block >= 64 else 32
    R = max(1, min(256 // T, per_block, MATVEC_STAGE_BYTES // K))
    S = min(MATVEC_MAX_STAGES, -(-per_block // R))
    while S > 1 and matvec_rows_smem(K, G, R, S) > MATVEC_SMEM:
        S -= 1
    return blocks, R, S, T


def matvec_rows_fits(N: int, K: int, group_size: int) -> bool:
    """Whether ``q80_matvec_rows`` takes a row of K inputs into N at this
    group size (its plan's shared memory within a block's)."""
    if not rows_group_ok(group_size) or K % group_size:
        return False
    _, R, S, _ = matvec_rows_plan(N, K, group_size)
    return matvec_rows_smem(K, K // group_size, R, S) <= MAX_SMEM


def rows_smem(MB: int, BN: int, CS: int, S: int, x_bytes: int = 4) -> int:
    """Shared memory of a q80_matmul_rows block (csrc/q80_matmul.cu:
    rows_smem) for activations of x_bytes a value: S stages (MB int8
    weight rows of ROWS_KC and 16 bytes of padding, a scale for each 16
    inputs of a row, BN raw activation rows of ROWS_KC padded by 16 bytes),
    two buffers of a chunk's weights and activations as f32; the cluster's
    partial tile (CS > 1, rows of BN + 4 floats) lies over them."""
    stage = (MB * (ROWS_KC + 16) + MB * (ROWS_KC // 16) * 4
             + BN * (ROWS_KC * x_bytes + 16))
    body = S * stage + 2 * ROWS_KC * (MB + BN) * 4
    return max(body, MB * (BN + 4) * 4 if CS > 1 else 0)


def rows_plan(B: int, N: int, K: int, n_sm: int = _build.H100_SMS
              ) -> Tuple[int, int, int, int]:
    """-> (MB, BN, CS, S) of ``q80_matmul_rows`` from shapes alone (a CUDA
    graph captures the launch; the same split for f32 and bf16 rows); the
    choices are the fastest splits of ``chip_smoke.py bench rows sweep`` at
    a Qwen3-0.6B GGUF model's products on an H100:

    * BN activation rows a tile (8, 16, 32 or 64), the least that holds B
      up to 64, so that each weight byte leaves device memory once; but at
      most 32 where the weight fits int8_mma.L2_WEIGHT (a layer product):
      its two tiles at B = 64 read it together, the second from L2;
    * MB = 128 weight rows a block where 128-row tiles still give two
      blocks for every SM (the head), else 64;
    * K's chunks of ROWS_KC split over a cluster of CS blocks, doubled from
      1 up to int8_mma.MAX_CLUSTER and the chunk count while the grid has
      fewer than 1.5 blocks an SM, or 4 where a tile has at most 16 rows
      (bound by bytes: more blocks in flight);
    * a ring of 3 stages (the least with a chunk in flight while the block
      dequantizes the next one and multiplies the one before), or as many
      as a block has chunks."""
    BN = next(bn for bn in (8, 16, 32, 64) if bn >= min(B, 64))
    if N * K <= int8_mma.L2_WEIGHT:
        BN = min(BN, 32)
    col_tiles = -(-B // BN)
    MB = 128 if -(-N // 128) * col_tiles >= 2 * n_sm else 64
    tiles = -(-N // MB) * col_tiles
    chunks = -(-K // ROWS_KC)
    want = 4 * n_sm if BN <= 16 else 1.5 * n_sm
    CS = 1
    while tiles * CS < want and 2 * CS <= min(int8_mma.MAX_CLUSTER, chunks):
        CS *= 2
    return MB, BN, CS, min(3, -(-chunks // CS))


def _rows_args(x: torch.Tensor, w: Q80Tensor, dtype, name: str):
    """The checks the rows-form kernels share -> x contiguous and 16-byte
    aligned."""
    _check_weight(x, w)
    if x.dtype not in _OUT_TYPES or dtype not in _OUT_TYPES:
        raise ValueError(f"{name} takes f32/bf16, got {x.dtype} -> {dtype}")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def q80_matvec_rows(x: torch.Tensor, w: Q80Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """rows form at one row: x (1, K) f32/bf16 -> (1, out) in `dtype`;
    kernel ``q80_matvec_rows`` (split by ``matvec_rows_plan``) on the card,
    for a group size that is a power of two from 16."""
    if x.device.type == "cpu":
        return q80_matmul_rows_plain(x, w, dtype)
    x = _rows_args(x, w, dtype, "q80_matvec_rows")
    K, N, gs = w.in_dim, w.out_dim, w.group_size
    if x.shape[0] != 1 or not matvec_rows_fits(N, K, gs):
        raise ValueError(f"q80_matvec_rows takes one row, a group size that "
                         f"is a power of two from 16 and a row that fits "
                         f"shared memory, got {tuple(x.shape)}, gs={gs}")
    int8_mma.init(x.device, "q80_matmul_init")
    y = torch.empty((1, N), dtype=dtype, device=x.device)
    plan = matvec_rows_plan(N, K, gs, _build.sm_count(x.device))
    fn = _build.lib("q80_matmul").q80_matvec_rows
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), w.q.data_ptr(),
            w.scales.data_ptr(), y.data_ptr(), int(dtype == torch.bfloat16),
            K, N, gs, *plan, _build.stream(x))
    q80_matvec_rows.launches += 1
    _build.check(rc, "q80_matvec_rows")
    return y


q80_matvec_rows.launches = 0


def q80_matmul_rows(x: torch.Tensor, w: Q80Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """rows form: x (B, K) f32/bf16 -> (B, out) in `dtype`; the tiled
    kernel ``q80_matmul_rows`` (split by ``rows_plan``) on the card, for a
    group size that is a power of two from 16."""
    if x.device.type == "cpu":
        return q80_matmul_rows_plain(x, w, dtype)
    x = _rows_args(x, w, dtype, "q80_matmul_rows")
    B, K = x.shape
    if B < 1 or not rows_group_ok(w.group_size):
        raise ValueError(f"q80_matmul_rows takes a group size that is a "
                         f"power of two from 16 and B >= 1, got "
                         f"gs={w.group_size}, B={B}")
    int8_mma.init(x.device, "q80_matmul_init")
    y = torch.empty((B, w.out_dim), dtype=dtype, device=x.device)
    plan = rows_plan(B, w.out_dim, K, _build.sm_count(x.device))
    fn = _build.lib("q80_matmul").q80_matmul_rows
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), w.q.data_ptr(),
            w.scales.data_ptr(), y.data_ptr(), int(dtype == torch.bfloat16),
            B, K, w.out_dim, w.group_size, *plan, _build.stream(x))
    q80_matmul_rows.launches += 1
    _build.check(rc, "q80_matmul_rows")
    return y


q80_matmul_rows.launches = 0


def q80_matmul_rows_warp(x: torch.Tensor, w: Q80Tensor,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """rows form, the first rows kernel (a warp a row, any group size): x (B, K)
    -> (B, out) in `dtype`; kernel ``q80_matmul_rows_warp`` on the card."""
    if x.device.type == "cpu":
        return q80_matmul_rows_plain(x, w, dtype)
    x = _rows_args(x, w, dtype, "q80_matmul_rows_warp")
    B, K = x.shape
    y = torch.empty((B, w.out_dim), dtype=dtype, device=x.device)
    fn = _build.lib("q80_matmul").q80_matmul_rows_warp
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), w.q.data_ptr(),
            w.scales.data_ptr(), y.data_ptr(), int(dtype == torch.bfloat16),
            B, K, w.out_dim, w.group_size, _build.stream(x))
    q80_matmul_rows_warp.launches += 1
    _build.check(rc, "q80_matmul_rows_warp")
    return y


q80_matmul_rows_warp.launches = 0


def q80_rows(x: torch.Tensor, w: Q80Tensor,
             dtype=torch.bfloat16) -> torch.Tensor:
    """The rows form, its kernel chosen by shape: one row
    ``q80_matvec_rows``, more ``q80_matmul_rows`` (a group size that is a
    power of two from 16), else ``q80_matmul_rows_warp``."""
    if x.device.type == "cpu":
        return q80_matmul_rows_plain(x, w, dtype)
    if rows_group_ok(w.group_size):
        if x.shape[0] == 1 and matvec_rows_fits(w.out_dim, w.in_dim,
                                                w.group_size):
            return q80_matvec_rows(x, w, dtype)
        return q80_matmul_rows(x, w, dtype)
    return q80_matmul_rows_warp(x, w, dtype)


def q80_matmul(x, w: Q80Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., in) @ dequant(w).T -> (..., out) in `dtype`, in the form
    the weight was loaded for (W8A8 or rows); x a tensor, or a ``Q80Act``
    for a W8A8 weight."""
    if w.q.dim() != 2:
        raise ValueError("index stacked weights with Q80Tensor.layer(i)")
    lead = x.shape[:-1]
    if isinstance(x, Q80Act):
        if not w.w8a8:
            raise ValueError("a quantized activation needs a W8A8 weight")
        return q80_matmul_int8(x, w, dtype).reshape(*lead, w.out_dim)
    x2 = x.reshape(-1, w.in_dim)
    fn = q80_matmul_int8 if w.w8a8 else q80_rows
    return fn(x2, w, dtype).reshape(*lead, w.out_dim)
