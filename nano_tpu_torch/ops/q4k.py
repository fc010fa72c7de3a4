"""Q4K 4-bit k-quant: the host-side weight quantizer and tensor frames,
the activation fake-quant and the fused-dequant matmul.

Port of ``nano_tpu/ops/q4k.py``.  The scheme (reference:
infer/tensor.c:71-483): the last axis of a tensor is split into 256-value
blocks; each block holds 8 groups of 32 values quantized asymmetrically to
4 bits (``x ~= v * s_g - b_g``, ``b_g >= 0``), with the 8 group scales and
biases themselves quantized to 6 bits against two per-block f32
super-scales.  One block is 160 bytes: u32 header, u32 length, u32 meta,
f32 s_scale, f32 s_bias, 12 B packed 6-bit scale/bias table, 128 B packed
nibbles.

Device layout (``Q4KTensor``, the JAX package's "packed" layout): byte
``g*16+j`` of a row holds value ``g*32+j`` in its low nibble and value
``g*32+16+j`` in its high nibble, so a 32-group is exactly 16 bytes; the
f32 group scales and biases (already dequantized from 6 bits) sit beside
it.  The file's interleaved nibble pairs are re-laid out at load.

The C engine quantizes the *activation* to Q4K before every quantized
matmul (reference: infer/infer.c:781-785).  ``fake_quant_act`` reproduces
that quantize->dequantize with the same rounding, bit for bit, and
``q4k_matmul_f32`` is the TPU kernel ``_q4k_kernel``'s math: f32 dequant
``v*s - b`` and an f32 dot.  Unlike the TPU, the card needs no
activation permutation (``_permute_act``): a lane reads a whole group.

The activation's quantization is kept as integers (``Q4KAct``:
``act_quant_q4k_packed``, the values packed in the weights' layout),
written by the norm or SwiGLU kernel that makes the activation
(``ops/norm_quant.py``) or by ``q4k_act_quant``.  One row (a decode step)
takes ``q4k_matvec_fq``, which rebuilds the fake-quantized row from it
and takes ``_q4k_kernel``'s f32 dot; more rows (a batched step, a
prefill) the C engine's integer expansion of the product on the int8
tensor cores (``q4k_matmul_w4a4``; the JAX package's
``q4k_matmul_int8``).  Each wrapper runs its hand-written CUDA kernel
(``csrc/q4k.cu``) for CUDA tensors and its plain PyTorch version
(``*_plain``) only for tensors on the CPU.  ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from nano_tpu_torch.ops import _build, int8_mma

BLOCK_LEN = 256
GROUP_LEN = 32
GROUPS_PER_BLOCK = 8
BLOCK_BYTES = 160
QUANT_TYPE_Q4K = 0x42

_FLT_MAX = np.float32(np.finfo(np.float32).max)
_FLT_TRUE_MIN = np.float32(1.401298464324817e-45)  # smallest denormal
_MAGIC = np.float32(12582912.0)  # 1.5 * 2**23


# =====================================================================
# host side (numpy): rounding, block unpacking, tensor frames
# =====================================================================

def nearest_int_np(x: np.ndarray) -> np.ndarray:
    """The C engine's nearest_int (infer/tensor.c:4-9): add 1.5*2^23 and
    read the mantissa bits."""
    val = (np.asarray(x, np.float32) + _MAGIC).view(np.int32)
    return (val & 0x007FFFFF) - 0x00400000


def n_blocks_per_line(n: int) -> int:
    return -(-n // BLOCK_LEN)


def _group_params_np(vals: np.ndarray, valid: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group (s, b) from (nb, 8, 32) values and their validity mask,
    with the C loop's semantics (infer/tensor.c:157-170): the max starts at
    FLT_TRUE_MIN, the min at FLT_MAX, and only valid values update them."""
    vmax = np.max(np.where(valid, vals, -_FLT_MAX), axis=-1)
    vmax = np.maximum(vmax, _FLT_TRUE_MIN).astype(np.float32)
    vmin = np.min(np.where(valid, vals, _FLT_MAX), axis=-1).astype(np.float32)
    neg = vmin <= np.float32(0.0)
    s = np.where(neg, (vmax - vmin) / np.float32(15.0),
                 vmax / np.float32(15.0)).astype(np.float32)
    b = np.where(neg, -vmin, np.float32(0.0)).astype(np.float32)
    return s, b


def quantize_lines_np(lines: np.ndarray) -> np.ndarray:
    """(rows, n) f32 -> (rows * n_blocks_per_line, 160) uint8 blocks, the C
    engine's weight quantizer (infer/tensor.c:144-251) in IEEE f32 host
    arithmetic: the last block of a line is partial when n % 256 != 0, and
    an all-zero group gets s == 0 and values 0."""
    lines = np.ascontiguousarray(lines, np.float32)
    rows, n = lines.shape
    nbpl = n_blocks_per_line(n)
    npad = nbpl * BLOCK_LEN
    x = np.zeros((rows, npad), np.float32)
    x[:, :n] = lines
    valid = np.zeros((npad,), bool)
    valid[:n] = True

    nb = rows * nbpl
    vals = x.reshape(nb, GROUPS_PER_BLOCK, GROUP_LEN)
    vmask = np.broadcast_to(
        valid.reshape(nbpl, GROUPS_PER_BLOCK, GROUP_LEN),
        (rows, nbpl, GROUPS_PER_BLOCK, GROUP_LEN)
    ).reshape(nb, GROUPS_PER_BLOCK, GROUP_LEN)

    s, b = _group_params_np(vals, vmask)                       # (nb, 8)

    # 4-bit values: nearest_int((x + b) / s) & 0xF, 0 where s == 0 or
    # outside the line
    safe_s = np.where(s == 0.0, np.float32(1.0), s)
    v = nearest_int_np((vals + b[..., None]).astype(np.float32)
                       / safe_s[..., None]) & 0x0F
    v = np.where((s[..., None] == 0.0) | ~vmask, 0, v).astype(np.uint8)
    v = v.reshape(nb, BLOCK_LEN)

    # 6-bit quantization of s and b against the block's super-scales; both
    # maxima start at FLT_TRUE_MIN, so all-zero biases still give a tiny
    # positive s_bias (infer/tensor.c:209-219)
    s_max = s.max(axis=1).astype(np.float32)
    b_max = np.maximum(b.max(axis=1), _FLT_TRUE_MIN).astype(np.float32)
    s_max = np.maximum(s_max, _FLT_TRUE_MIN).astype(np.float32)
    s_scale = (s_max / np.float32(63.0)).astype(np.float32)
    s_bias = (b_max / np.float32(63.0)).astype(np.float32)
    safe_ss = np.where(s_scale == 0.0, np.float32(1.0), s_scale)
    safe_sb = np.where(s_bias == 0.0, np.float32(1.0), s_bias)
    sq = np.where(s_scale[:, None] == 0.0, 0,
                  nearest_int_np(s / safe_ss[:, None]) & 0x3F).astype(np.uint8)
    bq = np.where(s_bias[:, None] == 0.0, 0,
                  nearest_int_np(b / safe_sb[:, None]) & 0x3F).astype(np.uint8)

    # the packed table (infer/tensor.c:228-241)
    sb = np.zeros((nb, 12), np.uint8)
    sb[:, 0:4] = ((sq[:, 4:8] & 0x30) << 2) | (sq[:, 0:4] & 0x3F)
    sb[:, 4:8] = ((bq[:, 4:8] & 0x30) << 2) | (bq[:, 0:4] & 0x3F)
    sb[:, 8:12] = ((bq[:, 4:8] & 0x0F) << 4) | (sq[:, 4:8] & 0x0F)

    packed_v = (v[:, 0::2] & 0x0F) | (v[:, 1::2] << 4)          # (nb, 128)

    lens = np.full((rows, nbpl), BLOCK_LEN, np.uint32)
    lens[:, -1] = n - (nbpl - 1) * BLOCK_LEN
    lens = lens.reshape(nb)

    blocks = np.zeros((nb, BLOCK_BYTES), np.uint8)
    blocks[:, 0:4] = np.frombuffer(
        np.full(nb, QUANT_TYPE_Q4K, np.uint32).tobytes(), np.uint8
    ).reshape(nb, 4)
    blocks[:, 4:8] = lens.astype("<u4").view(np.uint8).reshape(nb, 4)
    # meta (bytes 8:12) stays zero
    blocks[:, 12:16] = s_scale.astype("<f4").view(np.uint8).reshape(nb, 4)
    blocks[:, 16:20] = s_bias.astype("<f4").view(np.uint8).reshape(nb, 4)
    blocks[:, 20:32] = sb
    blocks[:, 32:160] = packed_v
    return blocks


def pack_tensor_frame(t: np.ndarray) -> bytes:
    """f32 tensor -> one self-describing Q4K frame (the inverse of
    ``parse_tensor_frame``).  Lines are the last axis; the leading axes
    flatten to rows (infer/tensor.c:281-310)."""
    shape = t.shape
    if not 1 <= len(shape) <= 6:
        raise ValueError(f"a Q4K frame holds 1 to 6 axes, got {shape}")
    n = shape[-1]
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    blocks = quantize_lines_np(np.asarray(t, np.float32).reshape(rows, n))
    nb = blocks.shape[0]
    total = 8 + 4 + 4 + 24 + 4 + nb * BLOCK_BYTES
    head = np.zeros(44, np.uint8)
    head[0:8] = np.array([total], "<u8").view(np.uint8)
    head[8:12] = np.array([QUANT_TYPE_Q4K], "<u4").view(np.uint8)
    head[12:16] = np.array([len(shape)], "<u4").view(np.uint8)
    shp = np.zeros(6, "<u4")
    shp[: len(shape)] = shape
    head[16:40] = shp.view(np.uint8)
    head[40:44] = np.array([nb], "<u4").view(np.uint8)
    return head.tobytes() + blocks.tobytes()


def unpack_blocks_np(blocks: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(nb, 160) uint8 -> (values uint8 (nb, 256), s f32 (nb, 8), b f32
    (nb, 8), lengths u32 (nb,)).  s and b are the dequantized group
    parameters (reference: infer/tensor.c:113-141)."""
    blocks = np.ascontiguousarray(blocks, np.uint8).reshape(-1, BLOCK_BYTES)
    nb = blocks.shape[0]
    lens = blocks[:, 4:8].copy().view("<u4").reshape(nb)
    s_scale = blocks[:, 12:16].copy().view("<f4").reshape(nb)
    s_bias = blocks[:, 16:20].copy().view("<f4").reshape(nb)
    sb = blocks[:, 20:32]
    sq = np.zeros((nb, 8), np.uint8)
    bq = np.zeros((nb, 8), np.uint8)
    sq[:, 0:4] = sb[:, 0:4] & 0x3F
    sq[:, 4:8] = (((sb[:, 0:4] >> 6) << 4) | (sb[:, 8:12] & 0x0F)) & 0x3F
    bq[:, 0:4] = sb[:, 4:8] & 0x3F
    bq[:, 4:8] = (((sb[:, 4:8] >> 6) << 4) | (sb[:, 8:12] >> 4)) & 0x3F
    s = (sq.astype(np.float32) * s_scale[:, None]).astype(np.float32)
    b = (bq.astype(np.float32) * s_bias[:, None]).astype(np.float32)
    pv = blocks[:, 32:160]
    v = np.zeros((nb, BLOCK_LEN), np.uint8)
    v[:, 0::2] = pv & 0x0F
    v[:, 1::2] = pv >> 4
    return v, s, b, lens


def dequantize_lines_np(blocks: np.ndarray, rows: int, n: int) -> np.ndarray:
    """Blocks of `rows` lines of length n -> (rows, n) f32."""
    v, s, b, _lens = unpack_blocks_np(blocks)
    vals = (v.reshape(-1, GROUPS_PER_BLOCK, GROUP_LEN).astype(np.float32)
            * s[:, :, None] - b[:, :, None])
    out = vals.reshape(rows, n_blocks_per_line(n) * BLOCK_LEN)[:, :n]
    return np.ascontiguousarray(out, np.float32)


def parse_tensor_frame(data: bytes, offset: int
                       ) -> Tuple[np.ndarray, Tuple[int, ...], int]:
    """One frame (u64 total, u32 header, u32 ndim, u32 shape[6], u32
    num_blocks, blocks; reference: infer/tensor.c:71-110) -> (blocks
    uint8 (nb, 160), shape, next offset)."""
    total = int(np.frombuffer(data, "<u8", 1, offset)[0])
    header, ndim = np.frombuffer(data, "<u4", 2, offset + 8)
    if header != QUANT_TYPE_Q4K:
        raise ValueError(f"not a Q4K frame: header 0x{int(header):x}")
    shape = tuple(int(x) for x in
                  np.frombuffer(data, "<u4", 6, offset + 16)[:ndim])
    nb = int(np.frombuffer(data, "<u4", 1, offset + 40)[0])
    blocks = np.frombuffer(data, np.uint8, nb * BLOCK_BYTES,
                           offset + 44).reshape(nb, BLOCK_BYTES)
    if total != 44 + nb * BLOCK_BYTES:
        raise ValueError("Q4K frame length mismatch")
    return blocks, shape, offset + total


def packed_from_blocks(blocks: np.ndarray, out_dim: int, in_dim: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """File blocks of an (out, in) matrix -> the device layout as numpy:
    (packed uint8 (out, n_pad/2), scales f32 (out, n_pad/32), biases)."""
    v, s, b, _l = unpack_blocks_np(blocks)
    npad = n_blocks_per_line(in_dim) * BLOCK_LEN
    v = v.reshape(out_dim, npad // GROUP_LEN, 2, GROUP_LEN // 2)
    packed = (v[:, :, 0, :] | (v[:, :, 1, :] << 4)).reshape(out_dim, npad // 2)
    return packed, s.reshape(out_dim, -1), b.reshape(out_dim, -1)


# =====================================================================
# device tensor
# =====================================================================

@dataclass
class Q4KTensor:
    """Q4K weight in the packed device layout.

    packed: uint8 (..., out, n_pad // 2); byte g*16+j holds value g*32+j
            (low nibble) and value g*32+16+j (high nibble)
    scales, biases: f32 (..., out, n_pad // 32), the dequantized group
            parameters
    in_dim: the true contraction length (n_pad rounds it up to 256)
    """
    packed: torch.Tensor
    scales: torch.Tensor
    biases: torch.Tensor
    in_dim: int

    @property
    def out_dim(self) -> int:
        return self.packed.shape[-2]

    @property
    def n_pad(self) -> int:
        return self.packed.shape[-1] * 2

    @classmethod
    def from_blocks(cls, blocks: np.ndarray, out_dim: int, in_dim: int,
                    device=None) -> "Q4KTensor":
        p, s, b = packed_from_blocks(blocks, out_dim, in_dim)
        return cls(packed=torch.from_numpy(p).to(device),
                   scales=torch.from_numpy(s).to(device),
                   biases=torch.from_numpy(b).to(device), in_dim=in_dim)

    @classmethod
    def stack(cls, tensors) -> "Q4KTensor":
        """(out, ...) tensors of one in_dim -> one contiguous (L, out, ...)
        tensor."""
        return cls(packed=torch.stack([t.packed for t in tensors]),
                   scales=torch.stack([t.scales for t in tensors]),
                   biases=torch.stack([t.biases for t in tensors]),
                   in_dim=tensors[0].in_dim)

    def layer(self, i: int) -> "Q4KTensor":
        """The i-th matrix of a stacked (L, out, ...) tensor (a view)."""
        return replace(self, packed=self.packed[i], scales=self.scales[i],
                       biases=self.biases[i])

    def to(self, device) -> "Q4KTensor":
        return replace(self, packed=self.packed.to(device),
                       scales=self.scales.to(device),
                       biases=self.biases.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """-> (..., out, in_dim) dense weight, the affine run in `dtype`."""
        *lead, out, nh = self.packed.shape
        ng = nh // (GROUP_LEN // 2)
        p = self.packed.reshape(*lead, out, ng, GROUP_LEN // 2)
        v = torch.cat([p & 0x0F, p >> 4], dim=-1).to(dtype)
        w = (v * self.scales[..., None].to(dtype)
             - self.biases[..., None].to(dtype))
        return w.reshape(*lead, out, ng * GROUP_LEN)[..., :self.in_dim]

    def dequantize_rows(self, ids: torch.Tensor, dtype=torch.float32
                        ) -> torch.Tensor:
        """Gather + dequantize rows (an embedding lookup on a Q4K table)."""
        return replace(self, packed=self.packed[ids], scales=self.scales[ids],
                       biases=self.biases[ids]).dequantize(dtype)


@dataclass
class Q4KAct:
    """An activation (..., n) in its Q4K integer form, as
    ``act_quant_q4k_packed`` writes it: by ``q4k_act_quant`` or by the
    norm or SwiGLU kernel that produced the activation
    (``ops/norm_quant.py``).

    vp:         uint8 (B, n_pad // 2), the values packed in the weights'
                layout (0 at positions >= n)
    sa, ba, c:  f32 (B, n_pad // 32), s_eff, b_eff and sa * A - n_g * ba
                of each group
    shape:      the activation's shape (..., n), B rows
    """
    vp: torch.Tensor
    sa: torch.Tensor
    ba: torch.Tensor
    c: torch.Tensor
    shape: torch.Size

    @property
    def rows(self) -> int:
        return self.vp.shape[0]

    @property
    def in_dim(self) -> int:
        return self.shape[-1]

    def parts(self) -> Tuple[torch.Tensor, ...]:
        return self.vp, self.sa, self.ba, self.c


# =====================================================================
# plain PyTorch versions (CPU path; on the card only for comparisons)
# =====================================================================

def _const(c, like: torch.Tensor) -> torch.Tensor:
    """c as an f32 scalar tensor on like's device.  Divisions divide by such
    a tensor: on a CUDA tensor a division by a Python number is a multiply
    by its reciprocal, not an IEEE division."""
    return torch.full((), float(c), dtype=torch.float32, device=like.device)


def nearest_int(x: torch.Tensor) -> torch.Tensor:
    """nearest_int_np on an f32 tensor -> int32 (exact for every input,
    NaN and inf included, as the C engine's bit trick)."""
    val = (x + _const(_MAGIC, x)).view(torch.int32)
    return (val & 0x007FFFFF) - 0x00400000


def act_quant_q4k_plain(x2d: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Q4K activation quantization, the INTEGER form.

    x2d (B, n) -> (values int8 (B, G, 32) in [0, 15], s_eff f32 (B, G),
    b_eff f32 (B, G)), G = n rounded up to 256, / 32; the dequantized
    activation is ``v * s_eff - b_eff``.  The masked formulation of the JAX
    package's ``act_quant_q4k`` (max starts at -FLT_MAX, min at FLT_MAX,
    only valid positions update them; reference: infer/tensor.c:144-251).
    Its aligned fast path computes the same values (nano_tpu's tests pin
    that), so one formulation serves every n."""
    B, n = x2d.shape
    nbpl = n_blocks_per_line(n)
    npad = nbpl * BLOCK_LEN
    xf = x2d.float()
    if npad != n:
        xf = torch.nn.functional.pad(xf, (0, npad - n))
    valid = (torch.arange(npad, device=xf.device) < n).reshape(
        nbpl, GROUPS_PER_BLOCK, GROUP_LEN)
    vals = xf.reshape(B, nbpl, GROUPS_PER_BLOCK, GROUP_LEN)
    zero = _const(0.0, xf)

    vmax = torch.where(valid, vals, _const(-_FLT_MAX, xf)).amax(-1)
    vmax = torch.maximum(vmax, _const(_FLT_TRUE_MIN, xf))
    vmin = torch.where(valid, vals, _const(_FLT_MAX, xf)).amin(-1)
    neg = vmin <= 0.0
    s = torch.where(neg, vmax - vmin, vmax) / _const(15.0, xf)
    b = torch.where(neg, -vmin, zero)

    safe_s = torch.where(s == 0.0, _const(1.0, xf), s)
    v = nearest_int((vals + b[..., None]) / safe_s[..., None]) & 0x0F
    v = torch.where((s[..., None] == 0.0) | ~valid, 0, v)

    s_max = torch.maximum(s.amax(-1), _const(_FLT_TRUE_MIN, xf))
    b_max = torch.maximum(b.amax(-1), _const(_FLT_TRUE_MIN, xf))
    s_scale = (s_max / _const(63.0, xf))[..., None]
    s_bias = (b_max / _const(63.0, xf))[..., None]
    one = _const(1.0, xf)
    sq = torch.where(s_scale == 0.0, 0,
                     nearest_int(s / torch.where(s_scale == 0.0, one, s_scale))
                     & 0x3F)
    bq = torch.where(s_bias == 0.0, 0,
                     nearest_int(b / torch.where(s_bias == 0.0, one, s_bias))
                     & 0x3F)
    s_eff = sq.float() * s_scale
    b_eff = bq.float() * s_bias
    G = nbpl * GROUPS_PER_BLOCK
    return (v.reshape(B, G, GROUP_LEN).to(torch.int8),
            s_eff.reshape(B, G), b_eff.reshape(B, G))


def fake_quant_act_plain(x2d: torch.Tensor) -> torch.Tensor:
    """x2d (B, n) -> (B, n_pad) f32: the Q4K quantize->dequantize of the
    activation, positions >= n written as 0.  Its first n columns equal
    the JAX package's ``fake_quant_act`` bit for bit: the same integer
    decisions, then ``v * s_eff - b_eff`` as two rounded f32 operations."""
    B, n = x2d.shape
    v, s_eff, b_eff = act_quant_q4k_plain(x2d)
    deq = (v.float() * s_eff[..., None] - b_eff[..., None]).reshape(B, -1)
    keep = torch.arange(deq.shape[1], device=deq.device) < n
    return torch.where(keep, deq, _const(0.0, deq))


def fake_quant_packed_plain(act: Q4KAct) -> torch.Tensor:
    """The fake-quantized activation (B, n_pad) f32 rebuilt from its
    integer form: v * sa - ba, the product and the difference each
    rounded, 0 at positions >= n; bit-equal to ``fake_quant_act_plain``
    of the activation the form was made from."""
    B, G = act.sa.shape
    p = act.vp.reshape(B, G, GROUP_LEN // 2)
    v = torch.cat([p & 0x0F, p >> 4], dim=-1).float()
    deq = (v * act.sa[..., None] - act.ba[..., None]).reshape(B, -1)
    keep = torch.arange(deq.shape[1], device=deq.device) < act.in_dim
    return torch.where(keep, deq, _const(0.0, deq))


def q4k_matmul_plain(xq: torch.Tensor, w: Q4KTensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """Fake-quantized activation (B, n_pad or in_dim) x w -> (B, out):
    f32 dequant ``v * s - b`` and an f32 dot over the first in_dim
    positions, the math of the TPU kernel ``_q4k_kernel``."""
    x = xq[:, :w.in_dim].float()
    return (x @ w.dequantize(torch.float32).t()).to(dtype)


def pack_act_q4k(v: torch.Tensor, sa: torch.Tensor, ba: torch.Tensor,
                 n: int) -> Tuple[torch.Tensor, ...]:
    """The integer form (values (B, G, 32) in [0, 15], 0 at positions >= n;
    s_eff, b_eff (B, G)) -> (vp u8 (B, G * 16), sa, ba, c f32 (B, G)): the
    values packed in the weights' own layout (byte g*16+j holds value
    g*32+j in its low nibble and g*32+16+j in its high nibble), and
    c = sa * A - n_g * ba with A the group's value sum and n_g its
    positions < n, each product and the difference rounded to f32."""
    B, G, _ = v.shape
    vi = v.to(torch.uint8)
    vp = (vi[..., :GROUP_LEN // 2] | (vi[..., GROUP_LEN // 2:] << 4))
    A = v.to(torch.int32).sum(-1).float()
    n_g = (n - torch.arange(G, device=v.device) * GROUP_LEN).clamp(
        0, GROUP_LEN).float()
    c = sa * A - n_g * ba
    return vp.reshape(B, G * GROUP_LEN // 2).contiguous(), sa, ba, c


def act_quant_q4k_packed_plain(x2d: torch.Tensor
                               ) -> Tuple[torch.Tensor, ...]:
    """x2d (B, n) -> (vp u8 (B, n_pad / 2), sa, ba, c f32 (B, G)):
    ``act_quant_q4k_plain``'s integer decisions packed by
    ``pack_act_q4k`` for ``q4k_matmul_w4a4``."""
    return pack_act_q4k(*act_quant_q4k_plain(x2d), x2d.shape[1])


def q4k_matmul_w4a4_plain(vp: torch.Tensor, sa: torch.Tensor,
                          ba: torch.Tensor, c: torch.Tensor, w: Q4KTensor,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """The activation's integer form (``act_quant_q4k_packed_plain``) x w
    -> (B, out): the Q4K product as the C engine expands it
    (infer/tensor.c:359-434; the JAX package's ``q4k_matmul_int8``).  With
    a = sa * va - ba and w = s * q - m over a group's n_g positions < in_dim,

        y[b, o] = sum_g sa * s * P - c * m - ba * s * Q,

    P = sum va * q and Q = sum q over those positions (the weight's nibbles
    at positions >= in_dim masked to 0), exact integers; c from the
    activation side.  P runs as an f32 product of integers: every partial
    sum is below 32 * 225 < 2^24, so any order gives it exactly."""
    B = vp.shape[0]
    G, out = w.scales.shape[-1], w.out_dim
    half = GROUP_LEN // 2

    def unpack(p, rows):
        p = p.reshape(rows, G, half)
        return torch.cat([p & 0x0F, p >> 4], dim=-1)       # (rows, G, 32)

    keep = (torch.arange(G * GROUP_LEN, device=vp.device)
            < w.in_dim).reshape(G, GROUP_LEN)
    q = torch.where(keep, unpack(w.packed, out), 0).float()
    va = unpack(vp, B).float()
    P = torch.einsum("bgk,ogk->bgo", va, q)                 # (B, G, out)
    sQ = (w.scales * q.sum(-1)).t()                         # (G, out)
    s, m = w.scales.t(), w.biases.t()
    y = ((sa[:, :, None] * s[None]) * P - c[:, :, None] * m[None]
         - ba[:, :, None] * sQ[None])
    return y.sum(1).to(dtype)


# =====================================================================
# kernel wrappers
# =====================================================================

_OUT_TYPES = (torch.float32, torch.bfloat16)


def _check_weight(w: Q4KTensor, device: torch.device, dtype) -> None:
    if w.packed.dim() != 2:
        raise ValueError("index stacked weights with Q4KTensor.layer(i)")
    parts = (w.packed, w.scales, w.biases)
    if (any(p.device != device or not p.is_contiguous() for p in parts)
            or w.packed.dtype != torch.uint8
            or w.scales.dtype != torch.float32
            or w.biases.dtype != torch.float32
            or w.scales.shape != (w.out_dim, w.n_pad // GROUP_LEN)
            or w.biases.shape != w.scales.shape
            or w.packed.data_ptr() % 16 or dtype not in _OUT_TYPES):
        raise ValueError("Q4K weight must be contiguous uint8 packed and f32 "
                         "scales/biases on the activation's device, "
                         "16-byte aligned, with f32/bf16 output")


def fake_quant_act(x2d: torch.Tensor) -> torch.Tensor:
    """x2d (B, n) f32/bf16 -> (B, n_pad) f32 fake-quantized activation,
    positions >= n zero; kernel ``q4k_fake_quant`` on the card."""
    if x2d.device.type == "cpu":
        return fake_quant_act_plain(x2d)
    if x2d.dim() != 2 or x2d.dtype not in _OUT_TYPES:
        raise ValueError(f"fake_quant_act takes f32/bf16 (B, n), got "
                         f"{x2d.dtype} {tuple(x2d.shape)}")
    x2d = x2d.contiguous()
    B, n = x2d.shape
    n_pad = n_blocks_per_line(n) * BLOCK_LEN
    out = torch.empty((B, n_pad), dtype=torch.float32, device=x2d.device)
    fn = _build.lib("q4k").q4k_fake_quant
    rc = fn(x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), out.data_ptr(),
            B, n, n_pad, _build.stream(x2d))
    fake_quant_act.launches += 1
    _build.check(rc, "q4k_fake_quant")
    return out


fake_quant_act.launches = 0


def q4k_matmul_f32(xq: torch.Tensor, w: Q4KTensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Fake-quantized activation xq (B, n_pad) f32 x w -> (B, out) in
    `dtype`; kernel ``q4k_matmul`` on the card (positions >= in_dim of
    xq are never read)."""
    if xq.device.type == "cpu":
        return q4k_matmul_plain(xq, w, dtype)
    B = xq.shape[0]
    if (xq.dim() != 2 or xq.shape[1] != w.n_pad or xq.dtype != torch.float32
            or not xq.is_contiguous() or xq.data_ptr() % 16):
        raise ValueError(f"q4k_matmul takes a contiguous, 16-byte aligned "
                         f"f32 (B, {w.n_pad}), got {xq.dtype} "
                         f"{tuple(xq.shape)}")
    _check_weight(w, xq.device, dtype)
    y = torch.empty((B, w.out_dim), dtype=dtype, device=xq.device)
    fn = _build.lib("q4k").q4k_matmul
    rc = fn(xq.data_ptr(), w.packed.data_ptr(), w.scales.data_ptr(),
            w.biases.data_ptr(), y.data_ptr(), int(dtype == torch.bfloat16),
            B, w.n_pad, w.in_dim, w.out_dim, _build.stream(xq))
    q4k_matmul_f32.launches += 1
    _build.check(rc, "q4k_matmul")
    return y


q4k_matmul_f32.launches = 0


# q4k_matvec_fq's work split: lanes a row at most (a block's threads), the
# ring's stages at most, the shared memory a block may take so that two fit
# on an SM (of the H100's 227 KB), and the longest padded row it takes
# (csrc/q4k.cu: kMvThreads, kMvMaxStages, kMvMaxGroups; a lane holds its
# groups' rebuilt values in registers).  A wider raw row takes the two
# kernels before it, q4k_fake_quant and q4k_matmul.
MATVEC_THREADS = 256
MATVEC_MAX_STAGES = 16
MATVEC_SMEM = 112 * 1024
MAX_MATVEC_PAD = 32768


def matvec_smem(R: int, n_pad: int, S: int) -> int:
    """Shared memory of a q4k_matvec_fq block (csrc/q4k.cu:mv4_smem): the
    barriers and the partial sums (256 bytes), S stages of R packed rows
    with their scales and biases (each with a 16-byte pad, rounded to
    16)."""
    buf = lambda n: (n + 31) & ~15
    G = n_pad // GROUP_LEN
    return 256 + S * (R * n_pad // 2 + 2 * buf(R * G * 4))


def matvec_plan(N: int, n_pad: int, n_sm: int = _build.H100_SMS
                ) -> Tuple[int, int, int, int]:
    """-> (blocks, R, S, T) of ``q4k_matvec_fq``: block b takes rows
    [N b / blocks, N (b + 1) / blocks) in tiles of R rows round a ring of S
    stages filled by bulk copy, T lanes a row.  From shapes alone, never
    from a value on the device (so a launch can be captured in a CUDA
    graph): T the least number of whole warps that gives every lane one
    32-group of a row (at most MATVEC_THREADS, and then a lane takes up to
    4), so that 256 // T rows make a pass of the block; up to two blocks an
    SM, so that the 1024-row products spread over every SM; a tile one pass
    of rows; as many stages as the block has tiles, up to
    MATVEC_MAX_STAGES and within MATVEC_SMEM, all issued before the first
    is consumed."""
    G = n_pad // GROUP_LEN
    T = min(MATVEC_THREADS, -(-G // 32) * 32)
    R = MATVEC_THREADS // T
    blocks = max(1, min(2 * n_sm, -(-N // R)))
    per_block = -(-N // blocks)
    S = min(MATVEC_MAX_STAGES, -(-per_block // R))
    while S > 1 and matvec_smem(R, n_pad, S) > MATVEC_SMEM:
        S -= 1
    return blocks, R, S, T


def q4k_matvec_fq_plain(x, w: Q4KTensor, dtype=torch.bfloat16
                        ) -> torch.Tensor:
    """What ``q4k_matvec_fq`` computes, in plain PyTorch: the f32 dequant
    dot of the fake-quantized row, from a raw row or its ``Q4KAct``."""
    xf = (fake_quant_packed_plain(x) if isinstance(x, Q4KAct)
          else fake_quant_act_plain(x))
    return q4k_matmul_plain(xf, w, dtype)


def q4k_matvec_fq(x, w: Q4KTensor, dtype=torch.bfloat16,
                  with_act: bool = False):
    """One activation row x w -> (1, out) in `dtype`: the f32 dot of the
    fake-quantized row with the dequantized weight (the function of the
    TPU kernel ``_q4k_kernel``), kernel ``q4k_matvec_fq`` on the card.  x
    is the row's ``Q4KAct`` (a norm's or SwiGLU's Q4K output), or the raw
    row (1, in_dim) f32/bf16, which ``act_quant_q4k_packed`` quantizes
    first (``q4k_act_quant``: two launches).  The kernel rebuilds the
    fake-quantized values v * sa - ba from the integer form, the bits of
    ``fake_quant_act``; with_act=True also returns them, (1, n_pad) f32 as
    the kernel rebuilt them.  The kernel takes n_pad up to
    MAX_MATVEC_PAD; a wider raw row on the card takes ``fake_quant_act``
    and ``q4k_matmul_f32`` (the same function), a wider ``Q4KAct`` is
    refused (the model writes none: ``gpt._q4k_out``)."""
    act = x
    if not isinstance(x, Q4KAct):
        if (x.dim() != 2 or x.shape != (1, w.in_dim)
                or x.dtype not in _OUT_TYPES):
            raise ValueError(f"q4k_matvec_fq takes an f32/bf16 (1, "
                             f"{w.in_dim}), got {x.dtype} {tuple(x.shape)}")
        if x.device.type != "cpu" and w.n_pad > MAX_MATVEC_PAD:
            xf = fake_quant_act(x)
            y = q4k_matmul_f32(xf, w, dtype)
            return (y, xf) if with_act else y
        act = Q4KAct(*act_quant_q4k_packed(x), x.shape)
    dev = act.vp.device
    if dev.type == "cpu":
        xf = fake_quant_packed_plain(act)
        y = q4k_matmul_plain(xf, w, dtype)
        return (y, xf) if with_act else y
    _check_weight(w, dev, dtype)
    G = w.n_pad // GROUP_LEN
    if (act.rows != 1 or act.in_dim != w.in_dim or w.n_pad > MAX_MATVEC_PAD
            or act.vp.shape != (1, w.n_pad // 2) or act.vp.dtype != torch.uint8
            or not act.vp.is_contiguous() or act.vp.data_ptr() % 16
            or any(t.dtype != torch.float32 or t.shape != (1, G)
                   or not t.is_contiguous() or t.device != dev
                   for t in (act.sa, act.ba))):
        raise ValueError(f"q4k_matvec_fq takes one row's Q4KAct of "
                         f"{w.in_dim} values (n_pad {w.n_pad}, at most "
                         f"{MAX_MATVEC_PAD}), got vp {tuple(act.vp.shape)}, "
                         f"sa {tuple(act.sa.shape)}, in_dim {act.in_dim}")
    int8_mma.init(dev, "q4k_matvec_fq_init")
    y = torch.empty((1, w.out_dim), dtype=dtype, device=dev)
    xf = (torch.empty((1, w.n_pad), dtype=torch.float32, device=dev)
          if with_act else None)
    plan = matvec_plan(w.out_dim, w.n_pad, _build.sm_count(dev))
    fn = _build.lib("q4k").q4k_matvec_fq
    rc = fn(act.vp.data_ptr(), act.sa.data_ptr(), act.ba.data_ptr(),
            w.packed.data_ptr(), w.scales.data_ptr(), w.biases.data_ptr(),
            y.data_ptr(), int(dtype == torch.bfloat16),
            None if xf is None else xf.data_ptr(), w.n_pad, w.in_dim,
            w.out_dim, *plan, _build.stream(act.vp))
    q4k_matvec_fq.launches += 1
    _build.check(rc, "q4k_matvec_fq")
    return (y, xf) if with_act else y


q4k_matvec_fq.launches = 0


def act_quant_q4k_packed(x2d: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """x2d (B, n) f32/bf16 -> (vp u8 (B, n_pad / 2), sa, ba, c f32 (B, G)),
    the activation's integer form for ``q4k_matmul_w4a4``; kernel
    ``q4k_act_quant`` on the card, equal to the plain version bit for
    bit."""
    if x2d.device.type == "cpu":
        return act_quant_q4k_packed_plain(x2d)
    if x2d.dim() != 2 or x2d.dtype not in _OUT_TYPES or x2d.shape[0] < 1:
        raise ValueError(f"q4k_act_quant takes f32/bf16 (B, n), got "
                         f"{x2d.dtype} {tuple(x2d.shape)}")
    x2d = x2d.contiguous()
    B, n = x2d.shape
    n_pad = n_blocks_per_line(n) * BLOCK_LEN
    G = n_pad // GROUP_LEN
    vp = torch.empty((B, n_pad // 2), dtype=torch.uint8, device=x2d.device)
    sa, ba, c = (torch.empty((B, G), dtype=torch.float32, device=x2d.device)
                 for _ in range(3))
    fn = _build.lib("q4k").q4k_act_quant
    rc = fn(x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), vp.data_ptr(),
            sa.data_ptr(), ba.data_ptr(), c.data_ptr(), B, n, n_pad,
            _build.stream(x2d))
    act_quant_q4k_packed.launches += 1
    _build.check(rc, "q4k_act_quant")
    return vp, sa, ba, c


act_quant_q4k_packed.launches = 0


def _w4a4_stage(MB: int, BN: int) -> int:
    """Bytes of a q4k_matmul_w4a4 stage, 256 values of K (csrc/q4k.cu:
    w4_stage): the packed weight tile (144 bytes a row: 128 and a pad), its
    scales and biases (96 bytes a row), the packed slot tile (144 bytes a
    slot) and its sa, ba, c (128 bytes a slot)."""
    return 240 * MB + 272 * BN


def w4a4_smem(MB: int, BN: int, CS: int, S: int) -> int:
    """Shared memory of a q4k_matmul_w4a4 block of MB weight rows."""
    return int8_mma.smem(_w4a4_stage(MB, BN), MB, BN, CS, S)


def w4a4_plan(B: int, N: int, n_pad: int, n_sm: int = _build.H100_SMS
              ) -> Tuple[int, int, int, int]:
    """-> (MB, BN, CS, S) of ``q4k_matmul_w4a4``: ``int8_mma.plan`` with the
    256-value chunks of K split over a cluster, a stage each; the weight
    is 3/4 of a byte a value with its scales and biases."""
    return int8_mma.plan(B, N, N * n_pad * 3 // 4, n_pad // BLOCK_LEN, 1,
                         _w4a4_stage, n_sm)


def q4k_matmul_w4a4(vp: torch.Tensor, sa: torch.Tensor, ba: torch.Tensor,
                    c: torch.Tensor, w: Q4KTensor, dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """The activation's integer form (``act_quant_q4k_packed``) x w ->
    (B, out) in `dtype`; kernel ``q4k_matmul_w4a4`` (int8 tensor cores,
    split by ``w4a4_plan``) on the card."""
    if vp.device.type == "cpu":
        return q4k_matmul_w4a4_plain(vp, sa, ba, c, w, dtype)
    _check_weight(w, vp.device, dtype)
    B, G = sa.shape[0], w.n_pad // GROUP_LEN
    if (vp.dtype != torch.uint8 or vp.shape != (B, w.n_pad // 2) or B < 1
            or any(t.dtype != torch.float32 or t.shape != (B, G)
                   or not t.is_contiguous() or t.device != vp.device
                   for t in (sa, ba, c))
            or not vp.is_contiguous() or vp.data_ptr() % 16
            or w.scales.data_ptr() % 16 or w.biases.data_ptr() % 16):
        raise ValueError(f"q4k_matmul_w4a4 takes contiguous u8 (B >= 1, "
                         f"{w.n_pad // 2}) values, 16-byte aligned, with f32 "
                         f"(B, {G}) sa, ba, c, got {vp.dtype} "
                         f"{tuple(vp.shape)}, {tuple(sa.shape)}")
    int8_mma.init(vp.device, "q4k_matmul_w4a4_init")
    y = torch.empty((B, w.out_dim), dtype=dtype, device=vp.device)
    plan = w4a4_plan(B, w.out_dim, w.n_pad, _build.sm_count(vp.device))
    fn = _build.lib("q4k").q4k_matmul_w4a4
    rc = fn(vp.data_ptr(), sa.data_ptr(), ba.data_ptr(), c.data_ptr(),
            w.packed.data_ptr(), w.scales.data_ptr(), w.biases.data_ptr(),
            y.data_ptr(), int(dtype == torch.bfloat16), B, w.n_pad, w.in_dim,
            w.out_dim, *plan, _build.stream(vp))
    q4k_matmul_w4a4.launches += 1
    _build.check(rc, "q4k_matmul_w4a4")
    return y


q4k_matmul_w4a4.launches = 0


def q4k_matmul(x, w: Q4KTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., in) -> (..., out) in `dtype`: the activation's Q4K
    quantization, then the product.  x is a tensor or its ``Q4KAct``
    (quantized by the kernel that produced it).  One row (a decode step)
    takes ``q4k_matvec_fq``, the f32 dequant dot of the fake-quantized row;
    more rows (a batched step, a prefill) ``q4k_matmul_w4a4`` on the int8
    tensor cores, the C engine's integer expansion of the same product (the
    same quantization decisions; f32 sums in another order).  A tensor is
    quantized first (``q4k_act_quant``)."""
    if w.packed.dim() != 2:
        raise ValueError("index stacked weights with Q4KTensor.layer(i)")
    lead = x.shape[:-1]
    if isinstance(x, Q4KAct):
        if x.in_dim != w.in_dim:
            raise ValueError(f"activation of {x.in_dim} values for a weight "
                             f"of {w.in_dim}")
        act = x
    else:
        x2d = x.reshape(-1, w.in_dim)
        if x2d.shape[0] == 1:
            return q4k_matvec_fq(x2d, w, dtype).reshape(*lead, w.out_dim)
        act = Q4KAct(*act_quant_q4k_packed(x2d), x2d.shape)
    y = (q4k_matvec_fq(act, w, dtype) if act.rows == 1
         else q4k_matmul_w4a4(*act.parts(), w, dtype))
    return y.reshape(*lead, w.out_dim)
