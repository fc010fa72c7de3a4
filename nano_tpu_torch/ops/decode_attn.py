"""Single-token decode attention over a static KV cache.

Port of ``nano_tpu/ops/decode_attn.py``: per batch row b and query head
h = kv * rep + r,

    s   = (K_cache[b, :, kv] @ q[b, h]) * k_scale / sqrt(D),  t <= pos[b]
    out = softmax(s) * v_scale  @  V_cache[b, :, kv]         (f32)

GQA stays grouped (K/V are never expanded); int8 caches fold their
per-vector scales into the score and the probability; bf16/f32 caches
pass ``None`` scales.

``decode_attention`` runs the hand-written CUDA kernel
(``csrc/decode_attn.cu``) for CUDA tensors and ``decode_attention_plain``
only for tensors on the CPU.  Unlike the TPU kernel there is no gate:
on the card every S = 1 attention goes through the kernel, as one launch:
q is read in its own type, and the kernel's scratch is a workspace kept
per (device, stream).  ``decode_attention.launches`` counts kernel
launches.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, Optional, Tuple

import torch

from nano_tpu_torch.ops import _build

_CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_REP = 8                          # what the kernel is built for
HEAD_DIMS = (16, 32, 48, 64, 128, 256)


@lru_cache(maxsize=None)
def _part_stride(rep: int, D: int) -> int:
    """Floats of one block's partial, as the kernel lays them out."""
    return _build.lib("decode_attn").decode_attention_part_stride(rep, D)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           k_scale: Optional[torch.Tensor],
                           v_scale: Optional[torch.Tensor],
                           pos: torch.Tensor, n_kv: int, rep: int
                           ) -> torch.Tensor:
    """The TPU kernel's math in PyTorch: q (B, H, D); caches (B, T, KV, D);
    scales (B, T, KV) f32 or None; pos (B,) or (1,) int.  -> (B, H*D) f32.
    Masked positions get -1e30 and the probabilities are normalised
    before the V product, as in the Pallas kernel."""
    B, H, D = q.shape
    T = k_cache.shape[1]
    qg = q.float().reshape(B, n_kv, rep, D)
    s = torch.einsum("bkrd,btkd->bkrt", qg, k_cache.float())
    ks = (k_scale.float() if k_scale is not None
          else torch.ones(B, T, n_kv, device=q.device))
    s = s * (ks.permute(0, 2, 1)[:, :, None, :] * (1.0 / math.sqrt(D)))
    t = torch.arange(T, device=q.device)
    visible = t[None, :] <= pos.reshape(-1, 1).to(q.device)
    s = torch.where(visible[:, None, None, :], s,
                    torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkrt,btkd->bkrd", p, v_cache.float())
    return out.reshape(B, H * D)


# Rows a split takes at least, and the most splits the kernel's combine
# holds.  The split does not follow the batch, so a block at a large
# batch takes several splits in turn, each its own partial; 32 rows keep
# batch 1, the single stream, fastest (chip_smoke.py bench decode on an
# H100 at T = 512: 64-row splits take 1.06x the time at batch 1, 0.88x at
# batch 8 and 64).
MIN_CHUNK = 32
MAX_SPLITS = 64


def choose_splits(n_kv: int, T: int, n_sm: int = _build.H100_SMS
                  ) -> Tuple[int, int]:
    """-> (chunk, n_split): block (b * KV + kv, s) of the kernel's grid
    takes cache rows [s * chunk, (s + 1) * chunk).  From shapes alone
    (``pos`` lives on the device and is never read here, so a call can be
    captured in a CUDA graph), and never from the batch: a row's partials
    and the order they are merged in are then the same at every batch
    size, so a batched decode step gives each row the single stream's bits.
    The splits bring one row's grid to between one and two blocks per SM
    where T has the rows for it (chunks of at least MIN_CHUNK rows, at most
    MAX_SPLITS splits); a batch multiplies the grid."""
    want = max(1, (2 * n_sm) // n_kv)
    n = max(1, min(want, MAX_SPLITS, -(-T // MIN_CHUNK)))
    chunk = -(-T // n)
    return chunk, -(-T // chunk)


def splits_per_block(B: int, n_kv: int, n_split: int,
                     n_sm: int = _build.H100_SMS) -> int:
    """The splits one block of the kernel takes in turn, each its own
    partial computed as a block of one split computes it: the fewest that
    keep the grid B * KV * ceil(n_split / per_block) within two blocks per
    SM (all of them where even that is more).  It moves the grid only,
    never a row's arithmetic."""
    return next((per for per in range(1, n_split + 1)
                 if B * n_kv * -(-n_split // per) <= 2 * n_sm), n_split)


# (device index, stream handle) -> (part f32, counter int32).  The kernel's
# scratch: per-block partials and one ticket per (batch row, KV head).  It
# is kept and reused instead of being allocated and zeroed per call.  That
# is safe on one stream: calls on a stream run in order, and the block that
# takes the last ticket of a call sets it back to zero before the kernel
# ends, so every call finds the counters zero and no partial is read after
# its call.  A workspace is never shared between streams (the stream is
# part of the key), so two streams may call concurrently.  A captured CUDA
# graph holds the workspace of the stream it was captured on: replay it on
# one stream at a time.
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, n_part: int,
               n_counter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_counter:
        # a freed buffer is handed out again only to later work of the same
        # stream, so a call still running on the old one is not disturbed
        ws = (torch.empty((n_part,), dtype=torch.float32, device=device),
              torch.zeros((n_counter,), dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


def workspaces() -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """Every workspace kept now.  A CUDA graph captured over
    ``decode_attention`` holds these, so that the one its launches write
    outlives a later, larger workspace of its stream."""
    return tuple(_workspaces.values())


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_scale: Optional[torch.Tensor],
                     v_scale: Optional[torch.Tensor], pos: torch.Tensor,
                     n_kv: int, rep: int) -> torch.Tensor:
    """q: (B, H, D) f32 or bf16; caches: (B, T, KV, D) f32/bf16/int8;
    scales: (B, T, KV) f32 or None; pos: (B,) int32, or (1,) for one
    position shared by every row.  -> (B, H*D) f32.  Kernel
    ``decode_attention`` on the card, one launch and nothing else on the
    stream; it reads only the cache rows t <= pos."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      pos, n_kv, rep)
    B, H, D = q.shape
    T = k_cache.shape[1]
    if (H != n_kv * rep or not 1 <= rep <= MAX_REP or D not in HEAD_DIMS
            or q.dtype not in _Q_TYPES
            or k_cache.shape != (B, T, n_kv, D)
            or v_cache.shape != k_cache.shape
            or k_cache.dtype not in _CACHE_TYPES
            or v_cache.dtype != k_cache.dtype
            or not k_cache.is_contiguous() or not v_cache.is_contiguous()
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16):
        raise ValueError(
            f"decode_attention takes f32/bf16 q and contiguous, 16-byte "
            f"aligned (B, T, KV, D) f32/bf16/int8 caches with rep <= {MAX_REP} "
            f"and D in {HEAD_DIMS}; got q {tuple(q.shape)} {q.dtype}, "
            f"cache {tuple(k_cache.shape)} {k_cache.dtype}, n_kv={n_kv}, "
            f"rep={rep}")
    quant = k_scale is not None
    if quant and (k_scale.shape != (B, T, n_kv) or v_scale is None
                  or v_scale.shape != k_scale.shape
                  or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32
                  or not k_scale.is_contiguous()
                  or not v_scale.is_contiguous()):
        raise ValueError("int8 cache scales must be contiguous f32 (B, T, KV)")
    if (pos.dtype != torch.int32 or pos.device != q.device
            or pos.numel() not in (1, B) or not pos.is_contiguous()):
        raise ValueError("pos must be a contiguous int32 (B,) or (1,) tensor "
                         "on the cache's device")
    stream = _build.stream(q)
    if q.stride(2) != 1 or q.stride(1) != D:
        q = q.contiguous()
    lib = _build.lib("decode_attn")
    n_sm = _build.sm_count(q.device)
    chunk, n_split = choose_splits(n_kv, T, n_sm)
    part, counter = _workspace(
        q.device, stream,
        B * n_kv * n_split * _part_stride(rep, D), B * n_kv)
    out = torch.empty((B, H * D), dtype=torch.float32, device=q.device)
    rc = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        pos.data_ptr(), 1 if pos.numel() == B and B > 1 else 0,
        out.data_ptr(), part.data_ptr(), counter.data_ptr(),
        _Q_TYPES[q.dtype], q.stride(0), _CACHE_TYPES[k_cache.dtype], B, T,
        n_kv, rep, D, 1.0 / math.sqrt(D), chunk,
        splits_per_block(B, n_kv, n_split, n_sm), stream)
    decode_attention.launches += 1
    _build.check(rc, "decode_attention")
    return out


decode_attention.launches = 0
