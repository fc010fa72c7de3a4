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
on the card every S = 1 attention goes through the kernel.
``decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nano_tpu_torch.ops import _build

_CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_scale: Optional[torch.Tensor],
                     v_scale: Optional[torch.Tensor], pos: torch.Tensor,
                     n_kv: int, rep: int) -> torch.Tensor:
    """q: (B, H, D); caches: (B, T, KV, D) f32/bf16/int8; scales: (B, T, KV)
    f32 or None; pos: (B,) int32, or (1,) for one position shared by every
    row.  -> (B, H*D) f32.  Kernel ``decode_attention`` on the card; it
    reads only the cache rows t <= pos."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      pos, n_kv, rep)
    B, H, D = q.shape
    T = k_cache.shape[1]
    if (H != n_kv * rep or rep > 8 or D > 256
            or k_cache.shape != (B, T, n_kv, D)
            or v_cache.shape != k_cache.shape
            or k_cache.dtype not in _CACHE_TYPES
            or v_cache.dtype != k_cache.dtype
            or not k_cache.is_contiguous() or not v_cache.is_contiguous()):
        raise ValueError(
            f"decode_attention takes contiguous (B, T, KV, D) f32/bf16/int8 "
            f"caches with rep <= 8 and D <= 256; got q {tuple(q.shape)}, "
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
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {q.device}, but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    qf = q.float().contiguous()
    out = torch.empty((B, H * D), dtype=torch.float32, device=q.device)
    # positions per block: 16, or more so at most 256 blocks share a head
    chunk = max(16, -(-T // 256))
    n_split = -(-T // chunk)
    part = torch.empty((B * n_kv * n_split * rep * (D + 2),),
                       dtype=torch.float32, device=q.device)
    counter = torch.zeros((B * n_kv,), dtype=torch.int32, device=q.device)
    fn = _build.lib("decode_attn").decode_attention
    rc = fn(qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            pos.data_ptr(), 1 if pos.numel() == B and B > 1 else 0,
            out.data_ptr(), part.data_ptr(), counter.data_ptr(),
            _CACHE_TYPES[k_cache.dtype], B, T, n_kv, rep, D,
            1.0 / math.sqrt(D), chunk,
            torch.cuda.current_stream(q.device).cuda_stream)
    decode_attention.launches += 1
    _build.check(rc, "decode_attention")
    return out


decode_attention.launches = 0
