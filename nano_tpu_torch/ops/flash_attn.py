"""Full-sequence causal GQA attention, forward and backward.

Port of the training-path attention of ``nano_tpu/models/gpt.py``: the
Pallas flash attention behind ``_flash_attend`` (with its backward
kernels) and the einsum path it stands beside.  Per batch row b and
query head h = kv * rep + r,

    out[b, s, h] = softmax_{t <= s}(q[b, s, h] . k[b, t, kv] / sqrt(D))
                   @ v[b, :, kv]

``flash_attention`` runs the hand-written CUDA kernels
(``csrc/flash_attn.cu``) for CUDA tensors — forward and, through
``FlashAttention``'s backward, the gradient — and
``flash_attention_plain`` only for tensors on the CPU.  Unlike the TPU
kernel there is no gate on S and K/V are never repeated to H heads.  The
backward uses no atomics: two runs on the same inputs agree bit for bit.
``flash_attention.launches`` counts forward launches,
``flash_attention.backward_launches`` backward ones.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from nano_tpu_torch.ops import _build

_TYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 48, 64, 128)


def causal_mask(S: int, device=None) -> torch.Tensor:
    """(S, S) additive f32 mask, -inf above the diagonal."""
    i = torch.arange(S, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0, -float("inf")
                       ).to(torch.float32)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The einsum path of the JAX package in PyTorch, differentiated by
    autograd: q (B, S, H, D), k / v (B, S, KV, D) -> (B, S, H*D) in q's
    type.  Scores in f32, additive -inf mask above the diagonal, f32
    softmax cast to the compute type before the V product."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, D)
    scores = torch.einsum("bskrd,btkd->bkrst", qg, k.float()) / math.sqrt(D)
    probs = torch.softmax(scores + causal_mask(S, q.device), dim=-1
                          ).to(q.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v.to(q.dtype))
    return out.reshape(B, S, H * D)


def plain_lse(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """What ``flash_attn_fwd`` returns beside out, in plain PyTorch: the
    row log-sum-exp of the scaled causal scores, (B, H, S) f32."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, D)
    scores = torch.einsum("bskrd,btkd->bkrst", qg, k.float()) / math.sqrt(D)
    return torch.logsumexp(scores + causal_mask(S, q.device), dim=-1
                           ).reshape(B, H, S)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t with D contiguous and every row on a 16-byte boundary, as the
    kernels' vector loads need; anything else is copied."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    B, S, H, D = q.shape
    KV = k.shape[2]
    if (q.dim() != 4 or k.shape != (B, S, KV, D) or v.shape != k.shape
            or KV == 0 or H % KV or D not in HEAD_DIMS or S < 1
            or q.dtype not in _TYPES or k.dtype != q.dtype
            or v.dtype != q.dtype or k.device != q.device
            or v.device != q.device or B > 65535 or H > 65535):
        raise ValueError(
            f"flash_attention takes f32 or bf16 q (B, S, H, D) and k, v "
            f"(B, S, KV, D) of one type on one device with H a multiple of "
            f"KV and D in {HEAD_DIMS}; got q {tuple(q.shape)} {q.dtype}, "
            f"k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} {v.dtype}")


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``flash_attn_fwd`` -> (out (B, S, H, D) in q's type, lse
    (B, H, S) f32, the row log-sum-exp of the scaled scores)."""
    _check(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _build.lib("flash_attn").flash_attn_fwd
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _TYPES[q.dtype], B, S, H, k.shape[2], D,
            *_strides(q), *_strides(k), *_strides(v), 1.0 / math.sqrt(D),
            _build.stream(q))
    flash_attention.launches += 1
    _build.check(rc, "flash_attn_fwd")
    return out, lse


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel ``flash_attn_bwd`` -> (dq, dk, dv), contiguous, in q's type.
    `out` and `lse` are what ``flash_attn_fwd`` returned for q, k, v."""
    _check(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    if (out.shape != q.shape or out.dtype != q.dtype
            or not out.is_contiguous() or dout.shape != q.shape
            or lse.shape != (B, H, S) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_attn_bwd takes out and lse as flash_attn_fwd "
                         "wrote them and dout in out's shape")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    dout = dout.to(q.dtype).contiguous()
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, KV, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, KV, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _build.lib("flash_attn").flash_attn_bwd
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), _TYPES[q.dtype], B, S, H, KV, D,
            *_strides(q), *_strides(k), *_strides(v), 1.0 / math.sqrt(D),
            _build.stream(q))
    flash_attention.backward_launches += 1
    _build.check(rc, "flash_attn_bwd")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The two kernels as one differentiable function of CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attn_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attn_bwd(q, k, v, out, lse, dout)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """q (B, S, H, D), k / v (B, S, KV, D), f32 or bf16 -> (B, S, H*D) in
    q's type; differentiable.  The kernels on the card, the plain version
    for tensors on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    B, S, H, D = q.shape
    return FlashAttention.apply(q, k, v).reshape(B, S, H * D)


flash_attention.launches = 0
flash_attention.backward_launches = 0
