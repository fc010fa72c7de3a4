"""Full-sequence causal GQA attention, forward and backward.

Port of the training-path attention of ``nano_tpu/models/gpt.py``: the
Pallas flash attention behind ``_flash_attend`` (with its backward
kernels) and the einsum path it stands beside.  Per batch row b and
query head h = kv * rep + r,

    out[b, s, h] = softmax_{t <= offset + s}(q[b, s, h] . k[b, t, kv]
                                             / sqrt(D)) @ v[b, :, kv]

q holds Sq query positions and k, v Skv >= offset + Sq key positions:
with offset 0 and Sq = Skv the causal attention of a whole sequence; with
an offset, the block of queries at positions offset .. offset + Sq - 1 of
a longer sequence against all of its keys, as a rank of sequence
parallelism holds them (``models.gpt``: its queries against the K/V
gathered over "seq").  The JAX package gets that form from GSPMD, which
partitions the einsum path's scores on S.

``flash_attention`` runs the hand-written CUDA kernels
(``csrc/flash_attn.cu``) for CUDA tensors — forward and, through the
operator's backward, the gradient — and their plain versions only for
tensors on the CPU.  Unlike the TPU kernel there is no gate on S and K/V
are never repeated to H heads.  The backward uses no atomics: two runs on
the same inputs agree bit for bit.  ``flash_attention.launches`` counts
forward launches, ``flash_attention.backward_launches`` backward ones.

The forward is the registered operator
``torch.ops.nano_tpu_torch.flash_attn_fwd`` (q, k, v) -> (out, lse), whose
gradient is ``flash_attn_bwd`` on the out and lse it saved: a
selective-checkpoint policy sees the kernel as that one operator and can
keep its outputs, so a backward that recomputes the block around it need
not launch the forward again (the "heads" remat policy of
``models.gpt``).  For CPU tensors the operator runs the plain versions of
both kernels (``flash_attn_fwd_plain``, ``flash_attn_bwd_plain``);
``flash_attention_plain``, the forward under autograd, is the reference
the kernels' gradients are held against.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from nano_tpu_torch.ops import _build

_TYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 48, 64, 128)


def causal_mask(S: int, device=None, offset: int = 0,
                S_kv: Optional[int] = None) -> torch.Tensor:
    """(S, S_kv) additive f32 mask (S_kv = S when None): 0 where key t is
    visible to query i (t <= offset + i), -inf elsewhere."""
    i = torch.arange(S, device=device)
    t = torch.arange(S if S_kv is None else S_kv, device=device)
    return torch.where(t[None, :] <= offset + i[:, None], 0.0, -float("inf")
                       ).to(torch.float32)


def flash_attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         offset: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``flash_attn_fwd`` returns, in plain PyTorch: the einsum path
    of the JAX package -> (out (B, Sq, H, D) in q's type, lse (B, H, Sq)
    f32, the row log-sum-exp of the scaled causal scores).  Scores in f32,
    additive -inf mask past key offset + i for query i, f32 softmax cast
    to the compute type before the V product."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, D)
    scores = (torch.einsum("bskrd,btkd->bkrst", qg, k.float()) / math.sqrt(D)
              + causal_mask(S, q.device, offset, k.shape[1]))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v.to(q.dtype))
    return (out.reshape(B, S, H, D),
            torch.logsumexp(scores, dim=-1).reshape(B, H, S))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """``flash_attn_fwd_plain``'s out as (B, Sq, H*D), differentiated by
    autograd: the reference for the kernels' forward and gradient."""
    B, S, H, D = q.shape
    return flash_attn_fwd_plain(q, k, v, offset)[0].reshape(B, S, H * D)


def flash_attn_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, offset: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What ``flash_attn_bwd`` returns, in plain PyTorch and f32: the
    probabilities again from q, k and the saved lse, delta = rowsum(dout *
    out), dS = P * (dP - delta) -> (dq, dk, dv) in q's type, dk and dv
    over all Skv keys.  It runs no attention forward: out and lse are
    read, not recomputed."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    R = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, S, KV, R, D)
    do = dout.float().reshape(B, S, KV, R, D)
    scores = (torch.einsum("bskrd,btkd->bkrst", qg, k.float()) * scale
              + causal_mask(S, q.device, offset, k.shape[1]))
    p = torch.exp(scores - lse.reshape(B, KV, R, S)[..., None])
    dv = torch.einsum("bkrst,bskrd->btkd", p, do)
    dp = torch.einsum("bskrd,btkd->bkrst", do, v.float())
    delta = (do * out.float().reshape(B, S, KV, R, D)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkrst,btkd->bskrd", ds, k.float()) * scale
    dk = torch.einsum("bkrst,bskrd->btkd", ds, qg) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t with D contiguous and every row on a 16-byte boundary, as the
    kernels' vector loads need; anything else is copied."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           offset: int = 0) -> None:
    B, S, H, D = q.shape
    S_kv, KV = k.shape[1], k.shape[2]
    if (q.dim() != 4 or k.shape != (B, S_kv, KV, D) or v.shape != k.shape
            or KV == 0 or H % KV or D not in HEAD_DIMS or S < 1
            or offset < 0 or offset + S > S_kv
            or q.dtype not in _TYPES or k.dtype != q.dtype
            or v.dtype != q.dtype or k.device != q.device
            or v.device != q.device or B > 65535 or H > 65535):
        raise ValueError(
            f"flash_attention takes f32 or bf16 q (B, Sq, H, D) and k, v "
            f"(B, Skv, KV, D) of one type on one device with H a multiple "
            f"of KV, D in {HEAD_DIMS} and 0 <= offset <= Skv - Sq; got q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
            f"v {tuple(v.shape)} {v.dtype}, offset {offset}")


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``flash_attn_fwd`` -> (out (B, Sq, H, D) in q's type, lse
    (B, H, Sq) f32, the row log-sum-exp of the scaled scores); query i
    sees keys 0 .. offset + i."""
    _check(q, k, v, offset)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _build.lib("flash_attn").flash_attn_fwd
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _TYPES[q.dtype], B, S, k.shape[1], offset, H,
            k.shape[2], D,
            *_strides(q), *_strides(k), *_strides(v), 1.0 / math.sqrt(D),
            _build.stream(q))
    flash_attention.launches += 1
    _build.check(rc, "flash_attn_fwd")
    return out, lse


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel ``flash_attn_bwd`` -> (dq, dk, dv), contiguous, in q's type;
    dk and dv over all Skv keys (zero where no query sees the key).
    `out` and `lse` are what ``flash_attn_fwd`` returned for q, k, v and
    `offset`."""
    _check(q, k, v, offset)
    B, S, H, D = q.shape
    S_kv, KV = k.shape[1], k.shape[2]
    if (out.shape != q.shape or out.dtype != q.dtype
            or not out.is_contiguous() or dout.shape != q.shape
            or lse.shape != (B, H, S) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_attn_bwd takes out and lse as flash_attn_fwd "
                         "wrote them and dout in out's shape")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    dout = dout.to(q.dtype).contiguous()
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S_kv, KV, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S_kv, KV, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _build.lib("flash_attn").flash_attn_bwd
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), _TYPES[q.dtype], B, S, S_kv,
            offset, H, KV, D,
            *_strides(q), *_strides(k), *_strides(v), 1.0 / math.sqrt(D),
            _build.stream(q))
    flash_attention.backward_launches += 1
    _build.check(rc, "flash_attn_bwd")
    return dq, dk, dv


@torch.library.custom_op("nano_tpu_torch::flash_attn_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as one operator: the kernel on the card, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attn_fwd_plain(q, k, v, offset)
    return flash_attn_fwd(q, k, v, offset)


def _setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs[:3], *output)
    ctx.offset = inputs[3]


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    bwd = flash_attn_bwd_plain if q.device.type == "cpu" else flash_attn_bwd
    return (*bwd(q, k, v, out, lse, dout, ctx.offset), None)


_fwd_op.register_autograd(_backward, setup_context=_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k / v (B, Skv, KV, D), f32 or bf16 -> (B, Sq, H*D)
    in q's type, query i seeing keys 0 .. offset + i; differentiable (dk,
    dv over all Skv keys).  Through the operator
    ``nano_tpu_torch::flash_attn_fwd``: the kernels on the card, their
    plain versions for CPU tensors."""
    B, S, H, D = q.shape
    out, _ = torch.ops.nano_tpu_torch.flash_attn_fwd(q, k, v, offset)
    return out.reshape(B, S, H * D)


flash_attention.launches = 0
flash_attention.backward_launches = 0
