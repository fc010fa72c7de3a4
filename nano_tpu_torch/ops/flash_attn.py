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
(``csrc/flash_attn.cu``; most of the bf16 forward and backward at D <= 64
in ``csrc/flash_fwd_wgmma.cu`` and ``csrc/flash_bwd_wgmma.cu``, as
``fwd_route`` and ``bwd_route`` choose) for CUDA tensors — forward and,
through the operator's backward, the gradient — and their plain versions
only for tensors on the CPU.  Unlike the TPU kernel there is no gate on S
and K/V are never repeated to H heads.  No kernel uses atomics: two runs
on the same inputs agree bit for bit.  ``flash_attention.launches``
counts forward launches, ``flash_attention.backward_launches`` backward
ones, and of those ``forward_wgmma_launches`` and ``wgmma_launches`` the
ones that ran on the wgmma kernels.

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
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch

from nano_tpu_torch.ops import _build

_TYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 48, 64, 128)
# the head widths the wgmma kernels (csrc/flash_fwd_wgmma.cu,
# csrc/flash_bwd_wgmma.cu) are built for; D = 128 keeps the mma.sync
# kernels: dK and dV of 64 x 128 in f32 are 128 registers a thread, S and
# dP 64 more, and the forward has no n128 product
WGMMA_HEAD_DIMS = (16, 32, 48, 64)


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


class FwdRoute(NamedTuple):
    """Which kernel takes the forward: "wgmma" (``csrc/flash_fwd_wgmma.cu``,
    bf16), "mma" (the mma.sync kernel in ``csrc/flash_attn.cu``, bf16) or
    "simt" (f32, the oracle type: flash_attn.cu's CUDA-core kernel).
    ``hpb``: query heads a block of the wgmma kernel."""
    kernel: str
    hpb: int = 1


def fwd_route(B: int, Sq: int, Skv: int, offset: int, H: int, KV: int,
              D: int, dtype: torch.dtype) -> FwdRoute:
    """The forward's kernel for these shapes, a function of the shapes
    alone (no device is asked, so it holds under a CUDA graph and on the
    CPU), as ``chip_smoke.py bench routes`` measured them against each
    other.  bf16: the wgmma kernel at D = 16 to 64, where it was faster
    than the mma.sync kernel at every shape timed, with two query heads a
    block where the heads of a KV head are even (one for the whole
    sequence at D = 32, where two were slower); the mma.sync kernel at
    D = 128, which the wgmma kernel does not take.  f32: the CUDA cores."""
    if dtype == torch.float32:
        return FwdRoute("simt")
    if D not in WGMMA_HEAD_DIMS:
        return FwdRoute("mma")
    whole = offset == 0 and Sq == Skv
    two = (H // KV) % 2 == 0 and not (D == 32 and whole)
    return FwdRoute("wgmma", 2 if two else 1)


class BwdRoute(NamedTuple):
    """Which kernels take the backward: "wgmma" (the two passes of
    ``csrc/flash_bwd_wgmma.cu``, bf16; the dk/dv pass reads the row
    statistics the dq pass leaves), "mma" (the two mma.sync passes in
    ``csrc/flash_attn.cu``, bf16) or "simt" (f32, the oracle type:
    flash_attn.cu's CUDA-core kernels).  ``hpb``: query heads a block of
    the wgmma dq pass."""
    passes: str
    hpb: int = 1


def bwd_route(B: int, Sq: int, Skv: int, offset: int, H: int, KV: int,
              D: int, dtype: torch.dtype) -> BwdRoute:
    """The backward's kernels for these shapes, a function of the shapes
    alone (no device is asked, so it holds under a CUDA graph and on the
    CPU), as ``chip_smoke.py bench routes`` measured them against each
    other.  bf16: the wgmma passes wherever they were faster than the
    mma.sync passes, a rank of sequence parallelism (Sq < Skv or offset >
    0) at D = 16 to 64 and the whole sequence at D = 32 to 64, with two
    query heads a dq block at D = 48 and 64 where the heads of a KV head
    are even (one at D = 16 and 32); the mma.sync passes for the whole
    sequence at D = 16 (the calculator's, where each block has one step and
    the wgmma passes' prologue loses) and at D = 128, which the wgmma passes
    do not take.  f32: the CUDA cores."""
    if dtype == torch.float32:
        return BwdRoute("simt")
    if D not in WGMMA_HEAD_DIMS or (D == 16 and offset == 0 and Sq == Skv):
        return BwdRoute("mma")
    return BwdRoute("wgmma", 2 if D >= 48 and (H // KV) % 2 == 0 else 1)


def wgmma_spread(n: int, pairs: int, resident: int) -> int:
    """The spread of a wgmma pass's 1-D grid of n tiles x `pairs` pairs
    (``csrc/flash_bwd_wgmma.cu:block_order``: chunks of `spread` pairs,
    tiles outer within a chunk) for a grid of n x pairs blocks of which
    `resident` run at once: every pair where the grid fits in two waves
    (the tiles with the most steps start first, the short ones fill in
    behind them), else 1 (a pair's tiles run together, and the tiles they
    share come from L2 while it holds them)."""
    return pairs if n * pairs <= 2 * resident else 1


@lru_cache(maxsize=None)
def _resident(device: int, kernel: str, *args: int) -> int:
    """Blocks of a wgmma kernel that the card runs at once: its library's
    ``<kernel>_blocks_per_sm(*args)`` (the forward's (D, hpb), a backward
    pass's (D, pass, hpb)) on every SM."""
    per_sm = getattr(_build.lib(kernel), kernel + "_blocks_per_sm")(*args)
    if per_sm < 1:
        raise RuntimeError(f"{kernel} {args}: no block fits an SM")
    return per_sm * _build.sm_count(torch.device("cuda", device))


def fwd_spread(device: int, B: int, Sq: int, H: int, D: int,
               route: FwdRoute) -> int:
    """``wgmma_spread`` of the wgmma forward's grid (query tiles x head
    groups x batch rows) on `device`."""
    return wgmma_spread(-(-Sq // 64), H // route.hpb * B,
                        _resident(device, "flash_fwd_wgmma", D, route.hpb))


def wgmma_spreads(device: int, B: int, Sq: int, Skv: int, H: int, KV: int,
                  D: int, hpb: int) -> Tuple[int, int]:
    """``wgmma_spread`` of the dq pass's grid (query tiles x head groups x
    batch rows) and of the dk/dv pass's (key tiles x KV heads x batch
    rows) on `device`."""
    return (wgmma_spread(-(-Sq // 64), H // hpb * B,
                         _resident(device, "flash_bwd_wgmma", D, 0, hpb)),
            wgmma_spread(-(-Skv // 64), KV * B,
                         _resident(device, "flash_bwd_wgmma", D, 1, 1)))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t with D contiguous and every row on a 16-byte boundary, as the
    kernels' vector loads and tensor maps need (a tensor map takes no
    stride of 0); anything else is copied."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 and s > 0 for s in t.stride()[:-1])):
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
                   offset: int = 0, route: Optional[FwdRoute] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``flash_attn_fwd`` -> (out (B, Sq, H, D) in q's type, lse
    (B, H, Sq) f32, the row log-sum-exp of the scaled scores); query i
    sees keys 0 .. offset + i.  The kernel is ``fwd_route``'s for the
    shapes, or `route` (a measurement's choice); a route the kernels do not
    take raises."""
    _check(q, k, v, offset)
    B, S, H, D = q.shape
    KV = k.shape[2]
    if route is None:
        route = fwd_route(B, S, k.shape[1], offset, H, KV, D, q.dtype)
    if (route.kernel not in ("simt", "mma", "wgmma")
            or (route.kernel == "simt") != (q.dtype == torch.float32)
            or (route.kernel == "wgmma" and (D not in WGMMA_HEAD_DIMS
                                             or route.hpb not in (1, 2)
                                             or (H // KV) % route.hpb))
            or (route.kernel != "wgmma" and route.hpb != 1)):
        raise ValueError(f"flash_attn_fwd has no route {route} for {q.dtype} "
                         f"at D = {D}, {H // KV} query heads a KV head")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    tail = (*_strides(q), *_strides(k), *_strides(v), 1.0 / math.sqrt(D))
    if route.kernel == "wgmma":
        fn = _build.lib("flash_fwd_wgmma").flash_fwd_wgmma
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, S, k.shape[1], offset, H, KV, D, route.hpb,
                fwd_spread(q.device.index, B, S, H, D, route), *tail,
                _build.stream(q))
        flash_attention.launches += 1
        flash_attention.forward_wgmma_launches += 1
        _build.check(rc, "flash_fwd_wgmma")
        return out, lse
    fn = _build.lib("flash_attn").flash_attn_fwd
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _TYPES[q.dtype], B, S, k.shape[1], offset, H, KV,
            D, *tail, _build.stream(q))
    flash_attention.launches += 1
    _build.check(rc, "flash_attn_fwd")
    return out, lse


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   offset: int = 0, route: Optional[BwdRoute] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel ``flash_attn_bwd`` -> (dq, dk, dv), contiguous, in q's type;
    dk and dv over all Skv keys (zero where no query sees the key).
    `out` and `lse` are what ``flash_attn_fwd`` returned for q, k, v and
    `offset`.  The kernels are ``bwd_route``'s for the shapes, or `route`
    (a measurement's choice); a route the kernels do not take raises."""
    _check(q, k, v, offset)
    B, S, H, D = q.shape
    S_kv, KV = k.shape[1], k.shape[2]
    if (out.shape != q.shape or out.dtype != q.dtype
            or not out.is_contiguous() or dout.shape != q.shape
            or lse.shape != (B, H, S) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_attn_bwd takes out and lse as flash_attn_fwd "
                         "wrote them and dout in out's shape")
    if route is None:
        route = bwd_route(B, S, S_kv, offset, H, KV, D, q.dtype)
    if (route.passes not in ("simt", "mma", "wgmma")
            or (route.passes == "simt") != (q.dtype == torch.float32)
            or (route.passes == "wgmma" and (D not in WGMMA_HEAD_DIMS
                                             or route.hpb not in (1, 2)
                                             or (H // KV) % route.hpb))):
        raise ValueError(f"flash_attn_bwd has no route {route} for {q.dtype} "
                         f"at D = {D}, {H // KV} query heads a KV head")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    dout = dout.to(q.dtype).contiguous()
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S_kv, KV, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S_kv, KV, D), dtype=q.dtype, device=q.device)
    tail = (*_strides(q), *_strides(k), *_strides(v), 1.0 / math.sqrt(D))
    if route.passes != "wgmma":
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        rc = _build.lib("flash_attn").flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), _TYPES[q.dtype], B, S, S_kv,
            offset, H, KV, D, *tail, _build.stream(q))
        flash_attention.backward_launches += 1
        _build.check(rc, "flash_attn_bwd")
        return dq, dk, dv
    # lse (exp2 units) and delta of each query tile, 64 of each
    stats = torch.empty((B, H, -(-S // 64), 2, 64), dtype=torch.float32,
                        device=q.device)
    # the dq pass, then the dk/dv pass as its programmatic dependent (PDL):
    # its blocks start as the dq pass's retire
    rc = _build.lib("flash_bwd_wgmma").flash_bwd_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), B, S, S_kv, offset, H, KV, D,
        route.hpb, *wgmma_spreads(q.device.index, B, S, S_kv, H, KV, D, route.hpb), 3,
        *tail, _build.stream(q))
    flash_attention.backward_launches += 1
    flash_attention.wgmma_launches += 1
    _build.check(rc, "flash_bwd_wgmma")
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
flash_attention.forward_wgmma_launches = 0
flash_attention.backward_launches = 0
flash_attention.wgmma_launches = 0
