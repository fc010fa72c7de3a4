"""The cached forward's RMSNorm (with the residual add before it) and
SwiGLU, each with the Q80 or the Q4K quantization of its output as an
epilogue.

Port of the XLA fusions around the TPU kernel K1 (``_q80_kernel``,
``nano_tpu/ops/qmatmul.py``): ``rms_norm`` and ``block``'s ``x + a``
(``nano_tpu/models/gpt.py``), ``feed_forward``'s ``silu(h1) * h3``, and
``act_quant_q80``, which ``q80_matmul_int8`` applies to their rounded
output.  On the card each is one kernel (``csrc/norm_quant.cu``) that
writes its output in the activation dtype and, when asked
(``group_size`` > 0), also the ``Q80Act`` that a W8A8 product takes
instead of launching ``q80_act_quant`` on it: the same integer decisions.
``rms_norm_q4k`` and ``swiglu_q4k`` are the same kernels with the Q4K
epilogue instead (the JAX package's ``act_quant_q4k``,
``nano_tpu/ops/q4k.py``, which ``fake_quant_act`` applies before every
Q4K product): the ``Q4KAct`` that ``q4k_matvec_fq`` (one row) and
``q4k_matmul_w4a4`` (more) take instead of launching ``q4k_act_quant``.
``rms_norm_q4k_fq`` is ``rms_norm_q4k`` with ``fake_quant_act`` itself as
the epilogue: the final norm of a Q4K model whose head is the Q80 table
requantized from its embedding (the C engine's Q4K treatment of that
row, ``infer/infer.c:1012-1014``), instead of launching
``q4k_fake_quant`` on it.

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch
version (``*_plain``: the eager ops, then ``act_quant_q80_plain`` or
``act_quant_q4k_packed_plain``) only for tensors on the CPU.
``<wrapper>.launches`` counts kernel launches.  The kernels have no
backward: the training forward keeps the eager ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from nano_tpu_torch.ops import _build, int8_mma
from nano_tpu_torch.ops.q4k import (BLOCK_LEN, GROUP_LEN, Q4KAct,
                                    act_quant_q4k_packed_plain,
                                    fake_quant_act_plain, n_blocks_per_line)
from nano_tpu_torch.ops.qmatmul import Q80Act, act_quant_q80_plain

_TYPES = (torch.float32, torch.bfloat16)
VALUES_PER_THREAD = 4       # a thread's chunk of a row (csrc/norm_quant.cu)
MAX_THREADS = 1024
PASSES = (1, 2, 4, 8, 16)   # the kernels' instances
# the widest row the Q4K epilogue takes: the row as f32 in a block's
# dynamic shared memory (csrc/norm_quant.cu: kMaxRowSmem)
MAX_Q4K_ROW = 229376 // 4


# =====================================================================
# plain PyTorch versions (CPU path; on the card only for comparisons)
# =====================================================================

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w, computed in f32."""
    xf = x.float()
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)


def _act(y: torch.Tensor, group_size: int) -> Optional[Q80Act]:
    if not group_size:
        return None
    xq, sa = act_quant_q80_plain(y.reshape(-1, y.shape[-1]), group_size)
    return Q80Act(xq, sa, y.shape)


def rms_norm_q80_plain(x: torch.Tensor, weight: torch.Tensor, eps: float,
                       residual: Optional[torch.Tensor] = None,
                       group_size: int = 0, want_hn: bool = True):
    """What ``rms_norm_q80`` computes, in plain PyTorch: h = x + residual,
    hn = rms_norm(h), and with group_size > 0 hn's Q80Act."""
    h = x if residual is None else x + residual
    hn = rms_norm(h, weight, eps)
    return (None if residual is None else h, hn if want_hn else None,
            _act(hn, group_size))


def swiglu_q80_plain(h13: torch.Tensor, group_size: int = 0,
                     want_hidden: bool = True):
    """What ``swiglu_q80`` computes, in plain PyTorch: silu(h1) * h3 of
    h13 = [h1 | h3], and with group_size > 0 its Q80Act."""
    Fh = h13.shape[-1] // 2
    y = F.silu(h13[..., :Fh]) * h13[..., Fh:]
    return y if want_hidden else None, _act(y, group_size)


def _act_q4k(y: torch.Tensor) -> Q4KAct:
    return Q4KAct(*act_quant_q4k_packed_plain(y.reshape(-1, y.shape[-1])),
                  y.shape)


def rms_norm_q4k_plain(x: torch.Tensor, weight: torch.Tensor, eps: float,
                       residual: Optional[torch.Tensor] = None,
                       want_hn: bool = True):
    """What ``rms_norm_q4k`` computes, in plain PyTorch: h = x + residual,
    hn = rms_norm(h), and hn's Q4KAct."""
    h, hn, _ = rms_norm_q80_plain(x, weight, eps, residual)
    return h, hn if want_hn else None, _act_q4k(hn)


def rms_norm_q4k_fq_plain(x: torch.Tensor, weight: torch.Tensor, eps: float,
                          residual: Optional[torch.Tensor] = None,
                          want_hn: bool = True):
    """What ``rms_norm_q4k_fq`` computes, in plain PyTorch: h = x +
    residual, hn = rms_norm(h), and fake_quant_act_plain(hn): (..., n_pad)
    f32, 0 at and past E."""
    h, hn, _ = rms_norm_q80_plain(x, weight, eps, residual)
    fq = fake_quant_act_plain(hn.reshape(-1, hn.shape[-1]))
    return (h, hn if want_hn else None,
            fq.reshape(*hn.shape[:-1], fq.shape[-1]))


def swiglu_q4k_plain(h13: torch.Tensor, want_hidden: bool = True):
    """What ``swiglu_q4k`` computes, in plain PyTorch: silu(h1) * h3 of
    h13 = [h1 | h3], and its Q4KAct."""
    y, _ = swiglu_q80_plain(h13)
    return y if want_hidden else None, _act_q4k(y)


# =====================================================================
# kernel wrappers
# =====================================================================

def plan(n: int) -> Tuple[int, int]:
    """-> (threads, passes) of a block that holds a row of n values, 4 a
    thread a pass: at most 1024 threads, from the width alone (a row's bits
    never depend on the row count)."""
    chunks = -(-n // VALUES_PER_THREAD)
    T = min(MAX_THREADS, -(-chunks // 32) * 32)
    P = next((p for p in PASSES if p * T >= chunks), None)
    if P is None:
        raise ValueError(f"a row of {n} values is wider than the kernels "
                         f"take ({PASSES[-1] * MAX_THREADS * 4})")
    return T, P


def _check_group(n: int, group_size: int, T: int) -> None:
    gs = group_size
    if gs and not (gs >= VALUES_PER_THREAD and gs & (gs - 1) == 0
                   and n % gs == 0 and T % (gs // VALUES_PER_THREAD) == 0):
        raise ValueError(f"group size {gs} must be a power of two >= 4 "
                         f"dividing the row ({n}) with at most {4 * T}")


def _aligned(*ts: torch.Tensor) -> bool:
    """Every row of every tensor starts on 4 values (8 bytes of bf16, 16
    of f32)."""
    return all(t.data_ptr() % (VALUES_PER_THREAD * t.element_size()) == 0
               and t.shape[-1] % VALUES_PER_THREAD == 0 for t in ts)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _n_pad_q4k(n: int) -> int:
    if n > MAX_Q4K_ROW:
        raise ValueError(f"the Q4K epilogue takes rows of at most "
                         f"{MAX_Q4K_ROW} values, got {n}")
    return n_blocks_per_line(n) * BLOCK_LEN


def _outputs_q4k(B: int, n: int, device):
    n_pad = _n_pad_q4k(n)
    vp = torch.empty((B, n_pad // 2), dtype=torch.uint8, device=device)
    sa, ba, c = (torch.empty((B, n_pad // GROUP_LEN), dtype=torch.float32,
                             device=device) for _ in range(3))
    return vp, sa, ba, c


def _outputs(B: int, n: int, group_size: int, device):
    if not group_size:
        return None, None
    xq = torch.empty((B, n // group_size, group_size), dtype=torch.int8,
                     device=device)
    sa = torch.empty((B, n // group_size), dtype=torch.float32, device=device)
    return xq, sa


def _norm_args(name: str, x: torch.Tensor, weight: torch.Tensor,
               residual: Optional[torch.Tensor], want_hn: bool):
    """The checked inputs and the outputs of a norm kernel's launch ->
    (T, P, x2, a2, w, h, hn, vec): x and the residual as (B, E) rows, the
    f32 weight, h (with a residual) and hn (where wanted) to write, and
    whether every row is aligned to 4 values."""
    E = x.shape[-1]
    if (x.dtype not in _TYPES or weight.shape != (E,)
            or (residual is not None and (residual.shape != x.shape
                                          or residual.dtype != x.dtype))):
        raise ValueError(f"{name} takes f32/bf16 (..., E) x, a "
                         f"residual like it and an (E,) weight, got x "
                         f"{x.dtype} {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, residual "
                         f"{None if residual is None else tuple(residual.shape)}")
    T, P = plan(E)
    x2 = x.reshape(-1, E).contiguous()
    a2 = None if residual is None else residual.reshape(-1, E).contiguous()
    w = weight.float().contiguous()
    h = None if a2 is None else torch.empty_like(x2)
    hn = torch.empty_like(x2) if want_hn else None
    vec = _aligned(*(t for t in (x2, a2, h, hn, w) if t is not None))
    return T, P, x2, a2, w, h, hn, vec


def rms_norm_q80(x: torch.Tensor, weight: torch.Tensor, eps: float,
                 residual: Optional[torch.Tensor] = None,
                 group_size: int = 0, want_hn: bool = True):
    """x (..., E) f32/bf16 [+ residual] -> (h, hn, act): h = x + residual
    in x's dtype (None without a residual), hn = rms_norm(h, weight, eps)
    in x's dtype (None unless want_hn), act the Q80Act of hn at
    group_size (None at 0); kernel ``rms_norm_q80`` on the card."""
    if x.device.type == "cpu":
        return rms_norm_q80_plain(x, weight, eps, residual, group_size,
                                  want_hn)
    T, P, x2, a2, w, h, hn, vec = _norm_args("rms_norm_q80", x, weight,
                                             residual, want_hn)
    B, E = x2.shape
    _check_group(E, group_size, T)
    xq, sa = _outputs(B, E, group_size, x.device)
    fn = _build.lib("norm_quant").rms_norm_q80
    rc = fn(x2.data_ptr(), _ptr(a2), w.data_ptr(), _ptr(h), _ptr(hn),
            _ptr(xq), _ptr(sa), int(x.dtype == torch.bfloat16), B, E, eps,
            group_size, T, P, int(vec), _build.stream(x2))
    rms_norm_q80.launches += 1
    _build.check(rc, "rms_norm_q80")
    lead = x.shape
    return (None if h is None else h.reshape(lead),
            None if hn is None else hn.reshape(lead),
            None if xq is None else Q80Act(xq, sa, lead))


rms_norm_q80.launches = 0


def _swiglu_args(name: str, h13: torch.Tensor, want_hidden: bool):
    """The checked input and the output of a SwiGLU kernel's launch ->
    (T, P, x2, y, vec, lead): h13 as (B, 2F) rows, y (B, F) where wanted,
    whether every row is aligned to 4 values, and the output's shape."""
    if h13.dtype not in _TYPES or h13.shape[-1] % 2:
        raise ValueError(f"{name} takes f32/bf16 (..., 2F), got "
                         f"{h13.dtype} {tuple(h13.shape)}")
    Fh = h13.shape[-1] // 2
    T, P = plan(Fh)
    x2 = h13.reshape(-1, 2 * Fh).contiguous()
    y = (torch.empty((x2.shape[0], Fh), dtype=h13.dtype, device=h13.device)
         if want_hidden else None)
    vec = _aligned(*(t for t in (x2[:, :Fh], y) if t is not None))
    return T, P, x2, y, vec, torch.Size((*h13.shape[:-1], Fh))


def swiglu_q80(h13: torch.Tensor, group_size: int = 0,
               want_hidden: bool = True):
    """h13 (..., 2F) f32/bf16 = [h1 | h3] -> (hidden, act): hidden =
    silu(h1) * h3 (..., F) in h13's dtype (None unless want_hidden), act
    its Q80Act at group_size (None at 0); kernel ``swiglu_q80`` on the
    card."""
    if h13.device.type == "cpu":
        return swiglu_q80_plain(h13, group_size, want_hidden)
    T, P, x2, y, vec, lead = _swiglu_args("swiglu_q80", h13, want_hidden)
    B, Fh = x2.shape[0], lead[-1]
    _check_group(Fh, group_size, T)
    xq, sa = _outputs(B, Fh, group_size, h13.device)
    fn = _build.lib("norm_quant").swiglu_q80
    rc = fn(x2.data_ptr(), _ptr(y), _ptr(xq), _ptr(sa),
            int(h13.dtype == torch.bfloat16), B, Fh, group_size, T, P,
            int(vec), _build.stream(x2))
    swiglu_q80.launches += 1
    _build.check(rc, "swiglu_q80")
    return (None if y is None else y.reshape(lead),
            None if xq is None else Q80Act(xq, sa, lead))


swiglu_q80.launches = 0


def rms_norm_q4k(x: torch.Tensor, weight: torch.Tensor, eps: float,
                 residual: Optional[torch.Tensor] = None,
                 want_hn: bool = True):
    """x (..., E) f32/bf16 [+ residual] -> (h, hn, act): h and hn as
    ``rms_norm_q80`` gives them, act the Q4KAct of hn (its integer form,
    ``act_quant_q4k_packed``'s bits); kernel ``rms_norm_q4k`` on the card
    (``rms_norm_q80``'s with the Q4K epilogue)."""
    if x.device.type == "cpu":
        return rms_norm_q4k_plain(x, weight, eps, residual, want_hn)
    T, P, x2, a2, w, h, hn, vec = _norm_args("rms_norm_q4k", x, weight,
                                             residual, want_hn)
    B, E = x2.shape
    vp, sa, ba, c = _outputs_q4k(B, E, x.device)
    int8_mma.init(x.device, "norm_quant_init")
    fn = _build.lib("norm_quant").rms_norm_q4k
    rc = fn(x2.data_ptr(), _ptr(a2), w.data_ptr(), _ptr(h), _ptr(hn),
            vp.data_ptr(), sa.data_ptr(), ba.data_ptr(), c.data_ptr(),
            int(x.dtype == torch.bfloat16), B, E, eps, T, P, int(vec),
            _build.stream(x2))
    rms_norm_q4k.launches += 1
    _build.check(rc, "rms_norm_q4k")
    lead = x.shape
    return (None if h is None else h.reshape(lead),
            None if hn is None else hn.reshape(lead),
            Q4KAct(vp, sa, ba, c, lead))


rms_norm_q4k.launches = 0


def rms_norm_q4k_fq(x: torch.Tensor, weight: torch.Tensor, eps: float,
                    residual: Optional[torch.Tensor] = None,
                    want_hn: bool = True):
    """x (..., E) f32/bf16 [+ residual] -> (h, hn, fq): h and hn as
    ``rms_norm_q80`` gives them, fq the Q4K fake-quant of hn, (..., n_pad)
    f32 with 0 at and past E (``fake_quant_act``'s bits); kernel
    ``rms_norm_q4k_fq`` on the card (``rms_norm_q4k``'s with
    ``q4k_fake_quant`` as the epilogue)."""
    if x.device.type == "cpu":
        return rms_norm_q4k_fq_plain(x, weight, eps, residual, want_hn)
    T, P, x2, a2, w, h, hn, vec = _norm_args("rms_norm_q4k_fq", x, weight,
                                             residual, want_hn)
    B, E = x2.shape
    fq = torch.empty((B, _n_pad_q4k(E)), dtype=torch.float32,
                     device=x.device)
    int8_mma.init(x.device, "norm_quant_init")
    fn = _build.lib("norm_quant").rms_norm_q4k_fq
    rc = fn(x2.data_ptr(), _ptr(a2), w.data_ptr(), _ptr(h), _ptr(hn),
            fq.data_ptr(), int(x.dtype == torch.bfloat16), B, E, eps, T, P,
            int(vec), _build.stream(x2))
    rms_norm_q4k_fq.launches += 1
    _build.check(rc, "rms_norm_q4k_fq")
    lead = x.shape
    return (None if h is None else h.reshape(lead),
            None if hn is None else hn.reshape(lead),
            fq.reshape(*lead[:-1], fq.shape[-1]))


rms_norm_q4k_fq.launches = 0


def swiglu_q4k(h13: torch.Tensor, want_hidden: bool = True):
    """h13 (..., 2F) f32/bf16 = [h1 | h3] -> (hidden, act): hidden as
    ``swiglu_q80`` gives it, act its Q4KAct; kernel ``swiglu_q4k`` on the
    card (``swiglu_q80``'s with the Q4K epilogue)."""
    if h13.device.type == "cpu":
        return swiglu_q4k_plain(h13, want_hidden)
    T, P, x2, y, vec, lead = _swiglu_args("swiglu_q4k", h13, want_hidden)
    B, Fh = x2.shape[0], lead[-1]
    vp, sa, ba, c = _outputs_q4k(B, Fh, h13.device)
    int8_mma.init(h13.device, "norm_quant_init")
    fn = _build.lib("norm_quant").swiglu_q4k
    rc = fn(x2.data_ptr(), _ptr(y), vp.data_ptr(), sa.data_ptr(),
            ba.data_ptr(), c.data_ptr(), int(h13.dtype == torch.bfloat16),
            B, Fh, T, P, int(vec), _build.stream(x2))
    swiglu_q4k.launches += 1
    _build.check(rc, "swiglu_q4k")
    return (None if y is None else y.reshape(lead),
            Q4KAct(vp, sa, ba, c, lead))


swiglu_q4k.launches = 0
