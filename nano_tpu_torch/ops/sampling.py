"""Token samplers over a batch of logits (B, V).

Port of ``nano_tpu/ops/sampling.py``: repetition penalty by division over
seen tokens, temperature, top-k, top-p (nucleus) truncated where the
cumulative probability first exceeds p, greedy argmax (the FIRST maximum
on ties).  Random draws come from a ``torch.Generator``; they cannot
reproduce ``jax.random``, so cross-framework tests go through
``sample_with_coin``, which consumes an explicit uniform coin exactly like
the C engine's inverse-CDF walk, and ``xorshift_*`` reimplement the
reference RNG (infer/utils.c:959-968).

Divisions by a sampler constant divide by a tensor, not a Python number:
PyTorch turns the latter into a multiply by the reciprocal on CUDA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class SamplerConfig:
    """Runtime sampling parameters (reference: infer/infer.h:215-223)."""

    temperature: float = 1.0
    top_p: float = 0.8
    top_k: int = 0              # 0 = disabled
    repetition_penalty: float = 1.1


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Divide logits of already-seen tokens by `penalty`, regardless of
    sign (reference: model.py:517-519, infer/infer.c:1156-1167)."""
    if penalty == 1.0:
        return logits
    return torch.where(seen_mask, _div(logits, penalty), logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit to -inf."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, -float("inf")),
                       logits)


def apply_top_p(probs: torch.Tensor, p: float) -> torch.Tensor:
    """Zero the tail outside the nucleus, keeping the first token that
    crosses the cumulative threshold; ties break by token id."""
    if p <= 0.0 or p >= 1.0:
        return probs
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_probs = torch.gather(probs, -1, order)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) <= p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, probs, torch.zeros_like(probs))


def sample(logits: torch.Tensor, cfg: SamplerConfig,
           generator: Optional[torch.Generator] = None,
           seen_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw next tokens (B,) from logits (B, V); temperature 0 is argmax."""
    logits = logits.float()
    if seen_mask is not None:
        logits = apply_repetition_penalty(logits, seen_mask,
                                          cfg.repetition_penalty)
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _div(logits, cfg.temperature)
    if cfg.top_k:
        logits = apply_top_k(logits, cfg.top_k)
    probs = apply_top_p(torch.softmax(logits, dim=-1), cfg.top_p)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_with_coin(logits: torch.Tensor, coin: torch.Tensor,
                     cfg: SamplerConfig,
                     seen_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling with an explicit uniform coin in [0, 1): sort
    descending, truncate at top-p, walk the CDF with r = coin * kept_mass
    (infer/infer.c:1100-1109)."""
    logits = logits.float()
    if seen_mask is not None:
        logits = apply_repetition_penalty(logits, seen_mask,
                                          cfg.repetition_penalty)
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_div(logits, cfg.temperature), dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_probs = torch.gather(probs, -1, order)
    cum = torch.cumsum(sorted_probs, dim=-1)
    if 0.0 < cfg.top_p < 1.0:
        keep = (cum - sorted_probs) <= cfg.top_p
    else:
        keep = torch.ones_like(cum, dtype=torch.bool)
    kept_mass = torch.where(keep, cum, torch.zeros_like(cum)).amax(
        dim=-1, keepdim=True)
    r = coin.to(cum.dtype)[..., None] * kept_mass
    hit = keep & (cum > r)
    idx = hit.to(torch.uint8).argmax(dim=-1)   # first kept index past r
    # nothing hit (rounding): the last kept index
    last_kept = keep.sum(dim=-1) - 1
    idx = torch.where(hit.any(dim=-1), idx, last_kept)
    return torch.gather(order, -1, idx[..., None])[..., 0]


def update_seen_mask(seen_mask: torch.Tensor, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """Mark tokens (B,) as seen in the (B, V) mask, in place (one scatter
    on the device, so a CUDA graph can capture it)."""
    return seen_mask.scatter_(1, tokens.long()[:, None], True)


def seen_mask_from_ids(ids: torch.Tensor, length: torch.Tensor,
                       vocab_size: int) -> torch.Tensor:
    """(B, V) bool mask of the ids in buffer (B, T) at positions < length
    (the C engine: all tokens before the current position,
    infer/infer.c:1158-1160)."""
    B, T = ids.shape
    valid = (torch.arange(T, device=ids.device)[None, :]
             < torch.as_tensor(length, device=ids.device).reshape(-1, 1))
    # an id outside [0, V) marks nothing (the JAX one-hot is all false)
    valid &= (ids >= 0) & (ids < vocab_size)
    counts = torch.zeros((B, vocab_size), dtype=torch.int32, device=ids.device)
    counts.scatter_add_(1, ids.long().clamp(0, vocab_size - 1),
                        valid.to(torch.int32))
    return counts > 0


# ---------------------------------------------------------------------
# reference RNG (host-side, for parity harnesses)
# ---------------------------------------------------------------------

def xorshift_u32(state: np.uint64) -> tuple[np.uint64, np.uint32]:
    """xorshift* step (reference: infer/utils.c:959-965)."""
    s = np.uint64(state)
    with np.errstate(over="ignore"):
        s ^= s >> np.uint64(12)
        s ^= (s << np.uint64(25)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        s ^= s >> np.uint64(27)
        out = np.uint32(((s * np.uint64(0x2545F4914F6CDD1D)) &
                         np.uint64(0xFFFFFFFFFFFFFFFF)) >> np.uint64(32))
    return s, out


def xorshift_f32(state: np.uint64) -> tuple[np.uint64, float]:
    """uniform in [0,1) (reference: infer/utils.c:967-969)."""
    state, u = xorshift_u32(state)
    return state, float(u >> np.uint32(8)) / 16777216.0
