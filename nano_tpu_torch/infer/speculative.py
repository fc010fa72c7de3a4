"""Self-speculative greedy decoding: n-gram drafts verified k+1 tokens a
round.

Port of ``nano_tpu/infer/speculative.py``.  A round drafts k tokens by
prompt lookup over the stream's own history (the latest earlier
occurrence of the current 3-gram, else 2-gram, and what followed it), runs
the current token and the k drafts through one (k+1)-row forward, and
emits the penalized-greedy tokens of the rows whose draft prefix was
accepted: 1 to k+1 tokens, each the argmax of a forward over the true
prefix.  There is no draft model and acceptance is exact token equality.

On the H100 a round is not free beside a plain step: the plain step is one
row through ``q80_matvec_fq`` / ``q4k_matvec_fq`` and ``decode_attention``,
while a round's k+1 rows go through ``q80_matmul_w8a8`` (or ``q4k_act_quant``
+ ``q4k_matmul_w4a4``), the einsum attention over the attended rows and
the head over every row.  Rounds pay only where drafts are accepted;
``engine.Session`` and ``serve.batching`` park speculation where they are
not.  PERF.md gives the card's round cost beside the step's.

The streams equal plain greedy decode's where the two forwards round
alike: on the CPU test models they are token-identical.  At full width the
verify forward sums the attention in another order than the decode kernel,
so two streams can part at a near-tie argmax, the divergence class the JAX
package documents for its (1, k+1) program.

Every function here works on device tensors and reads nothing back to the
host (no ``.item()``, ``nonzero`` or boolean indexing), so a round can be
captured in a CUDA graph: ``engine.SingleDecoder`` replays one round a
replay for ``Session`` and ``generate_on_device`` (the counterpart of the
JAX ``spec_decode_loop``'s ``while_loop``), and ``serve.batching`` one
batched step.  Tensors carry a leading batch axis: the single stream is
B = 1.

The cache needs no rollback: a round at position p writes rows [p, p+k];
rows past the accepted prefix hold rejected drafts, but the next round
starts at p' <= p + k + 1 and writes [p', p'+k] before it attends, and the
causal mask hides rows past each query in the meantime.  The history
buffer keeps the same invariant.

Scope: greedy (temperature 0) with any repetition penalty; each row's
penalty mask is the seen set plus the draft prefix before it
(``prefix_masks``), which equals sequential penalized greedy because a row
is kept only when its prefix was accepted.  Stochastic sampling is not
verified; the engines decode it plainly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nano_tpu_torch.models import gpt
from nano_tpu_torch.ops import sampling

# stats of the most recent speculative generate_on_device call (host side,
# for benchmarks): {"tokens": emitted by rounds, "rounds": verify forwards}
LAST_STATS = None


def batched_ngram_draft(hist: torch.Tensor, pos: torch.Tensor, k: int
                        ) -> torch.Tensor:
    """k draft tokens per row by prompt lookup over the token history.

    hist (B, T): hist[b, i] is the token fed at position i of row b, valid
    for i <= pos[b].  Finds the LATEST position p < pos[b] whose trailing
    3-gram matches (hist[pos-2], hist[pos-1], hist[pos]), else the latest
    2-gram match, and proposes hist[p+1 : p+1+k]; with no match the slice
    from 0 (a junk draft costs nothing: acceptance lands at 0).  -> (B, k).
    """
    B, T = hist.shape
    idx = torch.arange(T, device=hist.device)
    h1 = torch.cat([hist[:, :1], hist[:, :-1]], dim=1)      # hist[i-1]
    h2 = torch.cat([hist[:, :2], hist[:, :-2]], dim=1)      # hist[i-2]
    # a position past the history (a slot that is not decoding) is taken
    # as the last one, as the JAX gather clamps
    p = pos.long().clamp(0, T - 1)[:, None]
    a0 = hist.gather(1, p)
    a1 = hist.gather(1, (p - 1).clamp(min=0))
    a2 = hist.gather(1, (p - 2).clamp(min=0))
    valid = (idx[None, :] < p) & (idx[None, :] >= 2)
    m2 = valid & (hist == a0) & (h1 == a1)
    m3 = m2 & (h2 == a2)
    score = torch.where(m3, idx + T, torch.where(m2, idx, -1))
    best = score.amax(dim=1)
    p_star = torch.where(best >= T, best - T, best)
    start = torch.where(p_star >= 1, p_star + 1, 0).clamp(0, T - k)
    return hist.gather(1, start[:, None]
                       + torch.arange(k, device=hist.device)[None, :])


def ngram_draft(hist: torch.Tensor, pos: torch.Tensor, k: int
                ) -> torch.Tensor:
    """One history (T,) at position pos () -> k draft tokens (k,)."""
    return batched_ngram_draft(hist[None], pos.reshape(1), k)[0]


def prefix_masks(draft: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """Per-row repetition-penalty masks of a verify round: row i of slot b
    is seen[b] | {draft[b, j] : j < i}; a draft id outside [0, V) marks
    nothing, as the JAX one-hot.  draft (B, k), seen (B, V) bool ->
    (B, k+1, V) bool."""
    B, k = draft.shape
    V = seen.shape[-1]
    masks = torch.zeros((B, k + 1, V + 1), dtype=torch.bool,
                        device=seen.device)
    masks[:, :, :V] = seen[:, None, :]
    ids = torch.where((draft >= 0) & (draft < V), draft, V)   # V: no token
    ii, jj = torch.tril_indices(k + 1, k + 1, offset=-1, device=draft.device)
    # the value a device tensor: a host one is a copy, which a CUDA graph
    # capture refuses
    masks[torch.arange(B, device=draft.device)[:, None], ii[None, :],
          ids[:, jj]] = torch.ones((), dtype=torch.bool, device=draft.device)
    return masks[:, :, :V]


def emitted_mask(toks: torch.Tensor, n_out: torch.Tensor, V: int
                 ) -> torch.Tensor:
    """(B, V) bool: the tokens toks[b, :n_out[b]] of a round (B, k+1)."""
    valid = (torch.arange(toks.shape[1], device=toks.device)[None, :]
             < n_out[:, None])
    vocab = torch.arange(V, device=toks.device)
    return ((toks[:, :, None] == vocab) & valid[:, :, None]).any(dim=1)


def accepted(draft: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The leading run of drafts equal to the verified tokens: draft (B, k),
    g (B, k+1) -> (B,) int64 in [0, k]."""
    B, k = draft.shape
    match = torch.cat([draft == g[:, :k],
                       torch.zeros((B, 1), dtype=torch.bool,
                                   device=draft.device)], dim=1)
    return torch.argmin(match.to(torch.int32), dim=1)


def put_rows(buf: torch.Tensor, start: torch.Tensor, vals: torch.Tensor
             ) -> None:
    """buf[b, start[b] + j] = vals[b, j] in place, dropping columns past
    the buffer as the JAX scatter does: a dropped column writes back what
    the last column holds (a row both reaching the last column and passing
    it is the garbage of a slot that is not decoding)."""
    T = buf.shape[1]
    col = start.long()[:, None] + torch.arange(vals.shape[1],
                                               device=buf.device)[None, :]
    colc = col.clamp(max=T - 1)
    buf.scatter_(1, colc, torch.where(col < T, vals, buf.gather(1, colc)))


def verify_step(params, tok: torch.Tensor, pos: torch.Tensor,
                cache: gpt.KVCache, hist: torch.Tensor, seen: torch.Tensor,
                rep_penalty: float, cfg, dtype, k: int,
                attn_len: Optional[int] = None, rope=None,
                live: Optional[torch.Tensor] = None, lora=None,
                lora_scale=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One speculation round of one stream (JAX's ``_verify_round`` and its
    jitted ``verify_step``): draft k, verify k+1 in one forward.

    tok (1,) the current token (input at position pos), pos (1,) int32,
    hist (1, T), seen (1, V) bool.  -> (g (k+1,), n_out (1,) int64): g are
    the penalized-greedy tokens at positions pos..pos+k, the first n_out
    of them the emitted continuation; the next round's input is
    g[n_out-1] at position pos + n_out.  The cache, hist (g at pos+1..)
    and seen (the emitted tokens) are updated in place.  `live` (1,) bool:
    where false the round emits nothing (n_out 0, seen unchanged).  The
    penalty is ``sampling.apply_repetition_penalty``, the plain step's op.
    `lora`: the stream's adapter, as the plain step takes it.  The caller
    guarantees pos + k + 1 < attn_len.
    """
    draft = batched_ngram_draft(hist, pos, k)                  # (1, k)
    ids = torch.cat([tok.reshape(1, 1), draft], dim=1)          # (1, k+1)
    logits, _ = gpt.forward_spec_batched(params, ids, cache, pos, cfg,
                                         dtype, attn_len=attn_len, rope=rope,
                                         lora=lora, lora_scale=lora_scale)
    lf = logits[0]                                              # (k+1, V)
    if rep_penalty != 1.0:
        lf = sampling.apply_repetition_penalty(
            lf, prefix_masks(draft, seen)[0], rep_penalty)
    g = torch.argmax(lf, dim=-1)
    n_out = accepted(draft, g[None]) + 1
    if live is not None:
        n_out = n_out * live
    put_rows(hist, pos + 1, g[None])
    seen |= emitted_mask(g[None], n_out, seen.shape[-1])
    return g, n_out


def spec_decode_round(dec, k: int, attn_len: Optional[int] = None) -> None:
    """One round of the speculative decode loop over a decoder's device
    state (``engine.SingleDecoder``: tok, pos, cache, hist, seen, out,
    n_out, stop_at, rounds, round_g, round_n and the adapter's buffers),
    in place: the condition and the body of JAX's ``spec_decode_loop``
    ``while_loop``, which ``SingleDecoder`` replays from a CUDA graph and
    reads back every few rounds.

    The round is live while n_out < stop_at and pos + k + 2 <= max_seq_len
    (JAX's condition).  A round past the loop's end runs at position
    max_seq_len, whose cache row is the decoder's spare one and whose
    history columns are dropped: it changes no token of out[:n_out], not
    pos, and no cache row at or below pos.  round_g[:k+1] and round_n get
    the round's tokens and count for a host-driven ``Session``.
    """
    ctx = dec.ctx
    T = ctx.max_seq_len
    live = (dec.n_out < dec.stop_at) & (dec.pos + (k + 2) <= T)
    g, n = verify_step(ctx.params, dec.tok, torch.where(live, dec.pos, T),
                       dec.cache, dec.hist, dec.seen,
                       ctx.sampler.repetition_penalty, ctx.cfg, ctx.dtype, k,
                       attn_len, ctx.rope_tables(), live, dec.adapter.lora,
                       dec.adapter.scale)
    dec.out.index_copy_(0, dec.n_out + torch.arange(k + 1, device=g.device),
                        g)
    dec.tok.copy_(torch.where(live, g.gather(0, (n - 1).clamp(min=0)),
                              dec.tok))
    dec.pos.add_(n)
    dec.n_out.add_(n)
    dec.rounds.add_(live)
    dec.round_g[:k + 1].copy_(g)
    dec.round_n.copy_(n)
