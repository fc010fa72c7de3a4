"""Continuous batching: many independent generation streams share one
batched decode step.

Port of ``nano_tpu/serve/batching.py``.  A slot-based engine: the KV
cache carries a batch axis, every slot advances one token per step
wherever its stream is (a position per slot, on the device), and slots
attach and detach without new shapes (idle slots compute garbage that is
ignored).  Per-slot sampler parameters (temperature, top-p, repetition
penalty) are (B,) device vectors.

The batched step (``gpt.forward_decode_batched`` + ``_sample_rows``) reads
and writes only the engine's static buffers, so on the card it is captured
as a CUDA graph once per (cache length, all-greedy or not) and replayed:
``step_burst(n)`` is n replays and one host read.  The cache is one allocation of max_seq_len rows per slot; each
capacity of the pow2 bucketing (128, 256, ...) is a contiguous view of its
front, so every graph stays valid while capacity grows and resets.  All
of it runs on the context's stream under the context's lock
(``LLMContext.on_stream``), which the engine's own lock always precedes:
a client's prefill waits for a burst's replays and captures, and is never
recorded into them.

Speculative serving (``ctx.spec_k`` > 0): a step drafts k tokens per slot
from the slot's own history and verifies k+1 rows per slot in one
``gpt.forward_spec_batched``; a greedy slot emits 1..k+1 tokens, a
stochastic or parked one (``spec_ok`` false) its row 0 sampled exactly as
the plain step samples it.  Its graph is keyed by (cache length,
all-greedy or not, k); k ramps engine-wide in pow2 buckets and slots park
one by one, as the JAX engine's do.

LoRA: the engine serves the adapter its context had when the engine was
made to every slot, or, with ``adapters`` ({name: LoRA .bin}), each slot
with the adapter it joined with (``add(..., adapter=name)``; None: the
base).  The named adapters are one stack, padded to the largest rank
(zero columns add nothing; each keeps its own alpha / rank), whose row 0
is the base: a zero adapter with scale 0.  Each slot's row is an index in
a static (B,) device buffer, written when the slot joins, so a slot that
joins with another adapter replays the same graphs; a step runs every
adapter's branch over every slot and keeps each slot's own
(``gpt._lora_delta``).  A joining stream's prefill takes its adapter
alone.

Over a tensor-parallel context (``LLMContext.shard``) every rank runs its
own engine over its part of the model, and the ranks serve in SPMD: each
makes the same ``add`` and ``step`` calls with the same prompts, the
blocks sum their row-parallel products over the model group, and every
rank draws the same tokens.  Under gloo the steps run eagerly
(``LLMContext.captures``).  A frontend that feeds every rank from one
process is ROADMAP item 12.
"""

from __future__ import annotations

import collections
import threading
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nano_tpu_torch.infer import engine as eng
from nano_tpu_torch.infer import speculative
from nano_tpu_torch.io import binfmt
from nano_tpu_torch.models import gpt
from nano_tpu_torch.ops import sampling


def _sample_rows(logits: torch.Tensor, temperature: torch.Tensor,
                 top_p: torch.Tensor, top_k: int,
                 generator: Optional[torch.Generator], greedy: bool = False
                 ) -> torch.Tensor:
    """Per-slot sampling over penalized f32 logits (B, V) with (B,)
    temperature and top-p -> tokens (B,).  `greedy` (every active slot at
    temperature 0) is a bare argmax.  Otherwise nucleus sampling over the
    top-K window with the true full-vocab probabilities, a full-vocab draw
    for slots whose top_p is outside (0, 1) (when top_k is 0), and the
    argmax for slots at temperature 0."""
    greedy_tok = torch.argmax(logits, dim=-1)
    if greedy:
        return greedy_tok
    window = min(top_k if top_k else eng.NUCLEUS_WINDOW, logits.shape[-1])
    scaled = logits / temperature.clamp(min=1e-6)[:, None]
    top_logits, top_idx = torch.topk(scaled, window, dim=-1)
    if top_k:
        probs = torch.softmax(top_logits, dim=-1)
    else:
        probs = torch.exp(top_logits - torch.logsumexp(scaled, dim=-1,
                                                       keepdim=True))
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) <= top_p[:, None]
    use_topp = ((top_p > 0.0) & (top_p < 1.0))[:, None]
    probs = torch.where(keep | ~use_topp, probs, torch.zeros_like(probs))
    sampled = torch.gather(top_idx, -1,
                           eng._draw(probs, generator)[:, None])[:, 0]
    if not top_k:
        full = eng._draw(torch.softmax(scaled, dim=-1), generator)
        sampled = torch.where(use_topp[:, 0], sampled, full)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)


@dataclass
class Slot:
    """Slot lifecycle: FREE -> attached (claimed by add(), survives the
    end of decoding) -> FREE again only at the handler's explicit
    release().  `active` means "currently decoding"; a finished stream has
    active=False but attached=True, so a concurrent add() can never alias
    a slot whose consumer is still draining its queue."""
    active: bool = False
    attached: bool = False
    prompt_len: int = 0
    generated: int = 0
    max_new_tokens: int = 0
    finished_reason: Optional[str] = None
    sink: Optional[object] = None   # consumer's queue, set under the lock


class BurstResult(Dict[int, list]):
    """{slot: [tokens...]} plus per-slot end flags and sinks captured
    under the engine lock — consumers must use `ended` and `sinks` instead
    of re-reading live slot state (a new stream may have re-claimed the
    slot by the time they look)."""

    def __init__(self, toks: Dict[int, list], ended: Dict[int, bool],
                 sinks: Optional[Dict[int, object]] = None):
        super().__init__(toks)
        self.ended = ended
        self.sinks = sinks or {}


class BatchedEngine:
    """Slot-based continuous batching over one LLMContext.  `adapters`
    ({name: LoRA .bin path}): slots decode with their own adapters in one
    batched step (the module's docstring)."""

    def __init__(self, ctx: "eng.LLMContext", n_slots: int = 8,
                 adapters: Optional[Dict[str, str]] = None):
        self.ctx = ctx
        self.n_slots = n_slots
        dev = ctx.device
        V = ctx.cfg.vocab_size
        # LoRA: each slot's registry row (host and device), the stacked
        # registry (L, A, in, r) / (L, A, r, out) with its scales (A,) in the
        # compute dtype, and each row's adapter alone for the prefill
        self.adapter_idx = np.zeros(n_slots, np.int64)
        self._adapter_idx_t = torch.zeros((n_slots,), dtype=torch.int64,
                                          device=dev)
        self.adapter_ids: Dict[Optional[str], int] = {None: 0}
        self.lora_stack: Optional[Dict[str, torch.Tensor]] = None
        self.lora_scales: Optional[torch.Tensor] = None
        self._adapter_prefill = {0: (ctx.lora, ctx.lora_scale)}
        self._base_scale = torch.full((), ctx.lora_scale, dtype=ctx.dtype,
                                      device=dev)
        if adapters:
            if ctx.lora is not None:
                raise ValueError("use either a base-attached LoRA or "
                                 "named adapters, not both")
            self._build_adapter_stack(adapters)
        self._store = ctx.new_cache(n_slots)        # max_seq_len rows
        self.cache = self._view(self._min_cache_len())
        self.pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.tok = torch.zeros((n_slots,), dtype=torch.int64, device=dev)
        self.seen = torch.zeros((n_slots, V), dtype=torch.bool, device=dev)
        self._temperature_t = torch.ones((n_slots,), device=dev)
        self._top_p_t = torch.full((n_slots,), 0.8, device=dev)
        self._rep_penalty_t = torch.ones((n_slots,), device=dev)
        self.out = torch.zeros((ctx.max_seq_len, n_slots), dtype=torch.int64,
                               device=dev)
        self.n_out = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.gen = ctx.generator()
        self.temperature = np.full(n_slots, 1.0, np.float32)
        self.top_p = np.full(n_slots, 0.8, np.float32)
        self.rep_penalty = np.full(n_slots, 1.0, np.float32)
        self._pos_host = np.zeros(n_slots, np.int64)
        self.slots: List[Slot] = [Slot() for _ in range(n_slots)]
        self.lock = threading.Lock()   # one device mutator at a time
        self._graphs: Dict[tuple, eng.DecodeGraph] = {}
        # speculative serving: each slot's token history (drafts come from
        # its own stream; stale entries cost acceptance, never correctness),
        # a spec step's tokens (steps, B, spec_k + 1) and counts (steps, B),
        # which slots verify (greedy and not parked), the engine-wide draft
        # length and each slot's park (bursts left) and backoff (cap 8)
        K1 = ctx.spec_k + 1
        self.hist = torch.zeros((n_slots, ctx.max_seq_len), dtype=torch.int64,
                                device=dev)
        self.emit = torch.zeros((ctx.max_seq_len, n_slots, K1),
                                dtype=torch.int64, device=dev)
        self.emit_n = torch.zeros((ctx.max_seq_len, n_slots),
                                  dtype=torch.int64, device=dev)
        self._spec_ok_t = torch.zeros((n_slots,), dtype=torch.bool,
                                      device=dev)
        self._spec_k_cur = 1
        self._spec_park = np.zeros(n_slots, np.int64)
        self._spec_park_len = np.ones(n_slots, np.int64)
        # bursts by kind: speculative, and plain by the rule that took them
        self.bursts_by: Dict[str, int] = collections.Counter()

    # ------------------------------------------------------------
    def _build_adapter_stack(self, adapters: Dict[str, str]) -> None:
        """Load the named adapters into one stack, each zero-padded to the
        largest rank (the padding's columns of A and rows of B contribute
        nothing), behind a zero row 0 of scale 0; on a tensor-parallel
        context the stack is cut as one adapter is (``mesh.cut_lora``)."""
        from nano_tpu_torch.parallel.mesh import cut_lora, full_config
        ctx = self.ctx
        loaded = [(name, binfmt.read_lora(path, full_config(ctx.cfg)))
                  for name, path in adapters.items()]
        rmax = max(bl.rank for _, bl in loaded)

        def pad(key, leaf, r):
            w = [(0, 0)] * leaf.ndim
            w[-1 if key.endswith("_a") else -2] = (0, rmax - r)
            return np.pad(leaf, w)

        padded = [{k: pad(k, v, bl.rank) for k, v in bl.lora.items()}
                  for _, bl in loaded]
        self.lora_stack = {
            k: torch.from_numpy(np.stack(
                [np.zeros_like(padded[0][k])] + [p[k] for p in padded],
                axis=1)).to(ctx.device, ctx.dtype)
            for k in padded[0]}
        tp = getattr(ctx.cfg, "tp", None)
        if tp is not None:
            self.lora_stack = cut_lora(self.lora_stack, tp)
        scales = [bl.alpha / bl.rank for _, bl in loaded]
        self.lora_scales = torch.tensor([0.0] + scales).to(ctx.device,
                                                           ctx.dtype)
        for i, ((name, _), sc) in enumerate(zip(loaded, scales)):
            self.adapter_ids[name] = i + 1
            self._adapter_prefill[i + 1] = (
                {k: v[:, i + 1] for k, v in self.lora_stack.items()}, sc)

    def _lora_args(self) -> dict:
        """The batched forwards' adapter arguments: the stack and each
        slot's row where adapters are named, else the context's adapter
        as the engine found it (or none)."""
        if self.lora_stack is not None:
            return dict(lora=self.lora_stack, lora_scale=self.lora_scales,
                        lora_idx=self._adapter_idx_t)
        lora = self._adapter_prefill[0][0]
        return dict(lora=lora, lora_scale=self._base_scale)

    # ------------------------------------------------------------
    def _min_cache_len(self) -> int:
        return min(128, self.ctx.max_seq_len)

    def _cache_len(self) -> int:
        return self.cache.max_seq

    def _view(self, C: int) -> gpt.KVCache:
        """The cache of capacity C: (L, B, C, ...) contiguous over the
        front of the max_seq_len store."""
        def view(t):
            if t is None:
                return None
            shape = (*t.shape[:2], C, *t.shape[3:])
            return t.view(-1)[:int(np.prod(shape))].view(shape)
        s = self._store
        return gpt.KVCache(k=view(s.k), v=view(s.v), k_scale=view(s.k_scale),
                           v_scale=view(s.v_scale))

    @staticmethod
    def _tensors(cache: gpt.KVCache) -> List[torch.Tensor]:
        return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
                if t is not None]

    def _set_capacity(self, C: int) -> None:
        """Move to capacity C, keeping every slot's rows (zero past them),
        as the JAX engine's _grow_cache pads.  Caller holds the lock."""
        with self.ctx.on_stream():
            old = self._cache_len()
            keep = [t[:, :, :min(old, C)].clone()
                    for t in self._tensors(self.cache)]
            self.cache = self._view(C)
            for t, k in zip(self._tensors(self.cache), keep):
                t.zero_()
                t[:, :, :k.shape[2]] = k

    def _ensure_capacity(self, need: int) -> None:
        """Grow the cache's capacity to cover `need` rows (pow2-bucketed
        from 128, capped at max_seq_len).  Caller holds the lock."""
        want = min(eng._bucket(max(need, 1), minimum=self._min_cache_len()),
                   self.ctx.max_seq_len)
        if want > self._cache_len():
            self._set_capacity(want)

    # ------------------------------------------------------------
    def _step(self, cache: gpt.KVCache, greedy: bool) -> None:
        """One decode step for all slots over the static buffers."""
        ctx = self.ctx
        logits, _ = gpt.forward_decode_batched(
            ctx.params, self.tok, cache, self.pos, ctx.cfg, dtype=ctx.dtype,
            rope=ctx.rope_tables(), **self._lora_args())
        logits = torch.where(self.seen, logits / self._rep_penalty_t[:, None],
                             logits)
        nxt = _sample_rows(logits, self._temperature_t, self._top_p_t,
                           ctx.sampler.top_k, self.gen, greedy)
        sampling.update_seen_mask(self.seen, nxt)
        self.tok.copy_(nxt)
        self.out.index_copy_(0, self.n_out, nxt[None])
        self.pos.add_(1)
        self.n_out.add_(1)

    def _spec_step(self, cache: gpt.KVCache, greedy: bool, k: int) -> None:
        """One speculative step for all slots over the static buffers (the
        JAX engine's ``_batched_spec_step``): slots in ``spec_ok`` emit the
        1..k+1 verified penalized-greedy tokens of their rows; the others
        emit row 0's token, drawn by ``_sample_rows`` from the generator
        exactly as ``_step`` draws it, and advance one position.  With a
        sampled slot in the step (not `greedy`), row 0 of every slot
        attends through the decode kernel, as the plain step does, so a
        sampled slot's logits, draws and stream are the plain engine's bit
        for bit.  Rows past a slot's emitted tokens are rejected drafts,
        which the next step's cache writes cover."""
        ctx = self.ctx
        V = ctx.cfg.vocab_size
        drafts = speculative.batched_ngram_draft(self.hist, self.pos, k)
        ids = torch.cat([self.tok[:, None], drafts], dim=1)      # (B, k+1)
        logits, _ = gpt.forward_spec_batched(
            ctx.params, ids, cache, self.pos, ctx.cfg, dtype=ctx.dtype,
            rope=ctx.rope_tables(), first_row_kernel=not greedy,
            **self._lora_args())
        rep = self._rep_penalty_t[:, None, None]
        pen = torch.where(speculative.prefix_masks(drafts, self.seen),
                          logits / rep, logits)
        g = torch.argmax(pen, dim=-1)                            # (B, k+1)
        n_acc = speculative.accepted(drafts, g)
        if greedy:
            row0 = g[:, 0]       # row 0's mask is seen: the plain argmax
        else:
            row0 = _sample_rows(
                torch.where(self.seen, logits[:, 0] / rep[:, 0], logits[:, 0]),
                self._temperature_t, self._top_p_t, ctx.sampler.top_k,
                self.gen)
        ok = self._spec_ok_t
        n = torch.where(ok, n_acc + 1, 1)
        emit = torch.where(ok[:, None], g,
                           torch.cat([row0[:, None], g[:, 1:]], dim=1))
        nxt = torch.where(ok, g.gather(1, n_acc[:, None])[:, 0], row0)
        speculative.put_rows(self.hist, self.pos + 1, emit)
        self.seen |= speculative.emitted_mask(emit, n, V)
        self.tok.copy_(nxt)
        self.emit.index_copy_(0, self.n_out, F.pad(
            emit, (0, self.emit.shape[2] - (k + 1)))[None])
        self.emit_n.index_copy_(0, self.n_out, n[None])
        self.pos.add_(n)
        self.n_out.add_(1)

    def _graph(self, greedy: bool, k: int = 0) -> "eng.DecodeGraph":
        """The graph of one batched step at the current capacity: plain
        (k = 0) or speculative with k drafts."""
        key = (self._cache_len(), greedy, k)
        if key not in self._graphs:
            cache, me = self.cache, weakref.proxy(self)
            # the step holds the engine weakly: no reference cycle, so the
            # engine's cache is freed with the engine
            step = ((lambda: me._spec_step(cache, greedy, k)) if k else
                    (lambda: me._step(cache, greedy)))
            self._graphs[key] = eng.DecodeGraph(
                step, self.ctx.device, 1, None if greedy else self.gen,
                self.ctx.graph_pool(), self.ctx.captures)
        return self._graphs[key]

    def _run(self, n: int, greedy: bool) -> np.ndarray:
        """n batched steps -> their tokens (n, B), one host read."""
        with self.ctx.on_stream():
            self.n_out.zero_()
            graph = self._graph(greedy)
            for _ in range(n):
                graph.run()
            out = self.out[:n]
            if self.ctx.spec_k > 0:
                # keep each slot's history current through plain bursts:
                # the token of step t lands at position pos + 1 + t
                # (dropped past the end)
                t, b = np.nonzero(self._pos_host[None, :] + 1
                                  + np.arange(n)[:, None] < self.ctx.max_seq_len)
                dev = lambda a: torch.from_numpy(a).to(out.device)
                self.hist[dev(b), dev(self._pos_host[b] + 1 + t)] = \
                    out[dev(t), dev(b)]
            toks = out.cpu().numpy()
        self._pos_host += n
        return toks

    def _run_spec(self, n: int, greedy: bool, k: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """n speculative steps -> their tokens (n, B, k+1) and counts
        (n, B), one host read."""
        with self.ctx.on_stream():
            self.n_out.zero_()
            graph = self._graph(greedy, k)
            for _ in range(n):
                graph.run()
            both = torch.cat([self.emit[:n, :, :k + 1].reshape(-1),
                              self.emit_n[:n].reshape(-1)]).cpu().numpy()
        B = self.n_slots
        emits = both[:n * B * (k + 1)].reshape(n, B, k + 1)
        n_outs = both[n * B * (k + 1):].reshape(n, B)
        self._pos_host += n_outs.sum(axis=0)
        return emits, n_outs

    def _spec_ks(self) -> List[int]:
        """The draft lengths the controller can pick: pow2 up to spec_k,
        and spec_k."""
        ks, k = [], 1
        while k < self.ctx.spec_k:
            ks.append(k)
            k *= 2
        return ks + [self.ctx.spec_k] if self.ctx.spec_k > 0 else []

    def warmup(self) -> int:
        """Capture every decode graph serving can hit — each cache
        capacity, all-greedy or not, plain and at each draft length — and
        run each prefill bucket once, so no client pays a capture at first
        contact.  The engine must be idle: the warm-up steps run on its own
        buffers.  Returns the number of graphs and prefill buckets."""
        ctx = self.ctx
        T = ctx.max_seq_len
        with self.lock:
            if any(s.attached for s in self.slots):
                raise RuntimeError("warmup() needs an idle engine")
            n = 0
            pad = eng._bucket(1)
            pads = []
            while pad < T:
                pads.append(pad)
                pad *= 2
            # every named adapter's prefill has the same shapes: one covers
            # them all
            rows = [0] + ([1] if self.lora_stack is not None else [])
            for pad in pads + [T]:
                for row in rows:
                    with ctx.on_stream():
                        eng._prefill(ctx, [0] * min(pad, T - 1),
                                     ctx.new_cache(1, seq_len=pad),
                                     *self._adapter_prefill[row])
                    n += 1
            caps, c = [], self._min_cache_len()
            while c < T:
                caps.append(c)
                c *= 2
            for cap in caps + [T]:
                self.cache = self._view(cap)
                for greedy in (True, False):
                    for k in [0] + self._spec_ks():
                        self.n_out.zero_()
                        with ctx.on_stream():
                            self._graph(greedy, k).prepare()
                        n += 1
            self._set_capacity(self._min_cache_len())
            return n

    # ------------------------------------------------------------
    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if not s.active and not s.attached:
                return i
        return None

    @property
    def n_active(self) -> int:
        return sum(s.active for s in self.slots)

    # ------------------------------------------------------------
    def add(self, prompt_ids: List[int], max_new_tokens: int = 256,
            temperature: float = 1.0, top_p: float = 0.8,
            repetition_penalty: float = 1.1,
            sink: Optional[object] = None,
            adapter: Optional[str] = None) -> Optional[tuple]:
        """Attach a stream.  Returns (slot, first_token or None-if-stopped),
        or None when no slot is free (caller queues/retries).

        The engine lock is held only to claim the slot and to splice the
        prefilled rows in; the prefill holds only the context's lock, so it
        runs between two bursts and never inside one's capture.  `adapter`:
        the name of one of the engine's adapters (None: the base)."""
        if adapter not in self.adapter_ids:
            raise ValueError(f"unknown adapter: {adapter!r}")
        aidx = self.adapter_ids[adapter]
        ctx = self.ctx
        with self.lock:
            slot = self.free_slot()
            if slot is None:
                return None
            st = self.slots[slot]
            st.attached = True         # reserved; unclaimable until release
            st.active = False
        try:
            if not prompt_ids:
                # BOS-seed empty prompts, matching Session
                prompt_ids = [getattr(ctx.tokenizer, "bos_id", 0)]
            if len(prompt_ids) >= ctx.max_seq_len:
                prompt_ids = prompt_ids[-(ctx.max_seq_len - 1):]
            n = len(prompt_ids)
            # prefill on a bucket-sized batch-1 staging cache, then splice
            # the rows into the slot
            pad = min(eng._bucket(n), ctx.max_seq_len)
            tmp = ctx.new_cache(1, seq_len=pad)
            with ctx.on_stream():
                last, seen_row = eng._prefill(ctx, prompt_ids, tmp,
                                              *self._adapter_prefill[aidx])
                last = sampling.apply_repetition_penalty(
                    last, seen_row, repetition_penalty)
        except BaseException:
            with self.lock:
                st.attached = False
            raise
        try:
            return self._attach_prefilled(
                st, slot, prompt_ids, pad, tmp, seen_row, last, temperature,
                top_p, repetition_penalty, max_new_tokens, sink, aidx)
        except BaseException:
            with self.lock:
                st.attached = False
                st.active = False
            raise

    def _attach_prefilled(self, st, slot, prompt_ids, pad, tmp, seen_row,
                          last, temperature, top_p, repetition_penalty,
                          max_new_tokens, sink=None, adapter_idx: int = 0):
        ctx = self.ctx
        n = len(prompt_ids)
        with self.lock:
            # the spliced prompt rows (and the first decode write at n)
            # must fit the current capacity
            self._ensure_capacity(max(pad, n + 1))
            with ctx.on_stream():
                for dst, src in zip(self._tensors(self.cache),
                                    self._tensors(tmp)):
                    dst[:, slot, :pad] = src[:, 0]
                sampler = sampling.SamplerConfig(
                    temperature=temperature, top_p=top_p,
                    top_k=ctx.sampler.top_k,
                    repetition_penalty=repetition_penalty)
                first_t = eng._sample_windowed(last, sampler, self.gen)
                sampling.update_seen_mask(seen_row, first_t)
                self.pos[slot] = n
                self.tok[slot] = first_t[0]
                self.seen[slot] = seen_row[0]
                self._temperature_t[slot] = temperature
                self._top_p_t[slot] = top_p
                self._rep_penalty_t[slot] = repetition_penalty
                self._adapter_idx_t[slot] = adapter_idx
                if ctx.spec_k > 0:
                    self.hist[slot].zero_()
                    self.hist[slot, :n] = torch.tensor(prompt_ids,
                                                       dtype=torch.int64)
                    self.hist[slot, n] = first_t[0]
                first = int(first_t[0])
            self._pos_host[slot] = n
            self.adapter_idx[slot] = adapter_idx
            self._spec_park[slot] = 0         # a fresh stream: probe again
            self._spec_park_len[slot] = 1
            self.temperature[slot] = temperature
            self.top_p[slot] = top_p
            self.rep_penalty[slot] = repetition_penalty

            st.active = True
            st.prompt_len = n
            st.generated = 0
            st.max_new_tokens = max_new_tokens
            st.finished_reason = None
            st.sink = sink

            if first in ctx.stop_tokens:
                st.active = False
                st.finished_reason = "stop"
                return slot, None
            st.generated = 1
            if max_new_tokens <= 1:
                st.active = False
                st.finished_reason = "length"
            return slot, first

    def _spec_adapt_burst(self, unparked: List[int], n_outs: np.ndarray,
                          k: int) -> None:
        """After a speculative burst (the JAX engine's controller): a slot
        whose burst accepted nothing parks for a backoff-doubled number of
        bursts (cap 8), reset on any acceptance; the engine-wide k doubles
        toward spec_k when any slot fully accepted a round, else drops to
        the pow2 bucket of the best accepted run (floor 1).  n_outs (steps,
        B): tokens emitted per round."""
        best = 0
        for i in unparked:
            acc = int(n_outs[:, i].max()) - 1
            best = max(best, acc)
            if acc <= 0:
                self._spec_park[i] = self._spec_park_len[i]
                self._spec_park_len[i] = min(2 * self._spec_park_len[i], 8)
            else:
                self._spec_park_len[i] = 1
        if best >= k:
            self._spec_k_cur = min(2 * k, self.ctx.spec_k)
        else:
            self._spec_k_cur = 1 << (max(1, best).bit_length() - 1)

    def release(self, slot: int) -> None:
        """Return the slot to the free pool (consumer is done with it)."""
        with self.lock:
            self.slots[slot].active = False
            self.slots[slot].attached = False
            self.slots[slot].sink = None
            self.adapter_idx[slot] = 0
            # fully idle: reset the cache capacity (positions only grow
            # while streams live, so this is the one safe shrink point)
            if (not any(s.active or s.attached for s in self.slots)
                    and self._cache_len() > self._min_cache_len()):
                self.cache = self._view(self._min_cache_len())
                with self.ctx.on_stream():
                    for t in self._tensors(self.cache):
                        t.zero_()

    # ------------------------------------------------------------
    def _consume(self, slot_tokens: Dict[int, list]) -> BurstResult:
        """Slot bookkeeping over each active slot's candidate tokens.

        Returns a BurstResult {slot: [tokens...]} with per-slot `ended`
        flags; tokens after a stop token (or past the length limits) are
        discarded.  The flags are the ONLY safe end-of-stream signal.  The
        length cut uses prompt_len + generated, the same bound as
        Session's."""
        ctx = self.ctx
        out: Dict[int, list] = {}
        ended: Dict[int, bool] = {}
        sinks: Dict[int, object] = {}
        for i, st in enumerate(self.slots):
            if not st.active:
                continue
            sinks[i] = st.sink
            got: list = []
            for t in slot_tokens.get(i, []):
                if t in ctx.stop_tokens:
                    st.active = False
                    st.finished_reason = "stop"
                    break
                st.generated += 1
                got.append(t)
                if (st.generated >= st.max_new_tokens or
                        st.prompt_len + st.generated >= ctx.max_seq_len):
                    st.active = False
                    st.finished_reason = "length"
                    break
            out[i] = got
            ended[i] = not st.active
        return BurstResult(out, ended, sinks)

    def step_burst(self, n_steps: int = 1) -> BurstResult:
        """Advance every active slot n_steps steps: n_steps replays of the
        batched step and one host read (bursts longer than max_seq_len in
        pieces).  With spec_k > 0 each step is a speculative one while a
        greedy slot is unparked and every active slot has room for
        n_steps rounds of k + 1; a verifying slot emits up to k + 1 tokens
        a step.  `.ended[slot]` flags which streams finished during this
        burst (slots[slot].finished_reason says why)."""
        ctx = self.ctx
        with self.lock:
            if self.n_active == 0:
                return BurstResult({}, {}, {})
            max_pos = max(int(self._pos_host[i])
                          for i, s in enumerate(self.slots) if s.active)
            # all-greedy bursts replay the graph with a bare argmax
            greedy = all(self.temperature[i] <= 0.0
                         for i, s in enumerate(self.slots) if s.active)
            T = ctx.max_seq_len
            eligible = [i for i, s in enumerate(self.slots)
                        if s.active and self.temperature[i] <= 0.0]
            unparked = [i for i in eligible if self._spec_park[i] <= 0]
            if ctx.spec_k > 0:
                # parked slots sit this burst out and count it toward
                # their backoff
                for i in eligible:
                    if self._spec_park[i] > 0:
                        self._spec_park[i] -= 1
            k = max(1, min(self._spec_k_cur, ctx.spec_k))
            # a spec step may advance a slot k + 1 positions; near the
            # context end, or with no slot to verify, the plain steps (on
            # a spec-touched cache: rejected drafts lie past each position)
            need = max_pos + n_steps * (k + 1) + 2
            kind = ("plain" if ctx.spec_k == 0 else
                    "plain: no slot to verify" if not unparked else
                    "plain: near the context end" if need > T else "spec")
            self.bursts_by[kind] += 1
            if kind == "spec":
                self._ensure_capacity(need)
                self._spec_ok_t.copy_(torch.from_numpy(
                    (self.temperature <= 0.0) & (self._spec_park <= 0)))
                emits, n_outs = self._run_spec(n_steps, greedy, k)
                self._spec_adapt_burst(unparked, n_outs, k)
                return self._consume(
                    {i: [int(t) for step in range(n_steps)
                         for t in emits[step, i, :n_outs[step, i]]]
                     for i, s in enumerate(self.slots) if s.active})
            self._ensure_capacity(1 + n_steps + max_pos)
            toks = np.concatenate(
                [self._run(min(T, n_steps - lo), greedy)
                 for lo in range(0, n_steps, T)])
            return self._consume({i: toks[:, i].tolist()
                                  for i, s in enumerate(self.slots)
                                  if s.active})

    def step(self) -> BurstResult:
        """Advance every active slot one device step (a verifying slot may
        emit several tokens).  `.ended[slot]` flags streams that finished
        (stop token / length)."""
        return self.step_burst(1)
