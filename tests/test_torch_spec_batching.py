"""Speculative continuous batching of the port
(``nano_tpu_torch.serve.batching.BatchedEngine`` with ``spec_k`` > 0)
against the JAX package on the CPU, mirroring tests/test_spec_decode.py's
and tests/test_serve.py's batched spec cases on the toy model of
tests/test_torch_spec_decode.py: every greedy stream is token-identical
to the JAX engine's batched spec stream and to the port's plain engine,
across mixed sampling slots (the stochastic slot's draws the plain
engine's), a join mid-stream, the near-context-end fallback, an int8 KV
cache and the repetition penalty; the burst controller's k and park
trajectory equals JAX's; parked slots give the plain stream."""

import numpy as np
import pytest
import torch

from nano_tpu.serve.batching import BatchedEngine as JEngine
from nano_tpu_torch.serve.batching import BatchedEngine as TEngine
from tests.test_torch_spec_decode import RANDOMISH, REPETITIVE, _ctxs, toy  # noqa: F401


def _drain(be, slot, first, n_bursts=8, burst=4):
    got = [] if first is None else [first]
    for _ in range(n_bursts):
        r = be.step_burst(burst)
        got.extend(r.get(slot, []))
        if r.ended.get(slot):
            break
    return got


def _engines(toy, n_slots, spec_k=4, **kw):
    """{"plain": port engine without spec, "spec": port engine with it,
    "jax": the JAX engine with it}."""
    _, plain_ctx = _ctxs(toy, **kw)
    jctx, tctx = _ctxs(toy, spec_k=spec_k, **kw)
    return {"plain": TEngine(plain_ctx, n_slots=n_slots),
            "spec": TEngine(tctx, n_slots=n_slots),
            "jax": JEngine(jctx, n_slots=n_slots)}


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_batched_spec_matches_jax_and_plain(toy, penalty):
    """Three greedy streams at once, with the engine-wide k trajectory
    equal to JAX's, and verify rounds that accept drafts."""
    outs, ks = {}, {}
    for name, be in _engines(toy, 4).items():
        streams = [be.add(p, max_new_tokens=20, temperature=0.0,
                          repetition_penalty=penalty)
                   for p in (REPETITIVE, RANDOMISH, [12] * 6)]
        got = {s: [f] for s, f in streams}
        ks[name] = []
        for _ in range(8):
            r = be.step_burst(4)
            for s in got:
                got[s].extend(r.get(s, []))
            ks[name].append((be._spec_k_cur, tuple(be._spec_park)))
        outs[name] = [got[s] for s, _ in streams]
    assert outs["spec"] == outs["jax"] == outs["plain"]
    assert all(len(o) == 20 for o in outs["spec"])
    assert ks["spec"] == ks["jax"]
    assert max(k for k, _ in ks["spec"]) > 1


def test_batched_spec_mixed_sampling_slots(toy):
    """A stochastic slot in a spec engine draws from the generator as the
    plain engine's step does: its stream is the plain engine's, bit for
    bit; the greedy slot's is also JAX's."""
    outs = {}
    for name, be in _engines(toy, 4).items():
        g_slot, g_first = be.add(REPETITIVE, max_new_tokens=16,
                                 temperature=0.0, repetition_penalty=1.0)
        s_slot, s_first = be.add(RANDOMISH, max_new_tokens=16,
                                 temperature=0.9, top_p=0.85,
                                 repetition_penalty=1.1)
        got = {g_slot: [g_first], s_slot: [s_first]}
        for _ in range(12):
            r = be.step_burst(4)
            for s in got:
                got[s].extend(r.get(s, []))
            if not any(st.active for st in be.slots):
                break
        outs[name] = (got[g_slot], got[s_slot])
    assert outs["spec"] == outs["plain"]
    assert outs["spec"][0] == outs["jax"][0]
    assert len(outs["spec"][1]) == 16


def test_batched_spec_join_mid_stream(toy):
    outs = {}
    for name, be in _engines(toy, 4).items():
        s1, f1 = be.add(REPETITIVE, max_new_tokens=24, temperature=0.0,
                        repetition_penalty=1.0)
        got1 = [f1] + be.step_burst(3).get(s1, [])
        s2, f2 = be.add(RANDOMISH, max_new_tokens=12, temperature=0.0,
                        repetition_penalty=1.0)
        got2 = [f2]
        for _ in range(8):
            r = be.step_burst(3)
            got1.extend(r.get(s1, []))
            got2.extend(r.get(s2, []))
            if r.ended.get(s1) and r.ended.get(s2):
                break
        outs[name] = (got1, got2)
    assert outs["spec"] == outs["jax"] == outs["plain"]


def test_batched_spec_near_context_end_falls_back(toy, monkeypatch):
    """A stream that verifies until the cache end is near, then finishes
    through the plain steps on the spec-touched cache, at the length
    wall."""
    long_prompt = (REPETITIVE * 8)[:84]
    spec_bursts = []
    run_spec = TEngine._run_spec

    def counted(self, *a):
        spec_bursts.append(a)
        return run_spec(self, *a)

    monkeypatch.setattr(TEngine, "_run_spec", counted)
    outs = {}
    for name, be in _engines(toy, 2, spec_k=7).items():
        slot, first = be.add(long_prompt, max_new_tokens=64,
                             temperature=0.0, repetition_penalty=1.0)
        outs[name] = _drain(be, slot, first, n_bursts=16, burst=4)
    assert outs["spec"] == outs["jax"] == outs["plain"]
    assert len(outs["spec"]) == 128 - 84
    assert 0 < len(spec_bursts) < 16


def test_batched_spec_int8_kv(toy):
    outs = {}
    for name, be in _engines(toy, 2, int8_kv=True).items():
        slot, first = be.add(REPETITIVE, max_new_tokens=20,
                             temperature=0.0, repetition_penalty=1.0)
        outs[name] = _drain(be, slot, first)
    assert outs["spec"] == outs["jax"] == outs["plain"]


def test_spec_adapt_burst_trajectory_matches_jax(toy):
    """tests/test_serve.py's controller sequence on both engines: k
    doubles on a fully accepted round, drops to the best run's pow2
    bucket, zero-acceptance slots park with doubling backoff (cap 8),
    reset on any acceptance."""
    engines = _engines(toy, 3, spec_k=8)
    be, jbe = engines["spec"], engines["jax"]

    def outs(*per_slot):          # one burst step, n_out = acc + 1
        return np.asarray([[a + 1 for a in per_slot]])

    calls = [([0, 1, 2], (1, 0, 0), 1), ([0], (2, 0, 0), 2),
             ([0], (3, 0, 0), 4), ([0], (0, 0, 0), 2)] + \
        [([0], (0, 0, 0), 1)] * 5 + [([0], (1, 0, 0), 1)]
    for unparked, acc, k in calls:
        for e in (be, jbe):
            e._spec_adapt_burst(unparked, outs(*acc), k=k)
        assert be._spec_k_cur == jbe._spec_k_cur
        assert be._spec_park.tolist() == jbe._spec_park.tolist()
        assert be._spec_park_len.tolist() == jbe._spec_park_len.tolist()
    assert be._spec_park_len[0] == 1 and be._spec_park_len[1] == 2


def test_parked_slots_match_plain(toy):
    """A slot parked hard emits the plain stream, and a fresh add() resets
    the slot's park."""
    engines = _engines(toy, 2)
    be = engines["spec"]
    slot, first = be.add(RANDOMISH, max_new_tokens=12, temperature=0.0,
                         repetition_penalty=1.0)
    be._spec_park[slot] = 10 ** 6
    toks = [first]
    while be.slots[slot].active:
        toks.extend(be.step().get(slot, []))
    be.release(slot)
    plain = engines["plain"]
    pslot, pfirst = plain.add(RANDOMISH, max_new_tokens=12, temperature=0.0,
                              repetition_penalty=1.0)
    assert toks == _drain(plain, pslot, pfirst, n_bursts=12, burst=1)
    assert len(toks) == 12
    slot2, _ = be.add([1, 2], max_new_tokens=2, temperature=0.0,
                      repetition_penalty=1.0)
    assert be._spec_park[slot2] == 0


def test_warmup_counts_spec_graphs_and_streams_stay(toy):
    """warmup() also prepares a spec graph per capacity, sampler kind and
    draft length (1, 2, 4 for spec_k = 4); a stream afterwards is still
    the plain one."""
    engines = _engines(toy, 2)
    be = engines["spec"]
    n = be.warmup()
    assert n == 4 + 1 * 2 * 4        # 4 prefill buckets; 1 capacity x 2 x 4
    assert {key[2] for key in be._graphs} == {0, 1, 2, 4}
    slot, first = be.add(REPETITIVE, max_new_tokens=16, temperature=0.0,
                         repetition_penalty=1.0)
    plain = engines["plain"]
    pslot, pfirst = plain.add(REPETITIVE, max_new_tokens=16,
                              temperature=0.0, repetition_penalty=1.0)
    assert _drain(be, slot, first) == _drain(plain, pslot, pfirst)


def test_out_of_vocabulary_prompt_ids(toy):
    """A prompt id past the embedding table (the tiny fixtures' trie has
    one) is clamped by the embedding and marks nothing in the penalty
    masks: the spec stream is the plain engine's, penalized too."""
    engines = _engines(toy, 2)
    outs = {}
    for name in ("plain", "spec"):
        be = engines[name]
        slot, first = be.add([5, 64, 9, 3, 5, 64, 9, 3, 5, 64],
                             max_new_tokens=16,
                             temperature=0.0, repetition_penalty=1.3)
        outs[name] = _drain(be, slot, first)
    assert outs["spec"] == outs["plain"] and len(outs["spec"]) == 16
