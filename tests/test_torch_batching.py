"""Continuous batching of the port (``nano_tpu_torch.serve.batching``)
against the JAX package on the CPU, mirroring tests/test_serve.py's
BatchedEngine cases and tests/test_engine.py's int8-KV one: an f32 model
written by the JAX writer, loaded by both packages; every greedy stream
through the port's BatchedEngine is token-identical to the JAX engine's
solo greedy stream (and to the JAX BatchedEngine's), across a join
mid-flight, cache growth 128 -> 256 -> 512 by step_burst, the reset when
idle, slots exhausted and recycled, and an int8 KV cache."""

import threading
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.config import ModelConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.io import binfmt
from nano_tpu.models import gpt
from nano_tpu.ops import sampling as jsamp
from nano_tpu.serve.batching import BatchedEngine as JEngine
from nano_tpu.tokenizer.trie import TrieTokenizer
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.ops import sampling as tsamp
from nano_tpu_torch.serve import batching as tbatch


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    cfg = ModelConfig(block_size=64, vocab_size=64, n_layer=2, n_embd=32,
                      n_head=4, n_kv_head=2, n_hidden=64)
    params = gpt.init_params(jax.random.PRNGKey(7), cfg)
    tok = TrieTokenizer()
    tok.build([chr(ord("a") + i) for i in range(52)])
    path = str(tmp_path_factory.mktemp("batching") / "m.bin")
    binfmt.write_model(path, jax.tree.map(np.asarray, params), cfg,
                       tok.config, quant="f32")
    return path


def make_ctxs(path, max_seq_len=64, int8_kv=False):
    """(JAX context, port context) on the same file, greedy."""
    j = jeng.LLMContext.from_bin(
        path, max_seq_len=max_seq_len, dtype=jnp.float32,
        kv_cache_dtype=jnp.int8 if int8_kv else None,
        sampler=jsamp.SamplerConfig(temperature=0.0, repetition_penalty=1.0))
    t = teng.LLMContext.from_bin(
        path, max_seq_len=max_seq_len, dtype=torch.float32, device="cpu",
        kv_cache_dtype=torch.int8 if int8_kv else None,
        sampler=tsamp.SamplerConfig(temperature=0.0, repetition_penalty=1.0))
    return j, t


def solo_greedy(jctx, prompt, n):
    """The JAX engine's single stream."""
    session = jeng.Session(jctx, prompt, max_new_tokens=n)
    return [t for t in iter(session.step, None)]


def collect(be, ctx, prompt, n, **kw):
    """Run one stream to completion through a batched engine."""
    kw.setdefault("repetition_penalty", 1.0)
    slot, first = be.add(ctx.encode(prompt), max_new_tokens=n,
                         temperature=0.0, **kw)
    toks = [] if first is None else [first]
    while be.slots[slot].active:
        toks.extend(be.step().get(slot, []))
    be.release(slot)
    return toks


def test_batched_matches_single_stream(model_path):
    jctx, tctx = make_ctxs(model_path)
    be, jbe = tbatch.BatchedEngine(tctx, n_slots=4), JEngine(jctx, n_slots=4)
    for prompt in ("abcdef", "zzz", "hello"):
        want = solo_greedy(jctx, prompt, 12)
        assert collect(be, tctx, prompt, 12) == want
        assert collect(jbe, jctx, prompt, 12) == want


def test_repetition_penalty_per_slot_matches_jax(model_path):
    jctx, tctx = make_ctxs(model_path)
    be, jbe = tbatch.BatchedEngine(tctx, n_slots=2), JEngine(jctx, n_slots=2)
    for prompt in ("abcabc", "hello"):
        assert (collect(be, tctx, prompt, 16, repetition_penalty=1.3)
                == collect(jbe, jctx, prompt, 16, repetition_penalty=1.3))


def test_continuous_batching_join_midflight(model_path):
    """A stream that joins while another decodes produces exactly its solo
    greedy output: the per-slot positions are independent."""
    jctx, tctx = make_ctxs(model_path)
    be = tbatch.BatchedEngine(tctx, n_slots=4)
    s1, f1 = be.add(tctx.encode("abcdef"), max_new_tokens=10,
                    temperature=0.0, repetition_penalty=1.0)
    out1 = [f1]
    for _ in range(4):                       # advance stream 1 alone
        out1.extend(be.step().get(s1, []))
    s2, f2 = be.add(tctx.encode("qrs"), max_new_tokens=10, temperature=0.0,
                    repetition_penalty=1.0)
    assert s2 != s1
    out2 = [f2]
    while be.slots[s1].active or be.slots[s2].active:
        out = be.step()
        out1.extend(out.get(s1, []))
        out2.extend(out.get(s2, []))
    assert out1 == solo_greedy(jctx, "abcdef", 10)
    assert out2 == solo_greedy(jctx, "qrs", 10)


def test_cache_capacity_growth_and_idle_reset(model_path):
    """The cache starts at 128 rows and grows by powers of two as a stream
    advances through step_burst; tokens match solo greedy across every
    boundary, the capacity resets when the engine goes idle, and a fresh
    stream after the reset still matches."""
    jctx, tctx = make_ctxs(model_path, max_seq_len=512)
    be = tbatch.BatchedEngine(tctx, n_slots=2)
    assert be._cache_len() == 128
    prompt = "ab" * 50                     # 100 tokens + 300 new ones
    want = solo_greedy(jctx, prompt, 300)
    slot, first = be.add(tctx.encode(prompt), max_new_tokens=300,
                         temperature=0.0, repetition_penalty=1.0)
    toks = [first]
    seen_caps = {be._cache_len()}
    while be.slots[slot].active:
        toks.extend(be.step_burst(16).get(slot, []))
        seen_caps.add(be._cache_len())
    assert toks == want
    assert seen_caps == {128, 256, 512} and be._cache_len() == 512
    be.release(slot)
    assert be._cache_len() == 128
    slot2, f2 = be.add(tctx.encode("qrs"), max_new_tokens=12,
                       temperature=0.0, repetition_penalty=1.0)
    toks2 = [f2]
    while be.slots[slot2].active:
        toks2.extend(be.step_burst(4).get(slot2, []))
    be.release(slot2)
    assert toks2 == solo_greedy(jctx, "qrs", 12)


def test_burst_crossing_a_capacity_boundary(model_path):
    """A stream whose prompt already fills most of the first capacity: the
    burst that crosses 128 rows grows the cache before it runs."""
    jctx, tctx = make_ctxs(model_path, max_seq_len=256)
    be = tbatch.BatchedEngine(tctx, n_slots=2)
    slot, first = be.add(tctx.encode("xy" * 59), max_new_tokens=24,
                         temperature=0.0, repetition_penalty=1.0)
    toks = [first]
    while be.slots[slot].active:
        toks.extend(be.step_burst(8).get(slot, []))
    be.release(slot)
    assert toks == solo_greedy(jctx, "xy" * 59, 24)


def test_slots_exhaust_and_recycle(model_path):
    _, tctx = make_ctxs(model_path)
    be = tbatch.BatchedEngine(tctx, n_slots=2)
    a = be.add(tctx.encode("ab"), max_new_tokens=4, temperature=0.0,
               repetition_penalty=1.0)
    b = be.add(tctx.encode("cd"), max_new_tokens=4, temperature=0.0,
               repetition_penalty=1.0)
    assert a and b
    assert be.add(tctx.encode("ef")) is None      # full
    while be.n_active:
        res = be.step()
    assert res.ended == {0: True, 1: True}
    assert {s.finished_reason for s in be.slots} <= {"length", "stop"}
    be.release(a[0])
    be.release(b[0])
    assert be.free_slot() == 0
    assert be.add(tctx.encode("ef"), max_new_tokens=2) is not None


def test_int8_kv_cache_batched_engine_matches_jax(model_path):
    jctx, tctx = make_ctxs(model_path, int8_kv=True)
    be, jbe = tbatch.BatchedEngine(tctx, n_slots=2), JEngine(jctx, n_slots=2)
    assert be.cache.k.dtype == torch.int8 and be.cache.k_scale is not None
    got = collect(be, tctx, "abc", 16)
    assert got == collect(jbe, jctx, "abc", 16)
    assert got == solo_greedy(jctx, "abc", 16) and len(got) >= 2


def test_greedy_slot_beside_a_sampling_slot(model_path):
    """A temperature-0 slot keeps its greedy stream when another slot
    samples (the burst then runs the sampling step, whose rows at
    temperature 0 take the argmax); the sampling slot's tokens are ids."""
    jctx, tctx = make_ctxs(model_path)
    be = tbatch.BatchedEngine(tctx, n_slots=2)
    sg, fg = be.add(tctx.encode("hello"), max_new_tokens=12,
                    temperature=0.0, repetition_penalty=1.0)
    ss, fs = be.add(tctx.encode("abc"), max_new_tokens=12, temperature=0.9,
                    top_p=0.8, repetition_penalty=1.1)
    greedy, sampled = [fg], [] if fs is None else [fs]
    while be.slots[sg].active or be.slots[ss].active:
        out = be.step_burst(3)
        greedy.extend(out.get(sg, []))
        sampled.extend(out.get(ss, []))
    assert greedy == solo_greedy(jctx, "hello", 12)
    assert all(0 <= t < tctx.cfg.vocab_size for t in sampled)


def test_sample_rows_greedy_rows_and_nucleus():
    g = torch.Generator().manual_seed(0)
    logits = torch.from_numpy(
        np.random.RandomState(1).randn(3, 300).astype(np.float32))
    temp = torch.tensor([0.0, 0.8, 0.8])
    top_p = torch.tensor([0.8, 0.3, 1.0])
    assert torch.equal(
        tbatch._sample_rows(logits, temp, top_p, 0, g, greedy=True),
        logits.argmax(-1))
    probs = torch.softmax(logits[1] / 0.8, dim=-1)
    sp, order = torch.sort(probs, descending=True, stable=True)
    nucleus = set(order[(torch.cumsum(sp, -1) - sp) <= 0.3].tolist())
    for _ in range(30):
        tok = tbatch._sample_rows(logits, temp, top_p, 0, g)
        assert int(tok[0]) == int(logits[0].argmax())
        assert int(tok[1]) in nucleus
        assert 0 <= int(tok[2]) < 300


def test_warmup_then_serving(model_path):
    jctx, tctx = make_ctxs(model_path, max_seq_len=256)
    be = tbatch.BatchedEngine(tctx, n_slots=2)
    # prefill buckets 16..128 and 256, capacities 128 and 256 x greedy or
    # not
    assert be.warmup() == 5 + 2 * 2
    assert be._cache_len() == 128
    assert collect(be, tctx, "hello", 10) == solo_greedy(jctx, "hello", 10)


def test_join_from_another_thread_during_growth_bursts(model_path,
                                                      monkeypatch):
    """One thread runs bursts that grow the cache 128 -> 256 (on the card:
    each new capacity captures its graph) while another joins a stream.
    No prefill overlaps a burst's steps (the context's lock), and both
    streams give their solo greedy streams."""
    jctx, tctx = make_ctxs(model_path, max_seq_len=256)
    be = tbatch.BatchedEngine(tctx, n_slots=2)
    busy = {"step": False, "prefill": False}
    overlaps, first_step = [], threading.Event()
    eager, prefill = teng.DecodeGraph._eager, teng._prefill

    def slow(what, other, fn):
        def run(*a, **k):
            overlaps.append(busy[other])
            busy[what] = True
            time.sleep(0.01)
            try:
                return fn(*a, **k)
            finally:
                busy[what] = False
                if what == "step":
                    first_step.set()
        return run

    monkeypatch.setattr(teng.DecodeGraph, "_eager",
                        slow("step", "prefill", eager))
    monkeypatch.setattr(teng, "_prefill", slow("prefill", "step", prefill))
    pa, pb = "xy" * 62, "qrs"            # the first burst grows the cache
    sa, fa = be.add(tctx.encode(pa), max_new_tokens=40, temperature=0.0,
                    repetition_penalty=1.0)
    outs, caps, errors = {sa: [fa]}, set(), []

    def serve():
        try:
            while be.n_active:
                for s, toks in be.step_burst(4).items():
                    outs.setdefault(s, []).extend(toks)
                caps.add(be._cache_len())
                time.sleep(0.005)           # let the joining client in
        except BaseException as e:          # re-raised below
            errors.append(e)
            first_step.set()

    server = threading.Thread(target=serve)
    server.start()
    first_step.wait(30)
    sb, fb = be.add(tctx.encode(pb), max_new_tokens=12, temperature=0.0,
                    repetition_penalty=1.0)
    outs.setdefault(sb, []).insert(0, fb)
    server.join(60)
    assert not server.is_alive() and not errors
    assert caps == {256} and not any(overlaps)
    assert outs[sa] == solo_greedy(jctx, pa, 40)
    assert outs[sb] == solo_greedy(jctx, pb, 12)


def test_spec_and_adapters_raise_not_ported(model_path, tmp_path):
    """What the engine still refuses of adapters (serving them is
    test_torch_lora.py's): a missing file, an adapter it was not given,
    and named adapters beside a base-attached one."""
    _, tctx = make_ctxs(model_path)
    with pytest.raises(FileNotFoundError):
        tbatch.BatchedEngine(tctx, n_slots=2,
                             adapters={"a": str(tmp_path / "x.bin")})
    be = tbatch.BatchedEngine(tctx, n_slots=2)
    with pytest.raises(ValueError, match="unknown adapter"):
        be.add(tctx.encode("ab"), adapter="a")
    assert be.free_slot() == 0                     # nothing claimed
    tctx.lora = {}
    with pytest.raises(ValueError, match="not both"):
        tbatch.BatchedEngine(tctx, n_slots=2, adapters={"a": "x.bin"})
