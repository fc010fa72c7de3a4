"""The observer (``nano_tpu_torch.observe``) against the JAX package's on
the CPU: the same f32 .bin (3 layers, width 32, vocab 64, the shape of
tests/test_observe.py), the same ``Session("abc", max_new_tokens=3)`` in
both packages, greedy.  Callback mode: the multiset of (phase, layer)
events, each event's data shape, each tap's data within 1e-4 of its
max|x|, the SAMPLE tokens.  Summary mode: the rows' mean|x| within 1e-4
relative of the callback mode's, the LOGITS rows' top-6 ids equal to the
JAX package's summary rows.  The stream with an observer equals the one
without; taps stay on the thread and context that attached them; a
sharded context refuses an observer.  Also ``build_chat_ids`` against the
JAX package's, and ``profile_trace``."""

import collections
import json
import os
import threading
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu import observe as jobs
from nano_tpu.config import ModelConfig as JConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.io import binfmt as jbin
from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import sampling as jsamp
from nano_tpu.tokenizer import bpe as jbpe
from nano_tpu.tokenizer.trie import TrieTokenizer as JTrie
from nano_tpu_torch import observe as tobs
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.ops import sampling as tsamp
from nano_tpu_torch.serve.batching import BatchedEngine
from nano_tpu_torch.tokenizer import bpe as tbpe

TINY = dict(block_size=32, vocab_size=64, n_layer=3, n_embd=32, n_head=4,
            n_kv_head=2, n_hidden=64)
TOL = 1e-4          # of max|x| (callback data), relative (summary rows)
LAYER_PHASES = (tobs.Phase.ATTN_NORM, tobs.Phase.QKV, tobs.Phase.ROPE,
                tobs.Phase.ATTENTION, tobs.Phase.ATTN_OUT,
                tobs.Phase.FFN_NORM, tobs.Phase.FFN, tobs.Phase.RESIDUAL)


def _greedy(mod):
    return mod.SamplerConfig(temperature=0.0, repetition_penalty=1.0)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The f32 .bin and the JAX package's events, stream and summary rows
    for Session("abc", 3), made once."""
    path = str(tmp_path_factory.mktemp("observe") / "m.bin")
    cfg = JConfig(**TINY)
    params = jgpt.init_params(jax.random.PRNGKey(1), cfg)
    tok = JTrie()
    tok.build([chr(ord("a") + i) for i in range(26)])
    jbin.write_model(path, jax.tree.map(np.asarray, params), cfg,
                     tok.config, quant="f32")
    out = {"path": path}
    for mode in ("callback", "fallback"):
        events = []
        ctx = jeng.LLMContext.from_bin(
            path, max_seq_len=32, dtype=jnp.float32, sampler=_greedy(jsamp),
            observation=events.append)
        saved = jobs._FORCE_FALLBACK
        jobs._FORCE_FALLBACK = mode == "fallback"
        try:
            s = jeng.Session(ctx, "abc", max_new_tokens=3)
            while s.step() is not None:
                pass
        finally:
            jobs._FORCE_FALLBACK = saved
            jobs.set_observer(None)
        out[mode] = (events, list(s.output_ids))
    return out


def _port_ctx(path, **kw):
    return teng.LLMContext.from_bin(path, max_seq_len=32,
                                    dtype=torch.float32, device="cpu",
                                    sampler=_greedy(tsamp), **kw)


def _run_port(path, summary: bool, monkeypatch, **kw):
    events = []
    monkeypatch.setattr(tobs, "_FORCE_FALLBACK", summary)
    ctx = _port_ctx(path, observation=events.append, **kw)
    s = teng.Session(ctx, "abc", max_new_tokens=3)
    while s.step() is not None:
        pass
    return events, list(s.output_ids)


def _by_key(events):
    """(phase, layer) -> the events in the order they came."""
    out = collections.defaultdict(list)
    for e in events:
        out[(int(e.phase), e.layer)].append(e)
    return out


def test_callback_events_match_jax(model, monkeypatch):
    jev, jids = model["callback"]
    tev, tids = _run_port(model["path"], False, monkeypatch)
    assert tids == jids
    jk, tk = _by_key(jev), _by_key(tev)
    assert sorted(jk) == sorted(tk)
    assert ({k: len(v) for k, v in jk.items()}
            == {k: len(v) for k, v in tk.items()})
    worst = 0.0
    for key in jk:
        for je, te in zip(jk[key], tk[key]):
            jd, td = np.asarray(je.data), te.data
            assert jd.shape == td.shape, (tobs.Phase(key[0]), jd.shape,
                                          td.shape)
            if key[0] == tobs.Phase.SAMPLE:
                np.testing.assert_array_equal(td, jd)
                continue
            scale = max(float(np.abs(jd).max()), 1e-30)
            worst = max(worst, float(np.abs(td - jd).max()) / scale)
    assert worst <= TOL, worst
    # every phase fired, layer phases at every layer, the others at -1
    layers = {(p, l) for p, l in tk}
    for ph in tobs.Phase:
        if ph in LAYER_PHASES:
            assert {l for p, l in layers if p == ph} == {0, 1, 2}
        else:
            assert {l for p, l in layers if p == ph} == {-1}
    # the SAMPLE taps carry the stream's decode tokens
    samples = [int(e.data[0]) for e in tev if e.phase == tobs.Phase.SAMPLE]
    assert samples == tids[1:]


def test_summary_rows_match_callback_and_jax(model, monkeypatch):
    cev, _ = _run_port(model["path"], False, monkeypatch)
    sev, sids = _run_port(model["path"], True, monkeypatch)
    jsev, jids = model["fallback"]
    assert sids == jids and all(e.summary for e in sev)
    ck, sk, jk = _by_key(cev), _by_key(sev), _by_key(jsev)
    assert sorted(ck) == sorted(sk) == sorted(jk)
    # the JAX package's summary mode repeats each forward's EMBEDDING row
    # once per layer (the row, made before the layer scan, is popped by
    # the scan body's collect_rows and leaves through every iteration's
    # ys); the port writes it once, as its callback mode fires it
    emb = (int(tobs.Phase.EMBEDDING), -1)
    L = TINY["n_layer"]
    assert len(jk[emb]) == L * len(sk[emb])
    for i in range(0, len(jk[emb]), L):
        assert len({e.mean_abs for e in jk[emb][i:i + L]}) == 1
    jk[emb] = jk[emb][::L]
    for key in ck:
        assert len(ck[key]) == len(sk[key]) == len(jk[key])
        for ce, se, je in zip(ck[key], sk[key], jk[key]):
            assert abs(se.mean_abs - je.mean_abs) <= TOL * je.mean_abs
            want = float(np.abs(ce.data.astype(np.float64)).mean())
            assert abs(se.mean_abs - want) <= TOL * max(want, 1e-30), key
            if key[0] == tobs.Phase.LOGITS:
                np.testing.assert_array_equal(se.top_ids, je.top_ids)
                np.testing.assert_allclose(se.top_vals, je.top_vals,
                                           rtol=1e-4, atol=1e-5)
                ids, _ = tobs.top_candidates(ce.data, 6)
                np.testing.assert_array_equal(se.top_ids, ids)
            else:
                assert se.top_ids is None and je.top_ids is None


def test_observed_stream_equals_unobserved(model, monkeypatch):
    plain = _port_ctx(model["path"])
    s = teng.Session(plain, "abc", max_new_tokens=8)
    while s.step() is not None:
        pass
    for summary in (False, True):
        events = []
        monkeypatch.setattr(tobs, "_FORCE_FALLBACK", summary)
        ctx = _port_ctx(model["path"], observation=events.append)
        o = teng.Session(ctx, "abc", max_new_tokens=8)
        while o.step() is not None:
            pass
        assert o.output_ids == s.output_ids and events


def test_observer_turns_speculation_off(model, monkeypatch):
    ctx = _port_ctx(model["path"], observation=lambda o: None, spec_k=4)
    s = teng.Session(ctx, "abc", max_new_tokens=6)
    while s.step() is not None:
        pass
    assert not s._spec and "round" not in s.steps_by


def test_taps_stay_with_their_context_and_thread(model, monkeypatch):
    """A context without an observer, generate_on_device and
    BatchedEngine fire no taps, even with an observer attached through
    set_observer; another thread's work never sees this thread's."""
    seen = []
    tobs.set_observer(seen.append)
    try:
        ctx = _port_ctx(model["path"])
        s = teng.Session(ctx, "abc", max_new_tokens=3)
        while s.step() is not None:
            pass
        teng.generate_on_device(ctx, ctx.encode("abc"), 4)
        be = BatchedEngine(ctx, n_slots=2)
        slot, _ = be.add(ctx.encode("abc"), max_new_tokens=4,
                         temperature=0.0, repetition_penalty=1.0)
        while be.slots[slot].active:
            be.step()
        be.release(slot)
    finally:
        tobs.set_observer(None)
    assert seen == []

    mine, other = [], []
    octx = _port_ctx(model["path"], observation=mine.append)
    plain = _port_ctx(model["path"])
    done = threading.Event()

    def worker():
        s = teng.Session(plain, "xyz", max_new_tokens=6)
        while s.step() is not None:
            pass
        done.set()

    tobs.set_observer(None)
    t = threading.Thread(target=worker)
    with tobs.attached(other.append):
        t.start()
        s = teng.Session(octx, "abc", max_new_tokens=6)
        while s.step() is not None:
            pass
        t.join(60)
    assert done.is_set() and mine and other == []


def test_sharded_context_refuses_an_observer(model):
    ctx = _port_ctx(model["path"], observation=lambda o: None)
    with pytest.raises(ValueError, match="tensor-parallel"):
        ctx.shard(None)
    ctx.cfg = types.SimpleNamespace(**vars(ctx.cfg), tp=object())
    with pytest.raises(ValueError, match="tensor-parallel"):
        teng.Session(ctx, "abc")


def test_top_candidates_helper():
    logits = np.array([0.0, 3.0, 1.0, 2.0])
    ids, probs = tobs.top_candidates(logits, k=2)
    assert list(ids) == [1, 3]
    assert probs[0] > probs[1] > 0
    jids, jprobs = jobs.top_candidates(logits, k=2)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(probs, jprobs)


def test_build_chat_ids_nano_matches_jax(model):
    msgs = [{"role": "system", "content": "sys"},
            {"role": "user", "content": "ab"},
            {"role": "assistant", "content": "cd"},
            {"role": "user", "content": "ef"}]
    jctx = jeng.LLMContext.from_bin(model["path"], max_seq_len=32,
                                    dtype=jnp.float32)
    tctx = _port_ctx(model["path"])
    got = tctx.build_chat_ids(msgs)
    assert got == jctx.build_chat_ids(msgs)
    assert got == tctx.encode("<|instruct_mark|>sys\nab<|response_mark|>"
                              "cd<|eos|><|instruct_mark|>ef<|response_mark|>")


@pytest.mark.parametrize("thinking", [False, True])
def test_build_chat_ids_qwen3_matches_jax(thinking):
    """The Qwen3 template over a byte-level BPE whose vocabulary holds the
    control ids (the shape of tests/test_openai_http.py's fake)."""
    vocab = [bytes([i]) for i in range(252)] + [b"ab", b"abc", b"he", b"hel"]
    scores = [0.0] * 252 + [-1.0, -2.0, -3.0, -4.0]
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello abc"},
            {"role": "assistant", "content": "he"},
            {"role": "user", "content": "abcabc"}]
    ids = []
    for mod, eng in ((jbpe, jeng), (tbpe, teng)):
        tok = mod.BpeTokenizer(vocab, scores)
        tok.vocab_size = 200000             # the control ids in range
        ns = types.SimpleNamespace(arch="qwen3", enable_thinking=thinking,
                                   tokenizer=tok)
        ids.append(eng.LLMContext.build_chat_ids(ns, msgs))
    assert ids[0] == ids[1]
    assert ids[1].count(tbpe.QWEN_IM_START) == 5


def test_profile_trace_writes_a_chrome_trace(model, tmp_path):
    ctx = _port_ctx(model["path"])
    with tobs.profile_trace(str(tmp_path / "tr"), annotate="infer"):
        teng.generate_sync(ctx, "abc", max_new_tokens=3)
    with open(tmp_path / "tr" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "infer" in names and os.path.getsize(tmp_path / "tr"
                                                / "trace.json") > 0
