"""Speculative greedy decode of the port, single stream
(``nano_tpu_torch.infer.speculative``, ``engine.Session`` and
``engine.generate_on_device`` with ``spec_k`` > 0), against the JAX
package on the CPU: the draft, the penalty masks, ``forward_spec_batched``
over f32 / bf16 / int8 caches, one verify round, and the streams, the
round counts and the draft-length controller's trajectory on the toy model
of tests/test_spec_decode.py, on the committed tiny_q80.bin / tiny_q4k.bin
and with an int8 KV cache.  Every spec stream here is token-identical to
the port's plain stream and to the JAX package's spec stream."""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.config import ModelConfig as JConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.infer import speculative as jspec
from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import sampling as jsamp
from nano_tpu.tokenizer.trie import TrieTokenizer as JTrie
from nano_tpu_torch.config import ModelConfig as TConfig
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.infer import speculative as tspec
from nano_tpu_torch.io.from_jax import params_from_jax
from nano_tpu_torch.models import gpt as tgpt
from nano_tpu_torch.ops import sampling as tsamp
from nano_tpu_torch.tokenizer.trie import TrieTokenizer as TTrie
from tests.test_torch_decode_device import _caches, _tensors, models  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "js", "fixtures")
# tests/test_spec_decode.py's toy model, prompts and tokenizer
TOY = dict(block_size=128, vocab_size=64, n_layer=2, n_embd=32, n_head=4,
           n_kv_head=2, n_hidden=64)
REPETITIVE = [5, 9, 3, 5, 9, 3, 5, 9, 3, 5, 9, 3, 5, 9]
RANDOMISH = [7, 1, 30, 12, 4, 44, 2, 19]
LETTERS = [chr(ord("a") + i) for i in range(52)]


@pytest.fixture(scope="module")
def toy():
    jcfg, tcfg = JConfig(**TOY), TConfig(**TOY)
    tree = jax.tree.map(np.asarray,
                        jgpt.init_params(jax.random.PRNGKey(11), jcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), \
        params_from_jax(tree, device="cpu")


def _ctxs(toy, spec_k=0, penalty=1.0, temperature=0.0, int8_kv=False):
    """(JAX context, port context) on the toy model, greedy by default."""
    jcfg, tcfg, jp, tp = toy
    sampler = dict(temperature=temperature, repetition_penalty=penalty)
    if temperature > 0.0:
        sampler["top_p"] = 0.9
    jtok, ttok = JTrie(), TTrie()
    jtok.build(LETTERS)
    ttok.build(LETTERS)
    jctx = jeng.LLMContext(cfg=jcfg, params=jp, tokenizer=jtok,
                           max_seq_len=128, dtype=jnp.float32,
                           kv_cache_dtype=jnp.int8 if int8_kv else None,
                           sampler=jsamp.SamplerConfig(**sampler),
                           spec_k=spec_k)
    tctx = teng.LLMContext(cfg=tcfg, params=tp, tokenizer=ttok,
                           max_seq_len=128, device="cpu",
                           dtype=torch.float32,
                           kv_cache_dtype=torch.int8 if int8_kv else None,
                           sampler=tsamp.SamplerConfig(**sampler),
                           spec_k=spec_k)
    return jctx, tctx


# ---------------------------------------------------------------------
# the draft and the masks
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_ngram_draft_matches_jax(seed):
    """Histories over a 4-token alphabet (n-grams recur), every position
    from the first ones (no valid match) to the last (the slice clipped),
    k = 1, 3, 7; one history and the batched form with a position a row."""
    rng = np.random.RandomState(seed)
    T = 48
    hist = rng.randint(0, 4, (3, T)).astype(np.int32)
    for k in (1, 3, 7):
        for pos in (0, 1, 2, 3, 10, 30, T - 1):
            want = jspec.ngram_draft(jnp.asarray(hist[0]), jnp.int32(pos), k)
            got = tspec.ngram_draft(torch.from_numpy(hist[0]).long(),
                                    torch.tensor(pos), k)
            assert got.tolist() == np.asarray(want).tolist(), (k, pos)
        pos = rng.randint(0, T, 3).astype(np.int32)
        want = jspec.batched_ngram_draft(jnp.asarray(hist), jnp.asarray(pos),
                                         k)
        got = tspec.batched_ngram_draft(torch.from_numpy(hist).long(),
                                        torch.from_numpy(pos), k)
        assert got.tolist() == np.asarray(want).tolist(), k


def test_ngram_draft_finds_latest_continuation():
    hist = torch.tensor([0, 5, 9, 3, 5, 9, 7, 2, 5, 9, 0, 0])
    assert tspec.ngram_draft(hist, torch.tensor(9), 3).tolist() == [7, 2, 5]


@pytest.mark.parametrize("seed", range(3))
def test_prefix_masks_match_jax(seed):
    """Drafts with repeated tokens, tokens already seen, and ids outside
    the vocabulary (-1, V), which mark nothing."""
    rng = np.random.RandomState(seed)
    B, k, V = 3, 5, 12
    draft = rng.randint(-1, V + 1, (B, k)).astype(np.int32)
    seen = rng.rand(B, V) < 0.3
    want = jax.vmap(jspec.prefix_masks)(jnp.asarray(draft), jnp.asarray(seen))
    got = tspec.prefix_masks(torch.from_numpy(draft).long(),
                             torch.from_numpy(seen))
    assert got.shape == (B, k + 1, V)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------
# forward_spec_batched
# ---------------------------------------------------------------------

@pytest.mark.parametrize("attn_len", [None, 24])
@pytest.mark.parametrize("name", ["qwen3_q80", "nano_f32"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_forward_spec_batched_matches_jax(models, name, kind, attn_len):
    """B = 3 rows of S = 4 tokens at positions that differ (the first row,
    the middle, the end of the attended rows): logits within 1e-4 of the
    logit range (f32 both sides, the same int8 decisions, float sums in
    another order), the same argmax, every new cache row written where JAX
    writes it and nowhere else."""
    jcfg, tcfg, jp, tp = models[name]
    B, S, T = 3, 4, 32
    jc, tc = _caches(jcfg, tcfg, B, T, kind, seed=len(name) * len(kind))
    pos = np.array([0, 13, (attn_len or T) - S], np.int32)
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc2 = jgpt.forward_spec_batched(
        jp, jnp.asarray(toks), jc, jnp.asarray(pos), jcfg,
        dtype=jnp.float32, attn_len=attn_len)
    before = _tensors(tc)
    tl, tc2 = tgpt.forward_spec_batched(
        tp, torch.from_numpy(toks).long(), tc, torch.from_numpy(pos), tcfg,
        dtype=torch.float32, attn_len=attn_len)
    assert tc2 is tc and tl.shape == (B, S, jcfg.vocab_size)
    want = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert (tl.numpy().argmax(-1) == want.argmax(-1)).all()
    for i, (old, got, exp) in enumerate(zip(before, _tensors(tc),
                                            _tensors(jc2))):
        written = np.zeros(old.shape[:3], bool)
        for b in range(B):
            written[:, b, pos[b]:pos[b] + S] = True
        np.testing.assert_array_equal(got[~written], old[~written])
        tol = 0 if kind == "int8" and i < 2 else 1e-5 * np.abs(exp).max()
        np.testing.assert_allclose(got[written], exp[written], rtol=0,
                                   atol=tol)


# ---------------------------------------------------------------------
# a verify round
# ---------------------------------------------------------------------

@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_verify_step_rounds_match_jax(toy, penalty):
    """Six rounds from the same prefilled state: g, n_out, the history,
    the seen mask and the cache rows each round writes equal the JAX
    round's, and some round accepts a draft."""
    jctx, tctx = _ctxs(toy, spec_k=4, penalty=penalty)
    prompt = "abcabcabcabc"
    js = jeng.Session(jctx, prompt)
    js.step()                                   # the JAX prefill
    dec = tctx.decoder()
    dec.claim()
    dec.prefill(tctx.encode(prompt))
    tok, pos = dec.tok, dec.pos
    jtok, jpos = js._cur_tok[0], js.pos
    jcache, jhist, jseen = js._cache, js._hist, js._seen[0]
    assert dec.hist[0].tolist() == np.asarray(jhist).tolist()
    outs = []
    for k in (1, 2, 4, 4, 3, 4):
        jg, jn, jcache, jhist, jseen = jspec.verify_step(
            jctx.params, None, 0.0, jtok, jnp.int32(jpos), jcache, jhist,
            jseen, jnp.float32(penalty), jctx.cfg, jnp.float32, k)
        g, n = tspec.verify_step(tctx.params, tok, pos, dec.cache, dec.hist,
                                 dec.seen, penalty, tctx.cfg, torch.float32,
                                 k)
        jn = int(jn)
        assert g.tolist() == np.asarray(jg).tolist()
        assert n.tolist() == [jn]
        assert dec.hist[0].tolist() == np.asarray(jhist).tolist()
        assert dec.seen[0].tolist() == np.asarray(jseen).tolist()
        rows = slice(jpos, jpos + k + 1)
        for got, exp in zip(_tensors(dec.cache), _tensors(jcache)):
            np.testing.assert_allclose(got[:, 0, rows], exp[:, 0, rows],
                                       rtol=0, atol=1e-5)
        tok = g[jn - 1:jn]
        pos = pos + jn
        jtok, jpos = jg[jn - 1], jpos + jn
        outs.append(jn)
    assert max(outs) > 1, outs


# ---------------------------------------------------------------------
# generate_on_device
# ---------------------------------------------------------------------

@pytest.mark.parametrize("prompt", [REPETITIVE, RANDOMISH],
                         ids=["repetitive", "random"])
@pytest.mark.parametrize("k", [3, 7])
def test_generate_on_device_spec_matches_plain_and_jax(toy, prompt, k):
    """The device loop (rounds replayed SPEC_READ_EVERY at a time, past
    the loop's end too): the port's plain stream, JAX's spec stream and
    JAX's round count; rounds < tokens on the repetitive prompt."""
    _, plain_ctx = _ctxs(toy)
    jctx, tctx = _ctxs(toy, spec_k=k)
    plain = teng.generate_on_device(plain_ctx, prompt, 40).tolist()
    spec = teng.generate_on_device(tctx, prompt, 40).tolist()
    stats = tspec.LAST_STATS
    want = jeng.generate_on_device(jctx, prompt, 40).tolist()
    assert spec == plain == want
    assert stats == jspec.LAST_STATS
    assert stats["tokens"] >= 39
    if prompt is REPETITIVE:
        assert stats["rounds"] < stats["tokens"], stats


def test_rounds_past_the_end_change_nothing_read(toy):
    """A round replayed after the loop's end leaves out[:n_out], the
    position, the token, the seen mask and every cache row at or below the
    position as they were."""
    _, tctx = _ctxs(toy, spec_k=4)
    teng.generate_on_device(tctx, REPETITIVE, 30)
    dec = tctx.decoder()
    state = [t.clone() for t in (dec.out, dec.n_out, dec.pos, dec.tok,
                                 dec.seen, dec.hist)]
    cache = [t.clone() for t in _tensors_t(dec.cache)]
    n, pos = int(dec.n_out[0]), int(dec.pos[0])
    assert n >= 30
    for _ in range(3):
        dec._round_graph(4, None).run()
    assert torch.equal(dec.out[:n], state[0][:n])
    for got, old in zip((dec.n_out, dec.pos, dec.tok, dec.seen, dec.hist),
                        state[1:]):
        assert torch.equal(got, old)
    for got, old in zip(_tensors_t(dec.cache), cache):
        assert torch.equal(got[:, :, :pos + 1], old[:, :, :pos + 1])


def _tensors_t(c):
    return [t for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_int8_and_bf16_kv_spec_matches_plain_and_jax(toy, kv):
    int8 = kv == "int8"
    _, plain_ctx = _ctxs(toy, int8_kv=int8)
    jctx, tctx = _ctxs(toy, spec_k=7, int8_kv=int8)
    if not int8:
        plain_ctx.kv_cache_dtype = tctx.kv_cache_dtype = torch.bfloat16
        jctx = dataclasses.replace(jctx, kv_cache_dtype=jnp.bfloat16)
    plain = teng.generate_on_device(plain_ctx, REPETITIVE, 32).tolist()
    spec = teng.generate_on_device(tctx, REPETITIVE, 32).tolist()
    assert spec == plain == jeng.generate_on_device(
        jctx, REPETITIVE, 32).tolist()


# ---------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------

def _run(session):
    """Step a session to its end -> (tokens, per-step (k, park, pending))."""
    toks, traj = [], []
    while (t := session.step()) is not None:
        toks.append(t)
        traj.append((session._spec_k_cur, session._spec_park,
                     len(session._pending)))
    return toks, traj


@pytest.mark.parametrize("prompt", ["abcabcabcabc", "ab", "qzmxnw"])
def test_session_trajectory_matches_jax(toy, prompt):
    """The stream and the controller's k, park and pending tokens after
    every step equal the JAX Session's, and the stream equals plain."""
    jctx, tctx = _ctxs(toy, spec_k=8)
    got, traj = _run(teng.Session(tctx, prompt, max_new_tokens=60))
    want, jtraj = _run(jeng.Session(jctx, prompt, max_new_tokens=60))
    assert got == want and traj == jtraj
    assert max(k for k, _, _ in traj) > 1
    assert all(k <= 8 and k & (k - 1) == 0 for k, _, _ in traj)
    _, plain_ctx = _ctxs(toy)
    assert got == teng.generate_sync(plain_ctx, prompt,
                                     max_new_tokens=60).output_ids


def test_spec_adapt_controller_matches_jax(toy):
    """The same sequence of round outcomes moves both controllers alike:
    doubling, the pow2 bucket of a partial miss, the park, its backoff and
    cap, the reset on acceptance, the cap of spec_k."""
    jctx, tctx = _ctxs(toy, spec_k=8)
    ts, js = teng.Session(tctx, "ab"), jeng.Session(jctx, "ab")
    outcomes = [(1, 1), (2, 2), (4, 3), (2, 0), (1, 0)] + [(1, 0)] * 9 + \
        [(1, 1), (2, 2), (4, 4), (8, 8), (8, 5)]
    for k, n_acc in outcomes:
        ts._spec_adapt(k, n_acc)
        js._spec_adapt(k, n_acc)
        assert ((ts._spec_k_cur, ts._spec_park, ts._spec_park_len)
                == (js._spec_k_cur, js._spec_park, js._spec_park_len))
    assert teng.Session._SPEC_PARK_MAX == jeng.Session._SPEC_PARK_MAX


def test_session_park_takes_plain_steps_then_reprobes(toy, monkeypatch):
    """Parked, the session emits through plain steps (no round), then
    re-probes; the rounds, the trajectory and the stream equal JAX's."""
    jctx, tctx = _ctxs(toy, spec_k=8)
    ts, js = teng.Session(tctx, "ab", max_new_tokens=60), \
        jeng.Session(jctx, "ab", max_new_tokens=60)
    assert ts.step() == js.step()
    for s in (ts, js):
        for _ in range(4):
            s._spec_adapt(k=1, n_acc=0)
    park0 = ts._spec_park
    assert park0 == js._spec_park > 0
    calls = {"t": 0, "j": 0}
    round_t, round_j = teng.SingleDecoder.spec_round, jspec.verify_step

    def count_t(*a, **kw):
        calls["t"] += 1
        return round_t(*a, **kw)

    def count_j(*a, **kw):
        calls["j"] += 1
        return round_j(*a, **kw)

    monkeypatch.setattr(teng.SingleDecoder, "spec_round", count_t)
    monkeypatch.setattr(jspec, "verify_step", count_j)
    for _ in range(park0):
        assert ts.step() == js.step()
    assert calls == {"t": 0, "j": 0}
    got, traj = _run(ts)
    want, jtraj = _run(js)
    assert got == want and traj == jtraj
    assert calls["t"] == calls["j"] >= 1
    _, plain_ctx = _ctxs(toy)
    assert ts.output_ids == teng.generate_sync(
        plain_ctx, "ab", max_new_tokens=60).output_ids


def test_session_respects_max_new_tokens(toy):
    jctx, tctx = _ctxs(toy, spec_k=7)
    s = teng.generate_sync(tctx, "abcabc", max_new_tokens=5)
    assert len(s.output_ids) == 5
    assert s.output_ids == jeng.generate_sync(jctx, "abcabc",
                                              max_new_tokens=5).output_ids


def test_spec_off_under_sampling(toy):
    """A stochastic sampler takes the plain path: no spec state, the same
    draws as a context without spec_k."""
    _, tctx = _ctxs(toy, spec_k=7, penalty=1.1, temperature=0.8)
    _, plain_ctx = _ctxs(toy, penalty=1.1, temperature=0.8)
    s = teng.Session(tctx, "abc", max_new_tokens=12)
    assert not s._spec
    got = [t for t in iter(s.step, None)]
    assert got == teng.generate_sync(plain_ctx, "abc",
                                     max_new_tokens=12).output_ids
    assert (teng.generate_on_device(tctx, [1, 2, 3], 12).tolist()
            == teng.generate_on_device(plain_ctx, [1, 2, 3], 12).tolist())


def test_interleaved_spec_sessions_keep_their_own_streams(toy):
    """Two spec sessions stepped in turn, with a spec generate_on_device
    between their steps, each give their solo stream: the history and the
    round state are saved and restored with the rest of the decoder."""
    _, tctx = _ctxs(toy, spec_k=4)
    pa, pb = "abcabcabcabc", "qzmxnwqzmx"
    want_a = teng.generate_sync(tctx, pa, max_new_tokens=40).output_ids
    want_b = teng.generate_sync(tctx, pb, max_new_tokens=40).output_ids
    sa = teng.Session(tctx, pa, max_new_tokens=40)
    sb = teng.Session(tctx, pb, max_new_tokens=40)
    for i in range(40):
        sa.step()
        if i == 5:
            teng.generate_on_device(tctx, REPETITIVE, 30)
        sb.step()
    assert sa.output_ids == want_a and sb.output_ids == want_b
    assert sa._dec is sb._dec is tctx.decoder()


def test_penalized_greedy_matches_plain_and_jax(toy):
    """Repetition penalty 1.3: the per-row prefix masks give sequential
    penalized greedy, through Session and generate_on_device."""
    jctx, tctx = _ctxs(toy, spec_k=7, penalty=1.3)
    _, plain_ctx = _ctxs(toy, penalty=1.3)
    plain = teng.generate_sync(plain_ctx, "abcabcabcabc", max_new_tokens=30)
    spec = teng.generate_sync(tctx, "abcabcabcabc", max_new_tokens=30)
    assert spec.output_ids == plain.output_ids == jeng.generate_sync(
        jctx, "abcabcabcabc", max_new_tokens=30).output_ids
    assert (teng.generate_on_device(tctx, REPETITIVE, 40).tolist()
            == teng.generate_on_device(plain_ctx, REPETITIVE, 40).tolist()
            == jeng.generate_on_device(jctx, REPETITIVE, 40).tolist())


# ---------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------

@pytest.fixture
def jax_f32_op_by_op(monkeypatch):
    """The JAX Q4K side op by op with f32 dequant dots, as
    tests/test_torch_q4k_slice.py runs it."""
    monkeypatch.setenv("NANO_TPU_DEQUANT", "f32")
    jax.clear_caches()
    with jax.disable_jit():
        yield
    monkeypatch.delenv("NANO_TPU_DEQUANT")
    jax.clear_caches()


def _fixture_ctxs(name, spec_k):
    path = os.path.join(FIX, name)
    greedy = dict(temperature=0.0, repetition_penalty=1.0)
    jctx = jeng.LLMContext.from_bin(
        path, max_seq_len=64, dtype=jnp.float32,
        quantized=False if name == "tiny_q80.bin" else None,
        sampler=jsamp.SamplerConfig(**greedy), spec_k=spec_k)
    tctx = teng.LLMContext.from_bin(
        path, max_seq_len=64, dtype=torch.float32, device="cpu",
        sampler=tsamp.SamplerConfig(**greedy), spec_k=spec_k)
    return jctx, tctx


def _fixture_streams(name):
    with open(os.path.join(FIX, "expected.json")) as f:
        expected = json.load(f)
    jctx, tctx = _fixture_ctxs(name, spec_k=7)
    _, plain_ctx = _fixture_ctxs(name, spec_k=0)
    s = teng.generate_sync(tctx, expected["prompt"], max_new_tokens=16)
    assert s.output_ids == expected["greedy"][name[5:-4]]
    ids = [3, 9, 14, 20, 7, 1]
    spec = teng.generate_on_device(tctx, ids, 12).tolist()
    assert spec == teng.generate_on_device(plain_ctx, ids, 12).tolist()
    assert spec == jeng.generate_on_device(jctx, ids, 12).tolist()


def test_tiny_q80_spec_streams():
    _fixture_streams("tiny_q80.bin")


def test_tiny_q4k_spec_streams(jax_f32_op_by_op):
    _fixture_streams("tiny_q4k.bin")
