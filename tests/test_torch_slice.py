"""The port's main path against the JAX package on the CPU: Q80 prefill
with last_idx, single-token decode steps, greedy generation, on a random
group-size-256 model of the Qwen3 architecture (qk-norm, half RoPE, tied
head; the tiny shape of tools/bench_stages.py) and on the committed tiny
fixtures.  Weights cross over through params_from_jax."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.config import ModelConfig as JConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import sampling as jsamp
from nano_tpu.ops.qmatmul import Q80Tensor as JQ80
from nano_tpu_torch.config import ModelConfig as TConfig
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.io.from_jax import params_from_jax
from nano_tpu_torch.models import gpt as tgpt
from nano_tpu_torch.ops import sampling as tsamp
from nano_tpu_torch.ops.qmatmul import Q80Tensor as TQ80

FIX = os.path.join(os.path.dirname(__file__), "js", "fixtures")

# tools/bench_stages.py's NANO_BENCH_TINY Qwen3 shape
QWEN3_TINY = dict(block_size=256, vocab_size=512, n_layer=2, n_embd=256,
                  n_head=2, n_kv_head=1, n_hidden=512, head_dim=128,
                  use_qk_norm=True, rope_style="half", rope_theta=1e6,
                  norm_eps=1e-6, tie_embeddings=True)
GS = 256


def _random_q80_params(cfg, seed=0):
    """The loader's device layout (grouped int8 weights, grouped output_q
    off the embedding), as tools/bench_stages.py:q80_params builds it,
    with numpy leaves."""
    rng = np.random.RandomState(seed)

    def qt(*shape, inn):
        q = rng.randint(-127, 128, shape).astype(np.int8)
        s = (rng.rand(*shape[:-1], inn // GS).astype(np.float32) * 0.02
             + 1e-3)
        return JQ80(q=q, scales=s, group_size=GS)

    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_hidden, cfg.vocab_size
    HD, KVD = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim
    D = cfg.head_dim
    norm = lambda *s: (1.0 + 0.1 * rng.randn(*s)).astype(np.float32)
    blocks = {"attn_norm": norm(L, E), "ffn_norm": norm(L, E),
              "q_norm": norm(L, D), "k_norm": norm(L, D)}
    for name, out, inn in (("wqkv", HD + 2 * KVD, E), ("wo", E, HD),
                           ("w13", 2 * F, E), ("w2", E, F)):
        t = qt(L, out, inn, inn=inn)
        blocks[name] = jax.tree.map(np.asarray, t.to_grouped())
    tok = qt(V, E, inn=E)
    return {"tok_embeddings": tok,
            "output_q": jax.tree.map(np.asarray, tok.to_grouped()),
            "norm": norm(E), "blocks": blocks}


def _jax_params(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def qwen_tiny():
    jcfg, tcfg = JConfig(**QWEN3_TINY), TConfig(**QWEN3_TINY)
    tree = _random_q80_params(jcfg)
    return jcfg, tcfg, _jax_params(tree), params_from_jax(tree, device="cpu")


def test_params_from_jax_round_trips(qwen_tiny):
    jcfg, _, jp, tp = qwen_tiny
    for name, w in jp["blocks"].items():
        t = tp["blocks"][name]
        if isinstance(w, JQ80):
            assert isinstance(t, TQ80) and t.w8a8 and w.layout == "grouped"
            # rows -> grouped again gives the JAX arrays back exactly
            L, out, inn = t.q.shape
            back = t.q.numpy().reshape(L, out, inn // GS, GS).transpose(
                0, 2, 1, 3)
            np.testing.assert_array_equal(back, np.asarray(w.q))
            np.testing.assert_array_equal(t.scales.numpy(),
                                          np.asarray(w.scales))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    tok = tp["tok_embeddings"]
    np.testing.assert_array_equal(tok.q.numpy(), np.asarray(
        jp["tok_embeddings"].q))
    # the grouped head holds the embedding's values: one shared table
    assert tp["output_q"] is tok and tok.w8a8


def test_prefill_and_decode_logits_match_jax(qwen_tiny):
    jcfg, tcfg, jp, tp = qwen_tiny
    prompt = [5, 17, 300, 42, 99, 7, 256, 1, 64, 128, 3]
    n, pad, T = len(prompt), 16, 32
    ids = np.zeros((1, pad), np.int64)
    ids[0, :n] = prompt
    jcache = jgpt.KVCache.create(jcfg, 1, T, jnp.float32)
    tcache = tgpt.KVCache.create(tcfg, 1, T, torch.float32)
    jl, jcache = jgpt.forward_with_cache(
        jp, jnp.asarray(ids, jnp.int32), jcache, jnp.int32(0), jcfg,
        dtype=jnp.float32, attn_len=pad, last_idx=jnp.int32(n - 1))
    tl, _ = tgpt.forward_with_cache(
        tp, torch.from_numpy(ids), tcache, 0, tcfg, dtype=torch.float32,
        attn_len=pad, last_idx=n - 1)
    steps = [(np.asarray(jl)[:, 0], tl[:, 0].numpy())]
    tok = int(np.argmax(steps[0][0]))
    for i in range(8):
        pos = n + i
        jl, jcache = jgpt.forward_with_cache(
            jp, jnp.asarray([[tok]], jnp.int32), jcache, jnp.int32(pos), jcfg,
            dtype=jnp.float32)
        tl, _ = tgpt.forward_with_cache(
            tp, torch.tensor([[tok]]), tcache, pos, tcfg, dtype=torch.float32)
        steps.append((np.asarray(jl)[:, 0], tl[:, 0].numpy()))
        tok = int(np.argmax(steps[-1][0]))
    for want, got in steps:
        assert got.shape == want.shape == (1, jcfg.vocab_size)
        # f32 both sides with identical int8 decisions; the float sums run
        # in another order (W8A8 combine, attention, norms) -> 1e-4 of the
        # logit range
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        assert np.argmax(got) == np.argmax(want)


@pytest.mark.parametrize("penalty", [1.0, 1.1])
def test_greedy_generate_on_device_matches_jax_random_q80(qwen_tiny, penalty):
    jcfg, tcfg, jp, tp = qwen_tiny
    sampler = dict(temperature=0.0, repetition_penalty=penalty)
    jctx = jeng.LLMContext(cfg=jcfg, params=jp, tokenizer=None,
                           max_seq_len=128, dtype=jnp.float32,
                           sampler=jsamp.SamplerConfig(**sampler))
    tctx = teng.LLMContext(cfg=tcfg, params=tp, tokenizer=None,
                           max_seq_len=128, device=torch.device("cpu"),
                           dtype=torch.float32,
                           sampler=tsamp.SamplerConfig(**sampler))
    prompt = [11, 22, 33, 44, 55, 66, 77]
    want = jeng.generate_on_device(jctx, prompt, 24).tolist()
    got = teng.generate_on_device(tctx, prompt, 24).tolist()
    assert got == want
    # the Session path emits the same stream one step() at a time
    s = teng.Session(tctx, "", max_new_tokens=24, prompt_ids=prompt)
    stream = [t for t in iter(s.step, None)]
    assert stream == want[:len(stream)] and len(stream) >= 1


@pytest.mark.parametrize("name", ["tiny_f32.bin", "tiny_q80.bin"])
def test_greedy_matches_jax_on_fixtures(name):
    path = os.path.join(FIX, name)
    sampler = dict(temperature=0.0, repetition_penalty=1.0)
    # JAX: the f32-dequant oracle (quantized=False); the port keeps Q80
    # weights quantized and runs the rows form (f32 dequant, f32 dot)
    jctx = jeng.LLMContext.from_bin(path, max_seq_len=64, dtype=jnp.float32,
                                    quantized=False,
                                    sampler=jsamp.SamplerConfig(**sampler))
    tctx = teng.LLMContext.from_bin(path, max_seq_len=64,
                                    dtype=torch.float32, device="cpu",
                                    sampler=tsamp.SamplerConfig(**sampler))
    if name == "tiny_q80.bin":
        assert isinstance(tctx.params["tok_embeddings"], TQ80)
    ids = tctx.encode("helloworldabc")
    assert ids == jctx.encode("helloworldabc")
    want = jeng.generate_on_device(jctx, ids, 20).tolist()
    assert teng.generate_on_device(tctx, ids, 20).tolist() == want
    # and the committed golden stream through Session / generate_sync
    with open(os.path.join(FIX, "expected.json")) as f:
        expected = json.load(f)
    s = teng.generate_sync(tctx, expected["prompt"], max_new_tokens=16)
    assert s.output_ids == expected["greedy"][name[5:-4]]


@pytest.mark.parametrize("name", ["tiny_f32.bin", "tiny_q80.bin"])
@pytest.mark.parametrize("penalty", [1.0, 1.1])
def test_out_of_vocabulary_ids_clamp_like_jax(name, penalty):
    """The fixtures' trie tokenizer has 65 entries for a 64-row table, so
    " " encodes to id 64: the embedding gather clamps it to the last row,
    as the JAX gather does, and the repetition penalty ignores it."""
    path = os.path.join(FIX, name)
    sampler = dict(temperature=0.0, repetition_penalty=penalty)
    jctx = jeng.LLMContext.from_bin(path, max_seq_len=64, dtype=jnp.float32,
                                    quantized=False,
                                    sampler=jsamp.SamplerConfig(**sampler))
    tctx = teng.LLMContext.from_bin(path, max_seq_len=64,
                                    dtype=torch.float32, device="cpu",
                                    sampler=tsamp.SamplerConfig(**sampler))
    ids = tctx.encode("hello world abc")
    assert ids == jctx.encode("hello world abc")
    assert max(ids) >= tctx.cfg.vocab_size
    want = jeng.generate_on_device(jctx, ids, 16).tolist()
    assert teng.generate_on_device(tctx, ids, 16).tolist() == want


def test_int8_kv_cache_decode_matches_jax(qwen_tiny):
    jcfg, tcfg, jp, tp = qwen_tiny
    sampler = dict(temperature=0.0, repetition_penalty=1.0)
    jctx = jeng.LLMContext(cfg=jcfg, params=jp, tokenizer=None,
                           max_seq_len=64, dtype=jnp.float32,
                           kv_cache_dtype=jnp.int8,
                           sampler=jsamp.SamplerConfig(**sampler))
    tctx = teng.LLMContext(cfg=tcfg, params=tp, tokenizer=None,
                           max_seq_len=64, device=torch.device("cpu"),
                           dtype=torch.float32, kv_cache_dtype=torch.int8,
                           sampler=tsamp.SamplerConfig(**sampler))
    prompt = [9, 8, 7, 6, 5]
    assert (teng.generate_on_device(tctx, prompt, 12).tolist()
            == jeng.generate_on_device(jctx, prompt, 12).tolist())


def test_stream_decoder_matches_jax_on_split_utf8():
    from nano_tpu.tokenizer.bpe import BpeTokenizer as JBpe
    from nano_tpu_torch.tokenizer.bpe import BpeTokenizer as TBpe
    text = "aé€😀b"
    raw = text.encode("utf-8")
    vocab = [bytes([b]) for b in range(256)] + [raw[1:3]]
    scores = [0.0] * len(vocab)
    ids = list(raw)            # one byte per token: characters split
    jd = jeng.StreamDecoder(JBpe(vocab, scores))
    td = teng.StreamDecoder(TBpe(vocab, scores))
    got = [td.feed(i) for i in ids] + [td.flush()]
    assert got == [jd.feed(i) for i in ids] + [jd.flush()]
    assert "".join(got) == text
    assert TBpe(vocab, scores).encode(text) == JBpe(vocab, scores).encode(text)
