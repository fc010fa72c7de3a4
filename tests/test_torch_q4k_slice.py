"""The port's Q4K serving path against the JAX package on the CPU: the
.bin reader, the quantized loader (packed Q4K weights, fused wqkv / w13,
the tied head requantized to Q80), params_from_jax, prefill with last_idx
plus decode steps, and greedy generation, on the committed tiny_q4k.bin
and on a random Qwen3-tiny Q4K file (width 256: the aligned fake-quant
path and a W8A8 group-size-256 head).

The JAX side runs with NANO_TPU_DEQUANT=f32 (read while tracing, hence
jax.clear_caches()), so both sides do f32 dequant dots: the JAX default
is a bf16 dequant dot, the port's K3 is f32.  It also runs op by op
(jax.disable_jit()): compiled as one program, XLA's CPU backend folds the
lean fake-quant's rounding (x + 1.5*2^23) - 1.5*2^23 to x, turns the
divisions by 15 and 63 into multiplies by reciprocals and contracts
v * s - b into an FMA, so the jitted JAX functions do not compute the C
engine's Q4K activation quantization; executed op by op they do, bit for
bit (tests/test_torch_q4k.py)."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.config import ModelConfig as JConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.io import binfmt as jbin
from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import sampling as jsamp
from nano_tpu.ops.q4k import Q4KTensor as JQ4K
from nano_tpu.tokenizer.bpe import BpeTokenizer as JBpe
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.io import binfmt as tbin
from nano_tpu_torch.io.from_jax import params_from_jax
from nano_tpu_torch.models import gpt as tgpt
from nano_tpu_torch.ops import sampling as tsamp
from nano_tpu_torch.ops.q4k import Q4KTensor as TQ4K
from nano_tpu_torch.ops.qmatmul import Q80Tensor as TQ80

FIX = os.path.join(os.path.dirname(__file__), "js", "fixtures")
TINY = os.path.join(FIX, "tiny_q4k.bin")

# tests/test_torch_slice.py's Qwen3-tiny shape
QWEN3_TINY = dict(block_size=256, vocab_size=512, n_layer=2, n_embd=256,
                  n_head=2, n_kv_head=1, n_hidden=512, head_dim=128,
                  use_qk_norm=True, rope_style="half", rope_theta=1e6,
                  norm_eps=1e-6, tie_embeddings=True)
SAMPLER = dict(temperature=0.0, repetition_penalty=1.0)


@pytest.fixture(autouse=True)
def jax_f32_op_by_op(monkeypatch):
    monkeypatch.setenv("NANO_TPU_DEQUANT", "f32")
    jax.clear_caches()
    with jax.disable_jit():
        yield
    monkeypatch.delenv("NANO_TPU_DEQUANT")
    jax.clear_caches()


@pytest.fixture(scope="module")
def qwen_q4k(tmp_path_factory):
    """A random Qwen3-tiny model written as a Q4K .bin by the JAX writer:
    matrices ~ N(0, 1/in) so activations stay O(1), a 512-entry byte-level
    BPE vocabulary."""
    cfg = JConfig(**QWEN3_TINY)
    rng = np.random.RandomState(4)
    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_hidden, cfg.vocab_size
    HD, KVD, D = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim, \
        cfg.head_dim

    def mat(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)

    norm = lambda *s: (1.0 + 0.1 * rng.randn(*s)).astype(np.float32)
    params = {"tok_embeddings": rng.randn(V, E).astype(np.float32),
              "norm": norm(E),
              "blocks": {"attn_norm": norm(L, E), "ffn_norm": norm(L, E),
                         "q_norm": norm(L, D), "k_norm": norm(L, D),
                         "wq": mat(L, E, HD), "wk": mat(L, E, KVD),
                         "wv": mat(L, E, KVD), "wo": mat(L, HD, E),
                         "w1": mat(L, E, F), "w2": mat(L, F, E),
                         "w3": mat(L, E, F)}}
    vocab = [bytes([i]) for i in range(256)] + [
        bytes([97 + i // 16, 97 + i % 16]) for i in range(V - 256)]
    bpe = JBpe(vocab, [0.0] * V)
    path = str(tmp_path_factory.mktemp("q4k") / "qwen3_tiny_q4k.bin")
    jbin.write_model(path, params, cfg, bpe, quant="q4k",
                     model_type=jbin.MODEL_TYPE_QWEN3)
    return path


def _contexts(path, max_seq_len=64):
    jctx = jeng.LLMContext.from_bin(path, max_seq_len=max_seq_len,
                                    dtype=jnp.float32,
                                    sampler=jsamp.SamplerConfig(**SAMPLER))
    tctx = teng.LLMContext.from_bin(path, max_seq_len=max_seq_len,
                                    dtype=torch.float32, device="cpu",
                                    sampler=tsamp.SamplerConfig(**SAMPLER))
    return jctx, tctx


def _np(x):
    return np.asarray(x)


def _assert_q4k_equal(t, j, name=""):
    assert isinstance(t, TQ4K) and isinstance(j, JQ4K), name
    assert j.layout == "packed" and t.in_dim == j.in_dim, name
    for f in ("packed", "scales", "biases"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      _np(getattr(j, f)), err_msg=name)


def _assert_q80_rows_equal(t, j):
    """A JAX Q80 head (rows, or grouped (G, out, gs) at group size >= 256)
    against the port's (out, in) rows."""
    q = _np(j.q)
    if j.layout == "grouped":
        q = np.moveaxis(q, -3, -2).reshape(q.shape[1], -1)
    assert isinstance(t, TQ80) and t.group_size == j.group_size
    assert t.w8a8 == (j.layout == "grouped")
    np.testing.assert_array_equal(t.q.numpy(), q)
    np.testing.assert_array_equal(t.scales.numpy(), _np(j.scales))


# ---------------------------------------------------------------------
# reader and loader (exact)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("which", ["tiny", "qwen3"])
@pytest.mark.parametrize("dense", [True, False])
def test_read_model_matches_jax(qwen_q4k, which, dense):
    path = TINY if which == "tiny" else qwen_q4k
    j = jbin.read_model(path, dense=dense)
    t = tbin.read_model(path, dense=dense)
    assert vars(t.header) == vars(j.header)
    assert t.config.to_dict() == j.config.to_dict()
    if which == "tiny":
        assert t.tokenizer_config == j.tokenizer_config
    else:
        assert t.tokenizer_config["tokenizer"].vocab == \
            j.tokenizer_config["tokenizer"].vocab
    np.testing.assert_array_equal(t.rope_cos, j.rope_cos)
    np.testing.assert_array_equal(t.rope_sin, j.rope_sin)
    assert sorted(t.params) == sorted(j.params)
    for k, v in j.params.items():
        if isinstance(v, dict):
            assert sorted(t.params[k]) == sorted(v)
            for kk, vv in v.items():
                np.testing.assert_array_equal(t.params[k][kk], vv, err_msg=kk)
        else:
            np.testing.assert_array_equal(t.params[k], v, err_msg=k)
    frames = [("tok_embeddings", t.qparams["tok_embeddings"],
               j.qparams["tok_embeddings"])]
    frames += [(k, t.qparams["blocks"][k], v)
               for k, v in j.qparams["blocks"].items()]
    for name, tf, jf in frames:
        assert tf.shape == jf.shape, name
        np.testing.assert_array_equal(tf.blocks, jf.blocks, err_msg=name)


@pytest.mark.parametrize("which", ["tiny", "qwen3"])
def test_quantized_device_params_match_jax_loader(qwen_q4k, which):
    path = TINY if which == "tiny" else qwen_q4k
    jp = jbin.quantized_device_params(jbin.read_model(path, dense=False))
    got = tbin.quantized_device_params(tbin.read_model(path, dense=False),
                                       device="cpu")
    assert sorted(got) == sorted(jp)
    assert sorted(got["blocks"]) == sorted(jp["blocks"])
    for k, v in jp["blocks"].items():
        if isinstance(v, JQ4K):
            _assert_q4k_equal(got["blocks"][k], v, k)
        else:
            np.testing.assert_array_equal(got["blocks"][k].numpy(), _np(v))
    _assert_q4k_equal(got["tok_embeddings"], jp["tok_embeddings"])
    # the head requantized from the Q4K table (np.rint rounding), at group
    # size 64 (rows form) for tiny_q4k.bin, 256 (W8A8) for the Qwen3 file
    _assert_q80_rows_equal(got["output_q"], jp["output_q"])
    assert got["output_q"].group_size == (64 if which == "tiny" else 256)


def test_head_requant_keeps_packed_table_when_width_is_not_32_aligned():
    from nano_tpu.ops.q4k import quantize_lines_np
    w =np.random.RandomState(0).randn(8, 40).astype(np.float32)
    b = quantize_lines_np(w)
    assert tbin.q4k_head_requant(b, 8, 40) is None
    assert jbin.q4k_head_requant(b, 8, 40) is None
    for E, gs in ((64, 64), (96, 32), (512, 256)):
        w = np.random.RandomState(E).randn(16, E).astype(np.float32)
        b = quantize_lines_np(w)
        _assert_q80_rows_equal(tbin.q4k_head_requant(b, 16, E),
                               jbin.q4k_head_requant(b, 16, E))
        assert tbin.q4k_head_requant(b, 16, E).group_size == gs


def test_params_from_jax_round_trips(qwen_q4k):
    jp = jax.tree.map(np.asarray, jbin.quantized_device_params(
        jbin.read_model(qwen_q4k, dense=False)))
    tp = params_from_jax(jp, device="cpu")
    for k, v in jp["blocks"].items():
        if isinstance(v, JQ4K):
            _assert_q4k_equal(tp["blocks"][k], v, k)
    _assert_q4k_equal(tp["tok_embeddings"], jp["tok_embeddings"])
    _assert_q80_rows_equal(tp["output_q"], jp["output_q"])
    for layout in ("unpacked", "grouped"):
        other = getattr(jp["blocks"]["wo"], "to_" + layout)()
        with pytest.raises(NotImplementedError, match=layout):
            params_from_jax({"w": jax.tree.map(np.asarray, other)},
                            device="cpu")


# ---------------------------------------------------------------------
# forward and generation
# ---------------------------------------------------------------------

def test_prefill_and_decode_logits_match_jax(qwen_q4k):
    jctx, tctx = _contexts(qwen_q4k)
    jcfg, tcfg = jctx.cfg, tctx.cfg
    prompt = [5, 17, 300, 42, 99, 7, 256, 1, 64, 128, 3]
    n, pad, T = len(prompt), 16, 32
    ids = np.zeros((1, pad), np.int64)
    ids[0, :n] = prompt
    jcache = jgpt.KVCache.create(jcfg, 1, T, jnp.float32)
    tcache = tgpt.KVCache.create(tcfg, 1, T, torch.float32)
    jl, jcache = jgpt.forward_with_cache(
        jctx.params, jnp.asarray(ids, jnp.int32), jcache, jnp.int32(0), jcfg,
        dtype=jnp.float32, attn_len=pad, last_idx=jnp.int32(n - 1))
    tl, _ = tgpt.forward_with_cache(
        tctx.params, torch.from_numpy(ids), tcache, 0, tcfg,
        dtype=torch.float32, attn_len=pad, last_idx=n - 1)
    steps = [(np.asarray(jl)[:, 0], tl[:, 0].numpy())]
    tok = int(np.argmax(steps[0][0]))
    for i in range(8):
        pos = n + i
        jl, jcache = jgpt.forward_with_cache(
            jctx.params, jnp.asarray([[tok]], jnp.int32), jcache,
            jnp.int32(pos), jcfg, dtype=jnp.float32)
        tl, _ = tgpt.forward_with_cache(
            tctx.params, torch.tensor([[tok]]), tcache, pos, tcfg,
            dtype=torch.float32)
        steps.append((np.asarray(jl)[:, 0], tl[:, 0].numpy()))
        tok = int(np.argmax(steps[-1][0]))
    for want, got in steps:
        assert got.shape == want.shape == (1, jcfg.vocab_size)
        # f32 dequant dots both sides with the same fake-quant decisions;
        # the f32 sums run in another order -> 1e-4 of the logit range
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        assert np.argmax(got) == np.argmax(want)


@pytest.mark.parametrize("which", ["tiny", "qwen3"])
def test_greedy_matches_jax(qwen_q4k, which):
    path = TINY if which == "tiny" else qwen_q4k
    jctx, tctx = _contexts(path)
    assert isinstance(tctx.params["blocks"]["w13"], TQ4K)
    prompt = ([3, 9, 14, 20, 7, 1] if which == "tiny"
              else [11, 22, 33, 444, 55, 66, 77])
    want = jeng.generate_on_device(jctx, prompt, 24).tolist()
    assert teng.generate_on_device(tctx, prompt, 24).tolist() == want
    s = teng.Session(tctx, "", max_new_tokens=24, prompt_ids=prompt)
    stream = [t for t in iter(s.step, None)]
    assert stream == want[:len(stream)] and len(stream) >= 1


def test_tiny_q4k_reproduces_expected_stream():
    with open(os.path.join(FIX, "expected.json")) as f:
        expected = json.load(f)
    jctx, tctx = _contexts(TINY)
    s = teng.generate_sync(tctx, expected["prompt"], max_new_tokens=16)
    assert s.output_ids == expected["greedy"]["q4k"]
    ids = tctx.encode(expected["prompt"])
    assert ids == jctx.encode(expected["prompt"])
    assert (teng.generate_on_device(tctx, ids, 16).tolist()
            == jeng.generate_on_device(jctx, ids, 16).tolist())


@pytest.mark.parametrize("which", ["tiny", "qwen3"])
def test_batched_engine_streams_match_jax_solo(qwen_q4k, which):
    """Three greedy streams join mid-flight through the port's
    BatchedEngine on a Q4K file: every batched step's Q4K products take
    more than one row (the integer form on the CPU), and each stream is
    token-identical to the JAX engine's solo greedy stream.  The prompts'
    ids lie inside the embedding table (tiny_q4k.bin's trie also has id 64,
    past its 64-row table, where JAX reads NaN rows and the port clamps)."""
    from nano_tpu_torch.serve.batching import BatchedEngine
    path = TINY if which == "tiny" else qwen_q4k
    jctx, tctx = _contexts(path)
    assert isinstance(tctx.params["blocks"]["w13"], TQ4K)
    prompts = ([[3, 9, 14, 20, 7, 1], [5, 6, 7], [30, 31, 2, 8, 40]]
               if which == "tiny" else
               [[11, 22, 33, 444, 55], [100, 200, 300], [7, 8, 9, 10, 11]])
    n = 12
    be = BatchedEngine(tctx, n_slots=4)
    got = {}
    for i, prompt in enumerate(prompts):
        slot, first = be.add(prompt, max_new_tokens=n, temperature=0.0,
                             repetition_penalty=1.0)
        got[i] = (slot, [first])
        for _ in range(3):                    # the others decode meanwhile
            out = be.step()
            for j, (sl, toks) in got.items():
                toks.extend(out.get(sl, []))
    while be.n_active:
        out = be.step()
        for j, (sl, toks) in got.items():
            toks.extend(out.get(sl, []))
    for i, prompt in enumerate(prompts):
        want = jeng.generate_on_device(jctx, prompt, n).tolist()
        toks = got[i][1]
        assert len(toks) == n and toks == want, (i, toks, want)
