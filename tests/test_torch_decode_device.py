"""Decode with positions on the device against the JAX package on the CPU:
``gpt.forward_decode_batched`` (a position per row, the cache written by
index) against JAX ``forward_decode_batched`` and ``forward_with_cache``
over f32 / bf16 / int8 caches, on a random Qwen3-shaped Q80 model (group
size 256, through params_from_jax) and a dense f32 Nano model; and the
engine's step — the function the CUDA graph captures, run eagerly here —
through ``generate_on_device`` and ``Session`` against the JAX engine."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.config import ModelConfig as JConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import sampling as jsamp
from nano_tpu_torch.config import ModelConfig as TConfig
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.io.from_jax import params_from_jax
from nano_tpu_torch.models import gpt as tgpt
from nano_tpu_torch.ops import sampling as tsamp
from tests.test_torch_slice import QWEN3_TINY, _random_q80_params

NANO_TINY = dict(block_size=64, vocab_size=64, n_layer=2, n_embd=64,
                 n_head=4, n_kv_head=2, n_hidden=128)
CACHE_TYPES = {"f32": (jnp.float32, torch.float32),
               "bf16": (jnp.bfloat16, torch.bfloat16),
               "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def models():
    """name -> (JAX config, port config, JAX params, port params)."""
    out = {}
    jcfg, tcfg = JConfig(**QWEN3_TINY), TConfig(**QWEN3_TINY)
    tree = _random_q80_params(jcfg)
    out["qwen3_q80"] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                        params_from_jax(tree, device="cpu"))
    jcfg, tcfg = JConfig(**NANO_TINY), TConfig(**NANO_TINY)
    tree = jax.tree.map(np.asarray,
                        jgpt.init_params(jax.random.PRNGKey(5), jcfg))
    out["nano_f32"] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                       params_from_jax(tree, device="cpu"))
    return out


def _caches(jcfg, tcfg, B, T, kind, seed):
    """The same random cache contents on both sides."""
    jdt, tdt = CACHE_TYPES[kind]
    rng = np.random.RandomState(seed)
    shape = (jcfg.n_layer, B, T, jcfg.n_kv_head, jcfg.head_dim)
    if kind == "int8":
        k, v = (rng.randint(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.rand(*shape[:-1]).astype(np.float32) * 0.02
                  for _ in range(2))
        j = jgpt.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                         k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        t = tgpt.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                         k_scale=torch.from_numpy(ks),
                         v_scale=torch.from_numpy(vs))
        return j, t
    k, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    j = jgpt.KVCache(k=jnp.asarray(k, jdt), v=jnp.asarray(v, jdt))
    t = tgpt.KVCache(k=torch.from_numpy(k).to(tdt),
                     v=torch.from_numpy(v).to(tdt))
    return j, t


def _tensors(c):
    return [np.asarray(x if not hasattr(x, "float") else x.float(),
                       np.float32)
            for x in (c.k, c.v, c.k_scale, c.v_scale) if x is not None]


@pytest.mark.parametrize("name", ["qwen3_q80", "nano_f32"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_forward_decode_batched_matches_jax(models, name, kind):
    """Rows at positions that differ (first row, middle, last row of the
    cache): logits within 1e-4 of the logit range (f32 both sides, the
    same int8 decisions, float sums in another order), every cache row
    written where JAX writes it and nowhere else."""
    jcfg, tcfg, jp, tp = models[name]
    B, T = 3, 32
    jc, tc = _caches(jcfg, tcfg, B, T, kind, seed=len(name) + len(kind))
    pos = np.array([0, 17, T - 1], np.int32)
    tok = np.array([5, 40, 63], np.int32)
    jl, jc2 = jgpt.forward_decode_batched(
        jp, jnp.asarray(tok), jc, jnp.asarray(pos), jcfg, dtype=jnp.float32)
    before = _tensors(tc)
    tl, tc2 = tgpt.forward_decode_batched(
        tp, torch.from_numpy(tok).long(), tc, torch.from_numpy(pos), tcfg,
        dtype=torch.float32)
    assert tc2 is tc and tl.shape == (B, jcfg.vocab_size)
    want = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert (tl.numpy().argmax(-1) == want.argmax(-1)).all()
    for i, (old, got, exp) in enumerate(zip(before, _tensors(tc),
                                            _tensors(jc2))):
        written = np.zeros(old.shape[:3], bool)
        written[:, np.arange(B), pos] = True
        np.testing.assert_array_equal(got[~written], old[~written])
        # int8 rows: the same rounding decisions; values and scales: the
        # f32 projections' sums in another order
        tol = 0 if kind == "int8" and i < 2 else 1e-5 * np.abs(exp).max()
        np.testing.assert_allclose(got[written], exp[written], rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_single_row_decode_matches_jax_forward_with_cache(models, kind):
    """forward_with_cache with S == 1 is the batched step at B = 1: a host
    int and a device int32 position give the JAX single-stream logits."""
    jcfg, tcfg, jp, tp = models["qwen3_q80"]
    jc, tc = _caches(jcfg, tcfg, 1, 32, kind, seed=3)
    jl, _ = jgpt.forward_with_cache(jp, jnp.asarray([[7]], jnp.int32), jc,
                                    jnp.int32(20), jcfg, dtype=jnp.float32)
    want = np.asarray(jl)[:, 0]
    for start in (20, torch.tensor([20], dtype=torch.int32)):
        tc2 = tgpt.KVCache(*(None if x is None else x.clone()
                             for x in (tc.k, tc.v, tc.k_scale, tc.v_scale)))
        tl, _ = tgpt.forward_with_cache(tp, torch.tensor([[7]]), tc2, start,
                                        tcfg, dtype=torch.float32)
        np.testing.assert_allclose(tl[:, 0].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def _ctxs(models, name, max_seq_len=128, penalty=1.0, **kw):
    jcfg, tcfg, jp, tp = models[name]
    sampler = dict(temperature=0.0, repetition_penalty=penalty)
    jkw = {k: (jnp.int8 if v is torch.int8 else v) for k, v in kw.items()}
    jctx = jeng.LLMContext(cfg=jcfg, params=jp, tokenizer=None,
                           max_seq_len=max_seq_len, dtype=jnp.float32,
                           sampler=jsamp.SamplerConfig(**sampler), **jkw)
    tctx = teng.LLMContext(cfg=tcfg, params=tp, tokenizer=None,
                           max_seq_len=max_seq_len,
                           device=torch.device("cpu"), dtype=torch.float32,
                           sampler=tsamp.SamplerConfig(**sampler), **kw)
    return jctx, tctx


@pytest.mark.parametrize("graph_steps", [1, 4])
@pytest.mark.parametrize("penalty", [1.0, 1.1])
def test_generate_on_device_and_session_match_jax(models, graph_steps,
                                                  penalty):
    """The eager step through generate_on_device and Session equals the
    JAX engine's greedy stream; so does the context's decoder run through
    a DecodeGraph of `graph_steps` steps a 'replay'."""
    jctx, tctx = _ctxs(models, "qwen3_q80", penalty=penalty)
    prompt = [11, 22, 33, 44, 55, 66, 77]
    want = jeng.generate_on_device(jctx, prompt, 23).tolist()
    assert teng.generate_on_device(tctx, prompt, 23).tolist() == want
    s = teng.Session(tctx, "", max_new_tokens=23, prompt_ids=prompt)
    assert [t for t in iter(s.step, None)] == want[:len(s.output_ids)]
    assert len(s.output_ids) >= 1
    dec = tctx.decoder()
    with tctx.on_stream():
        dec.claim()
        dec.prefill(prompt)
        for _ in range(20 // graph_steps):
            dec._graph(graph_steps).run()
    assert dec.out[:21].tolist() == want[:21]


def test_int8_kv_generate_on_device_matches_jax(models):
    jctx, tctx = _ctxs(models, "nano_f32", max_seq_len=64,
                       kv_cache_dtype=torch.int8)
    prompt = [9, 8, 7, 6, 5]
    assert (teng.generate_on_device(tctx, prompt, 30).tolist()
            == jeng.generate_on_device(jctx, prompt, 30).tolist())


def test_interleaved_sessions_keep_their_own_streams(models):
    """Sessions share the context's decode state one at a time: two
    sessions stepped in turn, with a generate_on_device call between their
    steps, each give their solo stream."""
    jctx, tctx = _ctxs(models, "nano_f32", max_seq_len=64)
    pa, pb = [1, 2, 3, 4], [40, 41, 42, 43, 44, 45]
    want_a = jeng.generate_on_device(jctx, pa, 20).tolist()
    want_b = jeng.generate_on_device(jctx, pb, 20).tolist()
    sa = teng.Session(tctx, "", max_new_tokens=20, prompt_ids=pa)
    sb = teng.Session(tctx, "", max_new_tokens=20, prompt_ids=pb)
    for i in range(20):
        sa.step()
        if i == 7:
            teng.generate_on_device(tctx, [7, 7, 7], 64 - 3)
        sb.step()
    assert sa.output_ids == want_a[:len(sa.output_ids)]
    assert sb.output_ids == want_b[:len(sb.output_ids)]
    assert len(sa.output_ids) > 8 and len(sb.output_ids) > 8
    # one decode state with a max_seq_len cache, kept by the context
    assert tctx.decoder() is sa._dec is sb._dec
    assert tctx.decoder().cache.k.shape[2] == 64
