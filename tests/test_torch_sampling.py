"""nano_tpu_torch.ops.sampling against nano_tpu.ops.sampling on the CPU.

Random draws cannot match (torch.Generator vs jax.random), so the
samplers are held to each other through sample_with_coin with the same
numpy coins, and the deterministic pieces compare exactly."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.infer import engine as jeng
from nano_tpu.ops import sampling as jsamp
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.ops import sampling as tsamp


def _logits(seed, B=4, V=50):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, V) * 2).astype(np.float32), rng


@pytest.mark.parametrize("temperature,top_p,penalty", [
    (1.0, 0.8, 1.0), (0.7, 1.0, 1.0), (1.3, 0.5, 1.1), (0.9, 0.95, 1.3)])
def test_sample_with_coin_matches_jax(temperature, top_p, penalty):
    logits, rng = _logits(int(temperature * 100 + top_p * 10))
    seen = rng.rand(*logits.shape) < 0.2
    jcfg = jsamp.SamplerConfig(temperature=temperature, top_p=top_p,
                               repetition_penalty=penalty)
    tcfg = tsamp.SamplerConfig(temperature=temperature, top_p=top_p,
                               repetition_penalty=penalty)
    for _ in range(20):
        coin = rng.rand(logits.shape[0]).astype(np.float32)
        want = np.asarray(jsamp.sample_with_coin(
            jnp.asarray(logits), jnp.asarray(coin), jcfg, jnp.asarray(seen)))
        got = tsamp.sample_with_coin(torch.from_numpy(logits),
                                     torch.from_numpy(coin), tcfg,
                                     torch.from_numpy(seen)).numpy()
        np.testing.assert_array_equal(got, want)


def test_greedy_tie_takes_first_index():
    logits = np.zeros((3, 16), np.float32)
    logits[0, [3, 9]] = 5.0          # tie between 3 and 9
    logits[1, [0, 15]] = 1.0         # tie at the ends
    logits[2, :] = -1.0              # all tied
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    np.testing.assert_array_equal(want, [3, 0, 0])
    t = torch.from_numpy(logits)
    greedy = tsamp.SamplerConfig(temperature=0.0)
    np.testing.assert_array_equal(tsamp.sample(t, greedy).numpy(), want)
    np.testing.assert_array_equal(
        tsamp.sample_with_coin(t, torch.zeros(3), greedy).numpy(), want)
    np.testing.assert_array_equal(
        teng._sample_windowed(t, greedy, None).numpy(), want)


def test_penalty_top_k_top_p_and_seen_masks_match_jax():
    logits, rng = _logits(5, B=3, V=40)
    seen = rng.rand(*logits.shape) < 0.3
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    np.testing.assert_array_equal(
        tsamp.apply_repetition_penalty(tl, torch.from_numpy(seen), 1.3).numpy(),
        np.asarray(jsamp.apply_repetition_penalty(jl, jnp.asarray(seen), 1.3)))
    np.testing.assert_array_equal(
        tsamp.apply_top_k(tl, 7).numpy(), np.asarray(jsamp.apply_top_k(jl, 7)))
    probs = np.array(jax.nn.softmax(jl, axis=-1))
    np.testing.assert_array_equal(
        tsamp.apply_top_p(torch.from_numpy(probs), 0.6).numpy(),
        np.asarray(jsamp.apply_top_p(jnp.asarray(probs), 0.6)))
    ids = rng.randint(0, 40, (3, 12)).astype(np.int32)
    length = np.array([12, 5, 0], np.int32)
    want = np.asarray(jsamp.seen_mask_from_ids(jnp.asarray(ids),
                                               jnp.asarray(length), 40))
    got = tsamp.seen_mask_from_ids(torch.from_numpy(ids).long(),
                                   torch.from_numpy(length), 40)
    np.testing.assert_array_equal(got.numpy(), want)
    toks = np.array([1, 2, 39], np.int32)
    np.testing.assert_array_equal(
        tsamp.update_seen_mask(got.clone(), torch.from_numpy(toks)).numpy(),
        np.asarray(jsamp.update_seen_mask(jnp.asarray(want), jnp.asarray(toks))))


def test_xorshift_matches_jax():
    js = ts = np.uint64(0x9E3779B97F4A7C15)
    for _ in range(100):
        js, jv = jsamp.xorshift_f32(js)
        ts, tv = tsamp.xorshift_f32(ts)
        assert (js, jv) == (ts, tv)


def test_windowed_sampling_stays_in_nucleus_and_is_seeded():
    logits, _ = _logits(9, B=2, V=300)
    t = torch.from_numpy(logits)
    cfg = tsamp.SamplerConfig(temperature=0.8, top_p=0.3)
    # the nucleus: sorted prefix whose mass before each token is <= top_p
    # (the JAX engine's full-vocab probabilities, engine._sample_windowed)
    probs = torch.softmax(t / 0.8, dim=-1)
    sp, order = torch.sort(probs, descending=True, stable=True)
    keep = (torch.cumsum(sp, -1) - sp) <= 0.3
    draws = [teng._sample_windowed(t, cfg, torch.Generator().manual_seed(s))
             for s in range(40)]
    for b in range(2):
        nucleus = set(order[b][keep[b]].tolist())
        assert {int(d[b]) for d in draws} <= nucleus
    again = teng._sample_windowed(t, cfg, torch.Generator().manual_seed(3))
    assert torch.equal(again, draws[3])
    # the same window semantics as the JAX engine's top_k path: a top-1
    # window is greedy
    top1 = tsamp.SamplerConfig(temperature=1.0, top_k=1)
    np.testing.assert_array_equal(
        teng._sample_windowed(t, top1, torch.Generator()).numpy(),
        np.asarray(jeng._sample_windowed(jax.random.PRNGKey(0), jnp.asarray(logits),
                                         1.0, 0.8, 1, False)[1]))
