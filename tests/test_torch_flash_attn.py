"""Full-sequence causal GQA attention (K4): the port's plain version
against the JAX package's einsum path on the CPU, forward and gradient.

On the CPU the JAX package never takes its Pallas flash kernel
(`gpt._use_flash` is False there), so its einsum path `_gqa_scores` /
softmax / `_gqa_out` is the kernel's reference; the port's
`flash_attention` takes the kernels' plain versions for CPU tensors.  Inputs
come from numpy seeds.  f32: forward within 1e-5 of max|ref|, gradients
within 1e-4 of max|grad| (the same f32 arithmetic, sums in another order).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.models import gpt as jgpt
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.ops import decode_attn as tda
from nano_tpu_torch.ops import flash_attn as tfa

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config")


def _inputs(B, S, KV, rep, D, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    H = KV * rep
    return mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, D), mk(B, S, H * D)


def _jax_attention(q, k, v, dtype=jnp.float32):
    """The no-cache einsum branch of nano_tpu.models.gpt.attention."""
    B, S, H, D = q.shape
    cfg = JModelConfig(n_embd=H * D, n_head=H, n_kv_head=k.shape[2],
                       head_dim=D)
    scores = jgpt._gqa_scores(q.astype(dtype), k.astype(dtype), cfg)
    scores = scores + jgpt._causal_mask(S)
    probs = jax.nn.softmax(scores, axis=-1).astype(dtype)
    return jgpt._gqa_out(probs, v.astype(dtype))


CASES = [(B, S, KV, rep, D) for D in (16, 32, 48) for rep in (1, 2)
         for B, S, KV in ((2, 37, 2), (1, 64, 1))]


@pytest.mark.parametrize("B,S,KV,rep,D", CASES)
def test_plain_forward_matches_jax_einsum_path(B, S, KV, rep, D):
    q, k, v, _ = _inputs(B, S, KV, rep, D, S + D + rep)
    want = np.asarray(_jax_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v)))
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (B, S, KV * rep * D) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("B,S,KV,rep,D", CASES)
def test_plain_gradients_match_jax_grad(B, S, KV, rep, D):
    q, k, v, g = _inputs(B, S, KV, rep, D, S + D + rep + 1)
    want = jax.grad(lambda a, b, c: jnp.sum(_jax_attention(a, b, c) * g),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tfa.flash_attention(*leaves).backward(torch.from_numpy(g))
    for name, t, w in zip("qkv", leaves, want):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("D,rep", [(16, 2), (48, 1)])
def test_plain_bf16_casts_probabilities_like_jax(D, rep):
    """bf16 compute type: f32 scores and softmax, probabilities rounded to
    bf16 before the V product, as gpt.py does.  Both sides round to bf16
    at the same places; 2e-2 of max|ref| covers a last-bit difference of
    the bf16 V product's accumulation."""
    q, k, v, _ = _inputs(2, 40, 2, rep, D, 7)
    want = np.asarray(_jax_attention(*map(jnp.asarray, (q, k, v)),
                                     dtype=jnp.bfloat16).astype(jnp.float32))
    got = tfa.flash_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v, _ = _inputs(1, 9, 1, 2, 16, 3)
    q, k, v = map(torch.from_numpy, (q, k, v))
    n0 = (tfa.flash_attention.launches, tfa.flash_attention.backward_launches)
    got = tfa.flash_attention(q, k, v)
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v))
    assert (tfa.flash_attention.launches,
            tfa.flash_attention.backward_launches) == n0


def test_first_row_attends_only_itself():
    q, k, v, _ = _inputs(1, 5, 1, 1, 16, 4)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out[0, 0].numpy(), v[0, 0, 0], rtol=1e-6)


def test_kernel_wrappers_never_fall_back():
    """The kernel entry points build and launch or raise: with no nvcc
    they raise, whatever device the tensors are on."""
    q, k, v, _ = _inputs(1, 8, 1, 1, 16, 5)
    with pytest.raises((RuntimeError, ValueError)):
        tfa.flash_attn_fwd(*map(torch.from_numpy, (q, k, v)))


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "heads", "kv_shape"])
def test_check_refuses_what_the_kernels_do_not_take(bad):
    q = torch.zeros(1, 8, 4, 48)
    k = torch.zeros(1, 8, 2, 48)
    v = torch.zeros(1, 8, 2, 48)
    tfa._check(q, k, v)
    if bad == "head_dim":
        q, k, v = (torch.zeros(1, 8, n, 40) for n in (4, 2, 2))
    elif bad == "dtype":
        q = q.to(torch.float16)
    elif bad == "heads":
        k = v = torch.zeros(1, 8, 3, 48)
    else:
        v = torch.zeros(1, 7, 2, 48)
    with pytest.raises(ValueError, match="flash_attention takes"):
        tfa._check(q, k, v)


# what the card's forward kernel special-cases: four query heads of a KV
# head in one block, a sequence of one row, and one row short of / past a
# 64-row tile
EDGE_CASES = [(B, S, KV, 4, D) for D in (16, 32, 48) for B, S, KV in
              ((2, 1, 1), (1, 63, 2), (2, 65, 1))]


@pytest.mark.parametrize("B,S,KV,rep,D", EDGE_CASES)
def test_plain_forward_and_lse_at_tile_edges_and_rep4(B, S, KV, rep, D):
    """out within 1e-5 of max|ref| of the JAX einsum path, and the lse of
    `flash_attn_fwd_plain` (what the kernel's second output is held against on the card) within
    1e-5 of logsumexp over the JAX path's masked scores."""
    q, k, v, _ = _inputs(B, S, KV, rep, D, 11 * S + D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(_jax_attention(jq, jk, jv))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tfa.flash_attention(tq, tk, tv)       # CPU: the plain version
    assert got.shape == (B, S, KV * rep * D)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    cfg = JModelConfig(n_embd=KV * rep * D, n_head=KV * rep, n_kv_head=KV,
                       head_dim=D)
    scores = jgpt._gqa_scores(jq, jk, cfg) + jgpt._causal_mask(S)
    want_lse = np.asarray(jax.nn.logsumexp(scores, axis=-1)
                          ).reshape(B, KV * rep, S)
    got_lse = tfa.flash_attn_fwd_plain(tq, tk, tv)[1].numpy()
    assert got_lse.shape == (B, KV * rep, S)
    np.testing.assert_allclose(got_lse, want_lse, rtol=0, atol=1e-5)


def test_every_model_config_head_width_is_built():
    """Both attention ops take the head width of every model config the
    repo ships (Nano-56M 32, Nano-168M 48, Qwen3-0.6B 128): training goes
    through flash_attention, serving through decode_attention."""
    paths = sorted(glob.glob(os.path.join(CONFIG_DIR, "model_*.json")))
    assert len(paths) >= 3
    widths = {os.path.basename(p): ModelConfig.from_json(p).head_dim
              for p in paths}
    assert widths["model_56m.json"] == 32
    for name, D in widths.items():
        assert D in tfa.HEAD_DIMS, (name, D)
        assert D in tda.HEAD_DIMS, (name, D)
