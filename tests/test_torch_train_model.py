"""The training forward of the port (forward, loss_fn, chunked CE, remat
under every policy, init_params) against nano_tpu.models.gpt on the CPU.

Same parameters (made with numpy from a seed in the JAX package's tree
structure, carried across with params_from_jax) and the same token ids go
through both.  f32 throughout: logits within 1e-5 of max|logit|, the loss
within 1e-5 relative, every parameter's gradient within 1e-4 of its
max|grad| against jax.grad(gpt.loss_fn) — the same arithmetic, f32 sums in
another order.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.models import gpt as jgpt
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.io.from_jax import params_from_jax, params_to_numpy
from nano_tpu_torch.models import gpt as tgpt
from nano_tpu_torch.ops.flash_attn import causal_mask

NANO = dict(block_size=32, vocab_size=128, n_layer=2, n_embd=32, n_head=4,
            n_kv_head=2, n_hidden=64)
QWEN3 = dict(block_size=32, vocab_size=160, n_layer=2, n_embd=48, n_head=4,
             n_kv_head=2, n_hidden=96, head_dim=16, use_qk_norm=True,
             rope_style="half", rope_theta=1e6, norm_eps=1e-6)
QWEN2 = dict(NANO, qkv_bias=True, tie_embeddings=False)
LEARNED_POS = dict(NANO, use_rope=False)
GLOBAL = dict(NANO, is_causal=False)
# Nano-56M's head width (D = 32), cut to 2 layers and width 128
NANO56 = dict(block_size=32, vocab_size=128, n_layer=2, n_embd=128, n_head=4,
              n_kv_head=2, n_hidden=256)
CONFIGS = {"nano": NANO, "nano56": NANO56, "qwen3": QWEN3, "qwen2": QWEN2,
           "learned_pos": LEARNED_POS, "global": GLOBAL}


def _np_params(cfg_dict, seed):
    """Random parameters in the tree gpt.init_params gives: N(0, 0.05)
    matrices and biases, norm weights around 1."""
    shapes = jax.eval_shape(
        lambda k: jgpt.init_params(k, JModelConfig(**cfg_dict)),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        a = rng.randn(*tree.shape).astype(np.float32)
        return 1.0 + 0.1 * a if name.endswith("norm") else 0.05 * a
    return walk(shapes)


def _batch(cfg_dict, seed, B=3, S=19):
    rng = np.random.RandomState(seed)
    V = cfg_dict["vocab_size"]
    x = rng.randint(0, V, (B, S))
    y = rng.randint(0, V, (B, S))
    m = (rng.rand(B, S) < 0.6).astype(np.int32)
    return x, y, m


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]


def _both_losses(name, masked, remat=False, ce_chunk=0):
    cfg_dict = CONFIGS[name]
    tree = _np_params(cfg_dict, 11)
    x, y, m = _batch(cfg_dict, 12)
    jm = jnp.asarray(m) if masked else None
    jl, jg = jax.value_and_grad(jgpt.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(y), jm,
        JModelConfig(**cfg_dict), dtype=jnp.float32, remat=remat,
        ce_chunk=ce_chunk)
    params = params_from_jax(tree, "cpu", trainable=True)
    tl = tgpt.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y),
                      torch.from_numpy(m) if masked else None,
                      ModelConfig(**cfg_dict), dtype=torch.float32,
                      remat=remat, ce_chunk=ce_chunk)
    tl.backward()
    return float(jl), jax.tree.map(np.asarray, jg), tl.item(), params


def _assert_same(jl, jg, tl, params):
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    want = dict(_flat(jg))
    got = dict(_flat(params))
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        g = got[path].grad
        assert g is not None, path
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-12), (path, err)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logits_match_jax(name):
    cfg_dict = CONFIGS[name]
    tree = _np_params(cfg_dict, 1)
    x, _, _ = _batch(cfg_dict, 2)
    want = np.asarray(jgpt.forward(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
        JModelConfig(**cfg_dict), dtype=jnp.float32))
    got = tgpt.forward(params_from_jax(tree, "cpu"), torch.from_numpy(x),
                       ModelConfig(**cfg_dict), dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_gradients_match_jax(name, masked):
    _assert_same(*_both_losses(name, masked))


@pytest.mark.parametrize("remat", [True, "full", "ffn", "dots", "heads"])
@pytest.mark.parametrize("name", ["nano", "qwen3"])
def test_remat_policies_match_jax(name, remat):
    _assert_same(*_both_losses(name, True, remat=remat))


@pytest.mark.parametrize("remat", ["dots", "heads"])
@pytest.mark.parametrize("name", ["global", "learned_pos", "qwen2"])
def test_selective_remat_policies_match_jax_on_other_models(name, remat):
    """"dots" and "heads" against jax.grad under the same policy where the
    attention is the einsum path (global) and on the other parameter
    layouts."""
    _assert_same(*_both_losses(name, True, remat=remat))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("name", ["nano", "qwen3"])
def test_chunked_ce_matches_jax(name, masked):
    # 3 * 19 = 57 tokens in chunks of 7: the last chunk is ragged
    _assert_same(*_both_losses(name, masked, remat="ffn", ce_chunk=7))


def test_remat_changes_no_value():
    cfg = ModelConfig(**NANO)
    tree = _np_params(NANO, 5)
    x, y, m = map(torch.from_numpy, _batch(NANO, 6))
    grads = []
    for remat in (False, True, "ffn", "dots"):
        params = params_from_jax(tree, "cpu", trainable=True)
        tgpt.loss_fn(params, x, y, m, cfg, dtype=torch.float32,
                     remat=remat).backward()
        grads.append([p.grad for _, p in tgpt.param_leaves(params)])
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            assert torch.equal(a, b)


def _counted_step(monkeypatch, remat, **over):
    """One loss + backward of the NANO model under `remat`, counting the
    calls of the flash operator's plain forward ("op") and backward
    ("bwd"): (counts in the forward, counts during the backward, aten.mm
    calls during the backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from nano_tpu_torch.ops import flash_attn as tfa
    n = dict(op=0, bwd=0)

    def counting(key, fn):
        def f(*a, **k):
            n[key] += 1
            return fn(*a, **k)
        return f
    monkeypatch.setattr(tfa, "flash_attn_fwd_plain",
                        counting("op", tfa.flash_attn_fwd_plain))
    monkeypatch.setattr(tfa, "flash_attn_bwd_plain",
                        counting("bwd", tfa.flash_attn_bwd_plain))

    class MMs(TorchDispatchMode):
        mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                MMs.mm += 1
            return func(*args, **(kwargs or {}))

    cfg = ModelConfig(**dict(NANO, **over))
    params = params_from_jax(_np_params(dict(NANO, **over), 5), "cpu",
                             trainable=True)
    x, y, m = map(torch.from_numpy, _batch(NANO, 6))
    loss = tgpt.loss_fn(params, x, y, m, cfg, dtype=torch.float32,
                        remat=remat)
    fwd = dict(n)
    with MMs():
        loss.backward()
    return fwd, {k: n[k] - fwd[k] for k in n}, MMs.mm


def test_heads_remat_runs_no_attention_forward_in_backward(monkeypatch):
    """"heads" keeps the flash operator's out and lse: the backward
    recomputes the block but not the attention (one forward a layer),
    where full remat runs it again for every layer."""
    L = NANO["n_layer"]
    fwd, bwd, _ = _counted_step(monkeypatch, "heads")
    assert fwd == dict(op=L, bwd=0)
    assert bwd == dict(op=0, bwd=L)
    fwd, bwd, _ = _counted_step(monkeypatch, "full")
    assert fwd == dict(op=L, bwd=0)
    assert bwd == dict(op=L, bwd=L)                     # computed again


def test_dots_remat_keeps_the_projections(monkeypatch):
    """"dots" keeps every 2-D product's output: its backward runs as many
    aten.mm as no remat at all (the gradients' products), where full remat
    also runs the projections of every layer again (6 of its 7: the
    recompute stops once the tensors the backward reads are back, before
    w2); the attention runs again under both."""
    L = NANO["n_layer"]
    _, _, mm_none = _counted_step(monkeypatch, False)
    fwd, bwd, mm_dots = _counted_step(monkeypatch, "dots")
    _, _, mm_full = _counted_step(monkeypatch, "full")
    assert fwd == dict(op=L, bwd=0) and bwd == dict(op=L, bwd=L)
    assert mm_dots == mm_none and mm_full == mm_none + 6 * L


@pytest.mark.parametrize("policy", ["dots", "heads", "some-other-name"])
def test_remat_mode_takes_every_policy_name(policy):
    """The names of the JAX package's table are themselves; one the table
    does not know means full remat, as there."""
    assert tgpt._remat_mode(policy) == (
        policy if policy in ("dots", "heads") else "full")
    assert tgpt._remat_mode(False) is None and tgpt._remat_mode(True) == "full"


def test_bf16_loss_close_to_jax_bf16():
    """The training type: both sides round to bf16 at every projection, in
    other orders inside a dot, so the losses agree to bf16's precision
    (2e-2 relative), not to f32's."""
    tree = _np_params(NANO, 11)
    x, y, m = _batch(NANO, 12)
    jl = float(jgpt.loss_fn(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                            jnp.asarray(y), jnp.asarray(m),
                            JModelConfig(**NANO), dtype=jnp.bfloat16))
    tl = float(tgpt.loss_fn(params_from_jax(tree, "cpu"),
                            *map(torch.from_numpy, (x, y, m)),
                            ModelConfig(**NANO), dtype=torch.bfloat16))
    assert abs(tl - jl) <= 2e-2 * abs(jl)


def test_tied_embedding_gets_both_gradients_and_out_of_range_ids_clamp():
    """tok_embeddings is one leaf with two uses (gather and head); an id
    past the table clamps to the last row, as the JAX gather does, and the
    gather's backward still runs.  The loss and every gradient agree but
    for the table's last row: JAX's scatter (the gather's transpose) drops
    an out-of-range row's gradient, the port credits it to the row the
    forward read."""
    cfg_dict = NANO
    V = cfg_dict["vocab_size"]
    tree = _np_params(cfg_dict, 21)
    x, y, m = _batch(cfg_dict, 22)
    x[x == V - 1] = 0
    x[0, 0] = V + 5
    jl, jg = jax.value_and_grad(jgpt.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(m), JModelConfig(**cfg_dict), dtype=jnp.float32)
    jg = jax.tree.map(np.array, jg)
    params = params_from_jax(tree, "cpu", trainable=True)
    tl = tgpt.loss_fn(params, *map(torch.from_numpy, (x, y, m)),
                      ModelConfig(**cfg_dict), dtype=torch.float32)
    tl.backward()
    grad = params["tok_embeddings"].grad
    assert torch.isfinite(grad).all()
    last = grad[V - 1].numpy() - jg["tok_embeddings"][V - 1]
    assert np.abs(last).max() > 0            # the gather's share, kept
    jg["tok_embeddings"][V - 1] = grad[V - 1].numpy()
    _assert_same(float(jl), jg, tl.item(), params)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_has_the_jax_structure(name):
    cfg_dict = CONFIGS[name]
    want = jax.eval_shape(
        lambda k: jgpt.init_params(k, JModelConfig(**cfg_dict)),
        jax.random.PRNGKey(0))
    cfg = ModelConfig(**cfg_dict)
    got = tgpt.init_params(torch.Generator().manual_seed(3), cfg,
                           device="cpu")
    want_flat, got_flat = dict(_flat(want)), dict(_flat(got))
    assert sorted(want_flat) == sorted(got_flat)
    L = cfg.n_layer
    for path, w in want_flat.items():
        t = got_flat[path]
        assert tuple(t.shape) == tuple(w.shape), path
        assert t.dtype == torch.float32 and t.requires_grad and t.is_leaf
        leaf = path.split("/")[-1]
        if leaf.endswith("norm"):
            assert torch.all(t == 1)
        elif leaf in ("bq", "bk", "bv"):
            assert torch.all(t == 0)
        else:
            std = 0.02 / math.sqrt(2 * L) if leaf in ("wo", "w3") else 0.02
            assert abs(t.std().item() - std) < 0.15 * std, path
    n = sum(int(np.prod(w.shape)) for w in want_flat.values())
    if not cfg.use_rope:
        n -= cfg.block_size * cfg.n_embd
    assert tgpt.count_params(got, cfg) == n
    assert (tgpt.estimate_flops_per_token(cfg, n)
            == jgpt.estimate_flops_per_token(JModelConfig(**cfg_dict), n))
    again = tgpt.init_params(torch.Generator().manual_seed(3), cfg,
                             device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tgpt.param_leaves(got), tgpt.param_leaves(again)))


def test_params_round_trip_through_numpy():
    tree = _np_params(QWEN3, 9)
    back = params_to_numpy(params_from_jax(tree, "cpu", trainable=True))
    for (pa, a), (pb, b) in zip(_flat(tree), _flat(back)):
        assert pa == pb and np.array_equal(a, b)
    bf = params_to_numpy({"w": torch.tensor([1.5, -2.25]).to(torch.bfloat16)})
    assert bf["w"].dtype.name == "bfloat16"
    assert np.array_equal(bf["w"].astype(np.float32), [1.5, -2.25])


def test_causal_mask_matches_jax():
    assert np.array_equal(causal_mask(7).numpy(),
                          np.asarray(jgpt._causal_mask(7)))
