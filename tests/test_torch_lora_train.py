"""LoRA fine-tuning in the port against the JAX package on the CPU: the
loss and its gradients with respect to the adapter against jax.grad of
gpt.loss_fn(..., lora=...), the Trainer's use_lora (a fresh adapter at
step 0 on a checkpoint's base, AdamW over the adapter alone, the base bit
for bit unchanged) step by step beside the JAX Trainer, and LoRA-only
checkpoints crossing between the packages and served on the base.

Tolerances: f32 losses within 1e-5 relative; gradients within 1e-4 of
their largest element (the frameworks sum in other orders); after three
AdamW steps the adapters within 1e-5 (AdamW moves every element by about
lr whatever its gradient's size)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.io import checkpoint as jckpt
from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import sampling as jsamp
from nano_tpu.train import trainer as jtrainer
from nano_tpu_torch.config import ModelConfig as TConfig
from nano_tpu_torch.data import preprocess
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.io import checkpoint as tckpt
from nano_tpu_torch.io.from_jax import params_from_jax
from nano_tpu_torch.models import gpt as tgpt
from nano_tpu_torch.ops import sampling as tsamp
from nano_tpu_torch.tokenizer.trie import TrieTokenizer
from nano_tpu_torch.train import trainer as ttrainer

TINY = dict(block_size=32, vocab_size=128, n_layer=2, n_embd=64,
            n_head=4, n_kv_head=2, n_hidden=128)
CORPUS = ("the quick brown fox jumps over the lazy dog. " * 200 +
          "pack my box with five dozen liquor jugs. " * 200)
GREEDY = dict(temperature=0.0, repetition_penalty=1.0)


def random_lora(cfg, rank, seed, std=0.1):
    rng = np.random.RandomState(seed)
    L, E = cfg.n_layer, cfg.n_embd
    HD, KD = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim
    shapes = {"wq_a": (L, E, rank), "wq_b": (L, rank, HD),
              "wk_a": (L, E, rank), "wk_b": (L, rank, KD),
              "wv_a": (L, E, rank), "wv_b": (L, rank, KD),
              "wo_a": (L, HD, rank), "wo_b": (L, rank, E)}
    return {k: (rng.randn(*s) * std).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("remat,ce_chunk", [(False, 0), ("full", 24)],
                         ids=["plain", "remat_chunked_ce"])
def test_lora_loss_and_gradients_match_jax_grad(remat, ce_chunk):
    cfg = JConfig(**TINY)
    params = jax.tree.map(np.asarray,
                          jgpt.init_params(jax.random.PRNGKey(1), cfg))
    lora = random_lora(cfg, 4, 2)
    rng = np.random.RandomState(0)
    x = rng.randint(0, TINY["vocab_size"], (2, 16))
    y = rng.randint(0, TINY["vocab_size"], (2, 16))
    m = (rng.rand(2, 16) > 0.2).astype(np.int32)

    def jloss(lo):
        return jgpt.loss_fn(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                            cfg, dtype=jnp.float32, lora=lo, lora_scale=2.0,
                            remat=remat, ce_chunk=ce_chunk)

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, lora))
    tparams = params_from_jax(params, "cpu")
    tlora = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in lora.items()}
    tl = tgpt.loss_fn(tparams, torch.from_numpy(x), torch.from_numpy(y),
                      torch.from_numpy(m), TConfig(**TINY),
                      dtype=torch.float32, remat=remat, ce_chunk=ce_chunk,
                      lora=tlora, lora_scale=2.0)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for k, w in jg.items():
        w = np.asarray(w)
        g = tlora[k].grad.numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k
        assert np.abs(w).max() > 0, k       # every adapter leaf learns
    # the base takes no gradient: it is not a leaf that asks for one
    assert all(not t.requires_grad for _, t in tgpt.param_leaves(tparams))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Data shards of a repeated corpus, its trie tokenizer, and a base
    checkpoint (the JAX package's random init) to fine-tune."""
    d = tmp_path_factory.mktemp("lora_train")
    tok = TrieTokenizer()
    tok.build_from_text(CORPUS)
    tok_path = str(d / "tok.json")
    tok.dump_config_file(tok_path)
    corpus = str(d / "corpus.txt")
    with open(corpus, "w") as f:
        f.write(CORPUS)
    train_p, val_p = preprocess.generate_pretrain_dataset(
        [corpus], tok, block_size=TINY["block_size"],
        output_prefix=str(d / "pt"))
    base = str(d / "base.npz")
    params = jgpt.init_params(jax.random.PRNGKey(3), JConfig(**TINY))
    jckpt.save_checkpoint(base, params=jax.tree.map(np.asarray, params),
                          step=40, model_config=TINY,
                          tokenizer_config=tok.config)
    return d, tok_path, train_p, val_p, base


def _tc(setup, save_to, **over):
    _, tok_path, train_p, val_p, base = setup
    tc = dict(batch_size=8, gradient_accumulation_steps=1,
              learning_rate=1e-3, min_lr=1e-4, warmup_iters=2,
              lr_decay_iters=10, eval_interval=1000, eval_iters=1,
              log_interval=1, tokenizer_path=tok_path,
              dataset_path=[[train_p, val_p]], dtype="float32",
              save_checkpoint_to=str(save_to), random_seed=0,
              from_checkpoint=base, use_lora=True, lora_rank=4,
              lora_alpha=8)
    tc.update(over)
    return tc


def test_lora_trainer_follows_the_jax_trainer_with_the_base_frozen(
        setup, tmp_path, capsys):
    """Three steps from the same adapter (the JAX Trainer's fresh one,
    carried over), the same batches: losses and adapters beside the JAX
    Trainer's, the base bit-unchanged, a LoRA-only checkpoint."""
    jt = jtrainer.Trainer(TINY, _tc(setup, tmp_path / "j"), max_steps=3)
    jt.init()
    jt.load_data()
    start = jax.tree.map(np.array, jt.lora)
    pt = ttrainer.Trainer(TINY, _tc(setup, tmp_path / "t"), max_steps=3,
                          device="cpu")
    pt.init()
    out = capsys.readouterr().out
    n_lora = sum(v.size for v in start.values())
    assert pt.step_count == 0 and f"trainable={n_lora:,}" in out
    assert "LoRA fine-tune from" in out
    assert sorted(pt.lora) == sorted(start)
    for k, v in pt.lora.items():                  # the port's own draw
        assert v.shape == start[k].shape and v.requires_grad
        assert not v.any() if k.endswith("_b") else v.abs().max() > 0
    pt.load_data()
    pt.lora = {k: torch.from_numpy(v.copy()).requires_grad_(True)
               for k, v in start.items()}
    pt.opt = ttrainer.AdamW(pt.train_config, pt.lora)
    base = {k: v.detach().clone() for k, v in tgpt.param_leaves(pt.params)}
    jt.start()
    pt.start()
    assert [s for s, _ in pt.loss_history] == [1, 2, 3]
    for (_, jl), (_, tl) in zip(jt.loss_history, pt.loss_history):
        assert abs(tl - jl) <= 1e-5 * abs(jl), (jt.loss_history,
                                                pt.loss_history)
    moved = 0.0
    for k, w in jt.lora.items():
        g = pt.lora[k].detach().numpy()
        assert np.abs(g - np.asarray(w)).max() <= 1e-5, k
        moved = max(moved, np.abs(g - start[k]).max())
    assert moved > 1e-3 and pt.opt.count == 3
    for k, v in tgpt.param_leaves(pt.params):
        assert torch.equal(v, base[k]), k
        assert v.grad is None
    ck = tckpt.Checkpoint(str(tmp_path / "t" / "checkpoint.npz"))
    assert ck.is_lora and not ck.has("model") and ck.step == 3
    assert ck.train_config["lora_rank"] == 4


def test_lora_checkpoints_cross_and_serve_on_the_base(setup, tmp_path):
    """Each package's LoRA-only checkpoint read by the other's Checkpoint,
    and served by both engines on the base checkpoint: the same greedy
    stream."""
    _, _, _, _, base = setup
    jt = jtrainer.Trainer(TINY, _tc(setup, tmp_path / "j"), max_steps=2)
    jt.init()
    jt.load_data()
    jt.start()
    pt = ttrainer.Trainer(TINY, _tc(setup, tmp_path / "t"), max_steps=2,
                          device="cpu")
    pt.init()
    pt.load_data()
    pt.start()
    like = jgpt.init_lora_params(jax.random.PRNGKey(0), JConfig(**TINY), 4)
    for src, lora in (("j", jax.tree.map(np.asarray, jt.lora)),
                      ("t", {k: v.detach().numpy()
                             for k, v in pt.lora.items()})):
        path = str(tmp_path / src / "checkpoint.npz")
        got = tckpt.Checkpoint(path).load_lora()
        jgot = jckpt.Checkpoint(path).load_lora(like)
        for k, v in lora.items():
            np.testing.assert_array_equal(got[k].numpy(), v)
            np.testing.assert_array_equal(np.asarray(jgot[k]), v)
        jctx = jeng.LLMContext.from_checkpoint(
            base, dtype=jnp.float32, sampler=jsamp.SamplerConfig(**GREEDY))
        tctx = teng.LLMContext.from_checkpoint(
            base, dtype=torch.float32, device="cpu",
            sampler=tsamp.SamplerConfig(**GREEDY))
        ids = tctx.encode("the quick brown")
        plain = teng.generate_on_device(tctx, ids, 16).tolist()
        jctx.load_lora_checkpoint(path)
        tctx.load_lora_checkpoint(path)
        assert tctx.lora_scale == jctx.lora_scale == 2.0
        want = jeng.generate_on_device(jctx, ids, 16).tolist()
        assert teng.generate_on_device(tctx, ids, 16).tolist() == want
        assert plain == jeng.generate_on_device(
            jeng.LLMContext.from_checkpoint(
                base, dtype=jnp.float32,
                sampler=jsamp.SamplerConfig(**GREEDY)), ids, 16).tolist()
