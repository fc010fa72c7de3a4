"""The port's Trainer against nano_tpu.train.trainer on the CPU: schedule,
decay mask, a 5-step trajectory with gradient accumulation from the same
parameters and batches, exact resume, checkpoints that cross between the
packages, and what the port refuses."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.config import TrainConfig as JTrainConfig
from nano_tpu.io import checkpoint as jckpt
from nano_tpu.models import gpt as jgpt
from nano_tpu.train import trainer as jtrainer
from nano_tpu_torch.config import ModelConfig, TrainConfig
from nano_tpu_torch.data import preprocess
from nano_tpu_torch.io import checkpoint as tckpt
from nano_tpu_torch.io.from_jax import params_from_jax, params_to_numpy
from nano_tpu_torch.models import gpt as tgpt
from nano_tpu_torch.tokenizer.trie import TrieTokenizer
from nano_tpu_torch.train import __main__ as train_main
from nano_tpu_torch.train import trainer as ttrainer

TINY = dict(block_size=32, vocab_size=128, n_layer=2, n_embd=32,
            n_head=4, n_kv_head=2, n_hidden=64)

CORPUS = ("the quick brown fox jumps over the lazy dog. " * 200 +
          "pack my box with five dozen liquor jugs. " * 200)


@pytest.fixture(scope="module")
def corpus_shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    tok = TrieTokenizer()
    tok.build_from_text(CORPUS)
    tok_path = str(d / "tok.json")
    tok.dump_config_file(tok_path)
    corpus_path = str(d / "corpus.txt")
    with open(corpus_path, "w") as f:
        f.write(CORPUS)
    train_p, val_p = preprocess.generate_pretrain_dataset(
        [corpus_path], tok, block_size=TINY["block_size"],
        output_prefix=str(d / "pt"))
    return tok_path, train_p, val_p


def _tc(corpus_shards, save_to, **over):
    tok_path, train_p, val_p = corpus_shards
    tc = dict(batch_size=8, gradient_accumulation_steps=1,
              learning_rate=1e-3, min_lr=1e-4, warmup_iters=3,
              lr_decay_iters=10, eval_interval=1000, eval_iters=1,
              log_interval=1, tokenizer_path=tok_path,
              dataset_path=[[train_p, val_p]], dtype="float32",
              save_checkpoint_to=str(save_to), random_seed=0)
    tc.update(over)
    return tc


def _port_trainer(tc, max_steps, **kw):
    t = ttrainer.Trainer(TINY, tc, max_steps=max_steps, device="cpu", **kw)
    t.init()
    t.load_data()
    return t


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]


@pytest.mark.parametrize("decay_lr", [True, False])
def test_lr_schedule_equals_the_jax_schedule(decay_lr):
    kw = dict(learning_rate=1e-3, min_lr=1e-4, warmup_iters=3,
              lr_decay_iters=10, decay_lr=decay_lr)
    want = jtrainer.make_lr_schedule(JTrainConfig(**kw))
    got = ttrainer.make_lr_schedule(TrainConfig(**kw))
    for step in (0, 1, 2, 3, 4, 5, 9, 10, 11, 1000):
        # the JAX schedule computes in f32
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6)
    if decay_lr:
        assert got(0) == pytest.approx(1e-3 / 3)
        assert got(1000) == pytest.approx(1e-4)


def test_train_config_has_the_jax_fields_and_defaults():
    assert TrainConfig().to_dict() == JTrainConfig().to_dict()
    cfg = TrainConfig.from_dict({"batch_size": 3, "max_steps": 9,
                                 "not_a_field": 1})
    assert cfg.batch_size == 3 and not hasattr(cfg, "max_steps")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "config", "pretrain.json")
    assert (TrainConfig.from_json(path).to_dict()
            == JTrainConfig.from_json(path).to_dict())


@pytest.mark.parametrize("extra", [{}, dict(qkv_bias=True, use_qk_norm=True,
                                            tie_embeddings=False)])
def test_decay_mask_equals_the_jax_mask(extra):
    cfg = dict(TINY, **extra)
    jp = jgpt.init_params(jax.random.PRNGKey(0), JModelConfig(**cfg))
    tp = tgpt.init_params(torch.Generator().manual_seed(0),
                          ModelConfig(**cfg), device="cpu")
    want, got = jtrainer._decay_mask(jp), ttrainer._decay_mask(tp)
    assert dict(_flat(want)) == dict(_flat(got))
    assert got["blocks"]["attn_norm"] is False and got["blocks"]["wq"] is True


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_five_steps_with_accumulation_follow_the_jax_trainer(
        corpus_shards, tmp_path, mu_dtype):
    """Same carried-over parameters, same batches (same files and seed),
    accumulation 2, clipping and weight decay on.  f32 losses within 1e-4
    relative.  Parameters: AdamW moves every element by about lr per step
    whatever its gradient's size, so an element whose gradient is near
    zero can land up to a few lr apart when the two frameworks' f32 sums
    differ in the last bits; all elements stay within 1e-5 here (with the
    bf16 first moment, whose rounding can flip, within 1e-4)."""
    over = dict(gradient_accumulation_steps=2, adam_mu_dtype=mu_dtype)
    jt = jtrainer.Trainer(TINY, _tc(corpus_shards, tmp_path / "j", **over),
                          max_steps=5)
    jt.init()
    jt.load_data()
    start = jax.tree.map(np.array, jt.params)
    pt = _port_trainer(_tc(corpus_shards, tmp_path / "t", **over), 5)
    pt.params = params_from_jax(start, "cpu", trainable=True)
    pt.opt = ttrainer.AdamW(pt.train_config, pt.params)
    jt.start()
    pt.start()
    assert [s for s, _ in pt.loss_history] == [1, 2, 3, 4, 5]
    for (_, jl), (_, tl) in zip(jt.loss_history, pt.loss_history):
        assert abs(tl - jl) <= 1e-4 * abs(jl), (jt.loss_history,
                                                pt.loss_history)
    assert pt.loss_history[-1][1] < pt.loss_history[0][1]
    tol = 1e-5 if mu_dtype is None else 1e-4
    moved = 0.0
    for (path, w), (_, g), (_, s) in zip(
            _flat(jax.tree.map(np.asarray, jt.params)),
            _flat(params_to_numpy(pt.params)), _flat(start)):
        assert np.abs(g - w).max() <= tol, (path, np.abs(g - w).max())
        moved = max(moved, np.abs(g - s).max())
    assert moved > 1e-3                      # and they did move
    assert pt.opt.count == 5
    assert pt.opt.mu[0].dtype == (torch.bfloat16 if mu_dtype
                                  else torch.float32)


@pytest.mark.parametrize("over", [
    dict(), dict(adam_mu_dtype="bfloat16", remat=True, remat_policy="ffn",
                 gradient_accumulation_steps=2)],
    ids=["plain", "bf16_mu_ffn_remat_accum"])
def test_resume_reproduces_the_next_losses_exactly(corpus_shards, tmp_path,
                                                   over):
    whole = _port_trainer(_tc(corpus_shards, tmp_path / "a", **over), 6)
    whole.start()
    first = _port_trainer(_tc(corpus_shards, tmp_path / "b", **over), 4,
                          ckpt_filename="r.npz")
    first.start()
    ck = str(tmp_path / "b" / "r.npz")
    assert os.path.exists(ck)
    second = ttrainer.Trainer(
        TINY, _tc(corpus_shards, tmp_path / "c", from_checkpoint=ck, **over),
        max_steps=6, is_continued_pretrain=True, device="cpu")
    second.init()
    assert second.step_count == 4 and second.opt.count == 4
    for a, b in zip(first.opt.mu + first.opt.nu,
                    second.opt.mu + second.opt.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)
    second.load_data()
    second.start()
    assert second.step_count == 6
    assert second.loss_history == whole.loss_history[4:]   # bit for bit
    for (_, a), (_, b) in zip(tgpt.param_leaves(whole.params),
                              tgpt.param_leaves(second.params)):
        assert torch.equal(a, b)
    # without the replay the stream restarts, as in the JAX package
    third = ttrainer.Trainer(
        TINY, _tc(corpus_shards, tmp_path / "d", from_checkpoint=ck, **over),
        max_steps=5, device="cpu")
    third.init()
    third.load_data()
    third.start()
    assert third.loss_history[0][1] != whole.loss_history[4][1]


@pytest.mark.parametrize("leaf_dtype", ["float32", "bfloat16"])
def test_params_checkpoints_cross_between_the_packages(tmp_path, leaf_dtype):
    cfg = dict(TINY, use_qk_norm=True, tie_embeddings=False)
    jdt = jnp.float32 if leaf_dtype == "float32" else jnp.bfloat16
    jp = jgpt.init_params(jax.random.PRNGKey(1), JModelConfig(**cfg),
                          param_dtype=jdt)
    meta = dict(step=7, model_config=cfg, train_config={"batch_size": 2},
                tokenizer_config=None)
    # JAX -> port
    pj = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(pj, params=jp, **meta)
    ck = tckpt.Checkpoint(pj)
    assert ck.step == 7 and ck.model_config == cfg and ck.meta["is_lora"] is False
    assert not ck.has("opt")
    loaded = ck.load_params()
    want = dict(_flat(jax.tree.map(np.asarray, jp)))
    got = dict(_flat(params_to_numpy(loaded)))
    assert sorted(want) == sorted(got)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert np.array_equal(got[path].view(np.uint8),
                              want[path].view(np.uint8)), path
    # port -> JAX
    pt = str(tmp_path / "t.npz")
    tckpt.save_checkpoint(pt, params=loaded, **meta)
    assert sorted(np.load(pt).files) == sorted(np.load(pj).files)
    back = jckpt.Checkpoint(pt)
    assert back.meta == jckpt.Checkpoint(pj).meta
    again = back.load_params(jp)
    for (path, a), (_, b) in zip(_flat(jax.tree.map(np.asarray, again)),
                                 _flat(jax.tree.map(np.asarray, jp))):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def test_eval_gated_checkpoints_and_the_log_lines(corpus_shards, tmp_path,
                                                  capsys):
    tc = _tc(corpus_shards, tmp_path, eval_interval=2, eval_iters=2)
    t = _port_trainer(tc, 5, ckpt_filename="e.npz")
    seen = []
    save = t.save_checkpoint
    t.save_checkpoint = lambda *a: seen.append(t.step_count) or save(*a)
    t.start()
    # eval at steps 2 and 4 (never at the start step); saved when the val
    # loss improved, and once more at the end
    assert seen[-1] == 5 and set(seen) <= {2, 4, 5} and 2 in seen
    out = capsys.readouterr().out
    assert len(re.findall(r"Step \d+ \| Eval \| TrainLoss: \d+\.\d{4} \| "
                          r"ValLoss: \d+\.\d{4}", out)) == 2
    assert len(re.findall(r"Epoch: \d+ \| Step: \d+ \| Loss: \d+\.\d{4} \| "
                          r"\d+ ms/step, \d+\.\d GFLOP/s, \d+ tokens/s",
                          out)) == 5
    assert "training: batch=8 accum=1 tokens/step=256" in out
    assert "training finished" in out
    assert t.log_file and os.path.exists(t.log_file)
    assert "Loss:" in open(t.log_file).read()
    assert t.best_val_loss < float("inf")
    ck = tckpt.Checkpoint(str(tmp_path / "e.npz"))
    assert ck.step == 5 and ck.has("opt") and ck.tokenizer_config
    assert ck.train_config["eval_interval"] == 2


@pytest.mark.parametrize("over,match", [
    (dict(use_lora=True), "LoRA"),
    (dict(mesh_shape={"pipe": 2, "model": 2}),
     "pipeline parallelism composes with data parallelism only"),
])
def test_trainer_refuses_what_is_not_ported(corpus_shards, tmp_path, over,
                                            match):
    t = ttrainer.Trainer(TINY, _tc(corpus_shards, tmp_path, **over),
                         max_steps=1, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        t.init()


SFT_JSONL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "dataset", "sft_sample.jsonl")


@pytest.fixture(scope="module")
def sft_shards(tmp_path_factory):
    """dataset/sft_sample.jsonl through each package's generate_sft_dataset
    with the corpus tokenizer of `corpus_shards`' text plus the sample's
    characters, at TINY's block size: (tokenizer path, port shards, JAX
    shards)."""
    from nano_tpu.data import preprocess as jpre
    from nano_tpu.tokenizer.trie import TrieTokenizer as JTrieTokenizer
    d = tmp_path_factory.mktemp("sft")
    with open(SFT_JSONL, encoding="utf-8") as f:
        text = f.read()
    tok = TrieTokenizer()
    tok.build_from_text(CORPUS + text)
    tok_path = str(d / "tok.json")
    tok.dump_config_file(tok_path)
    jtok = JTrieTokenizer.from_file(tok_path)
    block = 4 * TINY["block_size"]
    port = preprocess.generate_sft_dataset([SFT_JSONL], tok, block,
                                           str(d / "t"))
    jax_ = jpre.generate_sft_dataset([SFT_JSONL], jtok, block, str(d / "j"))
    return tok_path, port, jax_, tok.vocab_size


@pytest.mark.parametrize("policy", ["dots", "heads"])
def test_sft_steps_follow_the_jax_trainer(sft_shards, tmp_path, policy):
    """Full SFT as config/sft.json runs it (from a checkpoint, masked loss,
    accumulation 2, remat) under each selective remat policy, on the port's
    shards for the port and the JAX package's for the JAX Trainer (the same
    arrays): 4 steps from the same checkpoint, f32 losses within 1e-4
    relative, as the 5-step pretrain trajectory above."""
    tok_path, port, jax_, V = sft_shards
    for a, b in zip(port, jax_):
        pa, pb = np.load(a), np.load(b)
        assert all(np.array_equal(pa[k], pb[k]) for k in ("ids", "mask"))
    cfg = dict(TINY, vocab_size=max(V, TINY["vocab_size"]),
               block_size=4 * TINY["block_size"])
    jp = jax.tree.map(np.asarray, jgpt.init_params(jax.random.PRNGKey(3),
                                                   JModelConfig(**cfg)))
    ck = str(tmp_path / "base.npz")
    jckpt.save_checkpoint(ck, params=jp, step=2, model_config=cfg,
                          train_config={}, tokenizer_config=None)
    over = dict(from_checkpoint=ck, gradient_accumulation_steps=2,
                remat=True, remat_policy=policy, batch_size=4)
    jt = jtrainer.Trainer(cfg, dict(_tc((tok_path, *jax_), tmp_path / "j"),
                                    **over), max_steps=6)
    jt.init()
    jt.load_data()
    jt.start()
    pt = ttrainer.Trainer(cfg, dict(_tc((tok_path, *port), tmp_path / "t"),
                                    **over), max_steps=6, device="cpu")
    pt.init()
    assert pt.step_count == 2
    pt.load_data()
    pt.start()
    assert [s for s, _ in pt.loss_history] == [3, 4, 5, 6]
    for (_, jl), (_, tl) in zip(jt.loss_history, pt.loss_history):
        assert abs(tl - jl) <= 1e-4 * abs(jl), (jt.loss_history,
                                                pt.loss_history)


def test_one_device_mesh_shape_is_accepted(corpus_shards, tmp_path):
    t = ttrainer.Trainer(TINY, _tc(corpus_shards, tmp_path,
                                   mesh_shape={"data": 1}),
                         max_steps=1, device="cpu")
    t.init()
    assert t.opt is not None


def test_entry_point_trains_on_the_cpu_when_asked(corpus_shards, tmp_path,
                                                  capsys):
    import json
    mc, tc = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    with open(mc, "w") as f:
        json.dump({"model_config": TINY}, f)
    with open(tc, "w") as f:
        json.dump(dict(_tc(corpus_shards, tmp_path / "out"), max_steps=50), f)
    train_main.main(["-m", mc, "-t", tc, "--max_steps", "2",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Step: 2" in out and "Step: 3" not in out
    ck = str(tmp_path / "out" / "checkpoint.npz")
    train_main.main(["-m", mc, "-t", json_with(tc, from_checkpoint=ck),
                     "-c", "--max_steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "replaying 2 batches" in out and "Step: 3" in out


def json_with(path, **over):
    import json
    with open(path) as f:
        d = json.load(f)
    d.update(over)
    out = path + ".2.json"
    with open(out, "w") as f:
        json.dump(d, f)
    return out
