"""The synthetic problems of the port (nano_tpu_torch.problems) and the
full-sequence decoders (engine.seq2seq, engine.denoise_generate) against
the JAX package on the CPU.

Datasets are array-equal (one random.Random(seed) stream in the same order,
uint16 ids, uint8 masks; the shard files byte-equal); every task's
eval_batch gives the JAX accuracy on the same weights (carried across with
params_from_jax); a short run_problem follows the JAX run's logged losses
within 1e-4 relative (f32, the same initial weights: the port's
init_params is patched to JAX's draw, whose numbers torch.Generator cannot
give); seq2seq gives the JAX tokens, and denoise_generate at top_k = 1
(each draw the argmax: no random stream involved) too."""

import contextlib
import io
import os
import random
import re
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_tpu import problems as jproblems
from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.infer import engine as jengine
from nano_tpu.models import gpt as jgpt
from nano_tpu_torch import problems as tproblems
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.infer import engine as tengine
from nano_tpu_torch.io.from_jax import params_from_jax
from nano_tpu_torch.models import gpt as tgpt

TASKS = ["q", "sort", "palindrome", "calculator"]


def _jax_params(mc, seed):
    return jax.tree.map(np.asarray, jgpt.init_params(
        jax.random.PRNGKey(seed), JModelConfig(**mc)))


def test_q_function_equals_the_jax_function():
    for n in list(range(0, 200)) + [888, 2024, 11111111, 98765432]:
        for digits in (1, 3, 4, 8):
            assert (tproblems.q_function(n, digits)
                    == jproblems.q_function(n, digits))


@pytest.mark.parametrize("task", TASKS)
def test_problem_definitions_match(task):
    kw = dict(n_layer=3) if task == "q" else {}
    t = tproblems.make_problem(task, 5, **kw)
    j = jproblems.make_problem(task, 5, **kw)
    assert t.model_config == j.model_config
    assert t.tokenizer.config == j.tokenizer.config
    assert t.is_causal == j.is_causal
    for seed in range(20):
        assert (t.gen_sample(random.Random(seed))
                == j.gen_sample(random.Random(seed)))


def test_unknown_task_is_refused():
    with pytest.raises(ValueError, match="unknown task"):
        tproblems.make_problem("chess")


@pytest.mark.parametrize("task", TASKS)
def test_datasets_are_the_jax_arrays(task, tmp_path):
    t = tproblems.make_problem(task, 4)
    j = jproblems.make_problem(task, 4)
    got = tproblems.generate_dataset(t, str(tmp_path / "t"), 300, 40, seed=7)
    want = jproblems.generate_dataset(j, str(tmp_path / "j"), 300, 40, seed=7)
    for a, b in zip(got, want):
        assert os.path.basename(a) == os.path.basename(b)
        za, zb = np.load(a), np.load(b)
        assert za.files == zb.files
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            assert np.array_equal(za[k], zb[k])
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    ids = np.load(got[0])["ids"]
    assert ids.dtype == np.uint16 and ids.shape[0] == 300
    assert ("mask" in np.load(got[0]).files) == (task in ("q", "calculator"))


@pytest.mark.parametrize("task", TASKS)
def test_eval_batch_equals_the_jax_evaluation(task):
    """Random weights (N(0, 0.02) as JAX draws them, the norms at 1) put
    the prediction near a constant; scaled up 20x the logits spread, so
    the accuracy depends on every position's argmax."""
    t = tproblems.make_problem(task, 4)
    j = jproblems.make_problem(task, 4)
    tree = jax.tree.map(lambda a: a * 20.0 if a.ndim > 1 else a,
                        _jax_params(j.model_config, 11))
    jcfg = JModelConfig(**j.model_config)
    tcfg = ModelConfig(**t.model_config)
    for seed in (1, 2):
        want = j.eval_batch(jax.tree.map(jnp.asarray, tree), jcfg,
                            j.tokenizer, random.Random(seed), 200)
        got = t.eval_batch(params_from_jax(tree, "cpu"), tcfg, t.tokenizer,
                           random.Random(seed), 200)
        assert got == want


def _losses(out):
    return [float(x) for x in re.findall(r"\| Loss: (\d+\.\d+)", out)]


@pytest.mark.parametrize("task,kw", [
    ("sort", dict(seq_length=4, max_steps=30, batch_size=32)),
    ("calculator", dict(max_steps=20, batch_size=16, expr_max_length=32,
                        n_layer=2))])
def test_short_run_follows_the_jax_run(task, kw, tmp_path, monkeypatch):
    seed = 5
    common = dict(n_train=400, n_val=40, n_eval=50, learning_rate=2e-3,
                  dtype="float32", seed=seed)
    extra = {k: kw.pop(k) for k in ("expr_max_length",) if k in kw}
    if extra:
        # the expression length is make_problem's, not run_problem's
        for mod in (jproblems, tproblems):
            orig = mod.make_problem
            monkeypatch.setattr(mod, "make_problem",
                                lambda task_, seq_, _o=orig, **m:
                                _o(task_, seq_, **extra, **m))

    def jax_init(rng, cfg, param_dtype=torch.float32, device=None):
        tree = _jax_params(cfg.to_dict(), seed)
        return params_from_jax(tree, device, trainable=True)
    monkeypatch.setattr(tgpt, "init_params", jax_init)
    outs = []
    for mod, d, dev in ((jproblems, "j", {}), (tproblems, "t",
                                                {"device": "cpu"})):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            acc = mod.run_problem(task, str(tmp_path / d), **common, **kw,
                                  **dev)
        outs.append((acc, _losses(out.getvalue())))
    (ja, jl), (ta, tl) = outs
    assert len(tl) == len(jl) >= 2
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-4 * b + 1e-4, (tl, jl)   # 4 printed decimals
    assert abs(ta - ja) <= 0.05, (ta, ja)


def test_run_problem_exports_a_model_the_engine_serves(tmp_path):
    """export_bin writes the trained sort model as an f32 .bin; served by
    from_bin (a .bin header carries no is_causal: set back from the
    problem), seq2seq gives the eval_batch argmaxes."""
    binp = str(tmp_path / "sort.bin")
    tproblems.run_problem("sort", str(tmp_path), seq_length=4,
                          max_steps=20, batch_size=32, n_train=300, n_val=30,
                          n_eval=20, dtype="float32", export_bin=binp,
                          device="cpu")
    ctx = tengine.LLMContext.from_bin(binp, device="cpu", dtype=torch.float32)
    ctx.cfg = replace(ctx.cfg, is_causal=False)
    tok = ctx.tokenizer
    ids = tok.encode("3141")
    logits = tgpt.forward(ctx.params, torch.tensor([ids]), ctx.cfg,
                          dtype=torch.float32)
    assert tengine.seq2seq(ctx, ids) == logits[0].argmax(-1).tolist()


def test_entry_point_prints_the_root_line(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tproblems.main(["sort", "--steps", "10", "--batch", "16",
                        "--seq_length", "3", "--n_train", "200",
                        "--n_eval", "20", "--out_dir", str(tmp_path),
                        "--n_layer", "1", "--device", "cpu"])
    last = out.getvalue().strip().splitlines()[-1]
    assert re.fullmatch(r"sort: exact-match accuracy \d+\.\d% \(artifacts "
                        r"in .*\)", last), last
    assert os.path.exists(tmp_path / "problem_sort.npz")


# =====================================================================
# seq2seq and denoise_generate on carried weights
# =====================================================================

GLOBAL = dict(block_size=12, vocab_size=40, n_layer=2, n_embd=32, n_head=4,
              n_kv_head=2, n_hidden=64, use_rope=True, is_causal=False)
LEARNED = dict(GLOBAL, use_rope=False, n_head=2)
CAUSAL = dict(GLOBAL, is_causal=True)
LEARNED_CAUSAL = dict(LEARNED, is_causal=True)


def _contexts(mc, lora_rank=0):
    tok = jproblems._digit_tokenizer()
    tree = jax.tree.map(lambda a: a * 10.0 if a.ndim > 1 else a,
                        _jax_params(mc, 21))
    jctx = jengine.LLMContext(cfg=JModelConfig(**mc),
                              params=jax.tree.map(jnp.asarray, tree),
                              tokenizer=tok, max_seq_len=mc["block_size"],
                              dtype=jnp.float32, random_seed=3)
    tctx = tengine.LLMContext(cfg=ModelConfig(**mc),
                              params=params_from_jax(tree, "cpu"),
                              tokenizer=tproblems._digit_tokenizer(),
                              max_seq_len=mc["block_size"], device="cpu",
                              dtype=torch.float32, random_seed=3)
    if lora_rank:
        rng = np.random.RandomState(2)
        L, E, D = mc["n_layer"], mc["n_embd"], mc["n_embd"] // mc["n_head"]
        KV = mc["n_kv_head"] * D
        lora = {}
        for name, inn, out in (("wq", E, E), ("wk", E, KV), ("wv", E, KV),
                               ("wo", E, E)):
            lora[name + "_a"] = rng.randn(L, inn, lora_rank).astype(
                np.float32) * 0.3
            lora[name + "_b"] = rng.randn(L, lora_rank, out).astype(
                np.float32) * 0.3
        jctx.lora = {k: jnp.asarray(v) for k, v in lora.items()}
        jctx.lora_scale = 2.0
        tctx.lora = {k: torch.from_numpy(v) for k, v in lora.items()}
        tctx.lora_scale = 2.0
    return jctx, tctx


@pytest.mark.parametrize("mc,lora_rank", [(GLOBAL, 0), (LEARNED, 0),
                                          (GLOBAL, 4), (CAUSAL, 0)],
                         ids=["global", "learned_pos", "lora", "causal"])
def test_seq2seq_gives_the_jax_tokens(mc, lora_rank):
    jctx, tctx = _contexts(mc, lora_rank)
    rng = np.random.RandomState(8)
    for n in (1, 5, mc["block_size"]):
        ids = rng.randint(0, mc["vocab_size"], n).tolist()
        assert tengine.seq2seq(tctx, ids) == jengine.seq2seq(jctx, ids)


@pytest.mark.parametrize("mc,lora_rank", [(LEARNED, 0), (LEARNED_CAUSAL, 0),
                                          (LEARNED, 4)],
                         ids=["global", "causal", "lora"])
@pytest.mark.parametrize("threshold", [0.9, 0.2])
@pytest.mark.parametrize("prompt_len", [0, 3, 11, 20])
def test_denoise_generate_top1_gives_the_jax_tokens(mc, lora_rank, threshold,
                                                    prompt_len):
    """Blocks of 12 (the prompt's tail keeps at most 11: one position is
    always left), new tokens across three blocks; a threshold no position
    reaches (one unmasked a round, the most confident) and one that
    several do.  The rounds' blocks must match too.  Learned positions:
    with RoPE an all-mask block gives every masked position the same
    confidence up to f32 rounding (only relative positions enter the
    scores), and the fallback's pick is then a rounding tie."""
    jctx, tctx = _contexts(mc, lora_rank)
    prompt = np.random.RandomState(prompt_len).randint(
        0, mc["vocab_size"], prompt_len).tolist()
    seen = {"j": [], "t": []}
    want = jengine.denoise_generate(
        jctx, prompt, 25, top_k=1, confidence_threshold=threshold,
        callback=lambda x: seen["j"].append(np.asarray(x).copy()))
    got = tengine.denoise_generate(
        tctx, prompt, 25, top_k=1, confidence_threshold=threshold,
        callback=lambda x: seen["t"].append(x.copy()))
    assert got == want and len(got) == prompt_len + 25
    assert len(seen["t"]) == len(seen["j"])
    for a, b in zip(seen["t"], seen["j"]):
        assert np.array_equal(a, b)


def test_denoise_generate_sampled_is_reproducible_and_in_the_top_k():
    """top_k > 1 draws from the renormalized top k with the context's
    torch.Generator (not the JAX engine's jax.random stream): the same
    seed gives the same tokens, and every unmasked token is one of its
    position's top k at that round."""
    _, tctx = _contexts(GLOBAL)
    a = tengine.denoise_generate(tctx, [1, 2], 20, top_k=3,
                                 confidence_threshold=0.5)
    b = tengine.denoise_generate(tctx, [1, 2], 20, top_k=3,
                                 confidence_threshold=0.5)
    assert a == b and len(a) == 22
    assert max(a) < GLOBAL["vocab_size"]
