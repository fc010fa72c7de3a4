"""LoRA under tensor parallelism in the port against the JAX package on
the CPU.

The port's ranks are two gloo processes (``parallel.launch``; rank
functions in tests/torch_parallel_ranks.py, which imports no jax) at TP
= 2, where a rank holds the B of q, k and v on its heads' columns and
wo's A on its heads' rows, and sums wo's branch over the model group; the
JAX package replicates the adapter over the conftest's virtual CPU mesh
and lets GSPMD cut the products.  One group of ranks runs every check of
the file: the f32 and Q80 models of tests/test_torch_infer_tp.py (Q80:
NANO_TPU_DEQUANT=f32 on the JAX side) with two adapters of ranks 2 and 4
(tests/test_torch_lora.py's), greedy streams with an adapter attached
after and before the shard, a swap, an unload, a clone, a LoRA
checkpoint's adapter and speculation, each token-identical to the JAX
package's sharded context's; per-slot adapters in BatchedEngine equal to
the JAX engine's on a sharded context; then a LoRA fine-tune at {"model":
2} from the JAX Trainer's fresh adapter, three steps against the JAX
Trainer on the same mesh (losses within 1e-5 relative, the adapter within
1e-5 of max|adapter|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.infer import engine as jengine
from nano_tpu.io import binfmt as jbinfmt
from nano_tpu.io import checkpoint as jckpt
from nano_tpu.models import gpt as jgpt
from nano_tpu.parallel import mesh as jmesh
from nano_tpu.serve import batching as jbatching
from nano_tpu.train import trainer as jtrainer
from nano_tpu_torch.data import preprocess
from nano_tpu_torch.io import checkpoint as tckpt
from nano_tpu_torch.parallel import launch
from nano_tpu_torch.tokenizer.trie import TrieTokenizer
from tests.test_torch_infer_tp import (JSAMP, TINY as SERVE_TINY,
                                       jax_f32_dequant, write_model)
from tests.test_torch_lora import random_lora
from tests.test_torch_parallel import CORPUS, SFT_JSONL, TINY, _tc

MESH = {"data": 1, "model": 2}
JOINS = [("abcdef", "a"), ("ghijk", None), ("abcabcabc", "b"),
         ("lmnopq", "a"), ("rstu", "b")]
LORA = dict(use_lora=True, lora_rank=4, lora_alpha=8)
STEPS = 3


def _jax_ctx(path, lora=None, **kw):
    """The JAX package's context of `path` with the adapter `lora`,
    sharded at TP = 2 (the adapter replicated)."""
    ctx = jengine.LLMContext.from_bin(path, max_seq_len=64,
                                      dtype=jnp.float32, sampler=JSAMP, **kw)
    if lora:
        ctx.load_lora(lora)
    return ctx.shard(jmesh.make_mesh(n_data=4, n_model=2))


def _jax_greedy(ctx, prompt="abcdef", n=12):
    session = jengine.Session(ctx, prompt, max_new_tokens=n)
    out = []
    while (t := session.step()) is not None:
        out.append(t)
    return out


def _jax_batched(ctx, adapters, n=10):
    be = jbatching.BatchedEngine(ctx, n_slots=4, adapters=adapters)
    got, live = {}, {}

    def join(i):
        prompt, name = JOINS[i]
        slot, first = be.add(ctx.encode(prompt), max_new_tokens=n,
                             temperature=0.0, repetition_penalty=1.0,
                             adapter=name)
        got[i], live[slot] = [first], i

    for i in range(4):
        join(i)
    while be.n_active:
        res = be.step_burst(2)
        for slot, toks in res.items():
            got[live[slot]].extend(toks)
        for slot in [s for s, e in res.ended.items() if e]:
            del live[slot]
            be.release(slot)
            if 4 not in got:
                join(4)
    return got


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora_tp")
    files = {"f32": write_model(d, "f32", SERVE_TINY, "f32", 32),
             "q80": write_model(d, "q80", SERVE_TINY, "q80", 32)}
    jcfg = JModelConfig(**SERVE_TINY)
    adapters = {}
    for name, rank, alpha, seed in (("a", 2, 4, 0), ("b", 4, 8, 1)):
        adapters[name] = random_lora(jcfg, rank, seed)
        files[name] = str(d / f"lora_{name}.bin")
        jbinfmt.write_lora(files[name], adapters[name], jcfg, rank=rank,
                           alpha=alpha)
    files["ckpt"] = str(d / "lora_ckpt.npz")
    jckpt.save_checkpoint(files["ckpt"], lora=adapters["b"], step=2,
                          model_config=SERVE_TINY,
                          train_config={"lora_rank": 4, "lora_alpha": 8})

    # the LoRA fine-tune: tests/test_torch_parallel.py's SFT shards and
    # start checkpoint, the JAX Trainer's fresh adapter on both sides
    with open(SFT_JSONL, encoding="utf-8") as f:
        text = f.read()
    tok = TrieTokenizer()
    tok.build_from_text(CORPUS + text)
    tok_path = str(d / "tok.json")
    tok.dump_config_file(tok_path)
    shards = preprocess.generate_sft_dataset([SFT_JSONL], tok,
                                             TINY["block_size"], str(d / "s"))
    cfg = dict(TINY, vocab_size=max(tok.vocab_size, TINY["vocab_size"]))
    start = jax.tree.map(np.asarray, jgpt.init_params(
        jax.random.PRNGKey(5), JModelConfig(**cfg)))
    ck0 = str(d / "start.npz")
    jckpt.save_checkpoint(ck0, params=start, step=0, model_config=cfg,
                          train_config={}, tokenizer_config=tok.config)
    tc = lambda sub: _tc(d / sub, shards, tok_path, mesh_shape=MESH,
                         from_checkpoint=ck0, **LORA)
    jt = jtrainer.Trainer(cfg, tc("j"), max_steps=STEPS)
    jt.init()
    assert dict(zip(jt.mesh.axis_names, jt.mesh.devices.shape)) == MESH
    lora0 = jax.tree.map(np.array, jt.lora)
    jt.load_data()
    jt.start()
    runs = [dict(train_config=tc("t"), max_steps=STEPS, lora=lora0,
                 ckpt_filename="lora.npz")]

    ranks = launch.run("tests.torch_parallel_ranks:lora_tp_file", 2,
                       args=(files, JOINS, cfg, runs), device="cpu",
                       threads=1)
    want = {}
    with jax_f32_dequant():
        for name in ("f32", "q80"):
            path = files[name]
            want[f"{name}/a"] = _jax_greedy(_jax_ctx(path, files["a"]))
            want[f"{name}/b"] = _jax_greedy(_jax_ctx(path, files["b"]))
            want[f"{name}/base"] = _jax_greedy(_jax_ctx(path))
        want["spec"] = _jax_greedy(_jax_ctx(files["f32"], files["b"],
                                            spec_k=4), "abcabcabcabc", 16)
        want["batched"] = _jax_batched(_jax_ctx(files["f32"]),
                                       {"a": files["a"], "b": files["b"]})
    return dict(ranks=ranks, want=want, jax_train=jt, dir=d, lora0=lora0)


@pytest.mark.parametrize("name", ["f32", "q80"])
def test_tp_streams_with_an_adapter_equal_jax(served, name):
    """Greedy Session streams at TP = 2 on both ranks: the adapter
    attached after the shard and before it, a swap to the other adapter,
    a clone with it (the base shared), an unload and a LoRA checkpoint's
    adapter, each the JAX package's sharded stream."""
    want = served["want"]
    assert want[f"{name}/a"] != want[f"{name}/base"]
    assert want[f"{name}/b"] != want[f"{name}/a"]
    for r in served["ranks"]:
        for key, wkey in (("a", "a"), ("a_before", "a"), ("b", "b"),
                          ("b_clone", "b"), ("base", "base"),
                          ("ckpt", "b")):
            assert r[f"{name}/{key}"] == want[f"{name}/{wkey}"], key
        # generate_on_device runs its 12 steps past a stop token, where
        # the Session stops
        got = r[f"{name}/on_device"]
        assert got[:len(want[f"{name}/b"])] == want[f"{name}/b"]


def test_tp_speculation_with_an_adapter_equals_jax(served):
    for r in served["ranks"]:
        assert r["spec"] == served["want"]["spec"]


def test_tp_per_slot_adapters_in_batched_engine_equal_jax(served):
    want = served["want"]["batched"]
    assert len(want) == 5 and len({tuple(v) for v in want.values()}) > 2
    for r in served["ranks"]:
        assert r["batched"] == want


def test_tp_adapter_is_cut_on_the_heads(served):
    """A rank's adapter of rank 4: the B of q, k and v on its 2 heads and
    1 KV head of 8 values, wo's A on its heads' 16 rows; the A's of q, k,
    v and wo's B whole."""
    got = served["ranks"][0]["shapes"]
    assert got == {"wq_a": (2, 32, 4), "wq_b": (2, 4, 16),
                   "wk_a": (2, 32, 4), "wk_b": (2, 4, 8),
                   "wv_a": (2, 32, 4), "wv_b": (2, 4, 8),
                   "wo_a": (2, 16, 4), "wo_b": (2, 4, 32)}


def test_tp_lora_fine_tune_follows_the_jax_trainer(served):
    """Three LoRA steps at {"model": 2}: losses within 1e-5 relative of
    the JAX Trainer's on the same mesh on both ranks, the gathered adapter
    within 1e-5 of max|adapter| of the JAX Trainer's, every factor moved,
    and a LoRA-only checkpoint."""
    jl = [l for _, l in served["jax_train"].loss_history]
    for r in served["ranks"]:
        hist, _, shape = r["train"][0]
        assert shape == MESH and [s for s, _ in hist] == [1, 2, 3]
        for (_, tl), want in zip(hist, jl):
            assert abs(tl - want) <= 1e-5 * abs(want), (hist, jl)
    ck = tckpt.Checkpoint(str(served["dir"] / "t" / "lora.npz"))
    assert ck.is_lora and not ck.has("model") and ck.step == STEPS
    got = {k: v.float().numpy() for k, v in ck.load_lora().items()}
    want = jax.tree.map(np.asarray, served["jax_train"].lora)
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= 1e-5 * scale, k
        assert np.abs(got[k] - served["lora0"][k]).max() > 0, k
