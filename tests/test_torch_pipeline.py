"""Pipeline parallelism in the port against the JAX package on the CPU.

The port's ranks are four gloo processes (``parallel.launch``; rank
functions in tests/torch_parallel_ranks.py, which imports no jax), the
JAX Trainer runs its GPipe ``make_pp_loss`` on the conftest's 8-device
virtual CPU mesh.  One group of ranks runs every training check of the
file on {"data": 2, "pipe": 2} (a 4-layer model, two layers a stage):
three steps from the same checkpoint as the JAX Trainer on the same mesh
with pp_microbatches 0 (``default_n_micro``: 2 of a data rank's 2 rows)
and 1, and with remat "dots" and ce_chunk; two steps, a save and a
resumed third step.  The microbatch count, remat and chunked CE change
only the f32 summation order, so every run is held to the JAX Trainer's
run with pp_microbatches 0: losses within 1e-5 relative, params within
1e-5 of max|param|, the resume bit for bit.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.io import checkpoint as jckpt
from nano_tpu.models import gpt as jgpt
from nano_tpu.parallel import pipeline as jpipeline
from nano_tpu.train import trainer as jtrainer
from nano_tpu_torch.data import preprocess
from nano_tpu_torch.parallel import launch
from nano_tpu_torch.parallel import pipeline as tpipeline
from nano_tpu_torch.tokenizer.trie import TrieTokenizer
from tests.test_torch_parallel import (CLIP, CORPUS, ROOT, SFT_JSONL, TINY,
                                       _flat, _npz_params, _tc)

PP_TINY = dict(TINY, n_layer=4)
MESH = {"data": 2, "pipe": 2}
STEPS = 3
# the port's runs held to the JAX Trainer's: name -> train config changes
RUNS = {"micro0": {}, "micro1": dict(pp_microbatches=1),
        "remat_chunk": dict(remat=True, remat_policy="dots", ce_chunk=96)}


def test_default_n_micro_equals_jax():
    for n_pipe in (1, 2, 3, 4, 8):
        for b in range(1, 40):
            assert tpipeline.default_n_micro(n_pipe, b) == \
                jpipeline.default_n_micro(n_pipe, b), (n_pipe, b)


def test_pp_param_specs_cut_the_layer_axis_as_jax():
    jp = jgpt.init_params(jax.random.PRNGKey(0), JModelConfig(
        **dict(PP_TINY, use_rope=False, tie_embeddings=False)))
    want = jpipeline.pp_param_specs(jp)
    got = tpipeline.pp_param_specs(jax.tree.map(np.asarray, jp))
    flat_want = dict(_flat(jax.tree.map(
        lambda s: s, want,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))))
    flat_got = dict(_flat(got))
    assert set(flat_got) == set(flat_want) and "wpe" in flat_got
    for path, spec in flat_want.items():
        assert flat_got[path] == (0 if tuple(spec) == ("pipe",) else None), \
            path


def test_stage_layers_cut_evenly():
    assert [tpipeline.stage_layers(8, 4, p) for p in range(4)] == \
        [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="pipe=3"):
        tpipeline.stage_layers(8, 3, 0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX Trainer's 3 steps on {"data": 2, "pipe": 2} and the port
    ranks' runs."""
    d = tmp_path_factory.mktemp("pp")
    with open(SFT_JSONL, encoding="utf-8") as f:
        text = f.read()
    tok = TrieTokenizer()
    tok.build_from_text(CORPUS + text)
    tok_path = str(d / "tok.json")
    tok.dump_config_file(tok_path)
    shards = preprocess.generate_sft_dataset([SFT_JSONL], tok,
                                             PP_TINY["block_size"],
                                             str(d / "s"))
    cfg = dict(PP_TINY, vocab_size=max(tok.vocab_size,
                                       PP_TINY["vocab_size"]))
    start = jax.tree.map(np.asarray, jgpt.init_params(
        jax.random.PRNGKey(5), JModelConfig(**cfg)))
    ck0 = str(d / "start.npz")
    jckpt.save_checkpoint(ck0, params=start, step=0, model_config=cfg,
                          train_config={}, tokenizer_config=tok.config)
    tc = lambda sub, **o: _tc(d / sub, shards, tok_path, mesh_shape=MESH,
                              **o)

    jt = jtrainer.Trainer(cfg, tc("j", from_checkpoint=ck0),
                          max_steps=STEPS)
    jt.init()
    assert dict(zip(jt.mesh.axis_names, jt.mesh.devices.shape)) == \
        dict(MESH, model=1)
    jt.load_data()
    jt.start()

    runs = [dict(train_config=tc(name, from_checkpoint=ck0, **over),
                 max_steps=STEPS, ckpt_filename=f"{name}.npz")
            for name, over in RUNS.items()]
    runs += [dict(train_config=tc("first", from_checkpoint=ck0),
                  max_steps=STEPS - 1, ckpt_filename="first.npz"),
             dict(train_config=tc("resume", from_checkpoint=str(
                 d / "first" / "first.npz")), max_steps=STEPS,
                  ckpt_filename="resume.npz", continued=True)]
    ranks = launch.run("tests.torch_parallel_ranks:train", 4,
                       args=(cfg, runs), device="cpu", threads=1)
    return dict(jax=jt, ranks=ranks, dir=d, cfg=cfg, start=start,
                shards=shards, tok_path=tok_path)


@pytest.mark.parametrize("name", list(RUNS))
def test_pp_losses_follow_the_jax_trainer_on_the_same_mesh(trained, name):
    """Three steps' losses within 1e-5 relative of the JAX Trainer's;
    every rank (both stages) logs the same losses; the clip acted."""
    i = list(RUNS).index(name)
    jl = [l for _, l in trained["jax"].loss_history]
    for rank in trained["ranks"]:
        hist, norm, shape = rank[i]
        assert shape == dict(MESH, model=1)
        assert [s for s, _ in hist] == [1, 2, 3]
        for (_, tl), want in zip(hist, jl):
            assert abs(tl - want) <= 1e-5 * abs(want), (hist, jl)
        assert norm > CLIP


@pytest.mark.parametrize("name", list(RUNS))
def test_pp_params_follow_the_jax_trainer(trained, name):
    """Every gathered parameter (the stages' layers put together, the
    replicated leaves' gradients summed over the stages) within 1e-5 of
    max|param| of the JAX Trainer's, and every one moved."""
    want = dict(_flat(jax.tree.map(np.asarray, trained["jax"].params)))
    got = _npz_params(str(trained["dir"] / name / f"{name}.npz"))
    start = dict(_flat(trained["start"]))
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        assert np.abs(got[path] - w).max() <= 1e-5 * scale, path
        assert np.abs(got[path] - start[path]).max() > 0, path


def test_pp_resume_on_the_same_mesh_is_bit_exact(trained):
    full, first, resume = (trained["ranks"][0][i][0]
                           for i in (0, len(RUNS), len(RUNS) + 1))
    assert resume == full[STEPS - 1:] and first == full[:STEPS - 1]
    a = np.load(str(trained["dir"] / "micro0" / "micro0.npz"))
    b = np.load(str(trained["dir"] / "resume" / "resume.npz"))
    keys = [k for k in a.files if k != "__meta__"]
    assert set(keys) == {k for k in b.files if k != "__meta__"}
    assert any(k.startswith("opt/mu/blocks") for k in keys)
    for k in keys:
        assert np.array_equal(a[k], b[k]), k


def test_pp_checkpoint_crosses_to_the_jax_package(trained):
    """The port's pipeline checkpoint holds the whole params (every
    layer) in the JAX layout: the JAX package loads them as the port
    reads them; the start checkpoint the runs resumed from was the JAX
    package's."""
    path = str(trained["dir"] / "micro0" / "micro0.npz")
    cfg = JModelConfig(**trained["cfg"])
    like = jax.eval_shape(lambda k: jgpt.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    jp = jckpt.Checkpoint(path).load_params(like)
    got = _npz_params(path)
    for p, leaf in _flat(jax.tree.map(np.asarray, jp)):
        assert np.array_equal(leaf, got[p]), p
    assert got["blocks/wq"].shape[0] == PP_TINY["n_layer"]
    assert jckpt.Checkpoint(path).step == STEPS


@pytest.mark.parametrize("shape", [{"pipe": 2}, {"seq": 2}])
def test_pipe_and_seq_meshes_train_through_torchrun(trained, tmp_path, shape):
    """python -m nano_tpu_torch.train under torchrun's environment (two
    CPU ranks, gloo): {"pipe": 2} with 2 microbatches and {"seq": 2}, one
    step from the same checkpoint, give the JAX Trainer's first loss on
    {"data": 2, "pipe": 2} (the same batch and model)."""
    d = trained["dir"]
    mc = str(tmp_path / "m.json")
    with open(mc, "w") as f:
        json.dump(trained["cfg"], f)
    tc = str(tmp_path / "t.json")
    with open(tc, "w") as f:
        json.dump(_tc(tmp_path / "out", trained["shards"],
                      trained["tok_path"], mesh_shape=shape,
                      pp_microbatches=2 if "pipe" in shape else 0,
                      from_checkpoint=str(d / "start.npz")), f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(launch.free_port()), "-m",
         "nano_tpu_torch.train", "-m", mc, "-t", tc, "--max_steps", "1",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    axis = next(iter(shape))
    assert f"mesh: {{'data': 1, '{axis}': 2, 'model': 1}} over gloo" in \
        out.stdout
    lines = [ln for ln in out.stdout.splitlines() if "| Loss: " in ln]
    assert len(lines) == 1, out.stdout
    loss = float(lines[0].split("| Loss: ")[1].split()[0])
    want = trained["jax"].loss_history[0][1]
    assert abs(loss - want) <= 1e-4 * want
