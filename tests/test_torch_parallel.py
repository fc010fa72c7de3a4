"""The port's mesh and data- x tensor-parallel training against the JAX
package on the CPU.

The port's ranks are four gloo processes (``nano_tpu_torch.parallel.
launch``, rank functions in tests/torch_parallel_ranks.py, which imports
no jax); the JAX Trainer runs on the conftest's 8-device virtual CPU mesh.
One group of ranks runs every training check of the file (a module
fixture): mesh_shape {"data": 2, "model": 2}, SFT shards (masked loss,
mask counts that differ between the ranks' rows), accumulation 2 and the
clip active, three steps from the same checkpoint as the JAX Trainer on
the same mesh; two steps, a save and a resumed third step; f32
throughout.  The specs, the cut plans at the Qwen3-4B shapes and what the
port refuses need no group.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.io import checkpoint as jckpt
from nano_tpu.models import gpt as jgpt
from nano_tpu.parallel import mesh as jmesh
from nano_tpu.train import trainer as jtrainer
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.data import preprocess
from nano_tpu_torch.io import checkpoint as tckpt
from nano_tpu_torch.ops.q4k import Q4KTensor
from nano_tpu_torch.ops.qmatmul import Q80Tensor
from nano_tpu_torch.parallel import launch
from nano_tpu_torch.parallel import mesh as meshlib
from nano_tpu_torch.tokenizer.trie import TrieTokenizer
from nano_tpu_torch.train import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFT_JSONL = os.path.join(ROOT, "dataset", "sft_sample.jsonl")
CORPUS = "the quick brown fox jumps over the lazy dog. " * 50

TINY = dict(block_size=128, vocab_size=128, n_layer=2, n_embd=32,
            n_head=4, n_kv_head=2, n_hidden=64)
MESH = {"data": 2, "model": 2}
STEPS = 3
# a LoRA fine-tune of the start checkpoint over four data ranks
LORA = dict(mesh_shape={"data": 4}, use_lora=True, lora_rank=4,
            lora_alpha=8)
# a clip below every step's global gradient norm here, so it scales each
# update (the ranks report the last step's norm)
CLIP = 0.05


def _tc(d, shards, tok_path, **over):
    tc = dict(batch_size=4, gradient_accumulation_steps=2,
              learning_rate=1e-3, min_lr=1e-4, warmup_iters=2,
              lr_decay_iters=10, eval_interval=1000, eval_iters=1,
              log_interval=1, tokenizer_path=tok_path, grad_clip=CLIP,
              dataset_path=[list(shards)], dtype="float32",
              save_checkpoint_to=str(d), random_seed=0, mesh_shape=MESH)
    tc.update(over)
    return tc


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX Trainer's 3 steps on the mesh and the port ranks' runs:
    -> dict of both sides' losses, params and checkpoints."""
    d = tmp_path_factory.mktemp("par")
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

    jt = jtrainer.Trainer(cfg, _tc(d / "j", shards, tok_path,
                                   from_checkpoint=ck0), max_steps=STEPS)
    jt.init()
    assert dict(zip(jt.mesh.axis_names, jt.mesh.devices.shape)) == MESH
    jt.load_data()
    jt.start()

    tc = lambda sub, **o: _tc(d / sub, shards, tok_path, **o)
    runs = [dict(train_config=tc("full", from_checkpoint=ck0),
                 max_steps=STEPS, ckpt_filename="full.npz"),
            dict(train_config=tc("first", from_checkpoint=ck0),
                 max_steps=STEPS - 1, ckpt_filename="first.npz"),
            dict(train_config=tc("resume", from_checkpoint=str(
                d / "first" / "first.npz")), max_steps=STEPS,
                 ckpt_filename="resume.npz", continued=True),
            dict(train_config=tc("lora", from_checkpoint=ck0, **LORA),
                 max_steps=2,
                 ckpt_filename="lora.npz")]
    ranks = launch.run("tests.torch_parallel_ranks:train", 4,
                       args=(cfg, runs), device="cpu", threads=1)
    lora = ttrainer.Trainer(cfg, dict(runs[-1]["train_config"],
                                      mesh_shape=None,
                                      save_checkpoint_to=str(d / "lora1")),
                            max_steps=2, device="cpu")
    lora.init()
    lora.load_data()
    lora.start()
    return dict(jax=jt, ranks=ranks, dir=d, cfg=cfg, start=start,
                shards=shards, lora=lora)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]


def _npz_params(path):
    return dict(_flat({k: v.numpy() for k, v in
                       _flat(tckpt.Checkpoint(path).load_params())}))


def test_dp_tp_losses_follow_the_jax_trainer_on_the_same_mesh(trained):
    """Three steps' losses within 1e-5 relative of the JAX Trainer's on
    {"data": 2, "model": 2}; every rank logs the same losses; the clip
    acted (the last step's norm exceeds it) and the masked loss had rows
    of different mask counts on the two data ranks."""
    jl = [l for _, l in trained["jax"].loss_history]
    for hist, norm, shape in (r[0] for r in trained["ranks"]):
        assert shape == MESH
        assert [s for s, _ in hist] == [1, 2, 3]
        for (_, tl), want in zip(hist, jl):
            assert abs(tl - want) <= 1e-5 * abs(want), (hist, jl)
        assert norm > CLIP
    ids, mask = preprocess.load_shard(trained["shards"][0])
    assert len(set(mask.sum(axis=1).tolist())) > 1


def test_dp_tp_params_follow_the_jax_trainer(trained):
    """After three steps, every gathered parameter within 1e-5 of
    max|param| of the JAX Trainer's, and every one moved."""
    want = dict(_flat(jax.tree.map(np.asarray, trained["jax"].params)))
    got = _npz_params(str(trained["dir"] / "full" / "full.npz"))
    start = dict(_flat(trained["start"]))
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= 1e-5 * scale, path
        assert np.abs(got[path] - start[path]).max() > 0, path


def test_dp_tp_resume_on_the_same_mesh_is_bit_exact(trained):
    """Two steps, a save (params and optimizer state gathered), a resume
    on the same mesh (cut again, the data stream replayed): the third
    step's loss and every parameter and moment equal the unbroken run's
    bit for bit."""
    full, first, resume = trained["ranks"][0][:3]
    assert resume[0] == full[0][STEPS - 1:]
    assert first[0] == full[0][:STEPS - 1]
    a = np.load(str(trained["dir"] / "full" / "full.npz"))
    b = np.load(str(trained["dir"] / "resume" / "resume.npz"))
    keys = [k for k in a.files if k != "__meta__"]
    assert set(keys) == {k for k in b.files if k != "__meta__"}
    assert any(k.startswith("opt/mu/") for k in keys)
    for k in keys:
        assert np.array_equal(a[k], b[k]), k


def test_lora_fine_tune_over_data_ranks_follows_one_device(trained):
    """A LoRA fine-tune (the adapter alone trained, from the same fresh
    adapter on every rank) over {"data": 4} takes one device's losses
    within 1e-5 relative and writes the adapter alone."""
    want = [l for _, l in trained["lora"].loss_history]
    for r in trained["ranks"]:
        hist, _, shape = r[3]
        assert shape == {"data": 4, "model": 1}
        got = [l for _, l in hist]
        assert len(got) == 2 and all(abs(a - b) <= 1e-5 * b
                                     for a, b in zip(got, want)), (got, want)
    ck = tckpt.Checkpoint(str(trained["dir"] / "lora" / "lora.npz"))
    assert ck.is_lora and not ck.has("model") and ck.has("lora")


def test_dp_tp_checkpoint_loads_in_the_jax_package(trained):
    """The port's checkpoint holds the whole params in the JAX layout: the
    JAX package loads them, every array equal to the port's reading."""
    path = str(trained["dir"] / "full" / "full.npz")
    cfg = JModelConfig(**trained["cfg"])
    like = jax.eval_shape(lambda k: jgpt.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    jp = jckpt.Checkpoint(path).load_params(like)
    got = _npz_params(path)
    for p, leaf in _flat(jax.tree.map(np.asarray, jp)):
        assert np.array_equal(leaf, got[p]), p
    assert jckpt.Checkpoint(path).step == STEPS


def test_data_only_and_model_only_meshes_train_through_torchrun(trained,
                                                                tmp_path):
    """python -m nano_tpu_torch.train under torchrun's environment (two
    CPU ranks, gloo): {"data": 2} and then {"model": 2} (under the "dots"
    and "heads" remat policies, whose recomputation runs the block's
    all-reduces again), one step each from the same checkpoint, give the
    JAX-mesh trajectory's first loss."""
    d = trained["dir"]
    tok_path = str(d / "tok.json")
    mc = str(tmp_path / "m.json")
    with open(mc, "w") as f:
        json.dump(trained["cfg"], f)
    want = trained["jax"].loss_history[0][1]
    for shape, remat in (({"data": 2}, {}),
                         ({"model": 2}, dict(remat=True,
                                             remat_policy="dots")),
                         ({"model": 2}, dict(remat=True,
                                             remat_policy="heads"))):
        tc = str(tmp_path / "t.json")
        with open(tc, "w") as f:
            json.dump(_tc(tmp_path / "out", trained["shards"], tok_path,
                          from_checkpoint=str(d / "start.npz"),
                          mesh_shape=shape, **remat), f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env.pop("XLA_FLAGS", None)
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", "2", "--master_port",
             str(launch.free_port()), "-m", "nano_tpu_torch.train", "-m",
             mc, "-t", tc, "--max_steps", "1", "--device", "cpu"],
            capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
        assert out.returncode == 0, out.stderr[-3000:]
        assert f"mesh: {{'data': {2 if 'data' in shape else 1}, 'model': " \
               f"{shape.get('model', 1)}}} over gloo" in out.stdout
        # rank 0 alone logs
        lines = [ln for ln in out.stdout.splitlines() if "| Loss: " in ln]
        assert len(lines) == 1, out.stdout
        loss = float(lines[0].split("| Loss: ")[1].split()[0])
        assert abs(loss - want) <= 1e-4 * want


# ---------------------------------------------------------------------
# specs and cut plans: shapes only
# ---------------------------------------------------------------------

def test_param_specs_name_the_jax_cut_dims():
    """The training specs cut the dims of JAX's param_specs(tensor_parallel
    =True) and nothing without tensor parallelism."""
    cfg = dict(TINY, qkv_bias=True, use_qk_norm=True)
    jp = jgpt.init_params(jax.random.PRNGKey(0), JModelConfig(**cfg))
    want = jmesh.param_specs(jp, tensor_parallel=True)
    got = meshlib.param_specs(jax.tree.map(np.asarray, jp), True)
    for (path, spec), (_, dim) in zip(
            _flat(jax.tree.map(lambda s: s, want,
                               is_leaf=lambda s: isinstance(
                                   s, jax.sharding.PartitionSpec))),
            _flat(got)):
        cut = [i for i, a in enumerate(spec) if a == jmesh.MODEL_AXIS]
        assert ([dim] if dim is not None else []) == cut, path
    assert all(v is None for _, v in _flat(meshlib.param_specs(
        jax.tree.map(np.asarray, jp), False)))
    assert meshlib.kv_cache_spec() == list(jmesh.kv_cache_spec()).index(
        jmesh.MODEL_AXIS)
    assert meshlib.batch_spec() == tuple(jmesh.batch_spec())


QWEN3_4B = dict(n_layer=36, n_embd=2560, n_head=32, n_kv_head=8,
                head_dim=128, n_hidden=9728, vocab_size=151936)


def _abstract(kind, out, inn, gs=256):
    """A quantized leaf of shapes only (meta tensors)."""
    meta = lambda *s, dt=torch.int8: torch.empty(s, dtype=dt, device="meta")
    if kind == "q80":
        return Q80Tensor(q=meta(1, out, inn),
                         scales=meta(1, out, inn // gs, dt=torch.float32),
                         group_size=gs, w8a8=True)
    n_pad = -(-inn // 256) * 256
    return Q4KTensor(packed=meta(1, out, n_pad // 2, dt=torch.uint8),
                     scales=meta(1, out, n_pad // 32, dt=torch.float32),
                     biases=meta(1, out, n_pad // 32, dt=torch.float32),
                     in_dim=inn)


@pytest.mark.parametrize("kind", ["q4k", "q80"])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_qwen3_4b_cut_plan(kind, tp):
    """The Qwen3-4B shapes at TP 2 / 4 / 8: every rank's heads cut evenly
    with wo row-parallel on its quantization units, its KV heads its own,
    and the FFN cut on w2's units (256-value groups or blocks): 38 units,
    so 19/19, 10/10/9/9 and 5/5/5/5/5/5/4/4.  The JAX package cuts the
    Q4K w2 evenly by values (GSPMD quantizes the whole activation) and
    replicates the Q80 w2 where the degree does not divide its 38 groups
    (TP 4 and 8, tests/test_infer_tp.py): the port cuts both on unit
    boundaries."""
    c = QWEN3_4B
    E, F, HD = c["n_embd"], c["n_hidden"], c["n_head"] * c["head_dim"]
    cfg = ModelConfig(**{k: v for k, v in c.items() if k != "vocab_size"},
                      vocab_size=c["vocab_size"])
    wo, w2 = _abstract(kind, E, HD), _abstract(kind, E, F)
    plans = [meshlib.tp_plan(cfg, tp, r, wo, w2) for r in range(tp)]
    units = [(p.ffn[1] - p.ffn[0]) // 256 + ((p.ffn[1] - p.ffn[0]) % 256 > 0)
             for p in plans]
    assert sum(units) == 38 and max(units) - min(units) <= 1
    assert units == sorted(units, reverse=True)
    assert all(p.attn == "row" and p.ffn_mode == "row" for p in plans)
    assert [p.heads for p in plans] == [(r * 32 // tp, (r + 1) * 32 // tp)
                                       for r in range(tp)]
    assert [p.kv_heads for p in plans] == [(r * 8 // tp, (r + 1) * 8 // tp)
                                          for r in range(tp)]
    assert plans[-1].ffn[1] == F
    # each rank's leaves, cut from abstract tensors
    blocks = {"wqkv": _abstract(kind, HD + 2 * 8 * 128, E), "wo": wo,
              "w13": _abstract(kind, 2 * F, E), "w2": w2}
    specs = meshlib.infer_param_specs({"blocks": blocks})["blocks"]
    for p, u in zip(plans, units):
        w2_r = meshlib.cut_leaf(w2, specs["w2"], p.ranges("w2"))
        w13_r = meshlib.cut_leaf(blocks["w13"], specs["w13"],
                                 p.ranges("w13"))
        assert (w2_r.in_dim if kind == "q4k" else w2_r.in_dim) == \
            p.ffn[1] - p.ffn[0]
        assert w13_r.out_dim == 2 * (p.ffn[1] - p.ffn[0])
        wqkv_r = meshlib.cut_leaf(blocks["wqkv"], specs["wqkv"],
                                  p.ranges("wqkv"))
        assert wqkv_r.out_dim == (32 // tp + 2 * 8 // tp) * 128
    if kind == "q80":     # JAX's: even by groups at TP 2, else replicated
        from nano_tpu.ops.qmatmul import Q80Tensor as JQ80
        S = jax.ShapeDtypeStruct
        jw2 = JQ80(q=S((1, 38, E, 256), np.int8),
                   scales=S((1, E, 38), np.float32), group_size=256,
                   layout="grouped")
        spec = jmesh.infer_param_specs({"blocks": {"w2": jw2}})["blocks"]
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                                 ("data", "model"))
        assert jmesh._divisible(jw2.q.shape, spec["w2"].q, mesh) == (tp == 2)


def test_fewer_kv_heads_than_ranks_keep_the_ones_their_heads_read():
    cfg = ModelConfig(n_embd=32, n_head=4, n_kv_head=2, n_hidden=64)
    plans = [meshlib.tp_plan(cfg, 4, r) for r in range(4)]
    assert [p.kv_heads for p in plans] == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert [p.heads for p in plans] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    local = meshlib.local_config(cfg, plans[2])
    assert (local.n_head, local.n_kv_head, local.head_dim) == (1, 1, 8)
    assert local.to_dict() == dict(cfg.to_dict(), n_head=1, n_kv_head=1)
    with pytest.raises(ValueError, match="KV heads"):
        meshlib.tp_plan(cfg, 4, 0, even=True)
    with pytest.raises(ValueError, match="heads"):
        meshlib.tp_plan(cfg, 8, 0)


def test_batch_rows_are_contiguous_over_data():
    mesh = meshlib.Mesh(shape={"data": 2, "model": 2}, rank=3,
                        backend="gloo", groups={})
    assert (mesh.index("data"), mesh.index("model")) == (1, 1)
    x = np.arange(8 * 3).reshape(8, 3)
    assert np.array_equal(meshlib.shard_batch(x, mesh), x[4:])
    a, b = meshlib.shard_batch((x, x + 1), mesh)
    assert np.array_equal(b, x[4:] + 1)
    with pytest.raises(ValueError, match="divide"):
        meshlib.batch_rows(7, mesh)


# ---------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------

@pytest.mark.parametrize("over,exc,match", [
    (dict(mesh_shape={"data": 2, "seq": 3}), ValueError,
     "block_size 128 does not divide over seq=3"),
    (dict(mesh_shape={"pipe": 2, "model": 2}), NotImplementedError,
     "composes with data parallelism only"),
    (dict(mesh_shape={"pipe": 2}, pp_microbatches=3), ValueError,
     "do not divide into pp_microbatches=3"),
    (dict(mesh_shape={"pipe": 2}, use_lora=True,
          from_checkpoint="unread.npz"), NotImplementedError,
     "not with 'model' or LoRA"),
    (dict(mesh_shape={"pipe": 4}), ValueError,
     "n_layer=2 does not divide over pipe=4"),
    (dict(mesh_shape={"pipe": 2, "seq": 2}), NotImplementedError,
     "'seq' > 1"),
    (dict(mesh_shape={"data": 3}), ValueError, "does not divide over data"),
    (dict(mesh_shape={"data": 2, "model": 2}), RuntimeError, "torchrun"),
], ids=["seq", "pipe", "pp_microbatches", "pipe_lora", "pipe_layers",
        "pipe_seq", "data_shrink", "no_group"])
def test_trainer_refusals(tmp_path, over, exc, match):
    """What the Trainer refuses before it makes a group: the JAX
    package's own refusals (a sequence that does not divide over "seq",
    "pipe" with "model" or LoRA, layers that do not divide over "pipe",
    microbatches that do not divide a data rank's rows), "pipe" with
    "seq", and the meshes a process group cannot give."""
    tc = dict(batch_size=4, dataset_path=[["a", "b"]], **over)
    t = ttrainer.Trainer(TINY, tc, max_steps=1, device="cpu")
    with pytest.raises(exc, match=match):
        t.init()


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """No switch on failure: two NCCL ranks on one card raise, naming
    gloo, before any group is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        meshlib.maybe_distributed_init()
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("RANK")
    assert meshlib.maybe_distributed_init() is False
    with pytest.raises(RuntimeError, match="process group"):
        meshlib.make_mesh(n_seq=2)
    with pytest.raises(RuntimeError, match="process group"):
        meshlib.make_mesh(n_model=2)
