"""Sequence parallelism in the port against the JAX package on the CPU.

K4's offset form: a block of Sq queries at positions offset .. offset +
Sq - 1 against Skv keys, in its plain version (the operator's CPU path),
against the rows of the JAX package's einsum attention over the whole
sequence, forward and ``jax.grad``, at head widths 16 and 48 with offsets
that are no multiple of any tile (f32: 1e-5 of max|ref| forward, 1e-4 of
max|grad| backward, as tests/test_torch_flash_attn.py).

Training: the port's ranks are four gloo processes (``parallel.launch``;
rank functions in tests/torch_parallel_ranks.py, which imports no jax),
the JAX Trainer runs on the conftest's 8-device virtual CPU mesh, where
GSPMD partitions its einsum attention on S.  One group of ranks runs
every check of the file: the transport of ``parallel.mesh`` (a send
natively and staged through host memory, as for gloo on CUDA tensors),
then {"data": 2, "seq": 2} and {"seq": 2, "model": 2} for three steps
each from the same checkpoint as the JAX Trainer on the same meshes (SFT
shards, masked loss, accumulation 2, the clip active, f32), and on the
second mesh two steps, a save and a resumed third step.  Losses within 1e-5 relative,
params within 1e-5 of max|param|, the resume bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.io import checkpoint as jckpt
from nano_tpu.models import gpt as jgpt
from nano_tpu.parallel import mesh as jmesh
from nano_tpu.train import trainer as jtrainer
from nano_tpu_torch.data import preprocess
from nano_tpu_torch.io import checkpoint as tckpt
from nano_tpu_torch.ops import flash_attn as tfa
from nano_tpu_torch.parallel import launch
from nano_tpu_torch.parallel import mesh as meshlib
from nano_tpu_torch.tokenizer.trie import TrieTokenizer
from tests.test_torch_parallel import (CLIP, CORPUS, SFT_JSONL, TINY, _flat,
                                       _npz_params, _tc)

MESHES = {"data_seq": {"data": 2, "seq": 2, "model": 1},
          "seq_model": {"data": 1, "seq": 2, "model": 2}}
STEPS = 3


# ---------------------------------------------------------------------
# K4's offset form, plain, against the JAX einsum path's rows
# ---------------------------------------------------------------------

def _jax_rows(q, k, v, offset):
    """Rows offset .. offset + Sq - 1 of the JAX einsum attention over
    the whole sequence, q's rows zero elsewhere (their rows are dropped,
    so they take no part in the gradients asked for)."""
    B, Sq, H, D = q.shape
    S = k.shape[1]
    qf = jnp.zeros((B, S, H, D), q.dtype).at[:, offset:offset + Sq].set(q)
    cfg = JModelConfig(n_embd=H * D, n_head=H, n_kv_head=k.shape[2],
                       head_dim=D)
    scores = jgpt._gqa_scores(qf, k, cfg) + jgpt._causal_mask(S)
    out = jgpt._gqa_out(jax.nn.softmax(scores, axis=-1), v)
    return out[:, offset:offset + Sq]


# (B, Sq, Skv, offset, KV, rep, D): offsets inside a tile, Sq < Skv with
# keys past the last query, a whole sequence, rep 1 and 2; phase 10d's two
# ranks of {"seq": 2} (half the positions each, offsets 0 and Sq) cut to a
# few positions, and D = 32
OFFSET_CASES = [(2, 9, 37, 13, 2, 2, 16), (1, 20, 20, 0, 1, 2, 16),
                (2, 16, 64, 29, 2, 1, 48), (1, 33, 70, 30, 1, 2, 48),
                (2, 7, 40, 33, 2, 2, 48), (2, 16, 32, 0, 2, 2, 48),
                (2, 16, 32, 16, 2, 2, 48), (1, 24, 48, 24, 2, 2, 32)]


@pytest.mark.parametrize("B,Sq,Skv,offset,KV,rep,D", OFFSET_CASES)
def test_offset_attention_matches_jax_rows_and_grad(B, Sq, Skv, offset, KV,
                                                     rep, D):
    rng = np.random.RandomState(Sq + Skv + offset + D)
    H = KV * rep
    q, k, v = (rng.randn(*s).astype(np.float32) for s in
               ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    g = rng.randn(B, Sq, H * D).astype(np.float32)
    want = np.asarray(_jax_rows(*map(jnp.asarray, (q, k, v)), offset))
    wgrads = jax.grad(lambda a, b, c: jnp.sum(_jax_rows(a, b, c, offset)
                                              * g), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = tfa.flash_attention(*leaves, offset=offset)
    assert got.shape == (B, Sq, H * D)
    assert np.abs(got.detach().numpy() - want).max() <= \
        1e-5 * np.abs(want).max()
    got.backward(torch.from_numpy(g))
    for name, t, w in zip("qkv", leaves, wgrads):
        w = np.asarray(w)
        assert t.grad.shape == w.shape
        assert np.abs(t.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max(), \
            name
    # dk, dv are zero for the keys no query sees
    if offset + Sq < Skv:
        assert not leaves[1].grad[:, offset + Sq:].any()


def test_offset_form_rows_equal_the_full_call():
    """Every rank's block of a sequence cut in four (offsets 0, 16, 32,
    48) against the call on the whole sequence: out and lse rows equal,
    dk and dv summed over the blocks equal the whole call's within f32
    summation order."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 64, h, 16).astype(np.float32))
               for h in (4, 2, 2))
    out, lse = tfa.flash_attn_fwd_plain(q, k, v)
    dout = torch.from_numpy(rng.randn(2, 64, 4, 16).astype(np.float32))
    dq, dk, dv = tfa.flash_attn_bwd_plain(q, k, v, out, lse, dout)
    dks, dvs = torch.zeros_like(dk), torch.zeros_like(dv)
    for off in range(0, 64, 16):
        rows = slice(off, off + 16)
        o, l = tfa.flash_attn_fwd_plain(q[:, rows], k, v, off)
        assert torch.allclose(o, out[:, rows], rtol=0, atol=1e-6)
        assert torch.allclose(l, lse[..., rows], rtol=0, atol=1e-6)
        a, b, c = tfa.flash_attn_bwd_plain(q[:, rows], k, v, o, l,
                                           dout[:, rows], off)
        assert torch.allclose(a, dq[:, rows], rtol=0, atol=1e-5)
        dks += b
        dvs += c
    assert torch.allclose(dks, dk, rtol=0, atol=1e-5)
    assert torch.allclose(dvs, dv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("offset,S_kv", [(-1, 20), (12, 20)])
def test_offset_outside_the_keys_is_refused(offset, S_kv):
    q = torch.zeros(1, 9, 2, 16)
    k = torch.zeros(1, S_kv, 2, 16)
    with pytest.raises(ValueError, match="offset"):
        tfa.flash_attn_fwd(q, k, k, offset)


# ---------------------------------------------------------------------
# the mesh and the batch: shapes only
# ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [dict(n_data=2, n_seq=2, n_model=2),
                                   dict(n_data=1, n_seq=2, n_pipe=2,
                                        n_model=2),
                                   dict(n_data=2, n_pipe=4)])
def test_rank_layout_is_the_jax_mesh_device_order(shape):
    """The port's rank of every mesh coordinate is the device id at that
    coordinate of the JAX package's make_mesh over devices 0 .. n - 1."""
    n = int(np.prod(list(shape.values())))
    jm = jmesh.make_mesh(devices=jax.devices()[:n], **shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    sizes = dict(zip(jm.axis_names, jm.devices.shape))
    for rank in range(n):
        m = meshlib.Mesh(shape=sizes, rank=rank, backend="gloo", groups={})
        assert ids[tuple(m.index(a) for a in jm.axis_names)] == rank
        for a in jm.axis_names:
            for i in range(sizes[a]):
                c = [m.index(b) for b in jm.axis_names]
                c[jm.axis_names.index(a)] = i
                assert m.rank_at(a, i) == ids[tuple(c)]


def test_batch_cut_on_rows_over_data_and_columns_over_seq():
    mesh = meshlib.Mesh(shape={"data": 2, "seq": 2, "model": 2}, rank=6,
                        backend="gloo", groups={})
    assert (mesh.index("data"), mesh.index("seq"),
            mesh.index("model")) == (1, 1, 0)
    x = np.arange(4 * 8).reshape(4, 8)
    assert np.array_equal(meshlib.shard_batch(x, mesh), x[2:, 4:])
    jm = jmesh.make_mesh(n_data=2, n_seq=2, n_model=2)
    assert meshlib.batch_spec(mesh) == tuple(jmesh.batch_spec(jm))
    with pytest.raises(ValueError, match="seq=2"):
        meshlib.batch_cols(7, mesh)


# ---------------------------------------------------------------------
# training on the meshes, against the JAX Trainer
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX Trainer's 3 steps on each mesh and the port ranks' runs."""
    d = tmp_path_factory.mktemp("sp")
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
    tc = lambda sub, shape, **o: _tc(d / sub, shards, tok_path,
                                     mesh_shape=shape, **o)

    jax_runs = {}
    for name, shape in MESHES.items():
        jt = jtrainer.Trainer(cfg, tc("j_" + name, shape,
                                      from_checkpoint=ck0),
                              max_steps=STEPS)
        jt.init()
        assert dict(zip(jt.mesh.axis_names, jt.mesh.devices.shape)) == \
            {k: v for k, v in shape.items() if v > 1 or k != "seq"}
        jt.load_data()
        jt.start()
        jax_runs[name] = jt

    sm = MESHES["seq_model"]
    runs = [dict(train_config=tc(name, shape, from_checkpoint=ck0),
                 max_steps=STEPS, ckpt_filename=f"{name}.npz")
            for name, shape in MESHES.items()]
    runs += [dict(train_config=tc("first", sm, from_checkpoint=ck0),
                  max_steps=STEPS - 1, ckpt_filename="first.npz"),
             dict(train_config=tc("resume", sm, from_checkpoint=str(
                 d / "first" / "first.npz")), max_steps=STEPS,
                  ckpt_filename="resume.npz", continued=True)]
    ranks = launch.run("tests.torch_parallel_ranks:seq_file", 4,
                       args=(cfg, runs), device="cpu", threads=1)
    return dict(jax=jax_runs, ranks=ranks, dir=d, cfg=cfg, start=start,
                shards=shards)


def test_transport_gathers_scatters_and_stages_sends(trained):
    """all_gather and reduce_scatter over the seq group (bf16 in and out,
    the sum in f32), and send / recv natively and staged through host
    memory as between gloo ranks that share a card."""
    for r, rank in enumerate(trained["ranks"]):
        t = rank["transport"]
        s = r % 2               # the seq index of rank r in {data 2, seq 2}
        want_gather = torch.cat([torch.arange(6.).reshape(1, 2, 3) + 10 * i
                                 for i in range(2)], 1).to(torch.bfloat16)
        want_scatter = (torch.arange(8.).reshape(1, 4, 2) * 3)[:, 2 * s:
                                                               2 * s + 2]
        assert torch.equal(t["gather"], want_gather)
        assert torch.equal(t["scatter"], want_scatter.to(torch.bfloat16))
        for path in ("native", "staged"):
            if s == 1:
                assert torch.equal(t[path], torch.arange(6.).reshape(1, 2, 3))
            else:
                assert path not in t


@pytest.mark.parametrize("name", list(MESHES))
def test_seq_losses_follow_the_jax_trainer_on_the_same_mesh(trained, name):
    """Three steps' losses within 1e-5 relative of the JAX Trainer's on
    the same mesh, the same on every rank; the clip acted."""
    i = list(MESHES).index(name)
    jl = [l for _, l in trained["jax"][name].loss_history]
    for rank in trained["ranks"]:
        hist, norm, shape = rank["train"][i]
        assert shape == {k: v for k, v in MESHES[name].items()
                         if v > 1 or k != "seq"}
        assert [s for s, _ in hist] == [1, 2, 3]
        for (_, tl), want in zip(hist, jl):
            assert abs(tl - want) <= 1e-5 * abs(want), (hist, jl)
        assert norm > CLIP


@pytest.mark.parametrize("name", list(MESHES))
def test_seq_params_follow_the_jax_trainer(trained, name):
    want = dict(_flat(jax.tree.map(np.asarray,
                                   trained["jax"][name].params)))
    got = _npz_params(str(trained["dir"] / name / f"{name}.npz"))
    start = dict(_flat(trained["start"]))
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= 1e-5 * scale, path
        assert np.abs(got[path] - start[path]).max() > 0, path


def test_seq_model_resume_is_bit_exact(trained):
    """{"seq": 2, "model": 2}: two steps, a save, a resume on the same
    mesh: the third step's loss and every parameter and moment equal the
    unbroken run's bit for bit."""
    full, first, resume = (trained["ranks"][0]["train"][i][0]
                           for i in (1, 2, 3))
    assert resume == full[STEPS - 1:] and first == full[:STEPS - 1]
    a = np.load(str(trained["dir"] / "seq_model" / "seq_model.npz"))
    b = np.load(str(trained["dir"] / "resume" / "resume.npz"))
    keys = [k for k in a.files if k != "__meta__"]
    assert set(keys) == {k for k in b.files if k != "__meta__"}
    assert any(k.startswith("opt/mu/") for k in keys)
    for k in keys:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", list(MESHES))
def test_seq_checkpoint_loads_in_the_jax_package(trained, name):
    path = str(trained["dir"] / name / f"{name}.npz")
    cfg = JModelConfig(**trained["cfg"])
    like = jax.eval_shape(lambda k: jgpt.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    jp = jckpt.Checkpoint(path).load_params(like)
    got = _npz_params(path)
    for p, leaf in _flat(jax.tree.map(np.asarray, jp)):
        assert np.array_equal(leaf, got[p]), p
    assert tckpt.Checkpoint(path).step == STEPS
