"""The port's tensor-parallel serving against the JAX package on the CPU:
f32 and Q80 models (tests/test_torch_infer_tp_q4k.py: Q4K).

Tiny .bin files written by the JAX package as tests/test_infer_tp.py
writes them (2 layers, 4 heads and 2 KV heads of 8 values, 64 hidden
units; Q80 at group size 32), with the matrices scaled by 8 so that the
greedy streams do not collapse onto one token, and a wider Q80 one (heads
of 128 values, 1024 hidden units, groups of 256: the W8A8 form) whose
row-parallel products are cut on its quantization groups, served at TP = 2
and at TP = 4 (fewer KV heads than ranks).  The port's ranks are four
gloo processes (``nano_tpu_torch.parallel.launch``;
tests/torch_parallel_ranks.py holds the rank functions and imports no
jax), one group for the whole file; the JAX package serves on the
conftest's 8-device virtual CPU mesh with NANO_TPU_DEQUANT=f32 (f32
dequant dots, as the port's; read while tracing, hence
jax.clear_caches()).  Greedy streams must be token-identical: f32
throughout, the row-parallel sums in another order than one device's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.infer import engine as jengine
from nano_tpu.io import binfmt as jbinfmt
from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import sampling as jsampling
from nano_tpu.parallel import mesh as jmesh
from nano_tpu.tokenizer.trie import TrieTokenizer as JTrieTokenizer
from nano_tpu_torch.ops.q4k import Q4KTensor
from nano_tpu_torch.ops.qmatmul import Q80Tensor
from nano_tpu_torch.parallel import launch
from tests import torch_parallel_ranks as ranks

JSAMP = jsampling.SamplerConfig(temperature=0.0, repetition_penalty=1.0)
TINY = dict(block_size=64, vocab_size=64, n_layer=2, n_embd=32, n_head=4,
            n_kv_head=2, n_hidden=64)
WIDE = dict(TINY, n_embd=512, n_hidden=1024)
WIDTHS = (2, 4)
SCALE = 8.0


def write_model(d, name, cfg, quant, group_size):
    """JAX init (seed 7) with the matrices scaled by SCALE, written by the
    JAX package's writer -> the file's path."""
    jcfg = JModelConfig(**cfg)
    params = jax.tree.map(
        lambda a: a * SCALE if a.ndim >= 2 else a,
        jax.tree.map(np.asarray, jgpt.init_params(jax.random.PRNGKey(7),
                                                   jcfg)))
    tok = JTrieTokenizer()
    tok.build([chr(ord("a") + i) for i in range(52)])
    path = str(d / f"{name}.bin")
    jbinfmt.write_model(path, params, jcfg, tok.config, quant=quant,
                        group_size=group_size)
    return path


@contextlib.contextmanager
def jax_f32_dequant(op_by_op=False):
    """The JAX package with f32 dequant dots (NANO_TPU_DEQUANT=f32), and
    op by op where asked (the Q4K activation fake-quant's rounding)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NANO_TPU_DEQUANT", "f32")
        jax.clear_caches()
        with jax.disable_jit() if op_by_op else contextlib.nullcontext():
            yield
    jax.clear_caches()


def jax_greedy(path, mesh=None, prompt="abcdef", n=12):
    """The JAX package's Session greedy stream (inside
    ``jax_f32_dequant``)."""
    ctx = jengine.LLMContext.from_bin(path, max_seq_len=64,
                                      dtype=jnp.float32, sampler=JSAMP)
    if mesh is not None:
        ctx.shard(mesh, tensor_parallel=True)
    session = jengine.Session(ctx, prompt, max_new_tokens=n)
    out = []
    while (t := session.step()) is not None:
        out.append(t)
    return out


def serve_files(files):
    """Every rank's results of tests/torch_parallel_ranks.py:serve."""
    return launch.run("tests.torch_parallel_ranks:serve", 4,
                      args=(files, list(WIDTHS)), device="cpu", threads=1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    files = {"tiny_f32": write_model(d, "tiny_f32", TINY, "f32", 32),
             "tiny_q80": write_model(d, "tiny_q80", TINY, "q80", 32),
             "wide_q80": write_model(d, "wide_q80", WIDE, "q80", 256)}
    got = serve_files(files)
    with jax_f32_dequant():
        jax_single = {name: jax_greedy(p) for name, p in files.items()}
        jax_tp = {(name, n): jax_greedy(p, jmesh.make_mesh(n_data=8 // n,
                                                           n_model=n))
                  for name, p in files.items() for n in WIDTHS}
        path = files["tiny_f32"]
        jax_more = (jax_greedy(path, n=8),
                    jax_greedy(path, prompt="ababab", n=10))
    return dict(files=files, ranks=got, jax=jax_single, jax_tp=jax_tp,
                jax_more=jax_more)


NAMES = ["tiny_f32", "tiny_q80", "wide_q80"]


@pytest.mark.parametrize("tp", WIDTHS)
@pytest.mark.parametrize("name", NAMES)
def test_tp_session_greedy_matches_jax(served, name, tp):
    """Session greedy at TP = tp on every rank equals the JAX package's
    single-device stream and its shard(mesh) stream."""
    want = served["jax"][name]
    assert len(want) == 12 and len(set(want)) > 1
    for r in served["ranks"]:
        assert r[f"{name}/tp{tp}/session"] == want, (name, tp)
    if (name, tp) in served["jax_tp"]:
        assert served["jax_tp"][(name, tp)] == want


@pytest.mark.parametrize("tp", WIDTHS)
def test_tp_batched_engine_and_speculation_match_jax(served, tp):
    """BatchedEngine, speculative BatchedEngine (spec_k = 4), speculative
    Session and generate_on_device over a sharded tiny f32 context equal
    JAX's single-device greedy streams (tests/test_infer_tp.py's
    test_tp_batched_engine / test_tp_spec_batched_engine)."""
    want8, want10 = served["jax_more"]
    r = served["ranks"][0]
    key = f"tiny_f32/tp{tp}"
    assert r[key + "/batched"] == want8
    assert r[key + "/spec_batched"] == want10
    assert r[key + "/spec_session"] == want10
    assert r[key + "/on_device"] == served["jax"]["tiny_f32"]


def _whole(path):
    return ranks._ctx(path).params["blocks"]


def _rows(w, lo, hi):
    """Rows [lo, hi) of layer 0 of a column-parallel leaf, as the rank's
    arrays are keyed."""
    if isinstance(w, torch.Tensor):         # dense (L, in, out)
        return {"w": w[0][:, lo:hi].numpy()}
    if isinstance(w, Q80Tensor):
        return {"q": w.q[0][lo:hi].numpy(), "scales": w.scales[0][lo:hi].numpy()}
    return {"packed": w.packed[0][lo:hi].numpy(),
            "scales": w.scales[0][lo:hi].numpy(),
            "biases": w.biases[0][lo:hi].numpy()}


def _cat(parts):
    axis = lambda k: 1 if k == "w" else 0
    return {k: np.concatenate([p[k] for p in parts], axis=axis(k))
            for k in parts[0]}


@pytest.mark.parametrize("tp", WIDTHS)
@pytest.mark.parametrize("name", NAMES)
def test_rank_cuts_hold_their_own_heads_and_hidden_units(served, name, tp):
    """Each rank's wqkv (or wq / wk / wv) holds its own q heads, then the k
    and v heads they read, and its w13 (or w1 / w3) the same hidden units
    of w1 and of w3: a cut part by part, not the contiguous cut of the
    fused rows."""
    blocks = _whole(served["files"][name])
    H, KV, D = 4, 2, (8 if name.startswith("tiny") else 128)
    F = 64 if name.startswith("tiny") else 1024
    for rank, r in enumerate(served["ranks"]):
        plan = r[f"{name}/tp{tp}/plan"]
        cuts = r[f"{name}/tp{tp}/cuts"]
        (h0, h1), (k0, k1), (f0, f1) = (plan["heads"], plan["kv_heads"],
                                        plan["ffn"])
        m = rank % tp
        assert (h0, h1) == (m * H // tp, (m + 1) * H // tp)
        assert (k0, k1) == ((m * KV // tp, (m + 1) * KV // tp) if tp <= KV
                            else (h0 // (H // KV), h0 // (H // KV) + 1))
        if "wqkv" in blocks:
            w, HD = blocks["wqkv"], H * D
            want = _cat([_rows(w, h0 * D, h1 * D),
                         _rows(w, HD + k0 * D, HD + k1 * D),
                         _rows(w, HD + KV * D + k0 * D, HD + KV * D + k1 * D)])
            got = cuts["wqkv"]
        else:
            want = _rows(blocks["wk"], k0 * D, k1 * D)
            got = cuts["wk"]
        for k in want:
            assert np.array_equal(got[k], want[k]), (name, tp, rank, k)
        if "w13" in blocks:
            w = blocks["w13"]
            want = _cat([_rows(w, f0, f1), _rows(w, F + f0, F + f1)])
            got = cuts["w13"]
        else:
            want, got = _rows(blocks["w3"], f0, f1), cuts["w3"]
        for k in want:
            assert np.array_equal(got[k], want[k]), (name, tp, rank, k)


ROW_MODES = [("tiny_f32", 4, "row", "row"),
             ("tiny_q80", 2, "gather", "row"),
             ("tiny_q80", 4, "gather", "replicated"),
             ("wide_q80", 2, "row", "row"), ("wide_q80", 4, "gather", "row")]


@pytest.mark.parametrize("name,tp,attn,ffn_mode", ROW_MODES)
def test_row_parallel_cuts_keep_quantization_units(served, name, tp, attn,
                                                   ffn_mode):
    """wo is cut by heads only where a rank's heads fill whole Q80 groups
    (a W8A8 activation's quantization groups) or Q4K blocks of 256 (the
    activation fake-quant's); elsewhere the heads are gathered and every
    rank runs the whole wo.  w2 is cut on its units, or the whole FFN runs
    on every rank where there are fewer units than ranks."""
    for r in served["ranks"]:
        plan = r[f"{name}/tp{tp}/plan"]
        assert (plan["attn"], plan["ffn_mode"]) == (attn, ffn_mode)
        wo = r[f"{name}/tp{tp}/cuts"]["wo"]
        whole = _whole(served["files"][name])["wo"]
        cut = (whole.q if isinstance(whole, Q80Tensor) else whole.packed
               if isinstance(whole, Q4KTensor) else whole)[0].shape
        got = (wo.get("q") if "q" in wo else wo.get("packed")
               if "packed" in wo else wo["w"]).shape
        assert (got != cut) == (attn == "row")


def test_kv_caches_hold_the_local_kv_heads(served):
    for tp in WIDTHS:
        r = served["ranks"][0]
        assert r[f"tiny_f32/tp{tp}/kv_cache"] == (2, 1, 64, 2 // min(tp, 2),
                                                   8)


def test_every_rank_takes_the_same_tokens(served):
    """SPMD serving: the streams of all four ranks are one."""
    first = served["ranks"][0]
    for r in served["ranks"][1:]:
        for k, v in first.items():
            if k.endswith(("session", "batched", "on_device")):
                assert r[k] == v, k


def test_sharded_contexts_refuse_what_is_item_11b(served):
    """Sequence- and pipeline-parallel meshes are made over the four ranks
    (once refused as ROADMAP item 11b), and a sharded context reads LoRA
    files; what stays refused: meshes that do not match the ranks, a model
    file given as an adapter, a second shard."""
    got = served["ranks"][0]["tiny_f32/tp2/refusals"]
    assert got["meshes"] == [{"data": 2, "seq": 2, "model": 1},
                             {"data": 1, "pipe": 2, "model": 2}]
    for what in ("seq", "pipe"):
        assert got[what].startswith("ValueError") and \
            "does not match the 4 ranks" in got[what], (what, got[what])
    for what in ("lora", "adapters"):
        assert got[what] == "ValueError: not a LoRA .bin file", got[what]
    assert got["twice"].startswith("ValueError")


@pytest.mark.parametrize("name", NAMES)
def test_replicate_to_streams_equal_the_original(served, name):
    """A replica (the weights copied, the tied head copied once, host
    state shared) streams what its source does; a sharded context does not
    replicate."""
    ctx = ranks._ctx(served["files"][name])
    rep = ctx.replicate_to("cpu")
    assert rep.tokenizer is ctx.tokenizer and rep.sampler is ctx.sampler
    assert rep._decoder is None and rep._lock is not ctx._lock
    if "output_q" in ctx.params:
        assert rep.params["output_q"] is rep.params["tok_embeddings"] or \
            ctx.params["output_q"] is not ctx.params["tok_embeddings"]
    assert ranks.greedy(rep, "abcdef") == ranks.greedy(ctx, "abcdef")
    assert ranks.greedy(rep, "abcdef") == served["jax"][name]
