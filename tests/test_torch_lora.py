"""LoRA in the port against the JAX package on the CPU: the branch
(_lora_delta, both forms), merge_lora, init_lora_params, LoRA files,
checkpoints and reference .pt adapters, the export entry point's --lora
and --merge-lora, and adapters served: the committed tiny_f32.bin +
tiny_lora.bin stream, hot-swap / swap / unload on f32, Q80 and Q4K bases,
speculative decode, and per-slot adapters in BatchedEngine.

Tolerances: the branch in f32 within 1e-6 of max|y| (the products' sums
run in another order), in bf16 exact (both round each product and the
scaling to bf16); the files exact; merge_lora and the export outputs exact
where every projection is at least 64 wide, as in the models here (there
XLA's CPU dot and torch.matmul both sum the rank in order with FMAs;
narrower, either may take another order, and the two agree within 1e-6 of
max|W|); streams token-identical."""

import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.io import binfmt as jbin
from nano_tpu.io import checkpoint as jckpt
from nano_tpu.io import pt_import as jpt
from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import sampling as jsamp
from nano_tpu.serve import batching as jbatch
from nano_tpu.tokenizer.trie import TrieTokenizer
from nano_tpu_torch import export as texport
from nano_tpu_torch.config import ModelConfig as TConfig
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.io import binfmt as tbin
from nano_tpu_torch.io import checkpoint as tckpt
from nano_tpu_torch.io import pt_import as tpt
from nano_tpu_torch.io.from_jax import params_from_jax
from nano_tpu_torch.models import gpt as tgpt
from nano_tpu_torch.ops import sampling as tsamp
from nano_tpu_torch.serve import batching as tbatch

FIX = os.path.join(os.path.dirname(__file__), "js", "fixtures")
TINY = dict(block_size=64, vocab_size=64, n_layer=2, n_embd=64, n_head=4,
            n_kv_head=4, n_hidden=128)
GREEDY = dict(temperature=0.0, repetition_penalty=1.0)
# Qwen3-shaped, group size 256: the W8A8 products and their fused norms
QWEN3_TINY = dict(block_size=256, vocab_size=512, n_layer=2, n_embd=256,
                  n_head=2, n_kv_head=1, n_hidden=512, head_dim=128,
                  use_qk_norm=True, rope_style="half", rope_theta=1e6,
                  norm_eps=1e-6, tie_embeddings=True)


def random_lora(cfg, rank, seed, std=0.3):
    rng = np.random.RandomState(seed)
    L, E = cfg.n_layer, cfg.n_embd
    HD, KD = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim
    shapes = {"wq_a": (L, E, rank), "wq_b": (L, rank, HD),
              "wk_a": (L, E, rank), "wk_b": (L, rank, KD),
              "wv_a": (L, E, rank), "wv_b": (L, rank, KD),
              "wo_a": (L, HD, rank), "wo_b": (L, rank, E)}
    return {k: (rng.randn(*s) * std).astype(np.float32)
            for k, s in shapes.items()}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A random 2-layer model written as f32, Q80 and Q4K .bin files by
    the JAX writer (as tests/test_engine.py's LoRA cases build theirs),
    and two adapters of ranks 2 and 4 as LoRA files."""
    d = tmp_path_factory.mktemp("lora")
    cfg = JConfig(**TINY)
    params = jax.tree.map(np.asarray,
                          jgpt.init_params(jax.random.PRNGKey(7), cfg))
    tok = TrieTokenizer()
    tok.build([chr(ord("a") + i) for i in range(52)])
    paths = {}
    for quant in ("f32", "q80", "q4k"):
        paths[quant] = str(d / f"m_{quant}.bin")
        jbin.write_model(paths[quant], params, cfg, tok.config, quant=quant)
    for name, rank, alpha, seed in (("a", 2, 4, 0), ("b", 4, 8, 1)):
        paths[name] = str(d / f"lora_{name}.bin")
        jbin.write_lora(paths[name], random_lora(cfg, rank, seed), cfg,
                        rank=rank, alpha=alpha)
    return cfg, params, tok, paths


def ctxs(path, quant="f32", **kw):
    """(JAX context, port context) on one file, f32, greedy, no stop
    token (the random models stop at once).  The JAX side of a Q80 file is
    its f32-dequant oracle (tests/test_torch_slice.py)."""
    kw.setdefault("stop_tokens", ())
    j = jeng.LLMContext.from_bin(
        path, max_seq_len=64, dtype=jnp.float32,
        quantized=False if quant == "q80" else None,
        sampler=jsamp.SamplerConfig(**GREEDY), **kw)
    t = teng.LLMContext.from_bin(
        path, max_seq_len=64, dtype=torch.float32, device="cpu",
        sampler=tsamp.SamplerConfig(**GREEDY), **kw)
    return j, t


@pytest.fixture
def jax_q4k_op_by_op(monkeypatch):
    """The JAX Q4K path as tests/test_torch_q4k_slice.py runs it: f32
    dequant, op by op (jitted, XLA folds the fake-quant's rounding)."""
    monkeypatch.setenv("NANO_TPU_DEQUANT", "f32")
    jax.clear_caches()
    with jax.disable_jit():
        yield
    monkeypatch.delenv("NANO_TPU_DEQUANT")
    jax.clear_caches()


# =====================================================================
# the branch, merge and init
# =====================================================================

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1, 64, 4, 64), (3, 5, 64, 16, 128),
                                   (8, 1, 256, 16, 256)])
def test_lora_delta_both_forms_match_jax(dtype, shape):
    B, S, E, r, O = shape
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.RandomState(B * S)
    x = rng.randn(B, S, E).astype(np.float32)
    a = (rng.randn(E, r) * 0.3).astype(np.float32)
    b = (rng.randn(r, O) * 0.3).astype(np.float32)
    # a stack of 3 (row 0 the zero adapter of scale 0) and a row each
    stack_a = (rng.randn(3, E, r) * 0.3).astype(np.float32)
    stack_b = (rng.randn(3, r, O) * 0.3).astype(np.float32)
    stack_a[0], stack_b[0] = 0.0, 0.0
    scales = np.array([0.0, 2.0, 0.75], np.float32)
    idx = rng.randint(0, 3, B)
    want = [jgpt._lora_delta(jnp.asarray(x, jdt), jnp.asarray(a),
                             jnp.asarray(b), 2.5, jdt),
            # JAX's per-slot form: each row's adapter gathered first
            jgpt._lora_delta(jnp.asarray(x, jdt), jnp.asarray(stack_a[idx]),
                             jnp.asarray(stack_b[idx]),
                             jnp.asarray(scales[idx]), jdt)]
    t = lambda v: torch.from_numpy(v)
    ti = t(idx)
    got = [tgpt._lora_delta(t(x).to(tdt), t(a), t(b), 2.5, tdt),
           tgpt._lora_delta(t(x).to(tdt), t(stack_a), t(stack_b),
                            t(scales)[ti], tdt, ti)]
    for w, g in zip(want, got):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == tdt and g.shape == w.shape
        g = g.float().numpy()
        if dtype == "float32":
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
        else:
            np.testing.assert_array_equal(g, w)
    assert torch.all(got[1][ti == 0] == 0)         # base rows: no delta


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_merge_lora_matches_jax_exactly(kv_heads):
    cfg = JConfig(**dict(TINY, n_kv_head=kv_heads))
    params = jax.tree.map(np.asarray,
                          jgpt.init_params(jax.random.PRNGKey(2), cfg))
    lora = random_lora(cfg, 4, 3)
    want = jax.tree.map(np.asarray, jgpt.merge_lora(params, lora, 2.0))
    tparams = params_from_jax(params, "cpu")
    got = tgpt.merge_lora(tparams, {k: torch.from_numpy(v)
                                    for k, v in lora.items()}, 2.0)
    for name in ("wq", "wk", "wv", "wo", "w1"):
        g, w = got["blocks"][name].numpy(), want["blocks"][name]
        if kv_heads == 4:
            np.testing.assert_array_equal(g, w)
        else:                     # wk / wv 32 wide: another order
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
    # the inputs are unchanged
    np.testing.assert_array_equal(tparams["blocks"]["wq"].numpy(),
                                  params["blocks"]["wq"])


def test_init_lora_params_shapes_bounds_and_zero_b():
    cfg = TConfig(**TINY)
    want = jgpt.init_lora_params(jax.random.PRNGKey(0), JConfig(**TINY), 4)
    got = tgpt.init_lora_params(torch.Generator().manual_seed(0), cfg, 4)
    again = tgpt.init_lora_params(torch.Generator().manual_seed(0), cfg, 4)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, again[k], rtol=0, atol=0)
        if k.endswith("_b"):
            assert not g.any()
        else:
            bound = 1.0 / np.sqrt(w.shape[1])
            assert float(g.abs().max()) <= bound
            assert float(g.abs().max()) > 0.9 * bound
            assert np.abs(np.asarray(w)).max() <= bound


# =====================================================================
# files, checkpoints, reference .pt adapters, export
# =====================================================================

def _read(p):
    with open(p, "rb") as f:
        return f.read()


def test_lora_files_bytes_equal_jax_and_cross_read(tiny, tmp_path):
    cfg, _, _, paths = tiny
    lora = random_lora(cfg, 3, 9)
    jp, tp = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jbin.write_lora(jp, lora, cfg, rank=3, alpha=6)
    tbin.write_lora(tp, {k: torch.from_numpy(v) for k, v in lora.items()},
                    TConfig(**TINY), rank=3, alpha=6)
    assert _read(tp) == _read(jp)
    for path in (jp, tp):
        for reader, c in ((tbin.read_lora, TConfig(**TINY)),
                          (jbin.read_lora, cfg)):
            bl = reader(path, c)
            assert (bl.rank, bl.alpha) == (3, 6)
            for k, v in lora.items():
                np.testing.assert_array_equal(bl.lora[k], v)
    with pytest.raises(ValueError, match="use read_lora"):
        tbin.read_model(tp)
    with pytest.raises(ValueError, match="not a LoRA"):
        tbin.read_lora(paths["f32"], TConfig(**TINY))


def test_committed_tiny_lora_reads_as_jax_reads_it():
    path = os.path.join(FIX, "tiny_lora.bin")
    jcfg = jbin.read_model(os.path.join(FIX, "tiny_f32.bin")).config
    tcfg = tbin.read_model(os.path.join(FIX, "tiny_f32.bin")).config
    want, got = jbin.read_lora(path, jcfg), tbin.read_lora(path, tcfg)
    assert (got.rank, got.alpha) == (want.rank, want.alpha) == (2, 4)
    assert sorted(got.lora) == sorted(want.lora)
    for k in want.lora:
        np.testing.assert_array_equal(got.lora[k], want.lora[k])


@pytest.mark.parametrize("leaf_dtype", ["float32", "bfloat16"])
def test_lora_checkpoints_cross_between_the_packages(tmp_path, leaf_dtype):
    cfg = JConfig(**TINY)
    lora = {k: v.astype(jnp.dtype(leaf_dtype))
            for k, v in random_lora(cfg, 4, 5).items()}
    meta = dict(step=3, model_config=TINY,
                train_config={"lora_rank": 4, "lora_alpha": 8})
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_checkpoint(jp, lora=lora, **meta)
    tckpt.save_checkpoint(tp, lora={k: torch.from_numpy(
        np.asarray(v, np.float32)).to(getattr(torch, leaf_dtype))
        for k, v in lora.items()}, **meta)
    like = jgpt.init_lora_params(jax.random.PRNGKey(0), cfg, 4)
    for path in (jp, tp):
        tc = tckpt.Checkpoint(path)
        assert tc.is_lora and not tc.has("model") and tc.step == 3
        got = tc.load_lora()
        jc = jckpt.Checkpoint(path)
        assert jc.is_lora
        jgot = jc.load_lora(like)
        for k, v in lora.items():
            assert str(got[k].dtype) == f"torch.{leaf_dtype}"
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(v, np.float32))
            np.testing.assert_array_equal(np.asarray(jgot[k], np.float32),
                                          np.asarray(v, np.float32))


def _ref_lora_pt(path, cfg, rank, alpha, seed):
    """A reference-schema LoRA .pt (reference: train.py:402-427, the
    wrapped linears of model.py:419-430): base keys with a `.w.` segment
    and the adapters as `.lora_a/.lora_b` (out, in) weights, the configs
    pickled as dataclasses of a throwaway module."""
    mod = types.ModuleType("ref_model_for_lora_test")

    @dataclasses.dataclass
    class TrainConfig:
        lora_rank: int = 16
        lora_alpha: int = 32

    TrainConfig.__module__ = mod.__name__
    TrainConfig.__qualname__ = "TrainConfig"
    mod.TrainConfig = TrainConfig
    g = torch.Generator().manual_seed(seed)
    E, HD = cfg.n_embd, cfg.n_head * cfg.head_dim
    KD = cfg.n_kv_head * cfg.head_dim
    outs = {"wq": (HD, E), "wk": (KD, E), "wv": (KD, E), "wo": (E, HD)}
    sd = {}
    for i in range(cfg.n_layer):
        for proj, (out, inn) in outs.items():
            p = f"_orig_mod.layers.{i}.attention.{proj}."
            sd[p + "w.weight"] = torch.randn(out, inn, generator=g)
            sd[p + "lora_a.weight"] = torch.randn(rank, inn, generator=g)
            sd[p + "lora_b.weight"] = torch.randn(out, rank, generator=g)
    ck = {"version": "2024.10", "is_lora": True, "lora": sd,
          "optimizer": {}, "step_count": 7,
          "train_config": TrainConfig(lora_rank=rank, lora_alpha=alpha),
          "model_config": dict(TINY)}
    sys.modules[mod.__name__] = mod
    try:
        torch.save(ck, path)
    finally:
        del sys.modules[mod.__name__]


def test_import_lora_equals_jax(tmp_path):
    path = str(tmp_path / "lora.pt")
    _ref_lora_pt(path, JConfig(**TINY), rank=4, alpha=8, seed=3)
    want, wr, wa = jpt.import_lora(path, JConfig(**TINY))
    got, gr, ga = tpt.import_lora(path, TConfig(**TINY))
    assert (gr, ga) == (wr, wa) == (4, 8)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="import_lora"):
        tpt.import_checkpoint(path)
    with pytest.raises(ValueError, match="not a LoRA"):
        base = str(tmp_path / "base.pt")
        torch.save({"is_lora": False}, base)
        tpt.import_lora(base, TConfig(**TINY))


@pytest.fixture(scope="module")
def ckpts(tiny, tmp_path_factory):
    """A base .npz checkpoint and a LoRA-only one (rank 4, alpha 8)."""
    cfg, params, tok, _ = tiny
    d = tmp_path_factory.mktemp("ck")
    base, lora = str(d / "base.npz"), str(d / "lora.npz")
    jckpt.save_checkpoint(base, params=params, step=5, model_config=TINY,
                          tokenizer_config=tok.config)
    tckpt.save_checkpoint(lora, lora={k: torch.from_numpy(v) for k, v in
                                      random_lora(cfg, 4, 11).items()},
                          step=3, model_config=TINY,
                          train_config={"lora_rank": 4, "lora_alpha": 8},
                          tokenizer_config=tok.config)
    return base, lora


@pytest.mark.parametrize("case", ["lora", "merge_bin", "merge_npz_q80"])
def test_export_lora_outputs_equal_root_export(tiny, ckpts, tmp_path,
                                               monkeypatch, case):
    import export as root_export
    _, _, _, paths = tiny
    base, lora = ckpts
    args = {"lora": ["--lora", lora],
            "merge_bin": ["--checkpoint", base, "--merge-lora", paths["b"]],
            "merge_npz_q80": ["--quant", base, "--merge-lora", lora]}[case]
    ours, theirs = str(tmp_path / "o.bin"), str(tmp_path / "r.bin")
    texport.main([ours] + args)
    monkeypatch.setattr(sys, "argv", ["export.py", theirs] + args)
    root_export.main()
    assert _read(ours) == _read(theirs)
    if case == "lora":
        bl = tbin.read_lora(ours, TConfig(**TINY))
        assert (bl.rank, bl.alpha) == (4, 8)


def test_merged_export_serves_as_base_plus_adapter(tiny, ckpts, tmp_path):
    """The --merge-lora f32 export against the base checkpoint with the
    adapter attached: the same greedy stream."""
    _, _, _, paths = tiny
    base, lora = ckpts
    merged = str(tmp_path / "m.bin")
    texport.main([merged, "--checkpoint", base, "--merge-lora", lora])
    m = teng.LLMContext.from_bin(merged, dtype=torch.float32, device="cpu",
                                 sampler=tsamp.SamplerConfig(**GREEDY))
    c = teng.LLMContext.from_checkpoint(base, dtype=torch.float32,
                                        device="cpu",
                                        sampler=tsamp.SamplerConfig(**GREEDY))
    c.load_lora_checkpoint(lora)
    assert c.lora_scale == 2.0 and c.lora["wq_a"].shape == (2, 64, 4)
    ids = c.encode("abcdefg")
    want = teng.generate_on_device(c, ids, 12).tolist()
    assert teng.generate_on_device(m, ids, 12).tolist() == want
    c.unload_lora()
    assert teng.generate_on_device(c, ids, 12).tolist() != want
    with pytest.raises(ValueError, match="LoRA-only checkpoint"):
        teng.LLMContext.from_checkpoint(lora, device="cpu")


# =====================================================================
# adapters served
# =====================================================================

def test_tiny_fixture_with_lora_equals_expected_and_jax():
    import json
    with open(os.path.join(FIX, "expected.json")) as f:
        expected = json.load(f)
    jctx, tctx = ctxs(os.path.join(FIX, "tiny_f32.bin"))
    for c in (jctx, tctx):
        c.load_lora(os.path.join(FIX, "tiny_lora.bin"))
    assert tctx.lora_scale == jctx.lora_scale == 2.0
    s = teng.generate_sync(tctx, expected["prompt"], max_new_tokens=16)
    assert s.output_ids == expected["greedy"]["f32_lora"]
    ids = tctx.encode(expected["prompt"])
    assert (teng.generate_on_device(tctx, ids, 24).tolist()
            == jeng.generate_on_device(jctx, ids, 24).tolist())


def _swap_streams(jctx, tctx, paths, ids, n):
    """Base, adapter a, adapter b (a swap), base again (an unload) on both
    contexts -> {stage: (JAX stream, port stream)}."""
    out = {}
    for stage, path in (("base", None), ("a", paths["a"]),
                        ("b", paths["b"]), ("unloaded", None)):
        for c in (jctx, tctx):
            if path:
                c.load_lora(path)
            else:
                c.unload_lora()
        out[stage] = (jeng.generate_on_device(jctx, ids, n).tolist(),
                      teng.generate_on_device(tctx, ids, n).tolist())
    return out


def _hot_swap_case(tiny, quant, n):
    _, _, _, paths = tiny
    jctx, tctx = ctxs(paths[quant], quant)
    ids = tctx.encode("abcdef")
    got = _swap_streams(jctx, tctx, paths, ids, n)
    for stage, (want, ours) in got.items():
        assert ours == want, stage
    assert got["base"][1] == got["unloaded"][1]
    assert got["a"][1] != got["base"][1] and got["b"][1] != got["a"][1]
    # a fresh context with the adapter of each stage gives its stream
    for stage in ("a", "b"):
        fresh = ctxs(paths[quant], quant)[1]
        fresh.load_lora(paths[stage])
        assert teng.generate_on_device(fresh, ids, n).tolist() == \
            got[stage][1], stage


@pytest.mark.parametrize("quant", ["f32", "q80"])
def test_hot_swap_swap_and_unload_equal_jax(tiny, quant):
    _hot_swap_case(tiny, quant, 10)


def test_hot_swap_on_a_q4k_base_equals_jax(tiny, jax_q4k_op_by_op):
    _hot_swap_case(tiny, "q4k", 6)


def test_swap_inside_a_session_equals_jax(tiny):
    """An adapter attached, swapped and detached between two steps of one
    Session: the next step decodes with it, as the JAX Session's does."""
    _, _, _, paths = tiny
    jctx, tctx = ctxs(paths["f32"])
    streams = []
    for eng, c in ((jeng, jctx), (teng, tctx)):
        s = eng.Session(c, "abcdef", max_new_tokens=12)
        got = []
        for i, path in enumerate([None, None, paths["a"], None, paths["b"],
                                  None, "unload", None, None, None]):
            if path == "unload":
                c.unload_lora()
            elif path:
                c.load_lora(path)
            got.append(s.step())
        streams.append(got)
    assert streams[1] == streams[0]


def test_clone_with_lora_shares_the_base(tiny):
    _, _, _, paths = tiny
    _, base = ctxs(paths["f32"])
    ids = base.encode("abcdef")
    plain = teng.generate_on_device(base, ids, 8).tolist()
    variant = base.clone_with_lora(paths["a"])
    assert variant.params is base.params and base.lora is None
    fresh = ctxs(paths["f32"])[1]
    fresh.load_lora(paths["a"])
    assert teng.generate_on_device(variant, ids, 8).tolist() == \
        teng.generate_on_device(fresh, ids, 8).tolist() != plain
    assert teng.generate_on_device(base, ids, 8).tolist() == plain


def test_decoder_keeps_graphs_by_adapter_shape(tiny):
    """The decoder's adapter buffers: an adapter of the same rank is copied
    into them, also after a detach (the graphs that read them stay), and
    another rank replaces them and drops the graphs keyed by the old
    shape; the base graph stays throughout."""
    _, _, _, paths = tiny
    _, tctx = ctxs(paths["f32"])
    ids = tctx.encode("abc")
    teng.generate_on_device(tctx, ids, 3)
    dec = tctx.decoder()
    tctx.load_lora(paths["a"])
    teng.generate_on_device(tctx, ids, 3)
    bufs = dec.adapter.lora
    assert {k[-1] for k in dec.graphs} == {None, (2, 64, 2)}
    tctx.unload_lora()
    teng.generate_on_device(tctx, ids, 3)
    assert dec.adapter.lora is None and dec.adapter.key is None
    tctx.load_lora(paths["a"])                 # same rank: copied in
    teng.generate_on_device(tctx, ids, 3)
    assert dec.adapter.lora is bufs
    assert {k[-1] for k in dec.graphs} == {None, (2, 64, 2)}
    tctx.load_lora(paths["b"])                 # rank 4: new buffers
    teng.generate_on_device(tctx, ids, 3)
    assert dec.adapter.lora is not bufs
    assert {k[-1] for k in dec.graphs} == {None, (2, 64, 4)}


def test_speculative_decode_with_an_adapter_equals_jax(tiny):
    _, _, _, paths = tiny
    jctx, tctx = ctxs(paths["f32"])
    for c in (jctx, tctx):
        c.load_lora(paths["b"])
        c.spec_k = 4
    ids = tctx.encode("abcabcabcabcabcabc")
    want = jeng.generate_on_device(jctx, ids, 20).tolist()
    assert teng.generate_on_device(tctx, ids, 20).tolist() == want
    s = teng.generate_sync(tctx, "abcabcabcabcabcabc", max_new_tokens=20)
    assert s.output_ids == want[:len(s.output_ids)] and s.steps_by["round"]
    tctx.spec_k = 0                           # plain decode, same stream
    assert teng.generate_on_device(tctx, ids, 20).tolist() == want


@pytest.mark.parametrize("spec_k", [0, 3])
def test_batched_engine_with_two_adapters_equals_jax(tiny, spec_k):
    """Adapters of ranks 2 and 4 and base slots in one BatchedEngine:
    every stream token-identical to the JAX engine's and to the stream of
    a context with that adapter alone."""
    _, _, _, paths = tiny
    jctx, tctx = ctxs(paths["f32"])
    adapters = {"a": paths["a"], "b": paths["b"]}
    joins = [("abcdef", "a"), ("ghijk", None), ("abcabcabc", "b"),
             ("lmnopq", "a"), ("rstu", "b")]
    streams = []
    for batching, c in ((jbatch, jctx), (tbatch, tctx)):
        c.spec_k = spec_k
        be = batching.BatchedEngine(c, n_slots=4, adapters=adapters)
        got, live = {}, {}             # join -> tokens, slot -> join

        def join(i):
            prompt, name = joins[i]
            slot, first = be.add(c.encode(prompt), max_new_tokens=10,
                                 temperature=0.0, repetition_penalty=1.0,
                                 adapter=name)
            got[i], live[slot] = [first], i

        for i in range(4):
            join(i)
        while be.n_active:
            res = be.step_burst(2)
            for slot, toks in res.items():
                got[live[slot]].extend(toks)
            for slot in [s_ for s_, e in res.ended.items() if e]:
                del live[slot]
                be.release(slot)
                if 4 not in got:
                    # the freed slot takes the fifth join, with its own
                    # adapter: the same graphs, another row of the stack
                    join(4)
        streams.append(got)
    assert streams[1] == streams[0]
    assert len(streams[1]) == 5
    if spec_k == 0:
        tc = tbatch.BatchedEngine(tctx, n_slots=2, adapters=adapters)
        assert tc.lora_stack["wq_a"].shape == (2, 3, 64, 4)
        assert tc.lora_scales.tolist() == [0.0, 2.0, 2.0]
    for i, (prompt, name) in enumerate(joins):
        solo = ctxs(paths["f32"])[1]
        if name:
            solo.load_lora(paths[name])
        want = teng.generate_on_device(solo, solo.encode(prompt),
                                       len(streams[1][i])).tolist()
        assert streams[1][i] == want, i


def test_batched_engine_serves_a_base_attached_adapter(tiny):
    _, _, _, paths = tiny
    jctx, tctx = ctxs(paths["f32"])
    outs = []
    for batching, c in ((jbatch, jctx), (tbatch, tctx)):
        c.load_lora(paths["a"])
        be = batching.BatchedEngine(c, n_slots=2)
        slot, first = be.add(c.encode("abcdef"), max_new_tokens=8,
                             temperature=0.0, repetition_penalty=1.0)
        toks = [first]
        while be.n_active:
            toks.extend(be.step().get(slot, []))
        outs.append(toks)
    assert outs[1] == outs[0]
    assert outs[1] == teng.generate_on_device(
        tctx, tctx.encode("abcdef"), 8).tolist()


@pytest.fixture(scope="module")
def qwen_tiny_q80():
    """Qwen3-shaped random Q80 weights at group size 256 (the W8A8
    products; as tests/test_torch_slice.py's _random_q80_params), both
    packages'."""
    from nano_tpu.ops.qmatmul import Q80Tensor as JQ80
    cfg = JConfig(**QWEN3_TINY)
    rng = np.random.RandomState(0)

    def qt(*shape, inn):
        q = rng.randint(-127, 128, shape).astype(np.int8)
        s = (rng.rand(*shape[:-1], inn // 256).astype(np.float32) * 0.02
             + 1e-3)
        return JQ80(q=q, scales=s, group_size=256)

    grouped = lambda t: jax.tree.map(np.asarray, t.to_grouped())

    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_hidden, cfg.vocab_size
    HD, KVD, D = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim, \
        cfg.head_dim
    norm = lambda *s: (1.0 + 0.1 * rng.randn(*s)).astype(np.float32)
    blocks = {"attn_norm": norm(L, E), "ffn_norm": norm(L, E),
              "q_norm": norm(L, D), "k_norm": norm(L, D)}
    for name, out, inn in (("wqkv", HD + 2 * KVD, E), ("wo", E, HD),
                           ("w13", 2 * F, E), ("w2", E, F)):
        blocks[name] = grouped(qt(L, out, inn, inn=inn))
    tok = qt(V, E, inn=E)
    tree = {"tok_embeddings": tok, "output_q": grouped(tok),
            "norm": norm(E), "blocks": blocks}
    return (cfg, TConfig(**QWEN3_TINY), jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


def test_w8a8_prefill_and_batched_step_with_adapters_match_jax(
        qwen_tiny_q80):
    """The W8A8 path, where the attention norm writes the int8 rows and,
    for the adapter, the normed tensor beside them: a prefill with one
    adapter, then a batched step whose rows take adapters from a stack
    (JAX: its per-slot form on the rows' gathered adapters)."""
    jcfg, tcfg, jp, tp = qwen_tiny_q80
    lo = [random_lora(jcfg, 4, 20, 0.05), random_lora(jcfg, 4, 21, 0.05)]
    prompt = [5, 17, 300, 42, 99, 7, 256, 1, 64]
    n, pad, T, B = len(prompt), 16, 32, 3
    ids = np.zeros((1, pad), np.int64)
    ids[0, :n] = prompt
    jl, jc = jgpt.forward_with_cache(
        jp, jnp.asarray(ids, jnp.int32),
        jgpt.KVCache.create(jcfg, 1, T, jnp.float32), jnp.int32(0), jcfg,
        dtype=jnp.float32, lora=jax.tree.map(jnp.asarray, lo[0]),
        lora_scale=2.0, attn_len=pad, last_idx=jnp.int32(n - 1))
    tc = tgpt.KVCache.create(tcfg, 1, T, torch.float32)
    tl, _ = tgpt.forward_with_cache(
        tp, torch.from_numpy(ids), tc, 0, tcfg, dtype=torch.float32,
        attn_len=pad, last_idx=n - 1,
        lora={k: torch.from_numpy(v) for k, v in lo[0].items()},
        lora_scale=2.0)
    want, got = np.asarray(jl)[:, 0], tl[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())

    # B rows at their own positions, each with its own adapter
    stack = {k: np.stack([np.zeros_like(lo[0][k]), lo[0][k], lo[1][k]])
             for k in lo[0]}                          # (A, L, in, r)
    scales = np.array([0.0, 2.0, 0.5], np.float32)
    idx = np.array([2, 0, 1])
    jcache = jgpt.KVCache(k=jnp.tile(jc.k, (1, B, 1, 1, 1)),
                          v=jnp.tile(jc.v, (1, B, 1, 1, 1)))
    tcache = tgpt.KVCache(k=tc.k.repeat(1, B, 1, 1, 1).contiguous(),
                          v=tc.v.repeat(1, B, 1, 1, 1).contiguous())
    tok = np.array([int(np.argmax(want))] * B)
    pos = np.array([n, n, n])
    sel, sc = jbatch._select_adapters(
        jax.tree.map(jnp.asarray, stack), jnp.asarray(scales),
        jnp.asarray(idx))
    jl, _ = jgpt.forward_decode_batched(
        jp, jnp.asarray(tok, jnp.int32), jcache, jnp.asarray(pos, jnp.int32),
        jcfg, dtype=jnp.float32, lora=sel, lora_scale=sc)
    tl, _ = tgpt.forward_decode_batched(
        tp, torch.from_numpy(tok), tcache,
        torch.from_numpy(pos).to(torch.int32), tcfg, dtype=torch.float32,
        lora={k: torch.from_numpy(np.ascontiguousarray(v.swapaxes(0, 1)))
              for k, v in stack.items()},             # (L, A, in, r)
        lora_scale=torch.from_numpy(scales), lora_idx=torch.from_numpy(idx))
    want, got = np.asarray(jl), tl.numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # the three rows differ: each took its own adapter
    assert np.abs(got[0] - got[1]).max() > 1e-3
    assert np.abs(got[1] - got[2]).max() > 1e-3
