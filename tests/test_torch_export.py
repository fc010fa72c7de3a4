"""The port's .bin writer and export entry point against the JAX
package's: the Q4K weight quantizer and tensor frames, write_model at
f32 / q80 / q4k (Nano with a partial Q4K block, Qwen3 with qk norms,
Qwen2 with biases, a non-default RoPE theta, a BPE tokenizer field),
repack of the committed fixtures, a checkpoint of the port's Trainer
through both export entry points, and from_checkpoint's greedy stream.
Every comparison is exact: bytes, arrays or tokens."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.io import binfmt as jbin
from nano_tpu.ops import q4k as jq4k
from nano_tpu.ops import sampling as jsamp
from nano_tpu.tokenizer import bpe as jbpe
from nano_tpu.tokenizer.trie import TrieTokenizer as JTrie
from nano_tpu_torch import export as texport
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.data import preprocess
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.io import binfmt as tbin
from nano_tpu_torch.io import checkpoint as tckpt
from nano_tpu_torch.ops import q4k as tq4k
from nano_tpu_torch.ops import sampling as tsamp
from nano_tpu_torch.tokenizer import bpe as tbpe
from nano_tpu_torch.tokenizer.trie import TrieTokenizer
from nano_tpu_torch.train import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "js", "fixtures")
GREEDY = dict(temperature=0.0, repetition_penalty=1.0)

# n_hidden 176: the FFN's input lines end in a partial Q4K block
NANO = dict(block_size=64, vocab_size=60, n_layer=2, n_embd=64, n_head=4,
            n_kv_head=2, n_hidden=176)
QWEN3 = dict(block_size=64, vocab_size=256, n_layer=2, n_embd=64, n_head=2,
             n_kv_head=1, n_hidden=96, head_dim=32, use_qk_norm=True,
             rope_style="half", rope_theta=1e6, norm_eps=1e-6)
QWEN2 = dict(block_size=64, vocab_size=256, n_layer=3, n_embd=64, n_head=2,
             n_kv_head=1, n_hidden=96, head_dim=32, qkv_bias=True,
             rope_theta=1e6, norm_eps=1e-6, tie_embeddings=False)


def _params(cfg: dict, seed: int = 0):
    """Checkpoint-layout f32 params from a numpy seed."""
    c = JModelConfig(**cfg)
    rng = np.random.RandomState(seed)
    L, E, V, F = c.n_layer, c.n_embd, c.vocab_size, c.n_hidden
    HD, KVD = c.n_head * c.head_dim, c.n_kv_head * c.head_dim

    def w(*s):
        return (rng.randn(*s) * 0.05).astype(np.float32)

    blocks = {"attn_norm": w(L, E) + 1, "ffn_norm": w(L, E) + 1,
              "wq": w(L, E, HD), "wk": w(L, E, KVD), "wv": w(L, E, KVD),
              "wo": w(L, HD, E), "w1": w(L, E, F), "w2": w(L, F, E),
              "w3": w(L, E, F)}
    if c.use_qk_norm:
        blocks["q_norm"] = w(L, c.head_dim) + 1
        blocks["k_norm"] = w(L, c.head_dim) + 1
    if c.qkv_bias:
        blocks.update(bq=w(L, HD), bk=w(L, KVD), bv=w(L, KVD))
    p = {"tok_embeddings": w(V, E), "norm": w(E) + 1, "blocks": blocks}
    if not c.tie_embeddings:
        p["output"] = w(E, V)
    return p


def _as_tensors(tree):
    return {k: _as_tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _trie_config(n: int) -> dict:
    tok = JTrie()
    tok.build([chr(ord("a") + i) for i in range(26)]
              + [chr(0x4e00 + i) for i in range(n - 30)])
    return tok.config


def _toy_bpe(mod):
    vocab = [b"<pad>", b"<unk>", b"<s>"] + [bytes([i]) for i in range(249)]
    merges = [b"he", b"hel", b"hell", b"hello"]
    scores = [0.0] * len(vocab) + [-(i + 1.0) for i in range(len(merges))]
    return mod.BpeTokenizer(vocab + merges, scores)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------
# the Q4K weight quantizer
# ---------------------------------------------------------------------

def _lines(kind, rows, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, n).astype(np.float32)
    if kind == "zero_groups":           # all-zero 32-groups: s == 0
        x[:, :64] = 0.0
        x[0] = 0.0
    elif kind == "negative":            # all-negative groups
        x = -np.abs(x) - 0.01
    elif kind == "positive":            # all-positive groups: b == 0
        x = np.abs(x) + 0.01
    elif kind == "tiny":                # denormal-scale groups
        x = x * np.float32(1e-40)
    return x


@pytest.mark.parametrize("kind", ["random", "zero_groups", "negative",
                                  "positive", "tiny"])
@pytest.mark.parametrize("n", [40, 176, 256, 300, 512])
def test_quantize_lines_bytes_equal_jax(kind, n):
    x = _lines(kind, 5, n, seed=n)
    got = tq4k.quantize_lines_np(x)
    want = jq4k.quantize_lines_np(x)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    # the port's reader inverts it as the JAX reader does
    np.testing.assert_array_equal(
        tq4k.dequantize_lines_np(got, 5, n),
        jq4k.dequantize_lines_np(want, 5, n))


@pytest.mark.parametrize("shape", [(176,), (3, 96), (2, 5, 176), (7, 256)])
def test_pack_tensor_frame_bytes_equal_jax(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    x.reshape(-1)[:32] = 0.0
    got = tq4k.pack_tensor_frame(x)
    assert got == jq4k.pack_tensor_frame(x)
    blocks, fshape, end = tq4k.parse_tensor_frame(got, 0)
    assert fshape == shape and end == len(got)


def test_q4k_tensor_stack_is_contiguous_and_layered():
    x = np.random.RandomState(2).randn(2, 8, 176).astype(np.float32)
    ts = [tq4k.Q4KTensor.from_blocks(tq4k.quantize_lines_np(x[i]), 8, 176)
          for i in range(2)]
    st = tq4k.Q4KTensor.stack(ts)
    assert st.packed.shape == (2, 8, 128) and st.packed.is_contiguous()
    assert st.in_dim == 176
    for i in range(2):
        assert torch.equal(st.layer(i).dequantize(), ts[i].dequantize())


# ---------------------------------------------------------------------
# write_model
# ---------------------------------------------------------------------

CASES = [
    ("nano", NANO, jbin.MODEL_TYPE_NANO, ("f32", "q80", "q4k")),
    ("nano_theta", dict(NANO, rope_theta=5e5), jbin.MODEL_TYPE_NANO,
     ("f32", "q80", "q4k")),
    ("qwen3", QWEN3, jbin.MODEL_TYPE_QWEN3, ("f32", "q80", "q4k")),
    ("qwen2", QWEN2, jbin.MODEL_TYPE_QWEN2, ("f32", "q80")),
]


@pytest.mark.parametrize("group_size", [256, 32])
@pytest.mark.parametrize("name,cfg,model_type,quants", CASES,
                         ids=[c[0] for c in CASES])
def test_write_model_bytes_equal_jax(tmp_path, name, cfg, model_type, quants,
                                     group_size):
    params = _params(cfg, seed=len(name))
    if model_type == jbin.MODEL_TYPE_NANO:
        jtok = ttok = _trie_config(cfg["vocab_size"])
    else:
        jtok, ttok = _toy_bpe(jbpe), _toy_bpe(tbpe)
    for quant in quants:
        jp, tp = str(tmp_path / f"j_{quant}.bin"), str(tmp_path / f"t_{quant}.bin")
        jbin.write_model(jp, params, JModelConfig(**cfg), jtok, quant=quant,
                         group_size=group_size, model_type=model_type)
        tbin.write_model(tp, _as_tensors(params), ModelConfig(**cfg), ttok,
                         quant=quant, group_size=group_size,
                         model_type=model_type)
        assert _read(tp) == _read(jp), (name, quant)
        hdr = tbin.parse_header(_read(tp))
        assert hdr.rope_theta == (cfg.get("rope_theta", 1e4)
                                  if name == "nano_theta" else 0.0)


def test_write_model_takes_bf16_tensors_as_f32(tmp_path):
    params = _params(NANO)
    bf = jax.tree.map(lambda a: torch.from_numpy(a).bfloat16(), params)
    as32 = jax.tree.map(lambda t: t.float().numpy(), bf)
    tok = _trie_config(NANO["vocab_size"])
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    tbin.write_model(a, bf, ModelConfig(**NANO), tok, quant="q80")
    jbin.write_model(b, as32, JModelConfig(**NANO), tok, quant="q80")
    assert _read(a) == _read(b)


def test_write_model_refusals(tmp_path):
    out = str(tmp_path / "x.bin")
    with pytest.raises(ValueError, match="shared classifier"):
        tbin.write_model(out, _params(QWEN2), ModelConfig(**QWEN2),
                         _toy_bpe(tbpe), quant="q4k",
                         model_type=tbin.MODEL_TYPE_QWEN2)
    with pytest.raises(ValueError, match="unsupported quant"):
        tbin.write_model(out, _params(NANO), ModelConfig(**NANO),
                         _trie_config(NANO["vocab_size"]), quant="q5")


@pytest.mark.parametrize("src", ["tiny_f32.bin", "tiny_q80.bin",
                                 "tiny_q4k.bin"])
@pytest.mark.parametrize("quant", ["f32", "q80", "q4k"])
def test_repack_fixture_bytes_equal_jax(tmp_path, src, quant):
    path = os.path.join(FIX, src)
    jp, tp = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jbin.repack(path, jp, quant=quant, group_size=64)
    tbin.repack(path, tp, quant=quant, group_size=64)
    assert _read(tp) == _read(jp)


def test_repack_f32_to_f32_is_identity(tmp_path):
    path = os.path.join(FIX, "tiny_f32.bin")
    out = str(tmp_path / "same.bin")
    tbin.repack(path, out, quant="f32")
    assert _read(out) == _read(path)


# ---------------------------------------------------------------------
# a checkpoint of the port's Trainer through both export entry points
# ---------------------------------------------------------------------

TRAIN = dict(block_size=32, vocab_size=128, n_layer=2, n_embd=32, n_head=4,
             n_kv_head=2, n_hidden=64)
CORPUS = ("the quick brown fox jumps over the lazy dog. " * 200 +
          "pack my box with five dozen liquor jugs. " * 200)


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """Two CPU steps of the port's Trainer, then its checkpoint."""
    d = tmp_path_factory.mktemp("export")
    tok = TrieTokenizer()
    tok.build_from_text(CORPUS)
    tok_path = str(d / "tok.json")
    tok.dump_config_file(tok_path)
    corpus = str(d / "corpus.txt")
    with open(corpus, "w") as f:
        f.write(CORPUS)
    train_p, val_p = preprocess.generate_pretrain_dataset(
        [corpus], tok, block_size=TRAIN["block_size"],
        output_prefix=str(d / "pt"))
    tc = dict(batch_size=8, gradient_accumulation_steps=1,
              learning_rate=3e-3, warmup_iters=1, lr_decay_iters=10,
              eval_interval=1000, eval_iters=1, log_interval=1,
              tokenizer_path=tok_path, dataset_path=[[train_p, val_p]],
              dtype="float32", save_checkpoint_to=str(d / "ck.npz"),
              random_seed=0)
    t = ttrainer.Trainer(TRAIN, tc, max_steps=2, device="cpu")
    t.init()
    t.load_data()
    t.start()
    return str(d / "ck.npz")


@pytest.mark.parametrize("flag,quant", [("--checkpoint", "f32"),
                                        ("--quant", "q80"),
                                        ("--q4k", "q4k")])
def test_export_entry_points_bytes_equal(trained_ckpt, tmp_path, monkeypatch,
                                         capsys, flag, quant):
    import export as root_export
    ours, theirs = str(tmp_path / "ours.bin"), str(tmp_path / "root.bin")
    texport.main([ours, flag, trained_ckpt])
    monkeypatch.setattr(sys, "argv", ["export.py", theirs, flag, trained_ckpt])
    root_export.main()
    out = capsys.readouterr().out
    assert out.count(f"exported {quant} ->") == 2
    assert _read(ours) == _read(theirs)
    # the trained f32 masters go to the writer as they are
    if quant == "f32":
        bm = tbin.read_model(ours)
        ck = tckpt.Checkpoint(trained_ckpt).load_params()
        np.testing.assert_array_equal(
            bm.params["blocks"]["w2"], ck["blocks"]["w2"].numpy())


def test_export_runs_as_a_module(trained_ckpt, tmp_path):
    import subprocess
    out = str(tmp_path / "m.bin")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "nano_tpu_torch.export", out,
                        "--quant", trained_ckpt], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "exported q80" in r.stdout
    assert tbin.parse_header(_read(out)).quant_type == tbin.QUANT_Q80


def test_export_lora_is_refused(trained_ckpt, tmp_path, monkeypatch):
    """The one LoRA export both entry points refuse: a reference LoRA .pt,
    which carries no base config (--lora of an .npz: test_torch_lora.py)."""
    import export as root_export
    argv = [str(tmp_path / "l.bin"), "--lora", str(tmp_path / "lora.pt")]
    with pytest.raises(SystemExit, match="needs the base config"):
        texport.main(argv)
    monkeypatch.setattr(sys, "argv", ["export.py"] + argv)
    with pytest.raises(SystemExit, match="needs the base config"):
        root_export.main()


def test_export_repack_entry_point(tmp_path):
    out = str(tmp_path / "r.bin")
    want = str(tmp_path / "w.bin")
    texport.main([out, "--repack", os.path.join(FIX, "tiny_q80.bin"),
                  "--to", "q4k"])
    jbin.repack(os.path.join(FIX, "tiny_q80.bin"), want, quant="q4k",
                group_size=256)
    assert _read(out) == _read(want)


def test_from_checkpoint_stream_equals_jax_and_from_bin(trained_ckpt,
                                                        tmp_path):
    jctx = jeng.LLMContext.from_checkpoint(
        trained_ckpt, dtype=jnp.float32,
        sampler=jsamp.SamplerConfig(**GREEDY))
    tctx = teng.LLMContext.from_checkpoint(
        trained_ckpt, dtype=torch.float32, device="cpu",
        sampler=tsamp.SamplerConfig(**GREEDY))
    assert tctx.device.type == "cpu"
    assert tctx.params["blocks"]["wq"].dtype == torch.float32
    ids = tctx.encode("the quick brown")
    assert ids == jctx.encode("the quick brown")
    want = jeng.generate_on_device(jctx, ids, 24).tolist()
    got = teng.generate_on_device(tctx, ids, 24).tolist()
    assert got == want
    f32 = str(tmp_path / "own.bin")
    texport.main([f32, "--checkpoint", trained_ckpt])
    bctx = teng.LLMContext.from_bin(f32, dtype=torch.float32, device="cpu",
                                    sampler=tsamp.SamplerConfig(**GREEDY))
    assert teng.generate_on_device(bctx, ids, 24).tolist() == want


def test_from_checkpoint_bf16_and_lora_only(trained_ckpt, tmp_path):
    ctx = teng.LLMContext.from_checkpoint(trained_ckpt, device="cpu")
    assert ctx.params["blocks"]["w1"].dtype == torch.bfloat16
    assert ctx.params["norm"].dtype == torch.float32
    lora_only = str(tmp_path / "lora.npz")
    from nano_tpu.io import checkpoint as jckpt
    jckpt.save_checkpoint(
        lora_only, lora={"wq_a": np.zeros((2, 32, 4), np.float32)},
        model_config=TRAIN, tokenizer_config=ctx.tokenizer.config)
    with pytest.raises(ValueError, match="LoRA-only checkpoint"):
        teng.LLMContext.from_checkpoint(lora_only, device="cpu")
