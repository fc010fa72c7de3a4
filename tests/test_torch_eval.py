"""PPL evaluation of the port (nano_tpu_torch.eval) against the root
eval.py's model_ppl on the CPU.

tests/js/fixtures/tiny_{f32,q80,q4k}.bin over the start of
dataset/pretrain_sample.txt, windows of the model's 64 tokens with a
stride of 24 (overlapping windows score only their new targets), and a
training checkpoint through from_checkpoint.  The JAX side runs with
NANO_TPU_DEQUANT=f32 (its default dequantizes Q80 and Q4K weights to bf16
for the dot on a non-TPU backend; the port's CPU path is f32), and the Q4K
file op by op (`jax.disable_jit()`): jitted on the CPU, XLA folds the
fake-quant's rounding away, so only the op-by-op JAX functions compute the
C engine's activation quantization.  Then both are the same f32
arithmetic with sums in another order: PPL within 1e-5 relative."""

import contextlib
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

import eval as root_eval
from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.io import checkpoint as jckpt
from nano_tpu.models import gpt as jgpt
from nano_tpu.tokenizer.trie import TrieTokenizer as JTrieTokenizer
from nano_tpu_torch import eval as teval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "js", "fixtures")
TOL = 1e-5


@pytest.fixture(scope="module")
def text():
    with open(os.path.join(ROOT, "dataset", "pretrain_sample.txt"),
              encoding="utf-8") as f:
        return f.read()[:500]


@pytest.fixture
def f32_dequant(monkeypatch):
    monkeypatch.setenv("NANO_TPU_DEQUANT", "f32")
    jax.clear_caches()
    yield
    monkeypatch.delenv("NANO_TPU_DEQUANT")
    jax.clear_caches()


def _jax_ppl(path, text, block_size=0, stride=0):
    ctx = (jax.disable_jit() if path.endswith("q4k.bin")
           else contextlib.nullcontext())
    with ctx:
        return root_eval.model_ppl(path, text, block_size, stride)


@pytest.mark.parametrize("quant", ["f32", "q80", "q4k"])
def test_model_ppl_matches_the_root_eval(f32_dequant, text, quant):
    path = os.path.join(FIX, f"tiny_{quant}.bin")
    want = _jax_ppl(path, text, 0, 24)
    got = teval.model_ppl(path, text, 0, 24, device="cpu")
    assert np.isfinite(got) and got > 1.0
    assert abs(got - want) <= TOL * want, (got, want)


@pytest.mark.parametrize("block_size,stride", [(32, 32), (32, 7), (16, 40)])
def test_window_sizes_and_strides(f32_dequant, text, block_size, stride):
    """A window below the model's and strides below, at and above it (a
    stride past the window skips the targets between: the JAX
    accounting's, kept)."""
    path = os.path.join(FIX, "tiny_f32.bin")
    want = root_eval.model_ppl(path, text, block_size, stride)
    got = teval.model_ppl(path, text, block_size, stride, device="cpu")
    assert abs(got - want) <= TOL * want, (got, want)


@pytest.mark.parametrize("n,S,stride", [(2, 64, 64), (100, 64, 24),
                                        (64, 64, 64), (65, 64, 64),
                                        (300, 32, 1), (300, 32, 31)])
def test_every_target_is_counted_once(n, S, stride):
    seen = []
    for start, valid, lo in teval.windows(n, S, stride):
        assert 1 <= valid <= S and 0 <= lo < valid
        seen.extend(range(start + 1 + lo, start + 1 + valid))
    assert seen == list(range(1, n))


def test_too_short_a_text_is_refused():
    ctx = teval.load_context(os.path.join(FIX, "tiny_f32.bin"), "cpu")
    with pytest.raises(ValueError, match="too short"):
        teval.ids_ppl(ctx, [3])


def test_a_checkpoint_through_from_checkpoint(tmp_path, text):
    """A JAX-package training checkpoint (random weights, the char
    tokenizer of the text) scored by both packages."""
    tok = JTrieTokenizer()
    tok.build_from_text(text)
    cfg = dict(block_size=48, vocab_size=tok.vocab_size, n_layer=2,
               n_embd=64, n_head=4, n_kv_head=2, n_hidden=128)
    params = jax.tree.map(np.asarray, jgpt.init_params(
        jax.random.PRNGKey(4), JModelConfig(**cfg)))
    path = str(tmp_path / "ck.npz")
    jckpt.save_checkpoint(path, params=params, step=3, model_config=cfg,
                          train_config={}, tokenizer_config=tok.config)
    want = root_eval.model_ppl(path, text, 0, 20)
    got = teval.model_ppl(path, text, 0, 20, device="cpu")
    assert abs(got - want) <= TOL * want, (got, want)


def _lines(out):
    return [ln.split(": ppl = ") if ": ppl = " in ln else ln.split(" = ")
            for ln in out.strip().splitlines()]


def test_entry_point_prints_the_root_lines(f32_dequant, monkeypatch,
                                           tmp_path, text):
    src = tmp_path / "text.txt"
    src.write_text(text, encoding="utf-8")
    m, c = (os.path.join(FIX, f"tiny_{q}.bin") for q in ("q80", "f32"))
    args = ["-m", m, "-i", str(src), "--compare", c, "-b", "48",
            "--stride", "16"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        teval.main(args + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["eval.py"] + args)
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        root_eval.main()
    got, want = _lines(out.getvalue()), _lines(ref.getvalue())
    assert [g[0] for g in got] == [w[0] for w in want] == [m, c, "delta"]
    for g, w in zip(got, want):
        assert abs(float(g[1]) - float(w[1])) <= 2e-4


def test_entry_point_defaults_to_the_card(tmp_path):
    """No --device: the card, or a refusal without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src = tmp_path / "t.txt"
    src.write_text("hello world", encoding="utf-8")
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.main(["-m", os.path.join(FIX, "tiny_f32.bin"), "-i", str(src)])
