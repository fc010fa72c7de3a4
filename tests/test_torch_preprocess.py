"""Corpus preprocessing of the port (nano_tpu_torch.data.preprocess, the
preset tokenizers and `python -m nano_tpu_torch.data`) against the JAX
package's functions and the root data.py on the CPU.

The same inputs go through both: dataset/pretrain_sample.txt,
dataset/sft_sample.jsonl and dataset/sft_self_id.jsonl, a base64 file from
write_base64_dataset, small [Q]/[A] and {"text"} files, and the shipped
charsets.  Every output file must be byte-equal (np.savez writes the same
bytes for the same arrays) and every tokenizer config equal; the command
lines must print the same lines (output paths aside)."""

import base64
import contextlib
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest

import data as root_data
from nano_tpu.data import preprocess as jpre
from nano_tpu.tokenizer import presets as jpresets
from nano_tpu.tokenizer.trie import TrieTokenizer as JTrieTokenizer
from nano_tpu_torch.data import __main__ as tdata_main
from nano_tpu_torch.data import preprocess as tpre
from nano_tpu_torch.tokenizer import presets as tpresets
from nano_tpu_torch.tokenizer.trie import TrieTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "pretrain_sample.txt")
SFT = [os.path.join(ROOT, "dataset", "sft_sample.jsonl"),
       os.path.join(ROOT, "dataset", "sft_self_id.jsonl")]
TOK16K = os.path.join(ROOT, "tokenizer", "nano_16384.json")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_files(a, b):
    assert os.path.basename(a) == os.path.basename(b)
    assert _bytes(a) == _bytes(b), (a, b)


@pytest.fixture(scope="module")
def char_tok(tmp_path_factory):
    """A char tokenizer of the sample corpus, as each package builds it."""
    with open(SAMPLE, encoding="utf-8") as f:
        text = f.read()
    t, j = TrieTokenizer(), JTrieTokenizer()
    t.build_from_text(text)
    j.build_from_text(text)
    assert t.config == j.config
    return t, j


# =====================================================================
# presets
# =====================================================================

@pytest.mark.parametrize("size", [4096, 6000, 8192])
def test_charset_presets_equal_the_jax_builders(size):
    path = os.path.join(ROOT, "tokenizer", f"charset_{size}.txt")
    assert tpresets.load_charset_file(path) == jpresets.load_charset_file(path)
    got = tpresets.build_preset(size, charset_file=path)
    want = jpresets.build_preset(size, charset_file=path)
    assert isinstance(got, TrieTokenizer)
    assert got.config == want.config
    assert got.vocab_size == want.vocab_size


@pytest.mark.parametrize("size", [16384, 32768])
def test_range_presets_from_a_vocab_and_a_word_list(size, tmp_path):
    vocab = os.path.join(ROOT, "tokenizer", f"nano_{size}.json")
    words = tmp_path / "words.txt"
    words.write_text("hello\nworld\n\nnano\r\n", encoding="utf-8")
    assert (tpresets.load_word_list(str(words))
            == jpresets.load_word_list(str(words)))
    assert (tpresets.extract_content_tokens(vocab)
            == jpresets.extract_content_tokens(vocab))
    assert (tpresets.extract_word_tokens(vocab)
            == jpresets.extract_word_tokens(vocab))
    for kw in (dict(from_vocab=vocab), dict(words_file=str(words)),
               dict(from_vocab=vocab, words_file=str(words))):
        got = tpresets.build_preset(size, **kw)
        want = jpresets.build_preset(size, **kw)
        assert got.config == want.config, kw


def test_preset_refusals_match():
    for size in (4096, 12345):
        with pytest.raises(ValueError):
            tpresets.build_preset(size)
        with pytest.raises(ValueError):
            jpresets.build_preset(size)


# =====================================================================
# pretrain parts, SFT, converters
# =====================================================================

@pytest.mark.parametrize("part_blocks,val_ratio", [(7, 0.05), (50, 0.2),
                                                   (10 ** 6, 0.05)])
def test_pretrain_parts_are_the_jax_files(char_tok, tmp_path, part_blocks,
                                          val_ratio):
    """The bounded-RAM two-level shuffle: the same parts in the same
    shuffled order, each shard byte-equal; no _part file left behind."""
    t, j = char_tok
    for d in ("t", "j"):
        (tmp_path / d).mkdir()
    got = tpre.generate_pretrain_dataset_parts(
        [SAMPLE], t, 16, str(tmp_path / "t" / "pt"), part_blocks=part_blocks,
        val_ratio=val_ratio, chunk_chars=1000)
    want = jpre.generate_pretrain_dataset_parts(
        [SAMPLE], j, 16, str(tmp_path / "j" / "pt"), part_blocks=part_blocks,
        val_ratio=val_ratio, chunk_chars=1000)
    assert len(got[0]) == len(want[0]) >= 1
    if part_blocks == 7:
        assert len(got[0]) > 10
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        _same_files(a, b)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    assert not any("_part" in n for n in os.listdir(tmp_path / "t"))


def test_pretrain_parts_refuse_a_corpus_too_small(char_tok, tmp_path):
    tiny = tmp_path / "tiny.txt"
    tiny.write_text("abc", encoding="utf-8")
    with pytest.raises(ValueError, match="too small"):
        tpre.generate_pretrain_dataset_parts(
            [str(tiny)], char_tok[0], 16, str(tmp_path / "x"), part_blocks=4)


@pytest.mark.parametrize("block_size", [24, 64, 512])
def test_apply_template_and_encode_equals_the_jax_function(block_size):
    t = TrieTokenizer.from_file(TOK16K)
    j = JTrieTokenizer.from_file(TOK16K)
    n_none = 0
    for path in SFT:
        with open(path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                obj = json.loads(line)
                got = tpre.apply_template_and_encode(
                    t, obj["question"], obj["answer"], block_size)
                want = jpre.apply_template_and_encode(
                    j, obj["question"], obj["answer"], block_size)
                assert got == want
                n_none += got is None
    if block_size == 24:
        assert n_none > 0            # over-long samples are dropped


@pytest.mark.parametrize("block_size,val_ratio,seed", [
    (512, 0.05, 39), (64, 0.3, 7), (128, 0.0, 1)])
def test_sft_shards_are_the_jax_files(tmp_path, block_size, val_ratio, seed):
    t = TrieTokenizer.from_file(TOK16K)
    j = JTrieTokenizer.from_file(TOK16K)
    got = tpre.generate_sft_dataset(SFT, t, block_size, str(tmp_path / "t"),
                                    val_ratio=val_ratio, seed=seed)
    want = jpre.generate_sft_dataset(SFT, j, block_size, str(tmp_path / "j"),
                                     val_ratio=val_ratio, seed=seed)
    for a, b in zip(got, want):
        assert _bytes(a) == _bytes(b)
    ids, mask = tpre.load_shard(got[0])
    assert ids.dtype == np.uint16 and mask.dtype == np.uint8
    assert ids.shape == mask.shape and ids.shape[1] == block_size + 1


def test_sft_single_sample_and_no_sample(tmp_path):
    t = TrieTokenizer.from_file(TOK16K)
    j = JTrieTokenizer.from_file(TOK16K)
    one = tmp_path / "one.jsonl"
    one.write_text(json.dumps({"question": "hi", "answer": "hello"}) + "\n\n",
                   encoding="utf-8")
    got = tpre.generate_sft_dataset([str(one)], t, 32, str(tmp_path / "t"))
    want = jpre.generate_sft_dataset([str(one)], j, 32, str(tmp_path / "j"))
    for a, b in zip(got, want):
        assert _bytes(a) == _bytes(b)
    assert len(tpre.load_shard(got[1])[0]) == 1        # val reuses it
    with pytest.raises(ValueError, match="no usable"):
        tpre.generate_sft_dataset([str(one)], t, 4, str(tmp_path / "x"))


@pytest.mark.parametrize("with_mask", [True, False])
def test_convert_base64_to_shard_is_the_jax_conversion(tmp_path, with_mask):
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 16384, (9, 33)).astype(np.uint16)
    mask = (rng.rand(9, 33) < 0.5).astype(np.uint8) if with_mask else None
    src = str(tmp_path / "old.base64")
    tpre.write_base64_dataset(src, ids, mask)
    tpre.convert_base64_to_shard(src, str(tmp_path / "t.npz"))
    jpre.convert_base64_to_shard(src, str(tmp_path / "j.npz"))
    assert _bytes(tmp_path / "t.npz") == _bytes(tmp_path / "j.npz")
    got_ids, got_mask = tpre.load_shard(str(tmp_path / "t.npz"))
    assert np.array_equal(got_ids, ids)
    assert (got_mask is None) == (not with_mask)


def test_convert_refuses_a_pickled_global(tmp_path):
    src = tmp_path / "evil.base64"
    src.write_text(base64.b64encode(pickle.dumps(
        [[1, 2], os.getcwd])).decode("ascii") + "\n")
    with pytest.raises(pickle.UnpicklingError, match="forbidden"):
        tpre.convert_base64_to_shard(str(src), str(tmp_path / "x.npz"))


QA = ("[Q]一加一等于几？\n[A]二。\n\nnoise line\n[Q]What is Nano?\n"
      "[A]A small \"LLM\".\n[A]an answer with no question\n")
DOCS = ('{"text": "第一篇"}\n\n{"text": "second \\"doc\\"\\nwith a newline"}\n')


@pytest.mark.parametrize("fn,text,n", [
    ("qa_txt_to_jsonl", QA, 3), ("jsonl_text_to_corpus", DOCS, 2)])
def test_raw_corpus_converters_write_the_jax_files(tmp_path, fn, text, n):
    src = tmp_path / "in.txt"
    src.write_text(text, encoding="utf-8")
    got = getattr(tpre, fn)(str(src), str(tmp_path / "t.out"))
    want = getattr(jpre, fn)(str(src), str(tmp_path / "j.out"))
    assert got == want == n
    assert _bytes(tmp_path / "t.out") == _bytes(tmp_path / "j.out")


# =====================================================================
# python -m nano_tpu_torch.data against the root data.py
# =====================================================================

def _run_root(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["data.py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        root_data.main()
    return out.getvalue()


def _run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tdata_main.main(argv)
    return out.getvalue()


def _both(monkeypatch, tmp_path, make_argv):
    """Run one subcommand through both CLIs, each writing under its own
    directory; -> (port dir, root dir).  The printed lines must be the
    same with the directories swapped."""
    dirs = []
    outs = []
    for tag, run in (("t", _run_port),
                     ("j", lambda a: _run_root(monkeypatch, a))):
        d = tmp_path / tag
        d.mkdir()
        outs.append(run(make_argv(str(d))))
        dirs.append(str(d))
    assert outs[0].replace(dirs[0], "<out>") == outs[1].replace(dirs[1],
                                                                "<out>")
    assert outs[0].strip()
    return dirs


def _same_trees(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert _bytes(os.path.join(a, n)) == _bytes(os.path.join(b, n)), n


@pytest.mark.parametrize("extra", [[], ["--part_blocks", "9"],
                                   ["-s", "5", "--val_ratio", "0.2"]])
def test_cli_pretrain(monkeypatch, tmp_path, char_tok, extra):
    tok = tmp_path / "tok.json"
    char_tok[0].dump_config_file(str(tok))
    t, j = _both(monkeypatch, tmp_path, lambda d: [
        "pretrain", "-i", SAMPLE, "-k", str(tok), "-b", "32",
        "-o", os.path.join(d, "pt")] + extra)
    _same_trees(t, j)


def test_cli_sft(monkeypatch, tmp_path):
    t, j = _both(monkeypatch, tmp_path, lambda d: [
        "sft", "-i", *SFT, "-k", TOK16K, "-b", "256",
        "-o", os.path.join(d, "sft")])
    _same_trees(t, j)


def test_cli_convert(monkeypatch, tmp_path):
    src = str(tmp_path / "old.base64")
    rng = np.random.RandomState(4)
    tpre.write_base64_dataset(src, rng.randint(0, 99, (5, 17)),
                              (rng.rand(5, 17) < 0.5).astype(np.uint8))
    t, j = _both(monkeypatch, tmp_path, lambda d: [
        "convert", "-i", src, "-o", os.path.join(d, "new.npz")])
    _same_trees(t, j)


@pytest.mark.parametrize("args", [
    ["--preset", "4096"], ["--preset", "6000"], ["--preset", "8192"],
    ["--preset", "16384"], ["--preset", "32768", "--from_vocab", TOK16K],
    ["-i", SAMPLE]], ids=["4096", "6000", "8192", "16384", "32768_vocab",
                          "text"])
def test_cli_tokenizer(monkeypatch, tmp_path, args):
    t, j = _both(monkeypatch, tmp_path, lambda d: [
        "tokenizer", "-o", os.path.join(d, "tok.json")] + args)
    _same_trees(t, j)


def test_cli_tokenizer_needs_input_or_preset(tmp_path):
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            tdata_main.main(["tokenizer", "-o", str(tmp_path / "x.json")])


@pytest.mark.parametrize("cmd,text", [("qa2jsonl", QA),
                                      ("jsonl2txt", DOCS)])
def test_cli_converters(monkeypatch, tmp_path, cmd, text):
    src = tmp_path / "in.txt"
    src.write_text(text, encoding="utf-8")
    t, j = _both(monkeypatch, tmp_path, lambda d: [
        cmd, "-i", str(src), "-o", os.path.join(d, "out")])
    _same_trees(t, j)
