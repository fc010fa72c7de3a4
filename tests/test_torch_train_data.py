"""The port's shard writers, dataset generator and DataLoader against the
JAX package's on the same files: byte-identical shard members, identical
batches, stream state and replay.  Everything here is numpy and exact."""

import zipfile

import numpy as np
import pytest

from nano_tpu.data import preprocess as jpre
from nano_tpu.tokenizer.trie import TrieTokenizer as JTrie
from nano_tpu.train.data import DataLoader as JLoader
from nano_tpu_torch.data import preprocess as tpre
from nano_tpu_torch.tokenizer.trie import TrieTokenizer as TTrie
from nano_tpu_torch.train import data as tdata
from nano_tpu_torch.train.data import DataLoader as TLoader

CORPUS = ("the quick brown fox jumps over the lazy dog. " * 120 +
          "pack my box with five dozen liquor jugs. " * 120)


def _members(path):
    """{member name: its bytes} of an .npz (the zip's own timestamps are
    not part of the data)."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _ids(rows, width, seed, vocab=500):
    return np.random.RandomState(seed).randint(
        0, vocab, (rows, width)).astype(np.uint16)


@pytest.mark.parametrize("with_mask", [False, True])
def test_save_shard_writes_the_same_members(tmp_path, with_mask):
    ids = _ids(7, 9, 0)
    mask = (np.random.RandomState(1).rand(7, 9) < 0.5) if with_mask else None
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jpre.save_shard(pj, ids, mask)
    tpre.save_shard(pt, ids, mask)
    assert _members(pj) == _members(pt)
    for load in (jpre.load_shard, tpre.load_shard):
        for path in (pj, pt):
            got_ids, got_mask = load(path)
            assert np.array_equal(got_ids, ids) and got_ids.dtype == ids.dtype
            assert (got_mask is None) == (mask is None)


@pytest.mark.parametrize("vocab,dtype", [(0xFFFF, np.uint16),
                                         (0x10000, np.uint32)])
def test_id_dtype(vocab, dtype):
    assert tpre._id_dtype(vocab) == jpre._id_dtype(vocab) == dtype


@pytest.mark.parametrize("block_size,val_ratio,chunk_chars", [
    (32, 0.05, 100_000), (16, 0.2, 777)])
def test_generate_pretrain_dataset_gives_identical_shards(
        tmp_path, block_size, val_ratio, chunk_chars):
    corpus = str(tmp_path / "corpus.txt")
    with open(corpus, "w") as f:
        f.write(CORPUS)
    jt, tt = JTrie(), TTrie()
    jt.build_from_text(CORPUS)
    tt.build_from_text(CORPUS)
    kw = dict(block_size=block_size, val_ratio=val_ratio,
              chunk_chars=chunk_chars, seed=5)
    jp = jpre.generate_pretrain_dataset([corpus], jt,
                                        output_prefix=str(tmp_path / "j"), **kw)
    tp = tpre.generate_pretrain_dataset([corpus], tt,
                                        output_prefix=str(tmp_path / "t"), **kw)
    for a, b in zip(jp, tp):
        assert _members(a) == _members(b)
    ids, _ = tpre.load_shard(tp[0])
    assert ids.shape[1] == block_size + 1 and ids.dtype == np.uint16


def test_generate_pretrain_dataset_with_workers_and_too_small(tmp_path):
    corpus = str(tmp_path / "corpus.txt")
    with open(corpus, "w") as f:
        f.write(CORPUS)
    tok = TTrie()
    tok.build_from_text(CORPUS)
    one = tpre.generate_pretrain_dataset([corpus], tok, 32,
                                         str(tmp_path / "a"), chunk_chars=2000)
    two = tpre.generate_pretrain_dataset([corpus], tok, 32,
                                         str(tmp_path / "b"), chunk_chars=2000,
                                         num_workers=2)
    for a, b in zip(one, two):
        assert _members(a) == _members(b)
    with pytest.raises(ValueError, match="too small"):
        tpre.generate_pretrain_dataset([corpus], tok, 10 ** 6,
                                       str(tmp_path / "c"))


def test_base64_format_flows_both_ways(tmp_path):
    ids = _ids(3, 9, 2).astype(np.uint32)
    mask = (np.random.RandomState(3).rand(3, 9) < 0.5).astype(np.uint8)
    pj, pt = str(tmp_path / "j.b64"), str(tmp_path / "t.b64")
    jpre.write_base64_dataset(pj, ids, mask)
    tpre.write_base64_dataset(pt, ids, mask)
    assert open(pj).read() == open(pt).read()
    for read in (jpre.read_base64_dataset, tpre.read_base64_dataset):
        got_ids, got_mask = read(pt)
        assert np.array_equal(got_ids, ids) and np.array_equal(got_mask, mask)
    tpre.write_base64_dataset(pt, ids, None)
    assert tpre.read_base64_dataset(pt)[1] is None


def test_base64_reader_refuses_foreign_pickles(tmp_path):
    import base64
    import pickle
    p = str(tmp_path / "evil.b64")
    with open(p, "w") as f:
        f.write(base64.b64encode(pickle.dumps([print, None])).decode() + "\n")
    with pytest.raises(pickle.UnpicklingError, match="forbidden"):
        tpre.read_base64_dataset(p)


@pytest.fixture()
def shards(tmp_path):
    """Two .npz shards of different widths (one with a mask) and one
    base64 file."""
    a, b, c = (str(tmp_path / n) for n in ("a.npz", "b.npz", "c.b64"))
    tpre.save_shard(a, _ids(11, 17, 10))
    tpre.save_shard(b, _ids(5, 13, 11),
                    np.random.RandomState(12).rand(5, 13) < 0.7)
    tpre.write_base64_dataset(c, _ids(4, 17, 13).astype(np.uint32))
    return [a, b, c]


def _same_stream(jl, tl, n, batch, block, **kw):
    for _ in range(n):
        for a, b in zip(jl.get_batch(batch, block, **kw),
                        tl.get_batch(batch, block, **kw)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (jl.course, jl.pos, jl.epoch) == (tl.course, tl.pos, tl.epoch)


@pytest.mark.parametrize("kw", [dict(is_causal=True), dict(is_causal=False),
                                dict(denoise=True)],
                         ids=["causal", "seq2seq", "denoise"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_gives_the_same_batches(shards, kw, shuffle):
    jl = JLoader(shards, seed=3, shuffle=shuffle)
    tl = TLoader(shards, seed=3, shuffle=shuffle)
    assert jl.total_samples == tl.total_samples == 20
    block = 8 if kw.get("is_causal") is False else 16
    _same_stream(jl, tl, 9, 6, block, **kw)
    assert tl.epoch >= 2


@pytest.mark.parametrize("denoise", [False, True])
def test_state_set_state_and_skip_batches(shards, denoise):
    jl, tl = JLoader(shards, seed=4, shuffle=True), TLoader(shards, seed=4,
                                                            shuffle=True)
    _same_stream(jl, tl, 2, 6, 16, denoise=denoise)
    st = tl.state()
    first = tl.get_batch(6, 16, denoise=denoise)
    tl.get_batch(6, 16, denoise=denoise)
    tl.set_state(st)                      # an eval read leaves no trace
    again = tl.get_batch(6, 16, denoise=denoise)
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    jl.get_batch(6, 16, denoise=denoise)
    # replay: a fresh loader skipped forward continues the same stream
    fresh_j = JLoader(shards, seed=4, shuffle=True)
    fresh_t = TLoader(shards, seed=4, shuffle=True)
    fresh_j.skip_batches(3, 6, denoise=denoise, block_size=16)
    fresh_t.skip_batches(3, 6, denoise=denoise, block_size=16)
    _same_stream(fresh_j, fresh_t, 5, 6, 16, denoise=denoise)
    _same_stream(jl, tl, 5, 6, 16, denoise=denoise)
    assert all(np.array_equal(a, b) for a, b in zip(
        fresh_t.get_batch(6, 16, denoise=denoise),
        tl.get_batch(6, 16, denoise=denoise)))


def test_lazy_shards_and_bounded_residency(shards):
    tl = TLoader(shards[:2], seed=0, max_resident=1)
    assert all(s._ids is None for s in tl.shards)       # headers only
    jl = JLoader(shards[:2], seed=0, max_resident=1)
    _same_stream(jl, tl, 7, 4, 8)
    assert sum(s._ids is not None for s in tl.shards) <= 1
    assert tdata._npz_rows(shards[0]) == 11
    assert tdata.MASK_TOKEN_ID == 7
