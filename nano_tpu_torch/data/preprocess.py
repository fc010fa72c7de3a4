"""Corpus preprocessing: raw text / JSONL -> packed token shards.

Port of ``nano_tpu/data/preprocess.py``, numpy only:
  * pretrain: chunk raw text, tokenize (optionally on a worker pool),
    split the token stream into (block_size+1)-token blocks dropping short
    tails, shuffle, hold out the last val_ratio as validation; or, for
    corpora larger than RAM, the bounded-RAM two-level shuffle
    (``generate_pretrain_dataset_parts``);
  * SFT: JSONL {question, answer} ->
    ``<|instruct_mark|>Q<|response_mark|>A<|eos|>`` padded with
    ``<|padding|>``, plus a loss mask covering only the answer tokens
    (incl. the closing eos);
  * raw-corpus converters ([Q]/[A] text -> JSONL, {"text"} JSONL -> one
    document a line).

Shards are ``.npz`` files holding a dense ``ids`` matrix (N, block_size+1)
uint16/uint32 and an optional ``mask`` matrix; the bytes are the JAX
package's (the same RNG draws in the same order), so either package
trains from the other's shards.  A reader/writer for the reference's
base64 line format is kept so datasets flow both ways.
"""

from __future__ import annotations

import base64
import json
import os
import pickle
from multiprocessing import get_context
from typing import List, Optional, Sequence, Tuple

import numpy as np

from nano_tpu_torch.tokenizer.trie import TrieTokenizer


def _id_dtype(vocab_size: int):
    return np.uint16 if vocab_size <= 0xFFFF else np.uint32


# =====================================================================
# shard format
# =====================================================================

def save_shard(path: str, ids: np.ndarray, mask: Optional[np.ndarray] = None
               ) -> None:
    if mask is None:
        np.savez(path, ids=ids)
    else:
        np.savez(path, ids=ids, mask=mask.astype(np.uint8))


def load_shard(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    z = np.load(path)
    return z["ids"], (z["mask"] if "mask" in z.files else None)


# =====================================================================
# pretrain
# =====================================================================

_worker_tok: Optional[TrieTokenizer] = None


def _init_worker(tokenizer_config: dict) -> None:
    global _worker_tok
    _worker_tok = TrieTokenizer.from_config_dict(tokenizer_config)


def _encode_chunk(text: str) -> List[int]:
    return _worker_tok.encode(text)



def _drain_blocks(leftover: List[int], block_size: int, dtype, emit
                  ) -> List[int]:
    """Slice complete (block_size+1)-token rows off `leftover` into
    emit(row); returns the remaining tail.  The ONE packing
    implementation shared by the worker/non-worker/parts paths (short
    tails are dropped, reference: data.py:112-119)."""
    w = block_size + 1
    n = len(leftover) // w
    for i in range(n):
        emit(np.asarray(leftover[i * w:(i + 1) * w], dtype))
    return leftover[n * w:]


def _encoded_chunks(text_paths: Sequence[str], tokenizer: TrieTokenizer,
                    chunk_chars: int, num_workers: int):
    """Stream token-id lists for chunk_chars-sized text pieces, optionally
    tokenizing on a worker pool.  The ONE reader/pool implementation
    of the generators."""

    def chunks():
        for p in text_paths:
            with open(p, "r", encoding="utf-8") as f:
                while True:
                    c = f.read(chunk_chars)
                    if not c:
                        break
                    yield c

    if num_workers > 1:
        with get_context("spawn").Pool(
                num_workers, initializer=_init_worker,
                initargs=(tokenizer.config,)) as pool:
            yield from pool.imap(_encode_chunk, chunks(), chunksize=1)
    else:
        for c in chunks():
            yield tokenizer.encode(c)


def generate_pretrain_dataset(
        text_paths: Sequence[str], tokenizer: TrieTokenizer, block_size: int,
        output_prefix: str, val_ratio: float = 0.05,
        chunk_chars: int = 100_000, num_workers: int = 0,
        seed: int = 39) -> Tuple[str, str]:
    """Tokenize raw text files into shuffled train/val shards.

    Returns (train_path, val_path).
    """
    rng = np.random.RandomState(seed)
    dtype = _id_dtype(tokenizer.vocab_size)
    blocks: List[np.ndarray] = []
    leftover: List[int] = []
    for tok_ids in _encoded_chunks(text_paths, tokenizer, chunk_chars,
                                   num_workers):
        leftover.extend(tok_ids)
        leftover = _drain_blocks(leftover, block_size, dtype,
                                 blocks.append)

    if not blocks:
        raise ValueError("corpus too small for one block")
    ids = np.stack(blocks)
    perm = rng.permutation(len(ids))
    ids = ids[perm]
    n_val = max(1, int(len(ids) * val_ratio)) if len(ids) > 1 else 0
    train_path = output_prefix + "_train.npz"
    val_path = output_prefix + "_val.npz"
    save_shard(train_path, ids[:len(ids) - n_val])
    save_shard(val_path, ids[len(ids) - n_val:] if n_val else ids[-1:])
    return train_path, val_path


def generate_pretrain_dataset_parts(
        text_paths: Sequence[str], tokenizer: TrieTokenizer, block_size: int,
        output_prefix: str, part_blocks: int, val_ratio: float = 0.05,
        chunk_chars: int = 100_000, num_workers: int = 0, seed: int = 39
        ) -> Tuple[List[str], List[str]]:
    """TB-scale variant: bounded-RAM two-level shuffle.

    Blocks are accumulated into PARTS of `part_blocks`, each part is
    shuffled in RAM and spilled to its own shard pair
    (``_train_part%04d`` / ``_val_part%04d``, the last val_ratio of the
    part as validation), then the part ORDER is shuffled by renaming the
    files to ``_train_%04d`` / ``_val_%04d`` (reference: data.py:66-168):
    no more than one part lives in memory.  One RandomState draws every
    intra-part permutation in part order, then the part order.

    Returns (train_paths, val_paths) in the shuffled part order.
    """
    rng = np.random.RandomState(seed)
    dtype = _id_dtype(tokenizer.vocab_size)
    train_tmp: List[str] = []
    val_tmp: List[str] = []
    part: List[np.ndarray] = []
    leftover: List[int] = []

    def flush_part():
        if not part:
            return
        ids = np.stack(part)
        part.clear()
        ids = ids[rng.permutation(len(ids))]        # intra-part shuffle
        n_val = max(1, int(len(ids) * val_ratio)) if len(ids) > 1 else 0
        i = len(train_tmp)
        tp = f"{output_prefix}_train_part{i:04d}.npz"
        vp = f"{output_prefix}_val_part{i:04d}.npz"
        save_shard(tp, ids[:len(ids) - n_val])
        save_shard(vp, ids[len(ids) - n_val:] if n_val else ids[-1:])
        train_tmp.append(tp)
        val_tmp.append(vp)

    def emit(row):
        part.append(row)
        if len(part) >= part_blocks:
            flush_part()

    for tok_ids in _encoded_chunks(text_paths, tokenizer, chunk_chars,
                                   num_workers):
        leftover.extend(tok_ids)
        leftover = _drain_blocks(leftover, block_size, dtype, emit)
    flush_part()
    if not train_tmp:
        raise ValueError("corpus too small for one block")

    # inter-part shuffle: rename the files into a shuffled order
    order = rng.permutation(len(train_tmp))
    train_paths, val_paths = [], []
    for new_i, old_i in enumerate(order):
        tp = f"{output_prefix}_train_{new_i:04d}.npz"
        vp = f"{output_prefix}_val_{new_i:04d}.npz"
        os.replace(train_tmp[old_i], tp)
        os.replace(val_tmp[old_i], vp)
        train_paths.append(tp)
        val_paths.append(vp)
    return train_paths, val_paths


# =====================================================================
# SFT
# =====================================================================

def apply_template_and_encode(tokenizer: TrieTokenizer, question: str,
                              answer: str, block_size: int
                              ) -> Optional[Tuple[List[int], List[int]]]:
    """-> (ids padded to block_size+1, loss mask over answer tokens), or
    None for a sample longer than block_size+1.

    Template (reference: data.py:170-190):
      <|instruct_mark|> Q <|response_mark|> A <|eos|> <|padding|>...
    mask = 1 exactly on the answer tokens + eos.
    """
    q_ids = tokenizer.encode(f"<|instruct_mark|>{question}<|response_mark|>")
    a_ids = tokenizer.encode(answer) + [tokenizer.eos_id]
    total = len(q_ids) + len(a_ids)
    if total > block_size + 1:
        return None
    pad = [tokenizer.pad_id] * (block_size + 1 - total)
    mask = [0] * len(q_ids) + [1] * len(a_ids) + [0] * len(pad)
    return q_ids + a_ids + pad, mask


def generate_sft_dataset(jsonl_paths: Sequence[str], tokenizer: TrieTokenizer,
                         block_size: int, output_prefix: str,
                         val_ratio: float = 0.05, seed: int = 39
                         ) -> Tuple[str, str]:
    """JSONL {question, answer} -> shuffled train/val shards with masks
    (over-long samples dropped).  Returns (train_path, val_path)."""
    rng = np.random.RandomState(seed)
    dtype = _id_dtype(tokenizer.vocab_size)
    all_ids, all_masks = [], []
    for p in jsonl_paths:
        with open(p, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                res = apply_template_and_encode(
                    tokenizer, obj["question"], obj["answer"], block_size)
                if res is None:
                    continue
                all_ids.append(np.asarray(res[0], dtype))
                all_masks.append(np.asarray(res[1], np.uint8))
    if not all_ids:
        raise ValueError("no usable SFT samples")
    perm = rng.permutation(len(all_ids))
    ids, masks = np.stack(all_ids)[perm], np.stack(all_masks)[perm]
    n_val = max(1, int(len(ids) * val_ratio)) if len(ids) > 1 else 0
    n_train = len(ids) - n_val
    train_path = output_prefix + "_train.npz"
    val_path = output_prefix + "_val.npz"
    save_shard(train_path, ids[:n_train], masks[:n_train])
    # a single-sample corpus reuses its sample for val: an EMPTY val shard
    # would make DataLoader._take spin forever
    v = slice(n_train, None) if n_val else slice(-1, None)
    save_shard(val_path, ids[v], masks[v])
    return train_path, val_path


# =====================================================================
# reference base64-line format compatibility (reference: data.py:123-140,
# train.py:85)
# =====================================================================

def read_base64_dataset(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a reference-format file: one base64(pickle([ids, mask])) per line.

    Lines are unpickled through a restricted unpickler admitting only the
    containers/ints/arrays the format legitimately needs — a dataset file
    from elsewhere must not be able to execute arbitrary pickle payloads
    .
    """
    import io as _io

    class _DatasetUnpickler(pickle.Unpickler):
        _OK = {("builtins", x) for x in
               ("list", "tuple", "int", "bytes", "bytearray", "NoneType")}
        _OK |= {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar"),
                ("array", "array"), ("array", "_array_reconstructor")}

        def find_class(self, module, name):
            if (module, name) in self._OK:
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                f"dataset line references forbidden global "
                f"{module}.{name}")

    def _loads(b):
        return _DatasetUnpickler(_io.BytesIO(b)).load()

    ids_list, mask_list = [], []
    has_mask = False
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ids, mask = _loads(base64.b64decode(line))
            ids_list.append(np.asarray(ids, np.uint32))
            if mask is not None:
                has_mask = True
                mask_list.append(np.asarray(mask, np.uint8))
            else:
                mask_list.append(None)
    n = min(len(x) for x in ids_list)
    ids = np.stack([x[:n] for x in ids_list])
    if has_mask:
        masks = np.stack([
            m[:n] if m is not None else np.ones(n, np.uint8)
            for m in mask_list])
        return ids, masks
    return ids, None


def write_base64_dataset(path: str, ids: np.ndarray,
                         mask: Optional[np.ndarray] = None) -> None:
    """Write our arrays in the reference's line format (for its trainer)."""
    with open(path, "w", encoding="utf-8") as f:
        for i in range(len(ids)):
            m = None if mask is None else [int(x) for x in mask[i]]
            blob = pickle.dumps([[int(x) for x in ids[i]], m])
            f.write(base64.b64encode(blob).decode("ascii") + "\n")


def convert_base64_to_shard(src: str, dst: str) -> None:
    """A reference base64-line file -> one .npz shard."""
    ids, mask = read_base64_dataset(src)
    save_shard(dst, ids, mask)


# =====================================================================
# raw-corpus converters (reference: dataset/parse_arexam.py)
# =====================================================================

def qa_txt_to_jsonl(in_path: str, out_path: str) -> int:
    """[Q]/[A]-tagged lines -> {question, answer} JSONL (reference:
    dataset/parse_arexam.py ar_sft).  Returns the number of pairs."""
    n = 0
    with open(in_path, "r", encoding="utf-8") as f, \
            open(out_path, "w", encoding="utf-8") as out:
        question = ""
        for line in f:
            line = line.strip()
            if line.startswith("[Q]"):
                question = line[3:]
            elif line.startswith("[A]"):
                out.write(json.dumps({"question": question,
                                      "answer": line[3:]},
                                     ensure_ascii=False) + "\n")
                question = ""
                n += 1
    return n


def jsonl_text_to_corpus(in_path: str, out_path: str) -> int:
    """{"text": ...} JSONL -> one <|bos|>text<|eos|> line per document
    (reference: dataset/parse_arexam.py general_jsonl).  Returns the
    number of documents."""
    n = 0
    with open(in_path, "r", encoding="utf-8") as f, \
            open(out_path, "w", encoding="utf-8") as out:
        for line in f:
            line = line.strip()
            if not line:
                continue
            out.write("<|bos|>" + json.loads(line)["text"] + "<|eos|>\n")
            n += 1
    return n
