"""Corpus preprocessing: raw text -> packed token shards.

Port of the pretrain half of ``nano_tpu/data/preprocess.py``, numpy only:
chunk raw text, tokenize (optionally on a worker pool), split the token
stream into (block_size+1)-token blocks dropping short tails, shuffle,
hold out the last val_ratio as validation.  Shards are ``.npz`` files
holding a dense ``ids`` matrix (N, block_size+1) uint16/uint32 and an
optional ``mask`` matrix; the bytes are the JAX package's, so either
package trains from the other's shards.  A reader/writer for the
reference's base64 line format is kept so datasets flow both ways.  The
SFT and bounded-RAM parts generators are not ported yet.
"""

from __future__ import annotations

import base64
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
    implementation shared by the worker and non-worker paths (short
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
