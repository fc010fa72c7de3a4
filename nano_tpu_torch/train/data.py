"""Training data loader: curriculum over shards, epoch tracking, batch
construction for causal / seq2seq / denoise objectives.  Port of
``nano_tpu/train/data.py`` (numpy only; the same batches from the same
files and seed).

Behavior parity with the reference DataLoader (reference: train.py:30-119):
  * a curriculum ("course") is an ordered list of dataset files; when one
    is exhausted the loader moves to the next, and wraps back to the first
    incrementing `epoch`.
  * causal batches: x = ids[:, 0:block], y = ids[:, 1:block+1], mask = all
    ones (pretrain) or the stored SFT mask shifted like y.
  * seq2seq (non-causal) batches: x = ids[:, 0:block], y = ids[:, block:2*block].
  * denoise batches: y = x; x gets random positions replaced by the mask
    token with a per-sample masking probability.

Differences by design: shards are dense .npz matrices (mmap-able, random
access) instead of base64-pickle lines, the reference's per-rank
interleaved batch skipping (train.py:311-318) is replaced by one global
batch, and `skip_batches` provides resume-replay (reference:
train.py:374-377).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from nano_tpu_torch.data.preprocess import load_shard, read_base64_dataset

MASK_TOKEN_ID = 7  # <|nano_meta_0|> (reference: train.py:26)


def _npz_rows(path: str) -> int:
    """Row count of the 'ids' member from its .npy header alone — no
    decompression (np.load(npz)['ids'] materializes the full matrix,
    and npz members cannot be mmapped)."""
    import zipfile
    from numpy.lib import format as npfmt
    with zipfile.ZipFile(path) as z, z.open("ids.npy") as f:
        ver = npfmt.read_magic(f)
        read_hdr = (npfmt.read_array_header_1_0 if ver == (1, 0)
                    else npfmt.read_array_header_2_0)
        shape, _, _ = read_hdr(f)
    return shape[0]


class _Shard:
    """Lazily-materialized shard: construction reads only the row count
    (npz header), token data loads on first access and can be released —
    so a long list of shard files never holds more than
    DataLoader.max_resident of them in RAM at once.
    The reference base64-line format has no cheap header; it loads
    eagerly (reference-compat small files)."""

    def __init__(self, path: str):
        self.path = path
        self._ids: Optional[np.ndarray] = None
        self._mask: Optional[np.ndarray] = None
        if path.endswith(".npz"):
            self.n = _npz_rows(path)
        else:  # reference base64-line format
            self._ids, self._mask = read_base64_dataset(path)
            self.n = len(self._ids)

    def _load(self) -> None:
        if self._ids is None:
            self._ids, self._mask = load_shard(self.path)

    @property
    def ids(self) -> np.ndarray:
        self._load()
        return self._ids

    @property
    def mask(self) -> Optional[np.ndarray]:
        self._load()
        return self._mask

    def release(self) -> None:
        if self.path.endswith(".npz"):
            self._ids = self._mask = None


class DataLoader:
    """Curriculum loader over token shards.

    ``max_resident`` bounds how many shards stay materialized (LRU;
    None = keep every shard once touched, the right default for the
    common several-file case)."""

    def __init__(self, filepath_list: Sequence[str], seed: int = 39,
                 shuffle: bool = False,
                 max_resident: Optional[int] = None):
        assert len(filepath_list) > 0
        self.shards = [_Shard(p) for p in filepath_list]
        self.course = 0
        self.pos = 0
        self.epoch = 0
        self.shuffle = shuffle
        self.max_resident = max_resident
        self._resident: List[int] = []
        self._rng = np.random.RandomState(seed)
        self._orders = [np.arange(s.n) for s in self.shards]
        if shuffle:
            for o in self._orders:
                self._rng.shuffle(o)

    def _touch(self, i: int) -> None:
        """LRU residency bookkeeping for shard i (about to be read)."""
        if self.max_resident is None:
            return
        if i in self._resident:
            self._resident.remove(i)
        self._resident.append(i)
        while len(self._resident) > self.max_resident:
            self.shards[self._resident.pop(0)].release()

    def _advance_course(self) -> None:
        self.course += 1
        self.pos = 0
        if self.course >= len(self.shards):
            self.course = 0
            self.epoch += 1
            if self.shuffle:
                for o in self._orders:
                    self._rng.shuffle(o)

    def _take(self, n: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Take n samples, crossing shard boundaries as needed."""
        ids_parts, mask_parts = [], []
        need = n
        width = None
        while need > 0:
            shard = self.shards[self.course]
            order = self._orders[self.course]
            if self.pos >= shard.n:
                self._advance_course()
                continue
            self._touch(self.course)
            take = min(need, shard.n - self.pos)
            sel = order[self.pos:self.pos + take]
            ids = shard.ids[sel]
            width = max(width or 0, ids.shape[1])
            ids_parts.append(ids)
            if shard.mask is not None:
                mask_parts.append(shard.mask[sel])
            else:
                mask_parts.append(np.ones_like(ids, np.uint8))
            self.pos += take
            need -= take
            if self.pos >= shard.n:
                self._advance_course()

        def fit(a, w):  # batches may span shards of different widths
            # w is the running max over the parts, so only padding occurs
            if a.shape[1] == w:
                return a
            return np.pad(a, ((0, 0), (0, w - a.shape[1])))

        return (np.concatenate([fit(a, width) for a in ids_parts]
                               ).astype(np.int32),
                np.concatenate([fit(a, width) for a in mask_parts]
                               ).astype(np.int32))

    def get_batch(self, batch_size: int, block_size: int,
                  is_causal: bool = True, denoise: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ids, mask = self._take(batch_size)
        if denoise:
            x = ids[:, :block_size]
            m = mask[:, :block_size]
            if x.shape[1] < block_size:
                # normalize to block_size: widths vary across shards and
                # a ragged width would crash np.stack in the accumulation
                # batch; padded positions carry mask 0
                pad = block_size - x.shape[1]
                x = np.pad(x, ((0, 0), (0, pad)))
                m = np.pad(m, ((0, 0), (0, pad)))
            x = x.copy()
            y = x.copy()
            p = self._rng.rand(batch_size, 1)
            noise = self._rng.rand(batch_size, block_size) < p
            x[noise] = MASK_TOKEN_ID
            # loss trains ONLY on corrupted positions (the reference's
            # intent, train.py:106-108 — its mean-reduction makes the
            # mask a no-op, a known bug we fix; SURVEY row 18).  The
            # shard/pad validity mask still gates out padding.
            return x, y, (noise & (m > 0)).astype(np.int32)
        if is_causal:
            x = ids[:, 0:block_size]
            y = ids[:, 1:block_size + 1]
            m = mask[:, 1:block_size + 1]
            if m.shape[1] < block_size:  # shard narrower than block+1
                pad = block_size - m.shape[1]
                y = np.pad(y, ((0, 0), (0, pad)))
                m = np.pad(m, ((0, 0), (0, pad)))
                x = np.pad(x, ((0, 0), (0, block_size - x.shape[1])))
            return x, y, m
        # seq2seq: input | output halves (reference: train.py:110-118)
        x = ids[:, 0:block_size]
        y = ids[:, block_size:block_size * 2]
        m = mask[:, 0:block_size]
        if x.shape[1] < block_size:
            pad = block_size - x.shape[1]
            x = np.pad(x, ((0, 0), (0, pad)))
            m = np.pad(m, ((0, 0), (0, pad)))
        y_valid = y.shape[1]
        if y_valid < block_size:
            # short output half: padded TARGET positions must weigh 0
            # or the loss trains against fake token-0 targets
            y = np.pad(y, ((0, 0), (0, block_size - y_valid)))
            m = m.copy()
            m[:, y_valid:] = 0
        return x, y, m

    def state(self) -> tuple:
        """Full stream snapshot: position plus RNG state and shuffle
        orders, so save/restore is side-effect free even when an eval read
        crosses an epoch boundary (which reshuffles) or uses denoise
        (which draws from the RNG)."""
        return (self.course, self.pos, self.epoch,
                self._rng.get_state(),
                [o.copy() for o in self._orders] if self.shuffle else None)

    def set_state(self, st: tuple) -> None:
        self.course, self.pos, self.epoch = st[:3]
        if len(st) > 3:
            self._rng.set_state(st[3])
            if st[4] is not None:
                self._orders = [o.copy() for o in st[4]]

    def skip_batches(self, n: int, batch_size: int,
                     denoise: bool = False,
                     block_size: Optional[int] = None) -> None:
        """Fast-forward the stream by index arithmetic (resume replay,
        reference: train.py:374-377).

        Walks the exact (course, pos, epoch) trajectory of n _take calls
        — including the per-epoch reshuffles — but gathers no data: a
        resume at step 100k previously re-read the entire dataset
        through fancy-indexing just to discard it.

        ``denoise`` replays get_batch's two RNG draws per batch as well
        (corruption rate + noise pattern, in stream order relative to
        the epoch reshuffles) so a resumed denoise run continues the
        exact uninterrupted trajectory — skipping rows alone would leave
        the RNG cursor offset and desync every later reshuffle too.
        """
        if denoise:
            assert block_size is not None, "denoise replay needs block_size"
            for _ in range(n):
                self._skip_rows(batch_size)
                self._rng.rand(batch_size, 1)
                self._rng.rand(batch_size, block_size)
            return
        self._skip_rows(n * batch_size)

    def _skip_rows(self, remaining: int) -> None:
        while remaining > 0:
            shard = self.shards[self.course]
            if self.pos >= shard.n:
                self._advance_course()
                continue
            take = min(remaining, shard.n - self.pos)
            self.pos += take
            remaining -= take
            if self.pos >= shard.n:
                self._advance_course()

    @property
    def total_samples(self) -> int:
        return sum(s.n for s in self.shards)
