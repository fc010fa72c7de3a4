"""Preset vocab builders with the reference's exact composition rules.

The port's own copy of ``nano_tpu/tokenizer/presets.py`` (pure Python, on
the port's ``TrieTokenizer``; the port never imports the JAX package).

The reference ships five vocab presets (reference: tokenizer.py:327-412):

  * 4096 / 6000 / 8192 — read from ``tokenizer/charset_*.txt`` files, one
    token per line with C-style escapes, in FILE ORDER;
  * 16384 — ``sorted(set(GB_CHARSET + EN_SUBWORDS + unicode ranges))``;
  * 32768 — ``EN_SUBWORDS + unicode ranges`` (order preserved, no sort).

The reference embeds its English word list (≈5k ECDICT exam words +
subwords) as data inside tokenizer.py; here word lists are INPUTS —
loaded from a plain word-per-line file or extracted from any existing
vocab JSON (every multi-char non-special token), so a reference vocab can
be decomposed and rebuilt byte-for-byte without shipping the list.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional, Sequence

from nano_tpu_torch.tokenizer.trie import TrieTokenizer

# Unicode range tables, verbatim from the reference builders
# (reference: tokenizer.py:329-338 for 32768, :354-363 for 16384)
RANGES_32768 = [
    (0x0000, 0x04FF),   # basic latin .. cyrillic
    (0x2000, 0x2BFF),   # punctuation, symbols, arrows (incl. some emoji)
    (0x3000, 0x312F),   # kana, bopomofo
    (0x4E00, 0x9FFF),   # CJK unified ideographs
    (0xFF00, 0xFFFF),   # fullwidth forms
    (0x1D7E2, 0x1D7FF),  # mathematical digit variants
    (0x1F300, 0x1F9FF),  # most emoji
]
RANGES_16384 = [
    (0x0000, 0x04FF),
    (0x2000, 0x20BF),
    (0x2100, 0x210F),
    (0x2190, 0x21FF),
    (0x2200, 0x2211),
    (0x2460, 0x2473),
    (0x3000, 0x312F),
    (0xFF00, 0xFFFF),
]

_ESCAPES = [("\\n", "\n"), ("\\r", "\r"), ("\\t", "\t"),
            ("\\f", "\f"), ("\\b", "\b")]


def load_charset_file(path: str) -> List[str]:
    """One token per line; ``\\n``-style escapes decoded
    (reference: tokenizer.py:378-414 loaders)."""
    out: List[str] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            t = line.rstrip("\r\n")
            for esc, ch in _ESCAPES:
                t = t.replace(esc, ch)
            out.append(t)
    return out


def load_word_list(path: str) -> List[str]:
    """Plain word-per-line list (replacement for the reference's embedded
    EN_SUBWORDS data)."""
    with open(path, "r", encoding="utf-8") as f:
        return [ln.rstrip("\r\n") for ln in f if ln.rstrip("\r\n")]


def extract_content_tokens(vocab_json_path: str) -> List[str]:
    """All non-special tokens of an existing vocab, in vocab order —
    feeding them back through build_from_tokens() reproduces the vocab
    exactly (the round-trip the parity tests assert)."""
    with open(vocab_json_path, "r", encoding="utf-8") as f:
        cfg = json.load(f)
    specials = set(cfg["special_tokens"])
    return [t for t in cfg["itos"] if t not in specials]


def extract_word_tokens(vocab_json_path: str) -> List[str]:
    """The multi-char (word/subword) tokens of an existing vocab — the
    recoverable equivalent of the reference's embedded English lists."""
    return [t for t in extract_content_tokens(vocab_json_path)
            if len(t) > 1]


def _chars(ranges: Sequence[tuple]) -> List[str]:
    out: List[str] = []
    for lo, hi in ranges:
        out.extend(chr(c) for c in range(lo, hi + 1))
    return out


def build_from_tokens(tokens: Iterable[str]) -> TrieTokenizer:
    """12 specials + the given tokens, in order (reference _build,
    tokenizer.py:265-288)."""
    tok = TrieTokenizer()
    tok.build(list(tokens))
    return tok


def build_from_charset_file(path: str) -> TrieTokenizer:
    """The 4096 / 6000 / 8192 preset recipe (reference:
    tokenizer.py:378-414): charset file order, no sorting."""
    return build_from_tokens(load_charset_file(path))


def build_16384(words: Sequence[str],
                gb_charset: Optional[Sequence[str]] = None) -> TrieTokenizer:
    """``sorted(set(gb_charset + words + unicode_16384))``
    (reference: tokenizer.py:353-376)."""
    tokens = sorted(set(list(gb_charset or []) + list(words)
                        + _chars(RANGES_16384)))
    return build_from_tokens(tokens)


def build_32768(words: Sequence[str]) -> TrieTokenizer:
    """``words + unicode_32768``, order preserved
    (reference: tokenizer.py:327-351)."""
    return build_from_tokens(list(words) + _chars(RANGES_32768))


def build_preset(size: int, charset_file: Optional[str] = None,
                 words_file: Optional[str] = None,
                 from_vocab: Optional[str] = None) -> TrieTokenizer:
    """One-stop builder for the five reference preset sizes.

    - 4096/6000/8192 need `charset_file`;
    - 16384/32768 take `words_file` (word-per-line) and/or `from_vocab`
      (an existing vocab JSON whose word tokens are reused).
    """
    if size in (4096, 6000, 8192):
        if charset_file is None:
            raise ValueError(f"preset {size} needs a charset file "
                             "(reference: tokenizer/charset_%d.txt)" % size)
        return build_from_charset_file(charset_file)
    words: List[str] = []
    if words_file:
        words.extend(load_word_list(words_file))
    if from_vocab:
        words.extend(extract_word_tokens(from_vocab))
    if size == 16384:
        gb = None
        if from_vocab:
            # single-char non-ASCII tokens of the source vocab stand in
            # for the reference's GB charset data
            gb = [t for t in extract_content_tokens(from_vocab)
                  if len(t) == 1]
        return build_16384(words, gb)
    if size == 32768:
        return build_32768(words)
    raise ValueError(f"unknown preset size {size}")
