"""Character/word trie tokenizer.

The port's own copy of ``nano_tpu/tokenizer/trie.py`` (pure Python, kept
here so the port never imports the JAX package).

Behavior-compatible with the reference's greedy longest-match tokenizer
(reference: tokenizer.py:210-325): vocabulary = 12 special tokens followed by
a character/word list; encoding walks the text taking the longest vocabulary
match at each position (single characters always match, unknown characters
map to ``<|unknown|>``); the JSON config schema is
``{vocab_size, stoi, itos, special_tokens}``.

The implementation here is a fresh one: instead of re-probing every prefix
length from max down to 1 through a nested-dict trie, we walk the trie once
per position and remember the deepest accepting node — O(len(text) * depth)
instead of O(len(text) * max_token_len * depth).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

SPECIAL_TOKENS = {
    "<|padding|>": 0,
    "<|unknown|>": 1,
    "<|bos|>": 2,
    "<|eos|>": 3,
    "<|instruct_mark|>": 4,
    "<|response_mark|>": 5,
    "<|BD4SUR|>": 6,
    "<|nano_meta_0|>": 7,
    "<|nano_meta_1|>": 8,
    "<|nano_meta_2|>": 9,
    "<|nano_meta_3|>": 10,
    "<|nano_meta_4|>": 11,
}


class _TrieNode:
    __slots__ = ("children", "token_id")

    def __init__(self) -> None:
        self.children: Dict[str, "_TrieNode"] = {}
        self.token_id: Optional[int] = None


class TrieTokenizer:
    """Greedy longest-match tokenizer over an explicit vocabulary."""

    def __init__(self) -> None:
        self.stoi: Dict[str, int] = {}
        self.itos: List[str] = []
        self.special_tokens: Dict[str, int] = dict(SPECIAL_TOKENS)
        self.vocab_size: int = 0
        self._root = _TrieNode()

    # ---------------- construction ----------------

    def _build_trie(self) -> None:
        self._root = _TrieNode()
        for token, tid in self.stoi.items():
            node = self._root
            for ch in token:
                nxt = node.children.get(ch)
                if nxt is None:
                    nxt = _TrieNode()
                    node.children[ch] = nxt
                node = nxt
            node.token_id = tid

    def build(self, tokens: Iterable[str]) -> None:
        """Build a vocab: specials first (ids 0-11), then the given tokens."""
        itos = list(self.special_tokens.keys()) + list(tokens)
        self.itos = itos
        self.stoi = {t: i for i, t in enumerate(itos)}
        self.vocab_size = len(itos)
        self._build_trie()

    def build_preset(self, vocab_size: int,
                     extra_tokens: Optional[List[str]] = None) -> None:
        """Build a fixed-size vocab from Unicode ranges (the reference
        ships 4096..32768 presets built the same way, tokenizer.py:327-412
        — its embedded English word lists are replaced by the optional
        `extra_tokens`, e.g. loaded from a word-list file).

        Ranges cover ASCII/Latin/Cyrillic, general punctuation/symbols,
        kana/bopomofo, CJK unified ideographs, fullwidth forms and emoji;
        the CJK block is truncated so the total is exactly `vocab_size`.
        """
        ranges = [
            (0x0000, 0x04FF),   # basic latin .. cyrillic
            (0x2000, 0x206F),   # general punctuation
            (0x3000, 0x312F),   # CJK punctuation, kana, bopomofo
            (0xFF00, 0xFFEF),   # fullwidth forms
        ]
        if vocab_size >= 32768:
            ranges.append((0x1F300, 0x1F9FF))   # emoji
        tokens: List[str] = list(extra_tokens or [])
        for lo, hi in ranges:
            tokens.extend(chr(c) for c in range(lo, hi + 1))
        budget = vocab_size - len(SPECIAL_TOKENS)
        seen = set()
        uniq = []
        for t in tokens:
            if t not in seen and t not in SPECIAL_TOKENS:
                seen.add(t)
                uniq.append(t)
        # fill the rest with CJK unified ideographs (most-used block),
        # then CJK Ext-A and Hangul syllables for the larger presets
        for lo, hi in ((0x4E00, 0x9FFF), (0x3400, 0x4DBF),
                       (0xAC00, 0xD7A3)):
            c = lo
            while len(uniq) < budget and c <= hi:
                ch = chr(c)
                if ch not in seen:
                    uniq.append(ch)
                    seen.add(ch)
                c += 1
        self.build(uniq[:budget])
        assert self.vocab_size <= vocab_size

    def build_from_text(self, text: str) -> None:
        """Charset vocab from a corpus (reference: tokenizer.py:420-424)."""
        self.build(sorted(set(text)))

    # ---------------- config (de)serialization ----------------

    @property
    def config(self) -> dict:
        return {
            "vocab_size": self.vocab_size,
            "stoi": self.stoi,
            "itos": self.itos,
            "special_tokens": self.special_tokens,
        }

    def load_config_dict(self, config: dict) -> "TrieTokenizer":
        self.vocab_size = config["vocab_size"]
        self.stoi = dict(config["stoi"])
        self.itos = list(config["itos"])
        self.special_tokens = dict(config["special_tokens"])
        self._build_trie()
        return self

    @classmethod
    def from_config_dict(cls, config: dict) -> "TrieTokenizer":
        return cls().load_config_dict(config)

    @classmethod
    def from_file(cls, path: str) -> "TrieTokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_config_dict(json.load(f))

    def dump_config_file(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.config, f, ensure_ascii=False)

    # ---------------- encode / decode ----------------

    @property
    def unknown_id(self) -> int:
        return self.special_tokens["<|unknown|>"]

    @property
    def pad_id(self) -> int:
        return self.special_tokens["<|padding|>"]

    @property
    def bos_id(self) -> int:
        return self.special_tokens["<|bos|>"]

    @property
    def eos_id(self) -> int:
        return self.special_tokens["<|eos|>"]

    def encode(self, text: str) -> List[int]:
        """Greedy longest-match; unmatched single chars -> <|unknown|>."""
        ids: List[int] = []
        pos = 0
        n = len(text)
        root = self._root
        unknown = self.unknown_id
        while pos < n:
            node = root
            best_id = -1
            best_len = 0
            depth = 0
            # single pass down the trie, tracking deepest accepting node
            while pos + depth < n:
                node = node.children.get(text[pos + depth])
                if node is None:
                    break
                depth += 1
                if node.token_id is not None:
                    best_id = node.token_id
                    best_len = depth
            if best_len == 0:
                # single character not in vocab
                ids.append(unknown)
                pos += 1
            else:
                ids.append(best_id)
                pos += best_len
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        # ids beyond the vocab render as nothing, like the C engine's
        # failed lookup (a model may have more logits than tokens when
        # vocab_size was padded past the tokenizer)
        n = len(self.itos)
        return "".join(self.itos[i] for i in ids if 0 <= i < n)


def apply_instruct_template(question: str) -> str:
    """Nano instruct wrapping (reference: data.py:170-178, infer.py:131)."""
    return f"<|instruct_mark|>{question}<|response_mark|>"
