"""Byte-level BPE tokenizer for converted Qwen2.5/Qwen3 models.

The port's own copy of ``nano_tpu/tokenizer/bpe.py`` (pure Python, kept
here so the port never imports the JAX package).

Behavior parity with the reference C tokenizer (reference:
infer/tokenizer.c:14-262): vocabulary of byte-strings with merge-rank
scores (score = -(1+merge_index), so earlier merges win); encoding splits
UTF-8 text into codepoint-level tokens (byte fallback for unknowns) and
repeatedly merges the best-scoring adjacent pair; the Qwen chat template
is applied with hard-coded special ids, including the enable_thinking
switch (infer/tokenizer.c:214-262).

Implementation is new: instead of re-concatenating strings and bsearching
the whole vocab per candidate pair (O(n^2) per merge round in the C
code), we precompute a (left_id, right_id) -> (score, merged_id) map and
scan with it.

The vocab+scores serialization matches the reference .bin field written
by infer/tools/export_qwen.py:362-436:
    u32 field_bytes, u32 max_token_length,
    then per token: f32 score, u32 len, len bytes.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Dict, List, Optional, Tuple

# Qwen special token ids (reference: infer/tokenizer.c:233-258,
# infer/infer.c stop ids 151643/151645)
QWEN_ENDOFTEXT = 151643
QWEN_IM_START = 151644
QWEN_IM_END = 151645
QWEN_THINK_OPEN = 151667
QWEN_THINK_CLOSE = 151668
QWEN_USER = 872
QWEN_ASSISTANT = 77091
QWEN_NEWLINE = 198

QWEN_STOP_TOKENS = (QWEN_ENDOFTEXT, QWEN_IM_END)


def gpt2_bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 printable-byte mapping (public domain construction)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class BpeTokenizer:
    """Byte-level BPE with merge-rank scores."""

    def __init__(self, vocab: List[bytes], scores: List[float]):
        assert len(vocab) == len(scores)
        self.vocab = vocab
        self.scores = scores
        self.vocab_size = len(vocab)
        self.max_token_length = max((len(t) for t in vocab), default=0)
        self.stoi: Dict[bytes, int] = {}
        for i, t in enumerate(vocab):
            # first occurrence wins (C bsearch over sorted unique strings)
            self.stoi.setdefault(t, i)
        # (left, right) -> (score, merged_id)
        self._pair_merge: Dict[Tuple[int, int], Tuple[float, int]] = {}
        self._build_pairs()

    def _build_pairs(self) -> None:
        # candidate merged tokens are exactly vocab entries with len >= 2;
        # enumerate splits to find constituent pairs present in the vocab
        for merged, mid in self.stoi.items():
            if len(merged) < 2:
                continue
            score = self.scores[mid]
            for cut in range(1, len(merged)):
                l = self.stoi.get(merged[:cut])
                r = self.stoi.get(merged[cut:])
                if l is None or r is None:
                    continue
                key = (l, r)
                prev = self._pair_merge.get(key)
                if prev is None or score > prev[0]:
                    self._pair_merge[key] = (score, mid)

    # ---------------- encode / decode ----------------

    def _initial_tokens(self, text: str) -> List[int]:
        """Codepoint-level split with byte fallback
        (reference: infer/tokenizer.c:132-171)."""
        out: List[int] = []
        for ch in text:
            b = ch.encode("utf-8")
            tid = self.stoi.get(b)
            if tid is not None:
                out.append(tid)
            else:
                # byte fallback: look the raw byte token up in THIS vocab
                # (byte-level BPE vocabs contain all 256 single bytes);
                # the llama2.c-style (byte+3) id is only a last resort
                # and is wrong for HF-id vocabs
                for x in b:
                    bt = self.stoi.get(bytes([x]))
                    out.append(bt if bt is not None else x + 3)
        return out

    def encode(self, text: str) -> List[int]:
        """Greedy best-pair merge (reference: infer/tokenizer.c:174-211),
        as a heap over a doubly-linked token list — O(n log n) instead of
        the rescan-per-merge O(n^2) (a 1 MB corpus previously took hours
        in pure Python; eval.py and the WSS server encode whole
        prompts/files through here).

        Merge ORDER is identical to the rescan algorithm: each round the
        reference takes the leftmost pair of strictly-highest score;
        the heap orders by (-score, left original index) and original
        indices are stable under merges (a merged node keeps its left
        constituent's index), so ties resolve to the same pair.  Stale
        heap entries are skipped by revalidating the pair's token ids.
        """
        tokens = self._initial_tokens(text)
        n = len(tokens)
        if n < 2:
            return tokens
        import heapq
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        alive = [True] * n
        heap: List[Tuple[float, int, int, int, int]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j < 0:
                return
            m = self._pair_merge.get((tokens[i], tokens[j]))
            if m is not None:
                heapq.heappush(heap,
                               (-m[0], i, tokens[i], tokens[j], m[1]))

        for i in range(n - 1):
            push(i)
        while heap:
            _negs, i, li, ri, mid = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j < 0 or tokens[i] != li or tokens[j] != ri:
                continue                       # stale entry
            tokens[i] = mid                    # merge into the left node
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                push(prv[i])
            push(i)
        return [tokens[i] for i in range(n) if alive[i]]

    def decode(self, ids: List[int]) -> str:
        return b"".join(self.vocab[i] for i in ids).decode("utf-8",
                                                           errors="replace")

    # ---------------- chat template ----------------

    def apply_chat_template(self, user_prompt: str,
                            enable_thinking: bool = False) -> List[int]:
        """<|im_start|>user\\n PROMPT <|im_end|>\\n<|im_start|>assistant\\n
        [+ empty <think> block when thinking disabled]
        (reference: infer/tokenizer.c:214-262)."""
        # the control-token ids are the canonical Qwen vocabulary's; a
        # smaller (test/toy) vocab cannot contain them — fall back to the
        # raw encoding instead of emitting out-of-range ids (same
        # condition as cpp/nano.cpp chat_template; the reference engine
        # reads out of bounds here)
        if (QWEN_IM_START >= self.vocab_size
                or QWEN_THINK_CLOSE >= self.vocab_size):
            return self.encode(user_prompt)
        ids = [QWEN_IM_START, QWEN_USER, QWEN_NEWLINE]
        ids += self.encode(user_prompt)
        ids += [QWEN_IM_END, QWEN_NEWLINE, QWEN_IM_START, QWEN_ASSISTANT,
                QWEN_NEWLINE]
        if not enable_thinking:
            ids += [QWEN_THINK_OPEN, QWEN_NEWLINE, QWEN_NEWLINE,
                    QWEN_THINK_CLOSE, QWEN_NEWLINE, QWEN_NEWLINE]
        return ids

    def apply_chat_template_messages(self, messages,
                                     enable_thinking: bool = False
                                     ) -> List[int]:
        """Multi-turn extension of the single-turn reference template:
        one ``<|im_start|>{role}\\n{content}<|im_end|>\\n`` block per
        message (OpenAI-style role/content dicts), then the generation
        prompt ``<|im_start|>assistant\\n``.  The reference engine only
        renders one user turn (infer/tokenizer.c:214-262); the block
        structure here is the canonical Qwen chat format the model was
        trained on."""
        if (QWEN_IM_START >= self.vocab_size
                or QWEN_THINK_CLOSE >= self.vocab_size):
            # toy/test vocab without the control tokens: raw fallback,
            # same condition as apply_chat_template above
            return self.encode("\n".join(m.get("content", "")
                                         for m in messages))
        ids: List[int] = []
        for m in messages:
            ids += [QWEN_IM_START]
            ids += self.encode(str(m.get("role", "user")))
            ids += [QWEN_NEWLINE]
            ids += self.encode(str(m.get("content", "")))
            ids += [QWEN_IM_END, QWEN_NEWLINE]
        ids += [QWEN_IM_START, QWEN_ASSISTANT, QWEN_NEWLINE]
        if not enable_thinking:
            ids += [QWEN_THINK_OPEN, QWEN_NEWLINE, QWEN_NEWLINE,
                    QWEN_THINK_CLOSE, QWEN_NEWLINE, QWEN_NEWLINE]
        return ids

    # ---------------- .bin field (de)serialization ----------------

    def serialize_field(self) -> bytes:
        buf = io.BytesIO()
        total = 8 + sum(8 + len(t) for t in self.vocab)
        buf.write(struct.pack("<II", total, self.max_token_length))
        for t, s in zip(self.vocab, self.scores):
            buf.write(struct.pack("<fI", s, len(t)))
            buf.write(t)
        return buf.getvalue()

    @classmethod
    def parse_field(cls, data: bytes, offset: int, vocab_size: int
                    ) -> Tuple["BpeTokenizer", int]:
        total, _max_len = struct.unpack_from("<II", data, offset)
        pos = offset + 8
        vocab: List[bytes] = []
        scores: List[float] = []
        for _ in range(vocab_size):
            s, ln = struct.unpack_from("<fI", data, pos)
            pos += 8
            vocab.append(bytes(data[pos:pos + ln]))
            pos += ln
            scores.append(s)
        assert pos - offset == total, "BPE tokenizer field length mismatch"
        return cls(vocab, scores), pos

    # ---------------- HF tokenizer.json import ----------------

    @classmethod
    def from_hf_tokenizer_json(cls, path: str, vocab_size: int
                               ) -> "BpeTokenizer":
        """Build from a HF tokenizer.json (reference:
        infer/tools/export_qwen.py:362-409): merge index -> negative score,
        GPT-2 printable-unicode decoded back to raw bytes."""
        with open(path, "r", encoding="utf-8") as f:
            tok = json.load(f)
        model = tok["model"]
        vocab_map = model["vocab"]
        tokens: List[str] = [""] * vocab_size
        scores: List[float] = [0.0] * vocab_size
        for t, i in vocab_map.items():
            tokens[i] = t
        for added in tok.get("added_tokens", []):
            tokens[added["id"]] = added["content"]
        return cls._from_printable_vocab(tokens, scores, model["merges"],
                                         model.get("byte_fallback", False))

    @classmethod
    def _from_printable_vocab(cls, tokens: "List[str]",
                              scores: "List[float]", merges,
                              byte_fallback: bool) -> "BpeTokenizer":
        """Shared tail of the HF-tokenizer.json and GGUF ingestion paths:
        merge index -> negative score, GPT-2 printable-unicode decoded
        back to raw bytes."""
        stoi = {t: i for i, t in enumerate(tokens) if t}
        for i, m in enumerate(merges):
            t1, t2 = (m[0], m[1]) if isinstance(m, list) else m.split(" ", 1)
            ti = stoi.get(t1 + t2)
            if ti is not None and scores[ti] == 0:
                scores[ti] = -(1 + i)
        gpt2_decode = {v: k for k, v in gpt2_bytes_to_unicode().items()}
        vocab_bytes: List[bytes] = []
        for t in tokens:
            if not byte_fallback:
                b = bytes(gpt2_decode.get(c, 0) for c in t)
            else:
                b = t.encode("utf-8")
            b = b.replace(b"\0", b"\7")
            vocab_bytes.append(b)
        return cls(vocab_bytes, scores)

    @classmethod
    def from_gguf_metadata(cls, tokens: "List[str]", merges
                           ) -> "BpeTokenizer":
        """Build from GGUF tokenizer.ggml.{tokens,merges} arrays — the
        same GPT-2 printable-unicode vocab strings a HF tokenizer.json
        carries (llama.cpp's convert writes them through unchanged)."""
        scores = [0.0] * len(tokens)
        return cls._from_printable_vocab(list(tokens), scores,
                                         list(merges or []), False)
