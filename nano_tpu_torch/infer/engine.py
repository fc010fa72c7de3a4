"""Inference engine: context + session API with streaming generation.

Port of the single-stream half of ``nano_tpu/infer/engine.py``:
``LLMContext`` (model load, sampler, KV cache sizing), ``Session`` (one
token per ``step()`` call), ``generate_sync`` with on_prefilling /
on_decoding / on_finished callbacks, ``StreamDecoder``, and
``generate_on_device`` (prefill + decode with no host round trip per
token).

Prompts are padded to power-of-two buckets and the prefill computes the
LM head only at the last prompt position (``last_idx``), as in the JAX
engine, so both compare the same positions.  PyTorch runs eagerly: the
decode loop is a Python loop (no ``lax.scan``), and the decode attention
reads only the rows up to the current position, so the per-segment
``attn_len`` buckets of the JAX scan have no counterpart here.
Speculative decode, LoRA, batching and observers are not ported yet.
"""

from __future__ import annotations

import codecs
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nano_tpu_torch import resolve_device
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.io import binfmt
from nano_tpu_torch.models import gpt
from nano_tpu_torch.ops import sampling
from nano_tpu_torch.tokenizer.trie import TrieTokenizer, apply_instruct_template

# Nano stop tokens: <|padding|>=0 and <|eos|>=3
NANO_STOP_TOKENS = (0, 3)

# nucleus window: top-p sampling runs over the top-K candidates instead
# of a full-vocab sort (the JAX engine's NUCLEUS_WINDOW)
NUCLEUS_WINDOW = 128


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _exact_multinomial(sampler: sampling.SamplerConfig) -> bool:
    """Plain multinomial: no top-k requested and top_p outside (0, 1)."""
    return (not sampler.top_k) and not (0.0 < sampler.top_p < 1.0)


def _sample_windowed(logits: torch.Tensor, sampler: sampling.SamplerConfig,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """Next tokens (B,) from f32 logits (B, V): argmax at temperature 0
    (the first maximum on ties); full-vocab multinomial when exact; else
    nucleus sampling over the top-K window with the true full-vocab
    probabilities (top-k renormalizes within the window)."""
    if sampler.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    temp = torch.full((), max(sampler.temperature, 1e-6),
                      dtype=logits.dtype, device=logits.device)
    scaled = logits / temp
    if _exact_multinomial(sampler):
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    window = min(sampler.top_k or NUCLEUS_WINDOW, logits.shape[-1])
    top_logits, top_idx = torch.topk(scaled, window, dim=-1)
    if sampler.top_k:
        probs = torch.softmax(top_logits, dim=-1)
    else:
        probs = torch.exp(top_logits - torch.logsumexp(scaled, dim=-1,
                                                       keepdim=True))
    if 0.0 < sampler.top_p < 1.0:
        cum = torch.cumsum(probs, dim=-1)
        probs = torch.where((cum - probs) <= sampler.top_p, probs,
                            torch.zeros_like(probs))
    draw = torch.multinomial(probs, 1, generator=generator)
    return torch.gather(top_idx, -1, draw)[:, 0]


# =====================================================================
# Context
# =====================================================================

@dataclass
class LLMContext:
    """Loaded model + runtime knobs (reference: Nano_Context).

    max_seq_len is decoupled from the model's block_size so the KV cache
    can be sized per deployment."""

    cfg: ModelConfig
    params: Dict[str, Any]
    tokenizer: Any                      # TrieTokenizer or BpeTokenizer
    max_seq_len: int
    device: Optional[torch.device] = None   # None: cuda, or raise
    dtype: torch.dtype = torch.bfloat16
    sampler: sampling.SamplerConfig = field(
        default_factory=sampling.SamplerConfig)
    random_seed: int = 39
    stop_tokens: Tuple[int, ...] = NANO_STOP_TOKENS
    arch: str = "nano"                  # "nano" | "qwen2" | "qwen3"
    enable_thinking: bool = False       # Qwen chat template switch
    kv_cache_dtype: Optional[torch.dtype] = None   # torch.int8 halves it
    _rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(
        default=None, init=False, repr=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def rope_tables(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(cos, sin) covering max_seq_len on the device, made once."""
        if not self.cfg.use_rope:
            return None
        if self._rope is None:
            self._rope = gpt.precompute_rope(
                self.cfg.head_dim, self.max_seq_len, self.cfg.rope_theta,
                self.device)
        return self._rope

    def new_cache(self, batch: int,
                  seq_len: Optional[int] = None) -> gpt.KVCache:
        return gpt.KVCache.create(self.cfg, batch,
                                  seq_len or self.max_seq_len,
                                  self.kv_cache_dtype or self.dtype,
                                  self.device)

    def generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.random_seed)

    @classmethod
    def from_bin(cls, path: str, max_seq_len: Optional[int] = None,
                 dtype=torch.bfloat16, quantized: Optional[bool] = None,
                 device=None, **kw) -> "LLMContext":
        """Load a .bin model onto `device` (cuda unless asked otherwise).
        quantized=None keeps Q80 and Q4K files quantized on the device
        (Q80 / Q4K kernels); quantized=False dequantizes to `dtype`."""
        device = resolve_device(device)
        with open(path, "rb") as f:
            hdr = binfmt.parse_header(f.read(binfmt.HEADER_BYTES))
        if quantized is None:
            quantized = hdr.quant_type in (binfmt.QUANT_Q80,
                                           binfmt.QUANT_Q4K)
        bm = binfmt.read_model(path, dense=not quantized)
        if quantized:
            params = binfmt.quantized_device_params(bm, device=device)
        else:
            params = binfmt.dense_device_params(bm.params, dtype, device)
        if bm.header.model_type in (binfmt.MODEL_TYPE_QWEN2,
                                    binfmt.MODEL_TYPE_QWEN3):
            from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
            tok = bm.tokenizer_config["tokenizer"]
            kw.setdefault("stop_tokens", QWEN_STOP_TOKENS)
            kw.setdefault("arch", "qwen2" if bm.header.model_type ==
                          binfmt.MODEL_TYPE_QWEN2 else "qwen3")
        else:
            tok = TrieTokenizer.from_config_dict(bm.tokenizer_config)
        return cls(cfg=bm.config, params=params, tokenizer=tok,
                   max_seq_len=max_seq_len or bm.config.block_size,
                   device=device, dtype=dtype, **kw)

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self.tokenizer.decode(ids)

    def build_prompt_ids(self, prompt: str, template: bool) -> List[int]:
        """Nano instruct template for Nano models, the Qwen chat template
        for Qwen models (reference: infer/main_cli.c:266-278)."""
        if not template:
            return self.encode(prompt)
        if self.arch in ("qwen2", "qwen3"):
            return self.tokenizer.apply_chat_template(
                prompt, enable_thinking=self.enable_thinking)
        return self.encode(apply_instruct_template(prompt))

    def stream_decoder(self) -> "StreamDecoder":
        return StreamDecoder(self.tokenizer)


class StreamDecoder:
    """Per-token streaming decode that never splits a multi-byte UTF-8
    character across emissions: byte-level BPE tokens (Qwen) can end
    mid-character, so the incomplete tail waits for the next token.
    Character-native tokenizers (the Nano trie) pass straight through."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        vocab = getattr(tokenizer, "vocab", None)
        self._byte_vocab = (isinstance(vocab, list) and len(vocab) > 0
                            and isinstance(vocab[0], bytes))
        if self._byte_vocab:
            self._dec = codecs.getincrementaldecoder("utf-8")("replace")

    def feed(self, tok_id: int) -> str:
        if not self._byte_vocab:
            return self._tok.decode([int(tok_id)])
        vocab = self._tok.vocab
        tid = int(tok_id)
        if not 0 <= tid < len(vocab):
            return ""                       # OOV: render as nothing
        return self._dec.decode(vocab[tid])

    def flush(self) -> str:
        """Emit any buffered incomplete tail (as U+FFFD)."""
        if not self._byte_vocab:
            return ""
        return self._dec.decode(b"", True)


# =====================================================================
# prefill shared by Session and generate_on_device
# =====================================================================

def _prefill_first_token(ctx: LLMContext, prompt_ids: List[int],
                         cache: gpt.KVCache, generator: torch.Generator
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the pow2-padded prompt, sample the first token from the last
    prompt position.  -> (token (1,) on the device, seen mask (1, V))."""
    n = len(prompt_ids)
    pad_len = min(_bucket(n), ctx.max_seq_len)
    ids = np.zeros((1, pad_len), np.int64)
    ids[0, :n] = prompt_ids
    ids_t = torch.from_numpy(ids).to(ctx.device)
    logits, _ = gpt.forward_with_cache(
        ctx.params, ids_t, cache, 0, ctx.cfg, dtype=ctx.dtype,
        attn_len=pad_len if pad_len < cache.max_seq else None,
        last_idx=n - 1, rope=ctx.rope_tables())
    # repetition-penalty scope: the prompt tokens
    seen = sampling.seen_mask_from_ids(
        ids_t, torch.tensor([n], device=ctx.device), ctx.cfg.vocab_size)
    last = sampling.apply_repetition_penalty(
        logits[:, 0].float(), seen, ctx.sampler.repetition_penalty)
    tok = _sample_windowed(last, ctx.sampler, generator)
    sampling.update_seen_mask(seen, tok)
    return tok, seen


def _decode_step(ctx: LLMContext, tok: torch.Tensor, pos: int,
                 cache: gpt.KVCache, seen: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """Forward one token at `pos`, sample the next (seen updated in
    place when a repetition penalty applies)."""
    logits, _ = gpt.forward_with_cache(
        ctx.params, tok[:, None], cache, pos, ctx.cfg, dtype=ctx.dtype,
        rope=ctx.rope_tables())
    logits = logits[:, 0].float()
    penalty = ctx.sampler.repetition_penalty
    if penalty != 1.0:
        logits = sampling.apply_repetition_penalty(logits, seen, penalty)
    nxt = _sample_windowed(logits, ctx.sampler, generator)
    if penalty != 1.0:
        sampling.update_seen_mask(seen, nxt)
    return nxt


# =====================================================================
# Session — one token per step() call
# =====================================================================

class Session:
    """Re-entrant generation session (reference: infer/infer.c:1196-1308).
    step() produces ONE token per call so event-loop frontends can
    interleave generation with I/O."""

    PREFILLING = 0
    DECODING = 1
    FINISHED = 2

    def __init__(self, ctx: LLMContext, prompt: str,
                 max_new_tokens: Optional[int] = None,
                 template: bool = False,
                 prompt_ids: Optional[List[int]] = None):
        self.ctx = ctx
        self.prompt_ids = (list(prompt_ids) if prompt_ids is not None
                           else ctx.build_prompt_ids(prompt, template))
        if len(self.prompt_ids) == 0:
            self.prompt_ids = [getattr(ctx.tokenizer, "bos_id", 0)]
        if len(self.prompt_ids) >= ctx.max_seq_len:
            self.prompt_ids = self.prompt_ids[-(ctx.max_seq_len - 1):]
        self.output_ids: List[int] = []
        self.pos = 0
        self.state = Session.PREFILLING
        self.max_new_tokens = (max_new_tokens if max_new_tokens is not None
                               else ctx.max_seq_len - len(self.prompt_ids))
        self._cache = ctx.new_cache(1)
        self._gen = ctx.generator()
        self._seen: Optional[torch.Tensor] = None
        self._cur_tok: Optional[torch.Tensor] = None
        self.t_start = time.time()
        self.t_first_token: Optional[float] = None
        self.tps = 0.0

    def _do_prefill(self) -> int:
        self._cur_tok, self._seen = _prefill_first_token(
            self.ctx, self.prompt_ids, self._cache, self._gen)
        self.pos = len(self.prompt_ids)
        self.state = Session.DECODING
        self.t_first_token = time.time()
        return int(self._cur_tok[0])

    def step(self) -> Optional[int]:
        """Generate the next token, or None when finished."""
        ctx = self.ctx
        if self.state == Session.FINISHED:
            return None
        if self.state == Session.PREFILLING:
            tok = self._do_prefill()
        else:
            if (self.pos + 1 >= ctx.max_seq_len or
                    len(self.output_ids) >= self.max_new_tokens):
                self.state = Session.FINISHED
                return None
            self._cur_tok = _decode_step(ctx, self._cur_tok, self.pos,
                                         self._cache, self._seen, self._gen)
            self.pos += 1
            tok = int(self._cur_tok[0])

        if tok in ctx.stop_tokens:
            self.state = Session.FINISHED
            return None
        self.output_ids.append(tok)
        n_out = len(self.output_ids)
        if self.t_first_token and n_out > 1:
            self.tps = (n_out - 1) / max(time.time() - self.t_first_token,
                                         1e-9)
        if (len(self.prompt_ids) + n_out) >= ctx.max_seq_len or \
                n_out >= self.max_new_tokens:
            self.state = Session.FINISHED
        return tok

    @property
    def text(self) -> str:
        return self.ctx.decode(self.output_ids)


def generate_sync(ctx: LLMContext, prompt: str,
                  max_new_tokens: Optional[int] = None,
                  template: bool = False,
                  on_prefilling: Optional[Callable[[Session], Any]] = None,
                  on_decoding: Optional[Callable[[Session, int, str], Any]] = None,
                  on_finished: Optional[Callable[[Session], Any]] = None,
                  prompt_ids: Optional[List[int]] = None) -> Session:
    """Callback-driven generation loop (reference: infer/infer.c:1321-1361).
    `prompt_ids` bypasses the tokenizer (token-id prompts)."""
    session = Session(ctx, prompt, max_new_tokens, template=template,
                      prompt_ids=prompt_ids)
    if on_prefilling:
        on_prefilling(session)
    sdec = ctx.stream_decoder()
    while session.state != Session.FINISHED:
        tok = session.step()
        if tok is None:
            break
        if on_decoding:
            if on_decoding(session, tok, sdec.feed(tok)) is False:
                break
    if on_finished:
        on_finished(session)
    return session


def generate_on_device(ctx: LLMContext, prompt_ids: List[int],
                       n_tokens: int) -> np.ndarray:
    """Throughput path: prefill + n_tokens decode with the tokens kept on
    the device until the end.  Returns the generated ids (n_tokens,).
    No early stop.  Over-long prompts keep their tail and n_tokens is
    capped to the cache room, both matching Session.  The cache is sized
    to the pow2 bucket of prompt + output, not max_seq_len."""
    if not prompt_ids:
        prompt_ids = [getattr(ctx.tokenizer, "bos_id", 0)]
    if len(prompt_ids) >= ctx.max_seq_len:
        prompt_ids = prompt_ids[-(ctx.max_seq_len - 1):]
    n = len(prompt_ids)
    n_tokens = min(n_tokens, ctx.max_seq_len - n)
    if n_tokens <= 0:
        return np.zeros((0,), np.int32)
    cache = ctx.new_cache(1, seq_len=min(_bucket(n + n_tokens),
                                         ctx.max_seq_len))
    gen = ctx.generator()
    tok, seen = _prefill_first_token(ctx, prompt_ids, cache, gen)
    out = torch.empty((n_tokens,), dtype=torch.int64, device=ctx.device)
    out[0] = tok[0]
    for i in range(1, n_tokens):
        tok = _decode_step(ctx, tok, n + i - 1, cache, seen, gen)
        out[i] = tok[0]
    return out.cpu().numpy().astype(np.int32)
