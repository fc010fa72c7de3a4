"""Inference engine: context + session API with streaming generation.

Port of the single-stream half of ``nano_tpu/infer/engine.py``:
``LLMContext`` (model load, sampler, KV cache sizing), ``Session`` (one
token per ``step()`` call), ``generate_sync`` with on_prefilling /
on_decoding / on_finished callbacks, ``StreamDecoder``, and
``generate_on_device`` (prefill + decode with no host round trip per
token), each with speculative greedy decode when ``spec_k`` > 0; and the
full-sequence decoders of non-causal and denoising models, ``seq2seq``
and ``denoise_generate`` (eager forwards through the no-cache path).

Prompts are padded to power-of-two buckets and the prefill computes the
LM head only at the last prompt position (``last_idx``), as in the JAX
engine, so both compare the same positions.  The prefill runs eagerly.
The decode step (``_decode_step``) takes every input as a device tensor —
token, position, seen mask, cache — so on the card it is captured once as
a CUDA graph (``DecodeGraph``) per sampler and replayed, one step a
replay: the counterpart of the JAX engine's ``_decode_scan``.  The context
keeps one ``SingleDecoder`` (the static buffers, a max_seq_len cache and
the graphs).  Every piece of work on the context's CUDA stream (prefill,
capture, replay) holds the context's lock, so a capture never records
another thread's kernels.  On the CPU (an explicit ``device="cpu"``) the same
step runs eagerly.  The decode attention reads only the rows up to each
position, so the per-segment ``attn_len`` buckets of the JAX scan have no
counterpart here.

Speculative decode (``infer.speculative``, ``LLMContext.spec_k`` > 0, greedy
sampling): the decoder's verify round (``speculative.spec_decode_round``)
is a ``DecodeGraph`` too, captured per (k, attended length).  ``Session``
replays one round and reads its tokens once; ``generate_on_device`` keeps
the loop's state on the device and reads it once every
``SPEC_READ_EVERY`` rounds.  Continuous batching is ``serve.batching``.

Observers (``observe``; ``LLMContext.observation``): a ``Session`` attaches
the context's observer around its prefill and each plain step, and
speculation is off while one is attached, as in the JAX engine.  A callback
observer's taps copy to the host, which no CUDA graph can hold, so its
steps run eagerly (``SingleDecoder.step``); a summary observer
(``NANO_TPU_OBSERVE=fallback``) keeps the step a graph, captured apart
with the taps writing rows into a static buffer that the host reads once
after each replay.  ``generate_on_device`` and ``BatchedEngine`` fire no
taps, as in JAX: ``on_stream`` attaches no observer for them.

Parallel serving (``parallel.mesh``): ``LLMContext.shard`` cuts the
weights to this rank's part of the mesh's "model" axis (tensor parallel:
the rank's config then holds its local heads and the plan, through which
the blocks all-reduce their row-parallel products; caches hold the local
KV heads), and ``replicate_to`` copies a context onto another device (a
replica, which serves on its own).  Serving across ranks is SPMD: every
rank makes the same calls with the same inputs, and since the hidden
state after each all-reduce is the same on every rank and the samplers
are seeded alike, every rank takes the same tokens.  Under NCCL the decode
steps and verify rounds stay CUDA graphs with the all-reduces captured in
them; a gloo collective cannot be captured, so under gloo they run eagerly
(``LLMContext.captures``).

LoRA: a context carries one adapter (``lora`` / ``lora_scale``), attached,
swapped and detached by ``load_lora`` / ``load_lora_checkpoint`` /
``unload_lora`` at any time (the JAX engine's hot-swap), or cloned into a
variant that shares the base weights (``clone_with_lora``).  The decoder
keeps its own static copy of the context's adapter
(``AdapterBuffers``), which its graphs read and which it brings up to date
each time a stream claims it: an adapter of the same rank is copied into
the buffers the graphs captured (no capture again, also after a detach),
one of another rank gets new buffers and the graphs that read the old ones
are dropped, and a context without an adapter runs the graphs it always
had.
"""

from __future__ import annotations

import codecs
import collections
import contextlib
import gc
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nano_tpu_torch import observe, resolve_device
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.infer import speculative
from nano_tpu_torch.io import binfmt
from nano_tpu_torch.models import gpt
from nano_tpu_torch.ops import decode_attn, launches, sampling
from nano_tpu_torch.tokenizer.trie import TrieTokenizer, apply_instruct_template

# Nano stop tokens: <|padding|>=0 and <|eos|>=3
NANO_STOP_TOKENS = (0, 3)

# nucleus window: top-p sampling runs over the top-K candidates instead
# of a full-vocab sort (the JAX engine's NUCLEUS_WINDOW)
NUCLEUS_WINDOW = 128

# speculative verify rounds that generate_on_device replays between two
# host reads of the loop's state
SPEC_READ_EVERY = 8


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _attn_bucket(cover: int, cap: int, minimum: int = 16) -> Optional[int]:
    """The attended length of a verify round that must attend `cover` rows
    of a `cap`-row cache: the covering pow2 bucket, or None when that is
    the whole cache."""
    b = min(_bucket(cover, minimum=minimum), cap)
    return b if b < cap else None


def _exact_multinomial(sampler: sampling.SamplerConfig) -> bool:
    """Plain multinomial: no top-k requested and top_p outside (0, 1)."""
    return (not sampler.top_k) and not (0.0 < sampler.top_p < 1.0)


def _draw(probs: torch.Tensor, generator: Optional[torch.Generator]
          ) -> torch.Tensor:
    """One index per row of `probs` (B, n), drawn in proportion to it: the
    exponential race argmax(p / E), E ~ Exp(1) (the Gumbel-max draw of
    jax.random.categorical).  No host synchronization, so a CUDA graph can
    capture it."""
    race = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / race, dim=-1)


def _sample_windowed(logits: torch.Tensor, sampler: sampling.SamplerConfig,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """Next tokens (B,) from f32 logits (B, V): argmax at temperature 0
    (the first maximum on ties); a full-vocab draw when exact; else
    nucleus sampling over the top-K window with the true full-vocab
    probabilities (top-k renormalizes within the window)."""
    if sampler.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    temp = torch.full((), max(sampler.temperature, 1e-6),
                      dtype=logits.dtype, device=logits.device)
    scaled = logits / temp
    if _exact_multinomial(sampler):
        return _draw(torch.softmax(scaled, dim=-1), generator)
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
    return torch.gather(top_idx, -1, _draw(probs, generator)[:, None])[:, 0]


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
    spec_k: int = 0                     # speculative draft length cap
    lora: Optional[Dict[str, torch.Tensor]] = None   # stacked (L, in, r) ...
    lora_scale: float = 0.0             # alpha / rank of the adapter
    mesh: Optional[Any] = None          # set by shard()
    observation: Optional[Callable] = None   # nano_tpu_torch/observe.py
    _rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(
        default=None, init=False, repr=False)
    _decoder: Optional["SingleDecoder"] = field(
        default=None, init=False, repr=False)
    _lock: Any = field(default_factory=threading.RLock, init=False,
                       repr=False)
    _stream: Any = field(default=None, init=False, repr=False)
    _pool: Any = field(default=None, init=False, repr=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    @contextlib.contextmanager
    def on_stream(self, observer: Optional[Callable] = None):
        """Run the enclosed decode work on the context's own CUDA stream
        (made once; every decode graph is captured and replayed on it, and
        the decode-attention workspace is kept per stream), ordered after
        the caller's stream and before it again, holding the context's lock
        (re-entrant): one thread's work at a time, so no thread's kernels
        land in another's capture.  `observer` is attached for the block on
        this thread (``observe.attached``), none unless one is given.  On
        the CPU: only the lock and the observer."""
        with self._lock, observe.attached(observer):
            if self.device.type != "cuda":
                yield
                return
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            caller = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                yield
            caller.wait_stream(self._stream)

    def graph_pool(self):
        """One memory pool for every decode graph of this context (they are
        replayed one at a time and keep no tensor of the pool alive)."""
        if self._pool is None and self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @property
    def captures(self) -> bool:
        """Whether decode steps are captured as CUDA graphs: on the card,
        unless the context is tensor parallel over a backend other than
        NCCL (gloo's collectives cannot be captured; the steps then run
        eagerly)."""
        tp = getattr(self.cfg, "tp", None)
        return self.device.type == "cuda" and (tp is None
                                               or tp.backend == "nccl")

    def shard(self, mesh, tensor_parallel: bool = True) -> "LLMContext":
        """Serve this rank's part of the model over `mesh`
        (``parallel.mesh.make_mesh``; the JAX engine's ``shard``).  With
        `tensor_parallel` the weights are cut to this rank's part of the
        "model" axis (``mesh.shard_inference_params``: heads and hidden
        units, fused tensors part by part) and the config becomes the
        rank's (local heads and the plan); without, the weights stay whole
        and every rank serves them.  Every rank of the model group then
        makes the same calls.  An attached LoRA adapter is cut with the
        same plan (``mesh.cut_lora``: the B of q, k and v on the rank's
        heads, wo's A on wo's input rows where wo is row-parallel); the
        JAX package replicates it and lets GSPMD cut the products."""
        from nano_tpu_torch.parallel import mesh as meshlib
        if getattr(self.cfg, "tp", None) is not None:
            raise ValueError("this context is sharded already")
        self.mesh = mesh
        if tensor_parallel:
            if self.observation is not None:
                raise ValueError(_NO_SHARDED_OBSERVER)
            self.params, tp = meshlib.shard_inference_params(
                self.params, mesh, self.cfg)
            self.cfg = meshlib.local_config(self.cfg, tp)
            if self.lora is not None:
                self.lora = meshlib.cut_lora(self.lora, tp)
        self._decoder = None
        return self

    def replicate_to(self, device) -> "LLMContext":
        """A replica of this context on `device`, the data-parallel
        serving unit (one BatchedEngine per replica, each decoding on its
        own): the weights (and adapter) copied there, one copy of a tensor
        that two leaves share (the tied head); host state (tokenizer,
        sampler) shared; its own decoder, stream and graphs."""
        import dataclasses
        if getattr(self.cfg, "tp", None) is not None:
            raise ValueError("replicate an unsharded context")
        device = torch.device(device)
        copies: Dict[int, Any] = {}

        def put(t):
            if id(t) not in copies:
                copies[id(t)] = t.to(device)
            return copies[id(t)]
        return dataclasses.replace(
            self, params=gpt.map_leaves(put, self.params),
            lora=None if self.lora is None else gpt.map_leaves(put, self.lora),
            device=device, mesh=None)

    def decoder(self) -> "SingleDecoder":
        """The single-stream decode state (a max_seq_len cache) and its
        graphs, made once and kept (made again for a larger spec_k)."""
        if self._decoder is None or self._decoder.k_max < self.spec_k:
            self._decoder = SingleDecoder(self)
        return self._decoder

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

    @classmethod
    def from_gguf(cls, path: str, max_seq_len: Optional[int] = None,
                  dtype=torch.bfloat16, quantized: Optional[bool] = None,
                  device=None, **kw) -> "LLMContext":
        """Load a llama.cpp-ecosystem GGUF checkpoint (dense Qwen2/Qwen3,
        ``io/gguf.py``) onto `device` (cuda unless asked otherwise).
        quantized=None keeps a quantized file (Q8_0 / Q4_K / Q6_K / Q4_0
        blocks) in the port's quantized layouts, which the ggml per-group
        affines map onto losslessly, with wq / wk / wv and w1 / w3 fused
        as a .bin file's are where each set is Q80 of one group size
        (``_fuse_q80_products``); quantized=False dequantizes everything
        to `dtype`."""
        from nano_tpu_torch.io import gguf
        from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
        device = resolve_device(device)
        g = gguf.GGUFFile(path)
        wq0 = g.tensors.get("blk.0.attn_q.weight")
        if quantized is None:
            quantized = (wq0 is not None and wq0.ggml_type in (
                gguf.GGML_Q8_0, gguf.GGML_Q4_K, gguf.GGML_Q6_K,
                gguf.GGML_Q4_0))
        if quantized:
            cfg, model_type, tok = gguf.gguf_header_only(g, max_seq_len)
            params = gguf.quantized_device_params(
                g, cfg, g.meta["general.architecture"], device=device)
            _fuse_q80_products(params["blocks"])
        else:
            cfg, raw, model_type, tok = gguf.load_gguf_qwen(path, max_seq_len)
            params = binfmt.dense_device_params(raw, dtype, device)
        kw.setdefault("stop_tokens", QWEN_STOP_TOKENS)
        kw.setdefault("arch", "qwen2" if model_type ==
                      binfmt.MODEL_TYPE_QWEN2 else "qwen3")
        return cls(cfg=cfg, params=params, tokenizer=tok,
                   max_seq_len=max_seq_len or cfg.block_size,
                   device=device, dtype=dtype, **kw)

    @classmethod
    def from_checkpoint(cls, path: str, max_seq_len: Optional[int] = None,
                        dtype=torch.bfloat16, device=None, **kw
                        ) -> "LLMContext":
        """Serve a training checkpoint (.npz, this package's or the JAX
        package's) on `device` (cuda unless asked otherwise): matrices in
        `dtype`, norms and biases in f32, the trie tokenizer from its
        metadata."""
        from nano_tpu_torch.io.checkpoint import Checkpoint
        device = resolve_device(device)
        ck = Checkpoint(path)
        if ck.is_lora and not ck.has("model"):
            raise ValueError("LoRA-only checkpoint: pass the base model via "
                             "from_checkpoint(base) + load_lora_checkpoint")
        cfg = ModelConfig.from_dict(ck.model_config)
        params = gpt.map_leaves(
            lambda t: t.to(device=device,
                           dtype=dtype if t.dim() >= 2 else torch.float32),
            ck.load_params())
        tok = TrieTokenizer.from_config_dict(ck.tokenizer_config)
        return cls(cfg=cfg, params=params, tokenizer=tok,
                   max_seq_len=max_seq_len or cfg.block_size,
                   device=device, dtype=dtype, **kw)

    def _attach(self, lora: Dict[str, Any], scale: float) -> None:
        """Attach a whole adapter, cut to this rank's part on a tensor-
        parallel context."""
        lora = {k: torch.as_tensor(v).to(self.device, self.dtype)
                for k, v in lora.items()}
        tp = getattr(self.cfg, "tp", None)
        if tp is not None:
            from nano_tpu_torch.parallel import mesh as meshlib
            lora = meshlib.cut_lora(lora, tp)
        self.lora = lora
        self.lora_scale = scale

    def load_lora_checkpoint(self, path: str) -> None:
        """Attach the LoRA adapter of a training checkpoint (.npz, this
        package's or the JAX package's): alpha / rank from its train
        config."""
        from nano_tpu_torch.io.checkpoint import Checkpoint
        ck = Checkpoint(path)
        rank, alpha = ck.lora_rank_alpha()
        self._attach(ck.load_lora(), alpha / rank)

    def load_lora(self, path: str) -> None:
        """Hot-swap a LoRA module (reference: infer/infer.c:500-549): the
        next step of every stream decodes with it."""
        from nano_tpu_torch.parallel.mesh import full_config
        bl = binfmt.read_lora(path, full_config(self.cfg))
        self._attach(bl.lora, bl.alpha / bl.rank)

    def unload_lora(self) -> None:
        self.lora = None
        self.lora_scale = 0.0

    def clone_with_lora(self, path: str) -> "LLMContext":
        """A variant context sharing the base weights (the same tensors,
        no copy) with its own LoRA adapter, decoder and stream."""
        import dataclasses
        variant = dataclasses.replace(self)
        variant.load_lora(path)
        return variant

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

    def build_chat_ids(self, messages) -> List[int]:
        """OpenAI-style role/content messages -> prompt ids.  Multi-turn
        extension of build_prompt_ids (the reference templates are
        single-turn): Qwen arches render canonical im_start blocks; Nano
        renders one instruct/response pair per exchange, the training
        format (reference: data.py:170-178), with any system message
        folded into the next user question."""
        if self.arch in ("qwen2", "qwen3"):
            return self.tokenizer.apply_chat_template_messages(
                messages, enable_thinking=self.enable_thinking)
        text, system = "", ""
        for m in messages:
            role = m.get("role", "user")
            content = str(m.get("content", ""))
            if role == "system":
                system = content
            elif role == "assistant":
                text += f"{content}<|eos|>"
            else:
                q = f"{system}\n{content}" if system else content
                system = ""
                text += apply_instruct_template(q)
        return self.encode(text)


# an observer sees one device's activations; a tensor-parallel rank holds
# only its own heads, so an observed sharded context is refused
_NO_SHARDED_OBSERVER = ("an observer cannot be attached to a tensor-parallel "
                        "(sharded) context: each rank holds only its own "
                        "heads")


def _fuse_q80_products(blocks: Dict[str, Any]) -> None:
    """In place: wq / wk / wv -> ``wqkv`` and w1 / w3 -> ``w13``,
    concatenated along the output dimension as the .bin loader lays them
    out (``binfmt.quantized_device_params``), where every tensor of the set
    is a stacked Q80 tensor of one group size: one product where the file
    had three or two, the same rows and the same math.  Any other set
    (Q4K, mixed kinds or group sizes) stays as the loader left it."""
    from nano_tpu_torch.ops.qmatmul import Q80Tensor
    for fused, names in (("wqkv", ("wq", "wk", "wv")), ("w13", ("w1", "w3"))):
        ws = [blocks.get(n) for n in names]
        if not all(isinstance(w, Q80Tensor) for w in ws):
            continue
        if len({(w.group_size, w.w8a8) for w in ws}) != 1:
            continue
        blocks[fused] = Q80Tensor(
            q=torch.cat([w.q for w in ws], dim=-2),
            scales=torch.cat([w.scales for w in ws], dim=-2),
            group_size=ws[0].group_size, w8a8=ws[0].w8a8)
        for n in names:
            del blocks[n]


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
# prefill and the decode step
# =====================================================================

def _prefill(ctx: LLMContext, prompt_ids: List[int], cache: gpt.KVCache,
             lora: Optional[Dict[str, torch.Tensor]] = None, lora_scale=0.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the pow2-padded prompt into `cache` (host positions, eager),
    with the adapter `lora` if one is given.  -> (f32 logits of the last
    prompt position (1, V), the prompt's seen mask (1, V))."""
    n = len(prompt_ids)
    pad_len = min(_bucket(n), ctx.max_seq_len)
    ids = np.zeros((1, pad_len), np.int64)
    ids[0, :n] = prompt_ids
    ids_t = torch.from_numpy(ids).to(ctx.device)
    logits, _ = gpt.forward_with_cache(
        ctx.params, ids_t, cache, 0, ctx.cfg, dtype=ctx.dtype,
        attn_len=pad_len if pad_len < cache.max_seq else None,
        last_idx=n - 1, rope=ctx.rope_tables(), lora=lora,
        lora_scale=lora_scale)
    # repetition-penalty scope: the prompt tokens
    seen = sampling.seen_mask_from_ids(
        ids_t, torch.tensor([n], device=ctx.device), ctx.cfg.vocab_size)
    return logits[:, 0].float(), seen


def _prefill_first_token(ctx: LLMContext, prompt_ids: List[int],
                         cache: gpt.KVCache, generator: torch.Generator,
                         lora: Optional[Dict[str, torch.Tensor]] = None,
                         lora_scale=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill, then sample the first token from the last prompt position.
    -> (token (1,) on the device, seen mask (1, V))."""
    last, seen = _prefill(ctx, prompt_ids, cache, lora, lora_scale)
    last = sampling.apply_repetition_penalty(
        last, seen, ctx.sampler.repetition_penalty)
    tok = _sample_windowed(last, ctx.sampler, generator)
    sampling.update_seen_mask(seen, tok)
    return tok, seen


def _decode_step(ctx: LLMContext, tok: torch.Tensor, pos: torch.Tensor,
                 cache: gpt.KVCache, seen: torch.Tensor,
                 generator: Optional[torch.Generator],
                 lora: Optional[Dict[str, torch.Tensor]] = None,
                 lora_scale=0.0) -> torch.Tensor:
    """Forward tok (B,) at positions pos (B,) int32 on the device (with the
    adapter `lora` if one is given; its scale a 0-d device tensor under a
    capture), sample the next tokens (seen updated in place when a
    repetition penalty applies).  Every input is a device tensor: this is
    the function a decode graph captures, and the eager loop it is held
    against."""
    logits, _ = gpt.forward_decode_batched(
        ctx.params, tok, cache, pos, ctx.cfg, dtype=ctx.dtype,
        rope=ctx.rope_tables(), lora=lora, lora_scale=lora_scale)
    penalty = ctx.sampler.repetition_penalty
    if penalty != 1.0:
        logits = sampling.apply_repetition_penalty(logits, seen, penalty)
    nxt = _sample_windowed(logits, ctx.sampler, generator)
    observe.tap(observe.Phase.SAMPLE, -1, nxt)
    if penalty != 1.0:
        sampling.update_seen_mask(seen, nxt)
    return nxt


class DecodeGraph:
    """`n_steps` calls of `step` — decode steps that read and write only
    static device buffers — captured once as a CUDA graph and replayed
    (the counterpart of the JAX engine's ``_decode_scan``).

    The first ``run`` on the card is eager, on the caller's stream (the
    context's own stream): every one-time CUDA call (library load, kernel
    attributes, the decode-attention workspace) happens there, and those
    steps are real.  Then the graph is captured on that stream; a capture
    that fails raises.  Later runs replay it and add to the kernels' launch
    counters what the capture counted (capturing records launches but runs
    none, so its own counts are taken back).  The graph holds the
    decode-attention workspaces alive.  A stochastic sampler draws from
    `generator`, which the graph registers.  On the CPU, and where
    `capture` is false (``LLMContext.captures``), every run is the eager
    steps.
    """

    def __init__(self, step: Callable[[], None], device: torch.device,
                 n_steps: int = 1, generator: Optional[torch.Generator] = None,
                 pool=None, capture: bool = True):
        self.step, self.device, self.n_steps = step, device, n_steps
        self.capture = capture and device.type == "cuda"
        self.generator, self.pool = generator, pool
        self.graph = None
        self.delta: Dict = {}           # launch counts of one replay
        self.workspaces: tuple = ()     # what the captured launches write

    def _eager(self) -> None:
        for _ in range(self.n_steps):
            self.step()

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "this PyTorch cannot register a torch.Generator with a "
                    "CUDA graph (CUDAGraph.register_generator_state), so "
                    "stochastic sampling cannot be captured; use greedy "
                    "sampling (temperature 0)")
            graph.register_generator_state(self.generator)
        before = launches.counts()
        # no garbage collection under capture: a graph freed by a collection
        # (of anything holding one in a reference cycle) would be destroyed
        # while the stream captures, which invalidates the capture
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=torch.cuda.current_stream(
                                      self.device)):
                self._eager()
            after = launches.counts()
        finally:
            launches.restore(before)
            if gc_on:
                gc.enable()
        self.delta = {k: after[k] - before[k] for k in before}
        self.graph = graph
        self.workspaces = decode_attn.workspaces()

    def prepare(self) -> None:
        """Warm up and capture now (the warm-up steps are real steps)."""
        if self.capture and self.graph is None:
            self._eager()
            self._capture()

    def run(self) -> None:
        if not self.capture:
            self._eager()
        elif self.graph is None:
            self.prepare()
        else:
            self.graph.replay()
            launches.add(self.delta)


class AdapterBuffers:
    """A LoRA adapter as static device tensors that captured graphs read:
    ``lora`` (stacked, in the compute dtype) and ``scale`` (a 0-d tensor in
    that dtype), None while no adapter is attached.  ``sync`` brings them
    up to an adapter: one of the shapes the buffers have is copied into
    them, so the graphs that captured them stay valid (detaching keeps the
    buffers for the next adapter); one of other shapes gets new buffers.
    ``key`` (the attached adapter's shape, None without one) is part of
    every graph's key, so no graph outlives the buffers it reads once the
    caller drops those of the replaced shape."""

    def __init__(self, device: torch.device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self.lora: Optional[Dict[str, torch.Tensor]] = None
        self.scale: Optional[torch.Tensor] = None
        self._bufs: Optional[tuple] = None      # (lora, scale), kept
        self._src: tuple = (None, 0.0)

    @property
    def key(self) -> Optional[tuple]:
        return None if self.lora is None else tuple(self.lora["wq_a"].shape)

    def sync(self, lora: Optional[Dict[str, torch.Tensor]], scale: float
             ) -> bool:
        """Hold `lora` scaled by `scale` (the same dict object as the last
        call: nothing to do).  -> whether buffers that a graph may have
        captured were replaced."""
        if lora is self._src[0] and scale == self._src[1]:
            return False
        self._src = (lora, scale)
        if lora is None:
            self.lora = self.scale = None
            return False
        bufs = self._bufs
        if bufs is not None and all(bufs[0][k].shape == t.shape
                                    for k, t in lora.items()):
            for k, t in lora.items():
                bufs[0][k].copy_(t)
            bufs[1].fill_(scale)
            self.lora, self.scale = bufs
            return False
        self._bufs = ({k: t.to(self.device, self.dtype, copy=True)
                       for k, t in lora.items()},
                      torch.full((), scale, dtype=self.dtype,
                                 device=self.device))
        self.lora, self.scale = self._bufs
        return bufs is not None


class SingleDecoder:
    """The single stream's decode state on the device — token, position,
    seen mask, a max_seq_len cache, an output buffer and the index of its
    next row — with one single-step ``DecodeGraph`` per sampler.  The
    context keeps one.

    For speculative decode (the context's spec_k > 0 when it was made:
    ``k_max``) it also holds the token history, the loop's end (``stop_at``,
    an index of out) and round count, the last round's tokens and count,
    one spare cache row past max_seq_len (where a round after the loop's
    end writes) and room in out for a round's overdraft; and one
    ``DecodeGraph`` of ``speculative.spec_decode_round`` per (k, attended
    length).

    Streams share it one at a time: a stream ``claim``s it before each use,
    and the state of the stream that held it is copied out (to be copied
    back when that stream claims it again).  A claim also brings the
    decoder's copy of the context's LoRA adapter (``adapter``) up to date;
    its graphs are keyed by the adapter's shape as well."""

    def __init__(self, ctx: LLMContext):
        dev = ctx.device
        # weak references here and in the graphs' steps: no reference
        # cycle, so the cache and the graphs go with the context
        self.ctx = weakref.proxy(ctx)
        self.k_max = ctx.spec_k
        spec = self.k_max > 0
        self.cache = ctx.new_cache(1, ctx.max_seq_len + int(spec))
        zeros = lambda n, dtype=torch.int64: torch.zeros(
            (n,), dtype=dtype, device=dev)
        self.tok = zeros(1)
        self.pos = zeros(1, torch.int32)
        self.seen = torch.zeros((1, ctx.cfg.vocab_size), dtype=torch.bool,
                                device=dev)
        self.out = zeros(ctx.max_seq_len + (self.k_max + 1 if spec else 0))
        self.n_out = zeros(1)
        self.hist = zeros(ctx.max_seq_len)[None]
        self.stop_at, self.rounds = zeros(1), zeros(1)
        self.round_g, self.round_n = zeros(self.k_max + 1), zeros(1)
        self.gen = ctx.generator()
        self.adapter = AdapterBuffers(dev, ctx.dtype)
        self.obs_rows: Optional[observe.RowBuffer] = None   # summary mode
        self.graphs: Dict[tuple, DecodeGraph] = {}
        self._owner: Optional[weakref.ref] = None
        # the state of each stream that does not hold the buffers now
        self._saved: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def _buffers(self) -> List[torch.Tensor]:
        c = self.cache
        return [t for t in (c.k, c.v, c.k_scale, c.v_scale, self.tok,
                            self.pos, self.seen, self.n_out, self.hist,
                            self.stop_at, self.rounds, self.round_g,
                            self.round_n) if t is not None]

    def claim(self, owner: Any = None) -> None:
        """Make `owner`'s stream the one in the buffers; None: a stream
        that is started and finished in one call (generate_on_device)."""
        if self.adapter.sync(self.ctx.lora, self.ctx.lora_scale):
            # the graphs that read the buffers just released or replaced
            self.graphs = {k: g for k, g in self.graphs.items()
                           if k[-1] is None}
        held = self._owner() if self._owner is not None else None
        if held is not None and held is owner:
            return
        if held is not None:
            self._saved[held] = ([t.clone() for t in self._buffers()],
                                 self.gen.get_state())
        saved = self._saved.pop(owner, None) if owner is not None else None
        if saved is not None:
            for t, s in zip(self._buffers(), saved[0]):
                t.copy_(s)
            self.gen.set_state(saved[1])
        self._owner = weakref.ref(owner) if owner is not None else None

    def _row_buffer(self) -> observe.RowBuffer:
        """Room for the summary rows of one forward: 8 taps a layer,
        EMBEDDING, FINAL_NORM, LOGITS and SAMPLE."""
        return observe.RowBuffer(8 * self.ctx.cfg.n_layer + 4,
                                 self.ctx.device)

    def _rows(self) -> observe.RowBuffer:
        """The decode step's summary rows, which its summary graph writes
        (made once, outside any capture; nothing else writes them, so
        their count stays the captured step's)."""
        if self.obs_rows is None:
            self.obs_rows = self._row_buffer()
        return self.obs_rows

    def prefill(self, prompt_ids: List[int]) -> torch.Tensor:
        """Start a stream: prefill into the cache, the first token into
        the buffers and out[0].  -> the first token (1,).  A summary
        observer gets the prefill's rows after it (a buffer of their
        own)."""
        self.gen.manual_seed(self.ctx.random_seed)
        rows = self._row_buffer() if observe.fallback_active() else None
        with observe.capture(rows):
            tok, seen = _prefill_first_token(
                self.ctx, prompt_ids, self.cache, self.gen,
                self.adapter.lora, self.adapter.scale)
        if rows is not None:
            observe.deliver(rows.read())
        self.tok.copy_(tok)
        self.seen.copy_(seen)
        self.pos.fill_(len(prompt_ids))
        self.out[:1] = tok
        self.n_out.fill_(1)
        self.stop_at.fill_(torch.iinfo(torch.int64).max)
        if self.k_max > 0:
            n = len(prompt_ids)
            self.hist.zero_()
            self.hist[0, :n] = torch.tensor(prompt_ids, dtype=torch.int64)
            self.hist[0, n:n + 1] = tok
        return tok

    def _step(self) -> None:
        """One decode step (what a graph captures); under a summary
        observer its taps write the decoder's rows."""
        with observe.capture(self._rows() if observe.fallback_active()
                             else None):
            nxt = _decode_step(self.ctx, self.tok, self.pos, self.cache,
                               self.seen, self.gen, self.adapter.lora,
                               self.adapter.scale)
        self.tok.copy_(nxt)
        self.out.index_copy_(0, self.n_out, nxt)
        self.pos.add_(1)
        self.n_out.add_(1)

    def _graph(self, n_steps: int = 1, observed=False) -> DecodeGraph:
        """The graph of `n_steps` steps for the context's sampler (the
        engine replays single steps; a longer graph is for measurement),
        with the summary taps when `observed` is "fallback" (the observing
        mode, ``observe.trace_token``, is part of the key)."""
        key = (self.ctx.sampler, n_steps, observed, self.adapter.key)
        if key not in self.graphs:
            stochastic = self.ctx.sampler.temperature > 0.0
            me = weakref.proxy(self)
            self.graphs[key] = DecodeGraph(
                lambda: me._step(), self.ctx.device, n_steps,
                self.gen if stochastic else None, self.ctx.graph_pool(),
                self.ctx.captures)
        return self.graphs[key]

    def step(self) -> None:
        """One decode step of the stream in the buffers, in the observing
        mode of this thread: a replay of the tap-free graph; eagerly under a
        callback observer, whose host copies no graph can hold; a replay of
        the summary graph under a summary observer, which then gets the
        step's rows, read once."""
        mode = observe.trace_token()
        if mode == "callback":
            self._step()
            return
        if mode:
            self._rows()                # made before the capture
        self._graph(1, mode).run()
        if mode:
            observe.deliver(self.obs_rows.read())

    def run(self, n: int) -> None:
        """n decode steps, a replay each."""
        graph = self._graph()
        for _ in range(n):
            graph.run()

    def _round_graph(self, k: int, attn_len: Optional[int]) -> DecodeGraph:
        """The graph of one verify round of k drafts attending `attn_len`
        rows (all when None)."""
        key = ("round", self.ctx.sampler, k, attn_len, self.adapter.key)
        if key not in self.graphs:
            me = weakref.proxy(self)
            self.graphs[key] = DecodeGraph(
                lambda: speculative.spec_decode_round(me, k, attn_len),
                self.ctx.device, pool=self.ctx.graph_pool(),
                capture=self.ctx.captures)
        return self.graphs[key]

    def spec_round(self, k: int, attn_len: Optional[int]) -> List[int]:
        """One verify round (a replay) -> its emitted tokens, read once."""
        self._round_graph(k, attn_len).run()
        got = torch.cat([self.round_n, self.round_g[:k + 1]]).tolist()
        return got[1:1 + got[0]]

    def spec_loop(self, n_tokens: int, k: int, cover_cap: int) -> None:
        """Speculative decode until out holds n_tokens (JAX's
        ``spec_decode_loop``): verify rounds replayed SPEC_READ_EVERY at a
        time, with one host read of (n_out, pos, rounds) between, from which
        the next replays' graph is chosen, the attended length covering
        pos + SPEC_READ_EVERY * (k + 1) + 2 rows (at most `cover_cap`, the
        rows the loop can reach).  Sets ``speculative.LAST_STATS``."""
        T = self.ctx.max_seq_len
        self.stop_at.fill_(n_tokens)
        self.rounds.zero_()
        while True:
            n_out, pos, rounds = torch.cat(
                [self.n_out, self.pos.long(), self.rounds]).tolist()
            if n_out >= n_tokens or pos + k + 2 > T:
                break
            cover = min(pos + SPEC_READ_EVERY * (k + 1) + 2, cover_cap)
            graph = self._round_graph(
                k, _attn_bucket(cover, T, minimum=256))
            for _ in range(SPEC_READ_EVERY):
                graph.run()
        speculative.LAST_STATS = {"tokens": n_out - 1, "rounds": rounds}


# =====================================================================
# Session — one token per step() call
# =====================================================================

class Session:
    """Re-entrant generation session (reference: infer/infer.c:1196-1308).
    step() produces ONE token per call so event-loop frontends can
    interleave generation with I/O.

    With ``ctx.spec_k`` > 0 and greedy sampling a step without pending
    tokens runs one verify round (a replay), which emits 1..k+1 tokens into
    ``_pending``.  The draft length adapts as the JAX Session's does: pow2
    buckets up to spec_k, doubled on full acceptance, the accepted run's
    bucket on a miss, and a rejected k = 1 probe parks speculation for a
    backoff-doubled number of plain steps."""

    PREFILLING = 0
    DECODING = 1
    FINISHED = 2

    # plain steps after a rejected k = 1 probe before the next probe:
    # doubled per consecutive rejection, reset on any acceptance
    _SPEC_PARK_MIN = 4
    _SPEC_PARK_MAX = 32

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
        self._dec: Optional[SingleDecoder] = None
        # speculative decode state
        self._pending: List[int] = []
        self._spec_k_cur = 1
        self._spec_park = 0
        self._spec_park_len = self._SPEC_PARK_MIN
        # tokens of the plain steps taken while parked, written into the
        # history in one device update before the next probe
        self._park_toks: List[int] = []
        # speculation is off while an observer is attached (the JAX
        # engine's rule): a verify round has no per-phase taps
        self._spec = (ctx.spec_k > 0 and ctx.sampler.temperature <= 0.0
                      and ctx.observation is None)
        if (ctx.observation is not None
                and getattr(ctx.cfg, "tp", None) is not None):
            raise ValueError(_NO_SHARDED_OBSERVER)
        # decode calls by kind: verify rounds, and plain steps by the rule
        # that took them (spec off, observed, sampling, parked, near the
        # context end)
        self.steps_by: Dict[str, int] = collections.Counter()
        self.t_start = time.time()
        self.t_first_token: Optional[float] = None
        self.tps = 0.0

    def _do_prefill(self) -> int:
        self._dec = self.ctx.decoder()
        with self.ctx.on_stream(self.ctx.observation):
            self._dec.claim(self)
            first = int(self._dec.prefill(self.prompt_ids)[0])
        self.pos = len(self.prompt_ids)
        self.state = Session.DECODING
        self.t_first_token = time.time()
        return first

    def _spec_adapt(self, k: int, n_acc: int) -> None:
        """Draft-length controller (pow2-bucketed, with the k = 0 park):
        full acceptance doubles toward the cap, a partial miss drops to the
        accepted run's bucket, and a fully rejected k = 1 probe parks
        speculation (plain steps) with exponential backoff."""
        if n_acc > 0:
            self._spec_park_len = self._SPEC_PARK_MIN
        if n_acc == k:
            self._spec_k_cur = min(2 * k, self.ctx.spec_k)
        elif n_acc == 0 and k == 1:
            self._spec_k_cur = 0
            self._spec_park = self._spec_park_len
            self._spec_park_len = min(2 * self._spec_park_len,
                                      self._SPEC_PARK_MAX)
        else:
            self._spec_k_cur = 1 << (max(1, n_acc).bit_length() - 1)

    def _spec_step(self) -> int:
        """One verify round: the history caught up with the parked plain
        steps, then a replay of the round's graph."""
        ctx, dec = self.ctx, self._dec
        k = max(1, min(self._spec_k_cur, ctx.spec_k,
                       ctx.max_seq_len - self.pos - 2))
        ab = _attn_bucket(self.pos + k + 2, ctx.max_seq_len, minimum=256)
        with ctx.on_stream():
            dec.claim(self)
            if self._park_toks:
                start = self.pos - len(self._park_toks) + 1
                dec.hist[0, start:self.pos + 1] = torch.tensor(
                    self._park_toks, dtype=torch.int64)
                self._park_toks = []
            self._pending = dec.spec_round(k, ab)
        self._spec_adapt(k, len(self._pending) - 1)
        self.pos += len(self._pending)
        return self._pending.pop(0)

    def step(self) -> Optional[int]:
        """Generate the next token, or None when finished."""
        ctx = self.ctx
        if self.state == Session.FINISHED:
            return None
        if self.state == Session.PREFILLING:
            tok = self._do_prefill()
        elif self._pending:
            tok = self._pending.pop(0)
        else:
            if (self.pos + 1 >= ctx.max_seq_len or
                    len(self.output_ids) >= self.max_new_tokens):
                self.state = Session.FINISHED
                return None
            if self._spec and self._spec_k_cur == 0:
                if self._spec_park > 0:
                    self._spec_park -= 1      # a plain step this time
                else:
                    self._spec_k_cur = 1      # the park is over: probe
            if (self._spec and self._spec_k_cur > 0
                    and self.pos + 3 <= ctx.max_seq_len):
                self.steps_by["round"] += 1
                tok = self._spec_step()
            else:
                self.steps_by[
                    "plain" if ctx.spec_k == 0 else
                    "observed" if ctx.observation is not None else
                    "sampling" if not self._spec else
                    "parked" if self._spec_k_cur == 0 else
                    "near the context end"] += 1
                # one replay of the context's graphed step (eager under a
                # callback observer), one token read
                with ctx.on_stream(ctx.observation):
                    self._dec.claim(self)
                    self._dec.step()
                    tok = int(self._dec.tok[0])
                self.pos += 1
                if self._spec:
                    self._park_toks.append(tok)

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
    capped to the cache room, both matching Session.  On the card the
    n_tokens - 1 decode steps are replays of the context's captured step,
    each writing its token to a device buffer at an index held on the
    device; one host read at the end.  With spec_k > 0, greedy sampling
    and room for the last round's drafts (the JAX engine's eligibility),
    speculative verify rounds instead (``SingleDecoder.spec_loop``; stats
    in ``speculative.LAST_STATS``)."""
    if not prompt_ids:
        prompt_ids = [getattr(ctx.tokenizer, "bos_id", 0)]
    if len(prompt_ids) >= ctx.max_seq_len:
        prompt_ids = prompt_ids[-(ctx.max_seq_len - 1):]
    n = len(prompt_ids)
    n_tokens = min(n_tokens, ctx.max_seq_len - n)
    if n_tokens <= 0:
        return np.zeros((0,), np.int32)
    # the rows a verify round can reach past the last token: its drafts
    need = n + n_tokens + ctx.spec_k + 2
    spec = (ctx.spec_k > 0 and ctx.sampler.temperature <= 0.0
            and need <= ctx.max_seq_len)
    dec = ctx.decoder()
    with ctx.on_stream():
        dec.claim()
        dec.prefill(prompt_ids)
        if spec:
            dec.spec_loop(n_tokens, ctx.spec_k, need)
        else:
            dec.run(n_tokens - 1)
        out = dec.out[:n_tokens].cpu()
    return out.numpy().astype(np.int32)


# =====================================================================
# seq2seq — non-causal single-pass decode (reference: infer/infer.c:1365-1402)
# =====================================================================

@torch.no_grad()
def seq2seq(ctx: LLMContext, input_ids: List[int]) -> List[int]:
    """Global-attention models (sort/palindrome): one forward over the
    input, argmax at every position (the first of equal maxima)."""
    ids = torch.tensor([input_ids], dtype=torch.int64, device=ctx.device)
    logits = gpt.forward(ctx.params, ids, ctx.cfg, dtype=ctx.dtype,
                         lora=ctx.lora, lora_scale=ctx.lora_scale)
    return logits[0].argmax(dim=-1).tolist()


# =====================================================================
# denoise decode (reference: model.py:581-638)
# =====================================================================

@torch.no_grad()
def _denoise_round(ctx: LLMContext, x: torch.Tensor, masked: torch.Tensor,
                   gen: torch.Generator, temperature: float,
                   confidence_threshold: float, top_k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One unmasking round: every still-masked position whose top-k
    probability mass reaches the threshold takes a token drawn from its
    renormalized top k; when none does, the most confident masked position
    alone (at least one a round)."""
    logits = gpt.forward(ctx.params, x, ctx.cfg, dtype=ctx.dtype,
                         lora=ctx.lora, lora_scale=ctx.lora_scale)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    tk_probs, tk_idx = torch.topk(probs, top_k, dim=-1)
    conf = tk_probs.sum(dim=-1)
    decode_mask = (conf >= confidence_threshold) & masked
    if not bool(decode_mask.any()):
        best = int(torch.where(masked, conf, -float("inf"))[0].argmax())
        decode_mask = torch.zeros_like(masked)
        decode_mask[0, best] = masked[0, best]
    tk_norm = tk_probs / tk_probs.sum(dim=-1, keepdim=True)
    draw = torch.multinomial(tk_norm.reshape(-1, top_k), 1, generator=gen)
    sampled = tk_idx.reshape(-1, top_k).gather(1, draw).reshape(x.shape)
    return (torch.where(decode_mask, sampled, x),
            masked & ~decode_mask)


def denoise_generate(ctx: LLMContext, prompt_ids: List[int],
                     max_new_tokens: int, temperature: float = 1.0,
                     top_k: int = 8, confidence_threshold: float = 0.9,
                     mask_token_id: int = 7,
                     callback: Optional[Callable[[np.ndarray], Any]] = None
                     ) -> List[int]:
    """Confidence-thresholded iterative unmasking over fixed-size blocks
    (the JAX engine's loop): each block of the model's block_size holds
    the prompt's tail (at most block_size - 1 tokens, so a position is
    always left to unmask) and mask tokens after it; rounds
    (``_denoise_round``) unmask it until none is left, then its new tokens
    join the output.  Generates max_new_tokens tokens beyond the prompt;
    `callback` sees the block (1, block_size) after each round.  The draws
    come from a ``torch.Generator`` seeded with ``ctx.random_seed``, not
    from the JAX engine's ``jax.random`` stream; at top_k = 1 a draw is the
    argmax and the tokens are the JAX engine's."""
    block = ctx.cfg.block_size
    all_tokens = list(prompt_ids)
    prompt_len = min(len(prompt_ids), block - 1)
    gen = ctx.generator()
    target = len(all_tokens) + max_new_tokens
    while len(all_tokens) < target:
        block_len = min(block - prompt_len, target - len(all_tokens))
        x = torch.full((1, block), mask_token_id, dtype=torch.int64)
        if prompt_len:
            x[0, :prompt_len] = torch.tensor(all_tokens[-prompt_len:])
        x = x.to(ctx.device)
        masked = torch.zeros((1, block), dtype=torch.bool, device=ctx.device)
        masked[0, prompt_len:prompt_len + block_len] = True
        while bool(masked.any()):
            x, masked = _denoise_round(ctx, x, masked, gen, temperature,
                                       confidence_threshold, top_k)
            if callback:
                callback(x.cpu().numpy())
        all_tokens.extend(x[0, prompt_len:prompt_len + block_len].tolist())
    return all_tokens
