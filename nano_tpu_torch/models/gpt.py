"""Nano GPT decoder: the cached inference forward and the full-sequence
training forward of the port.

Port of ``nano_tpu/models/gpt.py``: RMSNorm, RoPE (interleaved or half),
GQA without expanding KV, optional qk-norm and qkv biases, SwiGLU, tied /
untied / ``output_q`` heads; ``forward_with_cache`` with ``attn_len`` and
``last_idx``; ``forward_decode_batched`` (one token per row at
positions held on the device) and ``forward_spec_batched`` (S tokens per
row, the speculative verify round); and the no-cache path ``forward_hidden`` /
``forward`` / ``loss_fn`` (masked CE, chunked CE, remat) with ``init_params``.
Every forward takes an optional LoRA adapter (``lora`` / ``lora_scale``):
the low-rank branch (x @ A) @ B * alpha/rank on q, k, v and wo
(``_lora_delta``), one adapter for every row or, in the batched decode and
verify forwards, an adapter per row picked from a stack (``lora_idx``);
``merge_lora`` folds one into the base and ``init_lora_params`` makes one.
The cached forwards fire an attached observer's taps (``observe``) at the
JAX package's sites, each layer's by its index.

The parameters keep the JAX package's layout so the two compare like with
like: layer weights are STACKED along a leading (n_layer,) axis, dense
matrices are (in, out), quantized ones are ``Q80Tensor`` in the file's
(out, in) rows or packed ``Q4KTensor``.  PyTorch runs eagerly, so the
layer scan is a Python loop over views of the stacked tensors, and the KV
cache is updated IN PLACE (the JAX version returned a new cache; here the
same object comes back).

Kernels on the card: every quantized projection and head goes through
``ops.qmatmul`` (Q80) or ``ops.q4k`` (Q4K: the activation's Q4K
quantization, then the fused-dequant matmul), every single-token attention
through
``ops.decode_attn``, and every full-sequence causal attention of the
no-cache forward through ``ops.flash_attn``, forward and backward.  In
the cached forward each block's two RMSNorms (the second with the
residual add before it), its SwiGLU and the final norm are one kernel each
(``ops.norm_quant``), which also quantize their output for a W8A8 Q80
product fed more than one row, and for Q4K products at every row count,
so that no ``q80_act_quant`` or ``q4k_act_quant`` runs on it.
The cached prefill attention (S > 1), the qk-norm, RoPE and the cache
write are plain PyTorch, as they were XLA-fused ops on the TPU; so are the
no-cache forward's norms and SwiGLU (the fused kernels have no backward);
dense projections, the LoRA branch, the LM head and the loss are
``torch.matmul`` and plain PyTorch, as they were XLA's.

Training parameters are leaf tensors with ``requires_grad`` in the same
nested dict and the same stacked layout, f32 masters cast to the compute
type at each use.  The no-cache forward never touches a ``KVCache``, so
the cache's in-place writes stay out of every autograd graph.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                   create_selective_checkpoint_contexts)

from nano_tpu_torch import observe
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.observe import Phase
from nano_tpu_torch.ops import decode_attn
from nano_tpu_torch.ops.flash_attn import flash_attention
from nano_tpu_torch.ops.norm_quant import (rms_norm, rms_norm_q4k,
                                           rms_norm_q4k_fq, rms_norm_q80,
                                           swiglu_q4k, swiglu_q80)
from nano_tpu_torch.ops.q4k import (MAX_MATVEC_PAD, Q4KTensor, fake_quant_act,
                                    q4k_matmul)
from nano_tpu_torch.ops.qmatmul import Q80Tensor, q80_matmul

Params = Dict[str, Any]


# =====================================================================
# RoPE
# =====================================================================

def precompute_rope(head_dim: int, end: int, theta: float = 10000.0,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (end, head_dim // 2), f32.  Computed on the CPU and
    moved, so every device sees the same table."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    freqs = 1.0 / (theta ** exps)
    t = torch.arange(end, dtype=torch.float32)
    angles = torch.outer(t, freqs)
    return torch.cos(angles).to(device), torch.sin(angles).to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str = "interleaved") -> torch.Tensor:
    """Rotate (..., S, H, D) by position tables (S, D//2).

    interleaved: (x[2i], x[2i+1]) pairs (Nano/Qwen2 layout).
    half: (x[i], x[i+D/2]) pairs (Qwen3/HF rotate_half layout).
    """
    dtype = x.dtype
    xf = x.float()
    if cos.dim() == 2:
        cos = cos[:, None, :]
        sin = sin[:, None, :]
    if style == "interleaved":
        xr = xf[..., 0::2]
        xi = xf[..., 1::2]
        out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos],
                          dim=-1).reshape(x.shape)
    elif style == "half":
        D = x.shape[-1]
        x1 = xf[..., :D // 2]
        x2 = xf[..., D // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    else:
        raise ValueError(f"unknown rope style {style}")
    return out.to(dtype)


# =====================================================================
# primitive layers
# =====================================================================

def _q80_group(ws, rows: int) -> int:
    """The group size at which a fused norm or SwiGLU also quantizes its
    output for the products `ws`: that of W8A8 Q80 weights of one group
    size fed more than one row; else 0 (one row goes to q80_matvec_fq,
    which quantizes it itself, and other weights take the tensor)."""
    if rows < 2 or not all(isinstance(w, Q80Tensor) and w.w8a8 for w in ws):
        return 0
    sizes = {w.group_size for w in ws}
    return sizes.pop() if len(sizes) == 1 else 0


def _q4k_out(ws) -> bool:
    """Whether a fused norm or SwiGLU writes the Q4K integer form of its
    output for the products `ws`: where every one is Q4K, at any row count
    (one row as much as more: the quantization, not the product, is what a
    raw row would cost q4k_matvec_fq), and no row is wider than
    q4k_matvec_fq takes (MAX_MATVEC_PAD; a wider one goes as a tensor)."""
    return bool(ws) and all(isinstance(w, Q4KTensor)
                            and w.n_pad <= MAX_MATVEC_PAD for w in ws)


def _norm(x: torch.Tensor, weight: torch.Tensor, eps: float, ws,
          residual: Optional[torch.Tensor] = None, keep: bool = False):
    """The cached forward's RMSNorm of x (+ residual) for the products
    `ws`, one ``rms_norm_q80`` or ``rms_norm_q4k`` launch -> (h, the
    normed activation: a ``Q4KAct`` where the products are Q4K
    (``_q4k_out``), a ``Q80Act`` where ``_q80_group`` asks for one, else a
    tensor, and the normed tensor where that is the tensor or `keep` asks
    for it too, as a LoRA branch beside a quantized product does; else
    None)."""
    if _q4k_out(ws):
        h, hn, act = rms_norm_q4k(x, weight, eps, residual, want_hn=keep)
        return h, act, hn
    gs = _q80_group(ws, x.numel() // x.shape[-1])
    h, hn, act = rms_norm_q80(x, weight, eps, residual, gs,
                              want_hn=keep or not gs)
    return h, act if gs else hn, hn


def _dense(x, w, dtype) -> torch.Tensor:
    """x @ w in the compute dtype.  Dense weights are (in, out); Q80
    weights keep the file's (out, in) rows and run the Q80 kernels (x may
    be a ``Q80Act`` for a W8A8 one), Q4K weights the Q4K kernels (x may be
    a ``Q4KAct``)."""
    if isinstance(w, Q80Tensor):
        return q80_matmul(x, w, dtype)
    if isinstance(w, Q4KTensor):
        return q4k_matmul(x, w, dtype)
    return torch.matmul(x.to(dtype), w.to(dtype))


def _tp(cfg: ModelConfig):
    """The tensor-parallel plan a rank's config carries
    (``parallel.mesh.ShardedConfig``), None on one device."""
    return getattr(cfg, "tp", None)


def _sp(cfg: ModelConfig):
    """The sequence-parallel part a rank's config carries
    (``parallel.mesh.ShardedConfig``), None without one."""
    return getattr(cfg, "sp", None)


def _row(x, w, dtype, tp, part: str) -> torch.Tensor:
    """x @ w of a row-parallel product, `part` "attn" (wo) or "ffn" (w2),
    under tensor parallelism `tp`, by the plan's mode for that part: where
    w is whole on every rank (no `tp`, mode "replicated"), the product
    alone; "gather": the product of the heads of every rank; "row": this
    rank's partial product, summed over the model group in f32 (a
    quantized product gives f32 itself) and then rounded to `dtype` once,
    as one device rounds the whole sum."""
    mode = None if tp is None else tp.attn if part == "attn" else tp.ffn_mode
    if tp is None or mode == "replicated":
        return _dense(x, w, dtype)
    if mode == "gather":
        return _dense(tp.gather_heads(x), w, dtype)
    quant = isinstance(w, (Q80Tensor, Q4KTensor))
    return tp.leave(_dense(x, w, torch.float32 if quant else dtype)
                    ).to(dtype)


def _lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale,
                dtype, idx: Optional[torch.Tensor] = None,
                tp=None) -> torch.Tensor:
    """The LoRA branch (x @ A) @ B * scale, each product and the scaling
    rounded to `dtype` as the JAX package's (preferred_element_type=dtype,
    then `* scale` in dtype).

    a (in, r), b (r, out), scale a float or a 0-d tensor: one adapter for
    every row.  a (A, in, r), b (A, r, out), idx (B,) and scale (B,): row b
    of x (B, S, in) takes adapter idx[b] of the stack with scale[b], the
    JAX per-slot form with its gather (``serve/batching.py``) moved after
    the products: every adapter's product runs over every row and each row
    keeps its own, so a step reads each of the few adapters once where a
    per-row gather of their weights would read them B times.

    `tp`: x holds this rank's heads and a their rows of A (wo's branch
    under a row-parallel wo): the partial products x @ A are summed over
    the model group in f32 and rounded to `dtype` once, as ``_row`` sums
    wo's."""
    first = lambda x, a: torch.matmul(x.to(dtype), a.to(dtype))
    if tp is not None:
        first = lambda x, a: tp.leave(torch.matmul(
            x.to(dtype).float(), a.to(dtype).float())).to(dtype)
    if idx is None:
        s = scale if isinstance(scale, torch.Tensor) else torch.tensor(
            scale, dtype=dtype)
        h = first(x, a)
        return torch.matmul(h, b.to(dtype)) * s.to(dtype)
    B, S = x.shape[:2]
    h = first(x.reshape(1, B * S, -1), a)
    d = torch.matmul(h, b.to(dtype)).view(a.shape[0], B, S, -1)
    rows = torch.arange(B, device=x.device)
    return d[idx, rows] * scale.to(dtype)[:, None, None]


def _lora_add(y: torch.Tensor, x: torch.Tensor, lora: Optional[Params],
              name: str, scale, dtype, idx=None, tp=None) -> torch.Tensor:
    """y + the LoRA branch of projection `name` on x (y when no adapter;
    `tp` as in ``_lora_delta``)."""
    if lora is None:
        return y
    return y + _lora_delta(x, lora[name + "_a"], lora[name + "_b"], scale,
                           dtype, idx, tp)


def _attn_out(heads: torch.Tensor, layer: Params, dtype, tp,
              lora: Optional[Params] = None, lora_scale=0.0,
              lora_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """wo's product of the attention heads and its LoRA branch.  Under
    tensor parallelism with wo row-parallel both read this rank's heads
    and sum their partial products over the model group; where wo is
    whole ("gather") both read the heads of every rank."""
    if tp is not None and tp.attn == "gather":
        heads, tp = tp.gather_heads(heads), None
    y = _row(heads, layer["wo"], dtype, tp, "attn")
    return _lora_add(y, heads, lora, "wo", lora_scale, dtype, lora_idx, tp)


def _adapter_kw(lora: Optional[Params], i: int, lora_scale,
                lora_idx: Optional[torch.Tensor] = None) -> dict:
    """``block``'s adapter arguments for layer i (its views of the stacked
    tensors); none without an adapter, so that the block is called as it
    is without LoRA."""
    if lora is None:
        return {}
    return dict(lora={k: w[i] for k, w in lora.items()},
                lora_scale=lora_scale, lora_idx=lora_idx)


def _head_q80(params: Params) -> Optional[Q80Tensor]:
    """The Q80 weight that ``compute_logits`` applies to the final norm's
    output as it is, if any (not the Q4K model's requantized head, whose
    activation is fake-quantized first: ``_head_fq``)."""
    w = params.get("output_q")
    if w is not None and isinstance(params["tok_embeddings"], Q4KTensor):
        return None
    for w in (w, params.get("output"), params["tok_embeddings"]):
        if w is not None:
            return w if isinstance(w, Q80Tensor) else None


def _head_fq(params: Params) -> bool:
    """Whether the head is the Q80 table requantized from a Q4K embedding,
    whose activation ``compute_logits`` fake-quantizes first (the final
    norm of the cached forward does it instead, ``rms_norm_q4k_fq``)."""
    return (isinstance(params.get("output_q"), Q80Tensor)
            and isinstance(params["tok_embeddings"], Q4KTensor))


def _dot_f32(h: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """h @ w with both operands rounded to `dtype`, accumulated in f32
    (the JAX preferred_element_type=f32 dot of the LM head)."""
    return torch.matmul(h.to(dtype).float(), w.to(dtype).float())


def embed_tokens(params: Params, idx: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding row gather; a quantized table dequantizes the gathered
    rows.  Ids outside [0, V) are clamped into it, as the JAX gather does
    (the tiny fixtures' trie tokenizer has one entry more than the table)."""
    w = params["tok_embeddings"]
    V = w.out_dim if isinstance(w, (Q80Tensor, Q4KTensor)) else w.shape[0]
    idx = idx.clamp(0, V - 1)
    if isinstance(w, Q4KTensor):
        return w.dequantize_rows(idx, dtype)
    if isinstance(w, Q80Tensor):
        g = w.group_size
        q = w.q[idx]                        # (..., E) int8
        s = w.scales[idx]                   # (..., E // g)
        shape = q.shape
        deq = (q.float().reshape(*shape[:-1], shape[-1] // g, g)
               * s[..., None]).reshape(shape)
        return deq.to(dtype)
    return w[idx].to(dtype)


def compute_logits(h, params: Params, dtype) -> torch.Tensor:
    """LM head -> f32 logits: ``output_q`` (the quantized head, tied to the
    embedding table at load), untied ``output`` (in, out), or the tied
    embedding table (V, E) transposed.  A Q80 head requantized from a Q4K
    table still gets the C engine's Q4K treatment of its activation first
    (reference: infer/infer.c:1012-1014), then runs the Q80 kernels.  h may
    be a ``Q80Act`` for ``_head_q80``'s weight."""
    w = params.get("output_q")
    if w is not None:
        if _head_fq(params):
            E = h.shape[-1]
            h = fake_quant_act(h.reshape(-1, E))[:, :E].reshape(h.shape)
        return _dense(h, w, torch.float32)
    w = params.get("output")
    if w is None:
        w = params["tok_embeddings"]
        if isinstance(w, Q80Tensor):
            return _dense(h, w, torch.float32)
        return _dot_f32(h, w.t(), dtype)
    if isinstance(w, (Q80Tensor, Q4KTensor)):
        return _dense(h, w, torch.float32)
    return _dot_f32(h, w, dtype)


# =====================================================================
# attention
# =====================================================================

def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> int8 values + f32 per-vector scale; rounds half to even
    (torch.round, like jnp.round — unlike the C rounding of Q80)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = absmax / torch.full_like(absmax, 127.0)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    return torch.round(xf / safe[..., None]).to(torch.int8), scale


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """q (B, S, H, D), k (B, T, KV, D) -> (B, KV, rep, S, T) f32."""
    B, S, H, D = q.shape
    qg = q.float().reshape(B, S, cfg.n_kv_head, H // cfg.n_kv_head, D)
    scores = torch.einsum("bskrd,btkd->bkrst", qg, k.float())
    return scores / math.sqrt(D)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B, KV, rep, S, T), v (B, T, KV, D) -> (B, S, KV*rep*D)."""
    out = torch.einsum("bkrst,btkd->bskrd", probs, v)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _qkv(x: torch.Tensor, layer: Params, cfg: ModelConfig,
         cos: Optional[torch.Tensor], sin: Optional[torch.Tensor], dtype,
         lora: Optional[Params] = None, lora_scale=0.0,
         lora_idx: Optional[torch.Tensor] = None,
         xt: Optional[torch.Tensor] = None, layer_idx: Optional[int] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention prologue: projections (fused or not), the LoRA deltas
    on q, k and v (from `xt`, the normed tensor, where x is a ``Q80Act``
    or a ``Q4KAct``),
    biases, per-head qk-norm and RoPE.  x (B, S, E) -> q (B, S, H, D),
    k / v (B, S, KV, D).  With `layer_idx` (the cached forward) q is
    observed after the projection and after RoPE."""
    B, S, E = x.shape
    H, KV, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim

    if "wqkv" in layer:
        qkv = _dense(x, layer["wqkv"], dtype)
        q = qkv[..., :H * D]
        k = qkv[..., H * D:(H + KV) * D]
        v = qkv[..., (H + KV) * D:]
    else:
        q = _dense(x, layer["wq"], dtype)
        k = _dense(x, layer["wk"], dtype)
        v = _dense(x, layer["wv"], dtype)
    if lora is not None:
        xt = x if xt is None else xt
        q = _lora_add(q, xt, lora, "wq", lora_scale, dtype, lora_idx)
        k = _lora_add(k, xt, lora, "wk", lora_scale, dtype, lora_idx)
        v = _lora_add(v, xt, lora, "wv", lora_scale, dtype, lora_idx)
    if cfg.qkv_bias:
        q = q + layer["bq"].to(dtype)
        k = k + layer["bk"].to(dtype)
        v = v + layer["bv"].to(dtype)
    if layer_idx is not None:
        observe.tap(Phase.QKV, layer_idx, q)
    q = q.reshape(B, S, H, D)
    k = k.reshape(B, S, KV, D)
    v = v.reshape(B, S, KV, D)

    if cfg.use_qk_norm:
        q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.norm_eps)
    if cos is not None:
        q = apply_rope(q, cos, sin, cfg.rope_style)
        k = apply_rope(k, cos, sin, cfg.rope_style)
        if layer_idx is not None:
            observe.tap(Phase.ROPE, layer_idx, q)
    return q, k, v


def attention_nocache(x: torch.Tensor, layer: Params, cfg: ModelConfig,
                      cos: Optional[torch.Tensor],
                      sin: Optional[torch.Tensor], dtype,
                      lora: Optional[Params] = None, lora_scale=0.0
                      ) -> torch.Tensor:
    """One full-sequence attention layer without a cache (training).
    Causal models go through ``flash_attention`` (the kernels on the card,
    forward and backward); global attention is the unmasked einsum path.
    `lora`: the layer's adapter, on q, k, v and on wo from the heads.
    Under sequence parallelism (``_sp``) x holds this rank's positions:
    k and v are gathered over the seq group (after qk-norm and RoPE) and
    the queries attend at their offset to the whole sequence."""
    q, k, v = _qkv(x, layer, cfg, cos, sin, dtype, lora, lora_scale)
    sp, offset = _sp(cfg), 0
    if sp is not None:
        k, v = sp.gather(k), sp.gather(v)
        offset = sp.offset(q.shape[1])
    if cfg.is_causal:
        heads = flash_attention(q, k, v, offset)
    else:
        probs = torch.softmax(_gqa_scores(q, k, cfg), dim=-1).to(dtype)
        heads = _gqa_out(probs, v)
    return _attn_out(heads, layer, dtype, _tp(cfg), lora, lora_scale)


def attention(x: torch.Tensor, layer: Params, cfg: ModelConfig,
              cos: Optional[torch.Tensor], sin: Optional[torch.Tensor],
              mask: Optional[torch.Tensor], dtype,
              kv_cache: Tuple[torch.Tensor, ...],
              start_pos: Union[int, torch.Tensor],
              pos_t: Optional[torch.Tensor], attn_len: Optional[int] = None,
              lora: Optional[Params] = None, lora_scale=0.0,
              lora_idx: Optional[torch.Tensor] = None,
              xt: Optional[torch.Tensor] = None,
              layer_idx: int = -1) -> torch.Tensor:
    """One attention layer over a cache (k, v, k_scale, v_scale) of one
    layer, each (B, T, KV, D) / (B, T, KV), written in place.

    S == 1 (decode, positions on the device): `pos_t` (B,) int32 holds
    each row's position and `start_pos` the (B,) int64 index b * T +
    pos_t[b] of the row it writes in the cache seen as (B * T, ...); the
    decode-attention kernel then reads rows t <= pos_t[b].  S > 1: either
    a prefill, where `start_pos` is a host int and the S new rows go to
    [start_pos, start_pos + S), or a verify round with positions on the
    device, where `start_pos` is the (B * S,) int64 index of each new row
    in the cache seen as (B * T, ...).  Either way the einsum path reads the
    first `attn_len` rows (all when None) with the additive `mask`, (S,
    attn_len) or per row (B, 1, 1, S, attn_len); where `pos_t` is given,
    the first row's heads come from the decode-attention kernel instead, as
    a decode step at pos_t computes them.  `lora` (the layer's adapter,
    `lora_idx` as in ``_lora_delta``) adds its deltas to q, k, v (from
    `xt`, see ``_qkv``) and to wo's output, from the heads.  `layer_idx`
    names the layer to an observer (``observe``).
    """
    B, S = x.shape[:2]
    H, KV = cfg.n_head, cfg.n_kv_head
    q, k, v = _qkv(x, layer, cfg, cos, sin, dtype, lora, lora_scale,
                   lora_idx, xt, layer_idx)

    def out(heads):
        observe.tap(Phase.ATTENTION, layer_idx, heads)
        o = _attn_out(heads, layer, dtype, _tp(cfg), lora, lora_scale,
                      lora_idx)
        observe.tap(Phase.ATTN_OUT, layer_idx, o)
        return o

    ck, cv, ks, vs = kv_cache
    quant = ck.dtype == torch.int8
    if quant:
        k, k_sc = _kv_quantize(k)
        v, v_sc = _kv_quantize(v)
    if isinstance(start_pos, torch.Tensor):
        T = ck.shape[1]
        flat = lambda c: c.view(B * T, *c.shape[2:])
        rows_of = lambda x: x.reshape(B * S, *x.shape[2:])
        flat(ck).index_copy_(0, start_pos, rows_of(k).to(ck.dtype))
        flat(cv).index_copy_(0, start_pos, rows_of(v).to(cv.dtype))
        if quant:
            flat(ks).index_copy_(0, start_pos, rows_of(k_sc))
            flat(vs).index_copy_(0, start_pos, rows_of(v_sc))
    else:
        rows = slice(start_pos, start_pos + S)
        ck[:, rows], cv[:, rows] = k, v
        if quant:
            ks[:, rows], vs[:, rows] = k_sc, v_sc
    if pos_t is not None:
        first = decode_attn.decode_attention(
            q[:, 0], ck, cv, ks if quant else None, vs if quant else None,
            pos_t, KV, H // KV)[:, None, :].to(dtype)
        if S == 1:
            return out(first)

    Ta = attn_len if attn_len is not None else ck.shape[1]
    ck, cv = ck[:, :Ta], cv[:, :Ta]
    # a verify round keeps the probabilities and their product with v in
    # f32, as the decode kernel of the step it verifies does
    pdt = torch.float32 if isinstance(start_pos, torch.Tensor) else dtype
    if quant:
        # int8 KV: fold the per-vector scales into scores and probs
        scores = _gqa_scores(q, ck.to(dtype), cfg)
        scores = scores * ks[:, :Ta].permute(0, 2, 1)[:, :, None, None, :]
        probs = torch.softmax(scores + mask, dim=-1).to(pdt)
        probs = probs * vs[:, :Ta].permute(0, 2, 1)[:, :, None, None, :
                                                      ].to(pdt)
        heads = _gqa_out(probs, cv.to(pdt)).to(dtype)
    else:
        scores = _gqa_scores(q, ck, cfg) + mask
        probs = torch.softmax(scores, dim=-1).to(pdt)
        heads = _gqa_out(probs, cv.to(pdt)).to(dtype)
    if pos_t is not None:
        heads = torch.cat([first, heads[:, 1:]], dim=1)
    return out(heads)


def _ffn_hidden(x: torch.Tensor, layer: Params, dtype) -> torch.Tensor:
    """silu(w1 x) * w3 x, the 2F-wide half of SwiGLU."""
    if "w13" in layer:
        h13 = _dense(x, layer["w13"], dtype)
        Fh = h13.shape[-1] // 2
        h1, h3 = h13[..., :Fh], h13[..., Fh:]
    else:
        h1 = _dense(x, layer["w1"], dtype)
        h3 = _dense(x, layer["w3"], dtype)
    return F.silu(h1) * h3


def feed_forward(x: torch.Tensor, layer: Params, dtype,
                 remat: bool = False, tp=None) -> torch.Tensor:
    """SwiGLU: w2(silu(w1 x) * w3 x).  With `remat` the w1 / w3 outputs
    are not kept for backward but computed again there.  `tp`: the
    tensor-parallel plan (w2's partial sums added over the model group)."""
    if remat:
        hidden = checkpoint(_ffn_hidden, x, layer, dtype, use_reentrant=False,
                            preserve_rng_state=False)
    else:
        hidden = _ffn_hidden(x, layer, dtype)
    return _row(hidden, layer["w2"], dtype, tp, "ffn")


def feed_forward_cached(x, layer: Params, dtype, tp=None) -> torch.Tensor:
    """SwiGLU of the cached forward: w2(silu(w1 x) * w3 x) with the
    silu-product one ``swiglu_q4k`` launch for a Q4K w2 (its Q4K integer
    form, at any row count), else one ``swiglu_q80`` launch, which also
    quantizes it for a W8A8 w2 fed more than one row (``_q80_group``);
    `tp` as in ``feed_forward``."""
    if "w13" in layer:
        h13 = _dense(x, layer["w13"], dtype)
    else:
        h13 = torch.cat([_dense(x, layer["w1"], dtype),
                         _dense(x, layer["w3"], dtype)], dim=-1)
    if _q4k_out([layer["w2"]]):
        return _row(swiglu_q4k(h13, want_hidden=False)[1], layer["w2"], dtype,
                    tp, "ffn")
    gs = _q80_group([layer["w2"]], h13.numel() // h13.shape[-1])
    hidden, act = swiglu_q80(h13, gs, want_hidden=not gs)
    return _row(act if gs else hidden, layer["w2"], dtype, tp, "ffn")


def _final(h: torch.Tensor, params: Params, cfg: ModelConfig, dtype,
           last_idx: Optional[int] = None) -> torch.Tensor:
    """The final norm (one ``rms_norm_q80`` launch; ``rms_norm_q4k_fq``,
    which also fake-quantizes its output, where the head is a Q4K model's
    requantized Q80 table) and the LM head -> f32 logits, of row
    `last_idx` alone where one is given.  The norm is per row, so it runs
    on that row alone, unless an observer sees the final norm of every row
    (as the JAX package's tap does)."""
    fq = _head_fq(params)
    w = _head_q80(params)
    tapped = observe.active()
    if last_idx is not None and not tapped:
        h, last_idx = h[:, last_idx:last_idx + 1], None
    if fq:
        _, ht, hn = rms_norm_q4k_fq(h, params["norm"], cfg.norm_eps,
                                    want_hn=tapped)
        hn = hn[..., :h.shape[-1]]
    else:
        _, hn, ht = _norm(h, params["norm"], cfg.norm_eps,
                          [] if w is None else [w], keep=tapped)
    if tapped:
        observe.tap(Phase.FINAL_NORM, -1, ht)
        if last_idx is not None:
            hn = (hn if fq else ht)[:, last_idx:last_idx + 1]
    logits = (_dense(hn, params["output_q"], torch.float32) if fq
              else compute_logits(hn, params, dtype))
    observe.tap(Phase.LOGITS, -1, logits)
    return logits


def block(x: torch.Tensor, layer: Params, cfg: ModelConfig, cos, sin, mask,
          dtype, kv_cache, start_pos: Union[int, torch.Tensor],
          pos_t: Optional[torch.Tensor], attn_len: Optional[int] = None,
          lora: Optional[Params] = None, lora_scale=0.0,
          lora_idx: Optional[torch.Tensor] = None,
          layer_idx: int = -1) -> torch.Tensor:
    """Pre-norm residual block of the cached forward (`start_pos`, `pos_t`,
    the adapter and `layer_idx` as in ``attention``).  The attention norm,
    the residual add with the FFN norm, and SwiGLU are one kernel each, which
    also write the Q80 or Q4K quantization of their output where the
    product they feed takes it (``_q80_group``, ``_q4k_out``; with an
    adapter the attention norm
    writes the normed tensor beside it, which the LoRA branch reads); the
    last residual add stays one eager add.  Under tensor parallelism
    (``_tp``) the attention and FFN outputs are the sums over the model
    group (``_row``) before the norm and the add read them.  An observer
    sees the normed tensors, which the norms then write beside their
    quantized output (`keep`)."""
    qkv = ([layer["wqkv"]] if "wqkv" in layer
           else [layer["wq"], layer["wk"], layer["wv"]])
    w13 = [layer["w13"]] if "w13" in layer else [layer["w1"], layer["w3"]]
    tapped = observe.active()
    _, xn, xt = _norm(x, layer["attn_norm"], cfg.norm_eps, qkv,
                      keep=lora is not None or tapped)
    if tapped:
        observe.tap(Phase.ATTN_NORM, layer_idx, xt)
    a = attention(xn, layer, cfg, cos, sin, mask, dtype, kv_cache, start_pos,
                  pos_t, attn_len, lora, lora_scale, lora_idx, xt, layer_idx)
    h, hn, ht = _norm(x, layer["ffn_norm"], cfg.norm_eps, w13, residual=a,
                      keep=tapped)
    if not tapped:
        return h + feed_forward_cached(hn, layer, dtype, _tp(cfg))
    observe.tap(Phase.FFN_NORM, layer_idx, ht)
    f = feed_forward_cached(hn, layer, dtype, _tp(cfg))
    observe.tap(Phase.FFN, layer_idx, f)
    out = h + f
    observe.tap(Phase.RESIDUAL, layer_idx, out)
    return out


# =====================================================================
# KV cache and the cached forward
# =====================================================================

@dataclass
class KVCache:
    """Static-shape KV cache stacked over layers: (L, B, T, KV, D).

    dtype=torch.int8 stores per-(position, head) symmetrically quantized
    vectors with f32 scales (L, B, T, KV).
    """
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (cfg.n_layer, batch, max_seq, cfg.n_kv_head, cfg.head_dim)
        if dtype == torch.int8:
            sshape = shape[:-1]
            return cls(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       k_scale=torch.zeros(sshape, device=device),
                       v_scale=torch.zeros(sshape, device=device))
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    def layer(self, i: int) -> Tuple[Optional[torch.Tensor], ...]:
        return (self.k[i], self.v[i],
                None if self.k_scale is None else self.k_scale[i],
                None if self.v_scale is None else self.v_scale[i])


def layer_params(blocks: Params, i: int) -> Params:
    """Layer i's weights: views into the stacked tensors."""
    return {name: (w.layer(i) if isinstance(w, (Q80Tensor, Q4KTensor))
                   else w[i])
            for name, w in blocks.items()}


def forward_with_cache(params: Params, idx: torch.Tensor, cache: KVCache,
                       start_pos: Union[int, torch.Tensor], cfg: ModelConfig,
                       dtype=torch.bfloat16, attn_len: Optional[int] = None,
                       last_idx: Optional[int] = None,
                       rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                       lora: Optional[Params] = None, lora_scale=0.0
                       ) -> Tuple[torch.Tensor, KVCache]:
    """Forward S new tokens at absolute position start_pos using the cache.

    idx: (B, S) token ids.  Returns f32 logits (B, S, V) — or (B, 1, V)
    with `last_idx`, where the LM head runs for that position only — and
    the cache, updated in place.  `attn_len` bounds the rows the S > 1
    (prefill) attention reads; the caller guarantees start_pos + S <=
    attn_len.  S == 1 is ``forward_decode_batched`` with every row at
    start_pos (a host int, or an int32 tensor on the device, (1,) or
    (B,)), and reads rows <= start_pos whatever `attn_len` is.  `rope`
    passes precomputed (cos, sin) tables covering the cache.  `lora`: an
    adapter's stacked (L, in, r) / (L, r, out) tensors, scaled by
    `lora_scale` (a float or a 0-d tensor).
    """
    B, S = idx.shape
    dev = idx.device
    if S == 1:
        pos = (start_pos if isinstance(start_pos, torch.Tensor) else
               torch.full((1,), start_pos, dtype=torch.int32, device=dev))
        logits, _ = forward_decode_batched(params, idx[:, 0],
                                           cache, pos.expand(B), cfg, dtype,
                                           rope, lora, lora_scale)
        return logits[:, None], cache

    T = cache.max_seq
    Ta = attn_len if attn_len is not None else T
    h = embed_tokens(params, idx, dtype)
    if cfg.use_rope:
        cos_t, sin_t = (rope if rope is not None else
                        precompute_rope(cfg.head_dim, T, cfg.rope_theta, dev))
        cos, sin = cos_t[start_pos:start_pos + S], sin_t[start_pos:start_pos + S]
    else:
        cos = sin = None
        h = h + params["wpe"][start_pos:start_pos + S].to(dtype)
    observe.tap(Phase.EMBEDDING, -1, h)

    # query i (absolute start_pos+i) sees cache rows j <= start_pos+i
    # (causal) or j < start_pos+S (global)
    j = torch.arange(Ta, device=dev)[None, :]
    if cfg.is_causal:
        seen = j <= start_pos + torch.arange(S, device=dev)[:, None]
    else:
        seen = (j < start_pos + S).expand(S, Ta)
    mask = torch.where(seen, 0.0, -float("inf")).to(torch.float32)

    for i in range(cfg.n_layer):
        h = block(h, layer_params(params["blocks"], i), cfg, cos, sin, mask,
                  dtype, cache.layer(i), start_pos, None, attn_len,
                  layer_idx=i, **_adapter_kw(lora, i, lora_scale))
    return _final(h, params, cfg, dtype, last_idx), cache


def forward_decode_batched(params: Params, tok: torch.Tensor, cache: KVCache,
                           pos: torch.Tensor, cfg: ModelConfig,
                           dtype=torch.bfloat16,
                           rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                           = None, lora: Optional[Params] = None,
                           lora_scale=0.0,
                           lora_idx: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step with a position per batch row, every input on the
    device — the continuous-batching primitive, and the single stream's
    step at B = 1.  tok (B,) ids, pos (B,) int32 absolute positions ->
    f32 logits (B, V) and the cache, updated in place.

    The RoPE (or learned-position) rows are gathered by `pos`, each row's
    new k / v go to row pos[b] of its cache by one ``index_copy_``, and
    decode attention reads rows <= pos[b]: no host value enters the step,
    so it can be captured in a CUDA graph and replayed.  A position past
    the cache (a slot that is no longer decoding) is taken as the last
    row, where the JAX gathers clamp too; its output is garbage the
    caller ignores, as there.

    `lora` as in ``forward_with_cache``; or, with `lora_idx` (B,) on the
    device, a stack of adapters (L, A, in, r) / (L, A, r, out) with their
    scales (A,), row b decoding with adapter lora_idx[b] (``_lora_delta``).
    """
    B = tok.shape[0]
    T = cache.max_seq
    p = pos.clamp(max=T - 1)
    pl = p.long()
    h = embed_tokens(params, tok[:, None], dtype)          # (B, 1, E)
    if cfg.use_rope:
        cos_t, sin_t = (rope if rope is not None else precompute_rope(
            cfg.head_dim, T, cfg.rope_theta, tok.device))
        cos = cos_t.index_select(0, pl)[:, None, None, :]    # (B, 1, 1, D/2)
        sin = sin_t.index_select(0, pl)[:, None, None, :]
    else:
        cos = sin = None
        wpe = params["wpe"]
        h = h + wpe.index_select(0, pl.clamp(max=wpe.shape[0] - 1)
                                 )[:, None, :].to(dtype)
    observe.tap(Phase.EMBEDDING, -1, h)
    rows = torch.arange(B, device=tok.device) * T + pl     # into (B * T, ...)
    if lora_idx is not None:        # each row's scale, once for every layer
        lora_scale = lora_scale[lora_idx]
    for i in range(cfg.n_layer):
        h = block(h, layer_params(params["blocks"], i), cfg, cos, sin, None,
                  dtype, cache.layer(i), rows, p, layer_idx=i,
                  **_adapter_kw(lora, i, lora_scale, lora_idx))
    return _final(h, params, cfg, dtype)[:, 0], cache


def forward_spec_batched(params: Params, toks: torch.Tensor, cache: KVCache,
                         pos: torch.Tensor, cfg: ModelConfig,
                         dtype=torch.bfloat16, attn_len: Optional[int] = None,
                         rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                         = None, first_row_kernel: bool = False,
                         lora: Optional[Params] = None, lora_scale=0.0,
                         lora_idx: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, KVCache]:
    """S tokens per batch row at positions held on the device — the
    speculative verify round, batched over slots or for one stream at
    B = 1.  toks (B, S) ids, pos (B,) int32: row b runs its tokens at
    positions [pos[b], pos[b] + S), attending its cache prefix causally.
    -> f32 logits (B, S, V) (the head runs over every row) and the cache,
    updated in place.

    Built as ``forward_decode_batched`` is: the RoPE (or learned-position)
    rows are gathered by position, the S new rows of slot b go to rows
    b * T + pos[b] + j of the cache by one ``index_copy_``, the mask is made
    on the device from the positions, and the einsum attention reads the
    first `attn_len` rows (the caller guarantees max(pos) + S <= attn_len).
    A position past the cache (a slot that is not decoding) is taken as the
    last row, as in ``forward_decode_batched``: its output is garbage the
    caller ignores.  The decode-attention kernel takes S == 1 only, as the
    JAX package's does; with `first_row_kernel` it computes row 0 of every
    slot (a decode step's problem), so that row 0 has the bits of
    ``forward_decode_batched``'s logits for the same cache, which a
    sampled slot of a batched round needs to draw as the plain step draws.
    The adapter arguments are ``forward_decode_batched``'s.
    """
    B, S = toks.shape
    T = cache.max_seq
    Ta = attn_len if attn_len is not None else T
    dev = toks.device
    posm = pos.long()[:, None] + torch.arange(S, device=dev)[None, :]
    pw = posm.clamp(max=T - 1)                                # (B, S)
    h = embed_tokens(params, toks, dtype)                     # (B, S, E)
    if cfg.use_rope:
        cos_t, sin_t = (rope if rope is not None else precompute_rope(
            cfg.head_dim, T, cfg.rope_theta, dev))
        pr = pw.clamp(max=cos_t.shape[0] - 1).reshape(-1)
        cos = cos_t.index_select(0, pr).reshape(B, S, 1, -1)   # (B, S, 1, D/2)
        sin = sin_t.index_select(0, pr).reshape(B, S, 1, -1)
    else:
        cos = sin = None
        wpe = params["wpe"]
        h = h + wpe.index_select(0, pw.clamp(max=wpe.shape[0] - 1).reshape(-1)
                                 ).reshape(B, S, -1).to(dtype)
    j = torch.arange(Ta, device=dev)[None, None, :]
    mask = torch.where(j <= posm[:, :, None], 0.0, -float("inf")
                       ).to(torch.float32)[:, None, None]    # (B,1,1,S,Ta)
    rows = (torch.arange(B, device=dev)[:, None] * T + pw).reshape(-1)
    pos_t = pw[:, 0].to(torch.int32) if first_row_kernel else None
    if lora_idx is not None:        # each row's scale, once for every layer
        lora_scale = lora_scale[lora_idx]
    for i in range(cfg.n_layer):
        h = block(h, layer_params(params["blocks"], i), cfg, cos, sin, mask,
                  dtype, cache.layer(i), rows, pos_t, attn_len, layer_idx=i,
                  **_adapter_kw(lora, i, lora_scale, lora_idx))
    return _final(h, params, cfg, dtype), cache


# =====================================================================
# Full-sequence forward and loss — the training path
# =====================================================================

def block_nocache(x: torch.Tensor, layer: Params, cfg: ModelConfig, cos, sin,
                  dtype, remat_ffn: bool = False,
                  lora: Optional[Params] = None, lora_scale=0.0
                  ) -> torch.Tensor:
    """Pre-norm residual block of the no-cache forward (`lora`: the
    layer's adapter).  Under tensor parallelism (``_tp``) the normed
    activations enter the column-parallel products through ``tp.enter``
    (their gradients summed over the model group) and the row-parallel
    products leave summed (``_row``)."""
    tp = _tp(cfg)
    enter = tp.enter if tp is not None else (lambda t: t)
    xn = enter(rms_norm(x, layer["attn_norm"], cfg.norm_eps))
    h = x + attention_nocache(xn, layer, cfg, cos, sin, dtype, lora,
                              lora_scale)
    hn = enter(rms_norm(h, layer["ffn_norm"], cfg.norm_eps))
    return h + feed_forward(hn, layer, dtype, remat_ffn, tp)


def unstack_layers(blocks: Params) -> List[Params]:
    """Every layer's dense weights as views of the stacked tensors.  One
    ``unbind`` per tensor, so its backward is one ``stack`` of the layers'
    gradients (a ``w[i]`` per layer would build a full-size zero tensor
    for each).  Quantized weights (a loaded file's, which take no
    gradient) give each layer's view by ``layer``."""
    def layers(w):
        if isinstance(w, (Q80Tensor, Q4KTensor)):
            lead = w.q if isinstance(w, Q80Tensor) else w.packed
            return [w.layer(i) for i in range(lead.shape[0])]
        return w.unbind(0)
    per_name = {name: layers(w) for name, w in blocks.items()}
    n_layer = len(next(iter(per_name.values())))
    return [{name: ws[i] for name, ws in per_name.items()}
            for i in range(n_layer)]


# The remat policies of the training forward, keyed by TrainConfig's
# remat_policy (the JAX package's REMAT_POLICIES).  Under "full" (or True,
# or a name the table does not know) each block keeps only its input;
# "ffn" keeps everything but the 2F-wide w1 / w3 outputs; the two others
# are selective checkpoints of the whole block, whose policy sees every
# dispatcher operator the block runs:
#   "dots"   keeps the output of every product without batch dimensions
#            (the JAX dots_with_no_batch_dims_saveable): aten.mm / addmm,
#            which the projections, the w1 / w3 / w2 products and the LoRA
#            branch lower to; the attention (batched einsums, the flash
#            operator) is run again in backward, as JAX runs its Pallas
#            call again;
#   "heads"  keeps only the attention context (JAX's 'attn_heads'): the
#            flash operator's out and lse, so the backward reads them and
#            K4's forward runs once a layer.  The non-causal einsum path
#            has no such operator and is recomputed as under "full".
_SAVED_OPS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
    "heads": (torch.ops.nano_tpu_torch.flash_attn_fwd.default,),
}


def _remat_mode(remat: Union[bool, str, None]) -> Optional[str]:
    """False -> None; "ffn", "dots", "heads" -> themselves; True, "full"
    and a name the table does not know -> "full", as in the JAX package."""
    if not remat:
        return None
    return remat if remat in ("ffn", "dots", "heads") else "full"


def _saving(ops):
    """A selective-checkpoint context factory that keeps the outputs of
    `ops` and recomputes everything else."""
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return lambda: create_selective_checkpoint_contexts(policy)


def positions(cfg: ModelConfig, params: Params, S: int, device, dtype,
              embed: bool = True):
    """The position tables of a training forward over S local positions:
    (cos, sin) at them, or (None, None) and the ``wpe`` rows for a model
    without RoPE (None where `embed` is false).  Under sequence
    parallelism (``_sp``) the positions start at this rank's offset."""
    sp = _sp(cfg)
    lo = 0 if sp is None else sp.offset(S)
    if cfg.use_rope:
        cos, sin = precompute_rope(cfg.head_dim, lo + S, cfg.rope_theta,
                                   device)
        return cos[lo:], sin[lo:], None
    wpe = params["wpe"][lo:lo + S].to(dtype) if embed else None
    return None, None, wpe


def run_blocks(h: torch.Tensor, blocks: Params, cfg: ModelConfig, cos, sin,
               dtype, remat: Union[bool, str] = False,
               lora: Optional[Params] = None, lora_scale=0.0
               ) -> torch.Tensor:
    """The residual stream h through the stacked layers `blocks` (all of
    the model's, or a pipeline stage's), under `remat` as
    ``forward_hidden`` describes it."""
    mode = _remat_mode(remat)
    layers = unstack_layers(blocks)
    loras = ([None] * len(layers) if lora is None else unstack_layers(lora))
    kw = (dict(context_fn=_saving(_SAVED_OPS[mode])) if mode in _SAVED_OPS
          else {})
    for layer, ll in zip(layers, loras):
        if mode in ("full", "dots", "heads"):
            h = checkpoint(block_nocache, h, layer, cfg, cos, sin, dtype,
                           False, ll, lora_scale, use_reentrant=False,
                           preserve_rng_state=False, **kw)
        else:
            h = block_nocache(h, layer, cfg, cos, sin, dtype, mode == "ffn",
                              ll, lora_scale)
    return h


def forward_hidden(params: Params, idx: torch.Tensor, cfg: ModelConfig,
                   dtype=torch.bfloat16, remat: Union[bool, str] = False,
                   lora: Optional[Params] = None, lora_scale=0.0
                   ) -> torch.Tensor:
    """Full-sequence forward -> final-norm hidden states (B, S, E).

    A Python loop over the layers' views of the stacked parameters.
    `remat` (``_remat_mode``): "full" recomputes each block in backward
    (``torch.utils.checkpoint``; only the residual stream survives);
    "ffn" keeps everything but the 2F-wide w1 / w3 outputs, which
    backward computes again; "dots" and "heads" recompute the block but
    keep what their policy names (``_SAVED_OPS``).  `lora`: an adapter's
    stacked tensors (L, ...) scaled by `lora_scale`; the gradient reaches
    them as it does the parameters.
    """
    cos, sin, wpe = positions(cfg, params, idx.shape[1], idx.device, dtype)
    h = embed_tokens(params, idx, dtype)
    if wpe is not None:
        h = h + wpe
    h = run_blocks(h, params["blocks"], cfg, cos, sin, dtype, remat, lora,
                   lora_scale)
    return rms_norm(h, params["norm"], cfg.norm_eps)


def forward(params: Params, idx: torch.Tensor, cfg: ModelConfig,
            dtype=torch.bfloat16, remat: Union[bool, str] = False,
            lora: Optional[Params] = None, lora_scale=0.0) -> torch.Tensor:
    """Full-sequence forward -> f32 logits (B, S, V)."""
    return compute_logits(forward_hidden(params, idx, cfg, dtype, remat,
                                         lora, lora_scale), params, dtype)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token -log softmax(logits)[target], in f32."""
    V = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, V),
                           targets.reshape(-1), reduction="none"
                           ).reshape(targets.shape)


def loss_fn(params: Params, idx: torch.Tensor, targets: torch.Tensor,
            loss_mask: Optional[torch.Tensor], cfg: ModelConfig,
            dtype=torch.bfloat16, remat: Union[bool, str] = False,
            ce_chunk: int = 0, lora: Optional[Params] = None,
            lora_scale=0.0) -> torch.Tensor:
    """Per-token CE, optionally masked and normalized by the mask sum
    (the mean when the mask is None); `lora` as in ``forward_hidden``.

    ``ce_chunk`` > 0 computes the LM head and the cross-entropy in token
    chunks of that size, each chunk's logits computed again in backward,
    so the full (B*S, V) f32 logits never exist; values match the one-shot
    loss up to the f32 summation order.
    """
    if ce_chunk and ce_chunk > 0:
        h = forward_hidden(params, idx, cfg, dtype, remat, lora, lora_scale)
        return _chunked_ce(h, params, targets, loss_mask, dtype, ce_chunk)
    nll = _nll(forward(params, idx, cfg, dtype, remat, lora, lora_scale),
               targets)
    if loss_mask is None:
        return nll.mean()
    m = loss_mask.float()
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def loss_sums(params: Params, idx: torch.Tensor, targets: torch.Tensor,
              loss_mask: Optional[torch.Tensor], cfg: ModelConfig,
              dtype=torch.bfloat16, remat: Union[bool, str] = False,
              ce_chunk: int = 0, lora: Optional[Params] = None,
              lora_scale=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked CE as sums, (sum of nll * mask, sum of mask) (the mask
    all ones when None), so that ranks holding parts of a batch add theirs
    and divide once: ``loss_fn`` of the whole batch."""
    return ce_sums(forward_hidden(params, idx, cfg, dtype, remat, lora,
                                  lora_scale),
                   params, targets, loss_mask, dtype, ce_chunk)


def ce_sums(h: torch.Tensor, params: Params, targets: torch.Tensor,
            loss_mask: Optional[torch.Tensor], dtype, ce_chunk: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LM head and the masked CE of final-norm hidden states h as
    (sum of nll * mask, sum of mask), in token chunks where ce_chunk > 0
    (``loss_sums``)."""
    if ce_chunk and ce_chunk > 0:
        return _chunked_ce_sums(h, params, targets, loss_mask, dtype,
                                ce_chunk)
    nll = _nll(compute_logits(h, params, dtype), targets)
    m = (torch.ones_like(nll) if loss_mask is None else loss_mask.float())
    return (nll * m).sum(), m.sum()


def _chunked_ce_sums(h: torch.Tensor, params: Params, targets: torch.Tensor,
                     loss_mask: Optional[torch.Tensor], dtype, ce_chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LM head + CE over token chunks -> (nll_sum, mask_sum).  The
    last chunk is simply shorter (the JAX scan pads it with zero-weight
    rows: the same sum)."""
    B, S, E = h.shape
    N = B * S
    m = (torch.ones(N, dtype=torch.float32, device=h.device)
         if loss_mask is None else loss_mask.reshape(N).float())
    hf, tf = h.reshape(N, E), targets.reshape(N)

    def body(h_c, t_c, m_c):
        return (_nll(compute_logits(h_c, params, dtype), t_c) * m_c).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, N, ce_chunk):
        hi = min(lo + ce_chunk, N)
        total = total + checkpoint(body, hf[lo:hi], tf[lo:hi], m[lo:hi],
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total, m.sum()


def _chunked_ce(h: torch.Tensor, params: Params, targets: torch.Tensor,
                loss_mask: Optional[torch.Tensor], dtype, ce_chunk: int
                ) -> torch.Tensor:
    total, msum = _chunked_ce_sums(h, params, targets, loss_mask, dtype,
                                   ce_chunk)
    if loss_mask is None:
        return total / (h.shape[0] * h.shape[1])
    return total / msum.clamp(min=1.0)


# =====================================================================
# Initialization
# =====================================================================

def init_params(rng: torch.Generator, cfg: ModelConfig,
                param_dtype=torch.float32, device=None) -> Params:
    """GPT-2-style init: N(0, 0.02); w3 / wo scaled by 1/sqrt(2L); ones
    for norms, zeros for biases.  Drawn on the CPU from `rng` (a
    ``torch.Generator``; its numbers are not ``jax.random``'s) and moved
    to `device`, so a seed gives the same model on every device.  The
    leaves require grad."""
    L, E, V = cfg.n_layer, cfg.n_embd, cfg.vocab_size
    H, KV, D, Fh = cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.n_hidden
    std = 0.02
    res_std = 0.02 / math.sqrt(2 * L)

    def leaf(t):
        return t.to(device=device, dtype=param_dtype).requires_grad_(True)

    def normal(shape, s):
        return leaf(torch.randn(shape, generator=rng, dtype=torch.float32) * s)

    ones = lambda *shape: leaf(torch.ones(shape))
    zeros = lambda *shape: leaf(torch.zeros(shape))
    params: Params = {
        "tok_embeddings": normal((V, E), std),
        "norm": ones(E),
        "blocks": {
            "attn_norm": ones(L, E),
            "ffn_norm": ones(L, E),
            "wq": normal((L, E, H * D), std),
            "wk": normal((L, E, KV * D), std),
            "wv": normal((L, E, KV * D), std),
            "wo": normal((L, H * D, E), res_std),
            "w1": normal((L, E, Fh), std),
            "w2": normal((L, Fh, E), std),
            "w3": normal((L, E, Fh), res_std),
        },
    }
    if not cfg.use_rope:
        params["wpe"] = normal((cfg.block_size, E), std)
    if not cfg.tie_embeddings:
        params["output"] = normal((E, V), std)
    if cfg.qkv_bias:
        params["blocks"]["bq"] = zeros(L, H * D)
        params["blocks"]["bk"] = zeros(L, KV * D)
        params["blocks"]["bv"] = zeros(L, KV * D)
    if cfg.use_qk_norm:
        params["blocks"]["q_norm"] = ones(L, D)
        params["blocks"]["k_norm"] = ones(L, D)
    return params


def merge_lora(params: Params, lora: Params, scale: float) -> Params:
    """Fold a LoRA adapter into the base weights: W' = W + scale * (A @ B)
    for wq, wk, wv and wo of every layer, in f32, then in each weight's
    own dtype.  Merged params generate as base + adapter does (the delta
    applied once instead of per step) and export or quantize like any
    base.  Returns a new dict; the inputs are unchanged."""
    merged = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in params.items()}
    blocks = merged["blocks"]
    for name in ("wq", "wk", "wv", "wo"):
        w = torch.as_tensor(blocks[name])
        a = torch.as_tensor(lora[f"{name}_a"]).float()
        b = torch.as_tensor(lora[f"{name}_b"]).float()
        delta = torch.matmul(a.to(w.device), b.to(w.device)) * scale
        blocks[name] = (w.float() + delta).to(w.dtype)
    return merged


def init_lora_params(rng: torch.Generator, cfg: ModelConfig, rank: int,
                     param_dtype=torch.float32, device=None) -> Params:
    """LoRA A / B for wq, wk, wv and wo (reference: model.py:145-156):
    A uniform in +-1/sqrt(shape[1]) of its stacked (L, in, r) shape, as the
    JAX package draws it, B zero.  Drawn on the CPU from `rng` (its numbers
    are not ``jax.random``'s) and moved to `device`."""
    L, E, H, KV, D = (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_kv_head,
                      cfg.head_dim)

    def kaiming(shape):
        bound = 1.0 / math.sqrt(shape[1])
        u = torch.rand(shape, generator=rng, dtype=torch.float32)
        return (u * (2 * bound) - bound).to(device=device, dtype=param_dtype)

    zeros = lambda *shape: torch.zeros(shape, dtype=param_dtype,
                                       device=device)
    return {
        "wq_a": kaiming((L, E, rank)), "wq_b": zeros(L, rank, H * D),
        "wk_a": kaiming((L, E, rank)), "wk_b": zeros(L, rank, KV * D),
        "wv_a": kaiming((L, E, rank)), "wv_b": zeros(L, rank, KV * D),
        "wo_a": kaiming((L, H * D, rank)), "wo_b": zeros(L, rank, E),
    }


def param_leaves(params: Params, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested params dict, keys sorted within each
    dict (the order ``jax.tree.leaves`` gives)."""
    out: List[Tuple[str, Any]] = []
    for name in sorted(params):
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(params[name], dict):
            out.extend(param_leaves(params[name], path))
        else:
            out.append((path, params[name]))
    return out


def map_leaves(fn, tree: Any) -> Any:
    """The nested dict `tree` with fn applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def map_leaves_with_path(fn, tree: Any, prefix: str = "") -> Any:
    """The nested dict `tree` with fn(path, leaf) applied to every leaf,
    paths as ``param_leaves`` gives them."""
    if isinstance(tree, dict):
        return {k: map_leaves_with_path(fn, v, f"{prefix}/{k}" if prefix
                                        else k) for k, v in tree.items()}
    return fn(prefix, tree)


def count_params(params: Params, cfg: ModelConfig,
                 non_embedding: bool = True) -> int:
    """Total parameter count (learned positions left out, as the reference
    counts)."""
    n = sum(int(p.numel()) for _, p in param_leaves(params))
    if non_embedding and not cfg.use_rope and "wpe" in params:
        n -= int(params["wpe"].numel())
    return n


def estimate_flops_per_token(cfg: ModelConfig, n_params: int) -> float:
    """PaLM appendix-B formula 6N + 12*L*H*Q*T."""
    return (6 * n_params
            + 12 * cfg.n_layer * cfg.n_head * cfg.head_dim * cfg.block_size)
