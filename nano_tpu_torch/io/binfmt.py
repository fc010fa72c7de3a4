"""``.bin`` model and LoRA reader and writer — the port's copy of
``nano_tpu/io/binfmt.py``.

Format (bit-compatible with the reference; spec: reference
README.md:239-255, parser infer/infer.c:220-320):

    [0..255]  header: magic "BD4SURLM", version, model_type (0=Nano,
              2=Qwen2, 3=Qwen3, 10=LoRA), 9 x i32 config, quant_type
              (0x00 F32 / 0x80 Q80 / 0x42 Q4K), group_size; rope_theta
              extension at offset 68; zero-padded to 256 B
    [256..]   embedded tokenizer (trie field, or BPE field for Qwen)
    [...]     attn_norm[L], ffn_norm[L], final_norm (f32), then tok_emb,
              wq[L], wk[L], wv[L], wo[L], w1[L], w2[L], w3[L] (f32 or
              per-group int8 + f32 scales), arch extras, RoPE tables,
              classifier if untied.  Q4K files hold the eight matrices
              as self-describing Q4K tensor frames (ops/q4k.py), then the
              extras, and RoPE tables for Nano only.

``read_model`` is host-side numpy with the JAX package's stacked (L, in,
out) layout, so its output compares array for array.  ``write_model``
takes that layout (numpy arrays or tensors of any device and float type)
and writes the JAX writer's bytes; ``repack`` re-quantizes a file.
``quantized_device_params`` builds the device tensors: stacked
``Q80Tensor``s for Q80 files, stacked packed ``Q4KTensor``s for Q4K files
with the tied head requantized to Q80 (``q4k_head_requant``).
``write_lora`` / ``read_lora`` are the LoRA files (model type 10): the
256-B header and f32 A / B matrices, in the stacked (L, in, out) layout.
"""

from __future__ import annotations

import io
import math
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.ops import q4k
from nano_tpu_torch.ops.q4k import Q4KTensor
from nano_tpu_torch.ops.qmatmul import MIN_W8A8_GS, Q80Tensor

MAGIC_0 = 0x42443453  # "BD4S" (LE)
MAGIC_1 = 0x55524C4D  # "URLM"
VERSION = (2026, 1)

MODEL_TYPE_NANO = 0
MODEL_TYPE_QWEN2 = 2
MODEL_TYPE_QWEN3 = 3
MODEL_TYPE_LORA = 10

QUANT_F32 = 0x00
QUANT_Q80 = 0x80
QUANT_Q4K = 0x42

HEADER_BYTES = 256


def quantize_q80(w: np.ndarray, group_size: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-group int8 (reference: export.py:40-63) -> (int8
    values, f32 scales per group); rounds half to even (np.rint), as the
    JAX package's writer does."""
    flat = np.ascontiguousarray(w, dtype=np.float32).reshape(-1)
    if flat.size % group_size:
        raise ValueError(f"{flat.size} values do not split into groups of "
                         f"{group_size}")
    groups = flat.reshape(-1, group_size)
    scale = np.max(np.abs(groups), axis=1) / 127.0
    safe = np.where(scale == 0.0, 1.0, scale)
    q = np.rint(groups / safe[:, None]).astype(np.int8)
    return q.reshape(-1), scale.astype(np.float32)


def dequantize_q80(q: np.ndarray, scale: np.ndarray, group_size: int
                   ) -> np.ndarray:
    g = q.astype(np.float32).reshape(-1, group_size)
    return (g * scale.reshape(-1, 1)).reshape(-1)


def pick_group_size(n_embd: int, group_size: int) -> int:
    """Halve the group size until it divides n_embd (reference:
    export.py:418-420)."""
    while n_embd % group_size != 0:
        group_size //= 2
    return group_size


def _q80_group_size(cfg: ModelConfig, group_size: int) -> int:
    """The group size must divide every contraction dim (E, H*D, F), so
    that no group straddles two rows: halve it until it divides their
    gcd."""
    g = math.gcd(math.gcd(cfg.n_embd, cfg.n_hidden),
                 cfg.n_head * cfg.head_dim)
    return pick_group_size(g, group_size)


# =====================================================================
# tokenizer field (BNF at reference export.py:72-114)
# =====================================================================

def serialize_tokenizer_field(tokenizer_config: dict) -> bytes:
    itos: List[str] = tokenizer_config["itos"]
    specials = set(tokenizer_config["special_tokens"])
    buf = io.BytesIO()
    total = 8 + sum((len(t) + 2) * 4 for t in itos)
    buf.write(struct.pack("<II", total, len(itos)))
    for i, t in enumerate(itos):
        buf.write(struct.pack("<BBBB", len(t), 1 if t in specials else 0,
                              255, 255))
        buf.write(struct.pack("<I", i))
        for ch in t:
            buf.write(struct.pack("<I", ord(ch)))
    return buf.getvalue()


def parse_tokenizer_field(data: bytes, offset: int) -> Tuple[dict, int]:
    """-> (tokenizer config dict, next offset)."""
    total, vocab_size = struct.unpack_from("<II", data, offset)
    pos = offset + 8
    itos: List[Optional[str]] = [None] * vocab_size
    special_flags = [False] * vocab_size
    for _ in range(vocab_size):
        length, is_special, _, _ = struct.unpack_from("<BBBB", data, pos)
        (tid,) = struct.unpack_from("<I", data, pos + 4)
        chars = struct.unpack_from(f"<{length}I", data, pos + 8)
        itos[tid] = "".join(chr(c) for c in chars)
        special_flags[tid] = bool(is_special)
        pos += 8 + 4 * length
    if pos - offset != total:
        raise ValueError("tokenizer field length mismatch")
    itos_final = [t if t is not None else "" for t in itos]
    return {
        "vocab_size": vocab_size,
        "itos": itos_final,
        "stoi": {t: i for i, t in enumerate(itos_final)},
        "special_tokens": {t: i for i, t in enumerate(itos_final)
                           if special_flags[i]},
    }, pos


# =====================================================================
# header
# =====================================================================

def _pack_header(model_type: int, cfg: ModelConfig, shared_classifier: bool,
                 quant_type: int, group_size: int,
                 rope_theta: float = 0.0) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack("<II", MAGIC_0, MAGIC_1))
    buf.write(struct.pack("<ii", *VERSION))
    buf.write(struct.pack("<ii", model_type, 36))
    buf.write(struct.pack(
        "<9i", cfg.block_size, cfg.vocab_size, cfg.n_layer, cfg.n_embd,
        cfg.n_head, cfg.n_kv_head, cfg.n_hidden, int(shared_classifier),
        cfg.head_dim))
    buf.write(struct.pack("<i", quant_type))
    if quant_type != QUANT_F32 or rope_theta:
        buf.write(struct.pack("<i", group_size))
    # extension in the zero-padded region (the C engine ignores it):
    # rope_theta at offset 68, written only for a non-default theta
    if rope_theta:
        buf.write(struct.pack("<f", float(rope_theta)))
    raw = buf.getvalue()
    return raw + b"\0" * (HEADER_BYTES - len(raw))


@dataclass
class BinHeader:
    model_type: int
    major: int
    minor: int
    block_size: int
    vocab_size: int
    n_layer: int
    n_embd: int
    n_head: int
    n_kv_head: int
    n_hidden: int
    shared_classifier: bool
    head_dim: int
    quant_type: int
    group_size: int
    rope_theta: float = 0.0    # header extension; 0 in reference files

    def to_model_config(self) -> ModelConfig:
        kw: Dict[str, Any] = dict(
            block_size=self.block_size, vocab_size=self.vocab_size,
            n_layer=self.n_layer, n_embd=self.n_embd, n_head=self.n_head,
            n_kv_head=self.n_kv_head, n_hidden=self.n_hidden,
            head_dim=self.head_dim,
            tie_embeddings=self.shared_classifier)
        # norm_eps is not in the header; Qwen uses 1e-6 (HF config)
        if self.model_type == MODEL_TYPE_QWEN2:
            kw.update(qkv_bias=True, rope_theta=1e6, norm_eps=1e-6)
        elif self.model_type == MODEL_TYPE_QWEN3:
            kw.update(use_qk_norm=True, rope_theta=1e6, rope_style="half",
                      norm_eps=1e-6)
        if self.rope_theta > 0:
            kw.update(rope_theta=float(self.rope_theta))
        return ModelConfig(**kw)


def parse_header(data: bytes) -> BinHeader:
    m0, m1 = struct.unpack_from("<II", data, 0)
    if (m0, m1) != (MAGIC_0, MAGIC_1):
        raise ValueError("not a BD4SURLM .bin file")
    major, minor = struct.unpack_from("<ii", data, 8)
    model_type, _cfg_len = struct.unpack_from("<ii", data, 16)
    fields = struct.unpack_from("<9i", data, 24)
    quant_type, group_size = struct.unpack_from("<ii", data, 60)
    (rope_theta,) = struct.unpack_from("<f", data, 68)
    if not (rope_theta > 0) or rope_theta != rope_theta:   # 0/garbage
        rope_theta = 0.0
    return BinHeader(
        model_type=model_type, major=major, minor=minor,
        block_size=fields[0], vocab_size=fields[1], n_layer=fields[2],
        n_embd=fields[3], n_head=fields[4], n_kv_head=fields[5],
        n_hidden=fields[6], shared_classifier=bool(fields[7]),
        head_dim=fields[8], quant_type=quant_type, group_size=group_size,
        rope_theta=float(rope_theta))


# =====================================================================
# weight import
# =====================================================================

class _Reader:
    def __init__(self, data: bytes, offset: int):
        self.data = data
        self.pos = offset

    def f32(self, count: int) -> np.ndarray:
        out = np.frombuffer(self.data, dtype="<f4", count=count,
                            offset=self.pos)
        self.pos += 4 * count
        return np.asarray(out)

    def i8(self, count: int) -> np.ndarray:
        out = np.frombuffer(self.data, dtype=np.int8, count=count,
                            offset=self.pos)
        self.pos += count
        return np.asarray(out)


@dataclass
class QuantTensor:
    """A per-group int8 tensor as stored in the file."""
    q: np.ndarray          # int8, logical shape
    scale: np.ndarray      # f32, (numel // group_size,)
    group_size: int

    def dequantize(self) -> np.ndarray:
        return dequantize_q80(self.q.reshape(-1), self.scale,
                              self.group_size).reshape(self.q.shape)


@dataclass
class Q4KFrame:
    """One self-describing Q4K tensor frame as stored in the file."""
    blocks: np.ndarray          # (nb, 160) uint8
    shape: Tuple[int, ...]

    def dequantize(self) -> np.ndarray:
        rows = int(np.prod(self.shape[:-1])) if len(self.shape) > 1 else 1
        return q4k.dequantize_lines_np(self.blocks, rows,
                                       self.shape[-1]).reshape(self.shape)


@dataclass
class BinModel:
    header: BinHeader
    config: ModelConfig
    tokenizer_config: dict
    params: Dict[str, Any]                     # f32 arrays (JAX layout)
    qparams: Optional[Dict[str, Any]] = None   # QuantTensors / Q4KFrames
    rope_cos: Optional[np.ndarray] = None
    rope_sin: Optional[np.ndarray] = None


def _read_tensor(r: _Reader, shape: Tuple[int, ...], quant_type: int,
                 group_size: int, dense: bool = True):
    numel = int(np.prod(shape))
    if quant_type == QUANT_F32:
        return r.f32(numel).reshape(shape), None
    q = r.i8(numel).reshape(shape)
    s = r.f32(numel // group_size)
    qt = QuantTensor(q=q, scale=s, group_size=group_size)
    if not dense:
        return None, qt
    return qt.dequantize().astype(np.float32), qt


def _rope_tables(cfg: ModelConfig) -> Tuple[np.ndarray, np.ndarray]:
    dim = cfg.head_dim
    freqs = 1.0 / (cfg.rope_theta ** (
        np.arange(0, dim, 2, dtype=np.float32)[: dim // 2] / dim))
    t = np.arange(cfg.block_size, dtype=np.float32)
    angles = np.outer(t, freqs).astype(np.float32)
    return np.cos(angles), np.sin(angles)


# =====================================================================
# weight export (the writer half)
# =====================================================================

def _f32(x) -> np.ndarray:
    """A numpy array or a tensor (any device, any float type) -> f32
    numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _file_order_tensors(params: Dict[str, Any], cfg: ModelConfig,
                        include_quantizable: bool = True
                        ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """-> (f32 norms, the quantizable matrices in file order).

    The checkpoint layout is stacked (L, in, out); the file holds each
    layer's (out, in) rows.  include_quantizable=False skips the large
    transposed copies."""
    b = params["blocks"]
    L = cfg.n_layer

    def per_layer_T(name):
        arr = _f32(b[name])
        return [np.ascontiguousarray(arr[i].T) for i in range(L)]

    attn_norm, ffn_norm = _f32(b["attn_norm"]), _f32(b["ffn_norm"])
    norms = ([attn_norm[i] for i in range(L)]
             + [ffn_norm[i] for i in range(L)] + [_f32(params["norm"])])
    if not include_quantizable:
        return norms, []
    quantizable = [_f32(params["tok_embeddings"])]
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        quantizable += per_layer_T(name)
    return norms, quantizable


def write_model(path: str, params: Dict[str, Any], cfg: ModelConfig,
                tokenizer_config, quant: str = "f32",
                group_size: int = 128, model_type: int = MODEL_TYPE_NANO,
                rope_tables: Optional[Tuple[np.ndarray, np.ndarray]] = None
                ) -> None:
    """Export params in the checkpoint layout (the JAX pytree names,
    stacked (L, in, out), numpy arrays or tensors) to a .bin: quant 'f32',
    'q80' (group size halved until it divides every contraction dim) or
    'q4k' (eight stacked Q4K frames; Nano and Qwen3 with a tied head).

    tokenizer_config: a trie tokenizer's config dict, or a BpeTokenizer.
    rope_tables: (cos, sin) to embed verbatim (the tables read from a file
    keep a re-export byte-identical).  The served layout (fused wqkv /
    w13, quantized leaves) is not taken."""
    shared = "output" not in params
    # the header's theta extension only for non-default thetas, so that
    # default-theta files stay byte-identical with the reference exporter
    theta_ext = (0.0 if cfg.rope_theta in (10000.0, 1e6)
                 else cfg.rope_theta)
    norms, _ = _file_order_tensors(params, cfg, include_quantizable=False)

    def build_quantizable():
        _, quantizable_ = _file_order_tensors(params, cfg)
        if not shared:
            quantizable_.append(np.ascontiguousarray(
                _f32(params["output"]).T))
        return quantizable_

    # arch extras, f32 after the matrices (reference: infer/infer.c:175-183)
    extras: List[np.ndarray] = []
    b = params["blocks"]
    names = {MODEL_TYPE_QWEN2: ("bq", "bk", "bv"),
             MODEL_TYPE_QWEN3: ("q_norm", "k_norm")}.get(model_type, ())
    for name in names:
        arr = _f32(b[name])
        extras += [arr[i] for i in range(cfg.n_layer)]

    cos, sin = rope_tables if rope_tables is not None else _rope_tables(cfg)

    if isinstance(tokenizer_config, dict):
        tok_field = serialize_tokenizer_field(tokenizer_config)
    else:                                          # BpeTokenizer
        tok_field = tokenizer_config.serialize_field()

    def f32_bytes(w) -> bytes:
        return np.asarray(w).astype("<f4").tobytes()

    with open(path, "wb") as f:
        if quant in ("f32", "q80"):
            if quant == "f32":
                qtype, gs = QUANT_F32, 0
            else:
                qtype, gs = QUANT_Q80, _q80_group_size(cfg, group_size)
            f.write(_pack_header(model_type, cfg, shared, qtype, gs,
                                 theta_ext))
            f.write(tok_field)
            for w in norms:
                f.write(f32_bytes(w))
            quantizable = build_quantizable()
            classifier = None if shared else quantizable.pop()

            def write_matrix(w):
                if qtype == QUANT_F32:
                    f.write(f32_bytes(w))
                else:
                    q, s_ = quantize_q80(w, gs)
                    f.write(q.tobytes())
                    f.write(f32_bytes(s_))

            for w in quantizable:
                write_matrix(w)
            for w in extras:
                f.write(f32_bytes(w))
            f.write(f32_bytes(cos))
            f.write(f32_bytes(sin))
            if classifier is not None:
                write_matrix(classifier)
        elif quant == "q4k":
            # f32 norms, eight stacked Q4K frames (tok_emb 2-D; wq..w3 3-D
            # with a leading layer axis), the extras, RoPE tables for Nano
            # only (reference: infer/tools/export_q4k.c:28-224).  The
            # classifier is always the shared embedding, and the reference
            # repack drops Qwen2's qkv biases.
            if not shared:
                raise ValueError("Q4K requires a shared classifier")
            if model_type == MODEL_TYPE_QWEN2:
                raise ValueError("Q4K does not support Qwen2 (reference "
                                 "drops its qkv biases)")
            f.write(_pack_header(model_type, cfg, shared, QUANT_Q4K, 0,
                                 theta_ext))
            f.write(tok_field)
            for w in norms:
                f.write(f32_bytes(w))
            f.write(q4k.pack_tensor_frame(_f32(params["tok_embeddings"])))
            for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
                f.write(q4k.pack_tensor_frame(np.ascontiguousarray(
                    _f32(b[name]).transpose(0, 2, 1))))
            for w in extras:
                f.write(f32_bytes(w))
            if model_type == MODEL_TYPE_NANO:
                f.write(f32_bytes(cos))
                f.write(f32_bytes(sin))
        else:
            raise ValueError(f"unsupported quant: {quant}")


def repack(in_path: str, out_path: str, quant: str = "q4k",
           group_size: int = 128) -> None:
    """Re-quantize a .bin into another quant type; the RoPE tables are
    copied verbatim."""
    bm = read_model(in_path)
    tok = bm.tokenizer_config
    if isinstance(tok, dict) and tok.get("type") == "bpe":
        tok = tok["tokenizer"]
    write_model(out_path, bm.params, bm.config, tok, quant=quant,
                group_size=group_size, model_type=bm.header.model_type,
                rope_tables=(bm.rope_cos, bm.rope_sin))


def read_model(path: str, dense: bool = True) -> BinModel:
    """Parse a Nano/Qwen .bin (F32, Q80 or Q4K) into the stacked-params
    layout.

    dense=False skips the f32 dequantized copies of quantized matmul
    weights (params then carries only norms/extras); the quantized load
    consumes only qparams.  F32 files ignore the flag.
    """
    with open(path, "rb") as f:
        data = f.read()
    hdr = parse_header(data)
    if hdr.model_type == MODEL_TYPE_LORA:
        raise ValueError("LoRA files are not model files: use read_lora")
    if hdr.quant_type not in (QUANT_F32, QUANT_Q80, QUANT_Q4K):
        raise ValueError(f"unsupported quant_type 0x{hdr.quant_type:x}")
    if hdr.model_type in (MODEL_TYPE_QWEN2, MODEL_TYPE_QWEN3):
        from nano_tpu_torch.tokenizer.bpe import BpeTokenizer
        bpe, pos = BpeTokenizer.parse_field(data, HEADER_BYTES,
                                            hdr.vocab_size)
        tok_cfg = {"type": "bpe", "tokenizer": bpe}
    else:
        tok_cfg, pos = parse_tokenizer_field(data, HEADER_BYTES)
    cfg = hdr.to_model_config()
    r = _Reader(data, pos)

    L, E, V = cfg.n_layer, cfg.n_embd, cfg.vocab_size
    H, KV, D, F = cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.n_hidden
    gs = hdr.group_size
    if hdr.quant_type == QUANT_F32:
        dense = True

    attn_norm = np.stack([r.f32(E) for _ in range(L)])
    ffn_norm = np.stack([r.f32(E) for _ in range(L)])
    final_norm = r.f32(E)

    if hdr.quant_type == QUANT_Q4K:
        return _read_model_q4k(data, hdr, cfg, tok_cfg, r,
                               attn_norm, ffn_norm, final_norm, dense)

    def read_stack(shape_out_in):
        """L matrices stored (out, in) -> stacked (L, in, out) + quants."""
        fs, qs = [], []
        for _ in range(L):
            w, qt = _read_tensor(r, shape_out_in, hdr.quant_type, gs, dense)
            fs.append(np.ascontiguousarray(w.T) if dense else None)
            qs.append(qt)
        return (np.stack(fs) if dense else None), qs

    tok_emb, tok_emb_q = _read_tensor(r, (V, E), hdr.quant_type, gs, dense)
    wq, wq_q = read_stack((H * D, E))
    wk, wk_q = read_stack((KV * D, E))
    wv, wv_q = read_stack((KV * D, E))
    wo, wo_q = read_stack((E, H * D))
    w1, w1_q = read_stack((F, E))
    w2, w2_q = read_stack((E, F))
    w3, w3_q = read_stack((F, E))

    extras: Dict[str, Any] = {}
    if hdr.model_type == MODEL_TYPE_QWEN2:
        extras["bq"] = np.stack([r.f32(H * D) for _ in range(L)])
        extras["bk"] = np.stack([r.f32(KV * D) for _ in range(L)])
        extras["bv"] = np.stack([r.f32(KV * D) for _ in range(L)])
    elif hdr.model_type == MODEL_TYPE_QWEN3:
        extras["q_norm"] = np.stack([r.f32(D) for _ in range(L)])
        extras["k_norm"] = np.stack([r.f32(D) for _ in range(L)])

    rope_cos = r.f32(cfg.block_size * (D // 2)).reshape(cfg.block_size, -1)
    rope_sin = r.f32(cfg.block_size * (D // 2)).reshape(cfg.block_size, -1)

    params: Dict[str, Any] = {
        "norm": final_norm,
        "blocks": {"attn_norm": attn_norm, "ffn_norm": ffn_norm, **extras},
    }
    if dense:
        params["tok_embeddings"] = tok_emb
        params["blocks"].update(wq=wq, wk=wk, wv=wv, wo=wo,
                                w1=w1, w2=w2, w3=w3)
    qparams = None
    if hdr.quant_type == QUANT_Q80:
        qparams = {
            "tok_embeddings": tok_emb_q,
            "blocks": {"wq": wq_q, "wk": wk_q, "wv": wv_q, "wo": wo_q,
                       "w1": w1_q, "w2": w2_q, "w3": w3_q},
        }

    if not hdr.shared_classifier:
        clf, clf_q = _read_tensor(r, (V, E), hdr.quant_type, gs, dense)
        if dense:
            params["output"] = np.ascontiguousarray(clf.T)
        if qparams is not None:
            qparams["output"] = clf_q

    return BinModel(header=hdr, config=cfg, tokenizer_config=tok_cfg,
                    params=params, qparams=qparams,
                    rope_cos=rope_cos, rope_sin=rope_sin)


def _read_model_q4k(data: bytes, hdr: BinHeader, cfg: ModelConfig,
                    tok_cfg: dict, r: _Reader, attn_norm, ffn_norm,
                    final_norm, dense: bool) -> BinModel:
    """Q4K tail: 8 stacked tensor frames, extras, RoPE tables for Nano
    (reference: infer/infer.c:140-216)."""
    L, E, V = cfg.n_layer, cfg.n_embd, cfg.vocab_size
    H, KV, D, F = cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.n_hidden

    order = [("tok_embeddings", (V, E)), ("wq", (L, H * D, E)),
             ("wk", (L, KV * D, E)), ("wv", (L, KV * D, E)),
             ("wo", (L, E, H * D)), ("w1", (L, F, E)),
             ("w2", (L, E, F)), ("w3", (L, F, E))]
    frames: Dict[str, Q4KFrame] = {}
    for name, shape in order:
        blocks, fshape, r.pos = q4k.parse_tensor_frame(data, r.pos)
        if fshape != shape:
            raise ValueError(f"Q4K frame {name} has shape {fshape}, "
                             f"expected {shape}")
        frames[name] = Q4KFrame(blocks=blocks, shape=shape)

    extras: Dict[str, Any] = {}
    if hdr.model_type == MODEL_TYPE_QWEN3:
        extras["q_norm"] = np.stack([r.f32(D) for _ in range(L)])
        extras["k_norm"] = np.stack([r.f32(D) for _ in range(L)])
    elif hdr.model_type == MODEL_TYPE_QWEN2:
        raise ValueError("Q4K Qwen2 files are not well-formed "
                         "(reference drops the qkv biases)")

    if hdr.model_type == MODEL_TYPE_NANO:
        rope_cos = r.f32(cfg.block_size * (D // 2)).reshape(cfg.block_size, -1)
        rope_sin = r.f32(cfg.block_size * (D // 2)).reshape(cfg.block_size, -1)
    else:  # Qwen3 recomputes theta=1e6 tables (infer/infer.c:189-204)
        rope_cos, rope_sin = _rope_tables(cfg)

    def deq_T(name):  # (L, out, in) -> (L, in, out)
        return np.ascontiguousarray(
            frames[name].dequantize().transpose(0, 2, 1))

    params: Dict[str, Any] = {
        "norm": final_norm,
        "blocks": {"attn_norm": attn_norm, "ffn_norm": ffn_norm, **extras},
    }
    if dense:
        params["tok_embeddings"] = frames["tok_embeddings"].dequantize()
        params["blocks"].update({n: deq_T(n) for n in
                                 ("wq", "wk", "wv", "wo", "w1", "w2", "w3")})
    qparams = {"tok_embeddings": frames["tok_embeddings"],
               "blocks": {n: frames[n] for n in
                          ("wq", "wk", "wv", "wo", "w1", "w2", "w3")}}
    return BinModel(header=hdr, config=cfg, tokenizer_config=tok_cfg,
                    params=params, qparams=qparams,
                    rope_cos=rope_cos, rope_sin=rope_sin)


# =====================================================================
# device params
# =====================================================================

def dense_device_params(params: Dict[str, Any], dtype, device) -> Dict[str, Any]:
    """numpy pytree -> tensors on `device`: matrices in `dtype`, vectors
    (norms, biases) in f32."""
    def conv(x):
        t = torch.from_numpy(np.array(x))
        return t.to(device=device,
                    dtype=dtype if t.dim() >= 2 else torch.float32)
    return {k: (dense_device_params(v, dtype, device) if isinstance(v, dict)
                else conv(v)) for k, v in params.items()}


def quantized_device_params(bm: BinModel, fuse: bool = True,
                            device=None) -> Dict[str, Any]:
    """Device params keeping the matmul weights quantized.

    Matmul weights become stacked Q80Tensors (int8 + scales, (L, out, in)
    file layout); norms and arch extras stay f32.  fuse=True concatenates
    wq/wk/wv -> wqkv and w1/w3 -> w13 along the output dim (valid because
    Q80 groups run along the input dim): fewer, larger launches per step.
    """
    if bm.qparams is None:
        raise ValueError("not a quantized model file")
    if bm.header.quant_type == QUANT_Q4K:
        return _q4k_device_params(bm, fuse, device)
    gs = bm.header.group_size

    def tens(x):
        return torch.from_numpy(np.array(x)).to(device)

    def stack_q(qt_lists) -> Q80Tensor:
        L = len(qt_lists[0])
        qs, ss = [], []
        for i in range(L):
            qs.append(np.concatenate([lst[i].q for lst in qt_lists], axis=0))
            ss.append(np.concatenate(
                [lst[i].scale.reshape(lst[i].q.shape[0], -1)
                 for lst in qt_lists], axis=0))
        return Q80Tensor(q=tens(np.stack(qs)), scales=tens(np.stack(ss)),
                         group_size=gs)

    def single_q(qt) -> Q80Tensor:
        out, inn = qt.q.shape
        return Q80Tensor(q=tens(qt.q),
                         scales=tens(qt.scale.reshape(out, inn // gs)),
                         group_size=gs)

    qb = bm.qparams["blocks"]
    blocks: Dict[str, Any] = {
        "attn_norm": tens(bm.params["blocks"]["attn_norm"]),
        "ffn_norm": tens(bm.params["blocks"]["ffn_norm"]),
        "wo": stack_q([qb["wo"]]),
        "w2": stack_q([qb["w2"]]),
    }
    for name in ("q_norm", "k_norm", "bq", "bk", "bv"):
        if name in bm.params["blocks"]:
            blocks[name] = tens(bm.params["blocks"][name])
    if fuse:
        blocks["wqkv"] = stack_q([qb["wq"], qb["wk"], qb["wv"]])
        blocks["w13"] = stack_q([qb["w1"], qb["w3"]])
    else:
        blocks.update(wq=stack_q([qb["wq"]]), wk=stack_q([qb["wk"]]),
                      wv=stack_q([qb["wv"]]), w1=stack_q([qb["w1"]]),
                      w3=stack_q([qb["w3"]]))
    params: Dict[str, Any] = {
        "tok_embeddings": single_q(bm.qparams["tok_embeddings"]),
        "norm": tens(bm.params["norm"]),
        "blocks": blocks,
    }
    if "output" in bm.qparams:
        params["output"] = single_q(bm.qparams["output"])
    _maybe_int8_layout(params)
    return params


def _maybe_int8_layout(params: Dict[str, Any]) -> None:
    """The load-time numerics decision, in place: every Q80 weight with
    group size >= 256 takes the W8A8 form (int8 activations, exact int32
    group partials), smaller groups the f32 rows form; a tied Q80 head
    becomes ``output_q``, which shares the embedding table's storage (the
    JAX package kept a second, grouped copy for its matrix unit)."""
    def conv(t):
        if isinstance(t, Q80Tensor):
            t.w8a8 = t.group_size >= MIN_W8A8_GS
        return t

    for v in params["blocks"].values():
        conv(v)
    if isinstance(params.get("output"), (Q80Tensor, Q4KTensor)):
        conv(params["output"])          # an untied quantized head stays
        return
    tok = params["tok_embeddings"]
    if isinstance(tok, Q80Tensor):
        params["output_q"] = conv(tok)


def _q4k_device_params(bm: BinModel, fuse: bool, device) -> Dict[str, Any]:
    """Q4K frames -> stacked packed Q4KTensors (fused wqkv / w13: Q4K
    groups run along the input dim, so rows concatenate), norms f32, and
    the tied head requantized to Q80 as ``output_q`` (or the packed table
    itself when n_embd is not a multiple of 32)."""
    def stack(names) -> Q4KTensor:
        """(L, out, in) frames -> one stacked tensor, concatenated along out."""
        frames = [bm.qparams["blocks"][n] for n in names]
        L, _, inn = frames[0].shape
        per = [[q4k.packed_from_blocks(b, f.shape[1], inn)
                for b in f.blocks.reshape(L, -1, q4k.BLOCK_BYTES)]
               for f in frames]
        p, s, b = (torch.from_numpy(np.stack(
            [np.concatenate([fr[i][k] for fr in per]) for i in range(L)])
        ).to(device) for k in range(3))
        return Q4KTensor(packed=p, scales=s, biases=b, in_dim=inn)

    def tens(x):
        return torch.from_numpy(np.array(x)).to(device)

    blocks: Dict[str, Any] = {
        "attn_norm": tens(bm.params["blocks"]["attn_norm"]),
        "ffn_norm": tens(bm.params["blocks"]["ffn_norm"]),
        "wo": stack(["wo"]),
        "w2": stack(["w2"]),
    }
    for name in ("q_norm", "k_norm"):
        if name in bm.params["blocks"]:
            blocks[name] = tens(bm.params["blocks"][name])
    if fuse:
        blocks["wqkv"] = stack(["wq", "wk", "wv"])
        blocks["w13"] = stack(["w1", "w3"])
    else:
        blocks.update({n: stack([n]) for n in ("wq", "wk", "wv", "w1", "w3")})
    V, E = bm.config.vocab_size, bm.config.n_embd
    tok_blocks = bm.qparams["tok_embeddings"].blocks
    tok = Q4KTensor.from_blocks(tok_blocks, V, E, device)
    head = q4k_head_requant(tok_blocks, V, E, device)
    return {"tok_embeddings": tok, "norm": tens(bm.params["norm"]),
            "blocks": blocks, "output_q": tok if head is None else head}


def q4k_head_requant(blocks: np.ndarray, out_dim: int, in_dim: int,
                     device=None) -> Optional[Q80Tensor]:
    """Q4K LM head -> Q80 rows at the largest group size in (256, 128, 64,
    32) that divides in_dim (W8A8 form at >= 256), computed on the host
    from the file's blocks, as the JAX package does.  The head values are
    already 4-bit, so the int8 step adds noise far below the Q4K error.
    None when in_dim is not a multiple of 32 (the packed head stays)."""
    divisors = [g for g in (256, 128, 64, 32) if in_dim % g == 0]
    if not divisors:
        return None
    gs = max(divisors)
    dense = q4k.dequantize_lines_np(blocks, out_dim, in_dim)
    q, scales = quantize_q80(dense, gs)
    return Q80Tensor(q=torch.from_numpy(q.reshape(out_dim, in_dim)).to(device),
                     scales=torch.from_numpy(
                         scales.reshape(out_dim, in_dim // gs)).to(device),
                     group_size=gs, w8a8=gs >= MIN_W8A8_GS)


# =====================================================================
# LoRA files (reference: export.py:119-224, infer/infer.c:413-499)
# =====================================================================

_LORA_ORDER = ("wq", "wk", "wv", "wo")


def write_lora(path: str, lora: Dict[str, Any], cfg: ModelConfig,
               rank: int, alpha: int) -> None:
    """LoRA .bin: 256-B header (type 10) + f32 A / B matrices.

    File order: wq_a[L], wq_b[L], wk_a[L], wk_b[L], wv_a[L], wv_b[L],
    wo_a[L], wo_b[L]; each matrix stored (out, in) row-major.  `lora`
    holds the stacked (L, in, out) layout, numpy arrays or tensors of any
    device and float type.
    """
    buf = io.BytesIO()
    buf.write(struct.pack("<II", MAGIC_0, MAGIC_1))
    buf.write(struct.pack("<ii", *VERSION))
    buf.write(struct.pack("<ii", MODEL_TYPE_LORA, 32))
    buf.write(struct.pack("<8i", rank, alpha, cfg.n_layer, cfg.n_embd,
                          cfg.n_head, cfg.n_kv_head, cfg.n_hidden, 0))
    raw = buf.getvalue()
    with open(path, "wb") as f:
        f.write(raw + b"\0" * (HEADER_BYTES - len(raw)))
        for name in _LORA_ORDER:
            for suffix in ("_a", "_b"):
                stacked = _f32(lora[name + suffix])        # (L, in, out)
                for w in stacked:
                    f.write(np.ascontiguousarray(w.T).astype("<f4").tobytes())


@dataclass
class BinLora:
    rank: int
    alpha: int
    lora: Dict[str, np.ndarray]   # the stacked (L, in, out) layout, f32


def read_lora(path: str, cfg: ModelConfig) -> BinLora:
    """Parse a LoRA .bin for the base model `cfg` (its layer count and
    widths must be the file's)."""
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack_from("<II", data, 0) != (MAGIC_0, MAGIC_1):
        raise ValueError("not a BD4SURLM .bin file")
    model_type, _ = struct.unpack_from("<ii", data, 16)
    if model_type != MODEL_TYPE_LORA:
        raise ValueError("not a LoRA .bin file")
    rank, alpha, n_layer, n_embd, n_head, n_kv_head, n_hidden, _res = \
        struct.unpack_from("<8i", data, 24)
    if (n_layer, n_embd, n_head, n_kv_head, n_hidden) != (
            cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_kv_head,
            cfg.n_hidden):
        raise ValueError("LoRA file does not match base model config")
    r = _Reader(data, HEADER_BYTES)
    L, E = cfg.n_layer, cfg.n_embd
    HD, KD = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim
    dims = {"wq": (E, HD), "wk": (E, KD), "wv": (E, KD), "wo": (HD, E)}

    def read_stack(out_dim, in_dim):
        return np.stack([
            np.ascontiguousarray(r.f32(out_dim * in_dim)
                                 .reshape(out_dim, in_dim).T)
            for _ in range(L)])

    lora = {}
    for name in _LORA_ORDER:
        inn, out = dims[name]
        lora[name + "_a"] = read_stack(rank, inn)
        lora[name + "_b"] = read_stack(out, rank)
    return BinLora(rank=rank, alpha=alpha, lora=lora)
