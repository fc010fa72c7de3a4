"""HuggingFace Qwen2.5 / Qwen3 -> .bin converter.

Port of ``nano_tpu/io/qwen.py``: reads a HF checkpoint directory
(config.json, *.safetensors, tokenizer.json), maps the weights into the
checkpoint layout (Qwen3 keeps the HF rotate-half rows; Qwen2's q/k rows
take the interleaved-pair permutation), and writes model_type 2/3 files.

The safetensors files are read by hand (``_load_safetensors``), so the port
needs no ``safetensors`` package: an 8-byte little-endian header length, a
JSON header of ``dtype`` / ``shape`` / ``data_offsets`` per tensor, then the
raw bytes.  F32, F16 and BF16 are read; BF16 comes back as its raw uint16
bits, which ``_to_f32`` widens by a shift.
"""

from __future__ import annotations

import json
import os
import struct
from glob import glob
from typing import Any, Dict, Optional, Tuple

import numpy as np

from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.io import binfmt
from nano_tpu_torch.tokenizer.bpe import BpeTokenizer

# safetensors dtype -> numpy dtype of the stored bytes (BF16 kept raw)
_ST_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
              "BF16": np.dtype("<u2")}


def _read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """One .safetensors file -> {name: array}, F32 / F16 / BF16 (raw
    uint16) tensors."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n,) = struct.unpack_from("<Q", data, 0)
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes exceeds the file")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    base = 8 + n
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _ST_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name!r} has the unsupported "
                             f"dtype {info['dtype']} (F32, F16, BF16)")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape)) if shape else 1
        if end - begin != count * dt.itemsize or base + end > len(data):
            raise ValueError(f"{path}: tensor {name!r} data does not match "
                             f"its shape {shape} and dtype {info['dtype']}")
        out[name] = np.frombuffer(data, dtype=dt, count=count,
                                  offset=base + begin).reshape(shape)
    return out


def _load_safetensors(hf_dir: str) -> Dict[str, np.ndarray]:
    tensors: Dict[str, np.ndarray] = {}
    files = sorted(glob(os.path.join(hf_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors in {hf_dir}")
    for path in files:
        tensors.update(_read_safetensors(path))
    return tensors


def _to_f32(x: np.ndarray) -> np.ndarray:
    if x.dtype == np.uint16:  # bfloat16 stored raw
        return (x.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(x, np.float32)


def rope_permute_reverse(w: np.ndarray, n_heads: int, head_dim: int
                         ) -> np.ndarray:
    """HF rotate-half row layout -> interleaved-pair layout (reference:
    infer/tools/export_qwen.py permute_reverse): within each head, the
    rotation pair (i, i + D/2) moves to rows (2i, 2i+1).  Qwen2 runs the
    interleaved path; Qwen3 keeps the HF layout (half-split RoPE).  Shared
    by the safetensors and GGUF importers."""
    D = head_dim
    out = w.reshape(n_heads, D, *w.shape[1:])
    idx = np.empty(D, np.int64)
    idx[0::2] = np.arange(D // 2)
    idx[1::2] = np.arange(D // 2) + D // 2
    return out[:, idx].reshape(w.shape)


def load_hf_qwen(hf_dir: str, max_seq_len: Optional[int] = None
                 ) -> Tuple[ModelConfig, Dict[str, Any], int]:
    """-> (ModelConfig, f32 params in the checkpoint layout, model_type)."""
    with open(os.path.join(hf_dir, "config.json"), "r") as f:
        hc = json.load(f)
    arch = hc.get("model_type", "qwen3")
    if not arch.startswith("qwen"):
        raise ValueError(
            f"unsupported HF model_type {arch!r}: the .bin format maps "
            "Qwen2/Qwen3 dense checkpoints only (a non-qwen model would "
            "fail later with a bare missing-weight KeyError, or worse, "
            "export a structurally wrong file)")
    qwen3 = arch.startswith("qwen3")
    model_type = binfmt.MODEL_TYPE_QWEN3 if qwen3 else binfmt.MODEL_TYPE_QWEN2

    block_size = hc["max_position_embeddings"]
    if max_seq_len:
        block_size = min(block_size, max_seq_len)
    cfg = ModelConfig(
        block_size=block_size,
        vocab_size=hc["vocab_size"],
        n_layer=hc["num_hidden_layers"],
        n_embd=hc["hidden_size"],
        n_head=hc["num_attention_heads"],
        n_kv_head=hc["num_key_value_heads"],
        n_hidden=hc["intermediate_size"],
        norm_eps=hc.get("rms_norm_eps", 1e-6),
        rope_theta=hc.get("rope_theta", 1e6),
        head_dim=hc.get("head_dim"),
        use_qk_norm=qwen3,
        qkv_bias=not qwen3,
        rope_style="half" if qwen3 else "interleaved",
        tie_embeddings=hc.get("tie_word_embeddings", False),
    )

    t = _load_safetensors(hf_dir)

    def get(name):
        key = name if name in t else "model." + name
        return _to_f32(t[key])

    D = cfg.head_dim

    def stack(fmt, permute_heads: int = 0, transpose: bool = False):
        out = []
        for i in range(cfg.n_layer):
            v = get(fmt.format(i))
            if permute_heads:
                v = rope_permute_reverse(v, permute_heads, D)
            out.append(np.ascontiguousarray(v.T) if transpose else v)
        return np.stack(out)

    attn = "layers.{}.self_attn."
    mlp = "layers.{}.mlp."
    blocks: Dict[str, Any] = {
        "attn_norm": stack("layers.{}.input_layernorm.weight"),
        "ffn_norm": stack("layers.{}.post_attention_layernorm.weight"),
        "wq": stack(attn + "q_proj.weight", 0 if qwen3 else cfg.n_head, True),
        "wk": stack(attn + "k_proj.weight", 0 if qwen3 else cfg.n_kv_head,
                    True),
        "wv": stack(attn + "v_proj.weight", transpose=True),
        "wo": stack(attn + "o_proj.weight", transpose=True),
        "w1": stack(mlp + "gate_proj.weight", transpose=True),
        "w2": stack(mlp + "down_proj.weight", transpose=True),
        "w3": stack(mlp + "up_proj.weight", transpose=True),
    }
    if qwen3:
        blocks["q_norm"] = stack(attn + "q_norm.weight")
        blocks["k_norm"] = stack(attn + "k_norm.weight")
    else:
        blocks["bq"] = stack(attn + "q_proj.bias", cfg.n_head)
        blocks["bk"] = stack(attn + "k_proj.bias", cfg.n_kv_head)
        blocks["bv"] = stack(attn + "v_proj.bias")

    params: Dict[str, Any] = {
        "tok_embeddings": get("embed_tokens.weight"),
        "norm": get("norm.weight"),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        lm = t.get("lm_head.weight")
        lm = get("embed_tokens.weight") if lm is None else _to_f32(lm)
        params["output"] = np.ascontiguousarray(lm.T)
    return cfg, params, model_type


def convert_hf_qwen(hf_dir: str, out_path: str, quant: str = "f32",
                    group_size: int = 256,
                    max_seq_len: Optional[int] = None) -> ModelConfig:
    """HF checkpoint dir -> self-contained .bin (Q80 at group size 256
    takes the W8A8 kernels; the reference's own exporter uses 64)."""
    cfg, params, model_type = load_hf_qwen(hf_dir, max_seq_len)
    tok_path = os.path.join(hf_dir, "tokenizer.json")
    tokenizer = BpeTokenizer.from_hf_tokenizer_json(tok_path, cfg.vocab_size)
    binfmt.write_model(out_path, params, cfg, tokenizer, quant=quant,
                       group_size=group_size, model_type=model_type)
    return cfg
