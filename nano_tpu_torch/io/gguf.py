"""GGUF bridge: read llama.cpp-ecosystem checkpoints, write them.

Port of ``nano_tpu/io/gguf.py``.  The container is parsed directly and
memory-mapped (a tensor's raw bytes are read when it is used); the ggml
blocks dequantize with vectorized numpy, and the weights map into the
checkpoint layout (``load_gguf_qwen``) or straight onto the port's
quantized device tensors (``quantized_device_params``), so a GGUF
Qwen2/Qwen3 file runs on the same engine as a ``.bin``.

Reader scope: GGUF v2/v3; tensor types F32, F16, BF16, Q4_0, Q8_0, Q4_K,
Q6_K (block layouts per the public ggml spec, ggml-common.h).  Writer
scope: F32, F16 and Q8_0 tensors plus the metadata llama.cpp needs to
load a qwen2/qwen3 model (arch keys, tokenizer.ggml.*).
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.io import binfmt
from nano_tpu_torch.io.qwen import rope_permute_reverse
from nano_tpu_torch.ops import q4k as q4k_mod
from nano_tpu_torch.ops.q4k import Q4KTensor
from nano_tpu_torch.ops.qmatmul import MIN_W8A8_GS, Q80Tensor
from nano_tpu_torch.tokenizer.bpe import BpeTokenizer, gpt2_bytes_to_unicode

GGUF_MAGIC = 0x46554747          # "GGUF" little-endian

# metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 \
    = range(13)
_SCALAR = {
    _U8: ("<B", 1), _I8: ("<b", 1), _U16: ("<H", 2), _I16: ("<h", 2),
    _U32: ("<I", 4), _I32: ("<i", 4), _F32: ("<f", 4), _BOOL: ("<B", 1),
    _U64: ("<Q", 8), _I64: ("<q", 8), _F64: ("<d", 8),
}

# ggml tensor types: id -> (block_len, block_bytes)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q8_0 = 2, 8
GGML_Q4_K, GGML_Q6_K = 12, 14
GGML_BF16 = 30
_TYPE_BLOCK = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
    GGML_Q4_0: (32, 18), GGML_Q8_0: (32, 34),
    GGML_Q4_K: (256, 144), GGML_Q6_K: (256, 210),
}
_TYPE_NAME = {GGML_F32: "f32", GGML_F16: "f16", GGML_BF16: "bf16",
              GGML_Q4_0: "q4_0", GGML_Q8_0: "q8_0",
              GGML_Q4_K: "q4_k", GGML_Q6_K: "q6_k"}

_Q8_0_BLOCK = np.dtype([("d", "<f2"), ("qs", "i1", 32)])
_Q4_0_BLOCK = np.dtype([("d", "<f2"), ("qs", "u1", 16)])
_Q4_K_BLOCK = np.dtype([("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", 12),
                        ("qs", "u1", 128)])
_Q6_K_BLOCK = np.dtype([("ql", "u1", 128), ("qh", "u1", 64),
                        ("scales", "i1", 16), ("d", "<f2")])


# =====================================================================
# block dequantizers (vectorized; layouts per ggml-common.h)
# =====================================================================

def dequant_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    """Q8_0: 32-value blocks [d f16][qs i8 x32]; y = d * q."""
    blk = np.frombuffer(raw, dtype=_Q8_0_BLOCK)
    y = blk["d"].astype(np.float32)[:, None] * blk["qs"].astype(np.float32)
    return y.reshape(-1)[:n]


def dequant_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    """Q4_0: 32-value blocks [d f16][qs u8 x16]; the low nibbles are
    values 0..15, the high nibbles 16..31; y = d * (q - 8)."""
    blk = np.frombuffer(raw, dtype=_Q4_0_BLOCK)
    d = blk["d"].astype(np.float32)[:, None]
    qs = blk["qs"]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    y = np.concatenate([d * lo, d * hi], axis=1)
    return y.reshape(-1)[:n]


def _q4k_scale_min(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The 12-byte 6-bit scale/min table of a Q4_K superblock -> (N, 8)
    each (ggml get_scale_min_k4)."""
    s = scales.astype(np.uint8)
    sc = np.empty((s.shape[0], 8), np.uint8)
    mn = np.empty((s.shape[0], 8), np.uint8)
    sc[:, :4] = s[:, 0:4] & 63
    mn[:, :4] = s[:, 4:8] & 63
    sc[:, 4:] = (s[:, 8:12] & 0x0F) | ((s[:, 0:4] >> 6) << 4)
    mn[:, 4:] = (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)
    return sc, mn


def dequant_q4_k(raw: np.ndarray, n: int) -> np.ndarray:
    """Q4_K: 256-value superblocks [d f16][dmin f16][scales u8 x12]
    [qs u8 x128]; in 64-value chunk j the low nibbles of qs[32j:32j+32]
    are values 64j..64j+31 (scale 2j), the high nibbles 64j+32..64j+63
    (scale 2j+1); y = d*sc*q - dmin*mn."""
    blk = np.frombuffer(raw, dtype=_Q4_K_BLOCK)
    d = blk["d"].astype(np.float32)
    dmin = blk["dmin"].astype(np.float32)
    sc, mn = _q4k_scale_min(blk["scales"])
    qs = blk["qs"].reshape(-1, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    dsc = d[:, None] * sc.astype(np.float32)     # (N, 8)
    dmn = dmin[:, None] * mn.astype(np.float32)
    y = np.empty((blk.shape[0], 4, 64), np.float32)
    y[:, :, :32] = dsc[:, 0::2, None] * lo - dmn[:, 0::2, None]
    y[:, :, 32:] = dsc[:, 1::2, None] * hi - dmn[:, 1::2, None]
    return y.reshape(-1)[:n]


def _q6_values(blk: np.ndarray) -> np.ndarray:
    """The 6-bit values of Q6_K superblocks in value order, (N, 2, 128)
    int16 in [0, 63] (the two-half layout of ggml dequantize_row_q6_K)."""
    ql = blk["ql"].reshape(-1, 2, 64)
    qh = blk["qh"].reshape(-1, 2, 32)
    q6 = np.empty((blk.shape[0], 2, 128), np.int16)
    q6[:, :, 0:32] = (ql[:, :, :32] & 0x0F) | (((qh >> 0) & 3) << 4)
    q6[:, :, 32:64] = (ql[:, :, 32:] & 0x0F) | (((qh >> 2) & 3) << 4)
    q6[:, :, 64:96] = (ql[:, :, :32] >> 4) | (((qh >> 4) & 3) << 4)
    q6[:, :, 96:128] = (ql[:, :, 32:] >> 4) | (((qh >> 6) & 3) << 4)
    return q6


def dequant_q6_k(raw: np.ndarray, n: int) -> np.ndarray:
    """Q6_K: 256-value superblocks [ql u8 x128][qh u8 x64][scales i8 x16]
    [d f16]; y = d * sc * (q - 32), one scale per 16 values in order."""
    blk = np.frombuffer(raw, dtype=_Q6_K_BLOCK)
    d = blk["d"].astype(np.float32)[:, None, None]     # (N, 1, 1)
    sc = blk["scales"].reshape(-1, 2, 8).astype(np.float32)
    q6 = _q6_values(blk)
    y = np.empty((blk.shape[0], 2, 128), np.float32)
    sidx = np.arange(32) // 16
    for qi, off in enumerate((0, 2, 4, 6)):
        s = sc[:, :, sidx + off]                       # (N, 2, 32)
        y[:, :, 32 * qi:32 * (qi + 1)] = \
            d * s * (q6[:, :, 32 * qi:32 * (qi + 1)].astype(np.float32) - 32.0)
    return y.reshape(-1)[:n]


_DEQUANT = {
    GGML_Q8_0: dequant_q8_0,
    GGML_Q4_0: dequant_q4_0,
    GGML_Q4_K: dequant_q4_k,
    GGML_Q6_K: dequant_q6_k,
}


# =====================================================================
# container reader
# =====================================================================

class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return vals[0] if len(vals) == 1 else vals

    def take_bytes(self, n: int) -> bytes:
        b = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return b

    def take_str(self) -> str:
        n = self.take("<Q")
        return self.take_bytes(n).decode("utf-8", errors="replace")

    def take_value(self, vtype: int):
        if vtype == _STR:
            return self.take_str()
        if vtype == _ARR:
            etype = self.take("<I")
            count = self.take("<Q")
            if etype in _SCALAR and etype != _BOOL:
                fmt, size = _SCALAR[etype]
                arr = np.frombuffer(self.buf, dtype=np.dtype(fmt),
                                    count=count, offset=self.pos)
                self.pos += size * count
                return arr
            return [self.take_value(etype) for _ in range(count)]
        if vtype == _BOOL:
            return bool(self.take("<B"))
        if vtype in _SCALAR:
            return self.take(_SCALAR[vtype][0])
        raise ValueError(f"unknown GGUF metadata value type {vtype}")


class GGUFTensor:
    def __init__(self, name: str, shape: Tuple[int, ...], ggml_type: int,
                 raw: np.ndarray):
        self.name = name
        self.shape = shape          # row-major (out, ..., in): ne reversed
        self.ggml_type = ggml_type
        self._raw = raw

    @property
    def type_name(self) -> str:
        return _TYPE_NAME.get(self.ggml_type, str(self.ggml_type))

    def to_f32(self) -> np.ndarray:
        n = int(np.prod(self.shape))
        t = self.ggml_type
        if t == GGML_F32:
            y = np.frombuffer(self._raw, dtype="<f4", count=n)
        elif t == GGML_F16:
            y = np.frombuffer(self._raw, dtype="<f2",
                              count=n).astype(np.float32)
        elif t == GGML_BF16:
            u = np.frombuffer(self._raw, dtype="<u2", count=n)
            y = (u.astype(np.uint32) << 16).view(np.float32)
        elif t in _DEQUANT:
            y = _DEQUANT[t](self._raw, n)
        else:
            raise ValueError(
                f"unsupported ggml tensor type {t} for {self.name!r} "
                f"(supported: {sorted(_TYPE_NAME.values())})")
        return np.ascontiguousarray(y.reshape(self.shape))

    def blocks(self, dtype: np.dtype) -> np.ndarray:
        return np.frombuffer(self._raw, dtype=dtype)


class GGUFFile:
    """A parsed GGUF container: ``.meta`` (dict) and ``.tensors`` ({name:
    GGUFTensor}); the data stays memory-mapped and each tensor is
    dequantized when it is used."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        r = _Reader(self._mm)
        magic = r.take("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
        self.version = r.take("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF v{self.version}")
        n_tensors = r.take("<Q")
        n_kv = r.take("<Q")
        self.meta: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.take_str()
            vtype = r.take("<I")
            self.meta[key] = r.take_value(vtype)
        infos = []
        for _ in range(n_tensors):
            name = r.take_str()
            ndim = r.take("<I")
            ne = [r.take("<Q") for _ in range(ndim)]
            ggml_type = r.take("<I")
            offset = r.take("<Q")
            infos.append((name, ne, ggml_type, offset))
        align = int(self.meta.get("general.alignment", 32))
        data0 = (r.pos + align - 1) // align * align
        self.tensors: Dict[str, GGUFTensor] = {}
        for name, ne, t, off in infos:
            # an unknown type keeps its entry, so that a load names it
            blk_len, blk_bytes = _TYPE_BLOCK.get(t, (1, 0))
            n = int(np.prod(ne)) if ne else 1
            nbytes = (n // blk_len) * blk_bytes if blk_bytes else 0
            start = data0 + off
            if blk_bytes and start + nbytes > len(self._mm):
                raise ValueError(f"{path}: tensor {name!r} data "
                                 f"[{start}:{start + nbytes}] exceeds file "
                                 f"size {len(self._mm)}")
            raw = np.frombuffer(self._mm, dtype=np.uint8, count=nbytes,
                                offset=start)
            # ne is innermost-first; row-major wants it reversed
            self.tensors[name] = GGUFTensor(name, tuple(reversed(ne)), t,
                                            raw)

    def close(self):
        mm, self._mm = self._mm, None
        if mm is not None:
            del self.tensors         # the tensors hold views of the map
            mm.close()


# =====================================================================
# qwen2 / qwen3 import
# =====================================================================

def gguf_header_only(g: GGUFFile, max_seq_len: Optional[int] = None
                     ) -> Tuple[ModelConfig, int, BpeTokenizer]:
    """GGUF metadata -> (ModelConfig, model_type, tokenizer), without
    touching the tensor data."""
    arch = g.meta.get("general.architecture", "")
    if arch not in ("qwen2", "qwen3"):
        raise ValueError(
            f"unsupported GGUF architecture {arch!r}: the .bin format "
            "maps dense Qwen2/Qwen3 only (llama-family GGUFs carry "
            "incompatible rope/vocab conventions)")
    model_type = (binfmt.MODEL_TYPE_QWEN3 if arch == "qwen3"
                  else binfmt.MODEL_TYPE_QWEN2)
    m = g.meta

    def k(suffix, default=None):
        return m.get(f"{arch}.{suffix}", default)

    tokens = m.get("tokenizer.ggml.tokens")
    if tokens is None:
        raise ValueError(f"{g.path}: no tokenizer.ggml.tokens metadata")
    n_embd = int(k("embedding_length"))
    n_head = int(k("attention.head_count"))
    block_size = int(k("context_length", 32768))
    if max_seq_len:
        block_size = min(block_size, max_seq_len)
    cfg = ModelConfig(
        block_size=block_size,
        vocab_size=len(tokens),
        n_layer=int(k("block_count")),
        n_embd=n_embd,
        n_head=n_head,
        n_kv_head=int(k("attention.head_count_kv", n_head)),
        n_hidden=int(k("feed_forward_length")),
        norm_eps=float(k("attention.layer_norm_rms_epsilon", 1e-6)),
        rope_theta=float(k("rope.freq_base", 1e6)),
        head_dim=int(k("attention.key_length", n_embd // n_head)),
        use_qk_norm=(arch == "qwen3"),
        qkv_bias=(arch == "qwen2"),
        rope_style="half" if arch == "qwen3" else "interleaved",
        tie_embeddings="output.weight" not in g.tensors,
    )
    tokenizer = BpeTokenizer.from_gguf_metadata(
        tokens, m.get("tokenizer.ggml.merges"))
    return cfg, model_type, tokenizer


def load_gguf_qwen(path: str, max_seq_len: Optional[int] = None
                   ) -> Tuple[ModelConfig, Dict[str, Any], int,
                              BpeTokenizer]:
    """-> (ModelConfig, f32 params in the checkpoint layout, model_type,
    tokenizer); dense Qwen2/Qwen3 only."""
    g = GGUFFile(path)
    cfg, model_type, tokenizer = gguf_header_only(g, max_seq_len)
    qwen2 = g.meta["general.architecture"] == "qwen2"
    D = cfg.head_dim

    def get(name):
        if name not in g.tensors:
            raise KeyError(f"{path}: missing tensor {name!r}")
        return g.tensors[name].to_f32()

    def stack(fmt, permute_heads: int = 0, transpose: bool = False):
        out = []
        for i in range(cfg.n_layer):
            v = get(fmt.format(i))
            if permute_heads:
                v = rope_permute_reverse(v, permute_heads, D)
            out.append(np.ascontiguousarray(v.T) if transpose else v)
        return np.stack(out)

    blocks: Dict[str, Any] = {
        "attn_norm": stack("blk.{}.attn_norm.weight"),
        "ffn_norm": stack("blk.{}.ffn_norm.weight"),
        "wq": stack("blk.{}.attn_q.weight", cfg.n_head if qwen2 else 0, True),
        "wk": stack("blk.{}.attn_k.weight", cfg.n_kv_head if qwen2 else 0,
                    True),
        "wv": stack("blk.{}.attn_v.weight", transpose=True),
        "wo": stack("blk.{}.attn_output.weight", transpose=True),
        "w1": stack("blk.{}.ffn_gate.weight", transpose=True),
        "w2": stack("blk.{}.ffn_down.weight", transpose=True),
        "w3": stack("blk.{}.ffn_up.weight", transpose=True),
    }
    if qwen2:
        blocks["bq"] = stack("blk.{}.attn_q.bias", cfg.n_head)
        blocks["bk"] = stack("blk.{}.attn_k.bias", cfg.n_kv_head)
        blocks["bv"] = stack("blk.{}.attn_v.bias")
    else:
        blocks["q_norm"] = stack("blk.{}.attn_q_norm.weight")
        blocks["k_norm"] = stack("blk.{}.attn_k_norm.weight")

    params: Dict[str, Any] = {
        "tok_embeddings": get("token_embd.weight"),
        "norm": get("output_norm.weight"),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["output"] = np.ascontiguousarray(get("output.weight").T)
    return cfg, params, model_type, tokenizer


def convert_gguf(path: str, out_path: str, quant: str = "q80",
                 group_size: int = 256,
                 max_seq_len: Optional[int] = None) -> ModelConfig:
    """GGUF -> self-contained .bin (f32 / q80 / q4k); Q80 at group size
    256 takes the W8A8 kernels."""
    cfg, params, model_type, tokenizer = load_gguf_qwen(path, max_seq_len)
    binfmt.write_model(out_path, params, cfg, tokenizer, quant=quant,
                       group_size=group_size, model_type=model_type)
    return cfg


# =====================================================================
# quantized load: ggml blocks -> the port's quantized device tensors
# =====================================================================
#
# ggml's per-group affines map losslessly onto the device tensors:
#   Q8_0:  x = d*q            -> Q80Tensor, group size 32
#   Q4_K:  x = (d*sc)*q - (dmin*m) per 32-group, q in 0..15
#          -> Q4KTensor (scales = d*sc, biases = dmin*m)
#   Q6_K:  x = d*sc16*(q - 32) per 16-group, q in 0..63
#          -> Q80Tensor, group size 16 (q - 32 fits int8)
#   Q4_0:  x = d*(q - 8) = q*d - 8d per 32-block -> Q4KTensor
# Below group size 256 a Q80 weight takes the rows form (qmatmul.q80_rows).
# A layer stack must share one leaf kind: a name whose layers mix types is
# unified by requantizing every layer to Q4K from its dequantized values.

def _q80(q: np.ndarray, s: np.ndarray, gs: int) -> Q80Tensor:
    return Q80Tensor(q=torch.from_numpy(np.ascontiguousarray(q)),
                     scales=torch.from_numpy(np.ascontiguousarray(s)),
                     group_size=gs)


def q80_from_q8_0(t: GGUFTensor) -> Q80Tensor:
    inn = t.shape[-1]
    out = int(np.prod(t.shape[:-1]))
    blk = t.blocks(_Q8_0_BLOCK)
    return _q80(blk["qs"].reshape(out, inn),
                blk["d"].astype(np.float32).reshape(out, inn // 32), 32)


def q80_from_q6_k(t: GGUFTensor) -> Q80Tensor:
    inn = t.shape[-1]
    out = int(np.prod(t.shape[:-1]))
    blk = t.blocks(_Q6_K_BLOCK)
    d = blk["d"].astype(np.float32)
    q = (_q6_values(blk).astype(np.int8) - 32).reshape(out, inn)
    # the scales are in value order: within a half, consecutive 16-value
    # groups take sc[0..7] in sequence
    sc = blk["scales"].astype(np.float32)                # (N, 16)
    return _q80(q, (d[:, None] * sc).reshape(out, inn // 16), 16)


def q4k_from_q4_k(t: GGUFTensor) -> Q4KTensor:
    inn = t.shape[-1]
    out = int(np.prod(t.shape[:-1]))
    blk = t.blocks(_Q4_K_BLOCK)
    d = blk["d"].astype(np.float32)
    dmin = blk["dmin"].astype(np.float32)
    sc, mn = _q4k_scale_min(blk["scales"])
    scales = (d[:, None] * sc).reshape(out, inn // 32)
    biases = (dmin[:, None] * mn).reshape(out, inn // 32)
    qs = blk["qs"].reshape(-1, 4, 32)
    vals = np.empty((blk.shape[0], 8, 32), np.uint8)
    vals[:, 0::2] = qs & 0x0F            # group 2j: the low nibbles
    vals[:, 1::2] = qs >> 4              # group 2j+1: the high nibbles
    # the packed layout: byte g*16+j = value g*32+j | value g*32+16+j << 4
    v = vals.reshape(out, inn // 32, 2, 16)
    packed = (v[:, :, 0, :] | (v[:, :, 1, :] << 4)).reshape(out, inn // 2)
    return Q4KTensor(packed=torch.from_numpy(packed),
                     scales=torch.from_numpy(scales),
                     biases=torch.from_numpy(biases), in_dim=inn)


def q4k_from_q4_0(t: GGUFTensor) -> Q4KTensor:
    """Q4_0's nibble layout (the low nibbles are values 0..15 of byte j,
    the high ones 16..31) is byte for byte the packed group layout: the
    qs bytes pass through."""
    inn = t.shape[-1]
    out = int(np.prod(t.shape[:-1]))
    blk = t.blocks(_Q4_0_BLOCK)
    scales = blk["d"].astype(np.float32).reshape(out, inn // 32)
    packed = np.ascontiguousarray(blk["qs"]).reshape(out, inn // 2)
    return Q4KTensor(packed=torch.from_numpy(packed),
                     scales=torch.from_numpy(scales),
                     biases=torch.from_numpy(8.0 * scales), in_dim=inn)


def _our_q4k_requant(dense: np.ndarray) -> Q4KTensor:
    """f32 (out, in) -> Q4KTensor through the C engine's Q4K quantizer
    (the unification of a mixed-type layer stack)."""
    blocks = q4k_mod.quantize_lines_np(np.ascontiguousarray(dense,
                                                            np.float32))
    return Q4KTensor.from_blocks(blocks, dense.shape[0], dense.shape[1])


def _rope_row_perm(out: int, n_heads: int, D: int) -> np.ndarray:
    """The row-index permutation that rope_permute_reverse applies."""
    idx = np.empty(D, np.int64)
    idx[0::2] = np.arange(D // 2)
    idx[1::2] = np.arange(D // 2) + D // 2
    return (np.arange(n_heads)[:, None] * D + idx[None, :]).reshape(-1)


def _permute_rows(leaf, perm: np.ndarray):
    """Permute the output rows of a quantized leaf (Qwen2's q/k RoPE
    re-layout, without dequantizing)."""
    p = torch.from_numpy(perm)
    if isinstance(leaf, Q80Tensor):
        return Q80Tensor(q=leaf.q[p], scales=leaf.scales[p],
                         group_size=leaf.group_size)
    if isinstance(leaf, Q4KTensor):
        return Q4KTensor(packed=leaf.packed[p], scales=leaf.scales[p],
                         biases=leaf.biases[p], in_dim=leaf.in_dim)
    return np.asarray(leaf)[perm]


_GGUF_NAMES = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v",
               "wo": "attn_output", "w1": "ffn_gate", "w2": "ffn_down",
               "w3": "ffn_up"}

_LEAF_OF = {GGML_Q8_0: q80_from_q8_0, GGML_Q4_K: q4k_from_q4_k,
            GGML_Q6_K: q80_from_q6_k, GGML_Q4_0: q4k_from_q4_0}


def _leaf(t: GGUFTensor):
    fn = _LEAF_OF.get(t.ggml_type)
    return None if fn is None else fn(t)


def _kind(x) -> Tuple[str, Optional[int]]:
    # the group size is part of the kind: Q8_0 (gs 32) and Q6_K (gs 16)
    # both map to Q80Tensor but cannot stack
    return type(x).__name__, getattr(x, "group_size", None)


def quantized_device_params(g: GGUFFile, cfg: ModelConfig, arch: str,
                            device=None) -> Dict[str, Any]:
    """GGUF tensors -> device params with the block products kept
    quantized (stacked, contiguous Q80 / Q4K tensors; norms and biases
    f32), built on the host and moved to `device` once.  The head follows
    the .bin loader's rules (``binfmt._maybe_int8_layout``,
    ``binfmt.q4k_head_requant``): a tied Q4K-family head is requantized on
    the host to a Q80 ``output_q``."""
    L = cfg.n_layer
    # Qwen2 runs interleaved-pair RoPE: permute the q/k output rows in
    # quantized form (a row permutation commutes with per-row groups)
    pq = _rope_row_perm(cfg.n_head * cfg.head_dim, cfg.n_head, cfg.head_dim)
    pk = _rope_row_perm(cfg.n_kv_head * cfg.head_dim, cfg.n_kv_head,
                        cfg.head_dim)
    row_perm = {"wq": pq, "wk": pk} if arch == "qwen2" else {}

    blocks: Dict[str, Any] = {}
    for ours, theirs in _GGUF_NAMES.items():
        ts = [g.tensors[f"blk.{i}.{theirs}.weight"] for i in range(L)]
        leaves = [_leaf(t) for t in ts]
        if None in leaves or len({_kind(x) for x in leaves}) > 1:
            leaves = [_our_q4k_requant(t.to_f32().reshape(-1, t.shape[-1]))
                      for t in ts]
        if ours in row_perm:
            leaves = [_permute_rows(x, row_perm[ours]) for x in leaves]
        if isinstance(leaves[0], Q80Tensor):
            st = Q80Tensor(q=torch.stack([x.q for x in leaves]),
                           scales=torch.stack([x.scales for x in leaves]),
                           group_size=leaves[0].group_size)
        else:
            st = Q4KTensor.stack(leaves)
        blocks[ours] = st.to(device)

    def f32(name):
        return torch.from_numpy(np.array(g.tensors[name].to_f32()))

    def stack_f32(fmt, perm=None):
        vs = [f32(fmt.format(i)) for i in range(L)]
        if perm is not None:
            vs = [v[torch.from_numpy(perm)] for v in vs]
        return torch.stack(vs).to(device)

    blocks["attn_norm"] = stack_f32("blk.{}.attn_norm.weight")
    blocks["ffn_norm"] = stack_f32("blk.{}.ffn_norm.weight")
    if arch == "qwen3":
        blocks["q_norm"] = stack_f32("blk.{}.attn_q_norm.weight")
        blocks["k_norm"] = stack_f32("blk.{}.attn_k_norm.weight")
    else:
        blocks["bq"] = stack_f32("blk.{}.attn_q.bias", pq)
        blocks["bk"] = stack_f32("blk.{}.attn_k.bias", pk)
        blocks["bv"] = stack_f32("blk.{}.attn_v.bias")

    params: Dict[str, Any] = {"norm": f32("output_norm.weight").to(device),
                              "blocks": blocks}
    emb = g.tensors["token_embd.weight"]
    emb_leaf = _leaf(emb)
    params["tok_embeddings"] = (
        emb_leaf if emb_leaf is not None
        else torch.from_numpy(np.array(emb.to_f32()))).to(device)
    if not cfg.tie_embeddings:
        out = g.tensors["output.weight"]
        out_leaf = _leaf(out)
        params["output"] = (
            out_leaf if out_leaf is not None
            else torch.from_numpy(np.ascontiguousarray(out.to_f32().T))
        ).to(device)
    elif isinstance(params["tok_embeddings"], Q4KTensor):
        # a tied Q4K-family head: requantized on the host from the file's
        # values to Q80 rows at the largest group size in (256 .. 32) that
        # divides E; the packed table itself when none does
        dense = emb.to_f32()
        V, E = dense.shape
        divisors = [gs for gs in (256, 128, 64, 32) if E % gs == 0]
        if divisors:
            gs = max(divisors)
            q, scales = binfmt.quantize_q80(dense, gs)
            params["output_q"] = Q80Tensor(
                q=torch.from_numpy(q.reshape(V, E)).to(device),
                scales=torch.from_numpy(scales.reshape(V, E // gs)).to(device),
                group_size=gs, w8a8=gs >= MIN_W8A8_GS)
        else:
            params["output_q"] = params["tok_embeddings"]
    binfmt._maybe_int8_layout(params)
    return params


# =====================================================================
# writer (f32 / f16 / q8_0)
# =====================================================================

def quantize_q8_0(x: np.ndarray) -> bytes:
    """ggml Q8_0 blocks for a flat f32 array (a multiple of 32): per
    block d = max|x| / 127 rounded to f16, q = round(x / d)."""
    x = np.asarray(x, np.float32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1)
    d = (amax / 127.0).astype(np.float16)
    inv = np.where(d > 0, 1.0 / d.astype(np.float32), 0.0)
    q = np.clip(np.rint(x * inv[:, None]), -128, 127).astype(np.int8)
    blk = np.empty(x.shape[0], dtype=_Q8_0_BLOCK)
    blk["d"] = d
    blk["qs"] = q
    return blk.tobytes()


def _meta_bytes(key: str, vtype: int, value) -> bytes:
    out = [struct.pack("<Q", len(key.encode())), key.encode(),
           struct.pack("<I", vtype)]
    if vtype == _STR:
        b = value.encode("utf-8")
        out += [struct.pack("<Q", len(b)), b]
    elif vtype == _ARR:
        etype, elems = value
        out.append(struct.pack("<IQ", etype, len(elems)))
        for e in elems:
            if etype == _STR:
                b = e.encode("utf-8")
                out += [struct.pack("<Q", len(b)), b]
            else:
                out.append(struct.pack(_SCALAR[etype][0], e))
    elif vtype == _BOOL:
        out.append(struct.pack("<B", int(value)))
    else:
        out.append(struct.pack(_SCALAR[vtype][0], value))
    return b"".join(out)


def write_gguf(path: str, params: Dict[str, Any], cfg: ModelConfig,
               tokenizer, arch: str = "qwen3",
               quant: str = "q8_0") -> None:
    """Write params in the checkpoint layout (stacked per-layer blocks,
    (in, out) matrices; numpy arrays or tensors) as a GGUF file llama.cpp
    can load.  quant: f32 | f16 | q8_0 for the matrices; norms and biases
    stay f32.  `tokenizer` is a BpeTokenizer (``_tokenizer_lists``)."""
    wq = {"f32": GGML_F32, "f16": GGML_F16, "q8_0": GGML_Q8_0}[quant]
    tensors: List[Tuple[str, np.ndarray, int]] = []

    def add(name, w, t=None):
        w = binfmt._f32(w)
        if t is None:
            t = wq if w.ndim >= 2 and w.size % 32 == 0 else GGML_F32
        tensors.append((name, w, t))

    blocks = {k: binfmt._f32(v) for k, v in params["blocks"].items()}
    D = cfg.head_dim
    qwen2 = arch == "qwen2"

    def unstackT(w, i):
        return np.ascontiguousarray(w[i].T)

    def unpermute(w, n_heads):
        """Inverse of rope_permute_reverse: interleaved-pair rows back to
        the HF/GGUF rotate-half layout (Qwen2 q/k only)."""
        out = np.asarray(w, np.float32).reshape(n_heads, D, *w.shape[1:])
        idx = np.empty(D, np.int64)
        idx[np.arange(D // 2)] = 2 * np.arange(D // 2)
        idx[np.arange(D // 2) + D // 2] = 2 * np.arange(D // 2) + 1
        return out[:, idx].reshape(w.shape)

    add("token_embd.weight", params["tok_embeddings"])
    add("output_norm.weight", params["norm"], GGML_F32)
    if "output" in params:
        add("output.weight", binfmt._f32(params["output"]).T)
    for i in range(cfg.n_layer):
        add(f"blk.{i}.attn_norm.weight", blocks["attn_norm"][i], GGML_F32)
        add(f"blk.{i}.ffn_norm.weight", blocks["ffn_norm"][i], GGML_F32)
        wq_l, wk_l = unstackT(blocks["wq"], i), unstackT(blocks["wk"], i)
        if qwen2:
            wq_l = unpermute(wq_l, cfg.n_head)
            wk_l = unpermute(wk_l, cfg.n_kv_head)
        add(f"blk.{i}.attn_q.weight", wq_l)
        add(f"blk.{i}.attn_k.weight", wk_l)
        add(f"blk.{i}.attn_v.weight", unstackT(blocks["wv"], i))
        add(f"blk.{i}.attn_output.weight", unstackT(blocks["wo"], i))
        add(f"blk.{i}.ffn_gate.weight", unstackT(blocks["w1"], i))
        add(f"blk.{i}.ffn_down.weight", unstackT(blocks["w2"], i))
        add(f"blk.{i}.ffn_up.weight", unstackT(blocks["w3"], i))
        if "q_norm" in blocks:
            add(f"blk.{i}.attn_q_norm.weight", blocks["q_norm"][i], GGML_F32)
            add(f"blk.{i}.attn_k_norm.weight", blocks["k_norm"][i], GGML_F32)
        if "bq" in blocks:
            bq_l, bk_l = blocks["bq"][i], blocks["bk"][i]
            if qwen2:
                bq_l = unpermute(bq_l, cfg.n_head)
                bk_l = unpermute(bk_l, cfg.n_kv_head)
            add(f"blk.{i}.attn_q.bias", bq_l, GGML_F32)
            add(f"blk.{i}.attn_k.bias", bk_l, GGML_F32)
            add(f"blk.{i}.attn_v.bias", blocks["bv"][i], GGML_F32)

    tokens, merges = _tokenizer_lists(tokenizer, cfg.vocab_size)
    meta = [
        ("general.architecture", _STR, arch),
        ("general.name", _STR, "nano_tpu export"),
        (f"{arch}.block_count", _U32, cfg.n_layer),
        (f"{arch}.context_length", _U32, cfg.block_size),
        (f"{arch}.embedding_length", _U32, cfg.n_embd),
        (f"{arch}.feed_forward_length", _U32, cfg.n_hidden),
        (f"{arch}.attention.head_count", _U32, cfg.n_head),
        (f"{arch}.attention.head_count_kv", _U32, cfg.n_kv_head),
        (f"{arch}.attention.key_length", _U32, cfg.head_dim),
        (f"{arch}.attention.value_length", _U32, cfg.head_dim),
        (f"{arch}.attention.layer_norm_rms_epsilon", _F32, cfg.norm_eps),
        (f"{arch}.rope.freq_base", _F32, cfg.rope_theta),
        ("tokenizer.ggml.model", _STR, "gpt2"),
        ("tokenizer.ggml.tokens", _ARR, (_STR, tokens)),
        ("tokenizer.ggml.merges", _ARR, (_STR, merges)),
    ]

    align = 32
    payloads, infos = [], []
    off = 0
    for name, w, t in tensors:
        if t == GGML_F32:
            raw = w.astype("<f4").tobytes()
        elif t == GGML_F16:
            raw = w.astype("<f2").tobytes()
        else:
            raw = quantize_q8_0(w.reshape(-1))
        infos.append((name, list(reversed(w.shape)), t, off))
        payloads.append(raw)
        off += (len(raw) + align - 1) // align * align

    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", GGUF_MAGIC, 3, len(tensors), len(meta)))
        for key, vtype, val in meta:
            f.write(_meta_bytes(key, vtype, val))
        for name, ne, t, o in infos:
            b = name.encode()
            f.write(struct.pack("<Q", len(b)) + b)
            f.write(struct.pack("<I", len(ne)))
            for d in ne:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<IQ", t, o))
        pos = f.tell()
        f.write(b"\0" * ((pos + align - 1) // align * align - pos))
        for raw in payloads:
            f.write(raw)
            f.write(b"\0" * ((len(raw) + align - 1) // align * align
                             - len(raw)))


def _tokenizer_lists(tokenizer, vocab_size: int
                     ) -> Tuple[List[str], List[str]]:
    """(printable tokens, merges) for the GGUF metadata: the raw byte
    vocab re-encoded through the GPT-2 printable map, and a merge list
    rebuilt from the pair scores (llama.cpp needs merges only to encode)."""
    enc = gpt2_bytes_to_unicode()
    toks = getattr(tokenizer, "vocab", None)
    if toks is None:
        raise ValueError("tokenizer must be a BpeTokenizer")
    printable = ["".join(enc[b] for b in t) for t in toks]
    printable += [""] * (vocab_size - len(printable))
    pair = getattr(tokenizer, "_pair_merge", {})
    ranked = sorted(((score, l, r) for (l, r), (score, _m) in pair.items()),
                    reverse=True)
    merges = [f"{printable[l]} {printable[r]}" for _score, l, r in ranked]
    return printable, merges
