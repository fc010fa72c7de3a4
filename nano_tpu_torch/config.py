"""Model configuration: the port's own copy of ``nano_tpu.config.ModelConfig``.

Same fields, defaults and JSON loading (config/model_*.json), kept here
so the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (reference: model.py:19-32)."""

    block_size: int = 512
    vocab_size: int = 16384
    n_layer: int = 8
    n_embd: int = 512
    n_head: int = 16
    n_kv_head: Optional[int] = None
    n_hidden: Optional[int] = None
    dropout: float = 0.0
    use_rope: bool = True
    norm_eps: float = 1e-5
    is_causal: bool = True

    rope_theta: float = 10000.0
    # "interleaved": adjacent (2i, 2i+1) pairs rotate together (Nano/Qwen2).
    # "half": first/second half pairs (Qwen3/HF).
    rope_style: str = "interleaved"
    # Qwen3-style per-head q/k RMSNorm and explicit head_dim
    head_dim: Optional[int] = None
    use_qk_norm: bool = False
    qkv_bias: bool = False          # Qwen2 has attention biases
    tie_embeddings: bool = True

    def __post_init__(self) -> None:
        if self.n_kv_head is None:
            object.__setattr__(self, "n_kv_head", self.n_head)
        if self.n_hidden is None:
            # SwiGLU hidden default: 8/3 * n_embd rounded up to 256
            object.__setattr__(self, "n_hidden",
                               _round_up(int(8 * self.n_embd / 3), 256))
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.n_embd // self.n_head)
        if self.n_embd % self.n_head or self.n_head % self.n_kv_head:
            raise ValueError(
                f"n_embd={self.n_embd}, n_head={self.n_head} and "
                f"n_kv_head={self.n_kv_head} do not divide")

    @property
    def n_rep(self) -> int:
        return self.n_head // self.n_kv_head

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, path: str) -> "ModelConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
