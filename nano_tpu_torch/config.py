"""Model and training configuration: the port's own copies of
``nano_tpu.config.ModelConfig`` and ``TrainConfig``.

Same fields, defaults and JSON loading (config/model_*.json,
config/pretrain.json), kept here so the port never imports the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import List, Optional


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


@dataclass
class TrainConfig:
    """Training hyperparameters (reference: model.py:35-85).

    Unknown JSON keys are dropped, so the JAX package's and the reference's
    config files load as they are.
    """

    dropout: float = 0.0

    # AdamW
    learning_rate: float = 6e-4
    weight_decay: float = 1e-1
    beta1: float = 0.9
    beta2: float = 0.99

    # LR schedule (cosine with warmup)
    decay_lr: bool = True
    warmup_iters: int = 300
    lr_decay_iters: int = 100000
    min_lr: float = 6e-5

    # LoRA
    use_lora: bool = False
    lora_rank: int = 16
    lora_alpha: int = 32
    lora_dropout: float = 0.0

    # Task / paths
    from_checkpoint: str = ""
    save_checkpoint_to: str = ""
    dataset_path: Optional[List[List[str]]] = None
    tokenizer_path: str = ""

    batch_size: int = 128
    gradient_accumulation_steps: int = 4
    grad_clip: float = 1.0

    random_seed: int = 114514
    eval_interval: int = 100
    log_interval: int = 1
    eval_iters: int = 5

    # Runtime fields of the reference's config files; kept so the files
    # load and a checkpoint's train_config round-trips, read by nothing
    backend: str = "jax"
    device: str = "tpu"
    sdp_kernel: str = "flash"
    dtype: str = "bfloat16"
    use_amp: bool = True

    mesh_shape: Optional[dict] = None     # {"data": D, "seq": Q, "pipe": P,
                                          # "model": M} over a torchrun
                                          # launch's ranks
                                          # (parallel/mesh.py)
    param_dtype: str = "float32"          # master weights
    remat: bool = False                   # recompute activations in backward
    remat_policy: str = "full"            # "full" | "ffn" | "dots" | "heads"
                                          # (models/gpt.py _SAVED_OPS)
    ce_chunk: int = 0                     # chunked cross-entropy: the LM head
                                          # + CE over token chunks of this
                                          # size (0 = one shot)
    pp_microbatches: int = 0              # pipeline microbatches under
                                          # "pipe" (parallel/pipeline.py;
                                          # 0 = default_n_micro)
    adam_mu_dtype: Optional[str] = None   # Adam first-moment dtype
                                          # ("bfloat16" halves that buffer;
                                          # None = f32)
    max_resident_shards: Optional[int] = None
                                          # bound loaded data shards (LRU);
                                          # None = keep all once touched

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, path: str) -> "TrainConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
