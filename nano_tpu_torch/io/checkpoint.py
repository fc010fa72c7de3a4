"""Checkpoint save/load — self-contained, resumable.

Port of ``nano_tpu/io/checkpoint.py``: one ``.npz`` holding the model
params and / or a LoRA adapter, optimizer state, step count, both configs
and the full tokenizer config, with JSON metadata under ``__meta__``.

The ``model/…`` and ``lora/…`` keys, their arrays and the metadata are the
JAX package's (nested dict paths joined by ``/``; a bf16 leaf stored as a
uint16 view under its key suffixed ``::bfloat16``), so the **params** and
the **adapter** of a checkpoint written by either package load in the
other; a LoRA fine-tune's checkpoint holds the adapter alone
(``is_lora``, no ``model/…``).  The optimizer state is this
package's own flat layout under ``opt/…`` (``opt/count``, ``opt/mu/<path>``,
``opt/nu/<path>``): optax's state tree has no counterpart here, so a
checkpoint resumes training only in the package that wrote it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

VERSION = "nano-tpu-2026.08"

_META_KEY = "__meta__"
_DTYPE_SEP = "::"
_BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    """Nested dict of tensors (or arrays) -> {path key: numpy array}, keys
    sorted within each dict as ``jax.tree_util`` orders them."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}/{k}"))
        return flat
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[prefix + _DTYPE_SEP + _BF16] = (
                t.contiguous().view(torch.int16).numpy().view(np.uint16))
        else:
            flat[prefix] = t.numpy()
        return flat
    flat[prefix] = np.asarray(tree)
    return flat


def _unflatten(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """{"<prefix>/a/b": array} -> {"a": {"b": CPU tensor in the stored
    type}}: the nesting is read from the keys themselves."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        path, _, ext = key[len(prefix) + 1:].partition(_DTYPE_SEP)
        if ext == _BF16:
            leaf = torch.from_numpy(np.array(arr).view(np.int16)).view(
                torch.bfloat16)
        elif ext:
            raise ValueError(f"checkpoint leaf {key} has the unknown type "
                             f"{ext!r}")
        else:
            leaf = torch.from_numpy(np.array(arr))
        *parents, name = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def _paths(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def save_checkpoint(path: str, *, params: Any = None, lora: Any = None,
                    opt_state: Any = None, step: int = 0,
                    model_config: Optional[dict] = None,
                    train_config: Optional[dict] = None,
                    tokenizer_config: Optional[dict] = None,
                    extra: Optional[dict] = None) -> None:
    arrays: Dict[str, np.ndarray] = {}
    if params is not None:
        arrays.update(_flatten(params, "model"))
    if lora is not None:
        arrays.update(_flatten(lora, "lora"))
    if opt_state is not None:
        arrays.update(_flatten(opt_state, "opt"))
    meta = {
        "version": VERSION,
        "is_lora": lora is not None,
        "step_count": int(step),
        "model_config": model_config,
        "train_config": train_config,
        "tokenizer_config": tokenizer_config,
        "extra": extra or {},
    }
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp.npz"          # atomic-ish write
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


class Checkpoint:
    """Lazy checkpoint reader."""

    def __init__(self, path: str):
        self._npz = np.load(path)
        self.meta = json.loads(bytes(self._npz[_META_KEY]).decode("utf-8"))

    @property
    def step(self) -> int:
        return self.meta["step_count"]

    @property
    def is_lora(self) -> bool:
        return self.meta["is_lora"]

    @property
    def model_config(self) -> Optional[dict]:
        return self.meta["model_config"]

    @property
    def train_config(self) -> Optional[dict]:
        return self.meta["train_config"]

    @property
    def tokenizer_config(self) -> Optional[dict]:
        return self.meta["tokenizer_config"]

    def _collect(self, prefix: str) -> Dict[str, np.ndarray]:
        return {key: self._npz[key] for key in self._npz.files
                if key.startswith(prefix + "/")}

    def load_params(self) -> Dict[str, Any]:
        return _unflatten(self._collect("model"), "model")

    def load_lora(self) -> Dict[str, Any]:
        """The adapter: {"wq_a": (L, in, r) CPU tensor, ...}."""
        return _unflatten(self._collect("lora"), "lora")

    def lora_rank_alpha(self) -> Tuple[int, int]:
        """The adapter's (rank, alpha), from the train config (the
        reference's defaults 16 and 32 where it has none)."""
        tc = self.train_config or {}
        return int(tc.get("lora_rank", 16)), int(tc.get("lora_alpha", 32))

    def load_opt_state(self) -> Dict[str, Any]:
        """{"count", "mu": {<path>: tensor}, "nu": {...}} with the
        optimizer's flat path names."""
        state = _unflatten(self._collect("opt"), "opt")
        return {"count": state["count"], "mu": dict(_paths(state["mu"])),
                "nu": dict(_paths(state["nu"]))}

    def has(self, prefix: str) -> bool:
        return any(k.startswith(prefix + "/") for k in self._npz.files)
