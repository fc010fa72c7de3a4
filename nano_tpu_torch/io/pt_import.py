"""Import reference PyTorch ``.pt`` checkpoints.

Port of ``nano_tpu/io/pt_import.py``.  The reference saves self-contained checkpoints (reference: train.py:402-427):
``{version, is_lora, model|lora (state_dict), optimizer, step_count,
train_config, model_config, tokenizer_config}`` with the two configs
pickled as dataclass instances of the reference's own classes.  This
reader unpickles them through a shim (no reference code on the import
path, and an allowlist of tensor internals: a ``.pt`` is a pickle), maps
the module-qualified state-dict names to the stacked checkpoint layout,
and hands back arrays for the trainer, the engine or the ``.bin`` writer.

State-dict name map (reference model.py:311-348):
    tok_embeddings.weight            -> tok_embeddings (V, E)
    wpe.weight                       -> wpe (T, E)          [use_rope=False]
    layers.{i}.attention_norm.weight -> blocks.attn_norm[L]
    layers.{i}.ffn_norm.weight       -> blocks.ffn_norm[L]
    layers.{i}.attention.w{q,k,v,o}.weight -> blocks.w* (L, in, out)
    layers.{i}.feed_forward.w{1,2,3}.weight -> blocks.w* (L, in, out)
    norm.weight                      -> norm (E,)
    output.weight                    -> ignored when tied (model.py:348)
LoRA checkpoints wrap the linears (model.py:419-430), so base keys gain
a ``.w.`` segment and adapters appear as ``.lora_a/.lora_b``; their
import target (``import_lora``) is the stacked adapter {wq_a (L, E, r),
wq_b (L, r, out), ...}.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nano_tpu_torch.config import ModelConfig, TrainConfig
from nano_tpu_torch.io import binfmt
from nano_tpu_torch.io import checkpoint as ckpt_io


class _ConfigShim:
    """Stand-in for the reference's pickled ModelConfig/TrainConfig
    dataclass instances: captures attributes, nothing else."""

    def __init__(self, *args, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}


class _ShimPickleModule:
    """pickle-compatible module for torch.load: reference config classes
    resolve to the shim; everything else resolves normally."""

    Unpickler = None        # set below

    # torch's LEGACY (pre-1.6, non-zip) format calls pickle_module.load /
    # loads directly — those must go through the restricted unpickler too
    # or the allowlist is bypassed entirely for legacy files
    @staticmethod
    def load(f, **kw):
        return _ShimUnpickler(f, **kw).load()

    @staticmethod
    def loads(b, **kw):
        return _ShimUnpickler(io.BytesIO(b), **kw).load()


#: (module, name) pairs allowed through the unpickler beyond the
#: torch/numpy internals a tensor checkpoint legitimately references.
_ALLOWED_GLOBALS = {
    ("collections", "OrderedDict"),
    ("collections", "defaultdict"),
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "slice"),
    ("builtins", "complex"),
    ("builtins", "bytearray"),
}


class _ShimUnpickler(pickle.Unpickler):
    """Unpickler restricted to tensor-checkpoint globals.

    A ``.pt`` is a pickle, and pickle resolves arbitrary callables — so
    ``find_class`` only admits torch/numpy internals (storage + tensor
    rebuild helpers, dtypes) and plain containers, and raises on
    anything else.  Reference config dataclasses resolve to the
    attribute-capturing shim by NAME (the reference pickles them under
    whatever module train.py ran as: "model", "__main__", ...).
    """

    def find_class(self, module: str, name: str):
        if name in ("ModelConfig", "TrainConfig"):
            return _ConfigShim
        if (module, name) in _ALLOWED_GLOBALS:
            return super().find_class(module, name)
        # torch/numpy internals, resolve-then-type-check: a bare module
        # prefix trust would admit code-executing callables (torch.hub.
        # load, numpy.load, ...).  Resolving a global never calls it.
        if module == "torch._utils" and name.startswith("_rebuild_"):
            return super().find_class(module, name)
        if module == "torch":
            obj = super().find_class(module, name)
            if (isinstance(obj, torch.dtype) or name in ("Size", "Tensor")
                    or (isinstance(obj, type) and name.endswith("Storage"))):
                return obj
        elif module in ("torch.storage",):
            if name in ("TypedStorage", "_TypedStorage", "UntypedStorage"):
                return super().find_class(module, name)
        elif module in ("numpy.core.multiarray", "numpy._core.multiarray"):
            if name in ("_reconstruct", "scalar"):
                return super().find_class(module, name)
        elif module == "numpy":
            obj = super().find_class(module, name)
            if obj is np.ndarray or obj is np.dtype or (
                    isinstance(obj, type) and issubclass(obj, np.generic)):
                return obj
        elif module == "numpy.dtypes":
            # numpy>=1.25 dtype classes (the module holds nothing else)
            return super().find_class(module, name)
        elif module in ("numpy.core.numeric", "numpy._core.numeric"):
            if name == "_frombuffer":
                return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: .pt checkpoints may "
            "only reference torch/numpy tensor internals and plain "
            "containers")


_ShimPickleModule.Unpickler = _ShimUnpickler


def load_pt(path: str) -> Dict[str, Any]:
    """Raw reference checkpoint dict; tensors stay torch (CPU)."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_ShimPickleModule)


def _np(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().to("cpu").float().numpy())


def _strip(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop torch.compile's _orig_mod. prefix (reference export.py:487-491)
    and non-parameter buffers (attention masks / rope caches)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("_orig_mod."):
            k = k[len("_orig_mod."):]
        if k.endswith((".mask", ".cache_k", ".cache_v")) or \
                "freqs_" in k:
            continue
        out[k] = v
    return out


def _model_config(ck: Dict[str, Any]) -> ModelConfig:
    mc = ck["model_config"]
    d = mc.to_dict() if isinstance(mc, _ConfigShim) else dict(mc)
    return ModelConfig.from_dict(d)


def import_checkpoint(path: str) -> Tuple[ModelConfig, Dict[str, Any],
                                          Optional[dict], int, dict]:
    """.pt -> (ModelConfig, params pytree in our layout,
    tokenizer_config|None, step, train_config dict)."""
    ck = load_pt(path)
    if ck.get("is_lora"):
        raise ValueError("LoRA checkpoint: use import_lora() with the "
                         "base model's config")
    cfg = _model_config(ck)
    sd = _strip(ck["model"])
    L = cfg.n_layer

    def stack(fmt: str, transpose: bool) -> np.ndarray:
        mats = []
        for l in range(L):
            w = _np(sd[fmt.format(l)])
            mats.append(np.ascontiguousarray(w.T) if transpose else w)
        return np.stack(mats)

    blocks: Dict[str, Any] = {
        "attn_norm": stack("layers.{}.attention_norm.weight", False),
        "ffn_norm": stack("layers.{}.ffn_norm.weight", False),
    }
    # torch Linear stores (out, in); ours is (in, out)
    for ours, theirs in (("wq", "attention.wq"), ("wk", "attention.wk"),
                         ("wv", "attention.wv"), ("wo", "attention.wo"),
                         ("w1", "feed_forward.w1"),
                         ("w2", "feed_forward.w2"),
                         ("w3", "feed_forward.w3")):
        blocks[ours] = stack("layers.{}.%s.weight" % theirs, True)

    params: Dict[str, Any] = {
        "tok_embeddings": _np(sd["tok_embeddings.weight"]),
        "norm": _np(sd["norm.weight"]),
        "blocks": blocks,
    }
    if "wpe.weight" in sd:
        params["wpe"] = _np(sd["wpe.weight"])
    if not cfg.tie_embeddings and "output.weight" in sd:
        params["output"] = np.ascontiguousarray(_np(sd["output.weight"]).T)

    tok_cfg = ck.get("tokenizer_config")
    tc = ck.get("train_config")
    tc_dict = (tc.to_dict() if isinstance(tc, _ConfigShim)
               else dict(tc) if isinstance(tc, dict) else {})
    return cfg, params, tok_cfg, int(ck.get("step_count", 0)), tc_dict


def import_lora(path: str, cfg: ModelConfig
                ) -> Tuple[Dict[str, Any], int, int]:
    """LoRA .pt -> (the stacked adapter in the (L, in, out) layout, rank,
    alpha) for the base model `cfg`."""
    ck = load_pt(path)
    if not ck.get("is_lora"):
        raise ValueError("not a LoRA checkpoint")
    sd = _strip(ck["lora"])
    tc = ck.get("train_config")
    tc_d = tc.to_dict() if isinstance(tc, _ConfigShim) else dict(tc or {})
    rank = int(tc_d.get("lora_rank", 16))
    alpha = int(tc_d.get("lora_alpha", 32))
    lora: Dict[str, Any] = {}
    for proj in ("wq", "wk", "wv", "wo"):
        for ab in ("a", "b"):
            lora[f"{proj}_{ab}"] = np.stack([
                np.ascontiguousarray(_np(sd[
                    f"layers.{l}.attention.{proj}.lora_{ab}.weight"]).T)
                for l in range(cfg.n_layer)])
    return lora, rank, alpha


def pt_to_npz(pt_path: str, npz_path: str) -> ModelConfig:
    """Convert a reference full checkpoint to the .npz schema."""
    cfg, params, tok_cfg, step, tc = import_checkpoint(pt_path)
    ckpt_io.save_checkpoint(npz_path, params=params, step=step,
                            model_config=cfg.to_dict(),
                            train_config=TrainConfig.from_dict(tc).to_dict(),
                            tokenizer_config=tok_cfg)
    return cfg


def pt_to_bin(pt_path: str, bin_path: str, quant: str = "f32",
              group_size: int = 256) -> ModelConfig:
    """Convert a reference full checkpoint straight to .bin."""
    cfg, params, tok_cfg, _step, _tc = import_checkpoint(pt_path)
    if tok_cfg is None:
        raise ValueError(".pt has no embedded tokenizer_config; convert "
                         "to .npz and supply a tokenizer instead")
    binfmt.write_model(bin_path, params, cfg, tok_cfg, quant=quant,
                       group_size=group_size)
    return cfg
