"""Carry the JAX package's parameters across to the port.

``params_from_jax(tree)`` takes a ``nano_tpu`` params tree whose leaves
are numpy arrays (or anything ``np.asarray`` reads) and returns the
port's params, so both compute the same function.  The JAX ``Q80Tensor``
is recognised by its fields (``q``, ``scales``, ``group_size``,
``layout``) — this module imports neither ``jax`` nor ``nano_tpu``.  A
grouped ``(..., G, out, gs)`` tensor (the TPU's int8 layout) goes back to
the file's ``(..., out, in)`` rows and takes the W8A8 form; a rows tensor
takes the f32 rows form.  A JAX ``Q4KTensor`` (fields ``packed``,
``scales``, ``biases``, ``in_dim``, ``layout``) in the packed layout
carries across field for field; its ``unpacked`` and ``grouped`` layouts
are not ported.  An ``output_q`` head that holds the same values as the
embedding table shares its storage.  A dense f32 tree from
``gpt.init_params`` takes the same path; with ``trainable=True`` its
leaves require grad.  ``params_to_numpy`` is the way back.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nano_tpu_torch import resolve_device
from nano_tpu_torch.models.gpt import map_leaves
from nano_tpu_torch.ops.q4k import Q4KTensor
from nano_tpu_torch.ops.qmatmul import Q80Tensor


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch mapping
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _q80(t, device) -> Q80Tensor:
    q = np.asarray(t.q)
    layout = getattr(t, "layout", "rows")
    if layout == "grouped":
        # (..., G, out, gs) -> (..., out, G, gs) -> (..., out, in)
        q = np.moveaxis(q, -3, -2)
        q = q.reshape(*q.shape[:-2], -1)
    elif layout != "rows":
        raise ValueError(f"unknown Q80 layout {layout!r}")
    return Q80Tensor(q=_tensor(q, device), scales=_tensor(t.scales, device),
                     group_size=int(t.group_size),
                     w8a8=layout == "grouped")


def _q4k(t, device) -> Q4KTensor:
    layout = getattr(t, "layout", "packed")
    if layout != "packed":
        raise NotImplementedError(
            f"the JAX Q4K layout {layout!r} is not ported (packed only)")
    return Q4KTensor(packed=_tensor(t.packed, device),
                     scales=_tensor(t.scales, device),
                     biases=_tensor(t.biases, device), in_dim=int(t.in_dim))


def _same(a, b) -> bool:
    """Two weights of one kind holding the same values."""
    if isinstance(a, Q80Tensor) and isinstance(b, Q80Tensor):
        return (a.q.shape == b.q.shape and torch.equal(a.q, b.q)
                and torch.equal(a.scales, b.scales))
    if isinstance(a, Q4KTensor) and isinstance(b, Q4KTensor):
        return (a.packed.shape == b.packed.shape and a.in_dim == b.in_dim
                and torch.equal(a.packed, b.packed)
                and torch.equal(a.scales, b.scales)
                and torch.equal(a.biases, b.biases))
    return False


def _convert(x, device):
    if isinstance(x, dict):
        return {k: _convert(v, device) for k, v in x.items()}
    if hasattr(x, "packed"):
        return _q4k(x, device)
    if all(hasattr(x, a) for a in ("q", "scales", "group_size")):
        return _q80(x, device)
    return _tensor(x, device)


def params_from_jax(tree: Dict[str, Any], device=None,
                    trainable: bool = False) -> Dict[str, Any]:
    """nano_tpu params (numpy leaves) -> nano_tpu_torch params on
    `device` (cuda unless asked otherwise).  `trainable` marks every
    dense floating-point leaf as requiring grad."""
    params = _convert(tree, resolve_device(device))
    if trainable:
        params = map_leaves(
            lambda t: (t.requires_grad_(True)
                       if isinstance(t, torch.Tensor) and t.is_floating_point()
                       else t), params)
    tok, head = params.get("tok_embeddings"), params.get("output_q")
    if _same(tok, head):
        if isinstance(tok, Q80Tensor):
            tok.w8a8 = head.w8a8
        params["output_q"] = tok
    return params


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:           # numpy has no bf16 of its own
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Dense nano_tpu_torch params -> the same nested dict of numpy arrays
    (bf16 leaves as ``ml_dtypes.bfloat16``), as the JAX package takes
    them."""
    return map_leaves(_to_numpy, params)
