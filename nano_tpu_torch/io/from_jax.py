"""Carry the JAX package's parameters across to the port.

``params_from_jax(tree)`` takes a ``nano_tpu`` params tree whose leaves
are numpy arrays (or anything ``np.asarray`` reads) and returns the
port's params, so both compute the same function.  The JAX ``Q80Tensor``
is recognised by its fields (``q``, ``scales``, ``group_size``,
``layout``) — this module imports neither ``jax`` nor ``nano_tpu``.  A
grouped ``(..., G, out, gs)`` tensor (the TPU's int8 layout) goes back to
the file's ``(..., out, in)`` rows and takes the W8A8 form; a rows tensor
takes the f32 rows form.  An ``output_q`` head that holds the same values
as a Q80 embedding table shares its storage.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nano_tpu_torch import resolve_device
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


def _convert(x, device):
    if isinstance(x, dict):
        return {k: _convert(v, device) for k, v in x.items()}
    if hasattr(x, "packed"):
        raise NotImplementedError("Q4K tensors are not ported yet")
    if all(hasattr(x, a) for a in ("q", "scales", "group_size")):
        return _q80(x, device)
    return _tensor(x, device)


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """nano_tpu params (numpy leaves) -> nano_tpu_torch params on
    `device` (cuda unless asked otherwise)."""
    params = _convert(tree, resolve_device(device))
    tok, head = params.get("tok_embeddings"), params.get("output_q")
    if (isinstance(tok, Q80Tensor) and isinstance(head, Q80Tensor)
            and tok.q.shape == head.q.shape
            and torch.equal(tok.q, head.q)
            and torch.equal(tok.scales, head.scales)):
        tok.w8a8 = head.w8a8
        params["output_q"] = tok
    return params
