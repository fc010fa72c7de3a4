"""Pipeline-parallel training: a GPipe schedule over the "pipe" group.

Port of ``nano_tpu/parallel/pipeline.py``.  The layer stacks are cut on
their leading (layer) axis over "pipe": stage p holds layers
[p L / P, (p + 1) L / P) and its own copy of everything outside "blocks"
(embeddings, final norm, head, wpe).  A step runs M microbatches of the
rank's rows through the stages:

  * forward, microbatch by microbatch: stage 0 embeds, every stage runs
    its layers and sends its (mb, S, E) output to the next (``mesh.send``),
    and the last stage runs the final norm, the head and the CE (chunked
    with ``ce_chunk``), keeping its nll sum over the global mask sum;
  * backward, the microbatches in reverse: the last stage differentiates
    its loss, every stage sends the gradient of its input activation back
    a stage and the one before differentiates its output by it.

The JAX package writes the forward as a scan of M + P - 1 ticks under
``shard_map`` and gets this backward as the transpose of ``ppermute``;
here the schedule is written out, each stage keeping the autograd graph
of its M microbatches until the backward (GPipe's memory), and the
gradients of the replicated leaves are summed over "pipe" by the trainer
(``Trainer._reduce_grads``), as the shard_map transpose psums them.  Each
stage's layers run under the training forward's remat policy
(``gpt.run_blocks``).  The bubble is (P - 1) / (M + P - 1) of the step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.models import gpt
from nano_tpu_torch.parallel import mesh as meshlib


def pp_param_specs(params: Any) -> Any:
    """The dim each training leaf is cut on over "pipe": 0 (the layer
    axis) for every leaf under "blocks", None (whole on every stage) for
    the rest."""
    return {k: (gpt.map_leaves(lambda _: 0, v) if k == "blocks"
                else pp_param_specs(v) if isinstance(v, dict) else None)
            for k, v in params.items()}


def stage_layers(n_layer: int, n_pipe: int, stage: int) -> Tuple[int, int]:
    """The layers [lo, hi) of stage `stage`; n_layer must divide over
    n_pipe (``make_pp_loss`` asserts it)."""
    if n_layer % n_pipe:
        raise ValueError(f"n_layer={n_layer} does not divide over "
                         f"pipe={n_pipe}")
    per = n_layer // n_pipe
    return stage * per, (stage + 1) * per


def shard_params_pp(params: Any, mesh: meshlib.Mesh, n_layer: int) -> Any:
    """Training params -> this stage's leaves: the blocks cut to its layers
    (new leaves that require grad as the full ones did), the rest the same
    tensors."""
    lo, hi = stage_layers(n_layer, mesh.size(meshlib.PIPE_AXIS),
                          mesh.index(meshlib.PIPE_AXIS))

    def cut(t):
        with torch.no_grad():
            out = t.detach()[lo:hi].clone()
        return out.requires_grad_(t.requires_grad)
    out = dict(params)
    out["blocks"] = gpt.map_leaves(cut, params["blocks"])
    return out


def default_n_micro(n_pipe: int, batch_local: int) -> int:
    """2P microbatches (bubble < 1/3), clamped to what the local batch
    can supply; always a divisor of batch_local."""
    m = min(2 * n_pipe, batch_local)
    while batch_local % m != 0:
        m -= 1
    return max(m, 1)


def pp_step(params: Dict[str, Any], x: torch.Tensor, y: torch.Tensor,
            m: Optional[torch.Tensor], cfg: ModelConfig, mesh: meshlib.Mesh,
            denom: float, dtype=torch.bfloat16, n_micro: int = 0,
            remat: Union[bool, str] = False, ce_chunk: int = 0,
            backward: bool = True) -> torch.Tensor:
    """One GPipe pass of this rank's rows x, y, m (B_loc, S) through the
    stages, every stage of the rank's pipe group calling it alike:
    forward, then (with `backward`) the backward into the ``.grad`` of
    this stage's leaves.  `denom`: the mask sum of the whole global batch,
    which divides every microbatch's nll sum.  -> this rank's share of
    the loss (its nll sum over denom on the last stage, 0 on the others),
    detached; its sum over "pipe" and "data" is the loss."""
    P, p = mesh.size(meshlib.PIPE_AXIS), mesh.index(meshlib.PIPE_AXIS)
    group = mesh.group(meshlib.PIPE_AXIS)
    prev = mesh.rank_at(meshlib.PIPE_AXIS, p - 1) if p > 0 else None
    nxt = mesh.rank_at(meshlib.PIPE_AXIS, p + 1) if p < P - 1 else None
    B, S = x.shape
    M = n_micro if n_micro > 0 else default_n_micro(P, B)
    if B % M:
        raise ValueError(f"{B} local rows do not divide into {M} pipeline "
                         f"microbatches")
    mb, E, dev = B // M, cfg.n_embd, x.device
    cos, sin, wpe = gpt.positions(cfg, params, S, dev, dtype, embed=p == 0)

    ins: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(M):
        rows = slice(i * mb, (i + 1) * mb)
        if p == 0:
            h = gpt.embed_tokens(params, x[rows], dtype)
            if wpe is not None:
                h = h + wpe
        else:
            h = meshlib.recv((mb, S, E), dtype, dev, prev, group)
            h.requires_grad_(backward and torch.is_grad_enabled())
        ins.append(h)
        out = gpt.run_blocks(h, params["blocks"], cfg, cos, sin, dtype, remat)
        if nxt is not None:
            meshlib.send(out, nxt, group)
        else:
            hn = gpt.rms_norm(out, params["norm"], cfg.norm_eps)
            nll, _ = gpt.ce_sums(hn, params, y[rows],
                                 None if m is None else m[rows], dtype,
                                 ce_chunk)
            out = nll / denom
            total = total + out.detach()
        outs.append(out)
    if backward and torch.is_grad_enabled():
        for i in reversed(range(M)):
            if nxt is None:
                outs[i].backward()
            else:
                g = meshlib.recv((mb, S, E), dtype, dev, nxt, group)
                outs[i].backward(g)
            if prev is not None:
                meshlib.send(ins[i].grad, prev, group)
            outs[i] = ins[i] = None     # the microbatch's graph is done
    return total
