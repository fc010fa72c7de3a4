"""Observation hook: a per-phase tap into the cached forward pass.

Port of ``nano_tpu/observe.py``.  An observer receives an ``Observation``
(phase, layer, data) for each of the 12 forward phases of every prefill
and decode step a ``Session`` runs (reference: infer/infer.h:63-87), which
a UI renders as live per-layer activity.

    from nano_tpu_torch import observe

    def my_observer(obs: observe.Observation):
        print(obs.phase.name, obs.layer, obs.data.shape)

    ctx = LLMContext.from_bin(path, observation=my_observer)
    # ... generate through Session / generate_sync; my_observer fires ...

Two modes, as in the JAX package:

* callback (the default): each tap copies its tensor to the host
  (``data``, a float32 numpy array; SAMPLE's token ids as int32) and calls
  the observer at once.  A host copy cannot live inside a captured CUDA
  graph, so a context with a callback observer runs its decode steps
  eagerly (``SingleDecoder.step``); the prefill is eager anyway.
* summary (``NANO_TPU_OBSERVE=fallback``, the JAX package's "fallback"):
  each tap writes one bounded 15-float row ``[phase, layer, mean|x|,
  top-6 ids, top-6 values]`` (the top-6 only for LOGITS, over the last
  position's vocab row) into the next row of a static device buffer
  (``RowBuffer``).  Nothing reaches the host inside the step, so the step
  stays a CUDA graph: the summary graph is keyed apart from the tap-free
  one, and after each replay the host reads the rows once and replays
  them to the observer (``deliver``).

``set_observer`` attaches an observer for every thread, as in JAX; but
``LLMContext.on_stream`` attaches the context's observer (or none) for the
work it encloses, for its own thread only and under the context's lock, so
that a server thread's capture, ``generate_on_device`` and
``BatchedEngine`` never see a tap, whatever another thread attached.
With no observer a tap is one lookup.

``profile_trace`` is the other half: a ``torch.profiler`` trace of CPU and
CUDA activity, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import enum
import os
import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


class Phase(enum.IntEnum):
    """Forward phases (mirrors reference infer/infer.h:63-87)."""
    EMBEDDING = 0
    ATTN_NORM = 1
    QKV = 2
    ROPE = 3
    ATTENTION = 4
    ATTN_OUT = 5
    FFN_NORM = 6
    FFN = 7
    RESIDUAL = 8
    FINAL_NORM = 9
    LOGITS = 10
    SAMPLE = 11


@dataclass
class Observation:
    phase: Phase
    layer: int          # -1 outside the layer stack
    data: np.ndarray    # activation snapshot (host copy)
    # --- summary-mode fields (see RowBuffer) ---
    summary: bool = False
    mean_abs: Optional[float] = None      # mean |activation|
    top_ids: Optional[np.ndarray] = None  # LOGITS: top-6 token ids
    top_vals: Optional[np.ndarray] = None  # matching logits


_OBSERVER: Optional[Callable[[Observation], None]] = None
_LOCAL = threading.local()          # .scopes: the attached() stack
_FORCE_FALLBACK = os.environ.get("NANO_TPU_OBSERVE", "") == "fallback"
ROW = 15
TOP = 6
_CAPTURE: Optional["RowBuffer"] = None


def set_observer(fn: Optional[Callable[[Observation], None]]) -> None:
    """Attach `fn` for every thread outside an ``attached`` block (None:
    detach)."""
    global _OBSERVER
    _OBSERVER = fn


def current() -> Optional[Callable[[Observation], None]]:
    """The observer of this thread: its innermost ``attached`` one, else
    the one ``set_observer`` attached."""
    scopes = getattr(_LOCAL, "scopes", None)
    return scopes[-1] if scopes else _OBSERVER


def active() -> bool:
    """Whether taps fire on this thread."""
    return current() is not None


def fallback_active() -> bool:
    """Whether taps write summary rows instead of calling back."""
    return _FORCE_FALLBACK and active()


def trace_token():
    """The observing mode, part of a decode graph's key: False,
    "callback" or "fallback" (the JAX package's jit-cache key)."""
    if not active():
        return False
    return "fallback" if _FORCE_FALLBACK else "callback"


@contextlib.contextmanager
def attached(fn: Optional[Callable[[Observation], None]]):
    """Attach `fn` (None: no observer) for this thread for the block, and
    put back what was attached before.  ``LLMContext.on_stream`` encloses
    all device work of a context in one, holding the context's lock."""
    scopes = getattr(_LOCAL, "scopes", None)
    if scopes is None:
        scopes = _LOCAL.scopes = []
    scopes.append(fn)
    try:
        yield
    finally:
        scopes.pop()


class RowBuffer:
    """A static (n, ROW) f32 device buffer of summary rows.  A scope
    (``capture``) fills it from row 0; ``n`` is the number of rows the last
    scope wrote, which is the same on every replay of a graph captured
    with one."""

    def __init__(self, n_rows: int, device):
        self.rows = torch.zeros((n_rows, ROW), dtype=torch.float32,
                                device=device)
        self.n = 0

    def read(self) -> np.ndarray:
        """The rows of the last scope, on the host."""
        return self.rows[:self.n].cpu().numpy()


@contextlib.contextmanager
def capture(buf: Optional[RowBuffer]):
    """Summary taps inside the block write into `buf` from row 0 (None:
    no scope, and summary taps write nothing)."""
    global _CAPTURE
    saved = _CAPTURE
    _CAPTURE = buf
    if buf is not None:
        buf.n = 0
    try:
        yield buf
    finally:
        _CAPTURE = saved


def _write_row(buf: RowBuffer, phase: Phase, layer: int,
               x: torch.Tensor) -> None:
    """Row buf.n <- [phase, layer, mean|x|, top-6 ids, top-6 values], all
    on the device (no host value read, so a CUDA graph can capture it)."""
    i = buf.n
    if i >= buf.rows.shape[0]:
        raise RuntimeError(f"more than {buf.rows.shape[0]} observation rows "
                           "in one step")
    buf.n = i + 1
    row = buf.rows[i]
    row[0:1].fill_(float(int(phase)))
    row[1:2].fill_(float(layer))
    xf = x.detach().float()
    row[2:3].copy_(xf.abs().mean().reshape(1))
    if phase == Phase.LOGITS and x.shape[-1] >= TOP:
        vals, ids = torch.topk(xf.reshape(-1, x.shape[-1])[-1], TOP)
        row[3:3 + TOP].copy_(ids.float())
        row[3 + TOP:].copy_(vals)
    else:
        row[3:3 + TOP].fill_(-1.0)
        row[3 + TOP:].fill_(float("nan"))


def tap(phase: Phase, layer: int, x: torch.Tensor) -> None:
    """Observe `x` at `phase` of `layer` (-1 outside the stack) if an
    observer is attached on this thread: a host copy to the observer, or
    in summary mode a row of the open ``capture`` scope."""
    obs = current()
    if obs is None:
        return
    if _FORCE_FALLBACK:
        if _CAPTURE is not None:
            _write_row(_CAPTURE, phase, layer, x)
        return
    x = x.detach()
    data = (x.float() if x.is_floating_point() else x.to(torch.int32)
            ).cpu().numpy()
    obs(Observation(phase=Phase(int(phase)), layer=int(layer), data=data))


def deliver(rows: np.ndarray) -> None:
    """Replay summary rows read back from the device to the observer."""
    obs = current()
    if obs is None:
        return
    rows = np.asarray(rows, np.float32).reshape(-1, ROW)
    for r in rows:
        phase = Phase(int(r[0]))
        has_top = r[3] >= 0
        obs(Observation(
            phase=phase, layer=int(r[1]), data=np.asarray([r[2]]),
            summary=True, mean_abs=float(r[2]),
            top_ids=r[3:3 + TOP].astype(np.int64) if has_top else None,
            top_vals=r[3 + TOP:].copy() if has_top else None))


def top_candidates(logits: np.ndarray, k: int = 6):
    """Helper for observers: (ids, probs) of the k most likely tokens
    (the reference UI renders top-6, infer/ui_app.c:798-855)."""
    logits = np.asarray(logits, np.float32).reshape(-1)
    ids = np.argsort(-logits)[:k]
    z = logits - logits.max()
    p = np.exp(z) / np.exp(z).sum()
    return ids, p[ids]


@contextlib.contextmanager
def profile_trace(logdir: str, annotate: str = ""):
    """A ``torch.profiler`` trace of the CPU and CUDA activity inside the
    block, written into `logdir` as a Chrome trace (``trace.json``: open it
    in Perfetto or chrome://tracing).  `annotate` names the block as one
    ``record_function`` range.

        with observe.profile_trace("traces"):
            engine.generate_sync(ctx, prompt, 32)

    CLI: ``python -m nano_tpu_torch.infer ... --trace DIR``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            with (record_function(annotate) if annotate
                  else contextlib.nullcontext()):
                yield logdir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
