"""Rank functions for the port's tensor- and data-parallel CPU tests.

``nano_tpu_torch.parallel.launch.run`` starts them as the ranks of a gloo
group; each child imports this module by name, so it imports only torch,
numpy and the port (never jax: tests/test_torch_isolation.py holds it to
that), and returns plain values that the test compares with the JAX
package in its own process.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from nano_tpu_torch.infer import engine
from nano_tpu_torch.ops import sampling
from nano_tpu_torch.parallel import mesh as meshlib
from nano_tpu_torch.serve.batching import BatchedEngine

SAMP = sampling.SamplerConfig(temperature=0.0, repetition_penalty=1.0)


def _ctx(path: str, **kw) -> engine.LLMContext:
    return engine.LLMContext.from_bin(path, max_seq_len=64,
                                      dtype=torch.float32, sampler=SAMP,
                                      device="cpu", **kw)


def greedy(ctx, prompt: str, n: int = 12) -> List[int]:
    session = engine.Session(ctx, prompt, max_new_tokens=n)
    out = []
    while (t := session.step()) is not None:
        out.append(t)
    return out


def batched(ctx, prompt: str, n: int) -> List[int]:
    """One greedy stream through a 2-slot BatchedEngine."""
    be = BatchedEngine(ctx, n_slots=2)
    slot, first = be.add(ctx.encode(prompt), max_new_tokens=n,
                         temperature=0.0, repetition_penalty=1.0)
    toks = [first]
    while be.slots[slot].active:
        toks.extend(be.step().get(slot, []))
    return toks


def prefill_logits(ctx, prompt: str = "abcdef") -> np.ndarray:
    """The f32 logits of the prompt's last position after a prefill."""
    from nano_tpu_torch.models import gpt
    ids = ctx.encode(prompt)
    x = torch.zeros((1, 16), dtype=torch.int64)
    x[0, :len(ids)] = torch.tensor(ids)
    logits, _ = gpt.forward_with_cache(ctx.params, x, ctx.new_cache(1), 0,
                                       ctx.cfg, dtype=torch.float32,
                                       last_idx=len(ids) - 1)
    return logits[0, 0].numpy()


def _plan(tp) -> Dict[str, Any]:
    return dict(heads=tp.heads, kv_heads=tp.kv_heads, attn=tp.attn,
                ffn=tp.ffn, ffn_mode=tp.ffn_mode)


def _leaf(w) -> Dict[str, np.ndarray]:
    """A leaf's arrays (layer 0 of a stacked one) as numpy."""
    if isinstance(w, torch.Tensor):
        return {"w": w[0].numpy()}
    return {k: getattr(w, k)[0].numpy() for k in ("q", "scales", "packed",
                                                  "biases")
            if hasattr(w, k)}


def serve(files: Dict[str, str], widths: List[int]) -> Dict[str, Any]:
    """Every check of tests/test_torch_infer_tp.py on this rank: for each
    model file and each tensor-parallel width (over a (world / width,
    width) mesh), Session greedy streams, the plan and the cut of layer 0's
    column-parallel leaves; BatchedEngine, speculative serving and
    generate_on_device on some of them."""
    meshes = {n: meshlib.make_mesh(n_model=n) for n in widths}
    out: Dict[str, Any] = {}
    for name, path in files.items():
        for n, mesh in meshes.items():
            ctx = _ctx(path).shard(mesh)
            key = f"{name}/tp{n}"
            out[key + "/session"] = greedy(ctx, "abcdef")
            out[key + "/plan"] = _plan(ctx.cfg.tp)
            out[key + "/cuts"] = {k: _leaf(w) for k, w in
                                  ctx.params["blocks"].items()
                                  if k in ("wq", "wk", "wv", "wqkv", "w1",
                                           "w3", "w13", "wo", "w2")}
            out[key + "/kv_cache"] = tuple(ctx.new_cache(1).k.shape)
            out[key + "/logits"] = prefill_logits(ctx)
            if name.startswith("tiny_f32"):
                out[key + "/batched"] = batched(ctx, "abcdef", 8)
                spec = _ctx(path, spec_k=4).shard(mesh)
                out[key + "/spec_batched"] = batched(spec, "ababab", 10)
                out[key + "/spec_session"] = greedy(spec, "ababab", 10)
                out[key + "/on_device"] = engine.generate_on_device(
                    ctx, ctx.encode("abcdef"), 12).tolist()
                out[key + "/refusals"] = refusals(ctx, mesh, path)
    return out


def refusals(ctx, mesh, path: str) -> Dict[str, str]:
    """What a sharded context and the mesh refuse, by message (`path`: a
    file read as a LoRA adapter, which is refused before it is read)."""
    got: Dict[str, str] = {}
    for what, fn in (("seq", lambda: meshlib.make_mesh(n_model=1, n_seq=2)),
                     ("pipe", lambda: meshlib.make_mesh(n_model=1, n_pipe=2)),
                     ("lora", lambda: ctx.load_lora(path)),
                     ("adapters", lambda: BatchedEngine(ctx, 2, {"a": path})),
                     ("twice", lambda: ctx.shard(mesh))):
        try:
            fn()
            got[what] = ""
        except (NotImplementedError, ValueError) as e:
            got[what] = f"{type(e).__name__}: {e}"
    return got


def train(model_config: dict, runs: List[Dict[str, Any]]) -> List[Any]:
    """Port Trainer runs on this rank, one after the other: each run a dict
    of the train config, max_steps and is_continued_pretrain ->
    (loss_history, the last step's gradient norm before the clip, the
    mesh's shape) of each."""
    from nano_tpu_torch.train.trainer import Trainer
    out = []
    for run in runs:
        t = Trainer(model_config, run["train_config"],
                    max_steps=run["max_steps"],
                    ckpt_filename=run.get("ckpt_filename"),
                    is_continued_pretrain=run.get("continued", False),
                    device="cpu")
        t.init()
        t.load_data()
        t.start()
        out.append((t.loss_history, float(t.opt.last_norm),
                    dict(t.mesh.shape)))
    return out
