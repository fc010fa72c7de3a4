"""Rank functions for the port's parallel CPU tests.

``nano_tpu_torch.parallel.launch.run`` starts them as the ranks of a gloo
group; each child imports this module by name, so it imports only torch,
numpy and the port (never jax: tests/test_torch_isolation.py holds it to
that), and returns plain values that the test compares with the JAX
package in its own process.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

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
    model file read as a LoRA adapter, which the reader refuses), and the
    shapes of the "seq" and "pipe" meshes over the four ranks."""
    got: Dict[str, Any] = {
        "meshes": [meshlib.make_mesh(n_seq=2).shape,
                   meshlib.make_mesh(n_pipe=2, n_model=2).shape]}
    for what, fn in (("seq", lambda: meshlib.make_mesh(n_seq=3)),
                     ("pipe", lambda: meshlib.make_mesh(n_pipe=8)),
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
    of the train config, max_steps and is_continued_pretrain (and for a
    LoRA fine-tune the adapter it starts from, "lora") ->
    (loss_history, the last step's gradient norm before the clip, the
    mesh's shape) of each."""
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.train.trainer import AdamW, Trainer
    out = []
    for run in runs:
        t = Trainer(model_config, run["train_config"],
                    max_steps=run["max_steps"],
                    ckpt_filename=run.get("ckpt_filename"),
                    is_continued_pretrain=run.get("continued", False),
                    device="cpu")
        t.init()
        if "lora" in run:
            # a LoRA fine-tune from the given whole adapter (the JAX
            # Trainer's fresh one), cut as the Trainer cuts its own
            lora = {k: torch.from_numpy(v) for k, v in run["lora"].items()}
            if t.tp is not None:
                lora = meshlib.cut_lora(lora, t.tp)
            t.lora = {k: v.clone().requires_grad_(True)
                      for k, v in lora.items()}
            names = [n for n, _ in gpt.param_leaves(t.lora)]
            t.opt = AdamW(t.train_config, t.lora,
                          [t._cut_of(n) is not None for n in names],
                          t._cut_group())
        t.load_data()
        t.start()
        out.append((t.loss_history, float(t.opt.last_norm),
                    dict(t.mesh.shape)))
    return out


# ---------------------------------------------------------------------
# sequence and pipeline parallelism, LoRA under tensor parallelism
# ---------------------------------------------------------------------

def transport(shape: Dict[str, int]) -> Dict[str, Any]:
    """The transport of ``parallel.mesh`` over the seq group of a mesh of
    `shape`: -> the gathered and reduce-scattered tensors, and the tensor
    a send / recv moved, natively and staged through host memory as for
    gloo and CUDA tensors (forced here on CPU tensors)."""
    mesh = meshlib.make_mesh(**{f"n_{k}": v for k, v in shape.items()})
    group, s = mesh.group(meshlib.SEQ_AXIS), mesh.index(meshlib.SEQ_AXIS)
    x = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3) + 10 * s
    out: Dict[str, Any] = dict(
        gather=meshlib.all_gather(x.to(torch.bfloat16), group, 1),
        scatter=meshlib.reduce_scatter(
            (torch.arange(8, dtype=torch.float32).reshape(1, 4, 2)
             * (s + 1)).to(torch.bfloat16), group, 1))
    peer = mesh.rank_at(meshlib.SEQ_AXIS, 1 - s)
    for path, forced in (("native", False), ("staged", True)):
        real = meshlib._staged
        meshlib._staged = lambda t, g: forced
        try:
            if s == 0:
                meshlib.send(x, peer, group)
            else:
                out[path] = meshlib.recv(x.shape, x.dtype, "cpu", peer,
                                         group)
        finally:
            meshlib._staged = real
    return out


def seq_file(model_config: dict, runs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Every rank check of tests/test_torch_seq_parallel.py: the
    transport, then the Trainer runs."""
    return dict(transport=transport({"data": 2, "seq": 2}),
                train=train(model_config, runs))


def _greedy_ctx(path: str, mesh, lora: Optional[str] = None,
                before: bool = False, **kw) -> engine.LLMContext:
    """A context of `path` sharded over `mesh` with the LoRA file `lora`
    attached after the shard, or before it where `before`."""
    ctx = _ctx(path, **kw)
    if lora and before:
        ctx.load_lora(lora)
    ctx.shard(mesh)
    if lora and not before:
        ctx.load_lora(lora)
    return ctx


def batched_adapters(ctx, adapters: Dict[str, str], joins, n: int = 10
                     ) -> Dict[int, List[int]]:
    """tests/test_torch_lora.py's per-slot run: four of the five joins at
    once, each with its adapter (or the base), the fifth in the first slot
    freed -> {join: tokens}."""
    be = BatchedEngine(ctx, n_slots=4, adapters=adapters)
    got: Dict[int, List[int]] = {}
    live: Dict[int, int] = {}

    def join(i):
        prompt, name = joins[i]
        slot, first = be.add(ctx.encode(prompt), max_new_tokens=n,
                             temperature=0.0, repetition_penalty=1.0,
                             adapter=name)
        got[i], live[slot] = [first], i

    for i in range(4):
        join(i)
    while be.n_active:
        res = be.step_burst(2)
        for slot, toks in res.items():
            got[live[slot]].extend(toks)
        for slot in [s for s, e in res.ended.items() if e]:
            del live[slot]
            be.release(slot)
            if 4 not in got:
                join(4)
    return got


def lora_tp_file(files: Dict[str, str], joins, model_config: dict,
                 runs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Every rank check of tests/test_torch_lora_tp.py at TP = 2: greedy
    streams of the f32 and Q80 models with an adapter attached after and
    before the shard, a swap, an unload, a clone, the adapter of a LoRA
    checkpoint, speculation; per-slot BatchedEngine streams; the cut
    adapter's shapes; then a LoRA fine-tune (``train``)."""
    mesh = meshlib.make_mesh(n_model=2)
    out: Dict[str, Any] = {}
    for name in ("f32", "q80"):
        path = files[name]
        ctx = _greedy_ctx(path, mesh, files["a"])
        out[f"{name}/a"] = greedy(ctx, "abcdef")
        out[f"{name}/a_before"] = greedy(
            _greedy_ctx(path, mesh, files["a"], before=True), "abcdef")
        clone = ctx.clone_with_lora(files["b"])
        out[f"{name}/b_clone"] = greedy(clone, "abcdef")
        ctx.load_lora(files["b"])
        out[f"{name}/b"] = greedy(ctx, "abcdef")
        ctx.unload_lora()
        out[f"{name}/base"] = greedy(ctx, "abcdef")
        ctx.load_lora_checkpoint(files["ckpt"])
        out[f"{name}/ckpt"] = greedy(ctx, "abcdef")
        out[f"{name}/on_device"] = engine.generate_on_device(
            clone, clone.encode("abcdef"), 12).tolist()
    spec = _greedy_ctx(files["f32"], mesh, files["b"], spec_k=4)
    out["spec"] = greedy(spec, "abcabcabcabc", 16)
    base = _greedy_ctx(files["f32"], mesh)
    out["batched"] = batched_adapters(
        base, {"a": files["a"], "b": files["b"]}, joins)
    cut = _greedy_ctx(files["f32"], mesh, files["b"])
    out["shapes"] = {k: tuple(t.shape) for k, t in cut.lora.items()}
    out["train"] = train(model_config, runs)
    return out
