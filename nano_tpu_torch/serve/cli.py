"""Shared CLI plumbing for the serving frontends (wss, openai_http).

Port of ``nano_tpu/serve/cli.py``: both servers sit on the same
continuous-batching core and take the same engine knobs, so the argparse
surface and the LLMContext construction live in one place.  ``--device``
picks the device (cuda unless given; ``cpu`` is the only way onto the
CPU)."""

from __future__ import annotations

import argparse


def add_engine_args(ap: argparse.ArgumentParser, port: int) -> None:
    """Engine/serving flags shared by every .bin-serving frontend."""
    ap.add_argument("--model", required=True, help=".bin or .gguf model path")
    ap.add_argument("--lora", default=None, action="append",
                    help="LoRA .bin; bare path = attach to the base "
                         "model, name=path (repeatable) = serve it as a "
                         "selectable variant sharing the base weights "
                         "(route with {\"model\": name})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=port)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--burst", type=int, default=1,
                    help="tokens decoded per host read (multi-step "
                         "scheduling; higher = more throughput, chunkier "
                         "streaming)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel serving: copy the model to N "
                         "cards, one continuous-batching engine each")
    ap.add_argument("--max_seq_len", type=int, default=None)
    ap.add_argument("--kv_cache", default="int8",
                    choices=["model", "int8", "bf16"],
                    help="int8 (the serving default) halves the KV cache; "
                         "'model' keeps the model dtype ('bf16' is an "
                         "alias for 'model')")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="speculative serving: draft K tokens per slot by "
                         "n-gram prompt lookup; greedy streams emit up to "
                         "K+1 tokens per step with identical output "
                         "(serve/batching.py)")
    ap.add_argument("--warmup", action="store_true",
                    help="capture every decode graph and run every prefill "
                         "bucket before accepting connections, so no "
                         "client pays a capture at first contact")
    ap.add_argument("-t", "--temperature", type=float, default=1.0)
    ap.add_argument("-p", "--top_p", type=float, default=0.8)
    ap.add_argument("-r", "--repetition_penalty", type=float, default=1.05)


def build_ctx(args):
    """LLMContext + routable-adapter registry from parsed engine args."""
    import torch

    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.ops import sampling

    loader = (engine.LLMContext.from_gguf
              if args.model.endswith(".gguf")
              else engine.LLMContext.from_bin)
    ctx = loader(
        args.model, max_seq_len=args.max_seq_len,
        device=getattr(args, "device", None),
        kv_cache_dtype=torch.int8 if args.kv_cache == "int8" else None,
        spec_k=args.spec,
        sampler=sampling.SamplerConfig(
            temperature=args.temperature, top_p=args.top_p,
            repetition_penalty=args.repetition_penalty))
    adapters = {}
    for entry in args.lora or []:
        if "=" in entry:
            name, path = entry.split("=", 1)
            adapters[name] = path
        else:
            ctx.load_lora(entry)       # attach to the base model
    return ctx, (adapters or None)
