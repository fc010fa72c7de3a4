"""Interactive inference REPL: ``python -m nano_tpu_torch.infer``.

The port's counterpart of the root ``infer.py``: loads a .bin model, a
GGUF file or a training checkpoint (.npz) onto the card (or ``--device
cpu``), wraps prompts in the instruct template, streams tokens
typewriter-style, reports TPS, supports LoRA, speculative decode, the
denoise decode mode, the per-phase observer (``-o``) and a
``torch.profiler`` trace of a one-shot run (``--trace DIR``).

    python -m nano_tpu_torch.infer -i -m checkpoint.npz [-l lora.npz] [-p]
    python -m nano_tpu_torch.infer -i -m model.bin [-l lora.bin]
    python -m nano_tpu_torch.infer -m model.bin -q "one-shot prompt"
    python -m nano_tpu_torch.infer -d -m denoise_model.npz
"""

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="nano_tpu_torch inference")
    ap.add_argument("-m", "--model", required=True,
                    help=".npz checkpoint, .bin model or .gguf file")
    ap.add_argument("-l", "--lora", default=None)
    ap.add_argument("-i", "--instruct", action="store_true",
                    help="wrap prompts in the instruct/chat template")
    ap.add_argument("-p", "--profile", action="store_true",
                    help="print tokens/sec")
    ap.add_argument("-d", "--denoise", action="store_true")
    ap.add_argument("-q", "--prompt", default=None, help="one-shot prompt")
    ap.add_argument("-n", "--max_new_tokens", type=int, default=512)
    ap.add_argument("-c", "--max_seq_len", type=int, default=None)
    ap.add_argument("-t", "--temperature", type=float, default=1.0)
    ap.add_argument("--top_p", type=float, default=0.8)
    ap.add_argument("-r", "--repetition_penalty", type=float, default=1.05)
    ap.add_argument("-s", "--seed", type=int, default=39)
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="speculative greedy decode: draft K tokens by "
                         "n-gram prompt lookup, verify in one forward "
                         "(greedy only; identical output)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the "
                         "one-shot run into DIR (the kernel-level "
                         "complement of the per-phase --observe tap)")
    ap.add_argument("-o", "--observe", action="store_true",
                    help="show per-layer activity and the top-6 next-token "
                         "candidates per step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    from nano_tpu_torch import observe as obs_mod
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.ops import sampling

    sampler = sampling.SamplerConfig(
        temperature=args.temperature, top_p=args.top_p,
        repetition_penalty=args.repetition_penalty)
    observer = None
    if args.observe:
        state = {"acts": {}, "logits": None, "top": None}

        def observer(o):
            # after each step's SAMPLE: the layers' mean |residual| as bars
            # and the top-6 next-token candidates, from full activations
            # (callback mode) or summary rows (NANO_TPU_OBSERVE=fallback)
            if o.phase == obs_mod.Phase.RESIDUAL:
                state["acts"][o.layer] = (o.mean_abs if o.summary
                                          else float(np.abs(o.data).mean()))
            elif o.phase == obs_mod.Phase.LOGITS:
                if o.summary:
                    state["top"] = (o.top_ids, o.top_vals)
                else:
                    state["logits"] = o.data
            elif o.phase == obs_mod.Phase.SAMPLE and (
                    state["logits"] is not None or state["top"] is not None):
                bars = "".join(
                    " ▁▂▃▄▅▆▇█"[min(8, int(state["acts"].get(l, 0.0) * 4))]
                    for l in sorted(state["acts"]))
                if state["top"] is not None:
                    ids, vals = state["top"]
                    z = vals - vals.max()
                    probs = np.exp(z) / np.exp(z).sum()   # over the top-6
                else:
                    ids, probs = obs_mod.top_candidates(state["logits"], 6)
                cand = " ".join(f"{ctx.decode([int(i)])!r}:{p:.2f}"
                                for i, p in zip(ids, probs))
                print(f"\n[layers {bars}] top6: {cand}", file=sys.stderr)
                state["acts"].clear()
                state["top"] = None

    loader = (engine.LLMContext.from_bin if args.model.endswith(".bin")
              else engine.LLMContext.from_gguf
              if args.model.endswith(".gguf")
              else engine.LLMContext.from_checkpoint)
    try:
        ctx = loader(args.model, max_seq_len=args.max_seq_len,
                     device=args.device, sampler=sampler,
                     random_seed=args.seed, observation=observer,
                     spec_k=args.spec)
    except RuntimeError as e:
        if "CUDA" not in str(e):
            raise
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.lora:
        if args.lora.endswith(".bin"):
            ctx.load_lora(args.lora)
        else:
            ctx.load_lora_checkpoint(args.lora)
    cfg = ctx.cfg
    print(f"loaded {args.model}: {cfg.n_layer}L/{cfg.n_embd}E/"
          f"{cfg.n_head}H vocab={cfg.vocab_size} ctx={ctx.max_seq_len} "
          f"on {ctx.device}", file=sys.stderr)

    def run(prompt: str):
        if args.denoise:
            ids = ctx.encode(prompt)
            out = engine.denoise_generate(ctx, ids, args.max_new_tokens,
                                          temperature=max(args.temperature,
                                                          1e-3))
            print(ctx.decode(list(out)))
            return
        t0 = time.time()
        n_tok = [0]
        stamps = []

        def on_decoding(session, tok, text):
            print(text, end="", flush=True)
            n_tok[0] += 1
            if args.profile:
                # sliding 4-token TPS window (reference: infer.py:91-99)
                stamps.append(time.time())
                if len(stamps) > 4:
                    del stamps[0]
                if len(stamps) == 4:
                    tps = 3.0 / max(stamps[-1] - stamps[0], 1e-9)
                    print(f" [{tps:.1f} tok/s]", end="", flush=True)

        engine.generate_sync(ctx, prompt,
                             max_new_tokens=args.max_new_tokens,
                             template=args.instruct,
                             on_decoding=on_decoding)
        print()
        if args.profile and n_tok[0]:
            dt = time.time() - t0
            print(f"[{n_tok[0]} tokens, {n_tok[0]/dt:.1f} tok/s]",
                  file=sys.stderr)

    if args.prompt is not None:
        if args.trace:
            with obs_mod.profile_trace(args.trace, annotate="infer"):
                run(args.prompt)
            print(f"[trace written to {args.trace}]", file=sys.stderr)
        else:
            run(args.prompt)
        return 0
    print("REPL — empty line or EOF quits", file=sys.stderr)
    while True:
        try:
            line = input(">> ")
        except EOFError:
            break
        if not line:
            break
        run(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
