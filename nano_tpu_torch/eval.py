"""Perplexity evaluation over a text corpus.

Port of the root eval.py's ``model_ppl``: the same strided-window token
accounting (every token scored once, at the longest context its window
gives it), each window one f32 ``gpt.forward`` on the card — through the
model's Q80 / Q4K kernels for a quantized file and flash attention for a
causal model.  ``.bin``, ``.gguf`` and training checkpoints (``.npz``)
load through ``LLMContext.from_bin / from_gguf / from_checkpoint`` in f32.

    python -m nano_tpu_torch.eval -m model-q4k.bin -i text.txt
    python -m nano_tpu_torch.eval -m model-q4k.bin -i text.txt --compare model-f32.bin

The root script's ``--engine cpp`` (scoring through the C++ host engine)
is not ported: its binding lives in the JAX package.
"""

from __future__ import annotations

import argparse
import math
from typing import List, Sequence

import numpy as np
import torch


def load_context(path: str, device=None):
    """The model at `path` as an f32 ``LLMContext`` on `device` (cuda
    unless asked otherwise), by its file type."""
    from nano_tpu_torch.infer import engine
    loader = (engine.LLMContext.from_bin if path.endswith(".bin")
              else engine.LLMContext.from_gguf if path.endswith(".gguf")
              else engine.LLMContext.from_checkpoint)
    return loader(path, dtype=torch.float32, device=device)


@torch.no_grad()
def window_nll(ctx, window: Sequence[int]) -> torch.Tensor:
    """-log p(window[t + 1] | window[:t + 1]) for every t, (len - 1,) f32 on
    the device: one f32 forward over window[:-1]."""
    from nano_tpu_torch.models import gpt
    w = torch.as_tensor(np.asarray(window, np.int64), device=ctx.device)
    logits = gpt.forward(ctx.params, w[None, :-1], ctx.cfg,
                         dtype=torch.float32)
    logp = torch.log_softmax(logits[0].float(), dim=-1)
    return -logp.gather(-1, w[1:, None])[:, 0]


def windows(n_ids: int, S: int, stride: int):
    """The strided windows over n_ids tokens: (start, valid, lo) for each
    window that scores something — it covers ids[start:start + valid + 1]
    and scores targets lo..valid - 1 of it, the ones no earlier window
    scored (every token once, at the longest context available)."""
    counted_to = 0        # last counted target index (ids[] index), exclusive
    for start in range(0, max(n_ids - 1, 1), stride):
        valid = min(S + 1, n_ids - start) - 1
        if valid < 1:
            break
        lo_abs = max(start + 1, counted_to + 1)
        if lo_abs > start + valid:
            continue
        yield start, valid, lo_abs - (start + 1)
        counted_to = start + valid


def ids_ppl(ctx, ids: List[int], block_size: int = 0, stride: int = 0
            ) -> float:
    """Perplexity of the token ids under the context's model: windows of
    `block_size` (the model's when 0) targets every `stride` (the window
    when 0), each padded to full length with id 0 after its last token."""
    S = block_size or ctx.cfg.block_size
    ids = np.asarray(ids, np.int64)
    if len(ids) < 2:
        raise ValueError("text too short")
    total_nll, total_tok = 0.0, 0
    for start, valid, lo in windows(len(ids), S, stride or S):
        window = np.pad(ids[start:start + valid + 1], (0, S - valid))
        nll = window_nll(ctx, window)
        total_nll += float(nll[lo:valid].double().sum())
        total_tok += valid - lo
    return math.exp(total_nll / total_tok)


def model_ppl(path: str, text: str, block_size: int = 0, stride: int = 0,
              device=None) -> float:
    """Perplexity of `text` under the model at `path` (root eval.py's
    model_ppl), on `device` (cuda unless asked otherwise)."""
    ctx = load_context(path, device)
    return ids_ppl(ctx, ctx.encode(text), block_size, stride)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m nano_tpu_torch.eval",
        description="Nano PPL evaluation (PyTorch/CUDA).  The root "
                    "eval.py's --engine cpp is not ported: the C++ "
                    "binding lives in the JAX package.")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-i", "--input", required=True, help="UTF-8 text file")
    ap.add_argument("--compare", default=None,
                    help="second model (e.g. the FP32 export) to report "
                         "the PPL delta against")
    ap.add_argument("-b", "--block_size", type=int, default=0)
    ap.add_argument("--stride", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda unless given; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    with open(args.input, "r", encoding="utf-8") as f:
        text = f.read()

    ppl = model_ppl(args.model, text, args.block_size, args.stride,
                    args.device)
    print(f"{args.model}: ppl = {ppl:.4f}")
    if args.compare:
        ref = model_ppl(args.compare, text, args.block_size, args.stride,
                        args.device)
        print(f"{args.compare}: ppl = {ref:.4f}")
        print(f"delta = {ppl - ref:+.4f}")


if __name__ == "__main__":
    main()
