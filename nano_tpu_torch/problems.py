"""Synthetic "problems" harness: dataset synthesis + training + exact-match
accuracy evaluation for four toy tasks.

Port of ``nano_tpu/problems.py`` (reference: problem.py:35-400):
  * q          — count enclosed circles in a digit string (causal, answer
                 after a '-' separator, loss mask on the answer token)
  * sort       — sort a digit string (non-causal seq2seq)
  * palindrome — reverse a digit string (non-causal seq2seq, learned
                 positional embeddings)
  * calculator — evaluate a boolean S-expression ((+ a b)=OR, (* a b)=AND),
                 causal with loss mask on the value+eos tokens

The closed loop (generate -> train -> measure accuracy on fresh random
inputs) drives the whole single-device path: the datasets are the JAX
package's array for array (Python ``random.Random(seed)`` draws, uint16
ids, uint8 masks, the same .npz shards), training is the port's
``Trainer`` (the causal tasks' attention through the flash-attention
kernels on the card, the non-causal ones through the einsum path), and
accuracy is one batched f32 forward.

    python -m nano_tpu_torch.problems sort [--steps N --batch B ...]
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.data.preprocess import save_shard
from nano_tpu_torch.models import gpt
from nano_tpu_torch.tokenizer.trie import TrieTokenizer

QV_MAP = [1, 0, 0, 0, 0, 0, 1, 0, 2, 1, 0]   # circles per digit, '-'=idx 10
RES_MAP = "0123456789abcdefghijklmnopqrstuvwxyz"


def q_function(number: int, num_digits: int) -> str:
    """How many circles in the digit string (reference: problem.py:196-210)."""
    istr = ("-" * 27 + str(number))[-num_digits:]
    qv = sum(QV_MAP[10 if c == "-" else int(c)] for c in istr)
    return RES_MAP[qv]


def _digit_tokenizer() -> TrieTokenizer:
    tok = TrieTokenizer()
    tok.build(list("0123456789-") + list(RES_MAP[10:]))
    return tok


@torch.no_grad()
def _logits(params, cfg: ModelConfig, rows: List[List[int]]) -> torch.Tensor:
    """One f32 forward of the token rows on the parameters' device."""
    dev = params["tok_embeddings"].device
    x = torch.tensor(rows, dtype=torch.int64, device=dev)
    return gpt.forward(params, x, cfg, dtype=torch.float32)


# =====================================================================
# task definitions
# =====================================================================

@dataclass
class Problem:
    name: str
    seq_length: int
    model_config: dict
    tokenizer: TrieTokenizer
    is_causal: bool
    gen_sample: Callable[[random.Random], Tuple[List[int], Optional[List[int]]]]
    eval_batch: Callable     # (params, cfg, tok, rng, n) -> accuracy


def make_problem(task: str, seq_length: int = 8,
                 expr_max_depth: int = 4, expr_max_length: int = 64,
                 **model_overrides) -> Problem:
    if task == "q":
        tok = _digit_tokenizer()
        block = seq_length + 2
        mc = dict(block_size=block, vocab_size=tok.vocab_size, n_layer=2,
                  n_embd=64, n_head=2, n_kv_head=2, n_hidden=32,
                  use_rope=True, is_causal=True)

        def gen(rng: random.Random):
            i = rng.randint(0, 10 ** seq_length - 1)
            istr = ("-" * 27 + str(i))[-seq_length:]
            ids = tok.encode(f"{istr}-{q_function(i, seq_length)}")
            ids = ids + [tok.pad_id] * (block + 1 - len(ids))
            mask = [1 if j == seq_length + 1 else 0 for j in range(block + 1)]
            return ids, mask

        def evaluate(params, cfg, tokenizer, rng, n):
            prompts, answers = [], []
            for _ in range(n):
                i = rng.randint(0, 10 ** seq_length - 1)
                istr = ("-" * 27 + str(i))[-seq_length:]
                prompts.append(tokenizer.encode(f"{istr}-"))
                answers.append(tokenizer.stoi[q_function(i, seq_length)])
            logits = _logits(params, cfg, prompts)
            pred = logits[:, -1].argmax(dim=-1).cpu().numpy()
            return float(np.mean(pred == np.asarray(answers)))

    elif task in ("sort", "palindrome"):
        tok = _digit_tokenizer()
        block = seq_length
        mc = dict(block_size=block, vocab_size=tok.vocab_size, n_layer=2,
                  n_embd=32, n_head=4 if task == "sort" else 2, n_kv_head=2,
                  n_hidden=16, use_rope=(task == "sort"), is_causal=False)

        transform = (lambda s: "".join(sorted(s))) if task == "sort" \
            else (lambda s: s[::-1])

        def gen(rng: random.Random):
            n = rng.randint(0, 10 ** seq_length - 1)
            s = str(n + 10 ** seq_length)[1:]
            return tok.encode(s + transform(s)), None

        def evaluate(params, cfg, tokenizer, rng, n):
            xs, targets = [], []
            for _ in range(n):
                v = rng.randint(0, 10 ** seq_length - 1)
                s = str(v + 10 ** seq_length)[1:]
                xs.append(tokenizer.encode(s))
                targets.append(tokenizer.encode(transform(s)))
            pred = _logits(params, cfg, xs).argmax(dim=-1).cpu().numpy()
            return float(np.mean(np.all(pred == np.asarray(targets), axis=1)))

    elif task == "calculator":
        # boolean calculator vocab (reference: problem.py:147-163)
        tok = TrieTokenizer()
        tok.build(["inf", "(", ")", "+", "-", "*", "/", "="] + ["0", "1"])
        block = expr_max_length
        mc = dict(block_size=block, vocab_size=tok.vocab_size, n_layer=4,
                  n_embd=128, n_head=8, n_kv_head=4, n_hidden=256,
                  use_rope=False, is_causal=True)

        def gen_expr(depth: int, rng: random.Random):
            """-> (token ids, boolean value); (+)=OR, (*)=AND
            (reference: problem.py:165-193)."""
            if rng.random() <= 0.2 or depth >= expr_max_depth:
                v = rng.randint(0, 1)
                return [tok.stoi[str(v)]], v
            op = ["+", "*"][rng.randint(0, 1)]
            a_ids, a = gen_expr(depth + 1, rng)
            b_ids, b = gen_expr(depth + 1, rng)
            ids = [tok.stoi["("], tok.stoi[op]] + a_ids + b_ids + [tok.stoi[")"]]
            v = (a or b) if op == "+" else (a and b)
            return ids, int(v)

        def gen(rng: random.Random):
            expr_ids, value = gen_expr(0, rng)
            ids = expr_ids + [tok.stoi["="], tok.stoi[str(value)], tok.eos_id]
            if len(ids) > block + 1:
                return gen(rng)  # resample over-long expressions
            n_expr = len(expr_ids)
            ids = ids + [tok.pad_id] * (block + 1 - len(ids))
            mask = [1 if j in (n_expr + 1, n_expr + 2) else 0
                    for j in range(block + 1)]
            return ids, mask

        def evaluate(params, cfg, tokenizer, rng, n):
            xs, lens, answers = [], [], []
            for _ in range(n):
                while True:
                    expr_ids, value = gen_expr(0, rng)
                    if len(expr_ids) + 1 <= block:
                        break
                prompt = expr_ids + [tokenizer.stoi["="]]
                lens.append(len(prompt))
                xs.append(prompt + [tokenizer.pad_id] * (block - len(prompt)))
                answers.append(tokenizer.stoi[str(value)])
            logits = _logits(params, cfg, xs)
            idx = torch.tensor(lens, device=logits.device) - 1
            at = logits[torch.arange(len(xs), device=logits.device), idx]
            pred = at.argmax(dim=-1).cpu().numpy()
            return float(np.mean(pred == np.asarray(answers)))

    else:
        raise ValueError(f"unknown task {task}")

    mc.update(model_overrides)
    return Problem(name=task, seq_length=seq_length, model_config=mc,
                   tokenizer=tok, is_causal=mc["is_causal"], gen_sample=gen,
                   eval_batch=evaluate)


# =====================================================================
# closed loop
# =====================================================================

def generate_dataset(problem: Problem, out_dir: str, n_train: int,
                     n_val: int, seed: int = 39) -> Tuple[str, str]:
    """n_train then n_val samples from one ``random.Random(seed)`` ->
    problem_<task>_{train,val}.npz under out_dir."""
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)

    def build(n):
        ids_l, mask_l = [], []
        for _ in range(n):
            ids, mask = problem.gen_sample(rng)
            ids_l.append(np.asarray(ids, np.uint16))
            if mask is not None:
                mask_l.append(np.asarray(mask, np.uint8))
        return np.stack(ids_l), (np.stack(mask_l) if mask_l else None)

    train_path = os.path.join(out_dir, f"problem_{problem.name}_train.npz")
    val_path = os.path.join(out_dir, f"problem_{problem.name}_val.npz")
    save_shard(train_path, *build(n_train))
    save_shard(val_path, *build(n_val))
    return train_path, val_path


def run_problem(task: str, out_dir: str, seq_length: int = 8,
                max_steps: int = 2000, batch_size: int = 100,
                n_train: int = 50_000, n_val: int = 5_000,
                n_eval: int = 1000, learning_rate: float = 1e-3,
                seed: int = 39, dtype: str = "bfloat16",
                export_bin: str = "", device=None,
                **model_overrides) -> float:
    """generate_dataset(); train; evaluate accuracy — returns accuracy
    (reference: problem.py:336-400 closed loop).  Trains on `device`
    (cuda unless asked otherwise); `export_bin` also writes the trained
    model as a self-contained f32 .bin (embedded tokenizer), which
    ``LLMContext.from_bin`` serves (``engine.seq2seq`` for the non-causal
    tasks)."""
    from nano_tpu_torch.train.trainer import Trainer
    problem = make_problem(task, seq_length, **model_overrides)
    train_p, val_p = generate_dataset(problem, out_dir, n_train, n_val, seed)

    tok_path = os.path.join(out_dir, f"tok_{task}.json")
    problem.tokenizer.dump_config_file(tok_path)

    tc = dict(batch_size=batch_size, gradient_accumulation_steps=1,
              learning_rate=learning_rate, weight_decay=1e-1,
              beta1=0.9, beta2=0.95, decay_lr=True,
              warmup_iters=int(max_steps * 0.3), lr_decay_iters=max_steps,
              min_lr=6e-5, eval_interval=max(100, max_steps // 10),
              eval_iters=5, log_interval=max(10, max_steps // 20),
              tokenizer_path=tok_path, dataset_path=[[train_p, val_p]],
              dtype=dtype, save_checkpoint_to=out_dir, random_seed=seed)
    trainer = Trainer(problem.model_config, tc, max_steps=max_steps,
                      ckpt_filename=f"problem_{task}.npz", device=device)
    trainer.init()
    trainer.load_data()
    trainer.start()

    cfg = ModelConfig.from_dict(problem.model_config)
    acc = problem.eval_batch(trainer.params, cfg, problem.tokenizer,
                             random.Random(seed + 1), n_eval)
    trainer.log(f"[{task}] exact-match accuracy over {n_eval} fresh samples: "
                f"{acc * 100:.1f}%")
    if export_bin:
        from nano_tpu_torch.io import binfmt
        binfmt.write_model(export_bin, trainer.params, cfg,
                           problem.tokenizer.config, quant="f32")
        trainer.log(f"[{task}] exported {export_bin}")
    return acc



def main(argv=None) -> None:
    """The root problem.py's command line, on the port (`--device`: cuda
    unless given)."""
    import argparse
    import tempfile
    ap = argparse.ArgumentParser(prog="python -m nano_tpu_torch.problems",
                                 description="Nano synthetic problems")
    ap.add_argument("task", choices=["sort", "palindrome", "q", "calculator"])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--seq_length", type=int, default=8)
    ap.add_argument("--n_train", type=int, default=50_000)
    ap.add_argument("--n_eval", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--seed", type=int, default=39)
    ap.add_argument("--n_layer", type=int, default=None)
    ap.add_argument("--n_embd", type=int, default=None)
    ap.add_argument("--n_head", type=int, default=None)
    ap.add_argument("--n_kv_head", type=int, default=None)
    ap.add_argument("--n_hidden", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda unless given; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    out_dir = args.out_dir or tempfile.mkdtemp(prefix=f"nano_{args.task}_")
    overrides = {k: getattr(args, k) for k in
                 ("n_layer", "n_embd", "n_head", "n_kv_head", "n_hidden")
                 if getattr(args, k) is not None}
    acc = run_problem(args.task, out_dir, seq_length=args.seq_length,
                      max_steps=args.steps, batch_size=args.batch,
                      n_train=args.n_train, n_eval=args.n_eval,
                      learning_rate=args.lr, seed=args.seed,
                      device=args.device, **overrides)
    print(f"{args.task}: exact-match accuracy {acc*100:.1f}% "
          f"(artifacts in {out_dir})")


if __name__ == "__main__":
    main()
