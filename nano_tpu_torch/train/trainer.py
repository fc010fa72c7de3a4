"""Trainer — pretrain on one CUDA device.

Port of ``nano_tpu/train/trainer.py``: AdamW with decay / no-decay
parameter groups, cosine LR schedule with linear warmup, gradient clipping
by global norm, gradient accumulation, bf16 activations with f32 master
parameters, eval-gated checkpoint policy (save when the val loss improves
or every ``forced_save_every`` steps, at ``eval_interval`` cadence),
resume, continued-pretrain batch replay, and throughput / FLOPS logging
with the same log lines.

What differs from the JAX package, by design:
  * one device.  ``mesh_shape`` and ``pp_microbatches`` stay fields of the
    config and are refused when they ask for more than one device;
  * the step is eager PyTorch: a Python loop over the accumulation
    microbatches, ``loss.backward()`` into ``.grad`` (the microbatches'
    gradients sum there and are divided by their number once), then the
    clip and the AdamW update written out in plain PyTorch so that both
    follow optax's arithmetic (``clip_by_global_norm`` scales by
    ``max_norm / norm`` only when ``norm >= max_norm``; ``adamw`` is
    ``p - lr * (m_hat / (sqrt(v_hat) + 1e-8) + wd * p)`` with the schedule
    read at the count before the update);
  * parameters are updated in place.

LoRA fine-tuning (``use_lora``, reference: train.py:225-237) starts a
fresh adapter (``gpt.init_lora_params``, rank ``lora_rank``) at step 0 on
the pretrained base of ``from_checkpoint``; the base is frozen (no
gradient, untouched by AdamW, which holds the adapter's leaves alone), the
loss scales the adapter by lora_alpha / lora_rank, and checkpoints hold
the adapter alone (``is_lora``), which ``LLMContext.load_lora_checkpoint``
serves on the base.

On a CUDA device every layer's attention runs the flash-attention
kernels, forward and backward (``ops.flash_attn``): in a LoRA fine-tune
the backward carries each layer's gradient down to the adapters of the
layers below.  A step is bit-reproducible, so a resumed run continues the
trajectory exactly.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nano_tpu_torch import resolve_device
from nano_tpu_torch.config import ModelConfig, TrainConfig
from nano_tpu_torch.io import checkpoint as ckpt_io
from nano_tpu_torch.models import gpt
from nano_tpu_torch.tokenizer.trie import TrieTokenizer
from nano_tpu_torch.train.data import DataLoader

logger = logging.getLogger(__name__)


# =====================================================================
# LR schedule (reference: train.py:346-358)
# =====================================================================

def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> learning rate: linear warmup to ``learning_rate`` over
    ``warmup_iters`` steps (step 0 already gets 1/warmup of it), then a
    cosine from there to ``min_lr`` at ``lr_decay_iters``."""
    def lr(step: int) -> float:
        if not cfg.decay_lr:
            return cfg.learning_rate
        if step < cfg.warmup_iters:
            return cfg.learning_rate * (step + 1) / max(cfg.warmup_iters, 1)
        ratio = ((step - cfg.warmup_iters)
                 / max(cfg.lr_decay_iters - cfg.warmup_iters, 1))
        ratio = min(max(ratio, 0.0), 1.0)
        coeff = 0.5 * (1.0 + math.cos(math.pi * ratio))
        return cfg.min_lr + coeff * (cfg.learning_rate - cfg.min_lr)
    return lr


# =====================================================================
# optimizer: AdamW with decay only on matrix-like params.  The stacked
# norm weights are (L, E), so the mask goes by NAME, not by dim >= 2.
# =====================================================================

_NO_DECAY_NAMES = ("attn_norm", "ffn_norm", "norm", "q_norm", "k_norm",
                   "bq", "bk", "bv")


def _decay_mask(params: Any) -> Any:
    def walk(tree, under_name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return under_name not in _NO_DECAY_NAMES
    return walk(params)


_MU_DTYPES = {None: torch.float32, "float32": torch.float32,
              "bfloat16": torch.bfloat16}


class AdamW:
    """optax's ``chain(clip_by_global_norm, adamw(schedule, mask))`` over
    the leaves of a params dict, in plain PyTorch (``torch._foreach_*``).

    State: ``count`` (updates so far), ``mu`` (first moment, in
    ``adam_mu_dtype``) and ``nu`` (second moment, f32) per leaf, in the
    order of ``gpt.param_leaves``.  The moments' arithmetic runs in f32
    whatever ``mu`` is stored in, as in optax.
    """

    def __init__(self, cfg: TrainConfig, params: Dict[str, Any]):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        named = gpt.param_leaves(params)
        decay = dict(gpt.param_leaves(_decay_mask(params)))
        self.names = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.decays = [decay[n] for n in self.names]
        mu_dtype = _MU_DTYPES[cfg.adam_mu_dtype]
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        """One optimizer step from `grads` (in the params' order), in
        place.  No value leaves the device."""
        cfg = self.cfg
        grads = [g.float() for g in grads]
        if cfg.grad_clip > 0:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            clipped = torch._foreach_div(grads, norm)
            torch._foreach_mul_(clipped, cfg.grad_clip)
            keep = norm < cfg.grad_clip
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = cfg.beta1, cfg.beta2
        mu = [m.float() for m in self.mu]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, 1e-8)
        upd = torch._foreach_div(mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(upd, denom)
        if cfg.weight_decay:
            decayed = [(u, p) for u, p, d in zip(upd, self.params, self.decays)
                       if d]
            torch._foreach_add_([u for u, _ in decayed],
                                [p for _, p in decayed],
                                alpha=cfg.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        for stored, m in zip(self.mu, mu):
            if stored is not m:
                stored.copy_(m)

    def state_dict(self) -> Dict[str, Any]:
        """The flat checkpoint layout: count, mu/<path>, nu/<path>."""
        return {"count": np.asarray(self.count, np.int64),
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for dst, src in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for name, t in zip(self.names, dst):
                t.copy_(src[name])


# =====================================================================
# Trainer
# =====================================================================

class Trainer:
    """End-to-end training loop (reference TrainGPT, train.py:122).

    usage:
        t = Trainer(model_cfg_dict, train_cfg_dict, max_steps=...)
        t.init()
        t.load_data()
        t.start()

    Runs on ``cuda`` unless `device` says otherwise.
    """

    def __init__(self, model_config, train_config,
                 max_steps: int = 10 ** 10,
                 ckpt_filename: Optional[str] = None,
                 is_continued_pretrain: bool = False,
                 device=None):
        self.model_config = (model_config if isinstance(model_config, ModelConfig)
                             else ModelConfig.from_dict(model_config))
        self.train_config = (train_config if isinstance(train_config, TrainConfig)
                             else TrainConfig.from_dict(train_config))
        self.max_steps = max_steps
        self.ckpt_filename = ckpt_filename or "checkpoint.npz"
        self.is_continued_pretrain = is_continued_pretrain
        self.device = resolve_device(device)

        self.params = None
        self.lora = None                # the adapter a LoRA fine-tune trains
        self.opt: Optional[AdamW] = None
        self.step_count = 0
        self.tokenizer: Optional[TrieTokenizer] = None
        self.train_data: Optional[DataLoader] = None
        self.val_data: Optional[DataLoader] = None
        self.best_val_loss = float("inf")
        self._pending_skip = 0          # continued-pretrain replay batches
        self.forced_save_every = 1000   # reference: train.py:391-396
        self.loss_history: list = []

        self.log_file: Optional[str] = None
        self._file_handler: Optional[logging.Handler] = None

        self.dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                      "float16": torch.bfloat16}[self.train_config.dtype]

    # ------------------------------------------------------------
    def log(self, msg: str) -> None:
        logger.info(msg)
        print(msg, flush=True)

    def _open_log_file(self) -> None:
        """Timestamped train_*.log file for plot_loss.py.  Lands next to
        the checkpoints when a save path is configured, else in the cwd."""
        if self._file_handler is not None:
            return
        tc = self.train_config
        dest = tc.save_checkpoint_to or "."
        log_dir = (os.path.dirname(dest) or ".") if dest.endswith(".npz") else dest
        os.makedirs(log_dir, exist_ok=True)
        self.log_file = os.path.join(
            log_dir, time.strftime("train_%Y%m%d_%H%M%S.log"))
        self._file_handler = logging.FileHandler(self.log_file,
                                                 encoding="utf-8")
        self._file_handler.setFormatter(
            logging.Formatter("%(asctime)s | %(message)s"))
        logger.addHandler(self._file_handler)
        if logger.getEffectiveLevel() > logging.INFO:
            logger.setLevel(logging.INFO)

    def close_log_file(self) -> None:
        if self._file_handler is not None:
            logger.removeHandler(self._file_handler)
            self._file_handler.close()
            self._file_handler = None

    # ------------------------------------------------------------
    def init(self) -> None:
        tc, mc = self.train_config, self.model_config
        if tc.use_lora and not tc.from_checkpoint:
            raise NotImplementedError(
                "LoRA fine-tuning trains an adapter on a pretrained base: "
                "set from_checkpoint (a fresh model with LoRA is not "
                "implemented)")
        n_devices = math.prod(v for v in (tc.mesh_shape or {}).values() if v)
        if n_devices > 1:
            raise NotImplementedError(
                f"mesh_shape {tc.mesh_shape} asks for {n_devices} devices; "
                f"multi-device training is not ported yet")
        self.log(f"device: {self.device}")

        rng = torch.Generator().manual_seed(tc.random_seed)
        ck = None
        if tc.from_checkpoint:
            ck = ckpt_io.Checkpoint(tc.from_checkpoint)
            self.model_config = mc = ModelConfig.from_dict(ck.model_config)
            # a run saved without a tokenizer stores tokenizer_config=None
            self.tokenizer = (TrieTokenizer.from_config_dict(
                ck.tokenizer_config) if ck.tokenizer_config else None)
            self.params = gpt.map_leaves(
                lambda t: t.to(self.device).requires_grad_(not tc.use_lora),
                ck.load_params())
            if tc.use_lora:
                # a fresh adapter at step 0 on the frozen base
                self.step_count = 0
                self.lora = gpt.map_leaves(
                    lambda t: t.requires_grad_(True),
                    gpt.init_lora_params(rng, mc, tc.lora_rank,
                                         device=self.device))
                self.log(f"LoRA fine-tune from `{tc.from_checkpoint}` "
                         f"(rank={tc.lora_rank})")
            else:
                self.step_count = ck.step
                self.log(f"resumed from `{tc.from_checkpoint}` at step "
                         f"{self.step_count}")
        else:
            if tc.tokenizer_path:
                self.tokenizer = TrieTokenizer.from_file(tc.tokenizer_path)
                if self.tokenizer.vocab_size > mc.vocab_size:
                    self.log("WARNING: model vocab_size < tokenizer vocab_size")
            self.params = gpt.init_params(
                rng, mc, param_dtype=getattr(torch, tc.param_dtype),
                device=self.device)
            self.log("initialized new model")

        self.opt = AdamW(tc, self.lora if tc.use_lora else self.params)
        if ck is not None and ck.has("opt") and not tc.use_lora:
            self.opt.load_state_dict(ck.load_opt_state())

        n_params = gpt.count_params(self.params, mc)
        n_train = sum(int(p.numel()) for p in self.opt.params)
        self.flop_per_token = gpt.estimate_flops_per_token(mc, n_params)
        self.log(f"params: total={n_params:,} trainable={n_train:,}")

    def _remat(self):
        tc = self.train_config
        return (tc.remat_policy if (tc.remat and tc.remat_policy != "full")
                else tc.remat)

    # ------------------------------------------------------------
    def _loss(self, x: np.ndarray, y: np.ndarray, m: np.ndarray
              ) -> torch.Tensor:
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, torch.int64)
        tc = self.train_config
        return gpt.loss_fn(self.params, to(x), to(y), to(m),
                           self.model_config, dtype=self.dtype,
                           remat=self._remat(), ce_chunk=tc.ce_chunk,
                           lora=self.lora,
                           lora_scale=(tc.lora_alpha / tc.lora_rank
                                       if tc.use_lora else 0.0))

    def _train_step(self, xs, ys, ms) -> torch.Tensor:
        """xs: (accum, B, S).  One update from the mean of the
        microbatches' gradients; -> the microbatches' mean loss, on the
        device."""
        A = xs.shape[0]
        losses = []
        for a in range(A):
            loss = self._loss(xs[a], ys[a], ms[a])
            loss.backward()                  # sums into .grad
            losses.append(loss.detach())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.opt.params]
        if A > 1:
            grads = torch._foreach_div(grads, float(A))
        self.opt.update(grads)
        for p in self.opt.params:
            p.grad = None
        return torch.stack(losses).mean()

    @torch.no_grad()
    def _eval_step(self, x, y, m) -> float:
        return float(self._loss(x, y, m))

    # ------------------------------------------------------------
    def load_data(self) -> None:
        tc = self.train_config
        if not tc.dataset_path:
            raise ValueError("train_config.dataset_path required")
        train_files = [p[0] for p in tc.dataset_path]
        val_files = [p[1] for p in tc.dataset_path]
        self.train_data = DataLoader(train_files, seed=tc.random_seed,
                                     max_resident=tc.max_resident_shards)
        self.val_data = DataLoader(val_files, seed=tc.random_seed,
                                   max_resident=tc.max_resident_shards)
        self.log(f"dataset: {self.train_data.total_samples:,} train / "
                 f"{self.val_data.total_samples:,} val samples")
        if self.is_continued_pretrain and self.step_count > 0:
            # deferred to _run(): denoise replay must also burn the RNG
            # draws get_batch made, and denoise-ness is only known there
            self._pending_skip = self.step_count * \
                tc.gradient_accumulation_steps

    # ------------------------------------------------------------
    def _get_accum_batch(self, denoise: bool = False):
        tc, mc = self.train_config, self.model_config
        xs, ys, ms = [], [], []
        for _ in range(tc.gradient_accumulation_steps):
            x, y, m = self.train_data.get_batch(
                tc.batch_size, mc.block_size, is_causal=mc.is_causal,
                denoise=denoise)
            xs.append(x)
            ys.append(y)
            ms.append(m)
        return (np.stack(xs), np.stack(ys), np.stack(ms))

    def estimate_loss(self) -> Tuple[float, float]:
        """(train_loss, val_loss) over eval_iters batches (train.py:331-344)."""
        tc, mc = self.train_config, self.model_config
        losses = {"train": [], "val": []}
        for split, loader in (("train", self.train_data), ("val", self.val_data)):
            st = loader.state()   # eval must not advance the training
            # stream (it would desync continued-pretrain replay)
            for _ in range(tc.eval_iters):
                x, y, m = loader.get_batch(tc.batch_size, mc.block_size,
                                           is_causal=mc.is_causal)
                losses[split].append(self._eval_step(x, y, m))
            loader.set_state(st)
        return float(np.mean(losses["train"])), float(np.mean(losses["val"]))

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        tc = self.train_config
        if path is None:
            dest = tc.save_checkpoint_to or "."
            if dest.endswith(".npz"):    # a file path, not a directory
                path = dest
                os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
            else:
                os.makedirs(dest, exist_ok=True)
                path = os.path.join(dest, self.ckpt_filename)
        ckpt_io.save_checkpoint(
            path,
            params=None if tc.use_lora else self.params,
            lora=self.lora if tc.use_lora else None,
            opt_state=self.opt.state_dict(),
            step=self.step_count,
            model_config=self.model_config.to_dict(),
            train_config=self.train_config.to_dict(),
            tokenizer_config=self.tokenizer.config if self.tokenizer else None)
        self.log(f"checkpoint saved to {path}")
        return path

    # ------------------------------------------------------------
    def start(self, denoise: bool = False) -> None:
        self._open_log_file()
        try:
            self._run(denoise=denoise)
        finally:
            self.close_log_file()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, denoise: bool = False) -> None:
        tc = self.train_config
        if self._pending_skip:
            self.log(f"replaying {self._pending_skip} batches for "
                     f"continued pretrain")
            self.train_data.skip_batches(
                self._pending_skip, tc.batch_size, denoise=denoise,
                block_size=self.model_config.block_size)
            self._pending_skip = 0

        tokens_per_step = (tc.batch_size * tc.gradient_accumulation_steps *
                           self.model_config.block_size)
        self.log(f"training: batch={tc.batch_size} accum="
                 f"{tc.gradient_accumulation_steps} tokens/step={tokens_per_step}")

        start_step = self.step_count
        win_t0, win_steps = time.time(), 0
        while self.step_count < self.max_steps:
            # eval + checkpoint policy (reference: train.py:391-430,
            # incl. its `iter > start_step` gate: no untrained-model
            # checkpoint at step 0, no redundant eval+save on resume)
            if (self.step_count % tc.eval_interval == 0
                    and self.step_count > start_step):
                tr_loss, val_loss = self.estimate_loss()
                self.log(f"Step {self.step_count} | Eval | TrainLoss: "
                         f"{tr_loss:.4f} | ValLoss: {val_loss:.4f}")
                improved = val_loss < self.best_val_loss
                if improved:
                    self.best_val_loss = val_loss
                if improved or self.step_count % self.forced_save_every == 0:
                    self.save_checkpoint()

            # timing window restarts AFTER eval/checkpoint so the logged
            # ms/step + GFLOP/s never fold eval time in
            if self.step_count % tc.eval_interval == 0:
                self._sync()
                win_t0, win_steps = time.time(), 0
            # batch prep overlaps device compute: the step before was only
            # enqueued, so this host work runs while the card is busy
            xs, ys, ms = self._get_accum_batch(denoise=denoise)
            loss = self._train_step(xs, ys, ms)

            self.step_count += 1
            win_steps += 1
            if self.step_count % tc.log_interval == 0:
                # the loss readback is the completion barrier: launches are
                # asynchronous, so ms/step is averaged over the whole
                # window after fetching a value that depends on every step
                # in it
                loss_f = float(loss)
                dt = (time.time() - win_t0) / max(win_steps, 1)
                win_t0, win_steps = time.time(), 0
                self.loss_history.append((self.step_count, loss_f))
                # flop_per_token is the PaLM fwd+bwd formula (6N + 12LHQT)
                # already — no extra factor, same semantics as the
                # reference's log line (reference: train.py:485)
                flops = self.flop_per_token * tokens_per_step / dt
                self.log(
                    f"Epoch: {self.train_data.epoch} | Step: {self.step_count} "
                    f"| Loss: {loss_f:.4f} | {dt*1000:.0f} ms/step, "
                    f"{flops/1e9:.1f} GFLOP/s, {tokens_per_step/dt:.0f} tokens/s")

        self.save_checkpoint()
        self.log("training finished")
