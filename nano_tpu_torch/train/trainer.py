"""Trainer — pretrain on one CUDA device, or data-, sequence-, pipeline-
and tensor-parallel over the ranks of a process group.

Port of ``nano_tpu/train/trainer.py``: AdamW with decay / no-decay
parameter groups, cosine LR schedule with linear warmup, gradient clipping
by global norm, gradient accumulation, bf16 activations with f32 master
parameters, eval-gated checkpoint policy (save when the val loss improves
or every ``forced_save_every`` steps, at ``eval_interval`` cadence),
resume, continued-pretrain batch replay, and throughput / FLOPS logging
with the same log lines.

What differs from the JAX package, by design:
  * a mesh is a process group (``parallel.mesh``; launch with torchrun):
    ``mesh_shape`` {"data": D, "seq": Q, "pipe": P, "model": M} over
    D * Q * P * M ranks, "data" defaulting to what the world leaves.
    Every rank draws the same global batch from the same seeded DataLoader
    and takes its rows (and under "seq" its columns); the loss is taken as
    sums (``gpt.loss_sums``) over the mask sum of the whole batch, so that
    their sum over "data" and "seq" is the masked mean of the whole batch
    as in the JAX Trainer; gradients are all-reduced over "data" and
    "seq" in buckets; under "seq" > 1 each rank's attention gathers k and
    v over the seq group (``mesh.SequenceParallel``); under "model" > 1
    the weights are cut Megatron-style (``mesh.shard_params``) and the
    blocks sum over the model group; under "pipe" > 1 the layer stacks are
    cut over the stages and a step is a GPipe schedule of
    ``pp_microbatches`` microbatches (``parallel.pipeline``; it composes
    with "data" only, as the JAX package's); the global-norm clip adds a
    cut leaf's squares over its group and a whole leaf's once, and AdamW
    runs on the cut leaves.  Only rank 0 logs and writes; a checkpoint
    holds the whole params and optimizer state (gathered over "model" or
    "pipe"), so the JAX package loads its params and a resume on the same
    mesh cuts them again.  The JAX Trainer shrinks "data" to a divisor of
    batch_size; a process group cannot shrink, so this one raises there;
    "pipe" with "seq" > 1 raises too (the JAX package runs the seq ranks
    of a pipeline as copies of each other);
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
serves on the base.  Under "model" > 1 the adapter is cut with the base's
plan (``mesh.cut_lora``): the gradients of the whole A's of q, k and v
are summed over the model group, the cut B's and wo's A stay local.

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
import torch.distributed as dist

from nano_tpu_torch import resolve_device
from nano_tpu_torch.config import ModelConfig, TrainConfig
from nano_tpu_torch.io import checkpoint as ckpt_io
from nano_tpu_torch.models import gpt
from nano_tpu_torch.parallel import mesh as meshlib
from nano_tpu_torch.parallel import pipeline
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

    def __init__(self, cfg: TrainConfig, params: Dict[str, Any],
                 cut: Optional[List[bool]] = None, cut_group=None):
        self.cfg = cfg
        # tensor or pipeline parallel: which leaves are cut over the model
        # or pipe group, whose squares the global norm adds over it (a
        # whole leaf's count once)
        self.cut, self.cut_group = cut, cut_group
        self.last_norm: Optional[torch.Tensor] = None  # before the clip
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
            norm = self.last_norm = self.global_norm(grads)
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

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The gradients' global norm: over a cut group, the cut leaves'
        squares summed over it and the whole leaves' once."""
        if self.cut_group is None:
            return torch.sqrt(sum((g * g).sum() for g in grads))
        sq = [sum(((g * g).sum() for g, c in zip(grads, self.cut) if c == k),
                  torch.zeros((), device=grads[0].device))
              for k in (True, False)]
        dist.all_reduce(sq[0], group=self.cut_group)
        return torch.sqrt(sq[0] + sq[1])

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

        # the mesh (None on one device), this rank's tensor-parallel plan,
        # the config its forward runs with (local heads under "model" > 1)
        # and the full shape of each params path
        self.mesh: Optional[meshlib.Mesh] = None
        self.tp: Optional[meshlib.TensorParallel] = None
        self.fwd_config = self.model_config
        self.full_shapes: Dict[str, Tuple[int, ...]] = {}

        self.dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                      "float16": torch.bfloat16}[self.train_config.dtype]

    # ------------------------------------------------------------
    @property
    def is_main(self) -> bool:
        """Whether this rank logs and writes (rank 0, or the only one)."""
        return self.mesh is None or self.mesh.rank == 0

    def log(self, msg: str) -> None:
        if not self.is_main:
            return
        logger.info(msg)
        print(msg, flush=True)

    def _open_log_file(self) -> None:
        """Timestamped train_*.log file for plot_loss.py.  Lands next to
        the checkpoints when a save path is configured, else in the cwd."""
        if self._file_handler is not None or not self.is_main:
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
        self.mesh = self._make_mesh()
        self.log(f"device: {self.device}")
        if self.mesh is not None:
            self.log(f"mesh: {self.mesh.shape} over {self.mesh.backend}")

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

        n_params = gpt.count_params(self.params, mc)
        trainable = self.lora if tc.use_lora else self.params
        self.full_shapes = {n: tuple(p.shape)
                            for n, p in gpt.param_leaves(trainable)}
        n_train = sum(int(p.numel()) for _, p in gpt.param_leaves(trainable))
        self.fwd_config = mc
        if self.mesh is not None:
            self._shard(mc)
        trainable = self.lora if tc.use_lora else self.params
        names = [n for n, _ in gpt.param_leaves(trainable)]
        self.opt = AdamW(tc, trainable, [self._cut_of(n) is not None
                                         for n in names], self._cut_group())
        if ck is not None and ck.has("opt") and not tc.use_lora:
            state = ck.load_opt_state()
            for key in ("mu", "nu"):
                state[key] = {n: self._cut(n, t)
                              for n, t in state[key].items()}
            self.opt.load_state_dict(state)

        self.flop_per_token = gpt.estimate_flops_per_token(mc, n_params)
        self.log(f"params: total={n_params:,} trainable={n_train:,}")

    def _make_mesh(self) -> Optional[meshlib.Mesh]:
        """The mesh of mesh_shape over the process group, or None on one
        device (no mesh asked for, and no group of more than one rank).
        Raises for what the JAX package refuses too: "pipe" with "model"
        or LoRA, layers that do not divide over "pipe", a sequence that
        does not divide over "seq"; and for "pipe" with "seq"."""
        tc, mc = self.train_config, self.model_config
        shape = {k: v for k, v in (tc.mesh_shape or {}).items() if v}
        n_model = shape.get(meshlib.MODEL_AXIS, 1)
        n_seq = shape.get(meshlib.SEQ_AXIS, 1)
        n_pipe = shape.get(meshlib.PIPE_AXIS, 1)
        if n_pipe > 1:
            if n_model > 1 or tc.use_lora:
                raise NotImplementedError(
                    f"mesh_shape {tc.mesh_shape}: pipeline parallelism "
                    f"composes with data parallelism only (not with "
                    f"'model' or LoRA), as in the JAX package")
            if n_seq > 1:
                raise NotImplementedError(
                    f"mesh_shape {tc.mesh_shape}: pipeline parallelism "
                    f"with 'seq' > 1")
            if mc.n_layer % n_pipe:
                raise ValueError(f"n_layer={mc.n_layer} does not divide "
                                 f"over pipe={n_pipe}")
        if mc.block_size % n_seq:
            raise ValueError(f"block_size {mc.block_size} does not divide "
                             f"over seq={n_seq}")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if math.prod(shape.values()) <= 1 and world == 1:
            return None
        n_data = shape.get(meshlib.DATA_AXIS,
                           max(world // (n_model * n_seq * n_pipe), 1))
        if tc.batch_size % n_data:
            raise ValueError(
                f"batch_size {tc.batch_size} does not divide over data="
                f"{n_data} (the JAX Trainer shrinks the axis; a process "
                f"group cannot)")
        if n_pipe > 1:
            b_loc = tc.batch_size // n_data
            if b_loc % (tc.pp_microbatches or pipeline.default_n_micro(
                    n_pipe, b_loc)):
                raise ValueError(
                    f"{b_loc} rows a data rank do not divide into "
                    f"pp_microbatches={tc.pp_microbatches}")
        if not dist.is_initialized():
            raise RuntimeError(
                f"mesh_shape {tc.mesh_shape} asks for more than one rank: "
                f"launch with torchrun (python -m torch.distributed.run "
                f"--nproc_per_node N -m nano_tpu_torch.train ...)")
        return meshlib.make_mesh(n_data=n_data, n_model=n_model,
                                 n_seq=n_seq, n_pipe=n_pipe)

    @property
    def _pp(self) -> bool:
        """Whether the step is a pipeline's (a mesh with "pipe" > 1)."""
        return (self.mesh is not None
                and self.mesh.size(meshlib.PIPE_AXIS) > 1)

    def _shard(self, mc: ModelConfig) -> None:
        """This rank's part of the params (and adapter) on the mesh, its
        tensor-parallel plan and the config its forward runs with."""
        mesh, tc = self.mesh, self.train_config
        if self._pp:
            self.params = pipeline.shard_params_pp(self.params, mesh,
                                                   mc.n_layer)
            return
        self.params, self.tp = meshlib.shard_params(
            self.params, mesh, mc,
            tensor_parallel=mesh.size(meshlib.MODEL_AXIS) > 1)
        if self.tp is not None and tc.use_lora:
            self.lora = {k: t.detach().requires_grad_(True) for k, t in
                         meshlib.cut_lora(self.lora, self.tp).items()}
        sp = meshlib.seq_parallel(mesh)
        if self.tp is not None or sp is not None:
            self.fwd_config = meshlib.local_config(mc, self.tp, sp)

    def _cut_of(self, path: str):
        """(dim, element ranges of it) of the params or adapter path that
        this rank holds, or None where it holds the whole leaf."""
        name = path.split("/")[-1]
        if self._pp and path.startswith("blocks/"):
            return 0, [pipeline.stage_layers(
                self.model_config.n_layer, self.mesh.size(meshlib.PIPE_AXIS),
                self.mesh.index(meshlib.PIPE_AXIS))]
        if self.tp is None or self.tp.ranges(name) is None:
            return None
        return meshlib.train_dim(name), self.tp.ranges(name)

    def _cut_group(self):
        """The group over which the cut leaves are split (None: none is)."""
        if self._pp:
            return self.mesh.group(meshlib.PIPE_AXIS)
        return None if self.tp is None else self.tp.group

    def _cut(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """A whole leaf of the params path -> this rank's part."""
        c = self._cut_of(path)
        return t if c is None else meshlib.cut_ranges(t, *c)

    def _whole(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the params path -> the whole leaf (every
        rank of the cut group calls this)."""
        c = self._cut_of(path)
        if c is None:
            return t
        return meshlib.gather_leaf(t, self.full_shapes[path], *c,
                                   self._cut_group())

    def _remat(self):
        tc = self.train_config
        return (tc.remat_policy if (tc.remat and tc.remat_policy != "full")
                else tc.remat)

    # ------------------------------------------------------------
    def _loss(self, x: np.ndarray, y: np.ndarray, m: np.ndarray,
              backward: bool = False) -> torch.Tensor:
        """The loss of a global batch (with `backward`, its gradient into
        ``.grad`` too): on a mesh, this rank's share of it (its nll sum over
        the mask sum of the whole batch), whose sum over the mesh
        (``_mesh_sum``) is the loss."""
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, torch.int64)
        tc = self.train_config
        lora = dict(lora=self.lora, lora_scale=(
            tc.lora_alpha / tc.lora_rank if tc.use_lora else 0.0))
        if self.mesh is None:
            loss = gpt.loss_fn(self.params, to(x), to(y), to(m),
                               self.model_config, dtype=self.dtype,
                               remat=self._remat(), ce_chunk=tc.ce_chunk,
                               **lora)
        else:
            # every rank holds the whole global batch: the mask sum of the
            # whole batch needs no collective
            denom = max(float(m.sum()), 1.0)
            x, y, m = meshlib.shard_batch((x, y, m), self.mesh)
            if self._pp:
                return pipeline.pp_step(
                    self.params, to(x), to(y), to(m), self.model_config,
                    self.mesh, denom, self.dtype, tc.pp_microbatches,
                    self._remat(), tc.ce_chunk, backward)
            s, _ = gpt.loss_sums(self.params, to(x), to(y), to(m),
                                 self.fwd_config, dtype=self.dtype,
                                 remat=self._remat(), ce_chunk=tc.ce_chunk,
                                 **lora)
            loss = s / denom
        if backward:
            loss.backward()                  # sums into .grad
        return loss.detach()

    def _mesh_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A rank's share of the loss summed over the axes that split the
        batch ("data", "seq") and the stages ("pipe"); t itself on one
        device."""
        if self.mesh is not None:
            for axis in (meshlib.DATA_AXIS, meshlib.SEQ_AXIS,
                         meshlib.PIPE_AXIS):
                if self.mesh.size(axis) > 1:
                    dist.all_reduce(t, group=self.mesh.group(axis))
        return t

    # gradient bytes of one all-reduce over "data" or "seq"
    BUCKET_BYTES = 256 << 20

    # whole leaves that a rank uses only in part under "model": the heads'
    # qk norms, and an adapter's A of q, k and v (its B cut on the heads)
    _PARTIAL_UNDER_TP = ("q_norm", "k_norm", "wq_a", "wk_a", "wv_a")

    def _reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """In place: sum over the model group the gradients of whole leaves
        that the rank's heads use in part (``_PARTIAL_UNDER_TP``), over the
        stages those of the leaves every stage holds whole (embeddings,
        norm, head: stage 0 and the last one read them), then every
        gradient over "data" and "seq", in buckets of up to
        BUCKET_BYTES."""
        names = self.opt.names
        if self.tp is not None:
            for n, g in zip(names, grads):
                if n.split("/")[-1] in self._PARTIAL_UNDER_TP:
                    dist.all_reduce(g, group=self.tp.group)
        if self._pp:
            for n, g in zip(names, grads):
                if not n.startswith("blocks/"):
                    dist.all_reduce(g, group=self.mesh.group(
                        meshlib.PIPE_AXIS))
        for axis in (meshlib.DATA_AXIS, meshlib.SEQ_AXIS):
            if self.mesh.size(axis) > 1:
                self._bucketed_sum(grads, self.mesh.group(axis))

    def _bucketed_sum(self, grads: List[torch.Tensor], group) -> None:
        """Every gradient summed over `group` in place, in buckets of up to
        BUCKET_BYTES."""
        bucket: List[torch.Tensor] = []
        for i, g in enumerate(grads):
            bucket.append(g)
            full = sum(t.numel() * t.element_size() for t in bucket)
            if full >= self.BUCKET_BYTES or i == len(grads) - 1:
                flat = torch.cat([t.reshape(-1) for t in bucket])
                dist.all_reduce(flat, group=group)
                off = 0
                for t in bucket:
                    t.copy_(flat[off:off + t.numel()].view_as(t))
                    off += t.numel()
                bucket = []

    def _train_step(self, xs, ys, ms) -> torch.Tensor:
        """xs: (accum, B, S).  One update from the mean of the
        microbatches' gradients; -> the microbatches' mean loss, on the
        device."""
        A = xs.shape[0]
        losses = [self._loss(xs[a], ys[a], ms[a], backward=True)
                  for a in range(A)]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.opt.params]
        if A > 1:
            grads = torch._foreach_div(grads, float(A))
        if self.mesh is not None:
            self._reduce_grads(grads)
        self.opt.update(grads)
        for p in self.opt.params:
            p.grad = None
        return self._mesh_sum(torch.stack(losses).mean())

    @torch.no_grad()
    def _eval_step(self, x, y, m) -> float:
        return float(self._mesh_sum(self._loss(x, y, m)))

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
        trainable = self.lora if tc.use_lora else self.params
        opt_state = self.opt.state_dict()
        if self._cut_group() is not None:
            trainable = gpt.map_leaves_with_path(self._whole, trainable)
            for key in ("mu", "nu"):
                opt_state[key] = {n: self._whole(n, t)
                                  for n, t in opt_state[key].items()}
        if self.is_main:
            ckpt_io.save_checkpoint(
                path, params=None if tc.use_lora else trainable,
                lora=trainable if tc.use_lora else None,
                opt_state=opt_state,
                step=self.step_count,
                model_config=self.model_config.to_dict(),
                train_config=self.train_config.to_dict(),
                tokenizer_config=(self.tokenizer.config if self.tokenizer
                                  else None))
        if self.mesh is not None:
            dist.barrier()              # the file is whole for every rank
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
