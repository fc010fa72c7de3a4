"""Device mesh and the cuts of tensor parallelism, on ``torch.distributed``.

Port of ``nano_tpu/parallel/mesh.py``.  The JAX package declares a
``jax.sharding.Mesh`` and annotates arrays with shardings; XLA inserts the
collectives.  Here each rank is one process with a plain local tensor per
leaf, and the collectives are explicit code:

  * "data" (data parallel): every rank takes its contiguous rows of the
    global batch (``batch_rows``); the trainer all-reduces the gradients
    and the loss's sums over the data group.
  * "seq" (sequence parallel): every rank takes its contiguous S / n_seq
    columns of its rows (``batch_rows`` / ``batch_cols``); the model's
    attention all-gathers k and v over the seq group and runs its queries
    at their offset against the whole sequence (``SequenceParallel``);
    the trainer sums the loss's sums and the gradients over "seq" as over
    "data" (the params are whole on every seq rank).
  * "pipe" (pipeline parallel, ``parallel.pipeline``): the layer stacks
    are cut on the layer axis, each stage runs its layers on microbatches
    and hands its activations on (``send`` / ``recv``).
  * "model" (tensor parallel, Megatron-style): attention heads and the FFN
    hidden units are cut over the model group.  wq / wk / wv / w1 / w3
    (and the fused wqkv / w13 of a .bin file, part by part) keep this
    rank's output rows, wo / w2 its input rows; norms, embeddings and the
    head stay whole.  The block all-reduces the row-parallel products'
    partial sums (``TensorParallel``); in training two autograd functions
    put the all-reduce of the column-parallel input's gradient into the
    backward (``TensorParallel.enter`` / ``leave``).  A LoRA adapter is
    cut with the same plan (``cut_lora``).

The tensors stay plain: the kernels launch through ``ctypes`` on local
tensors, which a DTensor cannot carry a sharding through.

Rank order is the JAX mesh's: axes ("data", "seq", "pipe", "model"),
"model" innermost, "seq" and "pipe" only where larger than 1, so rank =
((d * n_seq + s) * n_pipe + p) * n_model + m.

The collectives beside all-reduce go through one transport
(``all_gather``, ``reduce_scatter``, ``send``, ``recv``), chosen by the
group's backend: NCCL runs all four on CUDA tensors and gloo all four on
CPU tensors; gloo also takes CUDA tensors for all-gather and
reduce-scatter (as for all-reduce, broadcast and barrier), but not for
send and recv (its transport is handed the device pointer: the sender
aborts; ``chip_smoke.py bench gloo``), so between ranks that share a card
a send or recv is staged through host memory.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nano_tpu_torch import resolve_device
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.ops.q4k import BLOCK_LEN, Q4KTensor
from nano_tpu_torch.ops.qmatmul import Q80Tensor

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"      # sequence parallel
PIPE_AXIS = "pipe"    # pipeline parallel (parallel/pipeline.py)
AXES = (DATA_AXIS, SEQ_AXIS, PIPE_AXIS, MODEL_AXIS)   # outermost first

# how long a collective may wait for the other ranks
TIMEOUT = datetime.timedelta(minutes=10)


def maybe_distributed_init(backend: Optional[str] = None,
                           device=None) -> bool:
    """Join the process group of a torchrun-style launch (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT in the environment,
    as torchrun sets them; reference: train.py:171-186).  -> whether a
    process group is up.  Without RANK / WORLD_SIZE this does nothing.

    `device` is the entry point's (cuda unless the caller asks for the
    CPU).  On CUDA the rank takes card LOCAL_RANK and the backend is NCCL;
    NCCL takes one card a rank, so more ranks on a host than it has cards
    raise, and ranks that share a card must ask for ``backend="gloo"``
    (whose CUDA all-reduce and broadcast copy through the host).  On the
    CPU the backend is gloo.  Nothing switches backend or device on its
    own."""
    if dist.is_initialized():
        return True
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend = backend or "nccl"
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_world > cards:
            raise RuntimeError(
                f"NCCL takes one card a rank, and {local_world} ranks on "
                f"this host share {cards} card(s); to run them on shared "
                f"cards ask for backend='gloo'")
        torch.cuda.set_device(local % cards)
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return True


@dataclass
class Mesh:
    """This rank's place in a ("data", "seq", "pipe", "model") grid of
    ranks and the process group of each axis: ``group(MODEL_AXIS)`` holds
    the ranks that differ from this one in "model" only, in the order of
    their "model" index."""
    shape: Dict[str, int]                 # axis -> size, outermost first
    rank: int
    backend: str
    groups: Dict[str, Any] = field(repr=False)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def _stride(self, axis: str) -> int:
        """Ranks between neighbours along `axis`."""
        inner = AXES[AXES.index(axis) + 1:]
        return math.prod(self.size(a) for a in inner)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.rank // self._stride(axis) % self.size(axis)

    def rank_at(self, axis: str, i: int) -> int:
        """The global rank of the rank that differs from this one in its
        `axis` coordinate only, which is i there."""
        return self.rank + (i - self.index(axis)) * self._stride(axis)

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              n_seq: int = 1, n_pipe: int = 1) -> Mesh:
    """The ("data", "seq", "pipe", "model") mesh over the process group
    (every rank calls this, in the same order as every other group it
    makes): rank = ((d * n_seq + s) * n_pipe + p) * n_model + m, "seq" and
    "pipe" in the shape only where larger than 1, as in the JAX package.
    n_data defaults to what the world leaves."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: launch with torchrun (or "
            "nano_tpu_torch.parallel.launch) and call maybe_distributed_init")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // (n_model * n_seq * n_pipe)
    if n_data * n_seq * n_pipe * n_model != world:
        raise ValueError(
            f"mesh data={n_data} x seq={n_seq} x pipe={n_pipe} x model="
            f"{n_model} does not match the {world} ranks of the process "
            f"group")
    shape = {DATA_AXIS: n_data}
    if n_seq > 1:
        shape[SEQ_AXIS] = n_seq
    if n_pipe > 1:
        shape[PIPE_AXIS] = n_pipe
    shape[MODEL_AXIS] = n_model
    mesh = Mesh(shape=shape, rank=dist.get_rank(),
                backend=dist.get_backend(), groups={})
    # every rank makes every group, in one order: for each axis, one group
    # for each coordinate of the other axes
    for axis in shape:
        stride = mesh._stride(axis)
        for base in range(world):
            if base // stride % shape[axis]:
                continue                # not the axis' first rank
            ranks = [base + i * stride for i in range(shape[axis])]
            g = dist.new_group(ranks)
            if mesh.rank in ranks:
                mesh.groups[axis] = g
    return mesh


# =====================================================================
# the transport: all-gather, reduce-scatter, send and recv
# =====================================================================

def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors (of t's shape) concatenated along `dim` in the
    order of the group's ranks."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's part along `dim` (the r-th of n equal parts) of the sum
    of the group's tensors, summed in f32 and rounded to t's type once."""
    n = dist.get_world_size(group)
    parts = [p.contiguous() for p in t.float().split(t.shape[dim] // n,
                                                     dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(t.dtype)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a send or recv of t over `group` goes through host memory:
    a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def send(t: torch.Tensor, dst: int, group) -> None:
    """t to global rank `dst` of `group` (staged through host memory for
    gloo and a CUDA tensor)."""
    t = t.detach().contiguous()
    dist.send(t.cpu() if _staged(t, group) else t, dst, group=group)


def recv(shape: Sequence[int], dtype, device, src: int, group
         ) -> torch.Tensor:
    """A tensor of `shape` and `dtype` from global rank `src` of `group`,
    on `device`."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if not _staged(out, group):
        dist.recv(out, src, group=group)
        return out
    host = torch.empty(tuple(shape), dtype=dtype)
    dist.recv(host, src, group=group)
    return out.copy_(host)


# =====================================================================
# the batch: contiguous rows over "data", columns over "seq"
# =====================================================================

def batch_spec(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    """The axes a (B, S) batch is cut on: B over "data" and, where the
    mesh has it, S over "seq" (the JAX P("data"[, "seq"]))."""
    if mesh is not None and mesh.size(SEQ_AXIS) > 1:
        return (DATA_AXIS, SEQ_AXIS)
    return (DATA_AXIS,)


def batch_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of n rows: the contiguous d-th
    of n_data equal parts, as NamedSharding(P("data")) lays them out."""
    nd = mesh.size(DATA_AXIS)
    if n % nd:
        raise ValueError(f"a batch of {n} rows does not divide over "
                         f"data={nd}")
    b = n // nd
    d = mesh.index(DATA_AXIS)
    return slice(d * b, (d + 1) * b)


def batch_cols(n: int, mesh: Mesh) -> slice:
    """This rank's columns of a sequence of n positions: the contiguous
    s-th of n_seq equal parts, as NamedSharding(P(..., "seq")) lays them
    out."""
    ns = mesh.size(SEQ_AXIS)
    if n % ns:
        raise ValueError(f"a sequence of {n} positions does not divide over "
                         f"seq={ns}")
    c = n // ns
    s = mesh.index(SEQ_AXIS)
    return slice(s * c, (s + 1) * c)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows (and, under "seq", columns) of every (B, S, ...)
    array or tensor in `batch` (a tuple, list or single array)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    rows = batch[batch_rows(len(batch), mesh)]
    if mesh.size(SEQ_AXIS) > 1:
        return rows[:, batch_cols(rows.shape[1], mesh)]
    return rows


# =====================================================================
# sequence parallelism: K/V gathered over "seq"
# =====================================================================

@dataclass
class SequenceParallel:
    """A rank's part in sequence parallelism over its mesh's "seq" group:
    it holds the positions [index * S_local, (index + 1) * S_local) of
    each row.  ``gather`` is the all-gather of k or v along S, whose
    backward is the reduce-scatter (the sum over the ranks, each keeping
    its own positions) of their gradients."""
    size: int
    index: int
    group: Any = field(default=None, repr=False, compare=False)

    def offset(self, s_local: int) -> int:
        """The position of this rank's first query."""
        return self.index * s_local

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S_local, ...) -> (B, S_local * size, ...), the seq group's
        positions in order; differentiable."""
        return _GatherSeq.apply(x, self)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return all_gather(x, sp.group, 1)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.sp.group, 1), None


def seq_parallel(mesh: Mesh) -> Optional[SequenceParallel]:
    """This rank's SequenceParallel, None where the mesh has no "seq"."""
    if mesh.size(SEQ_AXIS) == 1:
        return None
    return SequenceParallel(size=mesh.size(SEQ_AXIS),
                            index=mesh.index(SEQ_AXIS),
                            group=mesh.group(SEQ_AXIS))


# =====================================================================
# tensor parallelism: the cut plan and the collectives
# =====================================================================

def _split(n_units: int, size: int, r: int) -> Tuple[int, int]:
    """Rank r's units of n_units cut over size ranks on unit boundaries,
    the first n_units % size ranks one more (38 over 4: 10/10/9/9)."""
    base, extra = divmod(n_units, size)
    lo = r * base + min(r, extra)
    return lo, lo + base + (r < extra)


def _quant_unit(w) -> int:
    """The inputs a row-parallel cut of `w` must keep together: a Q80
    group (its scale, and for W8A8 the activation's quantization), a Q4K
    block of 256 (the activation's fake-quant runs per block), else 1."""
    if isinstance(w, Q80Tensor):
        return w.group_size
    if isinstance(w, Q4KTensor):
        return BLOCK_LEN
    return 1


@dataclass
class TensorParallel:
    """A rank's part in tensor parallelism over its mesh's "model" group,
    from shapes alone (every rank computes every rank's plan alike).

    heads / kv_heads: this rank's query and KV heads [lo, hi).  With fewer
    KV heads than ranks each rank keeps the one its query heads read.
    attn "row": wo keeps the input rows of the rank's heads and the block
    all-reduces its partial sums; "gather": the rank's heads cannot be cut
    on wo's quantization units, so they are gathered and every rank runs
    the whole wo.  ffn: the hidden units [lo, hi) of w1 / w3 / w2, cut on
    w2's units (unevenly where they do not divide: Qwen3-4B's 38 Q80
    groups over 4 ranks give 10/10/9/9); ffn_mode "replicated" where there
    are fewer units than ranks (the whole FFN on every rank, no sum)."""
    size: int
    rank: int
    n_head: int
    n_kv_head: int
    head_dim: int
    n_hidden: int
    heads: Tuple[int, int]
    kv_heads: Tuple[int, int]
    attn: str
    ffn: Tuple[int, int]
    ffn_mode: str
    group: Any = field(default=None, repr=False, compare=False)
    backend: str = "gloo"

    # ---- the collectives ----
    def all_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """y summed over the model group, in place (y is f32)."""
        dist.all_reduce(y, group=self.group)
        return y

    def _sum(self, y: torch.Tensor) -> torch.Tensor:
        """A copy of y summed over the model group in f32, in y's dtype."""
        s = y.to(torch.float32, memory_format=torch.contiguous_format,
                 copy=True)
        return self.all_reduce(s).to(y.dtype)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial products y (a row-parallel
        product's output, which the caller gives up): an all-reduce
        forward, the identity backward.  Without a gradient to take, an
        f32 y is summed in place."""
        if torch.is_grad_enabled() and y.requires_grad:
            return _ReduceFromModel.apply(y, self)
        return self.all_reduce(y.float().contiguous()).to(y.dtype)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """x as it is forward, its gradient all-reduced backward (before
        the column-parallel products that read a whole activation)."""
        if not torch.is_grad_enabled():
            return x
        return _CopyToModel.apply(x, self)

    def gather_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(..., local heads * D) -> (..., all heads * D): each rank writes
        its heads into zeros and the model group sums them (an all-gather
        by all-reduce, which gloo also runs on CUDA tensors; exact)."""
        D = self.head_dim
        full = torch.zeros(*x.shape[:-1], self.n_head * D,
                           dtype=torch.float32, device=x.device)
        full[..., self.heads[0] * D:self.heads[1] * D] = x.float()
        return self.all_reduce(full).to(x.dtype)

    # ---- the element ranges of each leaf ----
    def _q(self) -> Tuple[int, int]:
        return self.heads[0] * self.head_dim, self.heads[1] * self.head_dim

    def _kv(self) -> Tuple[int, int]:
        return (self.kv_heads[0] * self.head_dim,
                self.kv_heads[1] * self.head_dim)

    def ranges(self, name: str) -> Optional[List[Tuple[int, int]]]:
        """The element ranges of leaf `name`'s cut dimension (out for
        column-parallel leaves, in for row-parallel ones) that this rank
        keeps, in order; None: the whole leaf.  A LoRA adapter's B of q,
        k and v keeps the output columns of the rank's heads, and wo's A
        the input rows of wo's cut; the other factors stay whole."""
        D = self.head_dim
        q, kv = self._q(), self._kv()
        shift = lambda r, o: (r[0] + o, r[1] + o)
        HD, KD = self.n_head * D, self.n_kv_head * D
        if name in ("wq", "bq"):
            return [q]
        if name in ("wk", "wv", "bk", "bv"):
            return [kv]
        if name == "wqkv":
            return [q, shift(kv, HD), shift(kv, HD + KD)]
        if name in ("wo", "wo_a"):
            return [q] if self.attn == "row" else None
        if name == "wq_b":
            return [q]
        if name in ("wk_b", "wv_b"):
            return [kv]
        if name in _LORA:
            return None
        if self.ffn_mode == "replicated":
            return None
        if name in ("w1", "w3", "w2"):
            return [self.ffn]
        if name == "w13":
            return [self.ffn, shift(self.ffn, self.n_hidden)]
        return None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._sum(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, tp):
        return tp._sum(y)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_plan(cfg: ModelConfig, size: int, rank: int, wo=None, w2=None,
            even: bool = False) -> TensorParallel:
    """Rank `rank`'s TensorParallel over `size` ranks for a model of
    `cfg` whose wo and w2 are `wo` / `w2` (their quantization sets the
    units a row-parallel cut keeps together; dense when None).  `even`
    (training) asks for equal cuts of heads, KV heads and hidden units and
    raises where they do not divide."""
    H, KV, D, F = cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.n_hidden
    if H % size:
        raise ValueError(f"{H} attention heads do not divide over "
                         f"model={size}")
    h = H // size
    heads = (rank * h, (rank + 1) * h)
    if KV % size == 0:
        kv_heads = (rank * KV // size, (rank + 1) * KV // size)
    elif size % KV == 0 and not even:
        first = heads[0] // (H // KV)       # the KV head these heads read
        kv_heads = (first, first + 1)
    else:
        raise ValueError(f"{KV} KV heads do not divide over model={size}"
                         + ("" if even else " (nor model over them)"))
    attn = "row" if (h * D) % _quant_unit(wo) == 0 else "gather"
    unit = _quant_unit(w2)
    n_units = -(-F // unit)
    if even and F % size:
        raise ValueError(f"n_hidden={F} does not divide over model={size}")
    if n_units >= size:
        lo, hi = _split(n_units, size, rank)
        ffn, ffn_mode = (lo * unit, min(hi * unit, F)), "row"
    else:
        ffn, ffn_mode = (0, F), "replicated"
    return TensorParallel(size=size, rank=rank, n_head=H, n_kv_head=KV,
                          head_dim=D, n_hidden=F, heads=heads,
                          kv_heads=kv_heads, attn=attn, ffn=ffn,
                          ffn_mode=ffn_mode)


@dataclass(frozen=True)
class ShardedConfig(ModelConfig):
    """A rank's view of a ModelConfig under tensor and sequence
    parallelism: n_head and n_kv_head are its local heads (what the
    forwards, the KV cache and decode attention read), ``tp`` carries the
    plan and the group (``models/gpt.py`` sums the row-parallel products
    through it) and ``sp`` the rank's positions and the seq group (the
    training forward gathers k and v through it).  ``to_dict`` gives the
    local numbers without the plans."""
    tp: Optional[TensorParallel] = field(default=None, compare=False,
                                         repr=False)
    sp: Optional[SequenceParallel] = field(default=None, compare=False,
                                           repr=False)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(ModelConfig)}


def full_config(cfg: ModelConfig) -> ModelConfig:
    """The whole model's config behind a rank's config (itself where it
    carries no tensor-parallel plan)."""
    tp = getattr(cfg, "tp", None)
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    if tp is not None:
        fields.update(n_head=tp.n_head, n_kv_head=tp.n_kv_head)
    return ModelConfig(**fields)


def local_config(cfg: ModelConfig, tp: Optional[TensorParallel],
                 sp: Optional[SequenceParallel] = None) -> ShardedConfig:
    """The config a rank runs its part of `cfg` with under `tp` and `sp`
    (either may be None)."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields.update(head_dim=cfg.head_dim)
    if tp is not None:
        fields.update(n_head=tp.heads[1] - tp.heads[0],
                      n_kv_head=tp.kv_heads[1] - tp.kv_heads[0])
    return ShardedConfig(**fields, tp=tp, sp=sp)


# =====================================================================
# the specs and the cuts of the parameters
# =====================================================================

_COL = ("wq", "wk", "wv", "wqkv", "w1", "w3", "w13")
_ROW = ("wo", "w2")
_BIAS = ("bq", "bk", "bv")
_LORA = ("wq_a", "wq_b", "wk_a", "wk_b", "wv_a", "wv_b", "wo_a", "wo_b")


def _walk(tree: Any, fn, name: Optional[str] = None) -> Any:
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k) for k, v in tree.items()}
    return fn(name, tree)


def train_dim(name: Optional[str]) -> Optional[int]:
    """The dim a training leaf called `name` is cut on (stacked (L, in,
    out) matrices and (L, n) biases; a LoRA adapter's (L, in, r) A and
    (L, r, out) B)."""
    if name in _COL or name in ("wq_b", "wk_b", "wv_b"):
        return 2
    if name in _ROW or name in _BIAS or name == "wo_a":
        return 1
    return None


def cut_lora(lora: Dict[str, torch.Tensor], tp: TensorParallel
             ) -> Dict[str, torch.Tensor]:
    """An adapter's factors (L, in, r) / (L, r, out), or a stack of
    adapters (L, A, in, r) / (L, A, r, out), cut to this rank's part of
    tensor parallelism `tp` (``TensorParallel.ranges``): the B of q, k
    and v on its output columns, wo's A on its input rows where wo is
    row-parallel; the rest whole."""
    out = {}
    for name, t in lora.items():
        r = tp.ranges(name)
        out[name] = (t if r is None else
                     cut_ranges(t, -1 if name.endswith("_b") else -2, r))
    return out


def param_specs(params: Any, tensor_parallel: bool = False) -> Any:
    """The dim each training leaf is cut on over "model" (None: whole):
    stacked (L, in, out) matrices, wq / wk / wv / w1 / w3 on out, wo / w2
    on in, biases on their one dim; norms and embeddings whole."""
    return _walk(params, lambda name, leaf:
                 train_dim(name) if tensor_parallel else None)


def infer_param_specs(params: Any) -> Any:
    """The dim each inference leaf is cut on over "model" (None: whole):
    dense (L, in, out) stacks as ``param_specs``; Q80 (q, scales) and Q4K
    (packed, scales, biases) in the file's (L, out, in) layout, every
    array of the tensor on the same dim: column-parallel on out (-2),
    row-parallel on in (-1), groups and blocks following in."""
    def spec(name, leaf):
        quant = isinstance(leaf, (Q80Tensor, Q4KTensor))
        if name in _COL:
            return -2 if quant else -1
        if name in _ROW:
            return -1 if quant else -2
        if name in _BIAS:
            return -1
        return None
    return _walk(params, spec)


def kv_cache_spec() -> int:
    """The dim of a KV cache (L, B, T, KV, D) cut over "model": its KV
    heads (a rank's cache holds its own)."""
    return 3


def cut_ranges(t: torch.Tensor, dim: int, ranges: List[Tuple[int, int]],
         scale: int = 1) -> torch.Tensor:
    """The ranges of t's dim (in elements / scale), concatenated."""
    parts = [t.narrow(dim, lo // scale, -(-hi // scale) - lo // scale)
             for lo, hi in ranges]
    return torch.cat(parts, dim).contiguous()


def cut_leaf(leaf: Any, dim: int, ranges: List[Tuple[int, int]]) -> Any:
    """A full leaf cut down to the element ranges of its dim `dim`
    (``infer_param_specs``' dims).  A row-parallel range of a quantized
    tensor starts on one of its units (checked); a Q4K range that runs to
    the tensor's in_dim takes its padded last block with it."""
    if isinstance(leaf, Q80Tensor):
        gs = leaf.group_size
        if dim == -1 and any(lo % gs for lo, _ in ranges):
            raise ValueError(f"a Q80 cut {ranges} splits groups of {gs}")
        return dataclasses.replace(
            leaf, q=cut_ranges(leaf.q, dim, ranges),
            scales=cut_ranges(leaf.scales, dim, ranges,
                              gs if dim == -1 else 1))
    if isinstance(leaf, Q4KTensor):
        if dim == -2:
            return dataclasses.replace(
                leaf, packed=cut_ranges(leaf.packed, -2, ranges),
                scales=cut_ranges(leaf.scales, -2, ranges),
                biases=cut_ranges(leaf.biases, -2, ranges))
        if len(ranges) != 1 or ranges[0][0] % BLOCK_LEN:
            raise ValueError(f"a Q4K cut {ranges} splits blocks of "
                             f"{BLOCK_LEN}")
        lo, hi = ranges[0]
        pad = [(lo, leaf.n_pad if hi >= leaf.in_dim else hi)]
        return Q4KTensor(packed=cut_ranges(leaf.packed, -1, pad, 2),
                         scales=cut_ranges(leaf.scales, -1, pad, 32),
                         biases=cut_ranges(leaf.biases, -1, pad, 32),
                         in_dim=min(hi, leaf.in_dim) - lo)
    return cut_ranges(leaf, dim, ranges)


def _model_tp(mesh: Mesh, plan: TensorParallel) -> TensorParallel:
    return dataclasses.replace(plan, group=mesh.group(MODEL_AXIS),
                               backend=mesh.backend)


def shard_params(params: Any, mesh: Mesh, cfg: Optional[ModelConfig] = None,
                 tensor_parallel: bool = False
                 ) -> Tuple[Any, Optional[TensorParallel]]:
    """Training params -> (this rank's leaves, its TensorParallel or None):
    whole under data parallelism alone; under tensor parallelism cut by
    ``param_specs`` into equal parts (heads, KV heads and hidden units
    must divide over "model"), each cut leaf a new leaf that requires
    grad as the full one did."""
    n = mesh.size(MODEL_AXIS)
    if not tensor_parallel or n == 1:
        return params, None
    plan = _model_tp(mesh, tp_plan(cfg, n, mesh.index(MODEL_AXIS),
                                   even=True))

    def cut(name, leaf):
        r = plan.ranges(name)
        if r is None:
            return leaf
        with torch.no_grad():
            out = cut_ranges(leaf.detach(), train_dim(name), r)
        return out.requires_grad_(leaf.requires_grad)
    return _walk(params, cut), plan


def shard_inference_params(params: Any, mesh: Mesh, cfg: ModelConfig
                           ) -> Tuple[Any, TensorParallel]:
    """Inference params (dense, Q80 or Q4K, fused or not) -> (this rank's
    leaves, its TensorParallel).  Fused leaves are cut part by part: a
    rank's wqkv holds its q heads, then its k and v heads, and its w13 its
    rows of w1, then the same rows of w3.  A row-parallel leaf whose
    rank parts would split its quantization units stays whole (the plan's
    "gather" / "replicated" modes); the JAX package replicates such leaves
    too, but cuts by contiguous ranges elsewhere, which a fused leaf's
    parts do not survive without GSPMD's resharding."""
    blocks = params["blocks"]
    n = mesh.size(MODEL_AXIS)
    plan = _model_tp(mesh, tp_plan(cfg, n, mesh.index(MODEL_AXIS),
                                   blocks.get("wo"), blocks.get("w2")))
    specs = infer_param_specs(params)

    def cut(name, leaf):
        r = plan.ranges(name)
        dim = specs["blocks"].get(name) if name in blocks else None
        if r is None or dim is None:
            return leaf
        return cut_leaf(leaf, dim, r)
    out = dict(params)
    out["blocks"] = {k: cut(k, v) for k, v in blocks.items()}
    return out, plan


def gather_leaf(local: torch.Tensor, full_shape: Sequence[int], dim: int,
                ranges: List[Tuple[int, int]], group) -> torch.Tensor:
    """A dense leaf cut by ``cut_ranges`` back to its full shape on every rank
    of `group`: each rank writes its ranges into zeros and the group sums
    them (exact; gloo also runs this on CUDA tensors)."""
    full = torch.zeros(tuple(full_shape), dtype=torch.float32,
                       device=local.device)
    off = 0
    for lo, hi in ranges:
        full.narrow(dim, lo, hi - lo).copy_(
            local.detach().narrow(dim, off, hi - lo))
        off += hi - lo
    dist.all_reduce(full, group=group)
    return full.to(local.dtype)

