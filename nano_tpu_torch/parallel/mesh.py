"""Device mesh and the cuts of tensor parallelism, on ``torch.distributed``.

Port of ``nano_tpu/parallel/mesh.py``.  The JAX package declares a
``jax.sharding.Mesh`` and annotates arrays with shardings; XLA inserts the
collectives.  Here each rank is one process with a plain local tensor per
leaf, and the collectives are explicit code:

  * "data" (data parallel): every rank takes its contiguous rows of the
    global batch (``batch_rows``); the trainer all-reduces the gradients
    and the loss's sums over the data group.
  * "model" (tensor parallel, Megatron-style): attention heads and the FFN
    hidden units are cut over the model group.  wq / wk / wv / w1 / w3
    (and the fused wqkv / w13 of a .bin file, part by part) keep this
    rank's output rows, wo / w2 its input rows; norms, embeddings and the
    head stay whole.  The block all-reduces the row-parallel products'
    partial sums (``TensorParallel``); in training two autograd functions
    put the all-reduce of the column-parallel input's gradient into the
    backward (``TensorParallel.enter`` / ``leave``).

The tensors stay plain: the kernels launch through ``ctypes`` on local
tensors, which a DTensor cannot carry a sharding through.  "seq" and
"pipe" are ROADMAP queue 1 item 11b and raise.

Rank order is the JAX mesh's: axes ("data", "model"), "model" innermost,
so rank = d * n_model + m.
"""

from __future__ import annotations

import dataclasses
import datetime
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
SEQ_AXIS = "seq"      # sequence parallel: ROADMAP item 11b
PIPE_AXIS = "pipe"    # pipeline parallel: ROADMAP item 11b

ITEM_11B = "ROADMAP queue 1 item 11b"

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
    """This rank's place in a ("data", "model") grid of ranks and the
    process groups of its row and column: ``group(MODEL_AXIS)`` holds the
    ranks that differ from this one in "model" only."""
    shape: Dict[str, int]                 # axis -> size, outermost first
    rank: int
    backend: str
    groups: Dict[str, Any] = field(repr=False)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (rank = d * n_model + m)."""
        if axis == MODEL_AXIS:
            return self.rank % self.size(MODEL_AXIS)
        if axis == DATA_AXIS:
            return self.rank // self.size(MODEL_AXIS)
        return 0

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              n_seq: int = 1, n_pipe: int = 1) -> Mesh:
    """The ("data", "model") mesh over the process group (every rank
    calls this, in the same order as every other group it makes): rank =
    d * n_model + m.  n_data defaults to what the world leaves.  "seq" and
    "pipe" larger than 1 are ROADMAP item 11b."""
    if n_seq > 1 or n_pipe > 1:
        raise NotImplementedError(
            f"sequence and pipeline parallelism (seq={n_seq}, pipe={n_pipe}) "
            f"are {ITEM_11B}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: launch with torchrun (or "
            "nano_tpu_torch.parallel.launch) and call maybe_distributed_init")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh data={n_data} x model={n_model} does not "
                         f"match the {world} ranks of the process group")
    rank = dist.get_rank()
    groups: Dict[str, Any] = {}
    # every rank makes every group, in one order
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            groups[MODEL_AXIS] = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            groups[DATA_AXIS] = g
    return Mesh(shape={DATA_AXIS: n_data, MODEL_AXIS: n_model}, rank=rank,
                backend=dist.get_backend(), groups=groups)


# =====================================================================
# the batch: contiguous rows over "data"
# =====================================================================

def batch_spec(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    """The axes a (B, S) batch is cut on: B over "data" (the JAX
    P("data")); the S axis over "seq" is item 11b."""
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


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of every (B, ...) array or tensor in `batch` (a
    tuple, list or single array)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    return batch[batch_rows(len(batch), mesh)]


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
        keeps, in order; None: the whole leaf."""
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
        if name == "wo":
            return [q] if self.attn == "row" else None
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
    """A rank's view of a ModelConfig under tensor parallelism: n_head and
    n_kv_head are its local heads (what the forwards, the KV cache and
    decode attention read), and ``tp`` carries the plan and the group
    (``models/gpt.py`` sums the row-parallel products through it).
    ``to_dict`` gives the local numbers without the plan."""
    tp: Optional[TensorParallel] = field(default=None, compare=False,
                                         repr=False)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(ModelConfig)}


def local_config(cfg: ModelConfig, tp: TensorParallel) -> ShardedConfig:
    """The config a rank runs its part of `cfg` with under `tp`."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields.update(n_head=tp.heads[1] - tp.heads[0],
                  n_kv_head=tp.kv_heads[1] - tp.kv_heads[0],
                  head_dim=cfg.head_dim)
    return ShardedConfig(**fields, tp=tp)


# =====================================================================
# the specs and the cuts of the parameters
# =====================================================================

_COL = ("wq", "wk", "wv", "wqkv", "w1", "w3", "w13")
_ROW = ("wo", "w2")
_BIAS = ("bq", "bk", "bv")


def _walk(tree: Any, fn, name: Optional[str] = None) -> Any:
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k) for k, v in tree.items()}
    return fn(name, tree)


def train_dim(name: Optional[str]) -> Optional[int]:
    """The dim a training leaf called `name` is cut on (stacked (L, in,
    out) matrices and (L, n) biases)."""
    if name in _COL:
        return 2
    if name in _ROW or name in _BIAS:
        return 1
    return None


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

