"""The work split of the two int8 tensor-core products.

``q80_matmul_w8a8`` (``qmatmul.w8a8_plan``) and ``q4k_matmul_w4a4``
(``q4k.w4a4_plan``) share one design (``csrc/int8_mma.cuh``): MB weight
rows a block, BN slots a tile, the pieces of K split over a cluster of CS
blocks, a ring of S shared-memory stages.  Each product gives ``plan`` its
weight bytes, the pieces a cluster may split K into, the ring chunks a
piece holds and the bytes of one stage; the rule is the same for both.
"""

from __future__ import annotations

from typing import Callable, Optional, Set, Tuple

import torch

from nano_tpu_torch.ops import _build

MAX_STAGES = 4
MAX_CLUSTER = 8          # the portable cluster size
SMEM = 113 * 1024        # a block's shared memory, so that two fit on an SM
# weight bytes up to which a product's slot tiles re-read it from L2 (of
# the H100's 50 MB): every layer product of the Qwen3-0.6B shape, not its head
L2_WEIGHT = 16 << 20


def smem(stage: int, MB: int, BN: int, CS: int, S: int) -> int:
    """Shared memory of a block: S stages of `stage` bytes and, past them
    where CS > 1, the box where the cluster's blocks leave their partial
    sums (over them where CS = 1; csrc/int8_mma.cuh:ring_smem)."""
    stages, box = S * stage, MB * (BN + 2) * 4
    return stages + box if CS > 1 else max(stages, box)


def plan(B: int, N: int, weight_bytes: int, pieces: int, piece_chunks: int,
         stage: Callable[[int, int], int], n_sm: int = _build.H100_SMS,
         cluster: Optional[int] = None) -> Tuple[int, int, int, int]:
    """-> (MB, BN, CS, S) from the shapes alone (never from a value on the
    device, so that a launch can be captured in a CUDA graph), for B slots,
    N weight rows, K in `pieces` that a cluster may split (each
    `piece_chunks` stages long) and `stage(MB, BN)` bytes a stage; the
    choices are the fastest splits of ``chip_smoke.py bench q80 batched
    sweep`` at a Qwen3-0.6B step's products:

    * BN slots a tile (8, 16, 32 or 64), the least that holds B, so that a
      weight byte is read once; but at most 32 where the weight fits
      L2_WEIGHT (a layer product): its two slot tiles at B = 64 read the
      weight together, the second from L2, and give twice the blocks;
    * MB = 128 weight rows a block where 128-row tiles still give two
      blocks for every SM (the head: half the activation bytes a block
      reads for each weight byte), else 64;
    * the pieces of K split over a cluster of CS blocks, doubled from 1
      while the grid has fewer than 1.5 blocks an SM, up to MAX_CLUSTER
      and the piece count; or `cluster` blocks where the product fixes it
      (q80_matmul_w8a8: its order of summation);
    * a ring of S stages: as many as a block has chunks, up to MAX_STAGES,
      where the grid is one wave or a few, and 2 where it is many (more
      blocks an SM instead), within SMEM."""
    BN = next(bn for bn in (8, 16, 32, 64) if bn >= min(B, 64))
    if weight_bytes <= L2_WEIGHT:
        BN = min(BN, 32)
    col_tiles = -(-B // BN)
    MB = 128 if -(-N // 128) * col_tiles >= 2 * n_sm else 64
    tiles = -(-N // MB) * col_tiles
    CS = 1
    while 2 * tiles * CS < 3 * n_sm and 2 * CS <= min(MAX_CLUSTER, pieces):
        CS *= 2
    if cluster is not None:
        CS = cluster
    chunks = -(-pieces // CS) * piece_chunks
    S = min(MAX_STAGES if tiles * CS < 4 * n_sm else 2, chunks)
    while S > 1 and smem(stage(MB, BN), MB, BN, CS, S) > SMEM:
        S -= 1
    return MB, BN, CS, S


_ready: Set[Tuple[str, int]] = set()


def init(device: torch.device, entry: str) -> None:
    """Call the C function `entry` (one that raises every instance's
    shared-memory limit) once on `device`, before a product's first launch
    there: its wrapper does; a caller of the product's C function does it
    first."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if (entry, index) in _ready:
        return
    with torch.cuda.device(index):
        stem = _build.SIGNATURES[entry][1]
        _build.check(getattr(_build.lib(stem), entry)(), entry)
    _ready.add((entry, index))
