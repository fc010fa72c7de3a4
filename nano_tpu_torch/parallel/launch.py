"""Start the ranks of a process group on one host and collect what each
returns: torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR / MASTER_PORT at a free port of localhost) for `world` spawned
processes, each of which joins the group (``mesh.maybe_distributed_init``)
and calls a function named by its import path.

    from nano_tpu_torch.parallel import launch
    results = launch.run("my_module:rank_fn", 2, args=(...,),
                         backend="gloo", device="cuda")

The target is imported in each child by name, so it must live in a module
that the child can import without side effects.  A rank that raises makes
``run`` raise, and the other ranks are stopped.
"""

from __future__ import annotations

import importlib
import os
import socket
import tempfile
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nano_tpu_torch.parallel import mesh


def free_port() -> int:
    """A TCP port of localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, target: str, args: Sequence,
           backend: Optional[str], device: Optional[str],
           threads: Optional[int], out_dir: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    mesh.maybe_distributed_init(backend, device)
    try:
        module, fn = target.split(":")
        result = getattr(importlib.import_module(module), fn)(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(target: str, world: int, args: Sequence = (),
        backend: Optional[str] = None, device: Optional[str] = None,
        threads: Optional[int] = None) -> List[Any]:
    """Run ``module:function`` as ranks 0 .. world-1 of one process group
    (`backend` and `device` as ``mesh.maybe_distributed_init`` takes them;
    `threads`: each rank's intra-op threads) -> each rank's return value,
    in rank order."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_entry, nprocs=world, join=True,
                           start_method="spawn",
                           args=(world, free_port(), target, tuple(args),
                                 backend, device, threads, out_dir))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
