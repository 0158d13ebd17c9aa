"""Run a function on several ranks of one process group, from one process.

`run_ranks(fn, world, backend, *args)` spawns `world` processes, joins them
in a process group through a file:// rendezvous in a fresh directory (no
port to pick, so concurrent runs cannot collide), runs
`fn(rank, device, *args)` on each and returns the ranks' return values in
rank order (rank 0 may run in the caller's process instead). A failing rank
raises in the caller. `fn` must be importable
(a module-level function): the processes start fresh ("spawn").

The backend is the caller's: "nccl" gives rank r the card r, "gloo" keeps
every rank on the CPU.
"""

import os
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dl_swin_gan_tpu_torch.parallel.mesh import init_process


def _rank_main(index: int, first: int, fn: Callable, world: int,
               backend: str, directory: str, threads: Optional[int],
               args: tuple) -> None:
    rank = first + index
    if threads:
        torch.set_num_threads(threads)
    device = init_process(backend, rank, world,
                          f"file://{os.path.join(directory, 'rendezvous')}")
    try:
        out = fn(rank, device, *args)
        torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, backend: str, *args,
              threads: Optional[int] = 1,
              directory: Optional[str] = None,
              rank0_here: bool = False) -> List[Any]:
    """fn(rank, device, *args) on `world` ranks; their results in rank
    order. `threads`: torch's intra-op threads per spawned rank (None
    leaves torch's default). `directory`: where the rendezvous and the
    results go (a temporary directory by default). `rank0_here`: rank 0
    runs in this process and only ranks 1.. are spawned, which saves one
    process's start-up; the process group is destroyed after it."""
    first = int(rank0_here)
    with tempfile.TemporaryDirectory(dir=directory) as tmp:
        spawned = None
        if world > first:
            spawned = mp.start_processes(
                _rank_main, args=(first, fn, world, backend, tmp, threads,
                                  args),
                nprocs=world - first, join=False, start_method="spawn")
        try:
            if rank0_here:
                _rank_main(0, 0, fn, world, backend, tmp, None, args)
            while spawned is not None and not spawned.join():
                pass
        except BaseException:
            for p in spawned.processes if spawned is not None else ():
                p.terminate()
            raise
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
