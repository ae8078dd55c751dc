"""Start the ranks of a sharded run: `spawn(fn, n, device_type)`.

Each of the n ranks is a process started by torch.multiprocessing (the
"spawn" start method), which joins a process group through a FileStore in a
fresh temp dir (no TCP port, so runs side by side never race for one), binds
rank r to `cuda:r` (NCCL; one GPU per rank) or to the CPU (gloo, one
intra-op thread per rank), and calls `fn(mesh, *args)`. `fn` must be a
module-level function: a spawned process imports it by name. `spawn`
returns the ranks' return values, in rank order, and raises if any rank
raised.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, n: int, device_type: str, tmp: str,
               args: Sequence) -> None:
    from gaussian_lic_tpu_torch.parallel.sharded import make_mesh

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method="file://" + os.path.join(tmp, "store"),
                            rank=rank, world_size=n)
    try:
        out = fn(make_mesh(n, device=device), *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, device_type: str = "cuda", args: Sequence = (),
          timeout: Optional[float] = None) -> List:
    """Runs `fn(mesh, *args)` on n ranks; returns their results in rank
    order. Raises ValueError when the card has fewer GPUs than ranks (NCCL
    needs one GPU per rank), the first rank's error if any rank raises, and
    TimeoutError (the ranks killed) when they run past `timeout` seconds."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks need {n} GPUs (NCCL takes one GPU per rank); "
                         f"this machine has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="glic_spawn_") as tmp:
        ctx = mp.start_processes(_rank_main, args=(fn, n, device_type, tmp, tuple(args)),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):   # raises if a rank failed
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{n} ranks of {fn.__name__} ran past {timeout} s")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
