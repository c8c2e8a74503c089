"""Run one function on every rank of a process group, one process a rank.

    results = run_ranks(fn, world_size, args, workdir=D, timeout_s=300)

starts ``world_size`` processes with the ``spawn`` start method (safe in a
parent that has initialised CUDA), each calling ``fn(rank, world_size,
init_method, *args)`` with ``init_method`` a ``file://`` URL of a
``FileStore`` under ``workdir`` (no TCP port to collide with another
run), and returns the ranks' return values in rank order.  ``fn`` must be
importable by module and name; its return value comes back through
``torch.save`` (move tensors to the CPU first).

A rank that raises or dies fails the run at once: the launcher ends the
other ranks, which would otherwise wait in a collective until their
timeout, and raises ``RuntimeError`` naming the rank and its exit code.
A run past ``timeout_s`` is ended and raises ``TimeoutError``.  Every
process is ended before the call returns or raises.

The trainer is launched by ``torchrun`` instead (``launch.train``).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import Any, Callable, List, Sequence

import torch

POLL_S = 0.05


def _rank_main(fn: Callable, rank: int, world_size: int, init_method: str,
               args: Sequence[Any], out: str) -> None:
    result = fn(rank, world_size, init_method, *args)
    torch.save(result, out)


def run_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (), *,
              workdir: str, timeout_s: float) -> List[Any]:
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        raise ValueError(f"{store} exists: a FileStore needs a fresh path")
    outs = [os.path.join(workdir, f"rank{r}.pt") for r in range(world_size)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, f"file://{store}",
                               tuple(args), outs[r]))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while any(p.exitcode is None for p in procs):
            failed = [(r, p.exitcode) for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} of {world_size} "
                                   f"exited with code {failed[0][1]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks still running after "
                                   f"{timeout_s} s")
            time.sleep(POLL_S)
        failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if failed:
            raise RuntimeError(f"rank {failed[0][0]} of {world_size} exited "
                               f"with code {failed[0][1]}")
        return [torch.load(o, weights_only=False) for o in outs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=30)
