"""Ranks on the CPU: one spawned process per rank on a gloo group.

``run_ranks(fn, workdir, ...)`` spawns ``world`` processes; each joins a
gloo group that meets through a ``FileStore`` in a directory of its own
under ``workdir`` (never a TCP port, so several launches may run at once)
and calls ``fn(rank, d, *args)`` with ``d`` that directory, where ranks
hand back their results as files.  The spawn is joined within ``timeout``
seconds; past it the ranks are killed.  The multi-rank tests and the
dryrun entry point (``neuralsvd_tpu_torch.graft_entry``) run on it.
``fn`` must be importable by name from a module (spawn pickles it).
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVE_TIMEOUT", "run_ranks"]

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def run_ranks(fn, workdir, *args, world: int = 2, timeout: float = 120.0) -> str:
    """Run ``fn(rank, d, *args)`` on ``world`` gloo ranks; returns ``d``.
    Raises AssertionError with the ranks' tracebacks if one fails or the
    spawn outlives ``timeout`` seconds."""
    d = tempfile.mkdtemp(prefix=f"{fn.__name__}_", dir=workdir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, d, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [open(os.path.join(d, f"error.{r}")).read() for r in range(world)
              if os.path.exists(os.path.join(d, f"error.{r}"))]
    codes = [p.exitcode for p in procs]
    if hung or errors or any(c != 0 for c in codes):
        raise AssertionError(f"{fn.__name__}: ranks {hung} hung past {timeout} s, "
                             f"exit codes {codes}\n" + "\n".join(errors))
    return d


def _rank_main(fn, rank, world, d, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), world),
                            rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        fn(rank, d, *args)
    except BaseException:
        with open(os.path.join(d, f"error.{rank}"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()
