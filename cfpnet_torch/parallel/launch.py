"""Processes of a data-parallel run on one host.

``spawn(target, world, args)`` starts ``world`` processes by the ``spawn``
method (fresh interpreters: no thread or CUDA state crosses), runs
``target(rank, init_method, *args)`` in each with ``LOCAL_RANK`` set to its
rank, and waits for all of them. ``target`` is named ``"module:function"``,
imported in the child, so that a function of a module run as ``__main__``
can be named too. The first process to fail ends the run: the others are
terminated and the error is raised in the caller, as is a run that
outlasts ``timeout``.

The process group is the target's to join
(``mesh.maybe_initialize_distributed`` or ``mesh.init_rank``) at
``init_method``, a ``file://`` store in a fresh temporary directory, which
needs no free port; it is destroyed when the target returns.
"""

from __future__ import annotations

import importlib
import os
import tempfile
import time
from typing import Optional, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_entry(rank: int, target: str, args: Sequence) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    module, name = target.split(":")
    try:
        getattr(importlib.import_module(module), name)(rank, *args)
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def spawn(target: str, world: int, args: Sequence = (), timeout: Optional[float] = None) -> None:
    """Runs ``target(rank, init_method, *args)`` in ``world`` spawned
    processes (module docstring), which start with this process's
    environment, and returns when all have exited 0. ``init_method`` is
    the ``file://`` address of the run's store."""
    with tempfile.TemporaryDirectory(prefix="cfpnet_dp_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(_rank_entry, args=(target, (init_method, *args)),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{target}: {world} processes still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
