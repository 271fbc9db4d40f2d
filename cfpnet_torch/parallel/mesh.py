"""Data parallelism over processes: one process a card, the batch split by
rows, the statistics and the loss over the global batch.

Port of ``cfpnet_tpu/parallel/mesh.py`` (``maybe_initialize_distributed``,
the arithmetic of ``make_mesh``, ``shard_batch``) to ``torch.distributed``.
The JAX package runs one program over a 1-D ``'data'`` mesh: each step sees
the sharded global array, and XLA inserts the collectives. Here every
process holds its own rows, so the collectives are written out:

- ``all_reduce_sum``, a sum over the processes whose gradient is also a sum
  over the processes. Train-mode ``models/layers.py::BatchNorm`` sums its
  statistics through it, ``train/losses.py::silog_loss`` its counts and
  sums, ``train/selfsup.py`` its terms: each process then computes the
  global batch's loss, the same value on every process.
- ``average_gradients``: one all-reduce of every gradient, then a division
  by the world. Backward from the same global loss on every process hands
  each process W times its share of the gradient (each sum's backward adds
  the W processes' equal seeds), so the average is the global gradient.
- ``all_gather_f64`` (the eval merge, ``train/loop.py::evaluate_sharded``),
  ``broadcast_module`` (rank 0's weights, once) and ``barrier``.

With no process group, or a world of one, the model and the loss
communicate nothing and compute what they compute in one process.

Every all-reduce of the model, the loss and the gradients is counted
(``tracing.py``: ``parallel.all_reduce``, ``parallel.all_reduce_bytes``);
the gradients' falls in the train step's span ``train.allreduce``.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing


def is_distributed() -> bool:
    """A process group is initialized (a world of one included)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def rank_device(device) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for a card (LOCAL_RANK
    from the environment, 0 without it), the device as given otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def _flag_or_env(value: int, unset: int, env: str, flag: str) -> int:
    if value != unset:
        return int(value)
    if env not in os.environ:
        raise ValueError(f"--multihost: give {flag} or set {env}")
    return int(os.environ[env])


def maybe_initialize_distributed(config, device="cuda", backend: Optional[str] = None,
                                 timeout: Optional[float] = None) -> bool:
    """Join the job's process group where ``--multihost`` says so; returns
    True when it has more than one process (JAX ``:25-56``). Idempotent.

    The group is ``--coordinator_address`` (``host:port``, or a URL such as
    ``file:///path``) with ``--num_processes`` and ``--process_id``, each
    of which falls back to the launcher's environment (``WORLD_SIZE``,
    ``RANK``); without an address, ``MASTER_ADDR``/``MASTER_PORT`` as
    ``torchrun`` sets them, the counterpart of the cluster variables
    ``jax.distributed.initialize`` detects. ``init_rank`` joins it (gloo
    also reduces tensors on a card, staged through the host)."""
    if not getattr(config, "multihost", False):
        return False
    if not is_distributed():
        world = _flag_or_env(config.num_processes, 0, "WORLD_SIZE", "--num_processes")
        me = _flag_or_env(config.process_id, -1, "RANK", "--process_id")
        if not 0 <= me < world:
            raise ValueError(f"--multihost: process_id {me} is not in a world of {world}")
        address = config.coordinator_address
        if address:
            init_method = address if "://" in address else f"tcp://{address}"
        elif "MASTER_ADDR" in os.environ:
            init_method = "env://"
        else:
            raise ValueError("--multihost: give --coordinator_address or set MASTER_ADDR "
                             "and MASTER_PORT")
        init_rank(me, world, init_method, device, backend, timeout)
    return world_size() > 1


def init_rank(rank: int, world: int, init_method: str, device="cpu",
              backend: Optional[str] = None, timeout: Optional[float] = None) -> torch.device:
    """Joins the group of ``world`` processes at ``init_method`` as ``rank``
    on ``device`` (``rank_device``), which becomes the current card; NCCL
    on a card and gloo on the CPU unless ``backend`` names one. ``timeout``
    bounds the wait for the others and each collective, in seconds.
    Returns the process's device."""
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank, **kw)
    return device


def dp_world_size(dp_shards: int, n_devices: int, batch_size: Optional[int] = None) -> int:
    """Processes of a data-parallel run: the size of JAX's ``make_mesh``
    (``:59-71``). ``dp_shards`` (0: every device), at most ``n_devices``,
    then down to a divisor of ``batch_size`` where one is given."""
    n = dp_shards if dp_shards > 0 else n_devices
    n = min(n, n_devices)
    if batch_size is not None:
        while n > 1 and batch_size % n != 0:
            n -= 1
    return n


def rank_rows(batch_size: int, world: int, me: int, accum: int = 1) -> np.ndarray:
    """The rows of a global batch that process ``me`` of ``world`` holds.

    Contiguous, as the JAX loader's per-process shard (``data/pipeline.py``
    ``:101-107``); under ``--grad_accum`` its share of each microbatch in
    turn: microbatch i is global rows ``[i * mb, (i + 1) * mb)`` (the JAX
    step's ``reshape((accum, bs // accum))``), so the process's local
    microbatch i is its ``mb / world`` rows of that one."""
    if batch_size % world != 0:
        raise ValueError(
            f"multi-host data loading requires batch_size divisible by the process count: "
            f"bs={batch_size}, processes={world}. Pick bs a multiple of {world}.")
    if accum <= 1:
        per = batch_size // world
        return np.arange(me * per, (me + 1) * per)
    if batch_size % accum != 0:
        raise ValueError(f"--grad_accum {accum} does not divide batch size {batch_size}")
    mb = batch_size // accum
    if mb % world != 0:
        raise ValueError(f"--grad_accum {accum}: the microbatch of {mb} rows (bs={batch_size}) "
                         f"is not divisible by the {world} processes")
    per = mb // world
    return np.concatenate([np.arange(i * mb + me * per, i * mb + (me + 1) * per)
                           for i in range(accum)])


def shard_batch(batch: Dict[str, torch.Tensor], accum: int = 1) -> Dict[str, torch.Tensor]:
    """This process's rows (``rank_rows``) of a global batch, the
    counterpart of JAX ``shard_batch``; the batch itself in one process."""
    if world_size() == 1:
        return batch
    bs = next(iter(batch.values())).shape[0]
    rows = rank_rows(bs, world_size(), rank(), accum)
    return {k: v[torch.as_tensor(rows, device=v.device)] for k, v in batch.items()}


def _all_reduce(t: torch.Tensor) -> None:
    """``dist.all_reduce(t)`` (a sum, in place), counted: the counters
    ``parallel.all_reduce`` and ``parallel.all_reduce_bytes``."""
    tracing.count("parallel.all_reduce")
    tracing.count("parallel.all_reduce_bytes", t.numel() * t.element_size())
    dist.all_reduce(t)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes; its gradient is the sum of the processes'
    gradients of the result."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        _all_reduce(out)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes, differentiably (``_AllReduceSum``)."""
    return _AllReduceSum.apply(x)


def global_mean(local_mean: torch.Tensor) -> torch.Tensor:
    """The global batch's mean of a quantity of which ``local_mean`` is the
    mean over this process's rows, every process holding as many: the sum
    of the processes' means over the world."""
    if world_size() == 1:
        return local_mean
    return all_reduce_sum(local_mean) / world_size()


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def _coalesced(tensors: Iterable[torch.Tensor], collective) -> None:
    """``collective`` on one flat buffer per dtype of ``tensors``, the
    result copied back into each."""
    for group in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def average_gradients(grads: List[torch.Tensor]) -> None:
    """Every gradient summed over the processes, in one all-reduce a dtype,
    then divided by the world, in place."""
    world = world_size()

    def reduce(flat):
        _all_reduce(flat)
        flat.div_(world)

    _coalesced(grads, reduce)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Process ``src``'s parameters and buffers into every process's
    ``module``, in place."""
    with torch.no_grad():
        _coalesced(module.state_dict().values(), lambda flat: dist.broadcast(flat, src))


def _comm_device() -> torch.device:
    """Where host values go for a collective: the card under NCCL, which
    takes only CUDA tensors; the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_f64(vec: np.ndarray) -> np.ndarray:
    """[world, n] float64: every process's ``vec`` by rank (JAX
    ``process_allgather``)."""
    if world_size() == 1:
        return np.asarray(vec, np.float64)[None]
    t = torch.as_tensor(np.asarray(vec, np.float64), device=_comm_device())
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def barrier() -> None:
    if is_distributed():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
