"""Training entry point of the port (the counterpart of the root ``train.py``;
a package's ``__main__``, since ``cfpnet_torch.train`` is the package of the
loop).

    python -m cfpnet_torch.train @configs/train_cfpnet_combine1.txt [--device cpu]
    python -m cfpnet_torch.train @configs/debug_synthetic.txt --device cpu --logging

Runs ``train/loop.py::run_training`` on the card unless ``--device cpu``.
Checkpoints go to ``checkpoints/{name}/`` and ``weights/{name}/``, the JSONL
log to ``{save_dir}/train_log.jsonl``, all relative to the working
directory; ``--resume checkpoints/{name}/{ep}_{rmse}`` continues at the
next epoch with the optimizer state and the step. ``--no_logging`` turns
both off, as in the JAX package; ``--logging`` (this entry point's own
flag) turns them back on over an argfile's ``--no_logging``.

``--compute_dtype bfloat16`` trains with the bf16 step of
``train/steps.py`` (float32 masters, moments, statistics and loss);
validation runs in float32 on the masters and the checkpoints hold float32
weights, as in the JAX package.

``--device_pipeline`` runs flip, augmentation, normalization and the ToF
simulation on the card (``data/tof_sim_device.py``); ``--grad_accum N``
runs each batch as N microbatches (``train/steps.py``); ``--remat``
recomputes the image encoder's activations in the backward
(``models/deltar.py``); ``--debug_nans`` runs the training in autograd's
anomaly mode and checks each step's loss (``train/loop.py``), as the root
``train.py`` turns on ``jax_debug_nans``.

``--selfsup`` runs the self-supervised variant instead,
``train/selfsup.py::run_selfsup_training`` (as the root ``train.py``
does): video pairs (``--dataset synthetic`` or ``nyu``), depth and pose
trained jointly, a ``selfsup_val`` line an epoch in
``{save_dir}/selfsup_log.jsonl`` and the depth weights in
``weights/{name}/``.

Data parallelism (``cfpnet_torch/parallel``): with ``--multihost`` this
process joins a job's process group (root ``train.py:31-34``), from
``--coordinator_address``/``--num_processes``/``--process_id`` or the
launcher's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``, on the
card ``cuda:LOCAL_RANK``:

    torchrun --nproc_per_node 4 -m cfpnet_torch.train @configs/X.txt --multihost

Without it, ``--dp_shards`` on one host runs
``dp_world_size(dp_shards, cards, bs)`` processes (0: every card of
``local_device_count``, clamped to a divisor of ``--bs``, as the JAX
package's mesh), spawned here; with one card that is one, and nothing is
spawned. Either way the loop is data-parallel over the global batch
(``train/loop.py``).

``--spatial_shards N`` (> 1) splits image rows over N devices of this
process (``parallel/spatial.py``, the JAX 2-D mesh): the loop steps on a
grid of ``--dp_shards`` (default: the cards over N) by N cards, and nothing
is spawned; ``--dp_shards`` is then the grid's data axis, as in the JAX
loop. It needs ``--safe_dw_vjp``, as the JAX package does (``ValueError``),
and ``dp * N`` cards. ``--selfsup`` with it trains on one card and
validates on the grid, as the JAX self-supervised loop does.

Refused with ``NotImplementedError``: ``--spatial_shards > 1`` with
``--multihost`` (spatial partitioning is single-controller) or with
``--device_pipeline``; and, as the JAX loop refuses it,
``--train_zone_random_offset`` with ``--device_pipeline``.
``--use_pallas`` is accepted and changes nothing: the port always runs its
CUDA kernels on the card.
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import List, Optional

import numpy as np
import torch

from ..config import parse_config
from ..parallel import launch, mesh
from .loop import run_training
from .selfsup import run_selfsup_training


def set_seeds(seed: int) -> None:
    """reference train.py:218 (seed 117010053)"""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def refuse(config) -> None:
    """Raises, before any process starts, for the combinations of options
    that the JAX package refuses."""
    if config.spatial_shards > 1 and config.multihost:
        raise NotImplementedError("spatial partitioning is single-controller; use shard_batch "
                                  "for multi-host DP")


def local_device_count(device: torch.device) -> int:
    """The devices of this host that ``--dp_shards`` may take: the cards on
    a card, one on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def spawned_rank(rank: int, init_method: str, argv: List[str], world: int) -> None:
    """Process ``rank`` of a ``--dp_shards`` run (``launch.spawn``): the
    entry point with ``--multihost`` at the run's address."""
    main(argv + ["--multihost", "--coordinator_address", init_method,
                 "--num_processes", str(world), "--process_id", str(rank)])


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default: the card)")
    ap.add_argument("--logging", action="store_true",
                    help="write checkpoints and the JSONL log even where the argfile "
                         "says --no_logging")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    config = parse_config(rest).replace(mode="train")
    if args.logging:
        config = config.replace(no_logging=False)
    refuse(config)
    device = torch.device(args.device)
    if not config.multihost and config.spatial_shards <= 1:
        world = mesh.dp_world_size(config.dp_shards, local_device_count(device), config.bs)
        if world > 1:
            launch.spawn("cfpnet_torch.train.__main__:spawned_rank", world,
                         (list(sys.argv[1:] if argv is None else argv), world))
            return None
    owns_group = config.multihost and not mesh.is_distributed()
    if config.multihost:
        device = mesh.rank_device(device)
        mesh.maybe_initialize_distributed(config, device)
    set_seeds(config.seed)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        # anomaly mode for the run under --debug_nans, the previous mode after it
        with torch.autograd.set_detect_anomaly(bool(config.debug_nans)):
            if config.selfsup:
                return run_selfsup_training(config, device=device)
            return run_training(config, device=device)
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
