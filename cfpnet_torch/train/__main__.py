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

Refused with ``NotImplementedError``, each naming its ROADMAP.md item:
``--multihost`` and ``--spatial_shards > 1``; and, as the JAX loop
refuses it, ``--train_zone_random_offset`` with ``--device_pipeline``.
``--use_pallas`` and ``--safe_dw_vjp`` are accepted and change nothing: the
port always runs its CUDA kernels on the card, and its gradients need no
partitioner workaround.
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import List, Optional

import numpy as np
import torch

from ..config import parse_config
from .loop import run_training
from .selfsup import run_selfsup_training


def set_seeds(seed: int) -> None:
    """reference train.py:218 (seed 117010053)"""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def refuse(config) -> None:
    """Raises for the options of the root ``train.py`` that the port does not have
    (the loop, the loaders and the train step refuse theirs)."""
    if config.multihost:
        raise NotImplementedError("--multihost: multi-GPU training is not ported yet "
                                  "(ROADMAP.md §A 9)")


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
    set_seeds(config.seed)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # anomaly mode for the run under --debug_nans, the previous mode after it
    with torch.autograd.set_detect_anomaly(bool(config.debug_nans)):
        if config.selfsup:
            return run_selfsup_training(config, device=device)
        return run_training(config, device=device)


if __name__ == "__main__":
    main()
