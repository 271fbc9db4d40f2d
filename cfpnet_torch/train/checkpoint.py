"""Checkpoint IO with ``torch.save``.

Port of ``cfpnet_tpu/train/checkpoint.py`` (``save_weights``,
``load_weights``, ``save_checkpoint``, ``load_checkpoint``). A weights file
holds the model's ``state_dict`` (BatchNorm statistics included); a
checkpoint holds the whole training state: the ``state_dict``, the
``AdamW`` state of ``train/optim.py`` (each group's moments and count),
``step``, ``epoch`` and ``best_rmse``, so that a resumed run continues
where it stopped. Paths are the JAX package's (``checkpoints/{name}/...``,
``weights/{name}/...``, relative to the working directory), each one file
written whole and renamed into place. The port cannot read the JAX
package's orbax checkpoints; ``weights.from_flax`` and
``weights.opt_state_from_optax`` take their contents as numpy trees.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _save(path: str, payload: Dict[str, Any]) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load(path: str) -> Dict[str, Any]:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def save_weights(path: str, model: torch.nn.Module) -> None:
    """Weights-only file: the model's ``state_dict`` (reference
    model_io.py:5-11)."""
    _save(path, model.state_dict())


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a weights file, on the CPU."""
    return _load(path)


def save_checkpoint(path: str, state, epoch: int, best_rmse: float = float("inf")) -> None:
    """Full training checkpoint of ``state`` (``train/steps.py::TrainState``)
    after ``epoch``."""
    _save(path, {"model": state.model.state_dict(), "opt_state": state.tx.state_dict(),
                 "step": int(state.step), "epoch": int(epoch),
                 # float32, as the JAX package stores it
                 "best_rmse": float(np.float32(best_rmse))})


def load_checkpoint(path: str, state) -> Tuple[Any, int, float]:
    """Restore a full checkpoint into ``state`` in place (parameters and
    statistics copied onto their device). Returns (state, next_epoch,
    best_rmse). ``step`` is the optimizer's count, which the checkpoint's
    ``opt_state`` restores."""
    ckpt = _load(path)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.tx.load_state_dict(ckpt["opt_state"])
    if state.step != ckpt["step"]:
        raise ValueError(f"{path}: step {ckpt['step']} but the optimizer's count is "
                         f"{state.step}")
    return state, int(ckpt["epoch"]) + 1, float(ckpt["best_rmse"])
