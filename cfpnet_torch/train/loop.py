"""Training and evaluation loops.

Port of ``cfpnet_tpu/train/loop.py`` (``JsonlLogger``, ``make_eval_steps``,
``evaluate``, ``_Subset``, ``make_grouped_eval``, ``run_training``) for one
device: epochs of ``train/steps.py`` steps over the prefetching loader,
validation with the nine metrics every ``validate_every`` epochs and always
at the last, ``{ep}_{rmse:.3f}`` and ``best`` checkpoints, resume with the
optimizer state and the step, JSONL logs. Not ported: ``evaluate_sharded``
and the meshes (multi-GPU, ROADMAP.md §A 9).

``--device_pipeline`` (``cfpnet_tpu/train/loop.py:486-500, 515-517``): the
loader ships raw crops and ``data/tof_sim_device.py::preprocess_batch``
makes each step's batch on its device, between the loader and the step,
with draws from a generator on that device seeded from (seed, step)
(``prep_generator``), so that a resumed run draws what the uninterrupted
one drew. ``--debug_nans`` reads each step's loss on the host and raises
``FloatingPointError`` naming the step where it is not finite, or where
autograd's anomaly mode (``train/__main__.py``) found a NaN in the
backward; without it the step reads nothing.

The step runs in ``--compute_dtype`` (``train/steps.py``); validation runs
the float32 model on its float32 masters in every case, as the JAX loop's
eval steps cast nothing, and the checkpoints hold the float32 state.

The loop makes no host sync in a step: the losses are summed on the device
and read at the JSONL ``train`` lines (every 50 steps) and at the end of an
epoch, where the JAX loop reads each step's loss (``float(loss)``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data import native
from ..data.geometry import geometry_for, zone_offset_for
from ..data.pipeline import make_loader
from ..data.tof_sim_device import preprocess_batch
from ..models.deltar import make_model, model_geometries
from .checkpoint import load_checkpoint, save_checkpoint, save_weights
from .losses import RunningAverageDict
from .steps import create_train_state, make_eval_step, make_metric_step, make_train_step

EVAL_METRIC_KEYS = ["a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog",
                    "sq_rel"]


class JsonlLogger:
    def __init__(self, path: Optional[str]):
        self.f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.f = open(path, "a")

    def log(self, **kw):
        if self.f:
            kw.setdefault("ts", time.time())
            self.f.write(json.dumps(kw) + "\n")
            self.f.flush()

    def close(self):
        if self.f:
            self.f.close()


def make_eval_steps(model, config, loader, protocol: str = "validate"):
    """(eval_step, metric_step) for a loader: a dataset that carries measured
    sensor geometry (ZJUL5 rects, ``scale_geoms``) overrides the configured
    zone grid (reference zjuL5.py:135)."""
    geoms = getattr(getattr(loader, "dataset", None), "scale_geoms", None)
    if geoms is None:
        geoms = model_geometries(config, "online_eval")
    return (make_eval_step(model, config, geoms, protocol=protocol),
            make_metric_step(config, protocol=protocol))


def _pad(batch: Dict[str, torch.Tensor], size: int) -> Dict[str, torch.Tensor]:
    """A ragged batch padded to ``size`` rows by repeating its last row."""
    return {k: torch.cat([v] + [v[-1:]] * (size - v.shape[0])) for k, v in batch.items()}


def evaluate(model, config, loader, protocol: str = "validate", steps=None,
             per_image_hook=None, _accumulator=None) -> Dict[str, float]:
    """Metric sweep over an eval loader at its resolution.

    Metrics are computed per image and averaged image-weighted through
    ``RunningAverageDict``, as the reference's bs=1 protocol, at any
    ``--eval_bs``: a ragged last batch is padded by repeating its last
    sample and the pad images are left out; a sample whose
    ``has_valid_depth`` is false is skipped (reference train.py:179-181);
    ``image_u8`` batches are normalized on the device. One copy to the host
    a batch carries the metrics, the valid counts and the flags.

    ``steps=(eval_step, metric_step)`` reuses the steps across calls.
    ``per_image_hook(dataset_index, pred_hw, batch, j)`` is called for each
    real sample with its full-resolution prediction and the host copy of the
    batch's ``image_u8``/``image``/``depth`` (the loader is sequential, so
    ``dataset_index`` counts the dataset)."""
    eval_step, metric_step = steps if steps is not None else make_eval_steps(
        model, config, loader, protocol)
    eval_bs = getattr(loader, "batch_size", 1)
    metrics = RunningAverageDict() if _accumulator is None else _accumulator
    seen = 0
    for batch in loader:
        hvd = batch.pop("has_valid_depth", None)
        img_key = "image_u8" if "image_u8" in batch else "image"
        n_real = int(batch[img_key].shape[0])
        if n_real < eval_bs:
            batch = _pad(batch, eval_bs)
        pred, _prob = eval_step(batch)
        m, n = metric_step(batch["depth"], pred)
        rows = [m[k] for k in m] + [n.to(pred.dtype)]
        if hvd is not None:
            rows.append(_pad({"h": hvd}, eval_bs)["h"].to(pred.dtype))
        host = torch.stack(rows).cpu().numpy()
        m = dict(zip(m, host[:len(m)]))
        n, flags = host[len(m)], (host[len(m) + 1] if hvd is not None else None)
        if per_image_hook is not None:
            pred_host = pred.cpu().numpy()
            host_batch = {k: batch[k].cpu().numpy() for k in ("image_u8", "image", "depth")
                          if k in batch}
            for j in range(n_real):
                per_image_hook(seen + j, pred_host[j, ..., 0], host_batch, j)
        for j in range(n_real):
            if flags is not None and not flags[j]:
                continue
            if int(n[j]) > 0:
                metrics.update({k: float(v[j]) for k, v in m.items()})
        seen += n_real
    return metrics.get_value() or {}


class _Subset:
    """Index view of a dataset (keeps ``scale_geoms`` and ``sample_meta``)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)
        try:
            self.scale_geoms = getattr(dataset, "scale_geoms", None)
        except ValueError:
            # a mixed-rig dataset: make_grouped_eval sets each group's geometry
            self.scale_geoms = None

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def sample_meta(self, i):
        fn = getattr(self.dataset, "sample_meta", None)
        if fn is not None:
            return fn(self.indices[i])
        return "eval", f"{self.indices[i]:05d}"


def make_grouped_eval(model, config, dataset, protocol: str = "validate", device="cuda"):
    """Evaluation over a dataset whose captures may come from several rigs.

    The reference recomputes the ZJUL5 zone geometry per capture (reference
    zjuL5.py:106-135); here the geometry of an eval step is fixed, so a
    mixed-rig dataset (several ``geometry_groups``) gets one step pair per
    group, and the groups' per-image metrics stream into one
    ``RunningAverageDict``: the same image-weighted averages as one flat
    sweep. Returns ``eval_fn(per_image_hook=None) -> metrics``, reusable
    across epochs; the hook is called with global dataset indices."""
    groups = getattr(dataset, "geometry_groups", None)
    if not groups or len(groups) <= 1:
        loader = make_loader(config, "online_eval", dataset=dataset, device=device)
        steps = make_eval_steps(model, config, loader, protocol)

        def eval_fn(per_image_hook=None):
            return evaluate(model, config, loader, protocol=protocol, steps=steps,
                            per_image_hook=per_image_hook)

        return eval_fn

    plans = []
    for geoms, indices, _fr in groups:
        sub = _Subset(dataset, indices)
        sub.scale_geoms = geoms
        loader = make_loader(config, "online_eval", dataset=sub, device=device)
        plans.append((sub, loader, make_eval_steps(model, config, loader, protocol)))

    def eval_fn(per_image_hook=None):
        acc = RunningAverageDict()
        for sub, loader, steps in plans:
            hook = None
            if per_image_hook is not None:
                hook = (lambda s: lambda i, pred_hw, batch, j:
                        per_image_hook(s.indices[i], pred_hw, batch, j))(sub)
            evaluate(model, config, loader, protocol=protocol, steps=steps,
                     per_image_hook=hook, _accumulator=acc)
        return acc.get_value() or {}

    return eval_fn


def prep_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s device-pipeline draws, on
    ``device``: seeded from (seed, step, 777), the JAX loop's
    ``fold_in(fold_in(key(seed), step), 777)``."""
    state = np.random.SeedSequence([int(seed), int(step), 777]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def debug_nans_step(train_step):
    """``train_step`` with ``--debug_nans``'s checks: the loss read on the
    host after the step and ``FloatingPointError`` naming the step (the
    optimizer's count before it) where it is not finite; anomaly mode's
    error on a NaN in the backward raised as ``FloatingPointError`` naming
    the step. A step that returns a dict of terms
    (``train/selfsup.py``) is checked on its ``loss``."""

    def checked(state, batch, seed):
        step = state.step
        try:
            out = train_step(state, batch, seed)
        except RuntimeError as e:
            if "nan" not in str(e).lower():
                raise
            raise FloatingPointError(f"--debug_nans: step {step}: {e}") from e
        loss = out["loss"] if isinstance(out, dict) else out
        if not bool(torch.isfinite(loss)):
            raise FloatingPointError(f"--debug_nans: step {step}: the loss is {float(loss)}")
        return out

    return checked


def run_training(config, tiny: bool = False, max_steps_per_epoch: Optional[int] = None,
                 device="cuda", init_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 trace: Optional[List[dict]] = None,
                 step_context: Callable[[int], contextlib.AbstractContextManager] = (
                     lambda step: contextlib.nullcontext())):
    """End-to-end training (reference train.py main_worker + train): returns
    the final ``TrainState``.

    The model starts from torch's init under ``torch.manual_seed(seed)``, or
    from ``init_state_dict``; ``--resume`` then restores a full checkpoint.
    Step ``s`` draws its crop offsets from ``steps.step_generator(seed +
    s)``. With ``--train_zone_random_offset N`` batch ``b`` of epoch ``e``
    runs the train step built for ``zone_offset_for(seed, e, b, N)``, built
    at its first use; the loader simulated that batch's histograms at the
    same offset. ``trace``, when a list, gets one dict a step (epoch, step,
    the batch's dataset indices, its zone offset, the learning rate of the
    'rest' group, the loss as a device tensor); ``step_context(step)``
    wraps each step, the fetch of its batch included."""
    if getattr(config, "spatial_shards", 0) > 1:
        raise NotImplementedError("--spatial_shards > 1: spatial sharding is not ported yet "
                                  "(ROADMAP.md §A 9)")
    zone_off = int(getattr(config, "train_zone_random_offset", 0) or 0)
    if zone_off > 0 and config.device_pipeline:
        raise NotImplementedError(
            "--train_zone_random_offset with --device_pipeline is not wired (the on-device "
            "ToF sim uses one static geometry); drop one of the two flags")
    device = torch.device(device)
    train_loader = make_loader(config, "train", device=device)
    eval_loader = make_loader(config, "online_eval", device=device)
    torch.manual_seed(config.seed)
    model = make_model(config, tiny=tiny, device=device)
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict, strict=True)

    steps_per_epoch = len(train_loader)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    state = create_train_state(model, config, config.epochs * steps_per_epoch)

    start_epoch, best_rmse = 0, float("inf")
    if config.resume:
        state, start_epoch, best_rmse = load_checkpoint(config.resume, state)
        print(f"resumed from {config.resume} at epoch {start_epoch}")

    step_fns = {}

    def train_step_for(o: int):
        if o not in step_fns:
            step = make_train_step(model, config, model_geometries(config, "train", (o, o)))
            step_fns[o] = debug_nans_step(step) if config.debug_nans else step
        return step_fns[o]

    pix_geom = geometry_for(config, "train") if config.device_pipeline else None

    logger = JsonlLogger(
        None if config.no_logging else os.path.join(config.save_dir, "train_log.jsonl"))
    logger.log(kind="header", tof_path=native.active(), device=str(device),
               epochs=config.epochs, start_epoch=start_epoch, steps_per_epoch=steps_per_epoch,
               bs=config.bs, resume=config.resume)
    eval_steps = (make_eval_step(model, config, model_geometries(config, "online_eval"),
                                 protocol="validate"),
                  make_metric_step(config, protocol="validate"))

    step = state.step
    for epoch in range(start_epoch, config.epochs):
        t_epoch = time.perf_counter()
        train_loader.set_epoch(epoch)  # align the shuffle and zone-offset streams
        loss_sum = torch.zeros((), device=device)
        n_steps = 0
        batches = iter(train_loader)
        try:
            while True:
                with step_context(step):
                    batch = next(batches, None)
                    if batch is None or (max_steps_per_epoch and n_steps >= max_steps_per_epoch):
                        break
                    o = zone_offset_for(config.seed, epoch, n_steps, zone_off) if zone_off else 0
                    lr = float(state.tx.lr_fn(state.tx.count))
                    if pix_geom is not None:
                        batch = preprocess_batch(batch, config, pix_geom,
                                                 prep_generator(config.seed, step, device))
                    loss = train_step_for(o)(state, batch, config.seed + step)
                    loss_sum += loss
                    if trace is not None:
                        trace.append(dict(epoch=epoch, step=step, zone_offset=o, lr=lr,
                                          indices=[int(j) for j in train_loader.indices],
                                          loss=loss))
                    n_steps += 1
                    step += 1
                    if step % 50 == 0:
                        logger.log(kind="train", epoch=epoch, step=step, loss=float(loss))
        finally:
            batches.close()
        epoch_loss = float(loss_sum) / max(n_steps, 1)  # the epoch's one read of the losses
        train_s = time.perf_counter() - t_epoch
        # the consumer's wait for each step's batch, and the producer's time
        # to make each batch: which of the two sets the loop's pace
        timing = dict(steps=n_steps, train_s=train_s,
                      loader_wait_ms=[1e3 * w for w in train_loader.wait_s],
                      producer_ms=[1e3 * p for p in train_loader.produce_s])

        # validation and checkpoints every validate_every epochs and always at
        # the last, so that no run ends without a checkpoint
        stride = max(int(config.validate_every), 1)
        if (epoch + 1) % stride == 0 or epoch + 1 == config.epochs:
            t_val = time.perf_counter()
            metrics = evaluate(model, config, eval_loader, protocol="validate",
                               steps=eval_steps)
            timing["val_s"] = time.perf_counter() - t_val
            rmse = metrics.get("rmse", float("inf"))
            logger.log(kind="val", epoch=epoch, step=step, **metrics)
            print(f"epoch {epoch}: loss {epoch_loss:.4f} rmse {rmse:.4f} "
                  f"({time.perf_counter() - t_epoch:.0f}s)")
            if not config.no_logging:
                t_ckpt = time.perf_counter()
                # the epoch's checkpoint carries best_rmse from before this
                # epoch's update, as the JAX package's does
                save_checkpoint(f"checkpoints/{config.name}/{epoch}_{rmse:.3f}", state, epoch,
                                best_rmse)
                save_weights(f"weights/{config.name}/{epoch}_{rmse:.3f}", model)
                if rmse < best_rmse:
                    best_rmse = rmse
                    save_checkpoint(f"checkpoints/{config.name}/best", state, epoch, best_rmse)
                    save_weights(f"weights/{config.name}/best", model)
                timing["checkpoint_s"] = time.perf_counter() - t_ckpt
        logger.log(kind="epoch", epoch=epoch, step=step, loss=epoch_loss, **timing)
    logger.close()
    return state
