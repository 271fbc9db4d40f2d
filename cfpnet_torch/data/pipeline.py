"""Host -> device data pipeline.

Port of ``cfpnet_tpu/data/pipeline.py`` (``collate``, ``DataLoader``,
``make_loader``): one producer thread decodes batches
(ToF simulation included) into a bounded queue while the device computes.
Batches are yielded in the JAX package's order: the shuffle of an epoch is
``np.random.default_rng(seed + epoch)``, and before it decodes batch ``b``
the producer sets the dataset's ``zone_offset`` to
``zone_offset_for(seed, epoch, b, n)``, the value ``train/loop.py`` computes
for the same step. An exception of the producer is raised in the consumer.

On a CUDA device the producer copies each batch into pinned host memory and
the consumer starts its copy to the device with ``non_blocking=True``: the
host does not wait for it, and the copy runs in stream order before the
step that reads it. Under ``--device_pipeline`` the train batches are the
raw ``image_raw`` and ``depth`` (``data/datasets.py``), shipped the same
way; ``train/loop.py`` makes the step's batch of them on the device.

In a data-parallel run (``parallel/mesh.py``) every process walks the same
global order and decodes only its rows of each full batch
(``mesh.rank_rows``: contiguous, as the JAX loader's per-process shard,
``cfpnet_tpu/data/pipeline.py:45-53, :101-107``; under ``--grad_accum``
its share of each microbatch in turn). A train batch size that the
processes do not divide raises the JAX loader's ``ValueError``. Eval
loaders are not split (``train/loop.py::evaluate_sharded`` splits the
images instead).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from .. import tracing
from ..parallel import mesh
from .datasets import collate, make_dataset
from .geometry import zone_offset_for


class DataLoader:
    """Epoch-based loader: shuffle, batch, background prefetch.

    ``world`` processes split each full batch, process ``rank`` decoding
    its rows (``mesh.rank_rows``, microbatch-major under ``accum`` > 1);
    ``indices`` holds the dataset indices of the rows last yielded.

    Tracing (``tracing.py``): the span ``data.wait`` is the consumer blocked
    on the queue for each batch it takes, ``data.produce`` the producer
    thread's decode, collate and pin of each batch it makes (a root on its
    own thread)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, prefetch: int = 2,
                 zone_random_offset: int = 0, device="cpu", rank: int = 0, world: int = 1,
                 accum: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        # this process's rows of a full batch (all of them in one process)
        self.rows = mesh.rank_rows(batch_size, world, rank, accum) if world > 1 else None
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.zone_random_offset = int(zone_random_offset)
        self.device = torch.device(device)
        self.epoch = 0
        self.indices = None

    def set_epoch(self, epoch: int):
        """Pin the epoch counter (shuffle and zone-offset streams), so that
        the loader and the train loop agree after ``--resume`` and after a
        consumer that left an epoch early (the implicit increment at the end
        of an iteration is then skipped)."""
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_order(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def _host_batch(self, chunk) -> Dict[str, torch.Tensor]:
        batch = collate([self.dataset[int(i)] for i in chunk])
        pin = self.device.type == "cuda"
        return {k: (torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v))
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order = self._index_order()
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    if self.zone_random_offset > 0:
                        self.dataset.zone_offset = zone_offset_for(
                            self.seed, self.epoch, b, self.zone_random_offset)
                    chunk = order[b * self.batch_size: (b + 1) * self.batch_size]
                    if self.rows is not None and len(chunk) == self.batch_size:
                        chunk = chunk[self.rows]
                    with tracing.span("data.produce"):
                        batch = self._host_batch(chunk)
                    q.put((chunk, batch))
            except Exception as e:  # raised in the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            for _ in range(nb):
                with tracing.span("data.wait"):
                    item = q.get()
                if item is None:  # the producer stopped without a batch or an error
                    break
                if isinstance(item, Exception):
                    raise item
                self.indices, batch = item
                yield {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, then let it finish
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)
        self.epoch += 1


def make_loader(config, mode: str, dataset=None, device="cuda") -> DataLoader:
    """The loader policy of the JAX package: train at ``--bs``, shuffled,
    last partial batch dropped, split over the processes of a data-parallel
    run; eval at ``--eval_bs`` in order."""
    if dataset is None:
        dataset = make_dataset(config, mode)
    if mode == "train":
        # the microbatches of the step (the self-supervised one has none)
        accum = 1 if config.selfsup else int(config.grad_accum or 1)
        return DataLoader(dataset, config.bs, shuffle=True, drop_last=True, seed=config.seed,
                          zone_random_offset=getattr(config, "train_zone_random_offset", 0),
                          device=device, rank=mesh.rank(), world=mesh.world_size(),
                          accum=accum)
    return DataLoader(dataset, max(1, getattr(config, "eval_bs", 1)), shuffle=False,
                      drop_last=False, device=device)
