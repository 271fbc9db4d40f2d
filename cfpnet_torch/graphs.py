"""The eval forward captured once in a CUDA graph, replayed per batch.

PyTorch's counterpart of the JAX package's jitted forward
(``evaluate_time.py::timed_forward``): the forward has static shapes
throughout, so one capture per batch size replays every launch of it
(cuDNN, cuBLAS, elementwise and the three hand kernels) without the host.

``CapturedForward(model, geoms, batch_size, config)`` captures the forward
in the model's dtype (its parameters': float32, or bfloat16 after
``models/deltar.py::cast_to_compute_dtype``), so a graph is one (batch
size, dtype) and its image and histogram buffers are of that dtype. It
warms the model up
with a few eager forwards on a side stream, which does the first-call host
work outside the capture: the kernels' one-time attribute calls (dwconv's
and linear attention's shared-memory limits, attention's occupancy query
for clusters of 16, the fused LoFTR layer's limits and resident-tile
count), cuDNN's choice of algorithm, and the device copies of the resize
matrices (``ops/interp.py``). It then captures one forward into a memory
pool of its own.

What the graph bakes in:

- Every pointer of the forward, parameters included. The fused LoFTR
  kernel encodes its weights' TMA tensor maps on the host at each call
  (``csrc/fused_loftr.cu``, ``launch``), and the graph keeps them by value.
  ``model.load_state_dict`` copies into the same storage and is safe;
  moving or re-creating a parameter (``model.to``, ``model.cuda()`` on a
  CPU model, assigning a new ``nn.Parameter``) leaves the graph reading the
  old memory: capture again.
- The launches made with programmatic stream serialization (the fused LoFTR
  row pass, the attention apply pass) become programmatic edges; every
  other launch keeps a full edge to its predecessor. The attention apply
  pass reads q before ``griddepcontrol.wait``, which is safe only because
  its summary pass keeps that full edge.

Tracing (``tracing.py``): a call on new inputs is the span ``graph.call``
over ``graph.copy_in`` and ``graph.replay``, the build the span
``graph.capture``. The kernels' launch counters (``kernels/*.py``) count in Python, where a capture
records the launches without running them: ``CapturedCall`` takes the
capture's counts back and adds them at each replay (``launches``), so the
counters count what the device ran.

``CapturedTrainStep`` is the train step's graph (``train/steps.py::
make_train_step``): forward, loss, backward and the optimizer's update,
captured with autograd on at the second step and replayed for every later
one, its host values (crop offsets, the optimizer's per-step scalars)
copied into a static device buffer before each replay.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import tracing
from .data.geometry import ScaleGeometry
from .kernels.dtypes import dtype_name
from .models.fusion import CropShape, DeviceCrops, crop_starts

WARMUP = 3  # eager calls before the capture


def _take_back_launches(before: Dict[str, int]) -> Dict[str, int]:
    """The kernel launch counters' increments since ``before``, which a
    capture recorded without running them, taken back off the counters."""
    launches = {k: n - before.get(k, 0) for k, n in tracing.counters("kernel.").items()
                if n != before.get(k, 0)}
    for k, n in launches.items():
        tracing.count(k, -n)
    return launches


class CapturedCall:
    """``fn(*inputs)`` captured once in one ``torch.cuda.CUDAGraph`` over the
    static CUDA tensors ``inputs`` (named ``names``), without autograd.

    It warms ``fn`` up with ``WARMUP`` eager calls on a side stream, then
    captures one call into a memory pool of its own. ``replay()`` runs the
    graph on what the input buffers hold and returns its static outputs; a
    call ``captured(*tensors)`` copies the tensors into the buffers first,
    and raises ``ValueError`` on other shapes or dtypes. The next replay
    overwrites the outputs: clone what must outlive it. An error during
    capture propagates; it never runs eagerly instead. ``launches`` holds
    the kernel launch counters' increments of one replay.
    """

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], names: Sequence[str]):
        device = inputs[0].device
        if device.type != "cuda":
            raise ValueError(f"{type(self).__name__} needs inputs on a CUDA device, got {device}")
        self._inputs, self.names = tuple(inputs), tuple(names)

        with tracing.span("graph.capture"):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.no_grad(), torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(*self.inputs)
            torch.cuda.current_stream(device).wait_stream(side)

            self.graph = torch.cuda.CUDAGraph()
            before = tracing.counters("kernel.")
            with torch.no_grad(), torch.cuda.graph(self.graph):
                self.outputs = fn(*self.inputs)
            self.launches = _take_back_launches(before)
            self.replay()
            torch.cuda.synchronize(device)

    @property
    def inputs(self):
        """The static input buffers."""
        return self._inputs

    def replay(self):
        """One replay on the inputs already in the static buffers."""
        with tracing.span("graph.replay"):
            self.graph.replay()
        for k, n in self.launches.items():
            tracing.count(k, n)
        return self.outputs

    def __call__(self, *tensors: torch.Tensor):
        with tracing.span("graph.call"):
            with tracing.span("graph.copy_in"):
                for name, got, static in zip(self.names, tensors, self.inputs):
                    if got.shape != static.shape or got.dtype != static.dtype:
                        raise ValueError(f"{type(self).__name__}: {name} {tuple(got.shape)} "
                                         f"{got.dtype}; the graph was captured for "
                                         f"{tuple(static.shape)} {static.dtype}")
                    static.copy_(got)
            return self.replay()


class CapturedForward(CapturedCall):
    """The eval forward of ``model`` at ``batch_size`` images of the
    config's native size, captured in one ``torch.cuda.CUDAGraph``
    (``CapturedCall``).

    For ``--model_name deltar`` (CFPNet) a call ``captured(image, hist,
    mask)`` copies the inputs into the graph's static buffers ``image``,
    ``hist`` and ``mask``, replays it and returns its static outputs
    ``(bin_edges, pred, prob, None)``. For ``depth_anything_v2``, which
    reads the image alone, the graph has the one buffer ``image``: a call
    ``captured(image)`` returns ``(pred,)`` (``geoms`` unused). Raises
    ``ValueError`` on a model that is not on a CUDA device and on inputs of
    other shapes or dtypes (image and histogram in the model's dtype, the
    mask bool).
    """

    names = ("image", "hist", "mask")

    def __init__(self, model: torch.nn.Module, geoms: Dict[int, ScaleGeometry],
                 batch_size: int, config):
        param = next(model.parameters())
        device, dtype = param.device, param.dtype
        if device.type != "cuda":
            raise ValueError(f"CapturedForward needs a model on a CUDA device, got {device}")
        self.image = torch.zeros(batch_size, config.native_height, config.native_width, 3,
                                 device=device, dtype=dtype)
        if config.model_name == "depth_anything_v2":
            self.names = ("image",)
            fn = model
        else:
            zones = config.eval_zone_num ** 2
            self.hist = torch.zeros(batch_size, zones, config.zone_sample_num, device=device,
                                    dtype=dtype)
            self.mask = torch.ones(batch_size, zones, dtype=torch.bool, device=device)

            def fn(image, hist, mask):
                return model(image, hist, mask, geoms)
        super().__init__(fn, self.inputs, self.names)

    @property
    def inputs(self):
        return tuple(getattr(self, name) for name in self.names)


class SharedPool:
    """One memory pool for the graphs of several train steps of one run
    (``train/loop.py``'s step a zone offset), made at the first capture.
    Sharing is safe there: the steps replay one at a time on one stream,
    and nothing a graph allocates outlives its replay (its loss is cloned
    right after it), so another graph may reuse that memory between its
    replays."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class CapturedTrainStep:
    """A train step captured once in one ``torch.cuda.CUDAGraph`` and replayed
    for every later step: ``captured(state, batch, seed) -> loss``.

    ``run(state, batch, crops, scalars) -> loss`` is the step's device work
    (``train/steps.py::make_train_step``): the training forward with the
    crops ``crops`` (``models/fusion.py::DeviceCrops``), the loss, the
    backward and the optimizer's ``update`` on the per-step scalars
    ``scalars``, or ``state.tx.step()`` where ``scalars`` is None.
    ``generator(seed)`` is the step's crop generator.

    - The first call is an eager step, on a side stream as ``CapturedCall``
      warms up, with autograd on; its crops draw from the generator as they
      come and record their shapes.
    - The second call captures ``run`` into a private memory pool
      (``pool``, a ``SharedPool``, where several steps of one run share
      one), on static copies of the batch and a static device buffer of
      the crops' starts and the optimizer's scalars, then replays it.
    - Each later call copies the batch into the static inputs (device
      copies), draws the crops' starts from ``generator(seed)`` in the
      recorded order and takes ``state.tx.step_scalars``, both into a fresh
      pinned tensor copied to the static buffer in one non-blocking copy
      (the caching host allocator keeps the block until the copy has run),
      replays, advances the optimizer's count and returns a clone of the
      static loss: each call's loss is its own.

    A call on another state, or on a batch of other keys, shapes or dtypes,
    raises ``ValueError``. Kernel launch counters count replays as
    ``CapturedCall``'s do.
    """

    def __init__(self, run: Callable, generator: Callable[[int], torch.Generator],
                 pool: Optional[SharedPool] = None):
        self.run, self.generator, self.pool = run, generator, pool
        self.shapes: Optional[List[CropShape]] = None  # the crops of a step, in order
        self.graph = None

    def __call__(self, state, batch: Dict[str, torch.Tensor], seed: int) -> torch.Tensor:
        with tracing.span("train.step"):
            if self.shapes is None:
                return self._warm_up(state, batch, seed)
            if self.graph is None:
                with tracing.span("train.capture"):
                    self._capture(state, batch)
            return self._replay(state, batch, seed)

    def _warm_up(self, state, batch, seed):
        device = state.tx.params[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            crops = DeviceCrops(generator=self.generator(seed))
            loss = self.run(state, batch, crops, None)
        torch.cuda.current_stream(device).wait_stream(side)
        self.shapes = crops.shapes
        tracing.count("train.eager_steps")
        return loss

    def _capture(self, state, batch):
        tx = state.tx
        device, dtype = tx.params[0].device, tx.params[0].dtype
        self.state = state
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        n, k = len(self.shapes), len(tx.step_scalars(dtype))
        self._split = 8 * n  # int64 starts, then the optimizer's scalars in its dtype
        self.scalars = torch.zeros(self._split + k * dtype.itemsize, dtype=torch.uint8,
                                   device=device)
        self._np_dtype = np.dtype(dtype_name(dtype))
        starts = self.scalars[:self._split].view(torch.int64)
        values = self.scalars[self._split:].view(dtype)
        self.graph = torch.cuda.CUDAGraph()
        before = tracing.counters("kernel.")
        crops = DeviceCrops(starts=starts)
        # run() sets every .grad to None first: the backward allocates them in the pool.
        # "thread_local": the training loop's loader thread may pin a batch meanwhile, and
        # CUDA refuses the host allocator's event queries there during a global-mode capture.
        with torch.cuda.graph(self.graph, pool=self.pool.handle() if self.pool else None,
                              capture_error_mode="thread_local"):
            self.loss = self.run(state, self.batch, crops, values)
        self.launches = _take_back_launches(before)
        self.grads = [p.grad for p in tx.params]
        if crops.shapes != self.shapes:
            raise RuntimeError(f"the captured step took the crops {crops.shapes}, its eager "
                               f"step {self.shapes}")
        tracing.count("train.graph.captures")

    def _replay(self, state, batch, seed):
        if state is not self.state:
            raise ValueError("CapturedTrainStep: a call on another train state than the "
                             "one captured")
        with tracing.span("train.copy_in"):
            if batch.keys() != self.batch.keys():
                raise ValueError(f"CapturedTrainStep: a batch of {sorted(batch)}; the graph "
                                 f"was captured for {sorted(self.batch)}")
            for name, static in self.batch.items():
                got = batch[name]
                if got.shape != static.shape or got.dtype != static.dtype:
                    raise ValueError(f"CapturedTrainStep: {name} {tuple(got.shape)} "
                                     f"{got.dtype}; the graph was captured for "
                                     f"{tuple(static.shape)} {static.dtype}")
                static.copy_(got, non_blocking=True)
            host = torch.empty(self.scalars.shape, dtype=torch.uint8, pin_memory=True)
            raw = host.numpy()
            raw[:self._split].view(np.int64)[:] = crop_starts(self.shapes, self.generator(seed))
            raw[self._split:].view(self._np_dtype)[:] = state.tx.step_scalars(
                state.tx.params[0].dtype)
            self.scalars.copy_(host, non_blocking=True)
        with tracing.span("train.replay"):
            self.graph.replay()
        for k, n in self.launches.items():
            tracing.count(k, n)
        tracing.count("train.graph.replays")
        if state.tx.params[0].grad is not self.grads[0]:  # an eager step came between
            for p, g in zip(state.tx.params, self.grads):
                p.grad = g
        state.tx.count += 1
        return self.loss.clone()
