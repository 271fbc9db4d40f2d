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
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from . import tracing
from .data.geometry import ScaleGeometry

WARMUP = 3  # eager calls before the capture


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
            # the kernel launches the graph holds, by counter: recorded, not run
            self.launches = {k: n - before.get(k, 0)
                             for k, n in tracing.counters("kernel.").items()
                             if n != before.get(k, 0)}
            for k, n in self.launches.items():
                tracing.count(k, -n)
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
