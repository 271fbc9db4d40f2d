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
- The kernels' launch counters (``kernels/*.py``) count in Python, so they
  count at capture and never at a replay: count launches on an eager pass.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .data.geometry import ScaleGeometry

WARMUP = 3  # eager forwards before the capture


class CapturedForward:
    """The eval forward of ``model`` at ``batch_size`` images of the
    config's native size, captured in one ``torch.cuda.CUDAGraph``.

    A call ``captured(image, hist, mask)`` copies the inputs into the graph's
    static buffers, replays it and returns its static outputs
    ``(bin_edges, pred, prob, None)``. The next replay overwrites those
    outputs: clone what must outlive it. Raises ``ValueError`` on a model
    that is not on a CUDA device and on inputs of other shapes or dtypes
    (image and histogram in the model's dtype, the mask bool); an error
    during capture propagates. It never runs eagerly instead.
    """

    def __init__(self, model: torch.nn.Module, geoms: Dict[int, ScaleGeometry],
                 batch_size: int, config):
        param = next(model.parameters())
        device, dtype = param.device, param.dtype
        if device.type != "cuda":
            raise ValueError(f"CapturedForward needs a model on a CUDA device, got {device}")
        zones = config.eval_zone_num ** 2
        self.image = torch.zeros(batch_size, config.native_height, config.native_width, 3,
                                 device=device, dtype=dtype)
        self.hist = torch.zeros(batch_size, zones, config.zone_sample_num, device=device,
                                dtype=dtype)
        self.mask = torch.ones(batch_size, zones, dtype=torch.bool, device=device)
        args = (self.image, self.hist, self.mask, geoms)

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(WARMUP):
                model(*args)
        torch.cuda.current_stream(device).wait_stream(side)

        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph):
            self.outputs: Tuple = model(*args)
        self.graph.replay()
        torch.cuda.synchronize(device)

    def replay(self) -> Tuple:
        """One replay on the inputs already in the static buffers."""
        self.graph.replay()
        return self.outputs

    def __call__(self, image: torch.Tensor, hist: torch.Tensor, mask: torch.Tensor) -> Tuple:
        for name, got, static in (("image", image, self.image), ("hist", hist, self.hist),
                                  ("mask", mask, self.mask)):
            if got.shape != static.shape or got.dtype != static.dtype:
                raise ValueError(f"CapturedForward: {name} {tuple(got.shape)} {got.dtype}; the "
                                 f"graph was captured for {tuple(static.shape)} {static.dtype}")
            static.copy_(got)
        return self.replay()
