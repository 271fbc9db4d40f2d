"""The softmax attention's share of its roofline in the Depth Anything V2
cell: the least time of the forward's attention calls (their bytes and
operations from their shapes, ``reference/depth_anything_v2.py::least_ms``)
over the device time of the attention kernels a forward in the trace. The
kernels are those of the backend the port pins
(``cfpnet_torch/ops/dispatch.py::SOFTMAX_ATTENTION_BACKEND``), found by the
fragments of their names; none where the trace holds no such kernel."""

from benchmark.reference.depth_anything_v2 import least_ms

KERNELS = ("fort_native_sdpa",)  # cuDNN's fused attention kernels (the pinned backend)


def read(run):
    seconds = run.trace.kernel_s(*KERNELS)
    if seconds <= 0:
        return None
    least = sum(least_ms(shape) for k, shape in run.calls if k == "softmax_attention")
    return 100.0 * least * 1e-3 * run.trace.items / seconds
