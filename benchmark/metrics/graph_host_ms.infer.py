"""Host milliseconds of a frame's call into the CUDA graph, its launch left
out: the port's span ``graph.call`` (``cfpnet_torch/graphs.py::CapturedCall``)
less its child ``graph.replay``, which leaves the copies of the inputs into
the graph's buffers (``graph.copy_in``) and the call's checks. Under the
profiler the replay's launch holds the host for milliseconds, which measures
CUPTI and not the port, so it is not read. The median over the traced
frames: the last ``run.trace.items`` calls, one a frame, so that an earlier
traced attempt is not read again. The port's spans record while the profiler
runs (``cfpnet_torch.tracing``); none where the port has no such span."""

import statistics


def read(run):
    try:
        from cfpnet_torch import tracing
    except ImportError:
        return None
    spans = tracing.snapshot().spans
    calls = [s for s in spans if s.name == "graph.call"][-run.trace.items:]
    if not calls:
        return None
    ids = {s.id for s in calls}
    replay = {s.parent: s.ms for s in spans if s.name == "graph.replay" and s.parent in ids}
    return statistics.median(s.ms - replay.get(s.id, 0.0) for s in calls)
