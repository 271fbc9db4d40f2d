"""A traced window: torch.profiler (CUPTI) over a fixed number of items,
reduced to what the per-layer readers and the result's ``breakdown`` read.

The profiler sees host events (the harness's own spans, PyTorch operators,
CUDA runtime calls) and device events (kernels, copies, fills). From them:

- ``busy_s``: the union of the device events' intervals, in seconds;
  ``window_s``: the host's seconds from the synchronize before the first
  item to the synchronize after the last;
- ``kernels``: every device kernel as ``(name, seconds)``, copies and
  fills left out;
- ``device_ops``: the ten device operations that took most time, summed by
  name; ``idle_gaps``: the ten longest intervals with no device event, each
  named by the innermost host event in flight at its middle, under the
  harness's span.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

NOT_KERNELS = ("Memcpy", "Memset", "Memory")
SPAN = "bench."  # the prefix of the harness's own spans (``record_function``)


class Trace:
    def __init__(self, items: int, images: int, window_s: float, device_events, host_events):
        self.items, self.images, self.window_s = items, images, window_s
        self.kernels = [(e.name, (e.time_range.end - e.time_range.start) * 1e-6)
                        for e in device_events if not e.name.startswith(NOT_KERNELS)]
        spans = sorted((e.time_range.start, e.time_range.end) for e in device_events)
        merged: List[List[float]] = []
        for start, end in spans:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        self.busy_s = sum(e - s for s, e in merged) * 1e-6
        totals: Dict[str, float] = {}
        for e in device_events:
            totals[e.name] = totals.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        self.device_ops = [[name[:160], us * 1e-6] for name, us in
                           sorted(totals.items(), key=lambda kv: -kv[1])[:10]]
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                      reverse=True)[:10]
        self.idle_gaps = [[_host_at(host_events, (s + e) / 2), us * 1e-6] for us, s, e in gaps]

    def kernel_s(self, *fragments: str) -> float:
        """Seconds of the kernels whose name holds one of ``fragments``."""
        return sum(s for name, s in self.kernels if any(f in name for f in fragments))


def _host_at(host_events, t: float) -> str:
    """``span/innermost``: the harness span and the innermost host event
    that cover time ``t``; "none" where no host event does."""
    covering = [e for e in host_events if e.time_range.start <= t <= e.time_range.end]
    if not covering:
        return "none"
    inner = max(covering, key=lambda e: e.time_range.start).name
    spans = [e.name for e in covering if e.name.startswith(SPAN)]
    return f"{spans[0]}/{inner}" if spans and spans[0] != inner else inner


def capture(run_items: Callable[[], Tuple[int, int]]) -> Trace:
    """Profiles ``run_items()``, which runs the traced items and returns
    ``(items, images)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        items, images = run_items()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the harness's spans show on the device's timeline too; they are no operation
    device = [e for e in events if e.device_type == cuda and not e.name.startswith(SPAN)]
    return Trace(items, images, window_s, device, [e for e in events if e.device_type != cuda])
