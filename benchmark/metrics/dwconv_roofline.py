"""The large-kernel depthwise conv kernel's share of its roofline: the least
time of its calls in a forward (``counters.least_ms``) over its device time a
forward in the trace."""

from benchmark.reference.counters import least_ms


def read(run):
    seconds = run.trace.kernel_s("dwconv_kernel")
    if seconds <= 0:
        return None
    least = sum(least_ms(k, shape, run.traffic["dtype"]) for k, shape in run.calls
                if k == "dwconv")
    return 100.0 * least * 1e-3 * run.trace.items / seconds
