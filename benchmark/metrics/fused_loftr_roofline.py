"""The fused LoFTR kernel's share of its roofline: the least time of its calls
in a forward (their bytes and operations from their shapes, ``counters.least_ms``)
over the device time of its two passes a forward in the trace."""

from benchmark.reference.counters import least_ms


def read(run):
    seconds = run.trace.kernel_s("summary_kernel", "rows_kernel")
    if seconds <= 0:
        return None
    least = sum(least_ms(k, shape, run.traffic["dtype"]) for k, shape in run.calls
                if k == "fused_loftr")
    return 100.0 * least * 1e-3 * run.trace.items / seconds
