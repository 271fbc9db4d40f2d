"""Device kernels launched a train step, counted in the trace."""


def read(run):
    if not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.trace.items
