"""Host milliseconds a train step spends in its optimizer step: the port's span
``train.optimizer`` (``cfpnet_torch/train/steps.py``, the clip and the
update of ``train/optim.py::AdamW``), summed over each step, the mean over
the traced steps: the last ``run.trace.items`` spans ``train.step``, so that
an earlier traced attempt is not read again. The port's spans record while
the profiler runs (``cfpnet_torch.tracing``); none where the port has no
such span."""

NAME = "train.optimizer"


def read(run):
    try:
        from cfpnet_torch import tracing
    except ImportError:
        return None
    spans = tracing.snapshot().spans
    steps = [s.root for s in spans if s.name == "train.step"][-run.trace.items:]
    if not steps:
        return None
    roots = set(steps)
    return sum(s.ms for s in spans if s.name == NAME and s.root in roots) / len(steps)
