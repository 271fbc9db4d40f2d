"""Serving: ``torch.export`` artifacts of the eval path and their loader
(``export.py``), and a micro-batching HTTP endpoint over them
(``python -m cfpnet_torch.serve.http``)."""

from .export import (  # noqa: F401
    ServingModel,
    export_serving_artifact,
    make_serving_forward,
)
