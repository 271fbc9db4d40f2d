"""``BENCHMARK.json`` and the files each of its names resolves to.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own that the harness finds by that name, and a
configuration names its model family the same way. So a new cell,
configuration, mix, per-layer metric or model family is new files and new
entries, never an edit:

- ``benchmark/configs/<config>.json``: the configuration's settings (the
  argfile's flags, copied), its source, ``reduced`` and ``assumed``, and
  ``family``, the model it configures (``cfpnet`` where the file names
  none);
- ``benchmark/families/<family>.py``: everything that belongs to the model,
  behind the interface that ``families/__init__.py`` sets out: its inputs,
  seeded weights, the port's model and captured forward or train step, the
  plain reference, the comparison of outputs and the work counts;
- ``benchmark/reference/<family>.py`` (and files beside it): the family's
  plain reference, importing nothing of the system under test;
- ``benchmark/traffic/<traffic>.json``: the parameters of the mix (which
  driver runs it, batch, dtype, pool of distinct inputs, what is checked and
  traced), read by the driver that the mix names (``drivers.py``);
- ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric,
  ``read(run) -> float | None``;
- ``benchmark/limits/<cell>.json``: the limit of each number the cell's
  output check compares.

A configuration of a new model is thus a family module, its reference, a
configuration file, a limits file a cell, and new entries in
``BENCHMARK.json``: the configuration, its cells, and each cell's name in the
``workloads`` lists of the end-to-end metrics it reports.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
DEFAULT_FAMILY = "cfpnet"


class Spec:
    """One ``BENCHMARK.json``, its directory the root of the checkout."""

    def __init__(self, path: Path, here: Path = HERE):
        self.path, self.here = Path(path), Path(here)
        self.data = json.loads(self.path.read_text())

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def _json(self, folder: str, name: str) -> Dict:
        return json.loads((self.here / folder / f"{name}.json").read_text())

    def config(self, cell: Dict) -> Dict:
        return self._json("configs", cell["config"])

    def traffic(self, cell: Dict) -> Dict:
        return self._json("traffic", cell["traffic"])

    def family(self, cell: Dict):
        """The module of the model family that the cell's configuration
        names (``families/<family>.py``), imported with the benchmark's
        package."""
        name = self.config(cell).get("family", DEFAULT_FAMILY)
        if not name.isidentifier():
            raise ValueError(f"family {name!r} of {cell['config']} is not a module name")
        return importlib.import_module(f"{__package__}.families.{name}")

    def limits(self, cell: Dict) -> Dict[str, float]:
        return self._json("limits", cell["name"])

    def end_to_end(self, cell: Dict) -> List[Dict]:
        """The cell's end-to-end metrics: those with no ``workloads`` and
        those that list it."""
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: Dict) -> List[Dict]:
        """The cell's per-layer metrics: those that list it, and those
        without a list whose ``moves`` metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell["name"] in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in reported)]

    def reader(self, metric: Dict):
        """The ``read`` function of a per-layer metric's file."""
        path = self.here / "metrics" / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric['name']}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
