"""``BENCHMARK.json`` and the files each of its names resolves to.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own that the harness finds by that name, so a
new cell, configuration, mix or per-layer metric is new files and new
entries, never an edit:

- ``benchmark/configs/<config>.json``: the configuration's settings (the
  argfile's flags, copied), its source, ``reduced`` and ``assumed``;
- ``benchmark/traffic/<traffic>.json``: the parameters of the mix (which
  driver runs it, batch, dtype, pool of distinct inputs, what is checked and
  traced), read by the one generator of ``inputs.py``;
- ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric,
  ``read(run) -> float | None``;
- ``benchmark/limits/<cell>.json``: the limit of each number the cell's
  output check compares.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent


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
