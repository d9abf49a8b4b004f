"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration file (``configs/<config>.json``, the path the file names),
its traffic mix (``traffic/<traffic>.json``), its correctness limits
(``limits/<workload>.json``), the metrics it reports (``metrics/<name>.py``,
each with ``read(ctx)``) and the counts those read (``counts/<name>.py``).
Adding a cell or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List, Optional


class Cell:
    def __init__(self, root: str, workload: str):
        self.root = os.path.abspath(root)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = self._json(self.config_entry["file"])
        self.traffic = self._json(os.path.join(self.dir, "traffic",
                                               self.workload["traffic"] + ".json"))
        limits = os.path.join(self.dir, "limits", workload + ".json")
        self.limits = self._json(limits) if os.path.exists(limits) else {}

    @property
    def dir(self) -> str:
        return os.path.join(self.root, "bench_h100")

    def _json(self, path: str) -> dict:
        with open(os.path.join(self.root, path)) as f:
            return json.load(f)

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: end-to-end ones with ``--trace 0``,
        per-layer ones with ``--trace 1``."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load(os.path.join(self.dir, "metrics", metric + ".py"), f"metric_{metric}").read

    def count(self, name: str):
        return load(os.path.join(self.dir, "counts", name + ".py"), f"count_{name}")


def load(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peak(root: str, device_name: str, key: str) -> Optional[float]:
    """A published peak of the card (``counts/peaks.json``, matched in order
    against the card's name), None for a card not listed."""
    with open(os.path.join(root, "bench_h100", "counts", "peaks.json")) as f:
        table = json.load(f)["cards"]
    for entry in table:
        if entry["match"] in device_name:
            return entry[key]
    return None
