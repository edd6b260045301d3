"""Find what ``BENCHMARK.json`` names: a cell's configuration, its traffic
mix, its limits and every metric's reader, each by name, each in a file of
its own.

A checkout holds ``BENCHMARK.json`` at its root.  Under each directory of
its ``paths``:

* ``traffic/<traffic>.json``: a traffic mix (``lib/traffic.py`` reads it);
  one with ``"extends": <name>`` starts from that mix's keys;
* ``cells/<workload>.json``: the limits that decide ``correct`` in a cell;
* ``metrics/<metric>.py``: one metric's reader, a module with
  ``read(rec)`` that returns a number, or None where the run has nothing
  to read;
* a configuration is the ``file`` its ``configs`` entry names; its plain
  reference is the module beside it that the file's ``"reference"`` key
  names.

Adding a cell, a mix, a configuration or a metric adds files and entries:
nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root``, and the files it
    names."""

    def __init__(self, root):
        self.root = Path(root).resolve()
        with open(self.root / "BENCHMARK.json") as f:
            self.doc = json.load(f)
        self.dirs = [self.root / p for p in self.doc["paths"]]
        self.configs = {c["name"]: c for c in self.doc["configs"]}
        self.workloads = {w["name"]: w for w in self.doc["workloads"]}
        self.metrics = {m["name"]: m for m in
                        self.doc["end_to_end"] + self.doc["per_layer"]}

    def _find(self, sub: str, name: str) -> Path:
        hits = [d / sub / name for d in self.dirs if (d / sub / name).is_file()]
        if len(hits) != 1:
            raise FileNotFoundError(
                f"{sub}/{name}: {len(hits)} files under {self.doc['paths']}")
        return hits[0]

    def workload(self, name: str) -> Dict[str, Any]:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(self.workloads)}")
        return self.workloads[name]

    def config(self, name: str) -> Dict[str, Any]:
        """The configuration file's contents, with ``_path`` (its file)."""
        entry = self.configs[name]
        path = self.root / entry["file"]
        with open(path) as f:
            cfg = json.load(f)
        cfg["_path"] = str(path)
        cfg["_name"] = name
        return cfg

    def reference(self, cfg: Dict[str, Any]):
        """The plain reference module beside a configuration's file."""
        path = Path(cfg["_path"]).parent / f"{cfg['reference']}.py"
        return load_module(path, f"bench_ref_{cfg['reference']}")

    def traffic(self, name: str) -> Dict[str, Any]:
        with open(self._find("traffic", f"{name}.json")) as f:
            doc = json.load(f)
        if "extends" in doc:
            base = self.traffic(doc.pop("extends"))
            base.update(doc)
            doc = base
        doc["_name"] = name
        return doc

    def cell(self, workload: str) -> Dict[str, Any]:
        with open(self._find("cells", f"{workload}.json")) as f:
            return json.load(f)

    def reader(self, metric: str) -> Callable:
        path = self._find("metrics", f"{metric}.py")
        mod = load_module(path, "bench_metric_" + metric.replace(".", "_"))
        return mod.read

    def metrics_of(self, workload: str, section: str) -> List[Dict]:
        """The metrics of ``section`` ("end_to_end" or "per_layer") that
        ``workload`` reports: those without a ``workloads`` key and those
        that list it."""
        return [m for m in self.doc[section]
                if "workloads" not in m or workload in m["workloads"]]


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name`` (once)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, str(path))
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_metrics(spec: Spec, workload: str, section: str,
                 rec: Dict[str, Any]) -> Dict[str, Dict]:
    """``{name: {"value": v, "unit": u}}`` of every metric of ``section``
    that ``workload`` reports and whose reader finds something to read."""
    out = {}
    for m in spec.metrics_of(workload, section):
        v: Optional[float] = spec.reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
