"""The benchmark's data, found by name: `BENCHMARK.json` at the root of the
checkout, and under `vobench/` a configuration (`configs/<name>.json`), a
traffic mix (`traffic/<name>.json`, whose `driver` names the module of
`drivers/` that runs it), a cell's limits of the comparison
(`limits/<workload>.json`) and a per-layer metric's reader
(`metrics/<name>.py`). A new configuration, mix, cell or per-layer metric
is a new file and an entry in `BENCHMARK.json`; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts: str) -> Dict:
    path = os.path.join(*parts)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return _json(root, "BENCHMARK.json")


def cell(bench: Dict, workload: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> Dict:
    return _json(HERE, "configs", f"{name}.json")


def mix(name: str) -> Dict:
    return _json(HERE, "traffic", f"{name}.json")


def limits(workload: str) -> Dict:
    return _json(HERE, "limits", f"{workload}.json")


def driver(name: str):
    return importlib.import_module(f"vobench.drivers.{name}")


def reader(metric: str):
    """The module of `metrics/<metric>.py` (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader vobench/metrics/{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"vobench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(bench: Dict, workload: str) -> List[Dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if _applies(m, workload)]


def per_layer(bench: Dict, workload: str) -> List[Dict]:
    """The per-layer metrics this cell's traced run reports: those that
    list it, or that list no cells and move one of its end-to-end
    metrics."""
    e2e = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
