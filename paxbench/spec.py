"""Find a cell's parts by name.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` is run from files
found by name alone, so a later change adds a configuration, a traffic
mix or a per-layer metric by adding files and entries, never by editing
one:

* ``configs/<config>.json``: the deployment (log geometry, replicas,
  groups, the driver's settings, its guarantees, its source and cuts);
* ``traffic/<traffic>.json``: the parameters of one mix, whose
  ``kind`` names the generator ``generators/<kind>.py``;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(ctx)`` returning a number, or None where it finds nothing.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name) or ".." in name:
        raise ValueError(f"not a name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{check_name(name)}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{check_name(name)}.json")


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(kind: str, base: Path = HERE) -> ModuleType:
    """The generator module of a traffic ``kind``."""
    return _module(base / "generators" / f"{check_name(kind)}.py",
                   f"paxbench.generators.{kind}")


def reader(metric: str, base: Path = HERE) -> ModuleType:
    """The reader module of a per-layer metric."""
    return _module(base / "metrics" / f"{check_name(metric)}.py",
                   f"paxbench.metrics.{metric}")


def _covers(metric: dict, workload: str) -> bool:
    wl = metric.get("workloads")
    return wl is None or workload in wl


def cell(workload: str, bench: Optional[dict] = None,
         base: Path = HERE) -> Dict:
    """Everything one run of ``workload`` needs: its entry, its
    configuration and traffic files, and the metrics it reports."""
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    e2e: List[dict] = [m for m in bench["end_to_end"]
                       if _covers(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _covers(m, workload) and m["moves"] in e2e_names]
    return dict(name=workload, entry=entry,
                config=config(entry["config"], base),
                traffic=traffic(entry["traffic"], base),
                end_to_end=e2e, per_layer=layer)
