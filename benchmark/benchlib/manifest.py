"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration and traffic mix; each lives in a file of
its own under ``benchmark/`` (``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json``), the traffic file names
its driver (``drivers/<driver>.py``) and each per-layer metric has a reader
(``metrics/<metric>.py``). Adding a cell adds files; it edits none."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def load_module(kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its configuration, traffic, limits
    and metrics."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench or manifest()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(os.path.join(ROOT, configs[self.entry["config"]]["file"]))
        self.traffic = _json(os.path.join(BENCH_DIR, "traffic", f"{self.entry['traffic']}.json"))
        self.limits = _json(os.path.join(BENCH_DIR, "limits", f"{name}.json"))
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
        self.units: Dict[str, str] = {m["name"]: m["unit"]
                                      for m in bench["end_to_end"] + bench["per_layer"]}

    def driver(self) -> ModuleType:
        return load_module("drivers", self.traffic["driver"])

    def readers(self) -> List[ModuleType]:
        return [load_module("metrics", m["name"]) for m in self.per_layer]
