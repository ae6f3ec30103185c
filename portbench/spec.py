"""``BENCHMARK.json`` and the files it names, found by name.

- a cell: an entry of ``workloads``;
- its configuration: ``portbench/configs/<config>.json``, whose
  ``driver`` names ``portbench/drivers/<driver>.py`` (``run``);
- its traffic: ``portbench/traffic/<traffic>.json``, whose
  ``generator`` names ``portbench/generators/<generator>.py``
  (``build``);
- each metric: ``portbench/metrics/<name>.py`` (``read``), taken for a
  cell where the metric has no ``workloads`` list or its list names the
  cell.

A new cell, mix, configuration or metric is new files and entries; no
file here changes."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module of the package."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    mod = f"portbench.{kind}.{name.replace('.', '__').replace('-', '_')}"
    if mod in sys.modules:
        return sys.modules[mod]
    spec = importlib.util.spec_from_file_location(mod, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod] = module
    spec.loader.exec_module(module)
    return module


def load_json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return json.loads((HERE / kind / f"{name}.json").read_text())


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, bench: dict = None) -> Cell:
    """The cell ``workload`` of ``bench`` (default: the repository's
    ``BENCHMARK.json``) with its configuration and traffic files."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    return Cell(workload, w, load_json("configs", w["config"]),
                load_json("traffic", w["traffic"]),
                [m for m in bench["end_to_end"] if applies(m, workload)],
                [m for m in bench["per_layer"] if applies(m, workload)])
