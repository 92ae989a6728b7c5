"""Find a cell's pieces by the names in ``BENCHMARK.json``.

* a configuration: the ``file`` its entry names (``benchmark/configs/``);
* a traffic mix: ``benchmark/traffic/<traffic>.json``;
* the query a traffic mix drives: ``benchmark/queries/<query>.py``;
* a per-layer metric: ``benchmark/metrics/<name>.py``, whose ``read(view)``
  returns the value or None.

Adding a cell, a mix, a query or a metric is a new file and an entry: no
file here names one of them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT           # the checkout the cell's files are in


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT):
    """``<root>/benchmark/<kind>/<name>.py`` as a module."""
    path = root / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    modname = f"benchmark.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if root == ROOT and modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    if root == ROOT:
        sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    return Cell(name, w["chips"], config, traffic,
                _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name), root)
