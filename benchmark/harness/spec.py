"""A cell of ``BENCHMARK.json`` and the files that define it, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration is the JSON file that ``configs`` names; its
``call`` names the module under ``benchmark/calls/`` that makes one user
call of the program, and the plain reference of the same name under
``benchmark/reference/``. The traffic mix is ``benchmark/traffic/<name>
.json``, read by the one generator in ``traffic.py``. Each metric is a
reader ``benchmark/metrics/<name>.py`` with ``read(run)``. Adding a cell,
a configuration, a traffic mix or a metric is adding a file and an
entry; nothing here changes.
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = "benchmark"


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple   # BENCHMARK.json's metric entries this cell reports
    per_layer: tuple
    root: Path


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, tag):
    """The Python file ``path`` as a module (a name may hold dots)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no {tag} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"_bench_{tag}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _listed(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name, root=ROOT):
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``."""
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(root / BENCH / "traffic" / f"{w['traffic']}.json")
    e2e = tuple(m for m in bench["end_to_end"] if _listed(m, name))
    reported = {m["name"] for m in e2e}
    layer = tuple(m for m in bench["per_layer"]
                  if (name in m["workloads"] if "workloads" in m
                      else m["moves"] in reported))
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer, root)


def call_module(cell):
    return load_module(
        cell.root / BENCH / "calls" / f"{cell.config['call']}.py", "call")


def reference_module(cell):
    return load_module(
        cell.root / BENCH / "reference" / f"{cell.config['call']}.py",
        "reference")


def metric_reader(cell, name):
    return load_module(cell.root / BENCH / "metrics" / f"{name}.py",
                       "metric")
