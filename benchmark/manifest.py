"""``BENCHMARK.json`` and the data files it names, found by name.

- a configuration: the file its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``;
- a problem: ``problems/<problem>.py``, named by the traffic's
  ``"problem"``: its mesh, the program's problem object, what the seed
  draws and the plain reference's numbers;
- a cell: its entry in ``workloads`` and ``workloads/<cell>.json`` (the
  limits of the numbers that decide ``correct``);
- a per-layer metric: ``metrics/<name>.py``, a reader with ``read(rec)``.

A cell, problem or metric that the manifest names but whose file is
missing is refused when the cell is loaded, and so is a configuration or
traffic value that the harness or the problem does not implement
(``cell.check_config``, the problem's ``check``).
"""

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

from . import cell as C

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

__all__ = ["CellSpec", "load_manifest", "cell_spec", "load_reader", "load_problem",
           "cell_metrics"]


@dataclass
class CellSpec:
    """Everything one cell's run reads."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    problem: object = None  # the module of problems/<traffic["problem"]>.py
    end_to_end: list = field(default_factory=list)  # manifest entries of this cell
    per_layer: list = field(default_factory=list)
    readers: dict = field(default_factory=dict)  # per-layer name -> module


def load_manifest(path=MANIFEST):
    with open(path) as f:
        return json.load(f)


def _read_json(path, what):
    if not path.is_file():
        raise FileNotFoundError(f"{what} has no file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def _load_module(folder, name, what):
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{what} {name!r} has no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name):
    """The reader module of per-layer metric ``name``."""
    return _load_module("metrics", name, "per-layer metric")


def load_problem(name):
    """The module of problem ``name``."""
    return _load_module("problems", name, "problem")


def cell_metrics(manifest, cell, kind):
    """Entries of ``manifest[kind]`` that cell ``cell`` reports: those
    without a ``workloads`` key, and those whose list names the cell."""
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def cell_spec(cell, manifest=None):
    """The :class:`CellSpec` of cell ``cell``."""
    manifest = load_manifest() if manifest is None else manifest
    entry = next((w for w in manifest["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next((c for c in manifest["configs"] if c["name"] == entry["config"]), None)
    if conf is None:
        raise KeyError(f"workload {cell!r} names configuration {entry['config']!r}, "
                       f"which BENCHMARK.json does not list")
    per_layer = cell_metrics(manifest, cell, "per_layer")
    config = _read_json(ROOT / conf["file"], f"configuration {conf['name']!r}")
    traffic = _read_json(HERE / "traffic" / f"{entry['traffic']}.json",
                         f"traffic {entry['traffic']!r}")
    problem = load_problem(traffic.get("problem"))
    C.check_config(config)
    problem.check(config, traffic)
    return CellSpec(
        name=cell,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        limits=_read_json(HERE / "workloads" / f"{cell}.json", f"workload {cell!r}")["limits"],
        problem=problem,
        end_to_end=cell_metrics(manifest, cell, "end_to_end"),
        per_layer=per_layer,
        readers={m["name"]: load_reader(m["name"]) for m in per_layer},
    )
