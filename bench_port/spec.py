"""Finds a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics.  Everything that belongs to one of them
sits in a file of its own under this folder, found by its name:

* ``configs/<config>.json``: the configuration (its ``file`` entry in
  ``BENCHMARK.json``), the sizes the port is built with;
* ``traffic/<mix>.json``: a traffic mix's parameters, with the name of
  the generator that reads them (``"generator"``);
* ``generators/<generator>.py``: a generator, a module with a class
  ``Stream`` that makes a mix's inputs and drives one unit of its work
  (``engine.py`` has the timed loop they share);
* ``workloads/<cell>.json``: the cell's configuration and mix (checked
  against ``BENCHMARK.json``), its overrides of the mix's parameters and
  the limits of its correctness check;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a module
  with ``read(ctx) -> float | None``.

A later change adds a cell, a mix, a generator, a configuration or a
metric by adding files and entries; nothing here names one.  ``home``,
where the per-name folders sit, is this folder unless a caller gives
another (the tests give a temporary one).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: str
    params: dict            # the mix's parameters, with the cell's overrides
    limits: dict            # correctness numbers -> their limits
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list
    home: Path = HERE       # where workloads/, traffic/, metrics/ ... sit


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT,
              home: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default: the checkout's
    ``BENCHMARK.json``); configuration files are found from ``root``,
    the per-name folders under ``home``."""
    bench = load_benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = _read_json(root / conf["file"])
    cell = _read_json(home / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{cell[key]!r}, BENCHMARK.json {entry[key]!r}")
    params = _read_json(home / "traffic" / f"{entry['traffic']}.json")
    params.update(cell.get("params", {}))

    def here(m):
        return name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if here(m) is not False]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if here(m) or (here(m) is None and m["moves"] in moved)]
    return Cell(name=name, chips=int(entry["chips"]), config=cfg,
                traffic=entry["traffic"], params=params,
                limits=dict(cell["limits"]), end_to_end=e2e, per_layer=layer,
                home=home)


_modules = {}


def load_module(path: Path, prefix: str):
    """The module at ``path``, loaded once."""
    if path not in _modules:
        spec = importlib.util.spec_from_file_location(
            f"{prefix}_{path.stem.replace('.', '_')}_{len(_modules)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def stream_class(cell: Cell):
    """``Stream`` of ``generators/<generator>.py``, the generator that the
    cell's mix names."""
    return load_module(cell.home / "generators"
                   / f"{cell.params['generator']}.py",
                   "bench_port_generator").Stream


def metric_reader(name: str, home: Path = HERE):
    """``read`` of ``metrics/<name>.py``."""
    return load_module(home / "metrics" / f"{name}.py",
                   "bench_port_metric").read
