"""What a run reads: the cell from ``BENCHMARK.json``, its configuration
file, its traffic file, its limits, and the reader of each per-layer
metric, each found by its name.

- a configuration: ``BENCHMARK.json``'s ``configs[].file`` (under
  ``port_bench/configs/``);
- a traffic mix: ``port_bench/traffic/<traffic>.json``, whose ``kind``
  names the driver in ``port_bench/kinds/<kind>.py``;
- a cell's limits on the numbers that decide ``correct``:
  ``port_bench/limits/<cell>.json``;
- a per-layer metric: ``port_bench/metrics/<metric>.py``, whose
  ``read(trace)`` gives the number or None.

A later cell, traffic mix, configuration or metric is added as files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file
    traffic: dict          # the traffic file
    limits: dict           # the cell's limits
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)
    pkg: Path = PKG           # the folder that holds the cell's files


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``bench_path``, its files read from the
    ``port_bench`` folder beside it."""
    bench = _json(bench_path)
    pkg = Path(bench_path).parent / PKG.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = _json(bench_path.parent / confs[w["config"]]["file"])
    traffic = _json(pkg / "traffic" / f"{w['traffic']}.json")
    limits = _json(pkg / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], pkg)


def kind(traffic: dict):
    """The driver module of a traffic mix's kind."""
    return importlib.import_module(f"port_bench.kinds.{traffic['kind']}")


def metric_reader(name: str, pkg: Path = PKG):
    """``read`` of ``port_bench/metrics/<name>.py`` (a name may hold dots,
    so the file is loaded by its path)."""
    path = Path(pkg) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
