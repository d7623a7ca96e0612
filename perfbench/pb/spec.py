"""A cell as ``BENCHMARK.json`` names it, with the files it is built from.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by name:

  * a configuration: the ``file`` its entry in ``configs`` gives;
  * a traffic mix: ``perfbench/workloads/<traffic>.json``;
  * a per-layer metric: ``perfbench/metrics/<name>.py`` (a ``read(trace)``
    function returning a number or None);
  * a model family: ``perfbench/families/<family>.py`` (its weights, the
    program's gradient function, its operation counts), and its plain
    reference ``perfbench/reference/<family>.py``.

This module reads JSON only, so the entry point can set the process's
environment from a configuration before PyTorch is imported.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]   # perfbench/
ROOT = HERE.parent                           # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list


def checked_rounds(traffic: dict) -> int:
    """The rounds ``correct`` compares: round 1 alone, then one chunk."""
    return 1 + traffic["chunk"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def traffic_file(name: str) -> Path:
    return HERE / "workloads" / f"{name}.json"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def make_cell(bench: dict, name: str, chips: int, config_name: str,
              config_file: Path, traffic_name: str) -> Cell:
    """A cell from its files, reporting the metrics of ``bench`` that
    apply to ``name``."""
    return Cell(name=name, chips=chips, config_name=config_name,
                config=json.loads(config_file.read_text()),
                traffic_name=traffic_name,
                traffic=json.loads(traffic_file(traffic_name).read_text()),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic read, and the metrics it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return make_cell(bench, name, w["chips"], w["config"],
                     root / configs[w["config"]]["file"], w["traffic"])
