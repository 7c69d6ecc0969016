"""Finds a cell's files by the names in ``BENCHMARK.json``.

- ``BENCHMARK.json`` at the root of the checkout: the cells and metrics.
- ``bench/workloads/<cell>.json``: the cell's configuration, traffic mix
  (its parameters, read by the one general generator in ``traffic.py``) and
  ``why``.
- ``bench/configs/<config>.json``: a configuration's content, codec and
  guarantees, with its source, ``reduced`` and ``assumed``.
- ``bench/metrics/<metric>.py``: one reader a metric, which declares its
  ``LAYER``, ``UNIT``, ``BETTER``, ``SOURCE`` and ``MOVES`` and reads the
  metric from a finished run with ``read(run)``, returning None when it
  finds nothing to read.

Adding a cell, a configuration or a metric is adding its files and its
entries in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict             # bench/configs/<config>.json
    workload: dict           # bench/workloads/<cell>.json
    end_to_end: list         # BENCHMARK.json entries this cell reports
    per_layer: list


def manifest(root: Path | None = None) -> dict:
    return json.loads((Path(root or ROOT) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path | None = None) -> Cell:
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    workload = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    config = json.loads(
        (BENCH / "configs" / f"{entry['config']}.json").read_text())
    if workload["config"] != entry["config"] or \
            workload["traffic"] != entry["traffic"]:
        raise ValueError(f"{name}: workload file and BENCHMARK.json disagree "
                         "on its configuration or traffic")
    e2e = [x for x in m["end_to_end"] if _reports(x, name)]
    moved = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"]
                 if _reports(x, name) and x["moves"] in moved]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                workload=workload, end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The module of ``bench/metrics/<metric>.py``, loaded by its path
    (metric names may hold dots)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload_names() -> list[str]:
    return sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))
