"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) is resolved by name: its configuration
from ``configs/<config>.json``, its traffic mix from
``traffic/<traffic>.json``, and each metric it reports from the reader
``metrics/<metric>.py``. A metric belongs to a cell when its
``workloads`` lists the cell, or, with no ``workloads``, when the cell
reports the end-to-end metric it ``moves``; an end-to-end metric without
``workloads`` belongs to every cell.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _mine(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``), with its
    configuration, traffic and metric entries; raises KeyError for a name
    the benchmark does not have."""
    bench = benchmark() if bench is None else bench
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _mine(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name, entry["chips"], config, traffic, e2e, per_layer)


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
