"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

A configuration is the JSON file its entry names; a traffic mix is
``mixes/<traffic>.json``; the mix names its driver
(``drivers/<driver>.py``) and its entry, the call under test
(``entries/<entry>.py``); a metric is ``metrics/<metric name>.py``.  A
new cell, mix or metric is new files and new entries in
``BENCHMARK.json``: nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["ROOT", "PKG", "Cell", "load_bench", "merge", "load_cell", "load_metric"]

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    driver: object
    entry: object
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench() -> dict:
    """``BENCHMARK.json``."""
    return _read_json(os.path.join(ROOT, "BENCHMARK.json"))


def merge(bench: dict, more: dict) -> dict:
    """``bench`` with the entries of ``more`` added, as a later PR adds
    cells: a metric already named takes the new cells into its
    ``workloads``."""
    out = {k: (list(v) if isinstance(v, list) else v) for k, v in bench.items()}
    for key, entries in more.items():
        named = {e["name"]: i for i, e in enumerate(out[key])}
        for e in entries:
            if e["name"] in named:
                old = out[key][named[e["name"]]]
                out[key][named[e["name"]]] = dict(old, workloads=old["workloads"] + e["workloads"])
            else:
                out[key].append(e)
    return out


def _reports(metric: dict, cell: str, moved: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in moved


def load_cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix,
    driver, entry and the metrics it reports."""
    bench = bench or load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    mix = _read_json(os.path.join(PKG, "mixes", cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, moved)]
    return Cell(
        name=name, chips=int(cell["chips"]), config=config, mix=mix,
        driver=importlib.import_module(f"hgibench.drivers.{mix['driver']}"),
        entry=importlib.import_module(f"hgibench.entries.{mix['entry']}"),
        end_to_end=e2e, per_layer=per_layer,
    )


_METRICS: Dict[str, object] = {}


def load_metric(name: str):
    """The reader module ``metrics/<name>.py`` (names may hold dots)."""
    if name not in _METRICS:
        path = os.path.join(PKG, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(f"hgibench.metrics.{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _METRICS[name] = module
    return _METRICS[name]
