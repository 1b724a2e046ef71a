"""Finds a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, and the files of ``mpcbench/``."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    config: Dict          # configs/<config>.json
    traffic: Dict         # traffic/<traffic>.json
    chips: int
    end_to_end: List[Dict]  # the entries of BENCHMARK.json this cell reports
    per_layer: List[Dict]
    limits: Dict[str, float]  # limits/<cell>.json


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: str = REPO) -> Dict:
    return read_json(os.path.join(repo, "BENCHMARK.json"))


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; ``KeyError``
    for a cell the file does not hold."""
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(it has {sorted(entries)})")
    w = entries[name]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _applies(m, name)]
    return Cell(name=name,
                config=data("configs", w["config"]),
                traffic=data("traffic", w["traffic"]),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                limits=data("limits", name))


def data(kind: str, name: str) -> Dict:
    """``mpcbench/<kind>/<name>.json``."""
    return read_json(os.path.join(BENCH_DIR, kind, f"{name}.json"))


def module(kind: str, name: str):
    """The module ``mpcbench/<kind>/<name>.py``, loaded from its path (the
    names hold dots); for a metric, a name with a family suffix (``.serve``)
    falls back to the file without it."""
    candidates = [name]
    if "." in name:
        candidates.append(name.rsplit(".", 1)[0])
    for n in candidates:
        path = os.path.join(BENCH_DIR, kind, f"{n}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"mpcbench_{kind}_{n.replace('.', '_').replace('-', '_')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no {kind}/{name}.py under {BENCH_DIR}")
