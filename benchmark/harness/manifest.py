"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (configs/<name>.json) and a traffic mix
(traffic/<name>.json), which names its loop (loops/<name>.py, whose
`run(cell, seed, seconds, trace, device, t_start)` returns the run's
harness.loops.Outcome); a per-layer metric is layer_metrics/<name>.py,
whose `read(ctx)` returns its value or None. Adding a cell, a mix, a
loop or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    man = load_manifest(root)
    w = [c for c in man["workloads"] if c["name"] == name]
    if not w:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = w[0]
    conf = [c for c in man["configs"] if c["name"] == w["config"]][0]
    config = _load_json(os.path.join(root, conf["file"]))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
                config=config, traffic=traffic,
                end_to_end=[m for m in man["end_to_end"] if metric_applies(m, name)],
                per_layer=[m for m in man["per_layer"] if metric_applies(m, name)])


def _module(folder: str, name: str):
    path = os.path.join(BENCH_DIR, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise SystemExit(f"no {folder}/{name}.py in the benchmark")
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str):
    """layer_metrics/<name>.py's read function."""
    return _module("layer_metrics", metric_name).read


def loop(name: str):
    """loops/<name>.py, the loop a traffic file names."""
    return _module("loops", name)
