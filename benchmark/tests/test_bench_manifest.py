"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the files each entry names, the chip budget."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert man["command"][:2] == ["python3", "benchmark/run.py"] and len(man["command"]) <= 32
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in man["paths"])
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(man, section):
    names = [e["name"] for e in man[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_metrics_units_and_keys(man):
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and "\t" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert [m["bound"] for m in man["end_to_end"] if m["name"] == "setup_s"] == [0.25]


def test_every_cell_reports_what_it_must(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        mine = [m for m in man["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layers = [m for m in man["per_layer"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert layers
        for m in layers:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w["name"] in moved["workloads"]


def test_per_layer_metric_files(man):
    for m in man["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "layer_metrics", f"{m['name']}.py"))


def test_cells_configs_and_traffic(man):
    configs = {c["name"]: c for c in man["configs"]}
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= max(1, len(man["workloads"]) // 4)
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in configs.values()}) == len(configs)


def test_a_full_check_fits_the_budget(man):
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (man["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_every_mix_names_a_loop_and_an_unknown_one_is_refused(man):
    from benchmark.harness import manifest

    for mix in {w["traffic"] for w in man["workloads"]}:
        cell = manifest.find_cell([w["name"] for w in man["workloads"] if w["traffic"] == mix][0])
        assert callable(manifest.loop(cell.traffic["loop"]).run)
    with pytest.raises(SystemExit):
        manifest.loop("no_such_loop")


def test_the_result_line_waits_for_the_import_check(capsys):
    import sys
    import types

    from benchmark import run

    result, rows = {"correct": True}, [["loss_gap", 1e-6, 8e-4]]
    sys.modules["jax"] = types.ModuleType("jax")  # as if a reader had loaded it
    try:
        assert run.finish(result, rows) == 3
        out, err = capsys.readouterr()
        assert out == "" and "jax" in err
    finally:
        del sys.modules["jax"]
    assert run.finish(result, rows) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result and "check loss_gap" in err
