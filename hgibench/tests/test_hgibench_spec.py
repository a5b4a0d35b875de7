"""``BENCHMARK.json`` and the files it names: every cell, configuration,
mix, driver, entry and metric is found by its name, and the file keeps
to the limits the benchmark's format sets.  The serving cells kept for
later (``serving_cells.json``) are held to the same, added as a later
PR would add them."""

import json
import os
import re

import pytest

from hgibench import spec

with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
with open(os.path.join(spec.PKG, "tests", "serving_cells.json")) as f:
    ALL = spec.merge(BENCH, json.load(f))
CELLS = [w["name"] for w in ALL["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:3] == ["python3", "-m", "hgibench.run"]
    assert BENCH["paths"] == ["hgibench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("b", [BENCH, ALL], ids=["file", "with-serving"])
def test_names_units_and_lines(b):
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[key]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for text in [w["why"] for w in b["workloads"]] + [c["source"] for c in b["configs"]] + \
            [m["layer"] for m in b["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("b", [BENCH, ALL], ids=["file", "with-serving"])
def test_configs_are_files_under_paths_used_by_some_cell(b):
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["name"] in used and c["file"].startswith("hgibench/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg and "guarantees" in cfg
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_pieces_by_name(cell):
    c = spec.load_cell(cell, ALL)
    assert c.chips == 1
    for fn in ("setup", "request", "timers", "counters", "finish", "release", "check", "work",
               "control") + (("account",) if "sample" in c.mix else ()):
        assert callable(getattr(c.entry, fn))
    assert callable(c.driver.run)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_metric(m["name"]).read)
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("b", [BENCH, ALL], ids=["file", "with-serving"])
def test_every_metric_has_a_reader_and_each_layer_one_name(b):
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(spec.PKG, "metrics", m["name"] + ".py"))
    for m in b["per_layer"]:
        mod = spec.load_metric(m["name"])
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and hasattr(mod, "KERNELS") and hasattr(mod, "COUNTER")
    assert "mfu" not in json.dumps(b)


def test_mixes_name_a_driver_and_an_entry_that_exist():
    for name in os.listdir(os.path.join(spec.PKG, "mixes")):
        with open(os.path.join(spec.PKG, "mixes", name)) as f:
            mix = json.load(f)
        assert os.path.isfile(os.path.join(spec.PKG, "drivers", mix["driver"] + ".py"))
        assert os.path.isfile(os.path.join(spec.PKG, "entries", mix["entry"] + ".py"))
        assert "why" in mix and "trace" in mix
