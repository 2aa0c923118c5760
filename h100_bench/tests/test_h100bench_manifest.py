"""BENCHMARK.json against the benchmark's contract: names and units
legal, every configuration, traffic and metric file found by name."""
import json
import os

import pytest

from h100bench_util import BENCH_DIR, ROOT
from harness import manifest

BENCH = manifest.load()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines_are_legal():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert manifest.NAME_RE.fullmatch(n), n
    for m in METRICS:
        assert manifest.UNIT_RE.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    lines = ([c["source"] for c in BENCH["configs"]]
             + [c["why"] for c in BENCH["configs"]]
             + [w["why"] for w in BENCH["workloads"]]
             + [m["layer"] for m in BENCH["per_layer"]])
    for s in lines:
        assert 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s, s
    for section in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[section]]
        assert len(ns) == len(set(ns))
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:   # the moved metric is reported there
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_and_reports(name):
    cell = manifest.cell(BENCH, name)
    assert cell.chips == 1
    assert cell.traffic["driver"] in ("decode", "encode")
    e2e = [m["name"] for m in manifest.metrics_of(BENCH, name, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_of(BENCH, name, "per_layer")
    assert cell.config["limits"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(manifest.load_reader(metric).read)


def test_configurations_are_their_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("h100_bench/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        for rel in [cfg["codec"]["preset"]] + [
                v for k, v in cfg.get("input", {}).items()
                if k in ("stream", "warmup_stream")]:
            assert os.path.exists(os.path.join(BENCH_DIR, rel)), rel


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
