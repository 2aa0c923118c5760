"""BENCHMARK.json and the files it names, each found by its name.

- a configuration: the `file` its entry names (`configs/<config>.json`);
- a traffic mix: `traffic/<traffic>.json`;
- a metric, end-to-end or per-layer: its reader `metrics/<metric>.py`.
Paths inside a configuration or traffic file are relative to the
benchmark's folder.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclass
class Cell:
    """One entry of `workloads`, with its configuration and traffic
    loaded."""
    name: str
    chips: int
    config: dict
    traffic: dict

    def path(self, rel: str) -> str:
        """A data path of the configuration or traffic file."""
        return os.path.join(BENCH_DIR, rel)


def load() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config_path(manifest: dict, name: str) -> str:
    entry = _by_name(manifest["configs"], name, "configuration")
    return os.path.join(ROOT, entry["file"])


def traffic_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", name + ".json")


def reader_path(metric: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", metric + ".py")


def cell(manifest: dict, name: str) -> Cell:
    w = _by_name(manifest["workloads"], name, "workload")
    with open(config_path(manifest, w["config"])) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"])) as f:
        traffic = json.load(f)
    return Cell(w["name"], int(w["chips"]), config, traffic)


def metrics_of(manifest: dict, cell_name: str, section: str) -> list:
    """The entries of `end_to_end` or `per_layer` that the cell reports:
    those without a `workloads` key, and those that list it."""
    return [m for m in manifest[section]
            if cell_name in m.get("workloads", [cell_name])]


def load_reader(metric: str):
    """The reader module of a metric, loaded from its file (a metric's
    name may hold dots, so it is no importable module name)."""
    path = reader_path(metric)
    mod_name = "h100_bench_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")
