"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<config>.json`` beside its plain reference
``reference/<config>.py``; its ``generator`` key names
``datagen/<generator>.py``.  A traffic mix is ``traffic/<traffic>.json``.
A per-layer metric is ``metrics/<metric>.py``.  Adding any of them adds
files and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(REPO / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold ``.`` and ``-``)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path.relative_to(REPO)} is missing")
    mod_name = f"portbench.{kind}.{name.replace('.', '__').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(cfg: dict):
    return load_module("datagen", cfg["generator"])


def reference(config_name: str):
    return load_module("reference", config_name)


def metric_reader(name: str):
    return load_module("metrics", name)


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without a ``workloads`` key, and those that list
    the cell."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
