"""BENCHMARK.json against the benchmark's contract, and discovery of every
file it names by name."""

import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.benchmark()


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(one_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs_are_found_by_name():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = spec.config(BENCH, c["name"])
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert spec.generator(cfg).make
        ref = spec.reference(c["name"])
        assert ref.judge and ref.control_rows
        assert set(cfg["limits"]) >= {"bad_statements"} or \
            set(cfg["limits"]) == {"wrong_statements"}


def test_cells_are_found_by_name():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        tr = spec.traffic(w["traffic"])
        assert tr["clients"] >= 1 and tr["statements"]


def test_metrics_are_found_by_name():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"qps", "latency_p50_ms", "latency_p95_ms", "setup_s"} <= e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert callable(spec.metric_reader(m["name"]).read)
        layers.add(m["layer"])
    for cell in cells:
        assert spec.cell_metrics(BENCH, cell, "per_layer")
        # a per-layer metric is reported only where what it moves is
        reported = {m["name"] for m in spec.cell_metrics(BENCH, cell,
                                                         "end_to_end")}
        assert {"setup_s"} < reported
        for m in spec.cell_metrics(BENCH, cell, "per_layer"):
            assert m["moves"] in reported, (m["name"], cell)


def test_unknown_names_fail_loudly():
    with pytest.raises(KeyError):
        spec.workload(BENCH, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        spec.traffic("no_such_mix")


def test_a_new_metric_is_a_new_file(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "dispatch_ms.serve.py").write_text(
        "def read(r):\n    return 1.5\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    assert spec.metric_reader("dispatch_ms.serve").read(None) == 1.5
