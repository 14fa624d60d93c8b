"""Tiny cells of each configuration's shape, run end to end on the CPU
through the harness (its look for a card skipped) against the plain
reference; the control, and the faults a cell can have, come out not
correct."""

import time

import pytest

from portbench import run, spec

BENCH = spec.benchmark()
SEED = 2 ** 33 + 12345          # past 32 signed bits, as the check's are


def small(cell_name):
    cell = spec.workload(BENCH, cell_name)
    cfg = spec.config(BENCH, cell["config"])
    tr = spec.traffic(cell["traffic"])
    if cfg["generator"] == "embeddings":
        cfg["rows"] = 70_000           # over 2^16: the SQ8 sidecar is built
        tr.update(rounds=24, trace_statements=2, sync_statements=1)
    else:
        cfg["rows"] = 150_000
        tr.update(rounds=8)
    tr["warmup_rounds"] = 1
    return cell, cfg, tr


def run_small(cell_name, seconds=1.5, **kw):
    cell, cfg, tr = small(cell_name)
    return run.run_cell(BENCH, cell, SEED, seconds, 0, "cpu", time.time(),
                        cfg=cfg, tr=tr, **kw)


@pytest.mark.parametrize("cell_name", [w["name"] for w in BENCH["workloads"]])
def test_cell_end_to_end_against_the_reference(cell_name):
    res = run_small(cell_name, control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {
        m["name"] for m in spec.cell_metrics(BENCH, cell_name, "end_to_end")}
    assert {"qps", "setup_s"} <= set(res["metrics"])
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    # the control (the reference one precision down, or with its guarantee
    # broken) fails one of the cell's numbers
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    assert any(v > limits[k] for k, v in res["control"].items()), \
        res["control"]


def test_traced_run_on_the_cpu_reports_host_metrics_only():
    res = run.run_cell(BENCH, *small("cohere768_6m.serial")[:1], SEED, 1.0,
                       1, "cpu", time.time(),
                       **dict(zip(("cfg", "tr"),
                                  small("cohere768_6m.serial")[1:])))
    assert res["correct"]
    # no card: no device metric, no counter that only the card's wrappers
    # keep; the parse span is the host's own
    assert set(res["metrics"]) == {"parse_ms"}
    assert "busy_s" not in res["device"]


def test_traced_c10_run_reads_the_client_metrics():
    cell, cfg, tr = small("cohere768_6m.c10")
    res = run.run_cell(BENCH, cell, SEED, 1.5, 1, "cpu", time.time(),
                       cfg=cfg, tr=tr)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert {"client_latency_p50_ms", "client_latency_p95_ms",
            "client_fairness"} <= set(m)
    assert 0 < m["client_latency_p50_ms"] <= m["client_latency_p95_ms"]
    assert 0 <= m["client_fairness"] <= 100


def test_string_statements_against_the_reference():
    """The hits generator's String columns and the reference's string
    statements (a cell at ClickBench's string cardinalities would use
    them), at a small cardinality: the program's rows agree."""
    cell, cfg, tr = small("clickbench_hits_100m.mix5")
    cfg["tables"]["hits"] += [["URL", "String"], ["SearchPhrase", "String"]]
    cfg["distinct"] = {"URL": 3000, "SearchPhrase": 1000}
    tr["statements"] = [
        {"name": "distinct_phrases", "weight": 1,
         "sql": "SELECT count(DISTINCT SearchPhrase) FROM hits"},
        {"name": "url_like", "weight": 1,
         "sql": "SELECT count() FROM hits WHERE URL LIKE '%google%'"}]
    res = run.run_cell(BENCH, cell, SEED, 1.0, 0, "cpu", time.time(),
                       cfg=cfg, tr=tr)
    assert res["correct"], res["checks"]
    assert set(res["by_statement"]) == {"distinct_phrases", "url_like"}


def _alter_first_row(monkeypatch):
    from myscaledb_tpu_torch.core import table as table_mod
    real = table_mod.Table.to_rows

    def altered(self):
        rows = real(self)
        if rows:
            first = list(rows[0])
            first[-1] = first[-1] + 1 if isinstance(first[-1], int) \
                else first[-1] * 1.001 if isinstance(first[-1], float) \
                else first[-1]
            first[0] = first[0] + 1 if isinstance(first[0], int) \
                else first[0]
            rows[0] = tuple(first)
        return rows
    monkeypatch.setattr(table_mod.Table, "to_rows", altered)


def _half_the_rows(monkeypatch):
    from myscaledb_tpu_torch import session as session_mod
    real = session_mod.Session.get_table

    def half(self, name):
        t = real(self, name)
        return t.head(t.n_rows // 2)
    monkeypatch.setattr(session_mod.Session, "get_table", half)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
@pytest.mark.parametrize("cell_name", ["cohere768_6m.serial",
                                       "clickbench_hits_100m.mix5"])
def test_a_broken_timed_path_is_not_correct(cell_name, fault, monkeypatch):
    {"answer_altered": _alter_first_row,
     "half_left_out": _half_the_rows}[fault](monkeypatch)
    res = run_small(cell_name, seconds=1.0)
    assert not res["correct"]
    assert res["failed"] > 0
