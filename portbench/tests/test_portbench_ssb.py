"""A tiny ``ssb_sf100``-shaped cell end to end on the CPU through the
harness against the plain reference; the control (lo_revenue summed in
float32) and a planted wrong sum come out not correct."""

import time

import pytest

from portbench import run, spec

BENCH = spec.benchmark()
SEED = 2 ** 33 + 777
CELL = "ssb_sf100.serial"


def small():
    cell = spec.workload(BENCH, CELL)
    cfg = spec.config(BENCH, cell["config"])
    cfg["rows"] = 40_000
    tr = spec.traffic(cell["traffic"])
    tr.update(rounds=3, warmup_rounds=1, trace_statements=13,
              sync_statements=13)
    return cell, cfg, tr


def test_ssb_cell_against_the_reference():
    cell, cfg, tr = small()
    res = run.run_cell(BENCH, cell, SEED, 3.0, 0, "cpu", time.time(),
                       cfg=cfg, tr=tr)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert {"qps", "latency_p50_ms", "setup_s"} <= set(res["metrics"])


def only(tr, names):
    tr["statements"] = [s for s in tr["statements"] if s["name"] in names]
    return tr


def test_the_control_is_not_correct():
    """lo_revenue summed in float32 (the statements that sum it)."""
    cell, cfg, tr = small()
    res = run.run_cell(BENCH, cell, SEED, 1.0, 0, "cpu", time.time(),
                       cfg=cfg, tr=only(tr, {"q2_1", "q3_1", "q4_1"}),
                       control=True)
    assert res["correct"], res["checks"]
    assert res["control"]["wrong_statements"] > 0


def test_traced_ssb_run_reads_the_join_metrics():
    cell, cfg, tr = small()
    res = run.run_cell(BENCH, cell, SEED, 1.0, 1, "cpu", time.time(),
                       cfg=cfg, tr=tr)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["join_ms"] > 0 and m["join_carried_bytes_per_query"] > 0


@pytest.mark.parametrize("statement", ["q1_1", "q4_2"])
def test_a_planted_wrong_sum_is_not_correct(monkeypatch, statement):
    """One statement's sum off by one: the run is not correct."""
    from myscaledb_tpu_torch import session as session_mod
    real = session_mod.Session.sql_as
    cell, cfg, tr = small()
    tr = only(tr, {statement})
    target = tr["statements"][0]["sql"]

    def planted(self, user, sql):
        t = real(self, user, sql)
        if sql != target:
            return t
        rows = t.to_rows()

        class Off:
            def to_rows(self):
                return [r[:-1] + (r[-1] + 1,) for r in rows]
        return Off()
    monkeypatch.setattr(session_mod.Session, "sql_as", planted)
    res = run.run_cell(BENCH, cell, SEED, 1.0, 0, "cpu", time.time(),
                       cfg=cfg, tr=tr)
    assert not res["correct"]
    assert res["checks"]["wrong_statements"]["value"] > 0
