"""On the card: a small cell of each configuration's shape through the
whole run, traced; the control comes out not correct there too.  Run with
``python -m pytest portbench/tests -q -m cuda`` on a machine with a card."""

import time

import pytest

from portbench import run, spec
from portbench.tests.test_portbench_cells import BENCH, SEED, small


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", [w["name"] for w in BENCH["workloads"]])
def test_traced_cell_on_the_card(card, cell_name):
    cell, cfg, tr = small(cell_name)
    tr["trace_statements"] = 3
    res = run.run_cell(BENCH, cell, SEED, 1.0, 1, card, time.time(),
                       cfg=cfg, tr=tr, control=True)
    assert res["correct"], res["checks"]
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    assert any(v > limits[k] for k, v in res["control"].items())
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    want = {m["name"] for m in spec.cell_metrics(BENCH, cell_name,
                                                 "per_layer")}
    assert want <= set(res["metrics"]) | {"sq8_fallback_share"}
    for name, m in res["metrics"].items():
        if "_roofline" in name:
            assert 0 < m["value"] <= 105
