"""The port's load-benchmark tool (clickhouse-benchmark analog), after
tests/test_benchmark_tool.py: in-process and over HTTP, on a CPU session;
``main`` in both modes prints the summary's JSON."""

import json
import threading

import numpy as np

from myscaledb_tpu_torch import connect
from myscaledb_tpu_torch.runtime import benchmark
from myscaledb_tpu_torch.runtime.server import make_server


def _summary_ok(out):
    assert out["queries"] > 0 and out["errors"] == 0 and out["qps"] > 0
    lat = out["latency_ms"]
    assert 0 < lat["p50"] <= lat["p90"] <= lat["p99"] <= lat["p999"]


def test_run_local():
    s = connect(device="cpu")
    s.create_table("t", {"x": np.arange(1000, dtype=np.int64)})
    out = benchmark.run_local(["SELECT sum(x) FROM t",
                               "SELECT count() FROM t WHERE x < 100"],
                              duration=0.5, session=s)
    _summary_ok(out)
    assert out["rows_per_s"] > 0


def test_run_http_and_main(capsys):
    s = connect(device="cpu")
    s.create_table("t", {"x": np.arange(100, dtype=np.int64)})
    srv = make_server(s, port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{port}/"
        out = benchmark.run_http(["SELECT count() FROM t",
                                  "SELECT x FROM t ORDER BY x LIMIT 3"],
                                 duration=0.5, url=url, concurrency=2)
        _summary_ok(out)
        assert out["rows_per_s"] > 0
        bad = benchmark.run_http(["SELECT 1 FROM missing"], duration=0.2,
                                 url=url)
        assert bad["queries"] == 0 and bad["errors"] > 0
        assert benchmark.main(["--url", url, "-q", "SELECT 1", "-d",
                               "0.3"]) == 0
        _summary_ok(json.loads(capsys.readouterr().out))
    finally:
        srv.shutdown()
        srv.server_close()
    assert benchmark.main(["--device", "cpu", "-q", "SELECT 1", "-d",
                           "0.3"]) == 0
    _summary_ok(json.loads(capsys.readouterr().out))


def test_percentile_and_summarize():
    st = benchmark.Stats()
    for ms in range(1, 101):
        st.add(ms / 1e3, 2)
    st.add(0.0, 0, error=True)
    out = benchmark.summarize(st, 2.0)
    assert out["queries"] == 100 and out["errors"] == 1
    assert out["qps"] == 50.0 and out["rows_per_s"] == 100.0
    assert out["latency_ms"]["p50"] == 51.0
    assert out["latency_ms"]["p99"] == 100.0
