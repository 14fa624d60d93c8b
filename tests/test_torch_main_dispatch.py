"""``python -m myscaledb_tpu_torch <tool>``: the port of the JAX package's
dispatcher (tests/test_main_dispatch.py) — format, local over parts the
port's TableStore wrote, the usage exit code 2 — with the port's device
rule: every tool that opens a session takes the CUDA card unless it is
given ``--device cpu``, and with no card and no ``--device`` it exits 1
with connect()'s error instead of running on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from myscaledb_tpu.__main__ import main as j_main
from myscaledb_tpu_torch.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_format_tool_equals_the_jax_tool(capsys):
    words = ["SELECT a, sum(b) FROM t WHERE a > 1", "GROUP BY a"]
    assert j_main(["format"] + words) == 0
    want = capsys.readouterr().out
    assert main(["format", "--device", "cpu"] + words) == 0
    out = capsys.readouterr().out
    assert out == want
    assert out.splitlines()[0] == "SELECT a, sum(b)"


def test_local_tool(capsys):
    assert main(["local", "--device", "cpu", "-q", "SELECT 1 + 2"]) == 0
    assert capsys.readouterr().out.strip() == "3"


def test_local_tool_with_data_dir(tmp_path, capsys):
    from myscaledb_tpu_torch.core.table import Table
    from myscaledb_tpu_torch.storage.table_store import TableStore
    t = Table.from_dict({"v": np.arange(10, dtype=np.int64),
                         "s": np.array([f"w{i % 3}" for i in range(10)])},
                        device="cpu")
    TableStore(str(tmp_path / "nums"), device="cpu").insert(t)
    assert main(["local", "--device", "cpu", "--data-dir", str(tmp_path),
                 "-q", "SELECT sum(v) FROM nums",
                 "-q", "SELECT s, count() FROM nums GROUP BY s ORDER BY s"]
                ) == 0
    assert capsys.readouterr().out.split("\n")[:4] == \
        ["45", "w0\t4", "w1\t3", "w2\t3"]


def test_usage_on_no_args_or_unknown_tool(capsys):
    assert main([]) == 2
    assert "server" in capsys.readouterr().err
    assert main(["nonsense"]) == 2


@pytest.mark.parametrize("argv", [
    ["local", "-q", "SELECT 1"], ["format", "SELECT 1"],
    ["benchmark", "-q", "SELECT 1", "-d", "0.1"],
    ["server", "--port", "0"]])
def test_no_card_and_no_device_fails(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and 'device="cpu"' in err


def test_python_dash_m_entry_point():
    r = subprocess.run([sys.executable, "-m", "myscaledb_tpu_torch", "local",
                        "--device", "cpu", "-q", "SELECT 40 + 2"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "42"
