"""The 23 vector goldens through the port: each ``tests/goldens/vector``
case replays through ``myscaledb_tpu_torch.testing.run_golden_text`` on a
CPU session and must come out byte-identical to its ``.reference`` — the
same files the JAX package passes in tests/test_goldens.py.  No tolerance:
golden 00014 pins f32 cosine distances at d = 3 to their last digit."""

import os

import pytest
import torch

from myscaledb_tpu_torch import connect
from myscaledb_tpu_torch.testing import run_golden_text

torch.set_num_threads(1)

VECTOR = os.path.join(os.path.dirname(__file__), "goldens", "vector")
CASES = sorted(f[:-4] for f in os.listdir(VECTOR) if f.endswith(".sql"))


def test_all_vector_goldens_are_collected():
    assert len(CASES) == 23


@pytest.mark.parametrize("name", CASES)
def test_vector_golden(name):
    sql_text = open(os.path.join(VECTOR, name + ".sql")).read()
    expected = open(os.path.join(VECTOR, name + ".reference")
                    ).read().rstrip("\n").split("\n")
    if expected == [""]:
        expected = []
    got = run_golden_text(connect(device="cpu"), sql_text)
    assert got == expected
