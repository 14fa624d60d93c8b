"""The port's CUDA kernels on the card, against their plain PyTorch
versions, at small and ragged shapes that chip_smoke.py does not cover.

Every test needs a CUDA card and skips without one.  On the card (where
JAX is not installed, so the suite's conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from myscaledb_tpu_torch.ops.kernels import distance as K2
from myscaledb_tpu_torch.ops.kernels import distance_q as K1
from myscaledb_tpu_torch.ops.kernels.distance import query_aux
from myscaledb_tpu_torch.ops.vector import build_sq8

pytestmark = pytest.mark.cuda
METRICS = ["L2", "Cosine", "IP"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the H100 (see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n,d,nq", [(1, 32, 1), (130, 32, 9), (4133, 256, 17),
                                    (20000, 128, 128)])
@pytest.mark.parametrize("metric", METRICS)
def test_segmin_f32_kernel_matches_plain(cuda, n, d, nq, metric):
    x = torch.randn(n, d, device="cuda", generator=cuda)
    x[n // 2] = 0.0                                   # zero-norm row
    q = torch.randn(nq, d, device="cuda", generator=cuda)
    sqn = (x * x).sum(1)
    qa = query_aux(q, metric)
    mask = (torch.rand(n, device="cuda", generator=cuda) < 0.5).float()
    before = K2.segmin_f32.launches
    for m in (mask, None):
        got = K2.segmin_f32(x, q, sqn, qa, m, metric)
        want = K2.segmin_f32_plain(x, q, sqn, qa, m, metric)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (nq, -(-n // 128))
        assert torch.equal(torch.isposinf(got), torch.isposinf(want))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert K2.segmin_f32.launches == before + 2


@pytest.mark.parametrize("n,nq", [(100, 1), (16384 + 5, 17), (20000, 128)])
@pytest.mark.parametrize("metric", METRICS)
def test_segmin_sq8_kernel_matches_plain(cuda, n, nq, metric):
    d = 256
    x = torch.randn(n, d, device="cuda", generator=cuda)
    x[0] = 0.0
    x8, sides = build_sq8(x)
    q = torch.randn(nq, d, device="cuda", generator=cuda)
    mv = sides[3:4].clone()
    mv[0, :n] *= (torch.rand(n, device="cuda", generator=cuda) < 0.5).float()
    before = K1.segmin_sq8.launches
    got = K1.segmin_sq8(x8, sides, q, mv, metric)
    want = K1.segmin_sq8_plain(x8, sides, q, mv, metric)
    torch.cuda.synchronize()
    assert K1.segmin_sq8.launches == before + 1
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    x = torch.randn(256, 48, device="cuda", generator=cuda)   # d % 32 != 0
    q = torch.randn(1, 48, device="cuda", generator=cuda)
    with pytest.raises(ValueError, match="d % 32"):
        K2.segmin_f32(x, q, (x * x).sum(1), query_aux(q, "L2"), None, "L2")
    with pytest.raises(ValueError, match="is on"):
        K2.segmin_f32(x, q.cpu(), (x * x).sum(1), query_aux(q, "L2"), None,
                      "L2")


def test_sql_main_path_launches_k1_on_card(cuda):
    import myscaledb_tpu_torch as P
    rng = np.random.default_rng(3)
    n, d = 1 << 16, 128
    s = P.connect()
    s.create_table("t", {"id": np.arange(n, dtype=np.int64),
                         "price": rng.integers(0, 100, n).astype(np.int32),
                         "emb": rng.standard_normal((n, d), dtype=np.float32)})
    q = rng.standard_normal(d, dtype=np.float32)
    vec = "[" + ",".join(repr(float(v)) for v in q) + "]"
    before = K1.segmin_sq8.launches
    rows = s.sql(f"SELECT id, distance(emb, {vec}) AS d FROM t "
                 "WHERE price < 50 ORDER BY d LIMIT 10").to_rows()
    assert K1.segmin_sq8.launches == before + 1
    x = s.tables["t"]["emb"].data
    price = s.tables["t"]["price"].data
    dist = ((x - torch.as_tensor(q, device="cuda")) ** 2).sum(1)
    dist = torch.where(price < 50, dist, torch.inf)
    want = torch.sort(dist, stable=True).indices[:10].cpu().tolist()
    assert [r[0] for r in rows] == want
