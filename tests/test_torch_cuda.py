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
from myscaledb_tpu_torch.ops.kernels import group_agg as K3
from myscaledb_tpu_torch.ops.kernels.distance import query_aux
from myscaledb_tpu_torch.ops.aggregate_matmul import matmul_group_aggregate
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


@pytest.mark.parametrize("n", [1, 31, 1000, 4133, 70_001])
@pytest.mark.parametrize("G", [1, 2, 17, 256])
def test_group_agg_kernel_matches_plain(cuda, n, G):
    gid = torch.randint(0, G, (n,), device="cuda", generator=cuda,
                        dtype=torch.int32)
    gid[::7] = G + 3                                  # out of range: skipped
    mask = torch.rand(n, device="cuda", generator=cuda) < 0.5
    v = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), device="cuda",
                      generator=cuda, dtype=torch.int32)
    v[: min(n, 3)] = -2 ** 31
    f = torch.randn(n, device="cuda", generator=cuda)
    flags = torch.rand(n, device="cuda", generator=cuda) < 0.3
    kinds = ("int", "float", "count", "int", "int")
    args = (v, f, None, v, flags)
    before = K3.group_aggregate.launches
    got = K3.group_aggregate(gid, mask, args, kinds, G)
    want = K3.group_aggregate_plain(gid, mask, args, kinds, G)
    torch.cuda.synchronize()
    assert K3.group_aggregate.launches == before + 1
    assert torch.equal(got[1], want[1])
    for k, a, b in zip(kinds, got[0], want[0]):
        if k == "float":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)
        else:
            assert torch.equal(a, b)


def test_group_agg_more_args_than_one_launch(cuda):
    n, G = 20_000, 40
    gid = torch.randint(0, G, (n,), device="cuda", generator=cuda,
                        dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    cols = [torch.randint(-50, 50, (n,), device="cuda", generator=cuda,
                          dtype=torch.int32) for _ in range(11)]
    before = K3.group_aggregate.launches
    got = K3.group_aggregate(gid, mask, cols, ("int",) * 11, G)
    want = K3.group_aggregate_plain(gid, mask, cols, ("int",) * 11, G)
    assert K3.group_aggregate.launches == before + 2    # 8 + 3 arguments
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))


@pytest.mark.parametrize("G", [1, 17, 256])
def test_group_agg_float_sums_identical_across_calls(cuda, G):
    n = 3_000_017
    gid = torch.randint(0, G, (n,), device="cuda", generator=cuda,
                        dtype=torch.int32)
    mask = torch.rand(n, device="cuda", generator=cuda) < 0.7
    f = torch.randn(n, device="cuda", generator=cuda) * 1e3
    a = K3.group_aggregate(gid, mask, (f,), ("float",), G)[0][0]
    b = K3.group_aggregate(gid, mask, (f,), ("float",), G)[0][0]
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_group_agg_refuses_what_the_kernel_cannot_take(cuda):
    gid = torch.zeros(10, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="is on"):
        K3.group_aggregate(gid, torch.ones(10, dtype=torch.bool),
                           (None,), ("count",), 4)
    with pytest.raises(ValueError, match="num_groups"):
        K3.group_aggregate(gid, gid > 0, (None,), ("count",), 257)


def test_matmul_path_runs_in_full_f32(cuda):
    """1 + 2^-12 rounds to 1 in TF32's 10 mantissa bits: 64 rows of it per
    group sum to 64 + 2^-6 in full f32 and to 64 under TF32.  With TF32
    turned on, the path refuses to run."""
    n, G = 64 * 300, 300
    gid = torch.arange(G, device="cuda", dtype=torch.int32).repeat_interleave(
        64)
    vals = torch.full((n,), 1 + 2 ** -12, device="cuda")
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    (s,), _gc, _ = matmul_group_aggregate(gid, mask, (vals,), ("float",), G)
    assert bool((s == 64 * (1 + 2 ** -12)).all())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full-f32"):
            matmul_group_aggregate(gid, mask, (vals,), ("float",), G)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_sql_groupby_launches_k3_on_card(cuda):
    import myscaledb_tpu_torch as P
    rng = np.random.default_rng(4)
    n = 1 << 20
    s = P.connect()
    s.create_table("t", {"g": rng.integers(0, 256, n, dtype=np.int32),
                         "v": rng.integers(-1000, 1000, n, dtype=np.int32)})
    before = K3.group_aggregate.launches
    rows = s.sql("SELECT g, sum(v), count(), avg(v) FROM t WHERE v > -500 "
                 "GROUP BY g ORDER BY g").to_rows()
    assert K3.group_aggregate.launches == before + 1
    g = s.tables["t"]["g"].data
    v = s.tables["t"]["v"].data
    sel = v > -500
    cnt = torch.bincount(g[sel].long(), minlength=256).tolist()
    sums = torch.zeros(256, dtype=torch.int64, device="cuda").index_add_(
        0, g[sel].long(), v[sel].long()).tolist()
    assert [r[:3] for r in rows] == [(k, sums[k], cnt[k]) for k in range(256)
                                     if cnt[k]]
