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
from myscaledb_tpu_torch.ops.kernels import merge_count as K4
from myscaledb_tpu_torch.ops.kernels import binary_scan as K5
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


def _sq8_inputs(gen, n, d, nq):
    """A sidecar of n random rows (row 0 all zeros), a random mask over
    the valid rows, and nq queries."""
    x = torch.randn(n, d, device="cuda", generator=gen)
    x[0] = 0.0
    x8, sides = build_sq8(x)
    q = torch.randn(nq, d, device="cuda", generator=gen)
    mv = sides[3:4].clone()
    mv[0, :n] *= (torch.rand(n, device="cuda", generator=gen) < 0.5).float()
    return x8, sides, q, mv


def _sq8_branch(nq, d):
    from myscaledb_tpu_torch.ops.kernels import build
    return build.library().msdb_segmin_sq8_branch(nq, d)


@pytest.mark.parametrize("d", [128, 256, 768, 1024])
@pytest.mark.parametrize("nq", [1, 8, 9, 16, 32, 64, 128])
def test_segmin_sq8_wgmma_int_products(cuda, d, nq):
    """The wgmma branch's int32 products, before the bound's arithmetic,
    against torch._int_mm.  With unit scales, zero norms and residuals, and
    queries of integers whose largest magnitude is 127 (so sq = 1 and q8 =
    q), the IP bound of a row is -(x8 . q8 + 1e-6); one kept row a segment,
    at position seg % 128, makes each segment's minimum that row's product,
    and 256 segments put every row position of both warpgroups under
    test."""
    nseg = 256
    n_pad = nseg * 128
    x8 = torch.randint(-127, 128, (n_pad, d), device="cuda", generator=cuda,
                       dtype=torch.int8)
    q = torch.randint(-127, 128, (nq, d), device="cuda", generator=cuda,
                      dtype=torch.int32)
    q[:, 0] = 127
    q = q.float()
    sides = torch.zeros(4, n_pad, device="cuda")
    sides[2] = 1.0
    sides[3] = 1.0
    seg = torch.arange(nseg, device="cuda")
    rows = seg * 128 + seg % 128
    mv = torch.zeros(1, n_pad, device="cuda")
    mv[0, rows] = 1.0
    assert _sq8_branch(nq, d) == 1
    got = K1.segmin_sq8(x8, sides, q, mv, "IP")
    # torch._int_mm takes widths that are multiples of 8
    wide = -(-nq // 8) * 8
    q8t = torch.nn.functional.pad(q.to(torch.int8).T.contiguous(),
                                  (0, wide - nq))
    want = torch._int_mm(x8[rows], q8t)[:, :nq].T
    torch.cuda.synchronize()
    assert torch.equal(torch.round(-got).to(torch.int32), want)


@pytest.mark.parametrize("n", [100, 16389, 20000])
@pytest.mark.parametrize("d", [128, 256, 768, 1024])
@pytest.mark.parametrize("nq", [1, 8, 9, 16, 17, 64, 127, 128])
@pytest.mark.parametrize("metric", METRICS)
def test_segmin_sq8_wgmma_matches_plain(cuda, n, d, nq, metric):
    """The wgmma branch (every query count whose q8 fits its shared
    memory) against the plain version, at every query width it
    instantiates, ragged n (n_pad a multiple of 16384 only past 16384 rows)
    and the dims of the tested embeddings."""
    x8, sides, q, mv = _sq8_inputs(cuda, n, d, nq)
    assert _sq8_branch(nq, d) == 1
    before = K1.segmin_sq8.launches
    got = K1.segmin_sq8(x8, sides, q, mv, metric)
    want = K1.segmin_sq8_plain(x8, sides, q, mv, metric)
    torch.cuda.synchronize()
    assert K1.segmin_sq8.launches == before + 1
    assert got.shape == want.shape == (nq, x8.shape[0] // 128)
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq", [1, 9, 16, 17, 64, 127, 128])
@pytest.mark.parametrize("metric", METRICS)
def test_segmin_sq8_wgmma_matches_plain_at_1m_rows(cuda, nq, metric):
    """The wgmma branch at config 1's table size (1M rows x 128), where the
    persistent grid walks many segments a block."""
    x8, sides, q, mv = _sq8_inputs(cuda, 1_000_000, 128, nq)
    got = K1.segmin_sq8(x8, sides, q, mv, metric)
    want = K1.segmin_sq8_plain(x8, sides, q, mv, metric)
    torch.cuda.synchronize()
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq,branch", [(64, 1), (65, 0), (128, 0)])
@pytest.mark.parametrize("metric", METRICS)
def test_segmin_sq8_queries_past_shared_memory(cuda, nq, branch, metric):
    """At d = 1152 the queries of a 128-wide wgmma (147 KB of q8) do not
    fit in shared memory: from 65 queries on the __dp4a kernel runs,
    reading the sidecar once per tile of 8 queries; 64 still take the
    wgmma branch, over nine 128-byte chunks a segment."""
    x8, sides, q, mv = _sq8_inputs(cuda, 3000, 1152, nq)
    assert _sq8_branch(nq, 1152) == branch
    got = K1.segmin_sq8(x8, sides, q, mv, metric)
    want = K1.segmin_sq8_plain(x8, sides, q, mv, metric)
    torch.cuda.synchronize()
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [20000, 16389])
@pytest.mark.parametrize("metric", METRICS)
def test_segmin_sq8_branches_are_bit_equal(cuda, n, metric):
    """At d = 1152, 128 queries take the __dp4a branch (their q8 does not
    fit in shared memory); the same queries 64 or 16 at a time, and the
    first 10 alone, take the wgmma branch.  Bit for bit equal: the
    quantization is per query, and both branches sum exactly and share
    the bound's arithmetic."""
    d = 1152
    x8, sides, q, mv = _sq8_inputs(cuda, n, d, 128)
    assert _sq8_branch(128, d) == 0
    assert all(_sq8_branch(k, d) == 1 for k in (10, 16, 64))
    whole = K1.segmin_sq8(x8, sides, q, mv, metric)
    for k in (64, 16):
        parts = torch.cat([K1.segmin_sq8(x8, sides, q[i:i + k], mv, metric)
                           for i in range(0, 128, k)])
        assert torch.equal(whole, parts)
    assert torch.equal(K1.segmin_sq8(x8, sides, q[:10], mv, metric),
                       whole[:10])


@pytest.mark.parametrize("n,d", [(20000, 128), (16389, 1024)])
@pytest.mark.parametrize("metric", METRICS)
def test_segmin_sq8_wgmma_widths_are_bit_equal(cuda, n, d, metric):
    """128 queries (the 128-wide wgmma) equal the same queries 8 at a
    time (the 16-wide one, 8 of its columns padding) and one at a time,
    bit for bit."""
    x8, sides, q, mv = _sq8_inputs(cuda, n, d, 128)
    whole = K1.segmin_sq8(x8, sides, q, mv, metric)
    for k in (8, 1):
        parts = torch.cat([K1.segmin_sq8(x8, sides, q[i:i + k], mv, metric)
                           for i in range(0, 128, k)])
        assert torch.equal(whole, parts)


@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("metric", METRICS)
def test_segmin_sq8_query_prologue(cuda, d, metric):
    """The entry point's query quantization against quantize_queries: q8
    equal; qside within rtol 1e-5 (its norms are sums of d squares in
    another order than PyTorch's, a few f32 ulps apart)."""
    from myscaledb_tpu_torch.ops.kernels import build
    nq = 33
    x8, sides, q, mv = _sq8_inputs(cuda, 300, d, nq)
    q[3] = 0.0                                         # a zero query
    scratch = torch.empty(nq * d + nq * 16, dtype=torch.uint8, device="cuda")
    out = torch.empty(nq, x8.shape[0] // 128, device="cuda")
    build.check(build.library().msdb_segmin_sq8(
        x8.data_ptr(), sides.data_ptr(), q.data_ptr(), scratch.data_ptr(),
        mv.data_ptr(), out.data_ptr(), x8.shape[0], d, nq,
        K2.METRIC_CODES[metric], torch.cuda.current_stream().cuda_stream),
        "segmin_sq8")
    q8, qside = K1.quantize_queries(q, metric)
    torch.cuda.synchronize()
    assert torch.equal(scratch[:nq * d].view(torch.int8).view(nq, d), q8)
    torch.testing.assert_close(scratch[nq * d:].view(torch.float32)
                               .view(nq, 4), qside, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("d", [32, 128, 768])
@pytest.mark.parametrize("nq", [1, 8, 9, 20, 40, 128])
@pytest.mark.parametrize("metric", METRICS)
def test_segmin_f32_tensor_core_shapes(cuda, d, nq, metric):
    """The 3xTF32 kernel at every query-tile count it instantiates (1 and
    2 tiles on mma.sync, 4, 8 and 16 on wgmma), a ragged n, rows of large
    and tiny norm and a zero row."""
    n = 3 * 128 + 77
    x = torch.randn(n, d, device="cuda", generator=cuda)
    x[::5] *= 1e3
    x[1::7] *= 1e-3
    x[2] = 0.0
    q = torch.randn(nq, d, device="cuda", generator=cuda)
    sqn = (x * x).sum(1)
    qa = query_aux(q, metric)
    mask = (torch.rand(n, device="cuda", generator=cuda) < 0.7).float()
    got = K2.segmin_f32(x, q, sqn, qa, mask, metric)
    want = K2.segmin_f32_plain(x, q, sqn, qa, mask, metric)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (nq, 4)
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


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


IMAX = 2 ** 31 - 1


@pytest.mark.parametrize("nb,n", [(1, 1), (5, 33), (4133, 100_003),
                                  (1 << 20, 1 << 22)])
@pytest.mark.parametrize("max_case", ["none", "genuine", "invalid_only"])
def test_merge_count_kernel_matches_plain(cuda, nb, n, max_case):
    build = torch.randint(-5000, 5000, (nb,), device="cuda", generator=cuda,
                          dtype=torch.int32)
    valid = torch.rand(nb, device="cuda", generator=cuda) < 0.85
    if max_case != "none":
        build[0] = IMAX
        valid[0] = max_case == "genuine"
    probe = torch.randint(-6000, 6000, (n,), device="cuda", generator=cuda,
                          dtype=torch.int32)
    probe[:: 7] = IMAX
    b, hm = K4.prepare_build(build, valid)
    assert bool(hm) == (max_case == "genuine")
    before = K4.merge_count.launches
    got = K4.merge_count(b, probe, hm)
    want = K4.merge_count_plain(b, probe, hm)
    torch.cuda.synchronize()
    assert K4.merge_count.launches == before + 1
    assert got.dtype == torch.int64 and int(got) == int(want)


def test_merge_count_empty_and_all_invalid_builds(cuda):
    probe = torch.tensor([1, 2, IMAX, -3], dtype=torch.int32, device="cuda")
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    b, hm = K4.prepare_build(empty)
    assert int(K4.merge_count(b, probe, hm)) == 0
    keys = torch.tensor([1, 2, IMAX], dtype=torch.int32, device="cuda")
    b, hm = K4.prepare_build(keys, torch.zeros(3, dtype=torch.bool,
                                               device="cuda"))
    assert int(K4.merge_count(b, probe, hm)) == 0
    b, hm = K4.prepare_build(keys)
    assert int(K4.merge_count(b, probe, hm)) == 3


@pytest.mark.parametrize("case", sorted(K4.index_edge_cases()))
def test_merge_count_index_edge_cases(cuda, case):
    """The directory's edge cases: the kernel with the join build's index,
    and with none (the wrapper builds it), equals the plain version and
    the plain walk of the same directory."""
    build, valid, probe = K4.index_edge_cases()[case]
    b, hm = K4.prepare_build(torch.from_numpy(build).cuda(),
                             torch.from_numpy(valid).cuda())
    p = torch.from_numpy(probe).cuda()
    index = K4.build_count_index(b)
    want = int(K4.merge_count_plain(b, p, hm))
    assert int(K4.directory_walk(b, p, hm, index)) == want
    before = K4.merge_count.launches
    assert int(K4.merge_count(b, p, hm, index)) == want
    assert int(K4.merge_count(b, p[1:], hm)) == int(
        K4.merge_count_plain(b, p[1:], hm))          # unaligned probes
    assert K4.merge_count.launches == before + 2


@pytest.mark.parametrize("nseg,words", [(16, 8), (32, 2), (16, 17),
                                        (2, K5.QCHUNK_WORDS)])
@pytest.mark.parametrize("nq", [1, 10, 33])
@pytest.mark.parametrize("metric", ["Hamming", "Jaccard"])
def test_binary_segmin_kernel_is_bit_equal(cuda, nseg, words, nq, metric):
    x3 = torch.randint(-2 ** 31, 2 ** 31 - 1, (nseg, words, K5.SEG),
                       device="cuda", generator=cuda, dtype=torch.int32)
    x3[0, :, :5] = 0                                   # empty unions
    qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (nq, words), device="cuda",
                       generator=cuda, dtype=torch.int32)
    mask2 = (torch.rand(nseg, K5.SEG, device="cuda", generator=cuda)
             < 0.5).to(torch.uint8)
    mask2[1] = 0                                       # a fully masked segment
    n = nseg * K5.SEG - 777                            # a tail
    for has_mask in (False, True):
        before = K5.binary_segment_mins.launches
        got = K5.binary_segment_mins(x3, qw, mask2, metric, n, has_mask)
        want = K5.binary_segment_mins_plain(x3, qw, mask2, metric, n,
                                            has_mask)
        torch.cuda.synchronize()
        assert K5.binary_segment_mins.launches == before + 1
        assert got.shape == (nseg, nq)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_binary_segmin_kernel_refuses_rows_past_one_query_of_smem(cuda):
    wide = torch.zeros((1, K5.QCHUNK_WORDS + 1, K5.SEG), dtype=torch.int32,
                       device="cuda")
    with pytest.raises(ValueError, match=f"words <= {K5.QCHUNK_WORDS}"):
        K5.binary_segment_mins(wide, wide[0, :, :1].T.contiguous(), wide,
                               "Hamming", 1, False)


def test_sql_binary_launches_k5_on_card(cuda):
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.core.table import Column, Table
    from myscaledb_tpu_torch.interop import fixed_string_column
    rng = np.random.default_rng(5)
    n, nbytes = (1 << 16) + 5, 5                       # odd width: 2 words
    raw = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    s = P.connect()
    s.register("tb", Table([
        Column.from_numpy("id", np.arange(n, dtype=np.int64), device="cuda"),
        fixed_string_column("bv", raw, nbytes, device="cuda")]))
    q = rng.integers(0, 256, nbytes, dtype=np.uint8)
    before = K5.binary_segment_mins.launches
    rows = s.sql(f"SELECT id, distance(bv, unhex('{q.tobytes().hex()}')) "
                 "AS d FROM tb ORDER BY d LIMIT 10").to_rows()
    assert K5.binary_segment_mins.launches == before + 1
    d = np.unpackbits(raw ^ q[None, :], axis=1).sum(1)
    order = np.lexsort((np.arange(n), d))[:10]
    assert rows == [(int(i), float(d[i])) for i in order]


def _ddl_table(s, name, emb, price):
    """A table made the way a user makes one: CREATE, then INSERT ...
    SELECT from a staging table registered from numpy."""
    n, d = emb.shape
    s.create_table("stage", {"id": np.arange(n, dtype=np.int64),
                             "emb": emb, "price": price})
    s.sql(f"CREATE TABLE {name} (id UInt32, emb Array(Float32), price Int32,"
          f" CONSTRAINT l CHECK length(emb) = {d}) ENGINE = MergeTree "
          "ORDER BY id")
    s.sql(f"INSERT INTO {name} SELECT id, emb, price FROM stage")
    s.sql("DROP TABLE stage")


@pytest.mark.parametrize("nq", [10, 32, 128])
@pytest.mark.parametrize("same", [False, True])
def test_sql_batch_distance_on_card(cuda, nq, same):
    """batch_distance ... LIMIT 10 BY dist.1 on a DDL-built table: K1 once
    a statement; with identical rows the certificate fails and K2 runs (at
    nq = 32 and 128 its wgmma half).  Rows equal a direct-formula oracle on
    the card, ties by id."""
    import myscaledb_tpu_torch as P
    rng = np.random.default_rng(7)
    n, d, k = 1 << 16, 128, 10
    emb = rng.standard_normal((n, d), dtype=np.float32)
    if same:
        emb[:] = emb[0]
    price = rng.integers(0, 100, n).astype(np.int32)
    s = P.connect()
    _ddl_table(s, "tv", emb, price)
    qs = rng.standard_normal((nq, d), dtype=np.float32)
    lit = "[" + ",".join("[" + ",".join(repr(float(v)) for v in q) + "]"
                         for q in qs) + "]"
    before = (K1.segmin_sq8.launches, K2.segmin_f32.launches)
    rows = s.sql(f"SELECT id, batch_distance(emb, {lit}) AS dist FROM tv "
                 "WHERE price < 50 ORDER BY dist.1, dist.2 "
                 f"LIMIT {k} BY dist.1").to_rows()
    assert K1.segmin_sq8.launches == before[0] + 1
    if same:
        assert K2.segmin_f32.launches == before[1] + 1
    x = s.tables["tv"]["emb"].data
    keep = s.tables["tv"]["price"].data < 50
    assert len(rows) == nq * k
    for qi in range(nq):
        dist = ((x - torch.as_tensor(qs[qi], device="cuda")) ** 2).sum(1)
        dist = torch.where(keep, dist, torch.inf)
        order = torch.sort(dist, stable=True).indices[:k]
        got = [r for r in rows if r[1] == qi]
        assert [r[0] for r in got] == order.cpu().tolist()
        np.testing.assert_allclose([r[2] for r in got],
                                   dist[order].cpu().numpy(), rtol=2e-5)


@pytest.mark.parametrize("sql", [
    "SELECT id, price FROM t ORDER BY price, id LIMIT 3 BY price",
    "SELECT id, price FROM t WHERE price < 20 ORDER BY id DESC "
    "LIMIT 2 BY price, id % 2 LIMIT 50 OFFSET 1",
    "SELECT id, f FROM t ORDER BY id LIMIT 1 BY f",
])
def test_limit_by_on_card_equals_cpu(cuda, sql):
    """LIMIT BY runs on the device (torch.unique, a stable sort): the same
    statement on the card and on the CPU gives the same rows, float keys
    with -0.0 and NaN included."""
    import myscaledb_tpu_torch as P
    rng = np.random.default_rng(11)
    n = 1 << 16
    f = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, 2.5]), n)
    data = {"id": np.arange(n, dtype=np.int64),
            "price": rng.integers(0, 100, n).astype(np.int32), "f": f}
    rows = []
    for dev in ("cuda", "cpu"):
        s = P.connect(device=dev)
        s.create_table("t", data)
        rows.append(repr(s.sql(sql).to_rows()))
    assert rows[0] == rows[1]


# -- slice 8: device code of the scalar functions and special aggregates --

def _hits_like(rng, n):
    return {"id": np.arange(n, dtype=np.int64),
            "i32": rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
            "u": rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64),
            "f": rng.standard_normal(n).astype(np.float32),
            "d": rng.integers(0, 65536, n).astype(np.int32),
            "ts": rng.integers(0, 2 ** 32, n).astype(np.int64),
            "g": rng.integers(0, 24, n).astype(np.int32),
            "w": rng.integers(0, 3000, n).astype(np.int16)}


@pytest.mark.parametrize("sql", [
    # the device closed forms of the 64-bit hashes over int64 bits, and
    # their unsigned compare / modulo / order
    "SELECT cityHash64(u), sipHash64(i32), xxHash64(f), intHash64(u), "
    "intHash32(i32), cityHash64(u) % 1000003, xxHash64(u) > "
    "9223372036854775807 FROM t",
    "SELECT id, sipHash64(u) AS h FROM t ORDER BY h LIMIT 100",
    "SELECT bitCount(u), bitRotateLeft(u, 13), toUInt64(i32), "
    "bitShiftRight(cityHash64(u), 7) FROM t",
    # the civil calendar
    "SELECT toYear(d), toMonth(d), toDayOfMonth(d), toDayOfYear(d), "
    "toYYYYMMDDhhmmss(ts), toStartOfQuarter(d), toMonday(d), "
    "addMonths(d, 7), dateDiff('week', d, toDate(ts)) FROM t",
    "SELECT toStartOfMinute(ts) AS m, count() FROM t GROUP BY m ORDER BY m "
    "LIMIT 20",
    # the special aggregates: distinct run starts, the inverted-CDF
    # element, HLL registers (uniqHLL12 takes the sketch at any size)
    "SELECT g, uniqExact(u), uniq(i32), uniqHLL12(u), quantile(0.9)(w), "
    "median(f), argMin(id, f), argMax(u, w), anyLast(id), "
    "quantiles(0.1, 0.5)(w), sumDistinct(w), groupBitXor(i32), count() "
    "FROM t GROUP BY g ORDER BY g",
    "SELECT count(DISTINCT u), uniqCombined(i32), varPop(w), corr(f, w) "
    "FROM t",
])
def test_slice8_device_code_on_card_equals_cpu(cuda, sql):
    """The hashes, the calendar math and the special aggregates give the
    same rows on the card as on the CPU (the CPU tests hold the CPU to the
    JAX package); f64 moments within rtol 1e-12."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.config import Settings
    from myscaledb_tpu_torch.core.types import DataType
    rng = np.random.default_rng(12)
    data = _hits_like(rng, 200_003)
    rows = []
    for dev in ("cuda", "cpu"):
        s = P.connect(Settings(uniq_combined_exact_rows=1000), device=dev)
        s.create_table("t", data, dtypes={"d": DataType.DATE,
                                          "ts": DataType.DATETIME})
        rows.append(s.sql(sql).to_rows())
    got, want = rows
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        for x, y in zip(rg, rw):
            if isinstance(y, float) and not np.isnan(y):
                np.testing.assert_allclose(x, y, rtol=1e-12)
            else:
                assert repr(x) == repr(y)


def test_hll_registers_on_card_equal_cpu(cuda):
    from myscaledb_tpu_torch.ops import hll
    g = torch.Generator().manual_seed(3)
    keys = torch.randint(-2 ** 63, 2 ** 63 - 1, (1 << 20,), generator=g)
    gid = torch.randint(0, 7, (1 << 20,), generator=g)
    mask = torch.rand(1 << 20, generator=g) < 0.9
    want = hll.hll_registers(hll.hash_key_columns([keys]), gid, mask, 7)
    got = hll.hll_registers(hll.hash_key_columns([keys.cuda()]), gid.cuda(),
                            mask.cuda(), 7)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(hll.hll_estimate(got).cpu(), hll.hll_estimate(want))


def _slice9_data(rng, n):
    lens = rng.integers(0, 9, n)
    return {"id": np.arange(n, dtype=np.int64),
            "k": rng.integers(0, 50, n).astype(np.int64),
            "s": [f"w{i}" for i in rng.integers(0, 40, n)],
            "f": rng.integers(-8, 8, n) / 4.0,
            "cats": [rng.integers(0, 256, m).tolist() for m in lens],
            "tags": [[f"t{i}" for i in rng.integers(0, 30, m)]
                     for m in lens]}


@pytest.mark.parametrize("sql", [
    # ARRAY JOIN and arrayJoin(): row ids and positions on the card
    "SELECT id, c FROM t ARRAY JOIN cats AS c ORDER BY id, c",
    "SELECT c, count() FROM t ARRAY JOIN cats AS c GROUP BY c ORDER BY c",
    "SELECT count(), sum(c) FROM t LEFT ARRAY JOIN cats AS c",
    "SELECT id, x, y FROM t ARRAY JOIN cats AS x, tags AS y ORDER BY id, x",
    "SELECT arrayJoin(tags) AS w, count() FROM t GROUP BY w ORDER BY w",
    # the HOF env and the segment reductions over the flat element axis
    "SELECT id, arrayMap(x -> x * 2 + k, cats), arrayFilter(x -> x < 16, "
    "cats), arrayExists(x -> x = 7, cats), arrayCount(x -> x > k, cats), "
    "arrayFirstIndex(x -> x > 100, cats), arraySort(x -> -x, cats) FROM t "
    "ORDER BY id",
    "SELECT sum(arraySum(arrayMap(x -> x * 2, cats))), count() FROM t "
    "WHERE length(arrayFilter(x -> x < 16, cats)) > 0",
    "SELECT id, has(cats, 7), indexOf(tags, 't3'), countEqual(cats, k), "
    "hasAny(cats, [1, 2, 3]), hasAll(tags, ['t1']), arrayUniq(cats), "
    "arrayDistinct(tags), arraySlice(cats, 2, 3), arrayReverse(cats), "
    "cats[-1], arrayCumSum(cats), arrayConcat(cats, [k]) FROM t ORDER BY id",
    # set operations and IN (subquery) membership
    "SELECT k, s FROM t WHERE id < 5000 INTERSECT SELECT k, s FROM t "
    "WHERE id >= 3000",
    "SELECT f FROM t WHERE id % 3 = 0 EXCEPT SELECT f FROM t "
    "WHERE id % 5 = 0",
    "SELECT s FROM t WHERE k < 25 INTERSECT DISTINCT SELECT s FROM t "
    "WHERE k > 10",
    "SELECT count() FROM t WHERE s IN (SELECT s FROM t WHERE k = 3) "
    "AND k NOT IN (SELECT k FROM t WHERE id < 100)",
])
def test_slice9_device_code_on_card_equals_cpu(cuda, sql):
    """ARRAY JOIN, the lambda functions, the array functions, the set
    operations' multiset match and IN (subquery) give the same rows on the
    card as on the CPU (the CPU tests hold the CPU to the JAX package)."""
    import myscaledb_tpu_torch as P
    data = _slice9_data(np.random.default_rng(9), 20_011)
    rows = []
    for dev in ("cuda", "cpu"):
        s = P.connect(device=dev)
        s.create_table("t", data)
        rows.append(s.sql(sql).to_rows())
    assert repr(rows[0]) == repr(rows[1])


def test_element_row_ids_need_no_host_sync(cuda):
    """The per-element row ids and positions, the integer segment sums and
    the lambda env's broadcast of an outer column are made on the card
    without waiting for it (sync debug mode raises on a synchronisation)."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.exec import arrays as A
    from myscaledb_tpu_torch.exec.expr import Env
    from myscaledb_tpu_torch.sql.ast import Ident
    s = P.connect(device="cuda")
    s.create_table("t", _slice9_data(np.random.default_rng(4), 5003))
    t = s.tables["t"]
    env = Env(t, device=s.device)
    v = env.resolve(Ident("cats"))
    flat, off, _ = A.as_array(v, env)
    A.device_offsets(off, s.device)                 # the one upload
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rid = A._rid(off, s.device)
        pos = A._pos(off, s.device, rid)
        sums = A._seg_sum(off, flat, torch.int64, s.device)
        kk = A._ElemEnv(env, off, {}).resolve(Ident("k"))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    o = torch.as_tensor(off)
    lens = o[1:] - o[:-1]
    want_rid = torch.repeat_interleave(torch.arange(len(lens)), lens)
    assert torch.equal(rid.cpu(), want_rid)
    assert torch.equal(pos.cpu(), torch.arange(int(o[-1])) - o[:-1][want_rid])
    assert torch.equal(kk.data.cpu(), t["k"].data.cpu()[want_rid])
    want_sums = torch.zeros(len(lens), dtype=torch.int64).index_add_(
        0, want_rid, flat.cpu().long())
    assert torch.equal(sums.cpu(), want_sums)


def _text_corpus(rng, n):
    words = np.array([f"w{i}" for i in range(400)])
    lens = rng.integers(0, 30, n)
    ranks = np.minimum(rng.zipf(1.3, int(lens.sum())) - 1, 399)
    docs, at = [], 0
    for ln in lens:
        docs.append(" ".join(words[ranks[at:at + ln]]))
        at += ln
    docs[3] = None
    return docs


def test_bm25_on_card_bit_equals_cpu(cuda):
    """The BM25 index built on the card (device expansion, sort, run
    lengths) scores every query bit for bit as on the CPU (the CPU tests
    hold the CPU to the JAX package), and its top-k ids are equal."""
    from myscaledb_tpu_torch.text.bm25 import BM25Index
    rng = np.random.default_rng(10)
    docs = _text_corpus(rng, 30_011)
    idx = {dev: BM25Index(docs, device=dev) for dev in ("cuda", "cpu")}
    assert idx["cuda"].avg_len == idx["cpu"].avg_len
    for dev in ("starts", "post_docs", "post_tfs", "df", "doc_len"):
        assert torch.equal(getattr(idx["cuda"], dev).cpu(),
                           getattr(idx["cpu"], dev))
    mask = rng.random(len(docs)) < 0.5
    for q in ["w0 w1", "w5 w5 w77 nothing", "w3", "w10 w2 w399 w150"]:
        for op in ("OR", "AND"):
            a = idx["cuda"].scores(q, op).cpu()
            b = idx["cpu"].scores(q, op)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            for m in (None, mask):
                sa, ia = idx["cuda"].search(q, 25, mask=m, operator=op)
                sb, ib = idx["cpu"].search(q, 25, mask=m, operator=op)
                assert torch.equal(ia.cpu(), ib)
                assert torch.equal(sa.cpu(), sb)


def test_sql_hybrid_search_launches_k2_on_card(cuda):
    """HybridSearch's vector half scans with no SQ8 sidecar: at 2^16 rows
    and more it launches K2 once a statement.  RRF's rows equal the CPU's (the
    lists' ids are); RSF's ids are, its scores within 1e-5 (K2's 3xTF32
    distances normalize to a few f32 ulps from the CPU's)."""
    import myscaledb_tpu_torch as P
    rng = np.random.default_rng(12)
    n, d = (1 << 16) + 5, 128
    data = {"id": np.arange(n, dtype=np.int64),
            "body": _text_corpus(rng, n),
            "price": rng.integers(0, 100, n).astype(np.int32),
            "emb": rng.standard_normal((n, d)).astype(np.float32)}
    qv = "[" + ",".join(repr(float(v)) for v in
                        data["emb"][77] + 0.3) + "]"
    res = {}
    for dev in ("cuda", "cpu"):
        s = P.connect(device=dev)
        s.create_table("p", data)
        for fusion in ("rsf", "rrf"):
            before = K2.segmin_f32.launches
            res[dev, fusion] = s.sql(
                f"SELECT id, HybridSearch('fusion_type={fusion}')(emb, body, "
                f"{qv}, 'w1 w9 w40') AS s FROM p WHERE price < 50 "
                "ORDER BY s DESC LIMIT 10").to_rows()
            assert K2.segmin_f32.launches == before + (dev == "cuda")
    assert res["cuda", "rrf"] == res["cpu", "rrf"]
    got, want = res["cuda", "rsf"], res["cpu", "rsf"]
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=1e-5)


def test_partition_clustering_and_zone_maps_on_card_equal_cpu(cuda):
    """A partitioned INSERT clusters the batch and takes its zone maps on
    the card: the rows, their order and every zone map equal the CPU
    session's, and the pruned statement reads the same blocks."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.core.table import BLOCK_ROWS, ZoneMap
    from myscaledb_tpu_torch.runtime import metrics as M
    rng = np.random.default_rng(0)
    n = 3 * BLOCK_ROWS + 77
    data = {"d": rng.integers(0, 9, n).astype(np.uint8),
            "u": rng.integers(0, 1 << 32, n).astype(np.uint32),
            "f": rng.standard_normal(n).astype(np.float32),
            "s": [f"w{i % 31}" for i in range(n)]}
    out = []
    for dev in ("cpu", "cuda"):
        s = P.connect(device=dev)
        s.create_table("src", data)
        s.sql("CREATE TABLE p (d UInt8, u UInt32, f Float32, s String) "
              "ENGINE = MergeTree PARTITION BY (d, s) ORDER BY u")
        s.sql("INSERT INTO p SELECT * FROM src")
        s.sql("INSERT INTO p SELECT * FROM src WHERE d < 4")
        t = s.tables["p"]
        M.reset()
        rows = s.sql("SELECT count(), sum(u) FROM p WHERE d = 3").to_rows()
        out.append((t.to_rows(), [(t[c].zonemap.mins, t[c].zonemap.maxs)
                                  for c in ("d", "u", "f", "s")], rows,
                    M.events_snapshot().get("ZonemapPrunedBlocks", 0)))
    assert out[0][0] == out[1][0] and out[0][2:] == out[1][2:]
    for (a0, a1), (b0, b1) in zip(out[0][1], out[1][1]):
        assert a0.dtype == b0.dtype
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
    x = torch.randn(n, device="cuda", generator=cuda)
    zd = ZoneMap.build_device(x, np.float32)
    zh = ZoneMap.build(x.cpu().numpy())
    np.testing.assert_array_equal(zd.mins, zh.mins)
    np.testing.assert_array_equal(zd.maxs, zh.maxs)


@pytest.mark.parametrize("dtype", ["int64", "int32", "float32", "float64"])
def test_skip_index_sidecars_on_card_bit_equal_cpu(cuda, dtype):
    """The bloom words and set lists built on the card equal the CPU's,
    bit for bit (the CPU's equal the JAX package's numpy builds:
    tests/test_torch_skip_index.py)."""
    from myscaledb_tpu_torch.core.table import BLOCK_ROWS
    from myscaledb_tpu_torch.storage import skip_index as sk
    rng = np.random.default_rng(1)
    n = 5 * BLOCK_ROWS + 123
    a = (rng.integers(-60, 60, n) / 4).astype(dtype)
    a[BLOCK_ROWS:2 * BLOCK_ROWS] = rng.integers(-1 << 40, 1 << 40,
                                                BLOCK_ROWS)
    for fp in (0.025, 0.001):
        got = sk.build_bloom_sidecar(torch.as_tensor(a, device="cuda"), fp)
        want = sk.build_bloom_sidecar(torch.as_tensor(a), fp)
        np.testing.assert_array_equal(got.bits, want.bits)
    got = sk.build_set_sidecar(torch.as_tensor(a, device="cuda"), 100,
                               a.dtype)
    want = sk.build_set_sidecar(torch.as_tensor(a), 100, a.dtype)
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_array_equal(g + 0, w + 0)


def test_pruned_vector_search_reaches_k1_with_one_sq8_build(cuda,
                                                            monkeypatch):
    """A partitioned config-1 table on the card: the pruned statements and
    the unpruned ones launch K1 once each and share the table's one SQ8
    sidecar; rows equal the CPU session's."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.sql import executor
    builds = []
    real = executor.build_sq8
    monkeypatch.setattr(executor, "build_sq8",
                        lambda x: builds.append(x.device.type) or real(x))
    rng = np.random.default_rng(2)
    n, d = 200_000, 128
    data = {"id": np.arange(n, dtype=np.int64),
            "price": rng.integers(0, 100, n).astype(np.int32),
            "day": rng.integers(0, 10, n).astype(np.uint8),
            "emb": rng.standard_normal((n, d), dtype=np.float32)}
    qs = rng.standard_normal((4, d), dtype=np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        s = P.connect(device=dev)
        s.create_table("src", data)
        s.sql("CREATE TABLE t (id UInt32, price Int32, day UInt8, emb "
              f"Array(Float32), CONSTRAINT c CHECK length(emb) = {d}) "
              "ENGINE = MergeTree PARTITION BY day ORDER BY id")
        s.sql("INSERT INTO t SELECT id, price, day, emb FROM src")
        rows = []
        K1.segmin_sq8.launches = 0
        for where in ("day = 3 AND price < 50", "price < 50"):
            for q in qs:
                vec = "[" + ",".join(repr(float(v)) for v in q) + "]"
                rows.append(s.sql(f"SELECT id, distance(emb, {vec}) AS d "
                                  f"FROM t WHERE {where} ORDER BY d "
                                  "LIMIT 10").to_rows())
        out[dev] = (rows, K1.segmin_sq8.launches)
    assert [[r[0] for r in x] for x in out["cuda"][0]] == \
        [[r[0] for r in x] for x in out["cpu"][0]]
    assert out["cuda"][1] == 8
    assert builds == ["cpu", "cuda"]


def _views_data(rng, n):
    return {"k": rng.integers(0, 40, n).astype(np.uint32),
            "big": rng.integers(0, 5000, n).astype(np.int64),
            "v": rng.integers(-1000, 1000, n).astype(np.int32),
            "u": rng.integers(0, 1 << 40, n).astype(np.uint64),
            "f": rng.standard_normal(n).astype(np.float32),
            "s": np.array(["a", "bb", "ccc", "dd"])[rng.integers(0, 4, n)]}


@pytest.mark.parametrize("sql", [
    # K3 partials: 40 groups
    "SELECT k, sumState(v), countState(v), avgState(v), maxState(v), "
    "uniqState(u), uniqState(s) FROM t GROUP BY k ORDER BY k",
    # beyond 256 groups: the grouping's scatter partials
    "SELECT big, sumState(v), countState(v), minState(f), avgState(f) "
    "FROM t GROUP BY big ORDER BY big",
    # float sums in numpy's order on the device, groups of ~1250 rows
    "SELECT k, sumState(f), avgState(f) FROM t GROUP BY k ORDER BY k",
    "SELECT k, sumMerge(st), countMerge(ct), maxMerge(mt), uniqMerge(ut) "
    "FROM (SELECT k, big, sumState(v) AS st, countState(v) AS ct, "
    "maxState(v) AS mt, uniqState(u) AS ut FROM t GROUP BY k, big) "
    "GROUP BY k ORDER BY k",
    "SELECT k, finalizeAggregation(st) FROM (SELECT k, avgState(v) AS st "
    "FROM t GROUP BY k) ORDER BY k",
])
def test_state_combinators_on_card_equal_cpu(cuda, sql):
    """-State strings (from K3 up to 256 groups, from the scatter partials
    beyond) and their -Merge / finalizeAggregation are the same on the card
    as on the CPU (the CPU tests hold the CPU to the JAX package's
    strings); K3 launches where the groups allow it."""
    import myscaledb_tpu_torch as P
    data = _views_data(np.random.default_rng(12), 50_021)
    rows = []
    K3.group_aggregate.launches = 0
    for dev in ("cuda", "cpu"):
        s = P.connect(device=dev)
        s.create_table("t", data)
        rows.append(s.sql(sql).to_rows())
    assert repr(rows[0]) == repr(rows[1])
    if sql.startswith("SELECT k, sumState(v)"):
        assert K3.group_aggregate.launches >= 1


def test_lookups_and_alter_update_on_card_equal_cpu(cuda):
    """joinGet's sorted probe, dictGet's HASHED and FLAT lookups, IN a Set
    table and ALTER UPDATE give the same rows on the card as on the CPU."""
    import myscaledb_tpu_torch as P
    data = _views_data(np.random.default_rng(13), 30_011)
    stmts = [
        "SELECT joinGet('j', 'name', big) AS n, count() FROM t GROUP BY n "
        "ORDER BY n",
        "SELECT sum(dictGetOrDefault('dh', 'w', big, -1)), "
        "sum(dictGet('df', 'w', big)), countIf(dictHas('dh', big)) FROM t",
        "SELECT count() FROM t WHERE big IN st",
        "ALTER TABLE t UPDATE v = v * 3, s = 'zz' WHERE k < 7",
        "SELECT k, sum(v), count(), min(s) FROM t GROUP BY k ORDER BY k"]
    keys = np.arange(0, 5000, 3, dtype=np.int64)
    rows = []
    for dev in ("cuda", "cpu"):
        s = P.connect(device=dev)
        s.create_table("t", data)
        s.create_table("dsrc", {"big": keys, "w": keys * 7,
                                "name": [f"n{k % 97}" for k in keys]})
        s.sql("CREATE TABLE j (big Int64, name String) ENGINE = "
              "Join(ANY, LEFT, big)")
        s.sql("INSERT INTO j SELECT big, name FROM dsrc")
        s.sql("CREATE TABLE st (big Int64) ENGINE = Set")
        s.sql("INSERT INTO st SELECT big FROM dsrc WHERE big % 2 = 0")
        s.sql("CREATE DICTIONARY dh (big Int64, w Int64) PRIMARY KEY big "
              "SOURCE(TABLE 'dsrc') LAYOUT(HASHED())")
        s.sql("CREATE DICTIONARY df (big Int64, w Int64) PRIMARY KEY big "
              "SOURCE(TABLE 'dsrc') LAYOUT(FLAT())")
        rows.append([s.sql(q).to_rows() for q in stmts])
    assert repr(rows[0]) == repr(rows[1])
