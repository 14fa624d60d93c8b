"""Vector-scan parity on the CPU: myscaledb_tpu_torch.ops.vector against
myscaledb_tpu.ops.vector (Pallas paths in interpret mode) on the same numpy
inputs.  Ids must be equal; distances agree within the reference's own
tolerance (rtol 2e-5, tests/test_vector.py) at d = 128, where the two
libraries sum in different orders, and bit for bit at d <= 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myscaledb_tpu.ops import vector as J
from myscaledb_tpu_torch.ops import vector as P
from myscaledb_tpu_torch.ops.kernels import distance as K2
from myscaledb_tpu_torch.ops.kernels import distance_q as K1

torch.set_num_threads(1)

METRICS = ["L2", "Cosine", "IP"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(pd, pi, jd, ji, exact=False):
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    if exact:
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    else:
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=2e-5,
                                   atol=2e-5)


def _data(rng, n, d, nq):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    mask = rng.random(n) < 0.5
    return x, q, mask


@pytest.mark.parametrize("metric", METRICS)
def test_sq8_path_matches_jax(rng, metric):
    n, d, nq, k = 4096, 128, 3, 10
    x, q, mask = _data(rng, n, d, nq)
    jx8, jsides = J.build_sq8(jnp.asarray(x))
    jd, ji, jok = J._distance_scan_sq8(
        jnp.asarray(x), jx8, jsides, jnp.asarray(q), jnp.asarray(mask),
        metric, k, True, 32, interpret=True)
    x8, sides = P.build_sq8(_t(x))
    pd, pi, pok = P._distance_scan_sq8(_t(x), x8, sides, _t(q), _t(mask),
                                       metric, k, True, 32)
    assert bool(pok) == bool(jok)
    _check(pd, pi, jd, ji)


def test_sq8_certificate_fails_on_tied_rows(rng):
    n, d = 16384, 128
    x = np.ones((n, d), dtype=np.float32)
    q = rng.standard_normal((1, d)).astype(np.float32)
    x8, sides = P.build_sq8(_t(x))
    _, _, ok = P._distance_scan_sq8(_t(x), x8, sides, _t(q),
                                    torch.ones(0, dtype=torch.bool), "L2",
                                    10, False, 16)
    assert not bool(ok)


@pytest.mark.parametrize("metric", METRICS)
def test_segmin_path_matches_jax(rng, metric):
    n, d, nq, k = 4096 + 37, 128, 3, 7
    x, q, mask = _data(rng, n, d, nq)
    sqn = (x * x).sum(1)
    jd, ji = J._distance_scan_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(mask), jnp.asarray(sqn),
        metric, k, True, 16, interpret=True)
    pd, pi = P._distance_scan_segmin(_t(x), _t(q), _t(mask), _t(sqn), metric,
                                     k, True, 16)
    _check(pd, pi, jd, ji)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("has_mask", [True, False])
def test_oneshot_and_streaming_paths_match_jax(rng, metric, has_mask):
    n, d, nq, k = 3000 + 45, 24, 3, 12
    x, q, mask = _data(rng, n, d, nq)
    sqn = (x * x).sum(1)
    jm = jnp.asarray(mask) if has_mask else jnp.ones((0,), bool)
    pm = _t(mask) if has_mask else torch.ones(0, dtype=torch.bool)
    jd, ji = J._distance_scan_oneshot_impl(
        jnp.asarray(x), jnp.asarray(q), jm, jnp.asarray(sqn), metric, k,
        has_mask, 16)
    pd, pi = P._distance_scan_oneshot_impl(_t(x), _t(q), pm, _t(sqn), metric,
                                           k, has_mask, 16)
    _check(pd, pi, jd, ji)
    jd, ji = J._distance_scan_impl(jnp.asarray(x), jnp.asarray(q), jm,
                                   jnp.asarray(sqn), metric, k, 512,
                                   has_mask, 16)
    pd, pi = P._distance_scan_impl(_t(x), _t(q), pm, _t(sqn), metric, k, 512,
                                   has_mask, 16)
    _check(pd, pi, jd, ji)


def test_host_streaming_scan_matches_jax(rng):
    n, d, nq, k = 5000, 16, 2, 9
    x, q, mask = _data(rng, n, d, nq)
    jd, ji = J.distance_scan_streaming(x, jnp.asarray(q), "L2", k, mask,
                                       block_rows=1024)
    pd, pi = P.distance_scan_streaming(x, _t(q), "L2", k, mask,
                                       block_rows=1024)
    _check(pd, pi, jd, ji)


@pytest.mark.parametrize("metric", METRICS)
def test_small_d_is_bit_equal(rng, metric):
    """d <= 8 sums one f32 step at a time in both packages; Cosine's norms
    follow XLA's CPU order too (fused multiply-adds at d <= 4)."""
    n, d, nq, k = 700, 3, 4, 9
    x, q, mask = _data(rng, n, d, nq)
    jd, ji = J.distance_scan(x, q, metric=metric, k=k, mask=mask)
    pd, pi = P.distance_scan(_t(x), q, metric=metric, k=k, mask=_t(mask))
    _check(pd, pi, jd, ji, exact=True)


@pytest.mark.parametrize("d", range(1, 9))
def test_small_d_cosine_norms_are_bit_equal(rng, d):
    """The Cosine rescore at every d <= 8, norms of rows spread over six
    orders of magnitude, against the JAX package's compiled formula."""
    x = (rng.standard_normal((3000, d)) *
         rng.choice([1e-2, 1.0, 1e2, 1e4], (3000, 1))).astype(np.float32)
    q = rng.standard_normal((3000, d)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: J.exact_distance(
        a, b, "Cosine"))(x, q))
    got = P.exact_distance(_t(x), _t(q), "Cosine").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", ["k_gt_n", "all_false_mask", "all_tied"])
def test_edge_cases_match_jax(rng, metric, case):
    n, d, k = 50, 4, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((2, d)).astype(np.float32)
    mask = None
    if case == "k_gt_n":
        n, k = 6, 9
        x = x[:n]
    elif case == "all_false_mask":
        mask = np.zeros(n, dtype=bool)
    else:
        x[:] = 1.5
    jd, ji = J.distance_scan(x, q, metric=metric, k=k, mask=mask)
    pd, pi = P.distance_scan(_t(x), q, metric=metric, k=k,
                             mask=None if mask is None else _t(mask))
    _check(pd, pi, jd, ji, exact=True)


def test_dispatch_takes_kernel_branches_on_cpu(rng, monkeypatch):
    """At n >= 65536, d = 128 the port picks the K1 branch (sidecar) or the
    K2 branch (none), running the plain versions on CPU tensors, and
    returns the JAX package's answer."""
    calls = {"sq8": 0, "f32": 0}
    real_sq8, real_f32 = K1.segmin_sq8_plain, K2.segmin_f32_plain

    def spy_sq8(*a):
        calls["sq8"] += 1
        return real_sq8(*a)

    def spy_f32(*a):
        calls["f32"] += 1
        return real_f32(*a)

    monkeypatch.setattr(K1, "segmin_sq8_plain", spy_sq8)
    monkeypatch.setattr(K2, "segmin_f32_plain", spy_f32)
    n, d, k = 1 << 16, 128, 10
    x, q, mask = _data(rng, n, d, 1)
    jd, ji = J.distance_scan(x, q, metric="L2", k=k, mask=mask)
    xt = _t(x)
    pd, pi = P.distance_scan(xt, q, metric="L2", k=k, mask=_t(mask),
                             sq8=P.build_sq8(xt))
    _check(pd, pi, jd, ji)
    assert calls == {"sq8": 1, "f32": 0}
    pd, pi = P.distance_scan(xt, q, metric="L2", k=k, mask=_t(mask))
    _check(pd, pi, jd, ji)
    assert calls == {"sq8": 1, "f32": 1}
    assert K1.segmin_sq8.launches == 0 and K2.segmin_f32.launches == 0


def test_rowwise_distance_matches_jax(rng):
    x, q, _ = _data(rng, 40, 6, 1)
    for metric in METRICS:
        got = P.rowwise_distance(_t(x), q, metric).numpy()
        want = np.asarray(J.rowwise_distance(x, q, metric))
        if metric == "Cosine":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        else:
            np.testing.assert_array_equal(got, want)
