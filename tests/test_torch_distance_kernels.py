"""K1/K2 parity on the CPU: the plain PyTorch versions of the port's
kernels (which the wrappers run for CPU tensors) against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myscaledb_tpu.ops.pallas.distance import fused_segmin_scores
from myscaledb_tpu.ops.pallas.distance_q import sq8_segmin_lower_bounds
from myscaledb_tpu.ops.vector import build_sq8 as j_build_sq8
from myscaledb_tpu_torch.interop import sq8_sidecar_from_numpy
from myscaledb_tpu_torch.ops.kernels import distance as K2
from myscaledb_tpu_torch.ops.kernels import distance_q as K1
from myscaledb_tpu_torch.ops.kernels.distance import query_aux
from myscaledb_tpu_torch.ops.vector import build_sq8

torch.set_num_threads(1)

D = 128
CASES = [(m, nq) for m in ("L2", "Cosine", "IP") for nq in (1, 3, 17)]


def _inputs(rng, n, nq):
    x = rng.standard_normal((n, D)).astype(np.float32)
    q = rng.standard_normal((nq, D)).astype(np.float32)
    mask = rng.random(n) < 0.5
    return x, q, mask


@pytest.mark.parametrize("metric,nq", CASES)
@pytest.mark.parametrize("has_mask", [True, False])
def test_segmin_f32_plain_matches_pallas(rng, metric, nq, has_mask):
    n = 4096 + 37                                   # ragged tail
    x, q, mask = _inputs(rng, n, nq)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    sqn = (xt * xt).sum(1)
    q_aux = query_aux(qt, metric)
    mask_f = torch.from_numpy(mask.astype(np.float32)) if has_mask else None
    got = K2.segmin_f32(xt, qt, sqn, q_aux, mask_f, metric)
    assert K2.segmin_f32.launches == 0             # CPU: plain version
    want = np.asarray(fused_segmin_scores(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(sqn.numpy()),
        jnp.asarray(q_aux.numpy()),
        jnp.asarray(mask.astype(np.float32)) if has_mask
        else jnp.ones((0,), jnp.float32),
        metric, has_mask, interpret=True))
    nseg = -(-n // 128)
    assert got.shape == (nq, nseg)
    np.testing.assert_allclose(got.numpy(), want[:, :nseg], rtol=1e-5,
                               atol=1e-3)


def test_segmin_f32_pallas_tile_padding_is_inf(rng):
    """The TPU kernel pads its output to whole 8192-row tiles; the port
    returns ceil(n/128) segments, and the padding it drops is all +inf."""
    n, nq = 8192 + 300, 2
    x, q, _ = _inputs(rng, n, nq)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    sqn = (xt * xt).sum(1)
    q_aux = query_aux(qt, "L2")
    got = K2.segmin_f32(xt, qt, sqn, q_aux, None, "L2")
    want = np.asarray(fused_segmin_scores(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(sqn.numpy()),
        jnp.asarray(q_aux.numpy()), jnp.ones((0,), jnp.float32), "L2",
        False, interpret=True))
    nseg = got.shape[1]
    assert nseg == 67 and want.shape[1] == 128
    assert np.isposinf(want[:, nseg:]).all()
    np.testing.assert_allclose(got.numpy(), want[:, :nseg], rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("metric,nq", CASES)
@pytest.mark.parametrize("has_mask", [True, False])
def test_segmin_sq8_plain_matches_pallas(rng, metric, nq, has_mask):
    n = 4096 + 37
    x, q, mask = _inputs(rng, n, nq)
    j_x8, j_sides = j_build_sq8(jnp.asarray(x))
    x8, sides = sq8_sidecar_from_numpy(np.asarray(j_x8), np.asarray(j_sides),
                                       "cpu")
    n_pad = x8.shape[0]
    mv = sides[3:4].clone()
    if has_mask:
        mv[0, :n] *= torch.from_numpy(mask.astype(np.float32))
    got = K1.segmin_sq8(x8, sides, torch.from_numpy(q), mv, metric)
    assert K1.segmin_sq8.launches == 0
    want = np.asarray(sq8_segmin_lower_bounds(
        j_x8, j_sides, jnp.asarray(q), jnp.asarray(mv.numpy()), metric,
        interpret=True))
    assert got.shape == want.shape == (nq, n_pad // 128)
    np.testing.assert_array_equal(np.isposinf(got.numpy()),
                                  np.isposinf(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("n", [4096 + 37, 16384 + 5])
def test_build_sq8_matches_jax(rng, n):
    x = (rng.standard_normal((n, D)) * rng.random((n, 1)) * 10) \
        .astype(np.float32)
    x[3] = 0.0                                       # all-zero row
    j_x8, j_sides = (np.asarray(a) for a in j_build_sq8(jnp.asarray(x)))
    p_x8, p_sides = build_sq8(torch.from_numpy(x))
    assert p_x8.shape == j_x8.shape and p_x8.shape[0] == \
        K1.sidecar_pad_rows(n)
    np.testing.assert_array_equal(p_x8.numpy(), j_x8)
    p_sides = p_sides.numpy()
    # scale and validity rows are bit-equal; |x|^2 and the residual norm
    # are f32 sums over d that XLA and torch take in different orders
    # (measured: up to ~20 ulp on the residual norm, ROADMAP queue 3)
    np.testing.assert_array_equal(p_sides[2:], j_sides[2:])
    np.testing.assert_allclose(p_sides[:2], j_sides[:2], rtol=1e-5)


def test_carried_jax_sidecar_gives_same_bounds(rng):
    """A sidecar built by the JAX package, carried in through interop,
    gives the bounds of the port's own sidecar."""
    n = 4096 + 37
    x, q, _ = _inputs(rng, n, 3)
    j_x8, j_sides = j_build_sq8(jnp.asarray(x))
    carried = sq8_sidecar_from_numpy(np.asarray(j_x8), np.asarray(j_sides),
                                     "cpu")
    own = build_sq8(torch.from_numpy(x))
    qt = torch.from_numpy(q)
    for metric in ("L2", "Cosine", "IP"):
        a = K1.segmin_sq8(*carried, qt, carried[1][3:4].clone(), metric)
        b = K1.segmin_sq8(*own, qt, own[1][3:4].clone(), metric)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


@pytest.mark.parametrize("d", [128, 768])
@pytest.mark.parametrize("nq", [1, 9, 128])
@pytest.mark.parametrize("metric", ["L2", "Cosine", "IP"])
def test_3xtf32_arithmetic_matches_f32_and_pallas(rng, d, nq, metric):
    """The CUDA kernel's products (three TF32 products per term, the lo.lo
    term dropped, summed per 32-dim chunk), repeated in PyTorch, give the
    segment minima of the full f32 product and of the Pallas kernel within
    the stated tolerance, with rows of large and tiny norm and a ragged n.
    The tensor cores' truncating sums inside a chunk are not repeated here:
    test_torch_cuda.py's K2 cases hold the kernel itself to the tolerance."""
    n = 2 * 128 + 45
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[::5] *= 1e3
    x[1::7] *= 1e-3
    x[2] = 0.0
    q = rng.standard_normal((nq, d)).astype(np.float32)
    mask = rng.random(n) < 0.7
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    sqn = (xt * xt).sum(1)
    q_aux = query_aux(qt, metric)
    mask_f = torch.from_numpy(mask.astype(np.float32))
    got = K2.segmin_f32_3xtf32(xt, qt, sqn, q_aux, mask_f, metric)
    plain = K2.segmin_f32_plain(xt, qt, sqn, q_aux, mask_f, metric)
    want = np.asarray(fused_segmin_scores(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(sqn.numpy()),
        jnp.asarray(q_aux.numpy()), jnp.asarray(mask.astype(np.float32)),
        metric, True, interpret=True))[:, :got.shape[1]]
    assert got.shape == (nq, 3)
    np.testing.assert_array_equal(np.isposinf(got.numpy()), np.isposinf(want))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def test_tf32_round_is_cvt_rna():
    """Round to 10 mantissa bits, ties away from zero, as cvt.rna.tf32.f32
    does; the split's halves add back to the value within 2^-22."""
    ulp = 2.0 ** -10
    a = torch.tensor([1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                      3.0, 0.0, 2.0 ** -130])
    want = [1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3.0, 0.0, 2.0 ** -130]
    assert K2.tf32_round(a).tolist() == want
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(10_000)
                         .astype(np.float32))
    hi = K2.tf32_round(x)
    lo = K2.tf32_round(x - hi)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(256, D)
    q = torch.zeros(2, D)
    sqn = torch.zeros(256)
    with pytest.raises(TypeError):
        K2.segmin_f32(x.double(), q, sqn, torch.zeros(2), None, "L2")
    with pytest.raises(ValueError):
        K2.segmin_f32(x, q, sqn[:10], torch.zeros(2), None, "L2")
    with pytest.raises(ValueError):
        K2.segmin_f32(x, torch.zeros(129, D), sqn, torch.zeros(129), None,
                      "L2")
    with pytest.raises(ValueError):
        K1.segmin_sq8(torch.zeros(200, D, dtype=torch.int8),
                      torch.zeros(4, 200), q, torch.zeros(1, 200), "L2")
    with pytest.raises(ValueError):
        K2.segmin_f32(x, q, sqn, torch.zeros(2), None, "Hamming")
