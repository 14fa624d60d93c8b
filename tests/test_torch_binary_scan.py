"""K5 on the CPU: the port's ``binary_segment_mins`` (its plain version,
since the tensors lie on the CPU) against the JAX package's Pallas kernel
run under ``pltpu.force_tpu_interpret_mode()``, on the same numpy inputs:
Hamming and Jaccard, with and without a mask, with a tail of rows past n.
Integer scores, a float minimum and an IEEE division are exact in any
order, so the two must be bit-equal.  Also the layouts (``pack_binary``,
``to_segs_layout``) and the two-pass segment scan (``_binary_scan_segs``,
K5 then the exact rescore) against the JAX row-major scan."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myscaledb_tpu.ops import binary_vector as JBV
from myscaledb_tpu.ops.pallas.binary_scan import (
    binary_segment_mins as jax_segment_mins)
from myscaledb_tpu_torch.interop import binary_sidecar_from_numpy
from myscaledb_tpu_torch.ops import binary_vector as PBV
from myscaledb_tpu_torch.ops.kernels.binary_scan import (
    SEG, binary_segment_mins, popcount32)

torch.set_num_threads(1)


def _u32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("words,nq", [(8, 3), (2, 1)])
@pytest.mark.parametrize("metric", ["Hamming", "Jaccard"])
@pytest.mark.parametrize("has_mask", [False, True])
def test_plain_is_bit_equal_to_the_pallas_kernel(words, nq, metric,
                                                 has_mask):
    r = np.random.default_rng(words * 10 + nq)
    nseg = 16                                 # one JAX grid step
    x3 = r.integers(0, 1 << 32, (nseg, words, SEG), dtype=np.uint32)
    x3[0, :, :7] = 0                          # empty unions for Jaccard
    x3[2, :, 3] = 0xFFFFFFFF
    qw = r.integers(0, 1 << 32, (nq, words), dtype=np.uint32)
    mask2 = (r.random((nseg, SEG)) < 0.5).astype(np.uint8)
    mask2[5] = 0                              # a fully masked segment
    n = nseg * SEG - 1500                     # the last segments are a tail
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_segment_mins(jnp.asarray(x3), jnp.asarray(qw),
                                           jnp.asarray(mask2), metric, n,
                                           has_mask))
    got = binary_segment_mins(_u32(x3), _u32(qw), torch.from_numpy(mask2),
                              metric, n, has_mask)
    assert got.dtype == torch.float32 and got.shape == (nseg, nq)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_popcount32_matches_numpy():
    r = np.random.default_rng(3)
    x = r.integers(0, 1 << 32, 10_000, dtype=np.uint32)
    x[:3] = [0, 0xFFFFFFFF, 0x80000000]
    want = np.unpackbits(x.view(np.uint8).reshape(-1, 4), axis=1).sum(1)
    np.testing.assert_array_equal(popcount32(_u32(x)).numpy(), want)


def test_layouts_are_bit_equal():
    r = np.random.default_rng(4)
    raws = [bytes(r.integers(0, 256, int(r.integers(0, 8)),
                             dtype=np.uint8)) for _ in range(3000)]
    raws += [b"\xff" * 9, "caf\xe9", "€"]     # long, latin-1, replaced
    for nbytes in (5, 8):
        np.testing.assert_array_equal(PBV.pack_binary(raws, nbytes),
                                      JBV.pack_binary(raws, nbytes))
        np.testing.assert_array_equal(PBV.pack_binary_segs(raws, nbytes),
                                      JBV.pack_binary_segs(raws, nbytes))
    same = [bytes(r.integers(0, 256, 6, dtype=np.uint8)) for _ in range(50)]
    for rows in (same, [s.decode("latin-1") for s in same]):
        np.testing.assert_array_equal(PBV.pack_binary(rows, 6),
                                      JBV.pack_binary(rows, 6))
    x3 = JBV.pack_binary_segs(same, 6)
    assert torch.equal(binary_sidecar_from_numpy(x3, "cpu"), _u32(x3))


@pytest.mark.parametrize("metric", ["Hamming", "Jaccard"])
def test_segment_scan_equals_the_jax_row_scan(metric):
    """The two-pass scan the card runs (K5's plain version, then the
    rescore), on the CPU, against the JAX package's row-major scan: equal
    ids and bit-equal distances, ties by id, masked rows and a tail."""
    r = np.random.default_rng(12)
    n, words, nq, k = 3 * SEG + 17, 2, 4, 9
    xw = r.integers(0, 1 << 32, (n, words), dtype=np.uint32)
    xw[::5] = xw[0]                             # ties
    qw = r.integers(0, 1 << 32, (nq, words), dtype=np.uint32)
    mask = r.random(n) < 0.6
    x3 = PBV.to_segs_layout(xw)
    for m in (None, mask):
        want_d, want_i = JBV.binary_distance_scan(
            jnp.asarray(xw), jnp.asarray(qw), metric, k,
            mask=None if m is None else jnp.asarray(m))
        got_d, got_i = PBV._binary_scan_segs(
            _u32(x3), _u32(qw), metric, k,
            None if m is None else torch.from_numpy(m), n)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_d.numpy().view(np.int32),
                                      np.asarray(want_d).view(np.int32))
