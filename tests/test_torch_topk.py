"""k-selection parity: myscaledb_tpu_torch.ops.topk against
myscaledb_tpu.ops.topk, including the lowest-id tie rule that torch.topk
does not give."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myscaledb_tpu.ops import topk as J
from myscaledb_tpu_torch.ops import topk as P

torch.set_num_threads(1)


def test_all_tied_rows_give_lowest_ids():
    s = torch.zeros(3, 40)
    vals, idx = P.block_topk_min(s, 7)
    assert idx.tolist() == [list(range(7))] * 3
    assert (vals == 0).all()


def _draw(rng, shape, kind):
    if kind == "ties":
        return rng.integers(0, 4, shape).astype(np.float32)
    if kind == "signed_zero":
        return rng.choice(np.array([0.0, -0.0, 1.0, -1.0, np.inf],
                                   dtype=np.float32), shape)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "signed_zero"])
@pytest.mark.parametrize("k", [1, 5, 64])
def test_block_topk_min_matches_jax(rng, kind, k):
    s = _draw(rng, (4, 64), kind)
    jv, ji = J.block_topk_min(jnp.asarray(s), k)
    pv, pi = P.block_topk_min(torch.from_numpy(s), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("kind", ["random", "ties", "signed_zero"])
def test_merge_sorted_topk_matches_jax(rng, kind):
    sa = _draw(rng, (3, 20), kind)
    sb = _draw(rng, (3, 30), kind)
    ia = rng.permutation(1000)[:60].reshape(3, 20).astype(np.int32)
    ib = rng.permutation(1000)[:90].reshape(3, 30).astype(np.int32)
    ia[:, :3] = ib[:, :3]                      # duplicate ids across inputs
    js, ji = J.merge_sorted_topk(jnp.asarray(sa), jnp.asarray(ia),
                                 jnp.asarray(sb), jnp.asarray(ib), 25)
    ps, pi = P.merge_sorted_topk(torch.from_numpy(sa), torch.from_numpy(ia),
                                 torch.from_numpy(sb), torch.from_numpy(ib),
                                 25)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_total_order_key_orders_like_ieee_total_order():
    vals = np.array([np.nan, np.inf, 1.0, 0.0, -0.0, -1.0, -np.inf],
                    dtype=np.float32)
    key = P.total_order_key(torch.from_numpy(vals))
    assert torch.argsort(key).tolist() == [6, 5, 4, 3, 2, 1, 0]
