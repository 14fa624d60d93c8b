"""A dry run of every distributed path at small shapes: the port's
counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``'s multi-chip check), on ``make_mesh(n_shards)``:
one shard per visible card without a count, as the JAX package's.

It runs the operators (top-k, GROUP BY, top-n, the shuffle, both shuffle
joins, the fused config-5 step) and the SQL surface over distributed tables
(a filtered vector top-k, a GROUP BY, broadcast and shuffle joins,
TextSearch and HybridSearch against the same tables undistributed), checks
their shapes and the text searches' equality, and returns a summary.

    python -c "from myscaledb_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; print(dryrun_multichip())"
"""

from __future__ import annotations

import numpy as np
import torch


def dryrun_multichip(n_shards=None, device=None) -> dict:
    from myscaledb_tpu_torch import connect
    from myscaledb_tpu_torch.ops.sort import SortKey
    from myscaledb_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from myscaledb_tpu_torch.parallel.ops import (sharded_distance_topk,
                                                  sharded_group_aggregate,
                                                  sharded_topn)
    from myscaledb_tpu_torch.parallel.pipeline import fused_topk_join_agg
    from myscaledb_tpu_torch.parallel.shuffle import (
        sharded_shuffle_join_pairs, shuffle_by_key)

    mesh = make_mesh(n_shards, device=device)
    n_shards = mesh.size
    dev = mesh.device(0)
    n_loc, d, nq, k, G = 128, 16, 4, 5, 8
    n = n_shards * n_loc
    rng = np.random.default_rng(1)

    def put(a):
        return shard_rows(mesh, torch.as_tensor(a))

    x = put(rng.standard_normal((n, d)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32),
                        device=dev)
    price = put(rng.integers(0, 100, n).astype(np.int64))
    gid = put(rng.integers(0, G, n).astype(np.int32))
    mask = put(rng.random(n) < 0.5)

    # WHERE mask -> vector top-k; GROUP BY gid sum/count/avg(price);
    # ORDER BY price DESC LIMIT k; the all-to-all shuffle
    dist, ids = sharded_distance_topk(mesh, x, q, "L2", k, mask=mask,
                                      block_rows=64)
    states, gc = sharded_group_aggregate(
        mesh, gid, mask, (price, price, price), ("sum", "count", "avg"), G)
    top_ids = sharded_topn(mesh, [SortKey(price, ascending=False)], k)
    k_rx, (p_rx,), v_rx = shuffle_by_key(mesh, gid, (price,))
    assert int(v_rx.sum()) == n

    # shuffle joins, ANY and ALL
    rkey = put(rng.integers(0, 64, n).astype(np.int64))
    li, _ri = sharded_shuffle_join_pairs(mesh, price, rkey, how="ANY")
    li2, _ri2 = sharded_shuffle_join_pairs(mesh, price, rkey, how="ALL")
    assert len(li2) >= len(np.unique(li))
    assert dist.shape == (nq, k) and ids.shape == (nq, k)
    assert top_ids.shape == (k,)

    # the fused config-5 step
    fd, fi, fcnt, fstates, fgc = fused_topk_join_agg(
        mesh, x, q, "L2", k, price, rkey, gid, mask, price, ("sum",), G,
        block_rows=64)
    assert fd.shape == (nq, k) and int(fcnt) >= 0

    # SQL over a distributed table: the full stack
    s = connect(device=dev)
    s.create_table("t", {
        "id": np.arange(n, dtype=np.int64),
        "grp": rng.integers(0, G, n).astype(np.int32),
        "price": rng.integers(0, 100, n).astype(np.int64),
        "emb": rng.standard_normal((n, d)).astype(np.float32),
    })
    s.distribute("t", mesh)
    qv = ", ".join(str(v) for v in rng.standard_normal(d).round(3))
    r1 = s.sql(f"SELECT id, distance(emb, [{qv}]) AS dd FROM t "
               f"WHERE price > 20 ORDER BY dd LIMIT {k}")
    r2 = s.sql("SELECT grp, count(*), sum(price), avg(price) FROM t "
               "GROUP BY grp ORDER BY grp")
    # SQL joins: broadcast (a small dim side) and shuffle (both sides
    # distributed, the broadcast threshold at 0)
    s.create_table("dim", {"grp": np.arange(G, dtype=np.int32),
                           "factor": np.arange(G, dtype=np.int64) * 10})
    r3 = s.sql("SELECT t.grp, count(*) FROM t INNER JOIN dim "
               "ON t.grp = dim.grp GROUP BY t.grp ORDER BY t.grp")
    s.distribute("dim", mesh)
    r4 = s.sql("SELECT t.grp, count(*) FROM t INNER JOIN dim "
               "ON t.grp = dim.grp GROUP BY t.grp ORDER BY t.grp "
               "SETTINGS distributed_broadcast_join_threshold=0")
    assert r1.n_rows == k and r2.n_rows > 0
    assert r3.n_rows == r4.n_rows > 0

    # text and hybrid search: per-shard BM25 with global statistics and
    # per-shard vector top-k, fused at the initiator
    s.create_table("docs", {
        "id": np.arange(n, dtype=np.int64),
        "doc": np.asarray([f"term{i % 7} quick fox {i % 3}"
                           for i in range(n)], dtype=object),
        "emb": rng.standard_normal((n, d)).astype(np.float32),
    })
    text_q = ("SELECT id, TextSearch(doc, 'quick term1') AS sc FROM docs "
              "ORDER BY sc DESC LIMIT 5")
    qv2 = ", ".join(str(v) for v in rng.standard_normal(d).round(3))
    hybrid_q = (f"SELECT id, HybridSearch('fusion_type=RSF')(emb, doc, "
                f"[{qv2}], 'quick term1') AS sc FROM docs "
                "ORDER BY sc DESC LIMIT 5")
    local_t = s.sql(text_q).to_rows()
    local_h = s.sql(hybrid_q).to_rows()
    s.distribute("docs", mesh)
    assert s.sql(text_q).to_rows() == local_t, \
        "distributed TextSearch != local"
    assert s.sql(hybrid_q).to_rows() == local_h, \
        "distributed HybridSearch != local"
    return {"shards": n_shards, "devices": mesh.n_cards,
            "topk": ids[0, :3].tolist(),
            "groups": int((gc > 0).sum()),
            "sql_rows": (r1.n_rows, r2.n_rows),
            "join_pairs": (len(li), len(li2)),
            "sql_join_rows": (r3.n_rows, r4.n_rows),
            "join_count": int(fcnt)}
