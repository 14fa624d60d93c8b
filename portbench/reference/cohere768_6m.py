"""Plain reference of the filtered exact top-k by cosine distance.

It reads the same generated tensors that the program was handed (the id
column and the embeddings) and nothing the program derived: it computes
the norms, the filter and the top-k itself.  Candidates are chosen by a
float32 product with TF32 off, ``EXTRA`` more than k; they are then
rescored in float64 and ranked by (distance, id).  The float32 error of a
cosine distance here is near 1e-7, far below the gap of ``EXTRA`` ranks,
so the float64 top-k lies among the candidates.

``judge`` compares each statement's rows with the reference:

- ``bad_statements``: statements whose rows are not k rows of distinct ids
  that pass the filter, in ascending order of distance (ties by id);
- ``max_dist_err``: the widest gap between a returned distance and the
  float64 distance of the returned id;
- ``max_gap``: the widest gap, rank by rank, between the float64 distance
  of the returned id and the reference's float64 distance at that rank:
  how far the returned rows lie from the exact top-k.

``control_rows`` is the reference put in the program's place one precision
below float32: TF32, its inputs rounded to a 10-bit mantissa and the
products summed in float32.  Nothing here imports the program.
"""

from __future__ import annotations

import contextlib

import torch

EXTRA = 32
QUERY_BLOCK = 64
ROW_BLOCK = 1 << 20


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _inputs(data):
    (cols,) = data["tables"].values()
    return cols["id"], cols["emb"], data["queries"]


def _scores(x, ids, qb, id_mins, inv_xn, tf32: bool):
    """(len(qb), n) float32 cosine distances, rows the filter drops +inf."""
    n = x.shape[0]
    out = torch.empty((qb.shape[0], n), dtype=torch.float32, device=x.device)
    qn = qb / torch.linalg.vector_norm(qb, dim=1, keepdim=True)
    if tf32:
        qn = to_tf32(qn)
    for lo in range(0, n, ROW_BLOCK):
        hi = min(n, lo + ROW_BLOCK)
        xb = to_tf32(x[lo:hi]) if tf32 else x[lo:hi]
        out[:, lo:hi] = 1.0 - (qn @ xb.T) * inv_xn[lo:hi]
    out.masked_fill_(ids[None, :] < id_mins[:, None], torch.inf)
    return out


def _dist64(x, ids_row, q):
    """float64 cosine distances of rows ``ids_row`` (m, r) to q (m, d)."""
    xc = x[ids_row].double()
    qd = q.double()
    dot = (xc * qd[:, None, :]).sum(-1)
    return 1.0 - dot / (torch.linalg.vector_norm(xc, dim=-1)
                        * torch.linalg.vector_norm(qd, dim=-1)[:, None])


def _by_value_then_id(vals, ids):
    """Sort each row by (value, id)."""
    o = torch.argsort(ids, dim=1, stable=True)
    vals, ids = torch.gather(vals, 1, o), torch.gather(ids, 1, o)
    o = torch.argsort(vals, dim=1, stable=True)
    return torch.gather(vals, 1, o), torch.gather(ids, 1, o)


def _blocks(items):
    for lo in range(0, len(items), QUERY_BLOCK):
        yield items[lo:lo + QUERY_BLOCK]


def _block_queries(block, queries):
    qi = torch.tensor([p["q_index"] for p, _ in block],
                      device=queries.device)
    id_mins = torch.tensor([int(p["id_min"]) for p, _ in block],
                           device=queries.device)
    return queries[qi], id_mins


def _inv_norms(x):
    return 1.0 / torch.cat([torch.linalg.vector_norm(x[lo:lo + ROW_BLOCK],
                                                     dim=1)
                            for lo in range(0, x.shape[0], ROW_BLOCK)])


def judge(cfg: dict, data: dict, items: list) -> dict:
    """``items``: (params, rows) of every statement that came back.
    Returns {"numbers": {...}, "wrong": statements outside a limit}."""
    ids, x, queries = _inputs(data)
    limits = cfg["limits"]
    bad = wrong = 0
    max_err = max_gap = 0.0
    with no_tf32():
        inv_xn = _inv_norms(x)
        for block in _blocks(items):
            q, id_mins = _block_queries(block, queries)
            k = int(block[0][0]["k"])
            s = _scores(x, ids, q, id_mins, inv_xn, tf32=False)
            cand = torch.topk(s, min(k + EXTRA, s.shape[1]), dim=1,
                              largest=False).indices
            del s
            ref_d, _ = _by_value_then_id(_dist64(x, cand, q), ids[cand])
            ref_d = ref_d[:, :k]
            for j, (p, rows) in enumerate(block):
                got = torch.tensor([r[0] for r in rows], dtype=torch.int64,
                                   device=x.device)
                got_d = torch.tensor([r[1] for r in rows],
                                     dtype=torch.float64, device=x.device)
                ok_shape = (len(rows) == k and got.unique().numel() == k
                            and bool((got >= int(p["id_min"])).all())
                            and bool((got < x.shape[0]).all()))
                if ok_shape:
                    order = sorted(range(k), key=lambda i: (rows[i][1],
                                                            rows[i][0]))
                    ok_shape = order == list(range(k))
                if not ok_shape:
                    bad += 1
                    wrong += 1
                    continue
                row_of = got          # ids are row numbers (id = row)
                d64 = _dist64(x, row_of[None, :], q[j:j + 1])[0]
                err = float((got_d - d64).abs().max())
                gap = float((d64 - ref_d[j]).max())
                max_err, max_gap = max(max_err, err), max(max_gap, gap)
                if err > limits["max_dist_err"] or gap > limits["max_gap"]:
                    wrong += 1
    return {"numbers": {"bad_statements": bad, "max_dist_err": max_err,
                        "max_gap": max_gap}, "wrong": wrong}


def control_rows(cfg: dict, data: dict, items: list) -> list:
    """The rows of each statement as the reference computes them in TF32
    (the control): the k best by TF32 distance, ties by id."""
    ids, x, queries = _inputs(data)
    out = []
    with no_tf32():
        inv_xn = _inv_norms(x)
        for block in _blocks(items):
            q, id_mins = _block_queries(block, queries)
            k = int(block[0][0]["k"])
            s = _scores(x, ids, q, id_mins, inv_xn, tf32=True)
            top = torch.topk(s, min(k + EXTRA, s.shape[1]), dim=1,
                             largest=False)
            d, i = _by_value_then_id(top.values, ids[top.indices])
            for j in range(len(block)):
                out.append(list(zip(i[j, :k].tolist(), d[j, :k].tolist())))
    return out
