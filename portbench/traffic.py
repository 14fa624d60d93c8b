"""The one generator of statements: a traffic file's templates filled from
the seed.

A traffic file (``traffic/<name>.json``) holds:

- ``clients``: closed-loop clients against the one session;
- ``statements``: each with ``name``, ``weight``, ``sql`` and ``params``.
  ``{q}`` in ``sql`` is a new query vector of the configuration's data for
  every statement, as a SQL array literal; other ``{key}`` fields come from
  ``params``, where ``{"share_of_rows": r}`` stands for
  ``int(rows * r)``;
- ``rounds``: rounds in the sequence, each holding every statement
  ``weight`` times in an order drawn from the seed; the phases of a run
  consume them in turn, and a run that reaches the end starts again;
- ``warmup_rounds``: rounds run before the window, over query vectors of
  their own;
- ``trace_statements``, ``sync_statements``: statements of the traced
  phase and of the host-sync count (``--trace 1``), whole rounds each:
  both start at a round's start.

Every seed gives the same statements and sizes in another order, with
other vectors.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field


@dataclass
class Statement:
    name: str
    text: str
    params: dict = field(default_factory=dict)   # with ``q_index`` if any


def vector_literal(values) -> str:
    """A float32 vector as a SQL array literal.  ``repr`` of each value as
    a Python float is exact, so the program parses the very vector the
    reference reads."""
    return "[" + ",".join(map(repr, values)) + "]"


def _params(spec: dict, cfg: dict) -> dict:
    out = {}
    for key, value in spec.get("params", {}).items():
        if isinstance(value, dict) and "share_of_rows" in value:
            value = int(int(cfg["rows"]) * float(value["share_of_rows"]))
        out[key] = value
    return out


def sequence(tr: dict, seed: int, rounds: int) -> list:
    """Indexes into ``tr["statements"]``: ``rounds`` rounds, each holding
    statement ``i`` ``weight`` times, each round shuffled by the seed."""
    rng = random.Random(seed)
    one = [i for i, s in enumerate(tr["statements"])
           for _ in range(int(s["weight"]))]
    out = []
    for _ in range(rounds):
        r = list(one)
        rng.shuffle(r)
        out.extend(r)
    return out


def vectors_needed(tr: dict) -> tuple:
    """(vectors a round uses, vectors the warm-up uses)."""
    per_round = sum(int(s["weight"]) for s in tr["statements"]
                    if "{q}" in s["sql"])
    return (per_round * int(tr["rounds"]),
            per_round * int(tr.get("warmup_rounds", 1)))


def build(tr: dict, cfg: dict, seed: int, queries) -> tuple:
    """(warm-up statements, the run's statements).  ``queries`` is the
    data's (m, d) float32 query tensor, or None where no statement takes a
    vector; the warm-up takes the vectors after the run's."""
    n_run, n_warm = vectors_needed(tr)
    host_q = queries.cpu() if queries is not None else None
    counter = [0]

    def render(spec, qi_base):
        p = _params(spec, cfg)
        if "{q}" in spec["sql"]:
            qi = qi_base + counter[0]
            counter[0] += 1
            p["q_index"] = qi
            p["q"] = vector_literal(host_q[qi].tolist())
        text = spec["sql"].format(**p)
        p.pop("q", None)
        return Statement(spec["name"], text, p)

    specs = tr["statements"]
    run = [render(specs[i], 0)
           for i in sequence(tr, seed, int(tr["rounds"]))]
    counter[0] = 0
    warm = [render(specs[i], n_run)
            for i in sequence(tr, seed + 1, int(tr.get("warmup_rounds", 1)))]
    return warm, run
