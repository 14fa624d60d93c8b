"""State derived from session data and kept between statements, built
once per mutation epoch (``session._derived``).  It touches only the
session, so every layer that keeps such state imports it from here."""

from __future__ import annotations

import weakref

import torch


def _derived(session, kind, table_name, table, col, build, epoch=None):
    """State derived from one column and kept in the session: squared
    norms (``sqnorm``), the SQ8 sidecar (``sq8``), packed binary words
    (``binary``), the BM25 index (``bm25``) and skip-index sidecars:
    ``derived_state`` keyed (kind, table, column) and alive while the
    column's data is."""
    return derived_state(session, (kind, table_name, col), table[col].data,
                         lambda: build(table[col]), epoch)


def derived_state(session, key: tuple, live, build, epoch=None):
    """One cache for everything derived from session data, keyed by
    ``key`` and the mutation epoch, with one rule: storing an entry drops
    every entry of an earlier epoch, and an entry whose ``live`` object is
    no longer the one it was built from (another table under the same
    name in the same epoch, a CTE of an earlier statement, another
    dictionary at a reused address) is built anew.  ``build()`` runs
    under the session's sidecar lock, so of two threads that want the
    same entry one builds and the other waits.

    An index build may run this on the background executor's thread: on
    the card a CUDA event recorded after the build orders the reader's
    stream after the building thread's."""
    with session.sidecar_lock:
        if epoch is None:
            epoch = session._mutation_epoch
        key = (*key, epoch)
        hit = session._derived.get(key)
        if hit is not None and hit[2]() is not live:
            hit = None
        if hit is None:
            out = build()
            done = None
            if session.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(session.device))
            hit = (out, done, weakref.ref(live))
            for k in [k for k in session._derived if k[-1] != epoch]:
                del session._derived[k]
            session._derived[key] = hit
    out, done, _ = hit
    if done is not None:
        done.wait(torch.cuda.current_stream(session.device))
    return out
