"""Closed-loop clients against one session.

Each client sends a statement through ``Session.sql_as(None, text)`` (the
entry every wire server calls), reads its rows back with ``to_rows()``,
and only then sends its next one.  A statement's latency runs from the
moment it is sent until its rows are on the host.  Clients take the
run's statements in sequence order from one shared counter."""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class Done:
    pos: int                  # the statement's place in the run's sequence
    t_send: float             # time.perf_counter()
    t_done: float
    rows: Optional[list]
    error: Optional[str]
    phase: str
    wall_sql: float = 0.0     # time.time() when sql_as returned, and when
    wall_done: float = 0.0    # the rows were back (the traced phase's labels)
    client: int = 0           # which of the phase's clients sent it


class Sequence:
    """The run's statements, handed out in order across phases."""

    def __init__(self, statements):
        self.statements = statements
        self._next = itertools.count()
        self.consumed = 0

    def take(self) -> int:
        pos = next(self._next)
        self.consumed = pos + 1
        return pos

    def text(self, pos: int) -> str:
        return self.statements[pos % len(self.statements)].text

    def align(self, round_len: int) -> None:
        """Skip to the start of the next round, so that a phase of whole
        rounds holds each statement its weight's times."""
        while self.consumed % round_len:
            self.take()


def run_phase(session, seq: Sequence, clients: int, phase: str,
              seconds: Optional[float] = None, count: Optional[int] = None,
              after_each=None):
    """Run clients until ``seconds`` have passed (no statement is sent
    after that) or ``count`` statements were sent.  Every statement sent is
    waited for.  Returns (records, t_open, t_close) in perf_counter
    seconds; t_close is when the window closed (``seconds``) or when the
    last statement came back (``count``)."""
    lock = threading.Lock()
    sent = [0]
    records = []
    t_open = time.perf_counter()
    t_end = t_open + seconds if seconds is not None else None

    def client(me: int):
        while True:
            with lock:
                if count is not None and sent[0] >= count:
                    return
                t = time.perf_counter()
                if t_end is not None and t >= t_end:
                    return
                sent[0] += 1
                pos = seq.take()
            text = seq.text(pos)
            t_send = time.perf_counter()
            rows = err = None
            wq = 0.0
            try:
                res = session.sql_as(None, text)
                wq = time.time()
                rows = res.to_rows()
            except Exception as e:          # a failure is a result too
                err = f"{type(e).__name__}: {e}"[:500]
            t_done = time.perf_counter()
            rec = Done(pos, t_send, t_done, rows, err, phase, wq, time.time(),
                       me)
            with lock:
                records.append(rec)
            if after_each is not None:
                after_each()

    if clients == 1:
        client(0)
    else:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    t_close = t_end if t_end is not None else time.perf_counter()
    records.sort(key=lambda r: r.pos)
    return records, t_open, t_close
