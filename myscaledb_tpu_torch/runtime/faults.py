"""Copy of myscaledb_tpu/runtime/faults.py (JAX-free; imports renamed to
this package).

Fault injection + deterministic host-level retries.

Reference analog: ZooKeeperWithFaultInjection
(src/Common/ZooKeeper/ZooKeeperWithFaultInjection.h:41) wraps every
coordination call with seeded probabilistic failures, enabled by settings
(insert_keeper_fault_injection_probability, src/Core/Settings.h:913); the
connection layer retries by error count (PoolWithFailoverBase.h).  In this
engine the failure-prone boundaries are host-side: part IO, background
merge tasks, and the HTTP server's query execution.  The injector wraps
those sites; ``with_retries`` gives each a deterministic seeded retry loop
(same seed -> same failure pattern -> reproducible tests, the analog of the
reference's deterministic fault-injection seed).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, TypeVar

T = TypeVar("T")


class InjectedFault(RuntimeError):
    """A fault produced by the injector (never by real IO)."""


class FaultInjector:
    """Seeded probabilistic failure source, one per process.

    probability: chance that a guarded site raises InjectedFault.
    Thread-safe; per-site counters are kept for observability
    (system.metrics analog).
    """

    def __init__(self, probability: float = 0.0, seed: int = 0):
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.probability = probability
        self.injected: dict[str, int] = {}
        self.calls: dict[str, int] = {}

    def configure(self, probability: float, seed: int = 0) -> None:
        with self._lock:
            self.probability = probability
            self._rng = random.Random(seed)
            self.injected.clear()
            self.calls.clear()

    def maybe_fail(self, site: str) -> None:
        if self.probability <= 0.0:
            return
        with self._lock:
            self.calls[site] = self.calls.get(site, 0) + 1
            if self._rng.random() < self.probability:
                self.injected[site] = self.injected.get(site, 0) + 1
                raise InjectedFault(f"injected fault at {site}")


INJECTOR = FaultInjector()

# errors considered transient at host boundaries (reference: retriable
# Keeper/network error codes in ZooKeeperWithFaultInjection)
TRANSIENT = (InjectedFault, OSError, TimeoutError)


def with_retries(fn: Callable[[], T], retries: int = 3,
                 backoff_s: float = 0.0, site: str = "",
                 on_retry: Callable[[int, BaseException], None] | None = None
                 ) -> T:
    """Run fn, retrying transient failures up to `retries` times.

    Deterministic: no jitter — the retry schedule is fixed so a seeded
    injected failure pattern replays identically.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except TRANSIENT as e:
            attempt += 1
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            from myscaledb_tpu_torch.runtime import metrics as M
            M.increment(M.RETRIES)
            if backoff_s:
                time.sleep(backoff_s * attempt)
