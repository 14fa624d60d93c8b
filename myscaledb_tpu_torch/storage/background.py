"""Copy of myscaledb_tpu/storage/background.py (JAX-free; imports renamed
to this package).

Background task executor for storage maintenance.

Reference analog: MergeTreeBackgroundExecutor
(src/Storages/MergeTree/MergeTreeBackgroundExecutor.h:250) — a fixed thread
pool executing merge/mutate/index-build quanta off the query path, selected
per scheduling round by StorageMergeTree::scheduleDataProcessingJob
(src/Storages/StorageMergeTree.cpp:1311).  Here: a small thread pool + task
queue; the part-set commit protocol (atomic rename under the store lock)
makes concurrent queries see a consistent snapshot, so INSERT-heavy
workloads never serialize on merges.
"""

from __future__ import annotations

import queue
import threading
import traceback

from myscaledb_tpu_torch.runtime import metrics as M

TASKS_SCHEDULED = "BackgroundTasksScheduled"
TASKS_COMPLETED = "BackgroundTasksCompleted"
TASKS_FAILED = "BackgroundTasksFailed"


class BackgroundExecutor:
    """Fixed-size worker pool draining a FIFO of storage tasks."""

    def __init__(self, threads: int = 2, name: str = "bg"):
        self._q: queue.Queue = queue.Queue()
        self._threads = []
        self._stop = threading.Event()
        self._inflight = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        for i in range(threads):
            t = threading.Thread(target=self._worker,
                                 name=f"{name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self):
        while not self._stop.is_set():
            try:
                task = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                task()
                M.increment(TASKS_COMPLETED)
            except Exception:
                M.increment(TASKS_FAILED)
                traceback.print_exc()
            finally:
                with self._lock:
                    self._inflight -= 1
                    if self._inflight == 0 and self._q.empty():
                        self._idle.notify_all()
                self._q.task_done()

    def schedule(self, task) -> None:
        with self._lock:
            self._inflight += 1
        M.increment(TASKS_SCHEDULED)
        self._q.put(task)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until every scheduled task has finished (tests/shutdown)."""
        with self._lock:
            if self._inflight == 0 and self._q.empty():
                return True
            return self._idle.wait(timeout)

    def shutdown(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)


_default: BackgroundExecutor | None = None
_default_lock = threading.Lock()


def default_executor() -> BackgroundExecutor:
    global _default
    with _default_lock:
        if _default is None:
            _default = BackgroundExecutor()
        return _default
