"""Work-sharing scheduler for checker worker threads.

A mutex-protected list of job batches plus a condition variable. ``pop`` blocks
until work arrives or every worker is idle (global quiescence, at which point
the market closes so all workers shut down). ``split_and_push`` shares surplus
local work with idle workers. A worker that dies (exception) closes the market
via ``close`` so the remaining workers drain out instead of hanging.

Reference design: ``JobBroker``/``JobMarket`` at
``src/job_market.rs``. The port's copy of the JAX package's
``checker/job_market.py``, shared by the host engines (``bfs``, ``dfs``,
``on_demand``); the GPU checker's frontier lives in its chunk queue and
device ring instead (``checker/gpu.py``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Generic, List, TypeVar

Job = TypeVar("Job")


class JobBroker(Generic[Job]):
    def __init__(self, thread_count: int):
        self._cond = threading.Condition()
        self._open = True
        self._thread_count = thread_count
        self._open_count = thread_count
        self._job_batches: List[Deque[Job]] = []

    def pop(self) -> Deque[Job]:
        """Pop a batch of jobs; blocks. Empty result means no more jobs are
        coming (market closed)."""
        with self._cond:
            if not self._open:
                return deque()
            while True:
                if self._job_batches:
                    return self._job_batches.pop()
                self._open_count = max(0, self._open_count - 1)
                if self._open_count == 0:
                    # Last running thread: quiescence. Close and wake everyone.
                    self._open = False
                    self._cond.notify_all()
                    return deque()
                self._cond.wait()
                if not self._open:
                    return deque()
                self._open_count += 1

    def push(self, jobs: Deque[Job]) -> None:
        with self._cond:
            if not self._open:
                return
            self._job_batches.append(jobs)
            self._cond.notify()

    def split_and_push(self, jobs: Deque[Job]) -> None:
        """Split local surplus into 1 + min(idle_threads, len) pieces, keeping
        the first piece locally and publishing the rest."""
        with self._cond:
            if not self._open:
                jobs.clear()
                return
            idle = max(0, self._thread_count - self._open_count)
            pieces = 1 + min(idle, len(jobs))
            size = len(jobs) // pieces
            for _ in range(1, pieces):
                if size == 0:
                    continue
                to_share = deque()
                for _ in range(size):
                    to_share.appendleft(jobs.pop())
                self._job_batches.append(to_share)
                self._cond.notify()

    def close(self) -> None:
        """Close the market (worker finished or died): drop all queued work and
        wake all waiting workers so they exit."""
        with self._cond:
            self._open = False
            self._job_batches.clear()
            self._open_count = max(0, self._open_count - 1)
            self._cond.notify_all()

    def is_closed(self) -> bool:
        with self._cond:
            return (
                not self._open
                and not self._job_batches
                and self._open_count == 0
            )
