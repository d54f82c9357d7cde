"""Foreman: the server-side task broker for external workers.

JAX counterpart: ``fluidframework_tpu/service/foreman.py``; the port's copy,
imports rebased to this package.

Ref: lambdas/src/foreman (lambda.ts:21) + services messageSender.ts —
the reference assigns agent tasks (snapshot/intel/translation) to a pool
of external workers (Paparazzi / headless agents) over RabbitMQ, tracks
worker heartbeats, and reassigns the tasks of a dead worker
(foreman/README.md). The queueing transport here is a callable per
worker (the in-proc twin of the AMQP channel); everything else — the
registry, heartbeat expiry, at-most-one live assignment per task,
reassignment, and stale-completion rejection — is the broker logic
itself.

Relationship to runtime/agent_scheduler.py: the scheduler elects one
CLIENT of a document for a task through the data plane (consensus
register); the foreman hands work to processes that are NOT document
clients at all — the task farm.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

DEFAULT_WORKER_TIMEOUT = 30.0


@dataclass
class _Worker:
    worker_id: str
    dispatch: Callable[[dict], None]
    last_heartbeat: float
    assigned: set = field(default_factory=set)


@dataclass
class _Task:
    task_id: str
    payload: Any
    worker_id: Optional[str] = None  # current live assignment
    attempts: int = 0
    done: bool = False
    result: Any = None


class Foreman:
    def __init__(self, clock: Callable[[], float] = time.time,
                 worker_timeout: float = DEFAULT_WORKER_TIMEOUT,
                 logger=None):
        self._clock = clock
        self._timeout = worker_timeout
        self._log = logger
        self._workers: dict[str, _Worker] = {}
        self._tasks: dict[str, _Task] = {}
        self._queue: list[str] = []  # unassigned task ids, FIFO
        self._rr = itertools.cycle([])  # rebuilt on membership change
        self.reassignments = 0

    # ------------------------------------------------------------- workers

    def register_worker(self, worker_id: str,
                        dispatch: Callable[[dict], None]) -> None:
        self._workers[worker_id] = _Worker(
            worker_id, dispatch, self._clock())
        self._drain()

    def heartbeat(self, worker_id: str) -> None:
        w = self._workers.get(worker_id)
        if w is not None:
            w.last_heartbeat = self._clock()

    def check_workers(self) -> None:
        """Expire silent workers and requeue their in-flight tasks (the
        reassign-on-worker-death path, foreman/README.md)."""
        now = self._clock()
        for worker_id in [
            w.worker_id for w in self._workers.values()
            if now - w.last_heartbeat > self._timeout
        ]:
            self._drop_worker(worker_id)
        self._drain()

    def _drop_worker(self, worker_id: str) -> None:
        w = self._workers.pop(worker_id, None)
        if w is None:
            return
        if self._log is not None:
            self._log.error("worker_expired", worker_id=worker_id,
                            inflight=len(w.assigned))
        for task_id in w.assigned:
            task = self._tasks[task_id]
            task.worker_id = None
            self._queue.append(task_id)
            self.reassignments += 1

    # --------------------------------------------------------------- tasks

    def enqueue(self, task_id: str, payload: Any) -> None:
        if task_id in self._tasks and not self._tasks[task_id].done:
            return  # already queued or running
        self._tasks[task_id] = _Task(task_id, payload)
        self._queue.append(task_id)
        self._drain()

    def complete(self, worker_id: str, task_id: str, result: Any) -> bool:
        """A worker reports a result. Stale completions — from a worker
        whose assignment was revoked after heartbeat expiry — are
        REFUSED: the task may already be running elsewhere, and the
        revoked worker must not overwrite the live attempt's outcome."""
        task = self._tasks.get(task_id)
        if task is None or task.done or task.worker_id != worker_id:
            return False
        task.done = True
        task.result = result
        task.worker_id = None
        w = self._workers.get(worker_id)
        if w is not None:
            w.assigned.discard(task_id)
        return True

    def result(self, task_id: str) -> Any:
        task = self._tasks.get(task_id)
        return task.result if task is not None and task.done else None

    def pending_count(self) -> int:
        return sum(1 for t in self._tasks.values() if not t.done)

    # ------------------------------------------------------------ internal

    def _drain(self) -> None:
        """Assign queued tasks to the least-loaded live workers."""
        while self._queue and self._workers:
            task = self._tasks[self._queue.pop(0)]
            if task.done or task.worker_id is not None:
                continue
            w = min(self._workers.values(), key=lambda w: len(w.assigned))
            task.worker_id = w.worker_id
            task.attempts += 1
            w.assigned.add(task.task_id)
            w.dispatch({"task_id": task.task_id, "payload": task.payload,
                        "attempt": task.attempts})
