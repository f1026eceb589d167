"""Async settle jobs: in-memory store + background execution + TTL purge
(reference cloud/app/jobs.py:22-247).

Jobs run on a daemon worker thread (the device does the heavy lifting, so the
GIL is irrelevant); quota/monthly caps are charged at execution time, exactly
like the reference (jobs.py:81-94).
"""

from __future__ import annotations

import os
import queue
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional

__all__ = ["JobStore"]


def _job_ttl() -> float:
    try:
        return float(os.getenv("OSCILLINK_JOB_TTL", "600"))
    except ValueError:
        return 600.0


class JobStore:
    def __init__(self) -> None:
        self._jobs: Dict[str, dict] = {}
        # (priority, seq): priority-tier jobs (enterprise `priority_queue`
        # feature) dequeue ahead of normal ones; seq keeps FIFO within a
        # class.  The reference defines the flag but never consumes it —
        # here it actually reorders the queue.
        self._queue: "queue.PriorityQueue[tuple[int, int, str, Callable[[], dict]]]" = (
            queue.PriorityQueue()
        )
        self._seq = 0
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- worker ------------------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run_loop, name="oscillink-jobs", daemon=True
                )
                self._worker.start()

    def _run_loop(self) -> None:
        while True:
            _, _, job_id, fn = self._queue.get()
            with self._lock:
                # the status check and the running transition are one
                # atomic step vs cancel(): otherwise a DELETE landing
                # between them confirms cancellation yet the job still
                # runs (and charges quota)
                job = self._jobs.get(job_id)
                if job is None or job.get("status") == "cancelled":
                    continue
                job["status"] = "running"
                job["started_at"] = time.time()
            try:
                result = fn()
                job["status"] = "done"
                job["result"] = result
            except BaseException as e:  # noqa: BLE001 — a SystemExit from
                # job code must not kill the worker thread and strand every
                # queued job in 'running'/'queued' forever
                job["status"] = "error"
                job["error"] = str(e) or type(e).__name__
            finally:
                job["finished_at"] = time.time()

    # -- public API ----------------------------------------------------------

    def submit(
        self,
        fn: Callable[[], dict],
        meta: Optional[dict] = None,
        *,
        priority: bool = False,
    ) -> dict:
        self.purge()
        job_id = uuid.uuid4().hex
        rec: dict[str, Any] = {
            "id": job_id,
            "status": "queued",
            "submitted_at": time.time(),
            "priority": bool(priority),
            "result": None,
            "error": None,
            **(meta or {}),
        }
        with self._lock:
            self._jobs[job_id] = rec
            self._seq += 1
            seq = self._seq
        self._ensure_worker()
        self._queue.put((0 if priority else 1, seq, job_id, fn))
        return rec

    def get(self, job_id: str) -> Optional[dict]:
        return self._jobs.get(job_id)

    def cancel(self, job_id: str) -> Optional[dict]:
        with self._lock:  # atomic vs the worker's queued->running step
            job = self._jobs.get(job_id)
            if job is None:
                return None
            if job["status"] == "queued":
                job["status"] = "cancelled"
            return job

    def depth(self) -> int:
        with self._lock:
            return sum(
                1
                for j in list(self._jobs.values())
                if j["status"] in ("queued", "running")
            )

    def purge(self) -> None:
        now = time.time()
        ttl = _job_ttl()
        with self._lock:
            stale = [
                jid
                for jid, j in list(self._jobs.items())
                if j["status"] in ("done", "error", "cancelled")
                and now - (j.get("finished_at") or j["submitted_at"]) > ttl
            ]
            for jid in stale:
                self._jobs.pop(jid, None)
