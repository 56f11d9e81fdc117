"""Async request scheduler: single-flight coalescing + admission control.

The high-traffic shape (GQ-Fast's observation) is many small concurrent
requests, most of them identical: N users asking for the same
(model, method, algorithm) at the same epoch.  The scheduler makes that
cheap in two ways:

* **Coalescing** — requests are keyed by their work identity; while a
  future for a key is in flight, every further submit for the same key
  *joins* it instead of enqueueing redundant work.  K concurrent identical
  requests execute exactly once and share the result object.
* **Admission control** — in-flight work is bounded by the worker pool and
  the pending queue is bounded by ``max_queue``; a submit that finds the
  queue full is rejected immediately with a ``retry_after`` hint
  (EWMA of recent service time × queue depth) instead of growing memory
  without bound.  Load shedding happens at the door, not by OOM.

Graceful degradation on top:

* **Deadlines** — ``submit(key, fn, deadline_s=...)`` bounds how long a
  request may wait.  Admission is deadline-aware (work whose estimated
  queue wait already exceeds its budget is rejected at the door, not
  enqueued to die), and an expired waiter is cancelled at worker pickup
  instead of executing — both paths fail the future with
  :class:`DeadlineExceeded` and count
  ``serving_deadline_exceeded_total``.
* **Drain on close** — :meth:`close` stops admission, lets in-flight work
  complete, and fails every queued-but-unstarted future fast with a
  structured :class:`ServiceClosed`.  No follower future is ever left
  unresolved: futures are owner-managed (the scheduler resolves them
  itself; the pool's own futures are never handed out).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Hashable, Optional, Tuple

from repro_torch import obs
from repro_torch.durability import faults

# Floors for the backoff hint and the EWMA service-time estimate: under
# clock jitter (or a sub-ms fn) the EWMA can decay toward 0, and a
# Retry-After of 0 (or less) tells a client to hammer the full queue
# immediately.  1 ms is the smallest honest "come back later".
MIN_RETRY_AFTER_S = 0.001
MIN_EWMA_S = 0.0001


class AdmissionError(RuntimeError):
    """Backpressure: the scheduler's pending queue is full.

    ``retry_after`` (seconds) estimates when capacity frees up — the HTTP
    front end maps this to ``429`` + ``Retry-After``.
    """

    def __init__(self, pending: int, max_queue: int, retry_after: float):
        super().__init__(
            f"queue full ({pending}/{max_queue} pending); "
            f"retry in ~{retry_after:.2f}s")
        self.pending = pending
        self.max_queue = max_queue
        self.retry_after = retry_after


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before its work could run.

    ``stage`` says where it died: ``"admission"`` (the estimated queue
    wait already exceeded the budget — nothing was enqueued) or
    ``"queue"`` (it waited its deadline away and was cancelled at worker
    pickup, never executed).  Maps to HTTP ``504``; retryable.
    """

    def __init__(self, deadline_s: float, stage: str,
                 retry_after: float = MIN_RETRY_AFTER_S):
        super().__init__(
            f"deadline of {deadline_s:.3f}s exceeded at {stage}")
        self.deadline_s = deadline_s
        self.stage = stage
        self.retry_after = retry_after


class ServiceClosed(RuntimeError):
    """The scheduler (or its service) is shutting down; not retryable here.

    Raised synchronously by submits after :meth:`CoalescingScheduler.close`
    and set asynchronously on every queued-but-unstarted future, so no
    caller — leader or coalesced follower — is ever left waiting on a
    future that nobody will resolve.
    """

    def __init__(self, what: str = "scheduler"):
        super().__init__(f"{what} is closed")
        self.what = what


class _Job:
    """One owner-managed unit of queued work."""

    __slots__ = ("key", "fn", "future", "t_submit", "deadline")

    def __init__(self, key: Hashable, fn: Callable[[], object],
                 t_submit: float, deadline: Optional[float]):
        self.key = key
        self.fn = fn
        self.future: Future = Future()
        self.t_submit = t_submit
        self.deadline = deadline        # absolute perf_counter time or None


class CoalescingScheduler:
    """Bounded thread-pool executor with single-flight request coalescing.

    ``submit(key, fn)`` returns a :class:`concurrent.futures.Future`.
    Futures are shared: while ``key`` is in flight, further submits return
    the same future (and bump ``coalesced``).  Once a future completes its
    key leaves the in-flight map — a later identical request re-executes
    (by then the engine caches serve it warm, which is the cheap path the
    coalescing window exists to protect during the expensive first build).
    """

    def __init__(self, max_workers: int = 4, max_queue: int = 64,
                 name: str = "serving"):
        self.max_workers = int(max_workers)
        self.max_queue = int(max_queue)
        self._pool = ThreadPoolExecutor(max_workers=self.max_workers,
                                        thread_name_prefix=name)
        self._lock = threading.Lock()
        self._inflight: Dict[Hashable, Future] = {}
        self._pending = 0            # submitted but not yet finished
        self._ewma_s = 0.05          # recent service time estimate
        self._closed = False
        self.submitted = 0
        self.coalesced = 0
        self.executed = 0
        self.rejected = 0
        self.failed = 0
        self.expired = 0             # deadline-cancelled before execution
        self.drained = 0             # failed fast with ServiceClosed
        self._depth_gauge = obs.REGISTRY.gauge(
            "serving_queue_depth",
            help="Requests submitted but not yet finished.", queue=name)
        self._ewma_gauge = obs.REGISTRY.gauge(
            "serving_ewma_service_seconds",
            help="EWMA of recent request service time.", queue=name)
        self._wait_hist = obs.REGISTRY.histogram(
            "serving_queue_wait_seconds",
            help="Submit-to-start wait in the scheduler queue.", queue=name)
        self._ewma_gauge.set(self._ewma_s)

    # -- public API ----------------------------------------------------------
    def submit(self, key: Hashable, fn: Callable[[], object],
               deadline_s: Optional[float] = None) -> Future:
        """Run ``fn`` (or join the in-flight run of ``key``); may reject."""
        return self.submit_ex(key, fn, deadline_s=deadline_s)[0]

    def submit_ex(self, key: Hashable, fn: Callable[[], object],
                  deadline_s: Optional[float] = None
                  ) -> Tuple[Future, bool]:
        """Like :meth:`submit` but also reports whether the caller *joined*
        an already-in-flight run (True) or started this one (False).

        ``deadline_s`` is this request's total wait budget.  A join shares
        the leader's future and therefore the leader's fate — the
        follower's own deadline is not enforced on the shared run.
        """
        now = time.perf_counter()
        with self._lock:
            if self._closed:
                raise ServiceClosed("scheduler")
            self.submitted += 1
            fut = self._inflight.get(key)
            if fut is not None:
                self.coalesced += 1
                return fut, True
            if self._pending >= self.max_queue:
                self.rejected += 1
                raise AdmissionError(self._pending, self.max_queue,
                                     self.retry_after())
            if deadline_s is not None:
                est_wait = self._ewma_s * (self._pending
                                           / max(1, self.max_workers))
                if est_wait > deadline_s:
                    self.rejected += 1
                    self._deadline_metric("admission")
                    raise DeadlineExceeded(deadline_s, "admission",
                                           retry_after=self.retry_after())
            job = _Job(key, fn, now,
                       None if deadline_s is None else now + deadline_s)
            self._pending += 1
            self._depth_gauge.set(self._pending)
            self._inflight[key] = job.future
            self._pool.submit(self._execute, job)
            return job.future, False

    def retry_after(self) -> float:
        """Backoff hint: expected drain time of the work ahead of you.

        Floored at :data:`MIN_RETRY_AFTER_S` — never zero or negative,
        whatever the EWMA has decayed to under clock jitter.
        """
        waves = max(1.0, self._pending / max(1, self.max_workers))
        return max(MIN_RETRY_AFTER_S, round(self._ewma_s * waves, 3))

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"submitted": self.submitted,
                    "coalesced": self.coalesced,
                    "executed": self.executed,
                    "rejected": self.rejected,
                    "failed": self.failed,
                    "expired": self.expired,
                    "drained": self.drained,
                    "closed": self._closed,
                    "inflight": len(self._inflight),
                    "pending": self._pending,
                    "max_workers": self.max_workers,
                    "max_queue": self.max_queue,
                    "ewma_service_s": round(self._ewma_s, 4)}

    def close(self, wait: bool = True) -> None:
        """Drain: in-flight work completes, queued work fails fast.

        After this returns (with ``wait=True``) every future ever handed
        out is resolved — with its result, its work's exception, or a
        :class:`ServiceClosed`.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # queued-but-unstarted jobs still reach _execute (the pool runs
        # everything already submitted); _execute sees _closed and fails
        # them with ServiceClosed immediately instead of running fn
        self._pool.shutdown(wait=wait)

    def shutdown(self, wait: bool = True) -> None:
        self.close(wait=wait)

    # -- internals -----------------------------------------------------------
    @staticmethod
    def _deadline_metric(stage: str) -> None:
        obs.failure_counter("serving_deadline_exceeded_total",
                            stage=stage).inc()

    def _finish(self, job: _Job, counter: str) -> None:
        """Drop a never-executed job out of the maps; takes the lock."""
        with self._lock:
            setattr(self, counter, getattr(self, counter) + 1)
            self._pending -= 1
            if self._inflight.get(job.key) is job.future:
                del self._inflight[job.key]
            self._depth_gauge.set(self._pending)

    def _execute(self, job: _Job) -> None:
        fut = job.future
        now = time.perf_counter()
        if self._closed and not fut.done():
            self._finish(job, "drained")
            fut.set_exception(ServiceClosed("scheduler"))
            return
        if job.deadline is not None and now > job.deadline and not fut.done():
            self._finish(job, "expired")
            self._deadline_metric("queue")
            fut.set_exception(DeadlineExceeded(
                job.deadline - job.t_submit, "queue",
                retry_after=self.retry_after()))
            return
        if not fut.set_running_or_notify_cancel():
            # the caller cancelled the future while it was queued
            self._finish(job, "expired")
            return
        self._wait_hist.observe(max(0.0, now - job.t_submit))
        t0 = time.perf_counter()
        try:
            faults.fire("scheduler.worker")
            out = job.fn()
        except BaseException as e:
            with self._lock:
                self.failed += 1
            self._settle(job, t0, error=e)
            return
        self._settle(job, t0, result=out)

    def _settle(self, job: _Job, t_start: float, result: object = None,
                error: Optional[BaseException] = None) -> None:
        dt = time.perf_counter() - t_start
        with self._lock:
            self.executed += 1
            self._pending -= 1
            if self._inflight.get(job.key) is job.future:
                del self._inflight[job.key]
            self._ewma_s = max(MIN_EWMA_S,
                               self._ewma_s + 0.25 * (dt - self._ewma_s))
            self._depth_gauge.set(self._pending)
            self._ewma_gauge.set(self._ewma_s)
        if error is not None:
            job.future.set_exception(error)
        else:
            job.future.set_result(result)
