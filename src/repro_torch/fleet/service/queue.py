"""Request queue with coalescing for the planning control plane.

Plan requests are reads of the freshest fleet plan: K requests arriving
between two ticks do not need K engine calls — they share the single
(drift-gated) replan the next tick performs and all receive that tick's
plan snapshot.  :class:`CoalescingQueue` is the thread-safe mailbox that
makes this explicit: ``submit`` enqueues a :class:`PlanRequest` handle,
the service's tick ``drain``\\ s everything pending and resolves each
group with one shared response.
"""
from __future__ import annotations

import threading
import time


class PlanRequest:
    """Handle for one in-flight plan request (resolved by the tick loop)."""

    def __init__(self, key):
        self.key = key
        self.t_submit = time.perf_counter()
        self.response: dict | None = None
        self._event = threading.Event()

    def resolve(self, response: dict) -> float:
        """Attach the response; returns the request's latency in ms."""
        self.response = response
        self._event.set()
        return (time.perf_counter() - self.t_submit) * 1e3

    def ready(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> dict:
        """Block until the serving tick resolves this request."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"plan request {self.key} not served "
                               f"within {timeout}s")
        assert self.response is not None
        return self.response


class CoalescingQueue:
    """Thread-safe pending-request mailbox, grouped by coalescing key."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: dict[object, list[PlanRequest]] = {}

    def submit(self, key) -> PlanRequest:
        req = PlanRequest(key)
        with self._lock:
            self._pending.setdefault(key, []).append(req)
        return req

    def drain(self) -> dict[object, list[PlanRequest]]:
        """Atomically take everything pending (the tick serves it all)."""
        with self._lock:
            groups, self._pending = self._pending, {}
        return groups

    def __len__(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())
