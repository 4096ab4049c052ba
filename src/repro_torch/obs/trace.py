"""Span tracing: nested context managers over a ring-buffered trace log.

``span("decode_search")`` is the workhorse: when the layer is armed it
records a {name, start, wall duration, nesting depth, thread} event into
a bounded ring and observes the duration into the ``span_ms`` histogram
(labelled by span name).  When disarmed, ``span()`` returns a shared
no-op singleton -- no allocation, no clock read, no lock.

A span times the host's wall clock only: it never synchronizes a device,
so an armed span adds no host sync either (the reference's ``fence``,
which would, has no counterpart here; device time is the profiler's).

``now()`` is the raw clock for code that needs a timestamp across scopes.
``profile(logdir)`` wraps ``torch.profiler`` around a region when the
layer is armed.  Counterpart of ``repro/obs/trace.py``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

from . import metrics as _m

__all__ = [
    "NULL_SPAN",
    "Span",
    "Timer",
    "clear",
    "event",
    "events",
    "now",
    "profile",
    "span",
    "timer",
]

TRACE_CAPACITY = 4096
_RING: deque = deque(maxlen=TRACE_CAPACITY)
_EPOCH = time.perf_counter()
_TLS = threading.local()


def now() -> float:
    """Monotonic wall clock (seconds)."""
    return time.perf_counter()


def events() -> list:
    """Snapshot of the trace ring, oldest first."""
    return list(_RING)


def clear() -> None:
    _RING.clear()


def event(name: str, **fields) -> None:
    """Record a discrete event (health transition, failover, ...) iff armed."""
    if _m.enabled():
        rec = {"kind": "event", "name": name, "t_s": now() - _EPOCH}
        rec.update(fields)
        _RING.append(rec)


class Span:
    """Armed span: the host's wall time from entry to exit."""

    __slots__ = ("name", "labels", "_t0", "_depth")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels

    def __enter__(self):
        depth = getattr(_TLS, "depth", 0)
        _TLS.depth = depth + 1
        self._depth = depth
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        _TLS.depth = self._depth
        dur_ms = (t1 - self._t0) * 1e3
        rec = {
            "kind": "span",
            "name": self.name,
            "start_s": self._t0 - _EPOCH,
            "dur_ms": dur_ms,
            "depth": self._depth,
            "thread": threading.current_thread().name,
        }
        if self.labels:
            rec.update(self.labels)
        _RING.append(rec)
        _m.REGISTRY.histogram("span_ms", span=self.name, **self.labels).observe(
            dur_ms
        )
        return False


class _NullSpan:
    """Disarmed singleton: every method is a constant no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


def span(name: str, **labels):
    """Open a trace span; returns the shared no-op singleton when disarmed."""
    if _m.enabled():
        return Span(name, labels)
    return NULL_SPAN


class Timer:
    """Always measures wall time (``.elapsed_s``); records the sample into
    the registry histogram only when the layer is armed.  For call sites
    that need the elapsed time regardless (serve.py latency lines)."""

    __slots__ = ("name", "labels", "elapsed_s", "_t0")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.elapsed_s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.elapsed_s = time.perf_counter() - self._t0
        if _m.enabled():
            _m.REGISTRY.histogram(self.name, **self.labels).observe(
                self.elapsed_s * 1e3
            )
        return False


def timer(name: str, **labels) -> Timer:
    """Wall-clock timer; histogram names take a ``_ms`` suffix by convention."""
    return Timer(name, labels)


@contextlib.contextmanager
def profile(logdir: str):
    """Trace the region with ``torch.profiler`` when the layer is armed and
    write it as a Chrome trace to ``<logdir>/trace.json``.

    CPU activity always, CUDA activity too when the process sees a card.
    Disarmed, a no-op that touches neither torch nor the filesystem.  An
    error of the profiler while armed propagates."""
    if not _m.enabled():
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    # picks what the profiler records, not where anything runs
    if torch.cuda.is_available():  # analyze: allow
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
