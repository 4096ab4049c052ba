"""Span timing: nested context managers over the ``span_ms`` histogram.

``span("decode_search")`` is the workhorse: when the layer is armed it
observes the span's wall duration into the ``span_ms`` histogram
(labelled by span name).  When disarmed, ``span()`` returns a shared
no-op singleton -- no allocation, no clock read, no lock.

Device time is strictly opt-in: ``sp.fence(x)`` marks a torch tensor whose
device to synchronize at span exit, and the fence only fires when the
layer is armed, so instrumentation can never add a host sync to an
uninstrumented run.

``now()`` is the raw clock for code that needs a timestamp across scopes.
Counterpart of ``repro/obs/trace.py`` without its trace ring and profiler
hook, which come with the serving slice.
"""

from __future__ import annotations

import time

from . import metrics as _m

__all__ = ["NULL_SPAN", "Span", "Timer", "now", "span", "timer"]


def now() -> float:
    """Monotonic wall clock (seconds)."""
    return time.perf_counter()


class Span:
    """Armed span: wall time always, device time via opt-in fence()."""

    __slots__ = ("name", "labels", "_t0", "_fence")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self._fence = None

    def fence(self, x) -> None:
        """Synchronize ``x``'s device at span exit so the span covers
        device time."""
        self._fence = x

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._fence is not None:
            dev = getattr(self._fence, "device", None)
            if dev is not None and dev.type == "cuda":
                import torch

                torch.cuda.synchronize(dev)
            self._fence = None
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        _m.REGISTRY.histogram("span_ms", span=self.name, **self.labels).observe(
            dur_ms
        )
        return False


class _NullSpan:
    """Disarmed singleton: every method is a constant no-op."""

    __slots__ = ()

    def fence(self, x) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


def span(name: str, **labels):
    """Open a span; returns the shared no-op singleton when disarmed."""
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
