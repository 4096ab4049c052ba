"""Process-local metrics registry: counters and histograms.

Counterpart of the subset of ``repro/obs/metrics.py`` the boolean-AND
and ranked paths use (the bucketed exporters come with the serving
slice).  Zero-dependency (stdlib only).  The whole layer is off by
default: the ``REPRO_OBS`` environment variable (or :func:`enable`) arms
it, and every instrumentation helper (:func:`count`, ``CounterDict``)
collapses to a cheap boolean check when disarmed.  Nothing in this
module touches torch or numpy, so instrumenting a resident query path can
never add a host sync.

Naming scheme: ``<subsystem>_<what>[_<unit>]`` in snake_case, unit suffix
``_ms`` / ``_bytes`` / ``_s`` for non-count metrics.  Labels are for *bounded* dimensions only (backend, shard id,
phase name) -- never query ids or document ids.
"""

from __future__ import annotations

import math
import os
import threading

__all__ = [
    "Counter",
    "CounterDict",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "count",
    "enable",
    "enabled",
    "reset",
    "set_gauge",
]

_ENABLED = os.environ.get("REPRO_OBS", "0") not in ("", "0", "false", "off")


def enabled() -> bool:
    """True when the observability layer is armed."""
    return _ENABLED


def enable(on: bool = True) -> None:
    """Arm (or disarm) the layer programmatically, overriding REPRO_OBS."""
    global _ENABLED
    _ENABLED = bool(on)


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonic counter (floats allowed: byte totals, fractional credits)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    add = inc

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins scalar (the ranked engine's theta trajectory)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value


class Histogram:
    """Sample count and sum of one timed quantity."""

    __slots__ = ("name", "labels", "_count", "_sum", "_lock")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        with self._lock:
            self._count += 1
            self._sum += float(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @staticmethod
    def percentile_of(xs, q: float) -> float:
        """Linear-interpolated percentile of a raw sample list.

        The one implementation behind the ``launch.serve`` latency lines.
        """
        xs = sorted(xs)
        if not xs:
            return 0.0
        if len(xs) == 1:
            return float(xs[0])
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


class Registry:
    """Keyed store of metrics; one per process (module-level REGISTRY)."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict):
        key = (cls.__name__, name, _labelkey(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[2])
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def items(self):
        return sorted(self._metrics.items())

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()


def count(name: str, n=1, **labels) -> None:
    """Increment a counter iff the layer is armed; no-op constant otherwise."""
    if _ENABLED:
        REGISTRY.counter(name, **labels).inc(n)


def set_gauge(name: str, v, **labels) -> None:
    """Set a gauge iff the layer is armed."""
    if _ENABLED:
        REGISTRY.gauge(name, **labels).set(v)


def reset() -> None:
    """Drop every metric (tests and benches)."""
    REGISTRY.clear()


class CounterDict(dict):
    """Drop-in ``stats`` dict that mirrors numeric increments to counters.

    Engines historically expose a bare ``self.stats`` dict; tests and
    callers read it directly.  CounterDict keeps that contract intact
    (it IS a dict) while mirroring every numeric delta onto a registry
    counter named ``<prefix>_<key>`` when the layer is armed.  Non-numeric
    values pass through untouched.
    """

    __slots__ = ("_prefix", "_labels")

    def __init__(self, prefix: str, initial=None, **labels):
        super().__init__(initial or {})
        self._prefix = prefix
        self._labels = labels

    def __setitem__(self, key, value) -> None:
        if _ENABLED and isinstance(value, (int, float)) and not isinstance(value, bool):
            old = self.get(key, 0)
            if isinstance(old, (int, float)) and not isinstance(old, bool):
                delta = value - old
                if delta:
                    REGISTRY.counter(f"{self._prefix}_{key}", **self._labels).inc(delta)
        super().__setitem__(key, value)
