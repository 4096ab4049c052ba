"""Process-local metrics registry: counters, gauges, log-linear histograms.

Counterpart of ``repro/obs/metrics.py``.  Zero-dependency (stdlib only).
The whole layer is off by default: the ``REPRO_OBS`` environment variable
(or :func:`enable`) arms it, and every instrumentation helper
(:func:`count`, :func:`observe`, ``CounterDict``) collapses to a cheap
boolean check when disarmed.  Nothing in this
module touches torch or numpy, so instrumenting a resident query path can
never add a host sync.

Naming scheme: ``<subsystem>_<what>[_<unit>]`` in snake_case, unit suffix
``_ms`` / ``_bytes`` / ``_s`` for non-count metrics.  Labels are for
*bounded* dimensions only (backend, shard id, phase name) -- never query
ids or document ids.  The names follow the reference's catalogue
(``docs/metrics.md``) name for name; ``catalogue.md`` beside this module
lists the port's own.
"""

from __future__ import annotations

import bisect
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
    "counter",
    "enable",
    "enabled",
    "gauge",
    "histogram",
    "observe",
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
    """Last-write-wins scalar (theta trajectory, queue depth, ...)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def add(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


# log-linear bucketing: SUBS linear sub-buckets per power-of-ten decade,
# covering 1e-3 .. 1e9 (sub-microsecond spans in ms up to multi-GB byte
# totals).  Boundaries are upper-inclusive (`le`, Prometheus convention).
_SUBS = 8
_DECADE_LO = -3
_DECADE_HI = 9
_BOUNDS: list = []
for _d in range(_DECADE_LO, _DECADE_HI):
    _step = 9.0 * (10.0**_d) / _SUBS
    for _j in range(1, _SUBS + 1):
        _BOUNDS.append(10.0**_d + _j * _step)
_N_BUCKETS = len(_BOUNDS) + 1  # +1 overflow

# exact-percentile ring: raw samples kept up to this cap, after which the
# readout falls back to bucket interpolation (bounded memory, long runs)
RAW_CAP = 4096


class Histogram:
    """Fixed-bucket log-linear histogram with exact small-N percentiles.

    ``observe()`` is O(log buckets); the raw-sample ring gives *exact*
    p50/p90/p99/p99.9 until RAW_CAP samples, then interpolated from the
    log-linear buckets (<= 12.5% relative error per sub-bucket).
    """

    __slots__ = (
        "name",
        "labels",
        "_counts",
        "_raw",
        "_count",
        "_sum",
        "_min",
        "_max",
        "_lock",
    )

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._counts = [0] * _N_BUCKETS
        self._raw: list = []
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        v = float(v)
        i = bisect.bisect_left(_BOUNDS, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._raw) < RAW_CAP:
                self._raw.append(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

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

    def percentile(self, q: float) -> float:
        """Percentile readout: exact while the raw ring holds every sample,
        log-linear bucket interpolation afterwards."""
        with self._lock:
            if self._count == 0:
                return 0.0
            if self._count <= len(self._raw):
                return self.percentile_of(self._raw, q)
            counts = list(self._counts)
            total = self._count
        # bucket interpolation on a snapshot of the counts
        rank = (q / 100.0) * (total - 1)
        seen = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c > rank:
                lo = _BOUNDS[i - 1] if i > 0 else max(0.0, self._min)
                hi = _BOUNDS[i] if i < len(_BOUNDS) else self._max
                frac = (rank - seen) / c
                return float(lo + (hi - lo) * frac)
            seen += c
        return float(self._max)

    def summary(self) -> dict:
        """Snapshot dict used by the JSON exporter."""
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "p999": self.percentile(99.9),
        }

    def buckets(self) -> list:
        """(upper_bound, cumulative_count) pairs for Prometheus export."""
        out = []
        cum = 0
        with self._lock:
            counts = list(self._counts)
        for b, c in zip(_BOUNDS, counts):
            cum += c
            if c:
                out.append((b, cum))
        out.append((math.inf, cum + counts[-1]))
        return out


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


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def count(name: str, n=1, **labels) -> None:
    """Increment a counter iff the layer is armed; no-op constant otherwise."""
    if _ENABLED:
        REGISTRY.counter(name, **labels).inc(n)


def observe(name: str, v, **labels) -> None:
    """Record a histogram sample iff the layer is armed."""
    if _ENABLED:
        REGISTRY.histogram(name, **labels).observe(v)


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
