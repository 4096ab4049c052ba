"""repro_torch.obs -- metrics, span tracing, profiling and export.

Off by default; arm with ``REPRO_OBS=1`` or ``obs.enable()``.  Counterpart
of ``repro.obs``: the same API and metric names (``docs/metrics.md`` is
the catalogue, which the port follows name for name; the spans and
counters only the port has are in ``catalogue.md`` beside this module).

Quick tour::

    from repro_torch import obs

    obs.enable()
    obs.count("engine_cache_hits", backend="torch")
    with obs.span("decode_search", path="ranked"):
        ...
    with obs.timer("serve_batch_ms") as t:
        ...
    print(t.elapsed_s, obs.histogram("serve_batch_ms").percentile(99))
    print(obs.render_prometheus())
"""

from .metrics import (
    REGISTRY,
    Counter,
    CounterDict,
    Gauge,
    Histogram,
    Registry,
    count,
    counter,
    enable,
    enabled,
    gauge,
    histogram,
    observe,
    set_gauge,
)
from .metrics import reset as _reset_metrics
from .trace import (
    NULL_SPAN,
    Span,
    Timer,
    event,
    events,
    now,
    profile,
    span,
    timer,
)
from .trace import clear as clear_trace
from .export import diff, render_prometheus, snapshot, write_snapshot
from .server import MetricsServer

__all__ = [
    "REGISTRY",
    "Counter",
    "CounterDict",
    "Gauge",
    "Histogram",
    "MetricsServer",
    "NULL_SPAN",
    "Registry",
    "Span",
    "Timer",
    "clear_trace",
    "count",
    "counter",
    "diff",
    "enable",
    "enabled",
    "event",
    "events",
    "gauge",
    "histogram",
    "now",
    "observe",
    "profile",
    "render_prometheus",
    "reset",
    "set_gauge",
    "snapshot",
    "span",
    "timer",
    "write_snapshot",
]


def reset() -> None:
    """Drop all metrics and the trace ring (tests / benches)."""
    _reset_metrics()
    clear_trace()
