"""repro_torch.obs -- counters and span timing (off by default).

Arm with ``REPRO_OBS=1`` or ``obs.enable()``.  Counterpart of the subset of
``repro.obs`` the boolean-AND path calls; gauges, the trace ring, the
exporters and the HTTP server come with the serving slice.
"""

from .metrics import (
    REGISTRY,
    Counter,
    CounterDict,
    Histogram,
    Registry,
    count,
    enable,
    enabled,
    reset,
)
from .trace import NULL_SPAN, Span, Timer, now, span, timer

__all__ = [
    "REGISTRY",
    "Counter",
    "CounterDict",
    "Histogram",
    "NULL_SPAN",
    "Registry",
    "Span",
    "Timer",
    "count",
    "enable",
    "enabled",
    "now",
    "reset",
    "span",
    "timer",
]
