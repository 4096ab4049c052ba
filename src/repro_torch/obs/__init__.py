"""repro_torch.obs -- counters and span timing (off by default).

Arm with ``REPRO_OBS=1`` or ``obs.enable()``.  Counterpart of the subset of
``repro.obs`` the boolean-AND and ranked paths call; the trace ring, the
exporters and the HTTP server come with the serving slice.
"""

from .metrics import (
    REGISTRY,
    Counter,
    CounterDict,
    Gauge,
    Histogram,
    Registry,
    count,
    enable,
    enabled,
    reset,
    set_gauge,
)
from .trace import NULL_SPAN, Span, Timer, now, span, timer

__all__ = [
    "REGISTRY",
    "Counter",
    "CounterDict",
    "Gauge",
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
    "set_gauge",
    "span",
    "timer",
]
