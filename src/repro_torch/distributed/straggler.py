"""Straggler mitigation (host-side simulation).

Counterpart of ``repro/distributed/straggler.py``.

At 1000+ nodes the p99 host determines step time.  The watchdog tracks a
rolling median step time and flags steps slower than ``threshold x median``.
Flagged steps are recorded; the launcher can drop a persistent
straggler's data shard (re-assigning it round-robin) -- simulated here by
the ``reassign`` callback.
"""

from __future__ import annotations

import statistics
from collections import deque


class StragglerWatchdog:
    def __init__(self, window: int = 50, threshold: float = 3.0, reassign=None):
        self.window = deque(maxlen=window)
        self.threshold = threshold
        self.events: list[tuple[int, float, float]] = []
        self.reassign = reassign

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        med = statistics.median(self.window) if len(self.window) >= 8 else None
        self.window.append(duration_s)
        if med is not None and duration_s > self.threshold * med:
            self.events.append((step, duration_s, med))
            if self.reassign is not None:
                self.reassign(step)
            return True
        return False

    @property
    def median(self) -> float:
        return statistics.median(self.window) if self.window else 0.0
