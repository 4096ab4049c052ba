"""Deadline-aware batch former.

Counterpart of ``repro/serving/batcher.py``, the same in behaviour.  Pure
and clock-free: every method takes ``now`` explicitly, so the wave
semantics -- admission, linger, expiry, pow2 bucketing, backpressure --
are unit-testable without sleeping (tests/test_torch_serving.py drives it
with a hand-rolled clock).  :mod:`repro_torch.serving.loop` owns the real
clock and the asyncio plumbing.

Wave formation contract:

* requests pop in EARLIEST-DEADLINE order (a heap), so a tight-deadline
  request never strands behind a lax one admitted earlier;
* a request whose deadline has already passed when the wave forms is
  EXPIRED out (returned separately, never served) -- serving it would
  burn a wave slot on an answer nobody is waiting for;
* a wave fires when ``max_batch`` requests are queued or the oldest
  admission has lingered ``max_delay_s`` (the latency/occupancy trade:
  docs/serving.md);
* the queue is bounded at ``max_queue`` -- ``push`` refuses beyond it,
  and the server turns that refusal into backpressure (await) or load
  shedding (reject), caller's choice.

pow2 bucket reuse: each wave reports the pow2 bucket that covers it
(capped at ``max_batch``).  The server pads the wave to the bucket with
empty queries, so across waves the engine sees a handful of distinct
batch shapes instead of one per occupancy -- the same shape-stability
move as ``engine_core.pow2_bucket`` one level down.  ``stats`` counts
how often a wave's bucket was already seen (``bucket_hits`` / ``waves``
is the reuse ratio an operator should watch).
"""

from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Any


def pow2_wave(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at ``cap`` (cap need not be a
    power of two; an over-cap wave buckets to exactly cap)."""
    b = 1 << max(n - 1, 0).bit_length()
    return min(b, cap)


@dataclass(order=True)
class Request:
    """One admitted query.  Orders by (deadline, seq): heap ties break
    FIFO.  ``payload`` carries whatever the server attached (asyncio
    future, arrival timestamps); the former never looks inside."""

    deadline: float
    seq: int
    query: Any = field(compare=False)
    enqueued: float = field(compare=False, default=0.0)
    payload: Any = field(compare=False, default=None)


class BatchFormer:
    def __init__(
        self,
        max_batch: int = 64,
        max_queue: int = 1_024,
        max_delay_s: float = 2e-3,
    ):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_delay_s = float(max_delay_s)
        self._heap: list[Request] = []
        self._seq = itertools.count()
        self._since = math.inf  # enqueue time starting the current linger
        self.stats = {
            "admitted": 0,
            "refused": 0,
            "expired": 0,
            "waves": 0,
            "full_waves": 0,
            "bucket_hits": 0,
        }
        self._buckets_seen: set[int] = set()

    @property
    def depth(self) -> int:
        return len(self._heap)

    @property
    def full(self) -> bool:
        return len(self._heap) >= self.max_queue

    def push(self, query, now: float, deadline: float = math.inf,
             payload=None) -> Request | None:
        """Admit a request; None when the queue is at ``max_queue`` (the
        server decides whether that means backpressure or shedding)."""
        if self.full:
            self.stats["refused"] += 1
            return None
        req = Request(
            deadline=deadline, seq=next(self._seq), query=query,
            enqueued=now, payload=payload,
        )
        if not self._heap:
            self._since = now
        heapq.heappush(self._heap, req)
        self.stats["admitted"] += 1
        return req

    def ready(self, now: float) -> bool:
        """A wave should fire: full batch queued, the linger window has
        elapsed, or the earliest deadline is already at/past ``now``
        (waiting any longer could only expire it)."""
        if not self._heap:
            return False
        return (
            len(self._heap) >= self.max_batch
            or now - self._since >= self.max_delay_s
            or self._heap[0].deadline <= now
        )

    def linger_remaining(self, now: float) -> float:
        """Seconds until ``ready`` flips by timeout alone (inf on an
        empty queue) -- the server's idle-sleep bound."""
        if not self._heap:
            return math.inf
        if len(self._heap) >= self.max_batch:
            return 0.0
        return max(
            0.0,
            min(
                self._since + self.max_delay_s,
                self._heap[0].deadline,
            ) - now,
        )

    def take(self, now: float):
        """Form one wave: ``(batch, expired, bucket)``.

        Pops up to ``max_batch`` live requests in deadline order;
        requests already past deadline are expired out (they do not
        consume wave slots -- expiry mid-queue can therefore drain MORE
        than max_batch entries, which is exactly the load-shedding an
        overloaded queue needs).  ``bucket`` is the pow2 pad target for
        the batch (0 for an all-expired take).  An empty queue returns
        ``([], [], 0)`` -- draining idle is a no-op, not an error."""
        batch: list[Request] = []
        expired: list[Request] = []
        while self._heap and len(batch) < self.max_batch:
            if self._heap[0].deadline < now:
                expired.append(heapq.heappop(self._heap))
                continue
            batch.append(heapq.heappop(self._heap))
        self.stats["expired"] += len(expired)
        if not batch:
            if not self._heap:
                self._since = math.inf
            return batch, expired, 0
        self.stats["waves"] += 1
        if len(batch) == self.max_batch:
            self.stats["full_waves"] += 1
        bucket = pow2_wave(len(batch), self.max_batch)
        if bucket in self._buckets_seen:
            self.stats["bucket_hits"] += 1
        else:
            self._buckets_seen.add(bucket)
        # requests remain: the linger window restarts at this wave
        self._since = now if self._heap else math.inf
        return batch, expired, bucket
