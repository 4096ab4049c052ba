"""Continuous-batching async top-k serving loop.

Counterpart of ``repro/serving/loop.py``.  One asyncio task
(``serve_forever``) alternates between two states:

* **forming** -- wait until the :class:`BatchFormer` says a wave should
  fire (full batch, linger timeout, or an imminent deadline), admitting
  requests the whole time;
* **serving** -- pop the wave, pad it to its pow2 bucket with empty
  queries (shape reuse across waves), and run ONE
  ``TopKEngine.topk_batch`` call.  Admission continues while the engine
  runs -- the next wave forms from everything that arrived meanwhile,
  which is what makes the loop *continuous* batching rather than
  fixed-size batching.

The engine call runs in a worker thread (``asyncio.to_thread``), so the
event loop keeps admitting, shedding and expiring while a wave is on the
engine; the reference calls the engine on the event loop itself, where
arrivals wait out the whole wave.  One wave runs at a time (``drain`` and
``serve_forever`` take the same lock), so the engine is never called
concurrently.  The engine stays on whatever device it was built for: the
server never moves it and picks no device of its own.  A wave whose
engine call raises fails its requests with that error and re-raises it
out of ``serve_forever`` / ``drain``.

Backpressure: the queue is bounded.  ``submit`` AWAITS space (the
caller's send loop slows to the service rate -- closed-loop clients
self-throttle), ``try_submit`` raises :class:`QueueFull` instead (open-
loop producers shed).  Both outcomes are counted.

Every wave publishes through ``repro_torch.obs`` (armed or not -- the
gauges are cheap): queue depth, wave occupancy, wave latency,
per-request end-to-end latency, deadline misses.  The metric names are
the reference's (``docs/metrics.md``).
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass

import numpy as np

from .. import obs
from .batcher import BatchFormer


class QueueFull(RuntimeError):
    """try_submit refused: the request queue is at max_queue."""


@dataclass
class ServeResult:
    """One request's outcome.  ``expired`` results carry empty doc/score
    arrays: the deadline passed before a wave served the request, so the
    engine never ran for it."""

    docs: np.ndarray
    scores: np.ndarray
    expired: bool
    wait_s: float     # admission -> wave formation
    service_s: float  # wave formation -> result (0.0 when expired)

    @property
    def latency_s(self) -> float:
        return self.wait_s + self.service_s


_EMPTY = (np.zeros(0, np.int64), np.zeros(0, np.float64))


class AsyncTopKServer:
    """Continuous-batching front for a ``TopKEngine``.

    Parameters mirror the ``launch.serve --loop`` flags: ``max_batch``
    wave cap, ``max_queue`` backpressure bound, ``max_delay_s`` linger,
    ``default_deadline_s`` per-request SLO (math.inf = none).  ``clock``
    is injectable for tests."""

    def __init__(
        self,
        engine,
        k: int = 10,
        max_batch: int = 64,
        max_queue: int = 1_024,
        max_delay_s: float = 2e-3,
        default_deadline_s: float = math.inf,
        clock=time.monotonic,
    ):
        self.engine = engine
        self.k = int(k)
        self.former = BatchFormer(
            max_batch=max_batch, max_queue=max_queue, max_delay_s=max_delay_s
        )
        self.default_deadline_s = float(default_deadline_s)
        self.clock = clock
        self.stats = {
            "served": 0,
            "expired": 0,
            "late": 0,
            "shed": 0,
            "backpressure_waits": 0,
            "padded_queries": 0,
        }
        self._wake = asyncio.Event()
        self._space = asyncio.Event()
        self._space.set()
        self._serving = asyncio.Lock()  # one wave on the engine at a time
        self._closed = False
        self._task: asyncio.Task | None = None

    # ---- client side ------------------------------------------------
    def _admit(self, query, deadline_s: float | None):
        now = self.clock()
        ttl = self.default_deadline_s if deadline_s is None else deadline_s
        fut = asyncio.get_running_loop().create_future()
        req = self.former.push(
            list(query), now, deadline=now + ttl, payload=fut
        )
        if req is not None:
            self._wake.set()
        return req, fut

    async def submit(self, query, deadline_s: float | None = None):
        """Admit one query and await its :class:`ServeResult`.  When the
        queue is full, WAIT for space (backpressure: the submitter runs
        at the service rate)."""
        while True:
            req, fut = self._admit(query, deadline_s)
            if req is not None:
                return await fut
            self.stats["backpressure_waits"] += 1
            obs.count("serve_backpressure_waits")
            self._space.clear()
            await self._space.wait()

    async def try_submit(self, query, deadline_s: float | None = None):
        """Admit or raise :class:`QueueFull` (open-loop shedding)."""
        req, fut = self._admit(query, deadline_s)
        if req is None:
            self.stats["shed"] += 1
            obs.count("serve_requests", kind="shed")
            raise QueueFull(f"queue at max_queue={self.former.max_queue}")
        return await fut

    # ---- serving loop -----------------------------------------------
    def _resolve(self, req, result: ServeResult) -> None:
        fut = req.payload
        if not fut.done():
            fut.set_result(result)
        obs.observe("serve_request_ms", result.latency_s * 1e3)
        obs.count(
            "serve_requests", kind="expired" if result.expired else "done"
        )

    async def _run_wave(self) -> bool:
        """Form and serve one wave; False when the queue was idle."""
        async with self._serving:
            t_form = self.clock()
            batch, expired, bucket = self.former.take(t_form)
            if self.former.depth < self.former.max_queue:
                self._space.set()
            for req in expired:
                self.stats["expired"] += 1
                obs.count("serve_deadline_misses", kind="expired")
                self._resolve(req, ServeResult(
                    *_EMPTY, expired=True,
                    wait_s=t_form - req.enqueued, service_s=0.0,
                ))
            if not batch:
                return False
            queries = [req.query for req in batch]
            if bucket > len(batch):
                self.stats["padded_queries"] += bucket - len(batch)
                queries += [[] for _ in range(bucket - len(batch))]
            obs.observe("serve_wave_occupancy", len(batch) / max(bucket, 1))
            try:
                with obs.timer("serve_wave_ms", engine="topk"):
                    outs = await asyncio.to_thread(
                        self.engine.topk_batch, queries, self.k
                    )
            except Exception as e:
                for req in batch:
                    if not req.payload.done():
                        req.payload.set_exception(e)
                raise
            t_done = self.clock()
            for req, (docs, scores) in zip(batch, outs):
                self.stats["served"] += 1
                if req.deadline < t_done:
                    self.stats["late"] += 1
                    obs.count("serve_deadline_misses", kind="late")
                self._resolve(req, ServeResult(
                    docs, scores, expired=False,
                    wait_s=t_form - req.enqueued,
                    service_s=t_done - t_form,
                ))
            obs.set_gauge("serve_queue_depth", self.former.depth)
            return True

    async def serve_forever(self) -> None:
        """Run waves until :meth:`close`.  Between waves the loop yields
        to admissions; idle it sleeps on the wake event."""
        while not self._closed:
            now = self.clock()
            if self.former.ready(now):
                await self._run_wave()
                await asyncio.sleep(0)  # let submitters enqueue/resolve
                continue
            linger = self.former.linger_remaining(now)
            self._wake.clear()
            if self.former.depth:
                # half-formed wave: sleep out the linger window, but wake
                # early if admissions could complete the batch
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=linger)
                except asyncio.TimeoutError:
                    pass
            else:
                obs.set_gauge("serve_queue_depth", 0)
                await self._wake.wait()

    # ---- lifecycle --------------------------------------------------
    async def __aenter__(self):
        self._task = asyncio.ensure_future(self.serve_forever())
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def drain(self) -> None:
        """Serve until the queue is empty (pending futures resolved).
        Fires waves immediately -- draining does not honor the linger."""
        while self.former.depth:
            await self._run_wave()
            await asyncio.sleep(0)

    async def close(self) -> None:
        """Drain outstanding requests, then stop ``serve_forever`` (whose
        error, if a wave failed, re-raises here)."""
        try:
            await self.drain()
        finally:
            self._closed = True
            self._wake.set()
            task, self._task = self._task, None
            if task is not None:
                try:
                    await task
                except asyncio.CancelledError:
                    pass
