"""Traffic: how queries reach the system under test, as a traffic mix's
file describes it.

A mix (``bench/traffic/<name>.json``) sets ``op`` (``"and"``: boolean AND
through ``QueryEngine.intersect_batch``; ``"topk"``: BM25 top-``k``),
``arity``, ``pool`` (how many queries are drawn from the seed for the
window; they are sent in the pool's order, wrapping round if the window
outlasts it) and ``mode``:

* ``"batches"``: ``batch`` queries a call, one call after the other (the
  engine's own batch entry);
* ``"closed_loop"`` (``topk``): ``clients`` clients through the
  continuous-batching ``AsyncTopKServer`` (``max_batch``,
  ``max_delay_ms``, ``max_queue``), each sending its next query when its
  answer returns.

A mix that needs another pool or another way to send it adds
``bench/traffic/<name>.py`` beside its file, with ``pool(seed, cfg, mix)``
or ``serve(engine, mix, pool, warm, seconds, seed, around)`` or both, of
the signatures of ``gen.query_pool``'s use in the harness and of
``serve`` here; what it leaves out is taken from here.

``warmup`` calls or waves of queries from a pool of their own run first,
in set-up.  A window opens with the first query sent and closes at the
first answer at or after ``seconds``: every query sent before that
answer has returned, so the window holds all the work it timed.
"""

from __future__ import annotations

import asyncio
import math
import time



class Window:
    """What one window served: per request its pool index, answer,
    latency (s) and, through the server, its queue wait (s)."""

    def __init__(self):
        self.qidx: list[int] = []
        self.answers: list = []
        self.latency_s: list[float] = []
        self.wait_s: list[float] = []
        self.attempted = 0
        self.unanswered = 0
        self.units = 0  # engine calls (batches or waves)
        self.done_s: list[float] = []  # when each answer came, from t0
        self.t0 = self.t1 = 0.0
        self.server_stats: dict = {}

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def unit_seconds(self) -> list[float]:
        """The time between successive groups of answers (answers less
        than 10 ms apart are one group): for batches and full waves, each
        engine call's."""
        ends: list[float] = []
        for t in sorted(self.done_s):
            if ends and t - ends[-1] < 0.01:
                ends[-1] = t
            else:
                ends.append(t)
        return [b - a for a, b in zip([0.0] + ends, ends)]


def batches(call, pool, batch: int, seconds: float) -> Window:
    """``call(queries)`` on ``batch`` pool queries at a time until
    ``seconds`` have passed; each answer's latency is its call's."""
    w = Window()
    i = 0
    w.t0 = time.perf_counter()
    while True:
        idx = [(i + j) % len(pool) for j in range(batch)]
        ts = time.perf_counter()
        out = call([pool[j] for j in idx])
        te = time.perf_counter()
        w.attempted += len(idx)
        w.units += 1
        w.qidx += idx
        w.answers += list(out)
        w.latency_s += [te - ts] * len(idx)
        w.done_s += [te - w.t0] * len(idx)
        i += batch
        if te - w.t0 >= seconds:
            break
    w.t1 = te
    return w


def make_server(engine, mix: dict):
    from repro_torch.serving import AsyncTopKServer

    deadline = mix.get("deadline_ms")
    return AsyncTopKServer(
        engine, k=mix["k"], max_batch=mix["max_batch"],
        max_queue=mix.get("max_queue", 1024),
        max_delay_s=mix["max_delay_ms"] / 1e3,
        default_deadline_s=math.inf if deadline is None else deadline / 1e3,
    )


async def _closed(server, pool, clients: int, seconds: float, w: Window):
    end = None
    done: list[float] = []

    async def client(c: int):
        j = c
        while True:
            ts = time.perf_counter()
            if ts >= end:
                return
            q = pool[j % len(pool)]
            w.attempted += 1
            r = await server.submit(q)
            te = time.perf_counter()
            w.qidx.append(j % len(pool))
            w.answers.append((r.docs, r.scores))
            w.latency_s.append(te - ts)
            w.wait_s.append(r.wait_s)
            w.done_s.append(te - w.t0)
            done.append(te)
            j += clients

    w.t0 = time.perf_counter()
    end = w.t0 + seconds
    tasks = [asyncio.ensure_future(client(c)) for c in range(clients)]
    await asyncio.gather(*tasks)
    w.t1 = max(done) if done else time.perf_counter()


def serve(engine, mix: dict, pool, warm, seconds: float, seed: int,
          around) -> Window:
    """Run ``mix`` against ``engine``: the warm-up pool ``warm`` first,
    then the window over ``pool`` inside the context ``around()`` (which
    closes set-up and opens the harness's instruments)."""
    if mix["mode"] == "batches":
        if mix["op"] == "and":
            call = engine.intersect_batch
        else:
            def call(qs):
                return engine.topk_batch(qs, mix["k"])
        for s in range(0, len(warm), mix["batch"]):
            call(warm[s:s + mix["batch"]])
        with around():
            return batches(call, pool, mix["batch"], seconds)
    if mix["op"] != "topk":
        raise ValueError(f"mode {mix['mode']!r} serves op 'topk' only")
    w = Window()

    async def run():
        server = make_server(engine, mix)
        async with server:
            for s in range(0, len(warm), mix["max_batch"]):
                chunk = warm[s:s + mix["max_batch"]]
                await asyncio.gather(*(server.submit(q) for q in chunk))
            served0 = server.stats["served"]
            waves0 = server.former.stats["waves"]
            with around():
                if mix["mode"] != "closed_loop":
                    raise ValueError(f"unknown mode {mix['mode']!r}")
                await _closed(server, pool, mix["clients"], seconds, w)
            w.units = server.former.stats["waves"] - waves0
            w.server_stats = {
                "served": server.stats["served"] - served0,
                "waves": w.units, "max_batch": mix["max_batch"],
            }

    asyncio.run(run())
    return w
