"""The port's continuous-batching serving loop against the JAX package.

The reference's own tests (``tests/test_serving.py``) run here against
``repro_torch.serving`` over the port's ``TopKEngine`` on the CPU: the
batch former's wave semantics on a hand-rolled clock, and the async
server's results identical to a direct ``topk_batch``.  Then parity: a
seeded trace of pushes and takes at random times goes through both
packages' ``BatchFormer`` (same waves, expired sets, buckets and stats),
``pow2_wave`` agrees over a range, and both packages' ``AsyncTopKServer``
return the same top-k on the same corpus.  Last, what the port adds: the
engine runs off the event loop, so admission goes on during a wave, and a
wave whose engine raises fails its requests and the server.
"""

import asyncio
import math
import threading

import numpy as np
import pytest

from repro.configs import optvb_index as ref_optvb_index
from repro.core.index import build_partitioned_index as ref_build
from repro.data.postings import make_ranked_corpus as ref_make_ranked_corpus
from repro.ranked.topk_engine import TopKEngine as RefTopK
from repro.serving import AsyncTopKServer as RefServer
from repro.serving import BatchFormer as RefFormer
from repro.serving.batcher import pow2_wave as ref_pow2_wave

from repro_torch.configs import optvb_index
from repro_torch.core.index import build_partitioned_index
from repro_torch.data.postings import make_ranked_corpus
from repro_torch.ranked.topk_engine import TopKEngine
from repro_torch.serving import AsyncTopKServer, BatchFormer, QueueFull
from repro_torch.serving.batcher import pow2_wave


# ---------------------------------------------------------------------------
# batch former (pure, hand-rolled clock)
# ---------------------------------------------------------------------------

def test_pow2_wave_buckets():
    assert [pow2_wave(n, 64) for n in (0, 1, 2, 3, 4, 5, 63, 64, 65)] == [
        1, 1, 2, 4, 4, 8, 64, 64, 64,
    ]
    # cap need not be a power of two: over-cap waves bucket to exactly cap
    assert pow2_wave(7, 6) == 6


def test_empty_queue_drain_is_noop():
    f = BatchFormer()
    assert f.depth == 0 and not f.ready(0.0)
    assert f.take(0.0) == ([], [], 0)
    assert f.stats["waves"] == 0
    assert f.linger_remaining(0.0) == math.inf


def test_single_query_wave_fires_on_linger():
    f = BatchFormer(max_batch=8, max_delay_s=1.0)
    f.push([1], now=10.0)
    assert not f.ready(10.5)                # mid-linger: keep coalescing
    assert f.linger_remaining(10.5) == pytest.approx(0.5)
    assert f.ready(11.0)                    # linger elapsed
    batch, expired, bucket = f.take(11.0)
    assert [r.query for r in batch] == [[1]] and not expired
    assert bucket == 1                      # single-query wave: bucket 1
    assert f.depth == 0 and f.stats["waves"] == 1


def test_full_batch_fires_immediately():
    f = BatchFormer(max_batch=2, max_delay_s=1e9)
    f.push([1], now=0.0)
    assert not f.ready(0.0)
    f.push([2], now=0.0)
    assert f.ready(0.0) and f.linger_remaining(0.0) == 0.0
    batch, _, bucket = f.take(0.0)
    assert len(batch) == 2 and bucket == 2
    assert f.stats["full_waves"] == 1


def test_edf_pop_order_breaks_ties_fifo():
    f = BatchFormer(max_batch=4, max_delay_s=0.0)
    f.push(["lax"], now=0.0, deadline=100.0)
    f.push(["tight"], now=0.0, deadline=5.0)
    f.push(["tie-a"], now=0.0, deadline=7.0)
    f.push(["tie-b"], now=0.0, deadline=7.0)
    batch, _, _ = f.take(1.0)
    assert [r.query[0] for r in batch] == ["tight", "tie-a", "tie-b", "lax"]


def test_imminent_deadline_forces_wave():
    f = BatchFormer(max_batch=64, max_delay_s=1e9)
    f.push([1], now=0.0, deadline=2.0)
    assert not f.ready(1.0)
    # waiting past the earliest deadline could only expire it: fire now
    assert f.ready(2.0)
    assert f.linger_remaining(1.5) == pytest.approx(0.5)


def test_deadline_expiry_mid_wave_frees_slots():
    """Expired requests pop out of the wave WITHOUT consuming batch
    slots -- an overloaded queue drains more than max_batch per take."""
    f = BatchFormer(max_batch=2, max_delay_s=0.0)
    f.push(["dead-1"], now=0.0, deadline=1.0)
    f.push(["dead-2"], now=0.0, deadline=1.5)
    f.push(["live-1"], now=0.0, deadline=100.0)
    f.push(["live-2"], now=0.0, deadline=100.0)
    batch, expired, bucket = f.take(2.0)
    assert [r.query[0] for r in expired] == ["dead-1", "dead-2"]
    assert [r.query[0] for r in batch] == ["live-1", "live-2"]
    assert bucket == 2 and f.depth == 0
    assert f.stats["expired"] == 2 and f.stats["waves"] == 1


def test_all_expired_take_is_not_a_wave():
    f = BatchFormer(max_batch=4)
    f.push([1], now=0.0, deadline=1.0)
    batch, expired, bucket = f.take(5.0)
    assert batch == [] and len(expired) == 1 and bucket == 0
    assert f.stats["waves"] == 0
    # queue emptied: linger anchor resets
    assert f.linger_remaining(5.0) == math.inf


def test_bucket_reuse_across_waves():
    f = BatchFormer(max_batch=16, max_delay_s=0.0)
    for n in (3, 5, 4, 2, 6):               # occupancies 3,5,4,2,6
        for i in range(n):
            f.push([i], now=0.0)
        f.take(1.0)
    # buckets: 4, 8, 4(hit), 2, 8(hit) -> 2 hits over 5 waves
    assert f.stats["waves"] == 5
    assert f.stats["bucket_hits"] == 2


def test_push_refuses_beyond_max_queue():
    f = BatchFormer(max_queue=2)
    assert f.push([1], now=0.0) is not None
    assert f.push([2], now=0.0) is not None
    assert f.full and f.push([3], now=0.0) is None
    assert f.stats == {**f.stats, "admitted": 2, "refused": 1}


def test_linger_restarts_when_requests_remain():
    f = BatchFormer(max_batch=2, max_delay_s=1.0)
    for i in range(3):
        f.push([i], now=0.0)
    f.take(5.0)                             # pops 2, one remains
    assert f.depth == 1
    # the leftover's linger window restarts at the wave, not at admission
    assert not f.ready(5.5)
    assert f.linger_remaining(5.5) == pytest.approx(0.5)
    assert f.ready(6.0)


# ---------------------------------------------------------------------------
# async server over the port's engine on the CPU
# ---------------------------------------------------------------------------

def _corpus():
    rng = np.random.default_rng(31)
    return make_ranked_corpus(
        rng, n_lists=6, min_len=80, max_len=1_000,
        mean_dense_gap=2.13, frac_dense=0.8,
    )


@pytest.fixture(scope="module")
def engine():
    lists, freqs = _corpus()
    idx = build_partitioned_index(lists, "optimal", freqs=freqs)
    return TopKEngine(idx, device="cpu")


def _queries(engine, rng, n):
    nl = len(engine.index.list_sizes)
    return [rng.integers(0, nl, rng.integers(1, 4)).tolist()
            for _ in range(n)]


def test_server_results_identical_to_direct_batch(engine):
    queries = _queries(engine, np.random.default_rng(5), 23)
    want = engine.topk_batch(queries, 10)

    async def drive():
        async with AsyncTopKServer(
            engine, k=10, max_batch=8, max_delay_s=1e-3
        ) as server:
            return await asyncio.gather(
                *(server.submit(q) for q in queries)
            ), server

    results, server = asyncio.run(drive())
    for res, (wd, ws) in zip(results, want):
        assert not res.expired
        assert np.array_equal(res.docs, wd)
        assert np.array_equal(res.scores, ws)
        assert res.latency_s == res.wait_s + res.service_s >= 0.0
    assert server.stats["served"] == len(queries)
    assert server.former.depth == 0       # close() drained everything
    assert server.stats["padded_queries"] >= 0
    assert server.former.stats["waves"] >= 1


def test_server_expires_past_deadline_requests(engine):
    """A request admitted with an already-tiny deadline resolves as
    EXPIRED (empty arrays, engine never ran for it) once a wave forms."""
    queries = _queries(engine, np.random.default_rng(9), 4)

    async def drive():
        server = AsyncTopKServer(engine, k=10, max_batch=4,
                                 max_delay_s=0.0)
        async with server:
            dead = asyncio.ensure_future(
                server.submit(queries[0], deadline_s=-1.0)
            )
            live = await asyncio.gather(
                *(server.submit(q) for q in queries[1:])
            )
            return await dead, live, server

    dead, live, server = asyncio.run(drive())
    assert dead.expired and len(dead.docs) == 0 and dead.service_s == 0.0
    assert all(not r.expired for r in live)
    assert server.stats["expired"] == 1
    assert server.stats["served"] == len(queries) - 1


def test_try_submit_sheds_when_queue_full(engine):
    async def drive():
        server = AsyncTopKServer(engine, k=10, max_batch=2, max_queue=2,
                                 max_delay_s=1e9)
        # no serve_forever task: the queue cannot drain, so the third
        # admission must shed
        a = asyncio.ensure_future(server.try_submit([0]))
        b = asyncio.ensure_future(server.try_submit([1]))
        await asyncio.sleep(0)
        with pytest.raises(QueueFull):
            await server.try_submit([2])
        assert server.stats["shed"] == 1
        await server.drain()
        return await asyncio.gather(a, b), server

    (ra, rb), server = asyncio.run(drive())
    assert not ra.expired and not rb.expired
    assert server.former.stats["refused"] == 1


def test_submit_backpressure_waits_for_space(engine):
    """submit() on a full queue WAITS (closed-loop self-throttling) and
    completes once the serving loop frees space."""
    async def drive():
        async with AsyncTopKServer(
            engine, k=10, max_batch=2, max_queue=2, max_delay_s=0.0
        ) as server:
            out = await asyncio.gather(
                *(server.submit([i % 3]) for i in range(7))
            )
            return out, server

    out, server = asyncio.run(drive())
    assert len(out) == 7 and all(not r.expired for r in out)
    assert server.stats["served"] == 7
    assert server.stats["backpressure_waits"] >= 1
    assert server.former.stats["refused"] >= 1


def test_drain_ignores_linger(engine):
    """drain() fires waves immediately even though the linger window has
    not elapsed -- shutdown never waits out max_delay_s."""
    async def drive():
        server = AsyncTopKServer(engine, k=10, max_batch=64,
                                 max_delay_s=1e9)
        fut = asyncio.ensure_future(server.submit([0, 1]))
        await asyncio.sleep(0)
        assert server.former.depth == 1
        await server.drain()
        return await fut, server

    res, server = asyncio.run(drive())
    assert not res.expired and server.former.depth == 0


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def _trace_through(former, rng, n_ops):
    """A seeded trace of pushes (with and without deadlines) and takes at
    random times, in bursts of pushes that overfill the queue and lulls
    that drain it; returns everything the former said."""
    log, now = [], 0.0
    for step in range(n_ops):
        now += float(rng.exponential(0.01))
        burst = (step // 200) % 2 == 0
        p_push, p_ready = (0.92, 0.97) if burst else (0.3, 0.6)
        op = rng.random()
        if op < p_push:
            dl = (math.inf if rng.random() < 0.3
                  else now + float(rng.uniform(-0.01, 0.1)))
            req = former.push([int(rng.integers(0, 1_000))], now, deadline=dl)
            log.append(("push", None if req is None else req.seq,
                        former.depth, former.full))
        elif op < p_ready:
            log.append(("ready", former.ready(now),
                        former.linger_remaining(now)))
        else:
            batch, expired, bucket = former.take(now)
            log.append(("take", [(r.seq, r.query, r.deadline, r.enqueued)
                                 for r in batch],
                        [(r.seq, r.query) for r in expired], bucket))
    log.append(("stats", dict(former.stats)))
    return log


@pytest.mark.parametrize("max_batch,max_queue,max_delay_s,seed", [
    (8, 32, 0.02, 0), (64, 1_024, 2e-3, 1), (6, 10, 0.0, 2),
    (1, 4, 0.05, 3), (16, 40, 1e9, 4),
])
def test_batch_former_trace_matches_reference(max_batch, max_queue,
                                              max_delay_s, seed):
    kw = dict(max_batch=max_batch, max_queue=max_queue,
              max_delay_s=max_delay_s)
    got = _trace_through(BatchFormer(**kw), np.random.default_rng(seed), 2_000)
    want = _trace_through(RefFormer(**kw), np.random.default_rng(seed), 2_000)
    assert got == want
    stats = got[-1][1]
    assert stats["waves"] > 0 and stats["expired"] > 0
    assert stats["bucket_hits"] > 0
    if max_queue < 100:
        assert stats["refused"] > 0 and stats["full_waves"] > 0


@pytest.mark.parametrize("cap", [1, 2, 6, 7, 64, 100, 128, 257])
def test_pow2_wave_matches_reference(cap):
    assert [pow2_wave(n, cap) for n in range(301)] == [
        ref_pow2_wave(n, cap) for n in range(301)
    ]


@pytest.mark.parametrize("name", ["FULL", "SMOKE"])
def test_index_config_matches_reference(name):
    import dataclasses

    got, want = getattr(optvb_index, name), getattr(ref_optvb_index, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("resident", ["kernel", "mirror"])
def test_server_matches_reference_server(resident):
    """The same corpus (seed 31) through the reference's server over its
    numpy engine and the port's server over its CPU engine: the same
    top-k, query for query, docIDs and f64 scores exactly."""
    lists, freqs = _corpus()
    rng = np.random.default_rng(31)
    ref_lists, ref_freqs = ref_make_ranked_corpus(
        rng, n_lists=6, min_len=80, max_len=1_000,
        mean_dense_gap=2.13, frac_dense=0.8,
    )
    for a, b in zip(lists + freqs, ref_lists + ref_freqs):
        assert np.array_equal(a, b)
    ref_engine = RefTopK(ref_build(ref_lists, "optimal", freqs=ref_freqs),
                         backend="numpy", resident="kernel")
    port_engine = TopKEngine(
        build_partitioned_index(lists, "optimal", freqs=freqs),
        device="cpu", resident=resident,
    )
    queries = _queries(port_engine, np.random.default_rng(5), 40)

    async def drive(server_cls, eng):
        async with server_cls(eng, k=10, max_batch=8,
                              max_delay_s=1e-3) as server:
            return await asyncio.gather(*(server.submit(q) for q in queries))

    got = asyncio.run(drive(AsyncTopKServer, port_engine))
    want = asyncio.run(drive(RefServer, ref_engine))
    assert len(got) == len(want) == len(queries)
    for g, w in zip(got, want):
        assert not g.expired and not w.expired
        assert g.docs.dtype == w.docs.dtype and g.scores.dtype == w.scores.dtype
        assert np.array_equal(g.docs, w.docs)
        assert np.array_equal(g.scores, w.scores)


# ---------------------------------------------------------------------------
# what the port adds: the engine off the event loop
# ---------------------------------------------------------------------------

class _GatedEngine:
    """Answers every query with an empty top-k once ``gate`` opens; records
    the thread each call ran on."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.threads = []

    def topk_batch(self, queries, k):
        self.threads.append(threading.current_thread())
        self.entered.set()
        assert self.gate.wait(timeout=30)
        return [(np.zeros(0, np.int64), np.zeros(0, np.float64))
                for _ in queries]


def test_admission_continues_while_a_wave_is_on_the_engine():
    eng = _GatedEngine()

    async def drive():
        async with AsyncTopKServer(eng, k=10, max_batch=4, max_queue=3,
                                   max_delay_s=0.0) as server:
            first = asyncio.ensure_future(server.submit([0]))
            while not eng.entered.is_set():
                await asyncio.sleep(0.001)
            # the engine holds wave 1; the loop still admits and sheds
            rest = [asyncio.ensure_future(server.try_submit([i]))
                    for i in range(1, 4)]
            await asyncio.sleep(0)
            depth = server.former.depth
            with pytest.raises(QueueFull):
                await server.try_submit([9])
            eng.gate.set()
            out = await asyncio.gather(first, *rest)
            return depth, out, server

    depth, out, server = asyncio.run(drive())
    assert depth == 3 and server.stats["shed"] == 1
    assert len(out) == 4 and all(not r.expired for r in out)
    assert server.stats["served"] == 4
    assert all(t is not threading.main_thread() for t in eng.threads)


class _FailingEngine:
    def topk_batch(self, queries, k):
        raise RuntimeError("kernel launch failed")


def test_engine_error_fails_requests_and_the_server():
    async def drive():
        async with AsyncTopKServer(_FailingEngine(), k=10,
                                   max_delay_s=0.0) as server:
            await asyncio.wait_for(server.submit([0]), timeout=30)

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        asyncio.run(drive())


class _RecordingEngine:
    """Forwards to ``engine`` and records the size of every wave."""

    def __init__(self, engine):
        self.engine = engine
        self.waves = []

    def topk_batch(self, queries, k):
        self.waves.append(len(queries))
        return self.engine.topk_batch(queries, k)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scripted_waves(sizes):
    """Both packages' servers, with their defaults, an injected fake
    ``clock`` and one corpus, take bursts of ``sizes`` queries one clock
    second apart, then one request whose deadline passes before its wave.
    Returns (port, reference): each (results, the engine's wave sizes,
    server stats, former stats)."""
    lists, freqs = _corpus()
    ref_engine = RefTopK(ref_build(lists, "optimal", freqs=freqs),
                         backend="numpy", resident="kernel")
    port_engine = TopKEngine(
        build_partitioned_index(lists, "optimal", freqs=freqs), device="cpu")
    queries = _queries(port_engine, np.random.default_rng(8), sum(sizes) + 1)
    script, at = [], 0
    for t, n in enumerate(sizes):
        script.append((float(t), queries[at : at + n], None))
        at += n
    script.append((float(len(sizes)), queries[at:], 0.5))

    async def drive(server_cls, eng):
        clock = _FakeClock()
        rec = _RecordingEngine(eng)
        server = server_cls(rec, k=10, max_batch=8, max_delay_s=1e9,
                            clock=clock)
        out = []
        for t, burst, deadline in script:
            clock.t = t
            futs = [asyncio.ensure_future(server.submit(q, deadline_s=deadline))
                    for q in burst]
            await asyncio.sleep(0)
            clock.t = t + 0.75  # past the last burst's deadline
            await server.drain()
            out += await asyncio.gather(*futs)
        return out, rec.waves, server.stats, dict(server.former.stats)

    return (asyncio.run(drive(AsyncTopKServer, port_engine)),
            asyncio.run(drive(RefServer, ref_engine)))


def _assert_same_service(got, want, n_queries):
    res, waves, stats, fstats = got
    assert waves == want[1]
    assert stats == want[2]
    assert stats["expired"] == 1 and stats["served"] == n_queries
    assert fstats == want[3]
    assert len(res) == len(want[0]) == n_queries + 1
    for g, w in zip(res, want[0]):
        assert g.expired == w.expired
        assert np.array_equal(g.docs, w.docs)
        assert np.array_equal(g.scores, w.scores)
        assert (g.wait_s, g.service_s) == (w.wait_s, w.service_s)
    assert res[-1].expired and res[0].wait_s == 0.75


def test_unpadded_waves_under_a_fake_clock_match_reference():
    """Bursts of 4, 8 and 10 queries form waves that fill their pow2
    buckets (4, 8, 8, 2): no query is padded on either side, and the
    waves, expiry, top-k and fake-clock waits agree with the reference's
    (the port's server read the real clock before it took ``clock``)."""
    got, want = _scripted_waves([4, 8, 10])
    assert got[1] == [4, 8, 8, 2]
    assert got[2]["padded_queries"] == 0
    _assert_same_service(got, want, 22)


def test_padded_waves_under_a_fake_clock_match_reference():
    """Bursts of 3, 5 and 11 queries: each wave is padded to its pow2
    bucket with empty queries (4, 8, 8, 4; five padded), as the
    reference's server pads it, with the same results."""
    got, want = _scripted_waves([3, 5, 11])
    assert got[1] == [4, 8, 8, 4]
    assert got[2]["padded_queries"] == 5
    _assert_same_service(got, want, 19)
