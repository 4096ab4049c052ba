"""The port's obs layer against the JAX package's.

The reference's own tests (``tests/test_obs.py``) run here against
``repro_torch.obs``: metrics primitives, the disarmed no-op contract,
span tracing into the ring, the exporters and a live HTTP server, and the
port's ``TopKEngine`` and ``QueryEngine`` bit-identical with the layer on
and off.  Then parity: the same seeded observations (10,000 of them, past
``RAW_CAP``) into both packages' registries give identical percentiles,
summaries, buckets, Prometheus text (byte for byte) and JSON snapshots.  Last,
``profile`` over ``torch.profiler``: a Chrome trace when armed, an error
that propagates.  And one snapshot after a sharded, fault-injected engine
and a checkpoint round trip, held to the reference's for the same
scenario.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro_torch import obs
from repro_torch.obs.metrics import RAW_CAP


@pytest.fixture(autouse=True)
def obs_state():
    """Arm a clean registry per test; restore the ambient state after."""
    was, ref_was = obs.enabled(), ref_obs.enabled()
    obs.enable(True)
    obs.reset()
    yield
    obs.reset()
    obs.enable(was)
    ref_obs.reset()
    ref_obs.enable(ref_was)


# ----------------------------------------------------------------------
# metrics primitives
# ----------------------------------------------------------------------
def test_counter_and_gauge_basics():
    c = obs.counter("widgets", kind="a")
    c.inc()
    c.add(4)
    assert c.value == 5
    # labels address distinct metrics; same labels return the same object
    assert obs.counter("widgets", kind="b").value == 0
    assert obs.counter("widgets", kind="a") is c
    g = obs.gauge("depth")
    g.set(3.5)
    g.add(0.5)
    assert g.value == 4.0
    obs.count("widgets", 2, kind="a")
    obs.set_gauge("depth", 9)
    assert c.value == 7 and g.value == 9


def test_histogram_exact_percentiles_and_summary():
    h = obs.histogram("lat_ms")
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    for x in xs:
        h.observe(x)
    for q in (0, 50, 90, 99, 100):
        assert h.percentile(q) == pytest.approx(np.percentile(xs, q))
    s = h.summary()
    assert s["count"] == 5 and s["sum"] == pytest.approx(15.0)
    assert s["min"] == 1.0 and s["max"] == 5.0
    assert s["p50"] == pytest.approx(3.0)
    assert set(s) == {"count", "sum", "min", "max", "p50", "p90", "p99", "p999"}


def test_histogram_bucket_fallback_past_raw_cap():
    h = obs.histogram("long_run_ms")
    rng = np.random.default_rng(0)
    xs = rng.uniform(1.0, 100.0, RAW_CAP + 2_000)
    for x in xs:
        h.observe(float(x))
    assert h.count == len(xs) > RAW_CAP
    for q in (50, 90, 99):
        exact = float(np.percentile(xs, q))
        # documented bucket-interpolation bound: <=12.5% relative error
        assert abs(h.percentile(q) - exact) / exact < 0.125, q


def test_percentile_of_edge_cases():
    p = obs.Histogram.percentile_of
    assert p([], 99) == 0.0
    assert p([7.0], 50) == 7.0
    assert p([1.0, 2.0], 50) == pytest.approx(1.5)
    assert p([1.0, 2.0, 3.0, 4.0], 99.9) == pytest.approx(
        np.percentile([1, 2, 3, 4], 99.9)
    )


def test_thread_safety_exact_totals():
    c = obs.counter("contended")
    h = obs.histogram("contended_ms")

    def work():
        for _ in range(10_000):
            c.inc()
            h.observe(1.0)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 80_000
    assert h.count == 80_000


def test_counterdict_is_a_dict_that_mirrors():
    d = obs.CounterDict("eng", {"hits": 0, "rows": 0}, backend="numpy")
    assert isinstance(d, dict) and d["hits"] == 0
    d["hits"] += 3
    d["hits"] += 2
    d["rows"] = 10
    assert d["hits"] == 5 and d["rows"] == 10  # the dict contract holds
    assert obs.counter("eng_hits", backend="numpy").value == 5
    assert obs.counter("eng_rows", backend="numpy").value == 10
    # non-numeric values pass through without a mirror
    d["samples"] = [1.0]
    d["samples"].append(2.0)
    assert d["samples"] == [1.0, 2.0]
    snap = obs.snapshot(events=False)
    assert not any(k.startswith("eng_samples") for k in snap["counters"])


# ----------------------------------------------------------------------
# the disarmed contract
# ----------------------------------------------------------------------
def test_disabled_is_a_complete_noop():
    obs.enable(False)
    obs.count("ghost")
    obs.observe("ghost_ms", 1.0)
    obs.set_gauge("ghost_depth", 2)
    obs.event("ghost_event", x=1)
    sp = obs.span("ghost_span")
    assert sp is obs.NULL_SPAN  # shared singleton, no allocation
    with sp:
        pass
    d = obs.CounterDict("ghost", {"n": 0})
    d["n"] += 5
    assert d["n"] == 5  # dict behavior intact...
    with obs.timer("ghost_timer_ms") as t:
        pass
    assert t.elapsed_s >= 0.0  # timers still measure for their caller
    snap = obs.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {}
    assert snap["histograms"] == {} and snap["events"] == []


# ----------------------------------------------------------------------
# tracing
# ----------------------------------------------------------------------
def test_spans_nest_and_feed_span_ms():
    with obs.span("outer", path="t"):
        with obs.span("inner"):
            pass
    obs.event("marker", shard=3)
    evs = obs.events()
    by_name = {e["name"]: e for e in evs}
    assert by_name["inner"]["depth"] == 1
    assert by_name["outer"]["depth"] == 0
    assert by_name["outer"]["path"] == "t"
    assert by_name["marker"]["kind"] == "event"
    assert by_name["marker"]["shard"] == 3
    # inner closes before outer: ring order is completion order
    assert [e["name"] for e in evs] == ["inner", "outer", "marker"]
    assert obs.REGISTRY.histogram("span_ms", span="outer", path="t").count == 1
    assert obs.REGISTRY.histogram("span_ms", span="inner").count == 1
    obs.clear_trace()
    assert obs.events() == []


def test_span_record_fields_fence_and_thread():
    """A span's ring record: depth is per thread, the record names the
    thread, and no field claims device time (a span never fences)."""
    def worker():
        with obs.span("in_thread"):
            pass

    with obs.span("outer"):
        t = threading.Thread(target=worker, name="obs-test-worker")
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    by_name = {e["name"]: e for e in obs.events()}
    rec = by_name["outer"]
    assert rec["kind"] == "span"
    assert rec["dur_ms"] >= 0.0 and rec["start_s"] >= 0.0
    assert rec["thread"] == threading.current_thread().name
    assert by_name["in_thread"]["depth"] == 0  # the other thread's own depth
    assert by_name["in_thread"]["thread"] == "obs-test-worker"
    assert "fence_ms" not in rec and "fence_ms" not in by_name["in_thread"]


def test_trace_ring_is_bounded():
    from repro_torch.obs.trace import TRACE_CAPACITY

    for i in range(TRACE_CAPACITY + 10):
        obs.event("tick", i=i)
    evs = obs.events()
    assert len(evs) == TRACE_CAPACITY
    assert evs[0]["i"] == 10 and evs[-1]["i"] == TRACE_CAPACITY + 9


def test_timer_records_ms():
    with obs.timer("step_ms", phase="x") as t:
        pass
    assert t.elapsed_s >= 0.0
    h = obs.REGISTRY.histogram("step_ms", phase="x")
    assert h.count == 1
    assert h.max == pytest.approx(t.elapsed_s * 1e3)


def test_profile_degrades_to_noop(tmp_path):
    obs.enable(False)
    where = tmp_path / "nonexistent_profile_dir"
    with obs.profile(str(where)):
        pass  # must not touch torch.profiler or the filesystem when disarmed
    assert not where.exists()


def test_profile_writes_a_chrome_trace_when_armed(tmp_path):
    where = tmp_path / "prof"
    with obs.profile(str(where)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((where / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names)


def test_profile_error_propagates_when_armed(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    with pytest.raises(OSError):
        with obs.profile(str(blocker / "sub")):
            pass


# ----------------------------------------------------------------------
# exporters
# ----------------------------------------------------------------------
def _populate():
    obs.count("reqs", 3, backend="numpy")
    obs.set_gauge("theta", 1.25)
    for v in (1.0, 2.0, 100.0):
        obs.observe("lat_ms", v)


def test_snapshot_and_prometheus_rendering():
    _populate()
    snap = obs.snapshot()
    assert snap["counters"]['reqs{backend="numpy"}'] == 3
    assert snap["gauges"]["theta"] == 1.25
    assert snap["histograms"]["lat_ms"]["count"] == 3
    text = obs.render_prometheus()
    assert "# TYPE reqs counter" in text
    assert 'reqs{backend="numpy"} 3' in text
    assert "# TYPE theta gauge" in text and "theta 1.25" in text
    assert "# TYPE lat_ms histogram" in text
    assert 'lat_ms_bucket{le="+Inf"} 3' in text
    assert "lat_ms_sum 103" in text and "lat_ms_count 3" in text
    # cumulative bucket counts are monotone
    cum = [int(l.rsplit(" ", 1)[1]) for l in text.splitlines()
           if l.startswith("lat_ms_bucket")]
    assert cum == sorted(cum) and cum[-1] == 3


def test_snapshot_diff():
    _populate()
    old = obs.snapshot(events=False)
    obs.count("reqs", 2, backend="numpy")
    obs.observe("lat_ms", 5.0)
    d = obs.diff(obs.snapshot(events=False), old)
    assert d["counters"]['reqs{backend="numpy"}'] == 2
    assert d["gauges"]["theta"] == 0
    assert d["histograms"]["lat_ms"]["count"] == 1
    assert d["histograms"]["lat_ms"]["sum"] == pytest.approx(5.0)


def test_write_snapshot_roundtrip(tmp_path):
    _populate()
    path = tmp_path / "snap.json"
    wrote = obs.write_snapshot(str(path))
    back = json.loads(path.read_text())
    assert back["counters"] == {k: v for k, v in wrote["counters"].items()}
    assert back["histograms"]["lat_ms"]["count"] == 3


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


def test_metrics_server_http_roundtrip():
    _populate()
    with obs.MetricsServer(0) as srv:
        assert srv.port > 0
        base = f"http://127.0.0.1:{srv.port}"
        _, text = _get(f"{base}/metrics")
        assert 'reqs{backend="numpy"} 3' in text
        assert text == obs.render_prometheus()
        snap = json.loads(_get(f"{base}/metrics.json")[1])
        assert snap["counters"]['reqs{backend="numpy"}'] == 3
        assert snap["histograms"]["lat_ms"] == obs.histogram("lat_ms").summary()
        assert _get(f"{base}/snapshot")[0] == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/nope")
        assert e.value.code == 404
        e.value.close()


# ----------------------------------------------------------------------
# parity with the reference's registry
# ----------------------------------------------------------------------
def _observe_into(o, seed):
    """The same seeded metrics into one package's obs layer: labelled
    counters and gauges, and histograms of 10,000, 50 and 1 samples whose
    values span every decade, the overflow bucket and exact zeros."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([
        rng.lognormal(1.0, 3.0, 9_000),
        rng.uniform(0.0, 1e-3, 500),
        10.0 ** rng.uniform(8.5, 11.0, 300),
        np.zeros(200),
    ])
    rng.shuffle(xs)
    for x in xs:
        o.observe("serve_request_ms", float(x))
    for x in rng.exponential(5.0, 50):
        o.observe("serve_wave_ms", float(x), engine="topk")
    o.observe("span_ms", 3.25, span="pivot", path="ranked")
    for kind, n in (("done", 9_000), ("expired", 12), ("shed", 7)):
        o.count("serve_requests", n, kind=kind)
    o.count("serve_backpressure_waits", 3)
    o.set_gauge("serve_queue_depth", 17)
    o.set_gauge("ranked_theta_max", float(rng.uniform(0, 40)))
    return xs


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_matches_reference(seed):
    ref_obs.enable(True)
    ref_obs.reset()
    xs = _observe_into(obs, seed)
    _observe_into(ref_obs, seed)
    h = obs.histogram("serve_request_ms")
    rh = ref_obs.histogram("serve_request_ms")
    assert h.count == rh.count == len(xs) > RAW_CAP
    for q in (50, 90, 99, 99.9):
        assert h.percentile(q) == rh.percentile(q)
    assert h.summary() == rh.summary()
    assert h.buckets() == rh.buckets()
    small = obs.histogram("serve_wave_ms", engine="topk")
    assert small.summary() == ref_obs.histogram(
        "serve_wave_ms", engine="topk").summary()
    assert obs.render_prometheus() == ref_obs.render_prometheus()
    assert obs.snapshot(events=False) == ref_obs.snapshot(events=False)
    new = obs.snapshot(events=False)
    ref_new = ref_obs.snapshot(events=False)
    obs.count("serve_requests", 5, kind="done")
    ref_obs.count("serve_requests", 5, kind="done")
    assert (obs.diff(new, obs.snapshot(events=False))
            == ref_obs.diff(ref_new, ref_obs.snapshot(events=False)))


def test_module_surface_matches_reference():
    assert sorted(obs.__all__) == sorted(ref_obs.__all__)


# ----------------------------------------------------------------------
# instrumented engine: identity
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranked_index():
    from repro_torch.core.index import build_partitioned_index
    from repro_torch.data.postings import make_corpus, make_freqs, make_queries

    rng = np.random.default_rng(42)
    corpus = make_corpus(rng, n_lists=6, min_len=300, max_len=2_000,
                         mean_dense_gap=2.13, frac_dense=0.8)
    idx = build_partitioned_index(corpus, "optimal",
                                  freqs=make_freqs(rng, corpus))
    queries = [[int(t) for t in q] for q in make_queries(rng, 6, 12, 2)]
    return idx, queries


@pytest.mark.parametrize("backend,resident", [
    ("torch", "kernel"), ("torch", "mirror"), ("numpy", "kernel"),
])
def test_topk_bit_identical_with_obs_on(ranked_index, backend, resident):
    """Arming the layer must not perturb a single score or doc id."""
    from repro_torch.ranked.topk_engine import TopKEngine

    idx, queries = ranked_index
    eng = TopKEngine(idx, backend=backend, resident=resident, device="cpu",
                     seed_blocks=2)
    obs.enable(False)
    want = eng.topk_batch(queries, 10)
    obs.enable(True)
    got = eng.topk_batch(queries, 10)
    for (gd, gs), (wd, ws) in zip(got, want):
        assert np.array_equal(gd, wd)
        assert np.array_equal(gs, ws)
    snap = obs.snapshot(events=False)
    # the ranked phases surfaced as spans, in the histograms and the ring
    assert any('span="seed"' in k for k in snap["histograms"])
    assert {"seed", "rescore"} <= {e["name"] for e in obs.events()}


@pytest.mark.parametrize("backend,codec_policy", [
    ("torch", "svb"), ("torch", "ef"), ("numpy", "svb"),
])
def test_and_bit_identical_with_obs_on(ranked_index, backend, codec_policy):
    """The boolean engine's answers do not move with the layer armed, and
    its filter's spans surface (``codec_split`` on the multi-codec arena,
    on the torch backend)."""
    from repro_torch.core.query_engine import QueryEngine

    idx, queries = ranked_index
    eng = QueryEngine(idx, backend=backend, device="cpu",
                      codec_policy=codec_policy)
    obs.enable(False)
    want = eng.intersect_batch(queries)
    obs.enable(True)
    got = eng.intersect_batch(queries)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    names = {e["name"] for e in obs.events()}
    assert {"gather", "member_filter"} <= names
    assert ("codec_split" in names) == (
        backend == "torch" and codec_policy == "ef")


def test_snapshot_covers_every_instrumented_subsystem(tmp_path):
    """One snapshot after touching engine, shards, resilience and
    checkpointing carries metrics from all four subsystems -- and the same
    scenario through the reference gives the same counters, value for
    value, and the same histograms (up to the backend label).  The port
    adds exactly the names of its own that the scenario reaches: the AND
    filter's ``engine_member_cursors`` and ``group_cursors`` span, and the
    device dispatch's ``dispatch_stage`` span (its arena has one codec, so
    no ``codec_split``)."""
    from repro.core.index import build_partitioned_index as ref_build
    from repro.data.postings import make_corpus, make_freqs, make_queries

    from repro_torch.convert import index_arrays, index_from_arrays

    rng = np.random.default_rng(42)
    corpus = make_corpus(rng, n_lists=6, min_len=300, max_len=2_000,
                         mean_dense_gap=2.13, frac_dense=0.8)
    ref_idx = ref_build(corpus, "optimal", freqs=make_freqs(rng, corpus))
    queries = [[int(t) for t in q] for q in make_queries(rng, 6, 12, 2)]

    def scenario(o, idx, QueryEngine, ResilientEngine, ShardFaultInjector,
                 CheckpointManager, path, **kw):
        o.enable(True)
        o.reset()
        # the routed engine: the numpy backend would serve sharded
        # queries through the global flat mirror, never a shard dispatch
        res = ResilientEngine(
            QueryEngine(idx, shards=2, replicas=2, shard_mesh=None, **kw),
            injector=ShardFaultInjector(at_batches=(1,), shards=(0,)),
            backoff_s=1e-4,
        )
        for i in range(0, len(queries), 4):
            res.intersect_batch(queries[i : i + 4])
        r = np.random.default_rng(3)
        res.search_batch(r.integers(0, 6, 40), r.integers(0, 1_000_000, 40))
        m = CheckpointManager(path, async_save=False)
        # non-monotone payload: stays raw (saved bytes = the raw 800)
        tree = {"a": np.random.default_rng(5).standard_normal(100)}
        m.save(0, tree)
        m.restore(tree)
        return o.snapshot(events=False)

    from repro.checkpoint import CheckpointManager as RefManager
    from repro.core.query_engine import QueryEngine as RefQuery
    from repro.distributed.resilient import ResilientEngine as RefResilient
    from repro.distributed.resilient import ShardFaultInjector as RefInjector

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.query_engine import QueryEngine
    from repro_torch.distributed.resilient import (
        ResilientEngine,
        ShardFaultInjector,
    )

    want = scenario(ref_obs, ref_idx, RefQuery, RefResilient, RefInjector,
                    RefManager, tmp_path / "ref", backend="ref")
    snap = scenario(obs, index_from_arrays(index_arrays(ref_idx)),
                    QueryEngine, ResilientEngine, ShardFaultInjector,
                    CheckpointManager, tmp_path / "port", device="cpu")
    c, h = snap["counters"], snap["histograms"]
    assert any(k.startswith("engine_") for k in c)            # EngineCore
    assert any(k.startswith("shard_dispatch") for k in c)     # ShardedArena
    assert any(k.startswith("resilient_") for k in c)         # ResilientEngine
    assert c["checkpoint_saves"] == 1 and c["checkpoint_restores"] == 1
    assert c["checkpoint_saved_bytes"] == c["checkpoint_restored_bytes"] == 800
    assert h["checkpoint_save_ms"]["count"] == 1
    assert h["checkpoint_restore_ms"]["count"] == 1
    # the reference's every counter, value for value; beside them only the
    # names the port alone emits (repro_torch/obs/catalogue.md)
    assert {k: v for k, v in c.items() if k in want["counters"]} \
        == want["counters"]
    assert set(c) - set(want["counters"]) == {"engine_member_cursors"}
    hk = {k.replace('backend="torch"', 'backend="ref"') for k in h}
    assert len(hk) == len(h)
    assert set(want["histograms"]) <= hk
    assert hk - set(want["histograms"]) == {
        'span_ms{path="member",span="group_cursors"}',
        'span_ms{span="dispatch_stage"}'}
    assert snap["gauges"].keys() == want["gauges"].keys()
