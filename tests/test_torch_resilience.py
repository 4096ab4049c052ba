"""The port's fault-tolerant sharded serving against the JAX package.

Ports the oracles of ``tests/test_resilience.py``: the arena survives a
checkpoint round trip bit-exactly (OptVB-packing its monotone sidecars);
one shard's sub-arena restores from a GLOBAL checkpoint onto another shard
count / replica factor; replica routing fails a dead primary over; the
``ShardFaultInjector`` replays the reference's schedules and fires from
the real dispatch boundaries; ``ResilientEngine`` keeps answers
bit-identical to the no-fault run whenever a live copy exists and
degrades to exactly the no-fault answers of the live-restricted queries
otherwise; the health lifecycle shows in the obs layer.  The reference's
multi-device subprocess becomes the device-list dispatch over
``[cpu] * S``.  Beyond the reference: an arena checkpoint either package
writes restores in the other to equal arrays (ranked and multi-codec).
"""

import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as RefManager
from repro.core import arena_ckpt as ref_ckpt
from repro.core.index import build_partitioned_index as ref_build
from repro.core.query_engine import QueryEngine as RefQuery
from repro.core.shard import ShardedArena as RefSharded
from repro.data.postings import make_corpus, make_freqs, make_queries
from repro.distributed.resilient import ShardFaultInjector as RefInjector
from repro.ranked.topk_engine import TopKEngine as RefTopK

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import index_arrays, index_from_arrays
from repro_torch.core.arena_ckpt import (
    arena_to_tree,
    restore_arena,
    restore_shard,
    save_arena,
    tree_to_arena,
)
from repro_torch.core.query_engine import QueryEngine
from repro_torch.core.shard import (
    ShardedArena,
    ShardsUnavailable,
    replica_owners,
    shard_of_list,
)
from repro_torch.distributed.resilient import (
    DEAD,
    HEALTHY,
    RECOVERING,
    SUSPECT,
    ResilientEngine,
    ShardFailure,
    ShardFaultInjector,
)
from repro_torch.ranked.topk_engine import TopKEngine

N_LISTS = 7


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(77)
    return make_corpus(rng, n_lists=N_LISTS, min_len=300, max_len=2_500,
                       mean_dense_gap=2.13, frac_dense=0.8)


_IDX = {}


def indexes(corpus, ranked=False, codecs="svb"):
    """(reference index, the port's index carried over from it)."""
    key = (ranked, codecs)
    if key not in _IDX:
        kw = {}
        if ranked:
            kw["freqs"] = make_freqs(np.random.default_rng(78), corpus)
        ref = ref_build(corpus, "optimal", codecs=codecs, **kw)
        _IDX[key] = (ref, index_from_arrays(index_arrays(ref)))
    return _IDX[key]


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(79)
    return [[int(t) for t in q] for q in make_queries(rng, N_LISTS, 24, 2)]


def _arena_fields(a):
    out = {
        k: getattr(a, k)
        for k in ("lens", "data", "block_base", "block_keys", "lane_valid",
                  "part_of_block", "first_blk", "n_blk", "sizes", "bases",
                  "part_list", "list_blk_offsets")
    }
    out["stride"] = np.int64(a.stride)
    out["n_blocks"] = np.int64(a.n_blocks)
    if a.block_codec is not None:
        out.update(block_codec=a.block_codec, codec_row=a.codec_row,
                   ef_lo=a.ef_lo, ef_hi=a.ef_hi, ef_lbits=a.ef_lbits)
    if a.ranked is not None:
        r = a.ranked
        out.update(
            freq_lens=r.freq_lens, freq_data=r.freq_data, norm_q=r.norm_q,
            block_max_q=r.block_max_q, bound_scale=np.float32(r.bound_scale),
            idf=r.idf, list_ub=r.list_ub, kmin=np.float32(r.kmin),
            kstep=np.float32(r.kstep), norm_table=r.norm_table,
            bm25_k1=np.float64(r.params.k1), bm25_b=np.float64(r.params.b),
        )
    return out


def _assert_same_arena(a, b):
    fa, fb = _arena_fields(a), _arena_fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _serve_chunks(res, queries, batch=6):
    out, degraded_q = [], 0
    for i in range(0, len(queries), batch):
        chunk = queries[i : i + batch]
        got, info = res.intersect_batch(chunk)
        out.extend(got)
        if info.degraded:
            miss = set(info.missing_lists.tolist())
            degraded_q += sum(1 for q in chunk if any(t in miss for t in q))
    return out, degraded_q


def _engine(idx, **kw):
    return QueryEngine(idx, device="cpu", **kw)


# ----------------------------------------------------------------------
# arena checkpoint layout
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ranked", [False, True])
def test_arena_tree_roundtrip(corpus, ranked):
    ref, idx = indexes(corpus, ranked=ranked)
    back = tree_to_arena(arena_to_tree(idx.arena))
    assert (back.ranked is not None) == ranked
    _assert_same_arena(idx.arena, back)
    # the tree is the reference's, leaf for leaf
    want = ref_ckpt.arena_to_tree(ref.arena)
    got = arena_to_tree(idx.arena)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_arena_checkpoint_uses_optvb_codec(tmp_path, corpus):
    """The monotone sidecars land OptVB-packed, as the reference's do."""
    ref, idx = indexes(corpus)
    m = CheckpointManager(tmp_path / "port", async_save=False)
    save_arena(m, idx.arena, step=3)
    rm = RefManager(tmp_path / "ref", async_save=False)
    ref_ckpt.save_arena(rm, ref.arena, step=3)
    leaves = m.manifest(3)["leaves"]
    assert leaves == rm.manifest(3)["leaves"]
    assert m.manifest(3)["treedef"] == rm.manifest(3)["treedef"]
    keys = sorted(arena_to_tree(idx.arena))
    codec_of = {keys[leaf["i"]]: leaf["codec"] for leaf in leaves}
    assert codec_of["block_keys"] == "optvb"
    assert codec_of["first_blk"] == "optvb"
    assert codec_of["list_blk_offsets"] == "optvb"
    assert codec_of["data"] == "raw"
    back, got = restore_arena(m)
    assert got == 3
    _assert_same_arena(idx.arena, back)


def test_restore_arena_ranked_roundtrip(tmp_path, corpus):
    _, idx = indexes(corpus, ranked=True)
    m = CheckpointManager(tmp_path, async_save=False)
    save_arena(m, idx.arena)
    back, _ = restore_arena(m)
    assert back.ranked is not None
    _assert_same_arena(idx.arena, back)


@pytest.mark.parametrize("kind", ["ranked", "multi-codec"])
def test_arena_checkpoint_crosses_packages(tmp_path, corpus, kind):
    """An arena checkpoint the reference writes restores in the port, and
    one the port writes restores in the reference: equal arrays."""
    ranked = kind == "ranked"
    policy = "ef" if kind == "multi-codec" else "svb"
    ref, idx = indexes(corpus, ranked=ranked, codecs=policy)
    ra, ta = ref.arena_for(policy), idx.arena_for(policy)
    assert ta.multi == (kind == "multi-codec")
    rm = RefManager(tmp_path / "from_ref", async_save=False)
    ref_ckpt.save_arena(rm, ra, step=5)
    got, step = restore_arena(CheckpointManager(tmp_path / "from_ref",
                                                async_save=False))
    assert step == 5
    _assert_same_arena(got, ta)
    pm = CheckpointManager(tmp_path / "from_port", async_save=False)
    save_arena(pm, ta, step=6)
    back, step = ref_ckpt.restore_arena(RefManager(tmp_path / "from_port",
                                                   async_save=False))
    assert step == 6
    _assert_same_arena(back, ra)
    # one shard of a checkpoint the reference wrote, sliced in the port
    sub, _ = restore_shard(CheckpointManager(tmp_path / "from_ref",
                                             async_save=False), 1, 3)
    want = RefSharded.build(ra, 3, mesh=None).shards[1]
    _assert_same_arena(sub, want)


@pytest.mark.parametrize("n_shards,replicas", [(2, 1), (5, 2), (3, 3)])
def test_restore_shard_is_elastic(tmp_path, corpus, n_shards, replicas):
    """One shard restored from a GLOBAL checkpoint equals the same shard
    of a FRESH sharding at any (shard count, replica factor)."""
    _, idx = indexes(corpus)
    m = CheckpointManager(tmp_path, async_save=False)
    save_arena(m, idx.arena)
    sa = ShardedArena.build(idx.arena, n_shards, mesh=None,
                            replicas=replicas)
    for s in range(n_shards):
        sub, _ = restore_shard(m, s, n_shards, replicas=replicas)
        _assert_same_arena(sa.shards[s], sub)


def test_restore_shard_skips_corrupt_step(tmp_path, corpus):
    _, idx = indexes(corpus)
    m = CheckpointManager(tmp_path, async_save=False, keep=4)
    save_arena(m, idx.arena, step=1)
    save_arena(m, idx.arena, step=2)
    npz = tmp_path / "step_0000000002" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[: 40])  # truncate the newest step
    sub, got = restore_shard(m, 0, 2)
    assert got == 1
    sa = ShardedArena.build(idx.arena, 2, mesh=None)
    _assert_same_arena(sa.shards[0], sub)
    with pytest.raises(Exception):
        restore_shard(m, 0, 2, step=2)  # explicit step: no fallback


# ----------------------------------------------------------------------
# replica routing
# ----------------------------------------------------------------------
def test_replica_owner_layout():
    n = 100
    owner_r = replica_owners(n, 4, 3)
    assert owner_r.shape == (3, n)
    assert np.array_equal(owner_r[0], shard_of_list(np.arange(n), 4))
    for r in range(3):
        assert np.array_equal(owner_r[r], (owner_r[0] + r) % 4)
    assert all(len(set(owner_r[:, t])) == 3 for t in range(n))


def test_route_failover_prefers_primary(corpus):
    _, idx = indexes(corpus)
    sa = ShardedArena.build(idx.arena, 3, mesh=None, replicas=2)
    terms = np.arange(N_LISTS, dtype=np.int64)
    owner0, local0, served0 = sa.route(terms)
    assert served0.all()
    assert np.array_equal(owner0, sa.owner[terms])  # no-fault: primary
    victim = int(sa.owner[0])
    sa.dead[victim] = True
    owner1, local1, served1 = sa.route(terms)
    assert served1.all()
    moved = sa.owner[terms] == victim
    assert moved.any()
    assert np.array_equal(owner1[moved], (sa.owner[terms][moved] + 1) % 3)
    assert np.array_equal(owner1[~moved], owner0[~moved])
    for t, s, lt in zip(terms, owner1, local1):
        rows = np.flatnonzero((sa.owner_r == s).any(axis=0))
        assert rows[lt] == t
    sa.dead[:] = True
    _, _, served2 = sa.route(terms)
    assert not served2.any()
    assert np.array_equal(sa.unserved_lists(), terms)
    with pytest.raises(ShardsUnavailable):
        sa.route_one(0)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_replicated_engine_identity_no_faults(corpus, backend, queries):
    ref, idx = indexes(corpus)
    plain = RefQuery(ref, backend="numpy")
    eng = QueryEngine(idx, backend=backend, shards=3, replicas=2,
                      shard_mesh=None,
                      **({"device": "cpu"} if backend == "torch" else {}))
    rng = np.random.default_rng(5)
    terms = rng.integers(0, N_LISTS, 200)
    probes = rng.integers(0, 4_000_000, 200)
    bv, br = plain.search_batch(terms, probes)
    v, r = eng.search_batch(terms, probes)
    assert np.array_equal(v, bv) and np.array_equal(r, br)
    for g, w in zip(eng.intersect_batch(queries),
                    plain.intersect_batch(queries)):
        assert np.array_equal(g, w)


# ----------------------------------------------------------------------
# fault injector: the reference's schedules
# ----------------------------------------------------------------------
def test_injector_deterministic_schedule():
    inj = ShardFaultInjector(at_batches=(1, 3), shards=(2, 0))
    ref = RefInjector(at_batches=(1, 3), shards=(2, 0))
    dead_per_batch = []
    for _ in range(5):
        inj.begin_batch()
        ref.begin_batch()
        dead_per_batch.append(sorted(inj.dead))
        assert inj.dead == ref.dead
    assert dead_per_batch == [[], [2], [2], [0, 2], [0, 2]]
    assert inj.fired == ref.fired == 2
    with pytest.raises(ShardFailure) as ei:
        inj.check(2)
    assert ei.value.shard == 2
    inj.check(1)
    with pytest.raises(ShardFailure):
        inj.check_shards(np.array([[1, 0]]))
    inj.revive(0)
    inj.revive(2)
    inj.check_shards(np.array([0, 1, 2]))


def test_injector_probability_is_seeded():
    def schedule(cls, seed):
        inj = cls(probability=0.5, seed=seed, shards=(0, 1, 2),
                  transient=True)
        fires = []
        for _ in range(64):
            inj.begin_batch()
            fires.append(sorted(inj.dead))
        return fires, inj.fired

    a, fired_a = schedule(ShardFaultInjector, 11)
    assert (a, fired_a) == schedule(ShardFaultInjector, 11)
    assert (a, fired_a) == schedule(RefInjector, 11)  # the reference's
    assert 0 < fired_a < 64
    assert a != schedule(ShardFaultInjector, 12)[0]
    assert all(len(d) <= 1 for d in a)


@pytest.mark.parametrize("mesh", [None, "list"])
def test_inband_raise_from_dispatch_boundary(corpus, mesh):
    """A dead shard raises ShardFailure from the engine's own per-shard
    dispatch (the host loop's EngineCore, or the device-list dispatch)."""
    _, idx = indexes(corpus)
    inj = ShardFaultInjector()
    eng = _engine(idx, shards=3, fault_injector=inj,
                  shard_mesh=["cpu"] * 3 if mesh else None)
    rng = np.random.default_rng(6)
    terms = rng.integers(0, N_LISTS, 64)
    probes = rng.integers(0, 4_000_000, 64)
    eng.search_batch(terms, probes)
    assert (eng._smap_fn is not None) == bool(mesh)
    victim = int(eng.sharded.owner[int(terms[0])])
    inj.dead.add(victim)
    with pytest.raises(ShardFailure) as ei:
        eng.search_batch(terms, probes)
    assert ei.value.shard == victim


def test_resilient_needs_sharded_engine(corpus):
    _, idx = indexes(corpus)
    with pytest.raises(ValueError, match="shard"):
        ResilientEngine(QueryEngine(idx, backend="numpy"))


# ----------------------------------------------------------------------
# ResilientEngine: failover / degradation / recovery
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_replica_failover_bit_identical(corpus, backend, queries):
    ref, idx = indexes(corpus)
    want = RefQuery(ref, backend="numpy").intersect_batch(queries)
    res = ResilientEngine(
        QueryEngine(idx, backend=backend, shards=3, replicas=2,
                    shard_mesh=None,
                    **({"device": "cpu"} if backend == "torch" else {})),
        injector=ShardFaultInjector(at_batches=(1,), shards=(0,)),
        backoff_s=1e-4,
    )
    got, degraded_q = _serve_chunks(res, queries)
    assert degraded_q == 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert DEAD in res.health
    assert res.stats["failovers"] >= 1
    assert res.stats["dead_events"] == 1
    assert not res.sa.unserved_lists().size


@pytest.mark.parametrize("backend,resident", [("torch", "kernel"),
                                              ("torch", "mirror"),
                                              ("numpy", "kernel")])
def test_topk_replica_failover_bit_identical(corpus, backend, resident,
                                             queries):
    ref, idx = indexes(corpus, ranked=True)
    want = RefTopK(ref, backend="numpy", seed_blocks=2).topk_batch(queries, 10)
    res = ResilientEngine(
        TopKEngine(idx, backend=backend, seed_blocks=2, shards=3,
                   replicas=2, shard_mesh=None, resident=resident,
                   **({"device": "cpu"} if backend == "torch" else {})),
        injector=ShardFaultInjector(at_batches=(1,), shards=(1,)),
        backoff_s=1e-4,
    )
    got_all = []
    for i in range(0, len(queries), 6):
        got, info = res.topk_batch(queries[i : i + 6], 10)
        assert not info.degraded
        got_all.extend(got)
    for (gd, gs), (wd, ws) in zip(got_all, want):
        assert np.array_equal(gd, wd) and np.array_equal(gs, ws)
    assert res.stats["failovers"] >= 1


def test_transient_fault_retries_then_heals(corpus, queries):
    """A blip is absorbed by backoff-retry: SUSPECT, the retry succeeds,
    HEALTHY again without a dead_event."""

    class OneShotBlip(ShardFaultInjector):
        def check(self, shard):
            try:
                super().check(shard)
            except ShardFailure:
                self.dead.discard(int(shard))  # gone by the retry
                raise

    ref, idx = indexes(corpus)
    want = RefQuery(ref, backend="numpy").intersect_batch(queries)
    res = ResilientEngine(
        _engine(idx, shards=3, shard_mesh=None),
        injector=OneShotBlip(at_batches=(1,), shards=(0,)),
        backoff_s=1e-4,
    )
    got, degraded_q = _serve_chunks(res, queries)
    assert degraded_q == 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert res.stats["retries"] >= 1
    assert res.stats["dead_events"] == 0
    assert res.health == [HEALTHY] * 3


def test_degraded_equals_restricted_no_fault_answers(corpus, queries):
    ref, idx = indexes(corpus)
    plain = RefQuery(ref, backend="numpy")
    want = plain.intersect_batch(queries)
    res = ResilientEngine(
        _engine(idx, shards=3, shard_mesh=None),
        injector=ShardFaultInjector(at_batches=(1,), shards=(0,)),
        backoff_s=1e-4,
    )
    got, degraded_q = _serve_chunks(res, queries)
    missing = set(res.sa.unserved_lists().tolist())
    assert missing and degraded_q > 0
    restricted = plain.intersect_batch(
        [[t for t in q if t not in missing] for q in queries]
    )
    # shard 0 is dead from batch 1 on: a query served there that touches a
    # lost list gets the restricted answer, every other query the full one
    lost = [i >= 6 and any(t in missing for t in q)
            for i, q in enumerate(queries)]
    assert degraded_q == sum(lost)
    for i, (g, w, r, x) in enumerate(zip(got, want, restricted, lost)):
        assert np.array_equal(g, r if x else w), i
    assert res.stats["degraded_batches"] >= 1
    rng = np.random.default_rng(7)
    terms = rng.integers(0, N_LISTS, 80)
    probes = rng.integers(0, 4_000_000, 80)
    v, r, info = res.search_batch(terms, probes)
    hit = np.isin(terms, np.asarray(sorted(missing)))
    assert info.degraded
    assert set(info.missing_lists.tolist()) <= missing
    assert (v[hit] == -1).all() and (r[hit] == -1).all()
    bv, br = plain.search_batch(terms[~hit], probes[~hit])
    assert np.array_equal(v[~hit], bv) and np.array_equal(r[~hit], br)


@pytest.mark.parametrize("recover_async", [False, True])
def test_checkpoint_recovery_bit_identical(tmp_path, corpus, queries,
                                           recover_async):
    ref, idx = indexes(corpus)
    plain = RefQuery(ref, backend="numpy")
    want = plain.intersect_batch(queries)
    res = ResilientEngine(
        _engine(idx, shards=3, shard_mesh=None),
        injector=ShardFaultInjector(at_batches=(1,), shards=(0,)),
        manager=CheckpointManager(tmp_path, async_save=False),
        backoff_s=1e-4,
        recover_async=recover_async,
    )
    res.checkpoint()
    assert res.checkpoint_bytes > 0 and res.checkpoint_s >= 0
    got, degraded_q = _serve_chunks(res, queries)
    if recover_async:
        res.wait_recovered()
        extra, _ = _serve_chunks(res, queries[:6])
        for g, w in zip(extra, want[:6]):
            assert np.array_equal(g, w)
    else:
        assert degraded_q == 0
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert res.stats["recoveries"] == 1 and len(res.restore_s) == 1
    assert res.health == [HEALTHY] * 3
    assert not res.sa.dead.any()
    assert np.isfinite(res.recovery_p99_s())
    summary = res.health_summary()
    assert summary["health"] == [HEALTHY] * 3
    assert summary["recoveries"] == 1
    # the recovered shard was uploaded again (at the batch boundary)
    assert res.sa.shard_device_nbytes()[0] > 0
    rng = np.random.default_rng(8)
    terms = rng.integers(0, N_LISTS, 60)
    probes = rng.integers(0, 4_000_000, 60)
    v, r, info = res.search_batch(terms, probes)
    assert not info.degraded
    bv, br = plain.search_batch(terms, probes)
    assert np.array_equal(v, bv) and np.array_equal(r, br)


# ----------------------------------------------------------------------
# observability: the health lifecycle as emitted events
# ----------------------------------------------------------------------
@pytest.fixture
def armed_obs():
    was = obs.enabled()
    obs.enable(True)
    obs.reset()
    yield
    obs.reset()
    obs.enable(was)


def _transitions(shard: int) -> list[tuple[str, str]]:
    return [
        (e["src"], e["dst"])
        for e in obs.events()
        if e["name"] == "health_transition" and e["shard"] == shard
    ]


def test_health_lifecycle_emitted_as_obs_events(tmp_path, corpus, queries,
                                                armed_obs):
    _, idx = indexes(corpus)
    res = ResilientEngine(
        QueryEngine(idx, backend="numpy", shards=3, shard_mesh=None),
        injector=ShardFaultInjector(at_batches=(1,), shards=(0,)),
        manager=CheckpointManager(tmp_path, async_save=False),
        backoff_s=1e-4,
    )
    res.checkpoint()
    _, degraded_q = _serve_chunks(res, queries)
    assert degraded_q == 0
    seq = _transitions(0)
    assert seq == [
        (HEALTHY, SUSPECT), (SUSPECT, DEAD),
        (DEAD, RECOVERING), (RECOVERING, HEALTHY),
    ]
    assert all(_transitions(s) == [] for s in (1, 2))
    snap = obs.snapshot(events=False)
    c = snap["counters"]
    for src, dst in seq:
        key = (f'resilient_health_transitions'
               f'{{dst="{dst}",shard="0",src="{src}"}}')
        assert c[key] == 1, key
    assert c["resilient_recoveries"] == res.stats["recoveries"] == 1
    assert c["resilient_dead_events"] == res.stats["dead_events"] == 1
    assert c["resilient_failovers"] == res.stats["failovers"] >= 1
    h = snap["histograms"]
    assert h['resilient_recovery_ms{shard="0"}']["count"] == 1
    assert h['resilient_recovery_ms{shard="0"}']["max"] < 30_000
    assert h["resilient_failover_ms"]["count"] >= 1


def test_degraded_serving_counted_lifecycle_stops_at_dead(corpus, queries,
                                                          armed_obs):
    _, idx = indexes(corpus)
    res = ResilientEngine(
        QueryEngine(idx, backend="numpy", shards=3, shard_mesh=None),
        injector=ShardFaultInjector(at_batches=(1,), shards=(0,)),
        backoff_s=1e-4,
    )
    _, degraded_q = _serve_chunks(res, queries)
    assert degraded_q > 0
    assert _transitions(0) == [(HEALTHY, SUSPECT), (SUSPECT, DEAD)]
    snap = obs.snapshot(events=False)
    assert snap["counters"]["resilient_degraded_answers"] >= 1
    assert "resilient_recovery_ms{shard=\"0\"}" not in snap["histograms"]


# ----------------------------------------------------------------------
# the device-list dispatch under faults (the reference's subprocess lane)
# ----------------------------------------------------------------------
def test_device_list_faults_failover_and_recovery(tmp_path, corpus, queries):
    """The injector fires from the device-list dispatch boundary itself;
    replica failover and checkpoint recovery stay bit-identical with four
    shards on one device, and the recovered shard is uploaded again."""
    ref, idx = indexes(corpus)
    want = RefQuery(ref, backend="numpy").intersect_batch(queries)
    mesh = ["cpu"] * 4

    def serve(res):
        out = []
        for i in range(0, len(queries), 6):
            got, info = res.intersect_batch(queries[i : i + 6])
            assert not info.degraded
            out.extend(got)
        return out

    inj = ShardFaultInjector()
    eng = _engine(idx, shards=4, replicas=2, shard_mesh=mesh,
                  fault_injector=inj)
    rng = np.random.default_rng(2)
    terms = rng.integers(0, N_LISTS, 120)
    probes = rng.integers(0, 3_000_000, 120)
    eng.search_batch(terms, probes)
    assert eng._smap_fn is not None
    inj.dead.add(0)
    with pytest.raises(ShardFailure) as e:
        eng.search_batch(terms, probes)
    assert e.value.shard == 0

    res = ResilientEngine(
        _engine(idx, shards=4, replicas=2, shard_mesh=mesh),
        injector=ShardFaultInjector(at_batches=(1,), shards=(0,)),
        backoff_s=1e-4,
    )
    got = serve(res)
    assert res.stats["failovers"] >= 1
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert res.sa.shard_device_nbytes()[0] == 0  # the dead shard was evicted

    res = ResilientEngine(
        _engine(idx, shards=4, shard_mesh=mesh),
        injector=ShardFaultInjector(at_batches=(1,), shards=(1,)),
        manager=CheckpointManager(tmp_path, async_save=False),
        backoff_s=1e-4,
    )
    res.checkpoint()
    got = serve(res)
    assert res.stats["recoveries"] == 1
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert res.sa.shard_device_nbytes()[1] > 0
