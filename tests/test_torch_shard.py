"""The port's sharded arena and sharded engines against the JAX package.

Ports the oracles of ``tests/test_shard_routing.py``: the splitmix64
routing and replica placement equal ``repro.core.shard``'s; every
sub-arena equals the reference's array for array (single-codec,
multi-codec and ranked); ``route`` agrees under dead masks; a 1-shard
engine is bit-identical to the unsharded one; multi-shard engines equal
the unsharded engine and the reference's sharded engine; empty shards,
duplicate grouping across shard boundaries and the 2^31 probe clip hold
through the merge; the ranked engine's top-k and contributions are
identical sharded.  The reference's multi-device subprocess becomes the
device-list dispatch with ``[cpu] * S``: one device per shard, several
shards on one device, held to the host loop (``max_bucket`` rounds
included).  The port runs its torch backend on the CPU (the kernels'
plain versions) and its numpy backend; the reference runs ``ref`` (and
``numpy``).  Every comparison is exact.
"""

import numpy as np
import pytest

from repro.core.index import build_partitioned_index as ref_build
from repro.core.query_engine import QueryEngine as RefQuery
from repro.core.shard import ShardedArena as RefSharded
from repro.core.shard import replica_owners as ref_replica_owners
from repro.core.shard import shard_of_list as ref_shard_of_list
from repro.data.postings import make_corpus, make_freqs, make_queries
from repro.ranked.topk_engine import TopKEngine as RefTopK

from repro_torch.api import EngineConfig
from repro_torch.convert import index_arrays, index_from_arrays
from repro_torch.core.index import build_partitioned_index
from repro_torch.core.query_engine import QueryEngine
from repro_torch.core.shard import (
    ShardedArena,
    ShardMapSearch,
    ShardsUnavailable,
    replica_owners,
    shard_of_list,
)
from repro_torch.ranked.topk_engine import TopKEngine

N_LISTS = 7
ARENA_FIELDS = ("lens", "data", "block_base", "block_keys", "lane_valid",
                "part_of_block", "first_blk", "n_blk", "sizes", "bases",
                "part_list", "list_blk_offsets", "block_codec", "codec_row",
                "ef_lo", "ef_hi", "ef_lbits")
SIDECAR_FIELDS = ("freq_lens", "freq_data", "norm_q", "block_max_q", "idf",
                  "list_ub", "norm_table")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(23)
    return make_corpus(rng, n_lists=N_LISTS, min_len=300, max_len=2_500,
                       mean_dense_gap=2.13, frac_dense=0.8)


_IDX = {}


def indexes(corpus, ranked=False, codecs="svb"):
    """(reference index, the port's index carried over from it)."""
    key = (ranked, codecs)
    if key not in _IDX:
        kw = {}
        if ranked:
            kw["freqs"] = make_freqs(np.random.default_rng(24), corpus)
        ref = ref_build(corpus, "optimal", codecs=codecs, **kw)
        _IDX[key] = (ref, index_from_arrays(index_arrays(ref)))
    return _IDX[key]


def _cursors(rng, corpus, n=400):
    """Cursor batch hammering boundaries: members, gaps, far out of range."""
    terms = rng.integers(0, len(corpus), n)
    probes = rng.integers(0, 4_000_000, n)
    for i in range(0, n, 7):
        seq = corpus[int(terms[i])]
        probes[i] = seq[rng.integers(0, len(seq))]
    return terms, probes


def assert_same_arena(got, want):
    for k in ARENA_FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if w is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), k
    assert (got.stride, got.n_blocks, got.device_ok) == (
        want.stride, want.n_blocks, want.device_ok)
    assert (got.ranked is None) == (want.ranked is None)
    if want.ranked is not None:
        for k in SIDECAR_FIELDS:
            g, w = getattr(got.ranked, k), getattr(want.ranked, k)
            assert g.dtype == w.dtype and np.array_equal(g, w), k
        for k in ("bound_scale", "kmin", "kstep"):
            assert getattr(got.ranked, k) == getattr(want.ranked, k), k


# ----------------------------------------------------------------------
# routing and slicing: the reference's arrays
# ----------------------------------------------------------------------
@pytest.mark.parametrize("replicas", [1, 2, 3])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 5])
def test_routing_and_replica_owners_match_reference(corpus, n_shards,
                                                    replicas):
    lists = np.arange(1000, dtype=np.int64)
    owner = shard_of_list(lists, n_shards)
    assert np.array_equal(owner, ref_shard_of_list(lists, n_shards))
    assert owner.min() >= 0 and owner.max() < n_shards
    if n_shards > 1:  # splitmix spreads consecutive ids
        assert len(np.unique(owner[:16])) > 1
    assert np.array_equal(replica_owners(100, n_shards, replicas),
                          ref_replica_owners(100, n_shards, replicas))
    ref, idx = indexes(corpus)
    got = ShardedArena.build(idx.arena, n_shards, mesh=None,
                             replicas=replicas)
    want = RefSharded.build(ref.arena, n_shards, mesh=None, replicas=replicas)
    assert got.replicas == want.replicas
    for k in ("owner", "local_list", "owner_r", "local_r"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert all(np.array_equal(g, w)
               for g, w in zip(got.lists_of, want.lists_of))


@pytest.mark.parametrize("kind", ["svb", "multi-codec", "ranked"])
@pytest.mark.parametrize("n_shards,replicas", [(1, 1), (3, 1), (5, 2)])
def test_slice_arena_matches_reference(corpus, kind, n_shards, replicas):
    ref, idx = indexes(corpus, ranked=kind == "ranked",
                       codecs="ef" if kind == "multi-codec" else "svb")
    policy = "ef" if kind == "multi-codec" else "svb"
    ra, ta = ref.arena_for(policy), idx.arena_for(policy)
    assert ta.multi == (kind == "multi-codec")
    got = ShardedArena.build(ta, n_shards, mesh=None, replicas=replicas)
    want = RefSharded.build(ra, n_shards, mesh=None, replicas=replicas)
    for g, w in zip(got.shards, want.shards):
        assert_same_arena(g, w)
    for g, w in zip(got.rows_of, want.rows_of):
        assert np.array_equal(g, w)
    assert got.all_device_ok == want.all_device_ok
    assert got.shard_nbytes() == want.shard_nbytes()
    if n_shards == 1:  # a 1-shard slice reproduces the global arena
        sub = got.shards[0]
        assert np.array_equal(sub.block_keys, ta.block_keys)
        assert np.array_equal(sub.list_blk_offsets, ta.list_blk_offsets)
    if kind == "ranked":
        for g, w in zip(got.pivot_chunks, want.pivot_chunks):
            for k in ("qb", "nblk", "base", "offsets"):
                assert np.array_equal(getattr(g, k), getattr(w, k)), k


def test_route_under_dead_masks_matches_reference(corpus):
    ref, idx = indexes(corpus)
    rng = np.random.default_rng(3)
    terms = rng.integers(0, N_LISTS, 200)
    for n_shards, replicas in ((3, 2), (5, 3), (4, 1)):
        got = ShardedArena.build(idx.arena, n_shards, mesh=None,
                                 replicas=replicas)
        want = RefSharded.build(ref.arena, n_shards, mesh=None,
                                replicas=replicas)
        for _ in range(8):
            dead = rng.random(n_shards) < 0.4
            got.dead[:], want.dead[:] = dead, dead
            for g, w in zip(got.route(terms), want.route(terms)):
                assert np.array_equal(g, w)
            assert np.array_equal(got.unserved_lists(), want.unserved_lists())
            for t in range(N_LISTS):
                try:
                    expect = want.route_one(t)
                except Exception as e:  # the reference's ShardsUnavailable
                    with pytest.raises(ShardsUnavailable):
                        got.route_one(t)
                    assert type(e).__name__ == "ShardsUnavailable"
                else:
                    assert got.route_one(t) == expect


# ----------------------------------------------------------------------
# the sharded QueryEngine: identity
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend,mesh", [("torch", "auto"),
                                          ("torch", "list"),
                                          ("numpy", "auto")])
def test_one_shard_bit_identical_query(corpus, backend, mesh):
    """1 shard == unsharded == the reference's 1-shard engine (its ref
    backend runs the shard_map dispatch on the one CPU device)."""
    ref, idx = indexes(corpus)
    rng = np.random.default_rng(5)
    terms, probes = _cursors(rng, corpus)
    kw = dict(backend=backend)
    if backend == "torch":
        kw["device"] = "cpu"
    base = QueryEngine(idx, **kw)
    eng = QueryEngine(idx, shards=1,
                      shard_mesh=["cpu"] if mesh == "list" else mesh, **kw)
    rref = RefQuery(ref, backend="ref", shards=1)
    bv, br = base.search_batch(terms, probes)
    v, r = eng.search_batch(terms, probes)
    wv, wr = rref.search_batch(terms, probes)
    assert rref._smap_fn is not None
    for g in (v, bv):
        assert np.array_equal(g, wv)
    for g in (r, br):
        assert np.array_equal(g, wr)
    assert np.array_equal(eng.member_batch(terms, probes),
                          rref.member_batch(terms, probes))
    queries = [[0, 1], [2, 3, 4], [5], [6, 0], []]
    for q, g in zip(queries, eng.intersect_batch(queries)):
        assert np.array_equal(g, ref.intersect_scalar(q)), q
    assert (eng._smap_fn is not None) == (mesh == "list")
    if backend == "torch":
        assert eng.stats["sharded_batches"] > 0


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_multi_shard_matches_unsharded_and_reference(corpus, backend,
                                                     n_shards):
    ref, idx = indexes(corpus)
    rng = np.random.default_rng(6)
    terms, probes = _cursors(rng, corpus)
    kw = dict(device="cpu") if backend == "torch" else {}
    eng = QueryEngine(idx, backend=backend, shards=n_shards, **kw)
    rref = RefQuery(ref, backend="ref", shards=n_shards, shard_mesh=None)
    bv, br = RefQuery(ref, backend="numpy").search_batch(terms, probes)
    wv, wr = rref.search_batch(terms, probes)
    v, r = eng.search_batch(terms, probes)
    for g, w in ((v, bv), (r, br), (v, wv), (r, wr)):
        assert np.array_equal(g, w)
    queries = [[int(t) for t in q]
               for q in make_queries(rng, len(corpus), 8, 2)]
    for q, g, w in zip(queries, eng.intersect_batch(queries),
                       rref.intersect_batch(queries)):
        assert np.array_equal(g, w), (n_shards, q)
        assert np.array_equal(g, ref.intersect_scalar(q)), (n_shards, q)
    # the routed host path (per-shard EngineCores + scatter merge) is
    # exact as well, on either backend
    v2, r2, p2 = eng._fused_sharded(terms, probes)
    assert np.array_equal(np.where(p2, -1, v2), bv)
    assert np.array_equal(np.where(p2, -1, r2), br)


@pytest.mark.parametrize("mesh", [None, "list"])
def test_empty_shard_is_served_around(corpus, mesh):
    """More shards than lists: empty shards are valid degenerate
    sub-arenas, receive no cursor and never perturb the results."""
    ref, idx = indexes(corpus)
    n_shards = 16
    eng = QueryEngine(idx, device="cpu", shards=n_shards,
                      shard_mesh=["cpu"] * n_shards if mesh else None)
    sa = eng.sharded
    empty = [s for s in range(n_shards) if len(sa.lists_of[s]) == 0]
    assert empty
    for s in empty:
        assert sa.shards[s].n_blocks == 0
        assert np.array_equal(sa.shards[s].list_blk_offsets, [0])
    assert sorted(int(t) for f in sa.lists_of for t in f) == list(
        range(len(corpus)))
    rng = np.random.default_rng(7)
    terms, probes = _cursors(rng, corpus, 200)
    bv, br = RefQuery(ref, backend="numpy").search_batch(terms, probes)
    v, r = eng.search_batch(terms, probes)
    assert np.array_equal(v, bv) and np.array_equal(r, br)
    want = RefQuery(ref, backend="ref", shards=n_shards,
                    shard_mesh=None).search_batch(terms, probes)
    assert np.array_equal(v, want[0]) and np.array_equal(r, want[1])


@pytest.mark.parametrize("n_shards", [1, 3])
def test_duplicate_grouping_across_shard_boundaries(corpus, n_shards):
    """Grouping runs BEFORE routing, so duplicate cursors collapse across
    the whole batch even when their terms hash to different shards."""
    ref, idx = indexes(corpus)
    rng = np.random.default_rng(8)
    base_t = rng.integers(0, len(corpus), 40)
    base_p = rng.integers(0, 3_000, 40)
    terms, probes = np.tile(base_t, 8), np.tile(base_p, 8)
    owners = np.unique(shard_of_list(np.unique(base_t), n_shards))
    assert n_shards == 1 or len(owners) > 1
    want = RefQuery(ref, backend="numpy").search_batch(terms, probes)
    grouped = QueryEngine(idx, device="cpu", shards=n_shards)
    plain = QueryEngine(idx, device="cpu", shards=n_shards, group=False)
    rg = RefQuery(ref, backend="ref", shards=n_shards)
    assert np.array_equal(rg.search_batch(terms, probes)[0], want[0])
    for eng, expect_grouped in ((grouped, True), (plain, False)):
        v, r = eng.search_batch(terms, probes)
        assert np.array_equal(v, want[0]) and np.array_equal(r, want[1])
        assert (eng.stats["grouped_cursors"] > 0) == expect_grouped
    assert grouped.stats["grouped_cursors"] == rg.stats["grouped_cursors"]


@pytest.mark.parametrize("mesh", [None, "list"])
def test_probe_clip_2_31_survives_shard_merge(mesh):
    lists = [np.arange(0, 4_000, 3, dtype=np.int64),
             np.arange(1, 5_000, 2, dtype=np.int64),
             np.arange(2, 6_000, 5, dtype=np.int64)]
    ref = ref_build(lists, "optimal")
    idx = build_partitioned_index(lists, "optimal")
    probes = np.array([2**31 - 1, 2**31, 2**31 + 1, 2**40, -2**33,
                       0, int(lists[0][-1])])
    terms = np.zeros(len(probes), np.int64)
    for n_shards in (1, 2, 3):
        engine = QueryEngine(
            idx, device="cpu", shards=n_shards,
            shard_mesh=["cpu"] * n_shards if mesh else None,
        )
        want = RefQuery(ref, backend="ref", shards=n_shards,
                        shard_mesh=None).next_geq_batch(terms, probes)
        got = engine.next_geq_batch(terms, probes)
        assert np.array_equal(got, want)
        assert (got[:4] == -1).all() and got[4] == 0
        assert got[5] == 0 and got[6] == lists[0][-1]
        member = engine.member_batch(terms, probes)
        assert not member[:4].any() and member[5] and member[6]
        v, _, p = engine._fused_sharded(terms, probes)
        assert np.array_equal(np.where(p, -1, v), got), n_shards


# ----------------------------------------------------------------------
# the sharded TopKEngine: identity
# ----------------------------------------------------------------------
@pytest.mark.parametrize("resident", ["kernel", "mirror"])
@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_ranked_sharded_identity(corpus, backend, n_shards, resident):
    ref, idx = indexes(corpus, ranked=True)
    rng = np.random.default_rng(9)
    queries = [[int(t) for t in q]
               for ar in (2, 3)
               for q in make_queries(rng, len(corpus), 4, ar)]
    rref = RefTopK(ref, backend="ref", seed_blocks=2, shards=n_shards,
                   shard_mesh=None, resident=resident)
    want = rref.topk_batch(queries, 10)
    kw = dict(device="cpu") if backend == "torch" else {}
    eng = TopKEngine(idx, backend=backend, seed_blocks=2, shards=n_shards,
                     resident=resident, **kw)
    got = eng.topk_batch(queries, 10)
    for q, (gd, gs), (wd, ws) in zip(queries, got, want):
        assert np.array_equal(gd, wd), q
        assert np.array_equal(gs, ws), q
    terms = rng.integers(0, len(corpus), 300)
    docs = rng.integers(-5, 4_000_000, 300)
    assert np.array_equal(eng.contributions(terms, docs).view(np.int32),
                          rref.contributions(terms, docs).view(np.int32))
    for k in ("blocks_kept", "blocks_total", "candidates", "scored_pairs"):
        assert eng.stats[k] == rref.stats[k], k


# ----------------------------------------------------------------------
# the device-list dispatch: one device per shard, shards sharing a device
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_device_list_dispatch_equals_host_loop(corpus, n_shards):
    """The reference's forced-device-count subprocess, without one: the
    dispatch over ``[cpu] * S`` equals the host loop and the unsharded
    engine, boolean and ranked in both residencies."""
    ref, idx = indexes(corpus, ranked=True)
    rng = np.random.default_rng(1)
    terms, probes = _cursors(rng, corpus)
    mesh = ["cpu"] * n_shards
    bv, br = RefQuery(ref, backend="numpy").search_batch(terms, probes)
    e = QueryEngine(idx, device="cpu", shards=n_shards, shard_mesh=mesh)
    loop = QueryEngine(idx, device="cpu", shards=n_shards, shard_mesh=None)
    v, r = e.search_batch(terms, probes)
    assert e._smap_fn is not None and loop._smap_fn is None
    lv, lr = loop.search_batch(terms, probes)
    for g in (v, lv):
        assert np.array_equal(g, bv)
    for g in (r, lr):
        assert np.array_equal(g, br)
    queries = [[int(t) for t in q] for q in make_queries(rng, N_LISTS, 6, 2)]
    want = RefTopK(ref, backend="numpy", seed_blocks=2).topk_batch(queries, 10)
    ct = rng.integers(0, N_LISTS, 300)
    cd = rng.integers(-5, 3_000_000, 300)
    cw = RefTopK(ref, backend="numpy", seed_blocks=2).contributions(ct, cd)
    for resident in ("mirror", "kernel"):
        t = TopKEngine(idx, device="cpu", seed_blocks=2, shards=n_shards,
                       shard_mesh=mesh, resident=resident)
        got = t.topk_batch(queries, 10)
        for (gd, gs), (wd, ws) in zip(got, want):
            assert np.array_equal(gd, wd) and np.array_equal(gs, ws)
        assert np.array_equal(t.contributions(ct, cd), cw)
        assert t._smap_fn is not None
        assert (t._smap_pivot is not None) == (resident == "kernel")


def test_device_list_max_bucket_rounds(corpus):
    """A shard's run longer than ``max_bucket`` is served in rounds, each
    staging at most ``max_bucket`` cursors per shard: same answers."""
    _, idx = indexes(corpus)
    rng = np.random.default_rng(11)
    terms, probes = _cursors(rng, corpus, 500)
    eng = QueryEngine(idx, device="cpu", shards=3, shard_mesh=["cpu"] * 3)
    sa = eng.sharded
    owner, local, _ = sa.route(terms)
    order = np.argsort(owner, kind="stable")
    cuts = np.searchsorted(owner[order], np.arange(sa.n_shards + 1))
    whole = ShardMapSearch(sa)(local[order], probes[order], cuts)
    staged = []
    rounds = ShardMapSearch(sa, max_bucket=7)
    inner = rounds._dispatch

    def spy(lt, pr, c):
        staged.append(int(np.diff(c).max()))
        return inner(lt, pr, c)

    rounds._dispatch = spy
    got = rounds(local[order], probes[order], cuts)
    assert len(staged) == -(-int(np.diff(cuts).max()) // 7) > 1
    assert max(staged) <= 7
    for g, w in zip(got, whole):
        assert np.array_equal(g, w)
    v, _ = QueryEngine(idx, backend="numpy").search_batch(terms, probes)
    assert np.array_equal(np.where(whole[0] < 0, -1, whole[0]), v[order])


def test_device_list_releases_host_slices(corpus):
    """Once each shard's tensors are on its device the host sub-arena
    slices are released; a later access rebuilds them."""
    _, idx = indexes(corpus)
    rng = np.random.default_rng(4)
    terms, probes = _cursors(rng, corpus, 100)
    eng = QueryEngine(idx, device="cpu", shards=1, shard_mesh=["cpu"])
    want = QueryEngine(idx, backend="numpy").search_batch(terms, probes)
    assert np.array_equal(eng.search_batch(terms, probes)[0], want[0])
    assert eng._smap_fn is not None
    assert eng.sharded._shards is None
    assert eng.sharded.shard_device_nbytes()[0] > 0
    assert eng.sharded.shards[0].n_blocks == idx.arena.n_blocks


def test_explicit_device_list_errors(corpus):
    ref, idx = indexes(corpus)
    a = idx.arena
    with pytest.raises(ValueError, match="shard"):
        ShardedArena.build(a, 2, mesh=["cpu"])
    with pytest.raises(ValueError, match="shard"):
        ShardedArena.build(a, 1, mesh="cpu")
    with pytest.raises(ValueError, match="shard"):
        QueryEngine(idx, device="cpu", shards=3, shard_mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="shard_mesh"):
        EngineConfig(shards=2, shard_mesh=["cpu"] * 3)
    assert ShardedArena.build(a, 2, mesh=["cpu", "cpu"]).mesh == [
        __import__("torch").device("cpu")] * 2
    # "auto" off CUDA means the host loop
    assert ShardedArena.build(a, 2, mesh="auto", device="cpu").mesh is None
    # the dispatch is single-codec: an explicit list on a multi-codec
    # arena raises, "auto" falls to the host loop
    _, midx = indexes(corpus, codecs="ef")
    ma = midx.arena_for("ef")
    assert ma.multi
    with pytest.raises(ValueError, match="single-codec"):
        ShardedArena.build(ma, 2, mesh=["cpu"] * 2)
    assert ShardedArena.build(ma, 2, mesh="auto", device="cpu").mesh is None
    with pytest.raises(ValueError, match="shard_mesh"):
        EngineConfig(shards=2, shard_mesh=["cpu"] * 2).to_json()
    with pytest.raises(ValueError, match="fused"):
        QueryEngine(idx, device="cpu", shards=2, fused=False)
