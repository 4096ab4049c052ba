"""Wide indexes on the torch backend: int64 locate keys against the JAX
package.

The reference narrows its device keys to int32 (a TPU runs JAX with x64
off), so an arena whose ``(n_lists + 1) * stride`` passes 2^31 has
``device_ok`` False and the reference's device backends serve it from the
host mirror.  The port keeps ``block_keys`` int64 on the device and forms
``probe + term * stride`` in int64, so its torch backend serves such an
index through the device pipeline; only a docID that the kernels' int32
values cannot hold (a stride of 2^31 - 130 or more) is refused.

Held here, on the CPU (the kernels' plain versions), exactly: the boolean
entry points over the reference's EF tiles near 2^31 and over a wide
index of many lists, ranked top-k in both residencies, two shards (the
host loop and the device-list dispatch), a shard recovered from its arena
checkpoint, the graph store and the multi-hot decode, each against the
reference's ``ref`` engines (and ``exhaustive_topk``), with the device
path shown to have run (no numpy ``decode_search`` span; the kernel
wrappers called).
"""

import contextlib

import numpy as np
import pytest
import torch

from repro.core.index import build_partitioned_index as ref_build
from repro.core.query_engine import QueryEngine as RefEngine
from repro.data.graph_data import CompressedGraphStore as RefStore
from repro.data.postings import make_freqs
from repro.data.recsys_data import decode_multihot_batch as ref_multihot
from repro.ranked.bm25 import exhaustive_topk as ref_exhaustive
from repro.ranked.topk_engine import TopKEngine as RefTopK

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import index_arrays, index_from_arrays
from repro_torch.core import engine_core, shard
from repro_torch.core.arena import CODEC_EF, STRIDE_LIMIT, TAG_EF
from repro_torch.core.engine_core import locate_graph
from repro_torch.core.query_engine import QueryEngine
from repro_torch.data.graph_data import CompressedGraphStore
from repro_torch.data.recsys_data import decode_multihot_batch
from repro_torch.distributed.resilient import (
    HEALTHY,
    ResilientEngine,
    ShardFaultInjector,
)
from repro_torch.ranked import topk_engine
from repro_torch.ranked.bm25 import exhaustive_topk
from repro_torch.ranked.topk_engine import TopKEngine

N_WIDE = 600  # lists of the wide corpus: 301 * stride passes 2^31, so
UNIVERSE = 1 << 23  # each of two shards' keys do too
KERNELS = ((engine_core, "decode_search"), (engine_core, "ef_search"),
           (engine_core, "decode_blocks"), (engine_core, "pivot_select"),
           (engine_core, "pivot_score"), (topk_engine, "bm25_score_probe"),
           (topk_engine, "bm25_score_rows"), (topk_engine, "ef_search"),
           (shard, "decode_search"), (shard, "bm25_score_probe"))


def _clustered(rng, n):
    """Gaps in EF's winning band (the reference test's helper)."""
    return np.cumsum(rng.choice([1, 2, 6, 10, 20, 30], size=n)).astype(
        np.int64
    ) - 1


def _cut_at(points):
    """A partitioner returning fixed endpoints (the reference test's)."""

    def partitioner(gaps):
        pts = sorted(set(int(p) for p in points) | {len(gaps)})
        return np.asarray([p for p in pts if 0 < p <= len(gaps)], np.int64)

    return partitioner


def _wide_corpus():
    """N_WIDE lists over [0, 2^23): most short, a few of thousands of
    docIDs (several blocks, so Block-Max has bounds to prune on), every
    list reaching near the top of the universe so the stride is ~2^23."""
    rng = np.random.default_rng(31)
    lens = np.clip((20 * rng.zipf(1.6, N_WIDE)), 20, 6000)
    lens[:3] = 6000
    lists = []
    for n in lens:
        ids = np.unique(rng.integers(0, UNIVERSE - 1, int(n)))
        lists.append(np.append(ids[ids < UNIVERSE - 8], UNIVERSE - 8 + (
            len(lists) % 5)).astype(np.int64))
    return lists, rng


_IDX = {}


def wide(ranked=False, codecs="auto"):
    """(lists, the reference's index, the port's index carried over)."""
    key = (ranked, codecs)
    if key not in _IDX:
        lists, rng = _wide_corpus()
        kw = {"freqs": make_freqs(rng, lists)} if ranked else {}
        ref = ref_build(lists, "optimal", codecs=codecs, **kw)
        _IDX[key] = (lists, ref, index_from_arrays(index_arrays(ref)))
    return _IDX[key]


@contextlib.contextmanager
def device_path(monkeypatch):
    """Count the kernel wrappers' calls and collect the ``decode_search``
    spans' backends while the block runs."""
    calls = {}
    for mod, name in KERNELS:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=f"{mod.__name__}.{name}", **kw):
            calls[_key] = calls.get(_key, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    was = obs.enabled()
    obs.enable(True)
    obs.clear_trace()
    seen = {"calls": calls}
    try:
        yield seen
        seen["spans"] = {e["backend"] for e in obs.events()
                         if e["name"] == "decode_search"}
    finally:
        obs.clear_trace()
        obs.enable(was)


def _called(seen, name):
    return sum(n for k, n in seen["calls"].items() if k.endswith("." + name))


def _cursors(lists, rng, n=600):
    terms = rng.integers(0, len(lists), n)
    probes = np.array([lists[t][rng.integers(0, len(lists[t]))]
                       + rng.integers(-1, 2) for t in terms])
    last = len(lists) - 1  # the largest keys: term * stride past 2^31
    edge_t = [last, last, last, 0, last]
    edge_p = [0, int(lists[last][-1]), int(lists[last][-1]) + 1, 2**31 + 5,
              2**40]
    return (np.concatenate([terms, edge_t]).astype(np.int64),
            np.concatenate([probes, edge_p]).astype(np.int64))


def _queries(rng, n_lists, n=40):
    qs = [sorted(map(int, rng.choice(n_lists, 2, replace=False)))
          for _ in range(n)]
    return qs + [[0, 1, 2], [n_lists - 1, n_lists - 2], [n_lists - 1]]


def assert_boolean_equal(port, ref, lists, seed=0):
    rng = np.random.default_rng(seed)
    terms, probes = _cursors(lists, rng)
    for op in ("next_geq_batch", "member_batch"):
        got, want = getattr(port, op)(terms, probes), getattr(ref, op)(terms, probes)
        assert np.array_equal(got, want), op
    for g, w in zip(port.search_batch(terms, probes),
                    ref.search_batch(terms, probes)):
        assert np.array_equal(g, w)
    queries = _queries(rng, len(lists))
    for g, w in zip(port.intersect_batch(queries), ref.intersect_batch(queries)):
        assert np.array_equal(g, w)


# ----------------------------------------------------------------------
# the arena's keys
# ----------------------------------------------------------------------
def test_wide_arena_keeps_int64_keys_on_the_device():
    """One wide arena: keys past 2^31 (the reference's gate fails, the
    stride gate passes); the device copy is int64 and equal to the host's
    (an int32 copy would wrap); a locate over it equals numpy's int64
    searchsorted, also for the last list's cursors."""
    lists, ref, idx = wide()
    a, ra = idx.arena_for("auto"), ref.arena_for("auto")
    assert a.block_keys.max() >= 2**31 and a.stride < STRIDE_LIMIT
    assert a.stride == ra.stride and a.stride_ok
    assert a.device_ok is ra.device_ok is False
    assert (a.block_keys.astype(np.int32) != a.block_keys).any()  # would wrap
    dev = a.on("cpu")
    assert dev.block_keys.dtype == torch.int64
    assert torch.equal(dev.block_keys, torch.from_numpy(a.block_keys))
    assert dev.block_base.dtype == torch.int32  # the rest stays int32
    terms, probes = _cursors(lists, np.random.default_rng(1))
    t = torch.from_numpy(terms.astype(np.int32))
    p = torch.from_numpy(np.clip(probes, 0, a.stride - 1).astype(np.int32))
    rows, pe, past = locate_graph(dev.block_keys, dev.list_blk_offsets,
                                  a.stride, a.n_blocks, t, p)
    assert rows.dtype == torch.int32 and pe.dtype == torch.int32
    pc = np.clip(probes, 0, a.stride - 1)
    k = np.searchsorted(a.block_keys, pc + terms * a.stride, side="left")
    want_past = k >= a.list_blk_offsets[terms + 1]
    assert np.array_equal(past.numpy(), want_past)
    assert np.array_equal(rows.numpy(), np.minimum(k, a.n_blocks - 1))
    assert want_past.any() and (~want_past).any()
    assert (terms * a.stride >= 2**31).sum() > 50


# ----------------------------------------------------------------------
# boolean serving
# ----------------------------------------------------------------------
def test_ef_blocks_survive_2_31_probe_clip(monkeypatch):
    """The reference's ``test_multicodec`` case on the torch backend: EF
    tiles just below 2^31 (two lists: the reference's device_ok is False);
    probes straddling 2^31 clip to past-the-end, a huge negative probe
    clips to 0, in-range probes resolve inside the EF tiles; every answer
    equals the reference's ``ref`` backend, and the device pipeline ran."""
    rng = np.random.default_rng(0)
    low = _clustered(rng, 400)
    hi = (2**31 - 3_000_000) + np.cumsum(
        rng.choice([1, 2, 6, 10, 20, 30], size=3000)
    ).astype(np.int64)
    l0 = np.concatenate([low, hi])
    l1 = np.unique(np.concatenate([low[::2], hi[::3], hi[1:200]]))
    cuts = [400, 401] + list(range(401 + 1024, 3400, 1024))
    ref_idx = ref_build([l0, l1], partitioner=_cut_at(cuts), codecs="auto")
    idx = index_from_arrays(index_arrays(ref_idx))
    assert (np.asarray(idx.tags) == TAG_EF).sum() > 0
    arena = idx.arena_for("auto")
    assert arena.multi and (arena.block_codec == CODEC_EF).any()
    assert (arena.block_base[arena.block_codec == CODEC_EF] > 2**30).any()
    assert not arena.device_ok and arena.stride_ok
    ref = RefEngine(ref_idx, backend="ref", codec_policy="auto")
    probes = np.array(
        [2**31 - 1, 2**31, 2**31 + 1, 2**40, -(2**33), 0, int(hi[0]) + 1],
        np.int64,
    )
    terms = np.zeros(len(probes), np.int64)
    with device_path(monkeypatch) as seen:
        eng = QueryEngine(idx, device="cpu", codec_policy="auto")
        got = eng.next_geq_batch(terms, probes)
        member = eng.member_batch(terms, probes)
        inter = eng.intersect_batch([[0, 1], [1, 0]])
        both = np.concatenate([terms, terms + 1])
        pair = eng.next_geq_batch(both, np.concatenate([probes, probes]))
    assert (got[:4] == -1).all()  # >= 2^31 - 1 > last value: past the end
    assert got[4] == l0[0] and got[5] == l0[0]
    assert got[6] == hi[1]  # resolved inside an EF tile
    assert np.array_equal(got, ref.next_geq_batch(terms, probes))
    assert np.array_equal(member, ref.member_batch(terms, probes))
    assert np.array_equal(pair, ref.next_geq_batch(
        both, np.concatenate([probes, probes])))
    want = np.asarray(idx.intersect_scalar([0, 1]))
    for g, w in zip(inter, ref.intersect_batch([[0, 1], [1, 0]])):
        assert np.array_equal(g, w) and np.array_equal(g, want)
    assert seen["spans"] == {"torch"}
    assert _called(seen, "ef_search") > 0


@pytest.mark.parametrize("policy", ["svb", "auto", "ef"])
def test_wide_index_boolean_matches_reference(monkeypatch, policy):
    lists, ref_idx, idx = wide()
    with device_path(monkeypatch) as seen:
        port = QueryEngine(idx, device="cpu", codec_policy=policy)
        assert port._use_device
        for backend in ("ref", "numpy"):
            assert_boolean_equal(
                port, RefEngine(ref_idx, backend=backend, codec_policy=policy),
                lists)
    assert seen["spans"] == {"torch"}
    assert _called(seen, "decode_search") + _called(seen, "ef_search") > 0
    if policy == "ef":
        assert _called(seen, "ef_search") > 0


# ----------------------------------------------------------------------
# ranked serving
# ----------------------------------------------------------------------
@pytest.mark.parametrize("resident", ["kernel", "mirror"])
def test_wide_index_topk_matches_exhaustive_and_reference(monkeypatch,
                                                           resident):
    lists, ref_idx, idx = wide(ranked=True)
    rng = np.random.default_rng(7)
    queries = _queries(rng, len(lists), 24)
    want = exhaustive_topk(idx, queries, 10)
    ref = RefTopK(ref_idx, backend="ref", resident=resident,
                  codec_policy="auto").topk_batch(queries, 10)
    terms, docs = _cursors(lists, rng, 400)
    with device_path(monkeypatch) as seen:
        eng = TopKEngine(idx, resident=resident, device="cpu",
                         codec_policy="auto")
        got = eng.topk_batch(queries, 10)
        contrib = eng.contributions(terms, docs)
    for (gd, gs), (wd, ws), (rd, rs), (xd, xs) in zip(
            got, want, ref, ref_exhaustive(ref_idx, queries, 10)):
        assert np.array_equal(gd, wd) and np.array_equal(gs, ws)
        assert np.array_equal(gd, rd) and np.array_equal(gs, rs)
        assert np.array_equal(gd, xd) and np.array_equal(gs, xs)
    ref_contrib = RefTopK(ref_idx, backend="numpy").contributions(terms, docs)
    assert np.array_equal(contrib.view(np.int32), ref_contrib.view(np.int32))
    assert (contrib > 0).sum() > 100
    assert _called(seen, "bm25_score_probe") + _called(seen, "ef_search") > 0
    if resident == "kernel":
        assert _called(seen, "pivot_select") + _called(seen, "pivot_score") > 0
    assert "numpy" not in seen["spans"]


# ----------------------------------------------------------------------
# shards, and a shard recovered from its checkpoint
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh", [None, ["cpu", "cpu"]],
                         ids=["host-loop", "device-list"])
def test_two_shards_over_a_wide_index(monkeypatch, mesh):
    """Two shards: the host loop of per-shard cores (multi-codec) or the
    device-list dispatch (single-codec), boolean and ranked, equal to the
    reference's unsharded ``ref`` answers."""
    policy = "auto" if mesh is None else "svb"
    lists, ref_idx, idx = wide(ranked=True)
    ref = RefEngine(ref_idx, backend="ref", codec_policy=policy)
    rng = np.random.default_rng(9)
    queries = _queries(rng, len(lists), 16)
    with device_path(monkeypatch) as seen:
        sharded = QueryEngine(idx, device="cpu", shards=2, shard_mesh=mesh,
                              codec_policy=policy)
        assert (sharded.sharded.mesh is None) == (mesh is None)
        assert_boolean_equal(sharded, ref, lists, seed=3)
        tk = TopKEngine(idx, device="cpu", shards=2, shard_mesh=mesh,
                        resident="kernel", codec_policy=policy)
        got = tk.topk_batch(queries, 10)
    assert sharded.stats["sharded_batches"] > 0
    assert not sharded.sharded.all_device_ok  # the reference's gate
    assert all(sub.block_keys.max() >= 2**31 for sub in sharded.sharded.shards)
    for (gd, gs), (wd, ws) in zip(got, exhaustive_topk(idx, queries, 10)):
        assert np.array_equal(gd, wd) and np.array_equal(gs, ws)
    assert seen["spans"] <= {"torch"}
    assert _called(seen, "decode_search") > 0


def test_wide_shard_recovered_from_its_checkpoint(tmp_path):
    lists, ref_idx, idx = wide()
    queries = _queries(np.random.default_rng(4), len(lists), 30)
    want = RefEngine(ref_idx, backend="ref").intersect_batch(queries)
    res = ResilientEngine(
        QueryEngine(idx, device="cpu", shards=2, shard_mesh=None),
        injector=ShardFaultInjector(at_batches=(1,), shards=(0,)),
        manager=CheckpointManager(tmp_path, async_save=False),
        backoff_s=1e-4,
    )
    res.checkpoint()
    got = []
    for i in range(0, len(queries), 6):
        out, info = res.intersect_batch(queries[i : i + 6])
        assert not info.degraded
        got += out
    assert res.stats["recoveries"] == 1 and res.health == [HEALTHY] * 2
    sub = res.sa.shards[0]
    assert sub.stride == idx.arena_for("auto").stride and sub.stride_ok
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# ----------------------------------------------------------------------
# the stores over lists whose ids reach 2^30
# ----------------------------------------------------------------------
def test_graph_store_and_multihot_over_wide_lists(monkeypatch):
    rng = np.random.default_rng(12)
    lists = [np.sort(rng.choice(2**30, n, replace=False)).astype(np.int64)
             for n in (700, 300, 1500)]
    lists[2][-1] = 2**30 + 7
    ref_store = RefStore(lists)
    with device_path(monkeypatch) as seen:
        store = CompressedGraphStore(lists, device="cpu")
        assert not store.index.arena_for("auto").device_ok
        for u in range(3):
            got = store.neighbors(u)
            assert np.array_equal(got, ref_store.neighbors(u))
            assert np.array_equal(got, lists[u])
        users = np.array([2, 0, 1, 2, 2])
        ids, mask = decode_multihot_batch(store.index, users, 512,
                                          device="cpu")
    want_ids, want_mask = ref_multihot(ref_store.index, users, 512)
    assert ids.dtype == want_ids.dtype == np.int32
    assert np.array_equal(ids, want_ids) and np.array_equal(mask, want_mask)
    assert ids.max() > 2**29
    assert _called(seen, "decode_blocks") > 0 and "numpy" not in seen["spans"]


# ----------------------------------------------------------------------
# the one refusal left
# ----------------------------------------------------------------------
def test_docid_past_the_stride_limit_is_refused():
    """A docID of 2^31 - 100: the stride passes 2^31 - 130, so the kernels'
    int32 values cannot hold it and the torch backend refuses, naming the
    stride gate; the numpy backend answers as the reference's."""
    rng = np.random.default_rng(3)
    lists = [np.sort(rng.choice(2**30, 500, replace=False)).astype(np.int64),
             np.array([5, 70, 2**31 - 100], np.int64)]
    ref_idx = ref_build(lists, "optimal")
    idx = index_from_arrays(index_arrays(ref_idx))
    arena = idx.arena_for("auto")
    assert arena.stride >= STRIDE_LIMIT and not arena.stride_ok
    with pytest.raises(RuntimeError, match="stride_ok is False"):
        QueryEngine(idx, device="cpu")
    with pytest.raises(RuntimeError, match="2\\^31 - 130"):
        QueryEngine(idx, device="cpu", shards=2)
    host = QueryEngine(idx, backend="numpy")
    want = RefEngine(ref_idx, backend="numpy")
    terms = np.array([1, 1, 1, 0, 1], np.int64)
    probes = np.array([0, 71, 2**31 - 101, 2**31 - 99, 2**31 + 3], np.int64)
    assert np.array_equal(host.next_geq_batch(terms, probes),
                          want.next_geq_batch(terms, probes))
    assert host.next_geq_batch(terms, probes)[2] == 2**31 - 100
