"""The slice as a whole: the port's QueryEngine against the JAX package's.

The port's ``torch`` backend (on the CPU: the plain versions of the three
kernels) and its ``numpy`` backend are held exactly to the reference's
``ref`` (jitted device pipeline) and ``numpy`` backends on every batched
entry point, over single- and multi-codec arenas, with the flat mirror
built and refused, on the partition-LRU path and with grouped cursors.
"""

import numpy as np
import pytest

from repro.core.index import build_partitioned_index as ref_build
from repro.core.query_engine import QueryEngine as RefEngine
from repro.data.postings import make_corpus, make_queries

from repro_torch.api import EngineConfig, make_query_engine
from repro_torch.convert import index_arrays, index_from_arrays
from repro_torch.core.arena import CODEC_EF
from repro_torch.core.query_engine import QueryEngine

EDGE_PROBES = [2**31 + 5, 2**40, -7, 0]
SMALL_CACHE = 64 << 10  # refuses the flat mirror: the row-LRU path serves


def _cut_at(points):
    def partitioner(gaps):
        pts = sorted(set(int(p) for p in points) | {len(gaps)})
        return np.asarray([p for p in pts if 0 < p <= len(gaps)], np.int64)

    return partitioner


def _corpus(kind):
    """(lists, build kwargs): the generator's corpus, or clustered runs
    (Elias-Fano) beside sparse one-byte gaps (Stream-VByte)."""
    rng = np.random.default_rng(17)
    if kind == "generator":
        lists = make_corpus(rng, n_lists=6, min_len=300, max_len=4_000)
        return lists, dict(strategy="optimal")
    low = np.cumsum(rng.choice([1, 2, 6, 10, 20, 30], size=700)) - 1
    sparse = low[-1] + 1 + np.cumsum(rng.integers(65, 128, size=1500))
    lists = [np.concatenate([low, sparse]),
             np.unique(np.concatenate([low[::3], sparse[::2]])),
             np.unique(np.concatenate([low[1::2], sparse[::5]])),
             sparse[1::3].copy()]
    return [x.astype(np.int64) for x in lists], dict(partitioner=_cut_at([300, 700]))


_CACHE = {}


def indexes(kind, codecs="auto"):
    """(reference index, port index carried over from it)."""
    key = (kind, codecs)
    if key not in _CACHE:
        lists, kw = _corpus(kind)
        ref = ref_build(lists, codecs=codecs, **kw)
        _CACHE[key] = (lists, ref, index_from_arrays(index_arrays(ref)))
    return _CACHE[key]


def _cursors(lists, rng, n=150):
    terms = rng.integers(0, len(lists), n)
    probes = np.array([
        lists[t][rng.integers(0, len(lists[t]))] + rng.integers(-1, 2)
        for t in terms
    ])
    # edge probes on list 0, a list endpoint, and repeats of every cursor
    edge = np.array(EDGE_PROBES + [int(lists[0][-1]), int(lists[1][-1]) + 1])
    terms = np.concatenate([terms, [0] * 5 + [1], terms[:20]])
    probes = np.concatenate([probes, edge, probes[:20]])
    return terms.astype(np.int64), probes.astype(np.int64)


def assert_engines_agree(port, ref, lists, seed=0):
    rng = np.random.default_rng(seed)
    terms, probes = _cursors(lists, rng)
    for op in ("next_geq_batch", "member_batch", "search_batch"):
        got, want = getattr(port, op)(terms, probes), getattr(ref, op)(terms, probes)
        for g, w in zip(got if op == "search_batch" else [got],
                        want if op == "search_batch" else [want]):
            assert np.array_equal(g, w), op
    queries = [list(map(int, q)) for q in make_queries(rng, len(lists), 12, 2)]
    queries += [list(map(int, q)) for q in make_queries(rng, len(lists), 6, 3)]
    queries += [[0], [], [1, 1]]
    got, want = port.intersect_batch(queries), ref.intersect_batch(queries)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("policy", ["svb", "auto", "ef"])
@pytest.mark.parametrize("kind", ["generator", "mixed"])
def test_torch_backend_matches_reference_device_pipeline(kind, policy):
    lists, ref_idx, idx = indexes(kind)
    port = QueryEngine(idx, device="cpu", codec_policy=policy)
    assert port.backend == "torch"
    ref = RefEngine(ref_idx, backend="ref", codec_policy=policy)
    assert_engines_agree(port, ref, lists)
    if kind == "mixed" and policy != "svb":
        assert port.arena.multi and (port.arena.block_codec == CODEC_EF).any()


@pytest.mark.parametrize("policy", ["svb", "auto", "ef"])
@pytest.mark.parametrize("cache_bytes", [None, SMALL_CACHE], ids=["flat", "row-lru"])
def test_numpy_backend_matches_reference_numpy(policy, cache_bytes):
    lists, ref_idx, idx = indexes("mixed")
    kw = {} if cache_bytes is None else dict(cache_bytes=cache_bytes)
    port = QueryEngine(idx, backend="numpy", codec_policy=policy, **kw)
    ref = RefEngine(ref_idx, backend="numpy", codec_policy=policy, **kw)
    assert_engines_agree(port, ref, lists, seed=1)
    assert port._flat_ok is (cache_bytes is None)
    assert dict(port.stats) == {k: v for k, v in ref.stats.items() if k in port.stats}


@pytest.mark.parametrize("cache_bytes", [None, SMALL_CACHE], ids=["flat", "row-lru"])
def test_torch_backend_flat_mirror_and_row_lru(cache_bytes):
    """List decode runs the decode_blocks path through the flat mirror (built
    in one call) or the byte-budgeted row LRU (mirror refused)."""
    lists, ref_idx, idx = indexes("generator", "svb")
    kw = {} if cache_bytes is None else dict(cache_bytes=cache_bytes)
    port = QueryEngine(idx, device="cpu", **kw)
    ref = RefEngine(ref_idx, backend="ref", **kw)
    assert_engines_agree(port, ref, lists, seed=2)
    if cache_bytes is None:
        assert port._flat_ok and port.stats["decoded_rows"] == port.arena.n_blocks
    else:
        assert port._flat_ok is False and port.stats["evictions"] > 0


@pytest.mark.parametrize("policy", ["svb", "auto"])
def test_partition_lru_path(policy):
    lists, ref_idx, idx = indexes("mixed")
    port = QueryEngine(idx, device="cpu", fused=False, codec_policy=policy,
                       cache_bytes=SMALL_CACHE)
    ref = RefEngine(ref_idx, backend="ref", fused=False, codec_policy=policy,
                    cache_bytes=SMALL_CACHE)
    assert_engines_agree(port, ref, lists, seed=3)
    assert port.stats["decoded_parts"] > 0


def test_grouped_duplicate_cursors():
    lists, ref_idx, idx = indexes("mixed")
    terms, probes = _cursors(lists, np.random.default_rng(4))
    terms, probes = np.tile(terms, 3), np.tile(probes, 3)
    grouped = QueryEngine(idx, device="cpu")
    plain = QueryEngine(idx, device="cpu", group=False)
    want = RefEngine(ref_idx, backend="ref").search_batch(terms, probes)
    for eng in (grouped, plain):
        got = eng.search_batch(terms, probes)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert grouped.stats["grouped_cursors"] >= 2 * len(terms) // 3
    assert plain.stats["grouped_cursors"] == 0


def test_probes_past_int32_range():
    """Probes >= 2^31 resolve past the end (never wrap to probe 0), as in
    ``test_fused_search``; a list endpoint is found and is a member."""
    lists, ref_idx, idx = indexes("generator", "svb")
    probes = np.array(EDGE_PROBES + [int(lists[0][-1])], np.int64)
    terms = np.zeros(len(probes), np.int64)
    want = RefEngine(ref_idx, backend="numpy").next_geq_batch(terms, probes)
    assert want[0] == -1 and want[1] == -1 and want[4] == lists[0][-1]
    for backend in ("torch", "numpy"):
        e = QueryEngine(idx, backend=backend, device="cpu")
        assert np.array_equal(e.next_geq_batch(terms, probes), want), backend
        assert e.member_batch(terms, probes).tolist() == [
            False, False, False, lists[0][0] == 0, True]


def test_device_ok_false_arena():
    """Keys past int32 (the reference's ``device_ok`` is False): the torch
    backend serves the index on its device over int64 keys, with no numpy
    span, and both backends answer as the reference's ``ref`` and
    ``numpy`` backends do (the reference serves both from its host
    mirror)."""
    from repro_torch import obs

    rng = np.random.default_rng(5)
    lists = [np.sort(rng.choice(2**30, 800, replace=False)).astype(np.int64)
             for _ in range(3)]
    ref_idx = ref_build(lists, "optimal")
    idx = index_from_arrays(index_arrays(ref_idx))
    arena = idx.arena_for("auto")
    assert not arena.device_ok and arena.stride_ok
    was = obs.enabled()
    obs.enable(True)
    obs.clear_trace()
    try:
        port = QueryEngine(idx, device="cpu")
        assert port._use_device
        for backend in ("numpy", "ref"):
            assert_engines_agree(port, RefEngine(ref_idx, backend=backend),
                                 lists)
        spans = [e for e in obs.events() if e["name"] == "decode_search"]
    finally:
        obs.clear_trace()
        obs.enable(was)
    assert spans and {e["backend"] for e in spans} == {"torch"}
    host = QueryEngine(idx, backend="numpy")
    assert_engines_agree(host, RefEngine(ref_idx, backend="numpy"), lists)


def test_engine_feeds_the_kernels_what_they_accept(monkeypatch):
    """The resident pipeline hands every kernel wrapper int32/uint8,
    contiguous, aligned tensors of the shapes the CUDA launch checks demand
    (on the CPU the plain versions would take anything)."""
    import torch

    from repro_torch.core import engine_core
    from repro_torch.kernels.vbyte_decode.kernel import require

    seen = []

    def checked(fn, spec):
        def wrapper(*args, **kw):
            tensors = list(args) + [kw.get("codec_row")]
            for t, (name, dtype, width, ndim) in zip(tensors, spec):
                if t is not None:
                    require(t, name, dtype, width, ndim)
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return wrapper

    i32, u8 = torch.int32, torch.uint8
    vec = lambda name: (name, i32, None, 1)  # noqa: E731
    monkeypatch.setattr(engine_core, "decode_search", checked(
        engine_core.decode_search,
        [("lens", i32, 128, 2), ("data", u8, 512, 2), vec("block_base"),
         vec("rows"), vec("pe"), vec("codec_row")]))
    monkeypatch.setattr(engine_core, "ef_search", checked(
        engine_core.ef_search,
        [("lo", i32, 128, 2), ("hi", i32, 24, 2), vec("lbits"),
         vec("block_base"), vec("rows"), vec("pe"), vec("codec_row")]))
    monkeypatch.setattr(engine_core, "decode_blocks", checked(
        engine_core.decode_blocks,
        [("lens", i32, 128, 2), ("data", u8, 512, 2), vec("rows")]))
    lists, ref_idx, idx = indexes("mixed")
    for policy, cache in (("auto", None), ("svb", SMALL_CACHE)):
        eng = QueryEngine(idx, device="cpu", codec_policy=policy,
                          **({} if cache is None else dict(cache_bytes=cache)))
        assert_engines_agree(eng, RefEngine(ref_idx, backend="ref",
                                            codec_policy=policy), lists)
    assert set(seen) == {"decode_search", "ef_search", "decode_blocks"}


def test_config_facade():
    lists, ref_idx, idx = indexes("generator", "svb")
    eng = make_query_engine(idx, EngineConfig(device="cpu", codec_policy="ef"))
    assert eng.backend == "torch" and str(eng.device) == "cpu"
    assert eng.arena is idx.arena_for("ef")
    assert EngineConfig.from_json(eng.config.to_json()) == eng.config
    # sharding through the same facade: a 2-shard engine answers as the
    # unsharded one
    sharded = make_query_engine(idx, EngineConfig(device="cpu",
                                                  codec_policy="ef", shards=2))
    assert sharded.sharded is not None and sharded.sharded.n_shards == 2
    rng = np.random.default_rng(3)
    terms = rng.integers(0, len(lists), 64)
    probes = rng.integers(0, int(max(l[-1] for l in lists)) + 10, 64)
    for g, w in zip(sharded.search_batch(terms, probes),
                    eng.search_batch(terms, probes)):
        assert np.array_equal(g, w)
    with pytest.raises(TypeError, match="EngineConfig"):
        QueryEngine(idx, device="cpu", resident_typo=1)
    with pytest.raises(ValueError, match="backend"):
        EngineConfig(backend="pallas")
