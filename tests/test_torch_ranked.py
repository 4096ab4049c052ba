"""The ranked slice as a whole: the port's TopKEngine against the JAX package.

The port's ``torch`` backend (on the CPU: the plain versions of the
kernels) and its ``numpy`` backend, in both residencies, are held exactly
to the reference's ``TopKEngine(backend="ref")`` and to the exhaustive
oracle: top-k docIDs and f64 scores, the blocks the pivot keeps and the
candidates it emits.  The ranked sidecar is byte-identical to the
reference's, ``contributions()`` is bit-identical on a multi-codec arena,
and the device theta round keeps a superset of the exact selection.
"""

import numpy as np
import pytest
import torch

from repro.core import build_partitioned_index as ref_build
from repro.data.postings import make_corpus, make_freqs as ref_make_freqs
from repro.data.postings import make_queries
from repro.ranked.bm25 import exhaustive_topk as ref_exhaustive
from repro.ranked.topk_engine import TopKEngine as RefTopK

from repro_torch.api import EngineConfig, make_topk_engine
from repro_torch.convert import index_arrays, index_from_arrays
from repro_torch.core import build_partitioned_index
from repro_torch.data.postings import make_freqs
from repro_torch.ranked.bm25 import exhaustive_topk
from repro_torch.ranked.topk_engine import TopKEngine

SIDECAR = ("freq_lens", "freq_data", "norm_q", "block_max_q", "idf",
           "list_ub", "norm_table")
SCALARS = ("bound_scale", "kmin", "kstep")
ENGINES = [("torch", "kernel"), ("torch", "mirror"), ("numpy", "kernel"),
           ("numpy", "mirror")]


def _cut_at(points):
    def partitioner(gaps):
        pts = sorted(set(int(p) for p in points) | {len(gaps)})
        return np.asarray([p for p in pts if 0 < p <= len(gaps)], np.int64)

    return partitioner


_CACHE = {}


def corpus(kind):
    """(lists, freqs, build kwargs): the generator's corpus at a tiny size,
    or clustered runs (Elias-Fano under ``auto``) beside sparse one-byte
    gaps (Stream-VByte)."""
    if kind not in _CACHE:
        rng = np.random.default_rng(17)
        if kind == "generator":
            lists = make_corpus(rng, n_lists=12, min_len=300, max_len=4000)
            kw = dict(strategy="optimal")
        else:
            low = np.cumsum(rng.choice([1, 2, 6, 10, 20, 30], size=700)) - 1
            sparse = low[-1] + 1 + np.cumsum(rng.integers(65, 128, size=1500))
            lists = [np.concatenate([low, sparse]),
                     np.unique(np.concatenate([low[::3], sparse[::2]])),
                     np.unique(np.concatenate([low[1::2], sparse[::5]])),
                     sparse[1::3].copy(), low[::7].copy()]
            lists = [x.astype(np.int64) for x in lists]
            kw = dict(partitioner=_cut_at([300, 700]))
        _CACHE[kind] = (lists, ref_make_freqs(rng, lists), kw)
    return _CACHE[kind]


def indexes(kind, codecs="auto"):
    """(reference index, port index built by the port from the same
    corpus)."""
    key = ("idx", kind, codecs)
    if key not in _CACHE:
        lists, freqs, kw = corpus(kind)
        _CACHE[key] = (ref_build(lists, freqs=freqs, codecs=codecs, **kw),
                       build_partitioned_index(lists, freqs=freqs,
                                               codecs=codecs, **kw))
    return _CACHE[key]


def _queries(n_lists, seed=3):
    rng = np.random.default_rng(seed)
    qs = [[int(t) for t in q] for ar in (1, 2, 3)
          for q in make_queries(rng, n_lists, 5, ar)]
    return qs + [[], [0, 0], [1, 1, 1, 2]]


def assert_same_topk(got, want):
    assert len(got) == len(want)
    for (gd, gs), (wd, ws) in zip(got, want):
        assert gd.dtype == np.int64 and gs.dtype == np.float64
        assert np.array_equal(gd, wd) and np.array_equal(gs, ws)


@pytest.mark.parametrize("policy", ["svb", "auto", "ef"])
@pytest.mark.parametrize("kind", ["generator", "mixed"])
def test_ranked_sidecar_byte_identical(kind, policy):
    ridx, tidx = indexes(kind)
    ra, ta = ridx.arena_for(policy), tidx.arena_for(policy)
    assert ta.multi == ra.multi
    rr, tr = ra.ranked, ta.ranked
    for k in SIDECAR:
        g, w = getattr(tr, k), getattr(rr, k)
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    for k in SCALARS:
        g, w = getattr(tr, k), getattr(rr, k)
        assert np.float32(g).tobytes() == np.float32(w).tobytes(), k
    assert ta.nbytes() == ra.nbytes()
    # the device copies: norm codes stay uint8, idf / table float32, lob
    # int32; device_nbytes counts them
    dev = ta.on("cpu")
    assert dev.norm_q.dtype == dev.freq_data.dtype == torch.uint8
    assert dev.idf.dtype == dev.norm_table.dtype == torch.float32
    assert dev.lob.dtype == dev.freq_lens.dtype == torch.int32
    assert np.array_equal(dev.lob.numpy(), ta.part_list[ta.part_of_block])
    sidecar_bytes = sum(getattr(dev, k).numel() * getattr(dev, k).element_size()
                        for k in ("freq_lens", "freq_data", "norm_q", "idf",
                                  "norm_table", "lob"))
    unranked = tidx.arena_for(policy)
    assert ta.device_nbytes("cpu") >= sidecar_bytes + dev.lens.numel() * 4
    assert unranked is ta  # one arena per policy, cached on the index


def test_freqs_and_oracle_match_reference():
    """The port's tf generator draws the reference's values (its sticky
    chain vectorized, not looped), and its exhaustive oracle answers as
    the reference's does."""
    for seed in range(3):
        rng = np.random.default_rng(seed)
        lists = make_corpus(rng, n_lists=6, min_len=1, max_len=20000)
        lists += [np.zeros(0, np.int64), np.array([4])]
        for kw in ({}, dict(p_stay=0.5, frac_hot=0.5),
                   dict(p_stay=0.0, frac_hot=0.99)):
            r1, r2 = (np.random.default_rng(seed + 9) for _ in range(2))
            want, got = ref_make_freqs(r1, lists, **kw), make_freqs(r2, lists, **kw)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
            assert r1.random() == r2.random()  # the same draws were used
    ridx, tidx = indexes("generator")
    qs = _queries(12)
    for k in (1, 10):
        assert_same_topk(exhaustive_topk(tidx, qs, k),
                         ref_exhaustive(ridx, qs, k))


@pytest.mark.parametrize("backend,resident", ENGINES)
def test_topk_matches_reference_engine_and_oracle(backend, resident):
    ridx, tidx = indexes("generator")
    qs = _queries(12)
    want = exhaustive_topk(tidx, qs, 10)
    ref = RefTopK(ridx, backend="ref", resident=resident)
    eng = TopKEngine(tidx, backend=backend, resident=resident, device="cpu")
    assert eng.resident == resident and eng.backend == backend
    for _ in range(2):  # the second batch runs against warm caches
        assert_same_topk(ref.topk_batch(qs, 10), want)
        assert_same_topk(eng.topk_batch(qs, 10), want)
        for key in ("blocks_kept", "candidates", "blocks_total"):
            assert eng.stats[key] == ref.stats[key], key
    if resident == "kernel":
        assert eng.stats["pivot_chunks"] == ref.stats["pivot_chunks"] > 0
        if backend == "torch":
            assert eng.stats["fused_pivot_chunks"] > 0


@pytest.mark.parametrize("resident", ["kernel", "mirror"])
def test_topk_on_multi_codec_arena(resident):
    ridx, tidx = indexes("mixed")
    assert tidx.arena_for("auto").multi
    qs = _queries(5, seed=4)
    want = ref_exhaustive(ridx, qs, 7)
    for backend in ("torch", "numpy"):
        eng = TopKEngine(tidx, backend=backend, resident=resident,
                         device="cpu")
        assert_same_topk(eng.topk_batch(qs, 7), want)


def test_topk_edge_cases():
    _, tidx = indexes("generator")
    eng = TopKEngine(tidx, device="cpu", resident="kernel")
    lists = corpus("generator")[0]
    n_total = len(np.unique(np.concatenate(lists[:4])))
    got = eng.topk_batch([[0, 1, 2, 3]], n_total + 50)[0]
    want = exhaustive_topk(tidx, [[0, 1, 2, 3]], n_total + 50)[0]
    assert_same_topk([got], [want])
    assert len(got[0]) == n_total
    gd, gs = eng.topk_batch([[]], 10)[0]
    assert gd.size == 0 and gs.size == 0
    gd, gs = eng.topk_batch([[2]], 7)[0]
    gd2, gs2 = eng.topk_batch([[2, 2]], 7)[0]
    assert np.array_equal(gd2, gd) and np.allclose(gs2, 2 * gs)
    for d, s in eng.topk_batch([[0, 5], [3, 7, 9]], 20):
        assert (np.diff(s) <= 0).all()
        ties = np.flatnonzero(np.diff(s) == 0)
        assert (d[ties + 1] > d[ties]).all()


def _contrib_cursors(ta, lists, rng, n=300):
    """Half members (a list's own docIDs), half not, plus docIDs -1, 0,
    stride - 1, stride and far past it."""
    terms = rng.integers(0, len(lists), n)
    docs = np.array([lists[t][rng.integers(0, len(lists[t]))] for t in terms])
    docs[1::2] += rng.integers(1, 3, len(docs[1::2]))
    edge = np.array([-1, 0, ta.stride - 1, ta.stride, ta.stride + 9, 2**40])
    terms = np.concatenate([terms, np.arange(len(edge)) % len(lists),
                            terms[:30]])
    docs = np.concatenate([docs, edge, docs[:30]])
    return terms.astype(np.int64), docs.astype(np.int64)


def test_contributions_on_a_multi_codec_arena():
    """contributions() on the auto arena of the mixed corpus: SVB cursors
    through bm25_score_probe, EF cursors through ef_search + the row
    scorer; bit-identical to the numpy backend and the reference, with
    out-of-range docIDs contributing 0."""
    ridx, tidx = indexes("mixed")
    ta = tidx.arena_for("auto")
    assert ta.multi and (ta.block_codec == 1).any() and (ta.block_codec == 0).any()
    lists = corpus("mixed")[0]
    terms, docs = _contrib_cursors(ta, lists, np.random.default_rng(5))
    want = RefTopK(ridx, backend="ref").contributions(terms, docs)
    assert (want[:300:2] > 0).all() and (want[300:306] == 0).all()
    for backend, resident in ENGINES:
        eng = TopKEngine(tidx, backend=backend, resident=resident,
                         device="cpu")
        got = eng.contributions(terms, docs)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), (
            backend, resident)
    assert len(TopKEngine(tidx, device="cpu").contributions([], [])) == 0


def test_contributions_waves_pad_with_their_first_cursor(monkeypatch):
    """The pow2 padding cursors of each codec's wave repeat the wave's first
    cursor: list 0 at docID 0 opens the mixed corpus with an EF block, so
    padding the SVB wave with it would send an EF block to the SVB probe
    kernel."""
    _, tidx = indexes("mixed")
    ta = tidx.arena_for("auto")
    assert ta.block_codec[0] == 1  # list 0, docID 0 locates an EF block
    import repro_torch.ranked.topk_engine as te

    seen = []
    real = te.bm25_score_probe

    def spy(*args):
        rows = args[-2]
        seen.append(ta.block_codec[rows.numpy()])
        return real(*args)

    monkeypatch.setattr(te, "bm25_score_probe", spy)
    eng = TopKEngine(tidx, device="cpu", resident="kernel")
    svb = np.nonzero(ta.block_codec == 0)[0]
    lists = corpus("mixed")[0]
    t = int(ta.part_list[ta.part_of_block[svb[-1]]])
    docs = lists[t][-3:]
    eng.contributions(np.full(3, t), docs)
    assert seen and all((codecs == 0).all() for codecs in seen)


def _uncached_specs(lists, rng, nq=5):
    specs = []
    for _ in range(nq):
        terms = np.unique(rng.integers(0, len(lists), rng.integers(1, 4)))
        docs = np.unique(np.concatenate([
            rng.choice(lists[t], size=min(len(lists[t]), 200), replace=False)
            for t in terms
        ]).astype(np.int64))
        specs.append((terms.astype(np.int64), np.ones(len(terms)), docs))
    return specs


@pytest.mark.parametrize("seed", [11, 12])
def test_device_theta_round_keeps_a_superset(seed):
    """Round A on the device (f32 lower bounds summed by index_add, theta
    nudged down, UBs up) keeps a superset of the exact round-B selection,
    raises theta exactly as the host does, and leaves the top-k unchanged.
    The lower bounds themselves are never compared: on a card their f32
    sums come in no fixed order."""
    _, tidx = indexes("generator")
    lists = corpus("generator")[0]
    specs = _uncached_specs(lists, np.random.default_rng(seed))
    theta = np.array([-np.inf, 0.5, 1.0, -np.inf, 2.0])
    k = 5
    host = TopKEngine(tidx, backend="numpy", resident="kernel")
    out_h, t2_h = host._score_specs(specs, theta.copy(), k)
    dev = TopKEngine(tidx, backend="torch", device="cpu", resident="kernel")
    out_d, t2_d = dev._score_specs(specs, theta.copy(), k)
    assert host.stats["theta_device_rounds"] == 0
    assert dev.stats["theta_device_rounds"] == 1
    assert np.array_equal(t2_d, t2_h)
    fin = np.isfinite(theta)
    assert np.all(t2_d[fin] >= theta[fin])
    for (dd, sd), (dh, sh) in zip(out_d, out_h):
        md, mh = dict(zip(dd.tolist(), sd.tolist())), dict(zip(dh.tolist(), sh.tolist()))
        assert set(mh) <= set(md)
        assert all(md[d] == mh[d] for d in mh)
        oh, od = np.lexsort((dh, -sh))[:k], np.lexsort((dd, -sd))[:k]
        assert np.array_equal(dh[oh], dd[od]) and np.array_equal(sh[oh], sd[od])


def test_pivot_keep_sets_match_reference():
    """The blocks the pivot keeps at the seeded theta are the reference's,
    on both port backends."""
    ridx, tidx = indexes("generator")
    qs = _queries(12, seed=8)[:12]
    ref = RefTopK(ridx, backend="ref", resident="kernel")
    specs = [ref._query_spec(q) for q in qs]
    theta = np.array([-np.inf if i % 4 == 0 else 0.5 * (i % 5) + 1.0
                      for i in range(len(qs))])
    want = ref._pivot_rows(specs, theta)
    for backend in ("torch", "numpy"):
        eng = TopKEngine(tidx, backend=backend, device="cpu", resident="kernel")
        got = eng._pivot_rows([eng._query_spec(q) for q in qs], theta)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), backend


def test_jax_built_index_through_convert_serves_the_same_topk():
    """An index the JAX package built, carried over by ``convert``, gives
    the port the reference's ranked sidecar and the reference's answers."""
    ridx, _ = indexes("generator")
    tidx = index_from_arrays(index_arrays(ridx))
    assert tidx.has_freqs and tidx.n_docs_real == ridx.n_docs_real
    ra, ta = ridx.arena_for("auto"), tidx.arena_for("auto")
    for k in SIDECAR:
        assert np.array_equal(getattr(ta.ranked, k), getattr(ra.ranked, k)), k
    qs = _queries(12, seed=6)
    want = RefTopK(ridx, backend="ref").topk_batch(qs, 10)
    assert_same_topk(make_topk_engine(tidx, EngineConfig(device="cpu"))
                     .topk_batch(qs, 10), want)


def test_engine_options():
    _, tidx = indexes("generator")
    eng = TopKEngine(tidx, device="cpu")
    assert eng.resident == "mirror"  # "auto" on the CPU
    assert TopKEngine(tidx, backend="numpy").resident == "mirror"
    with pytest.raises(ValueError, match="resident"):
        TopKEngine(tidx, device="cpu", resident="disk")
    with pytest.raises(NotImplementedError, match="shard"):
        TopKEngine(tidx, device="cpu", shards=2)
    with pytest.raises(TypeError, match="unexpected"):
        TopKEngine(tidx, device="cpu", warp_size=32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TopKEngine(tidx)
    lists = corpus("generator")[0]
    plain = build_partitioned_index(lists[:3], "optimal")  # no freqs
    with pytest.raises(ValueError, match="ranked sidecar"):
        TopKEngine(plain, device="cpu")
    import argparse

    ns = argparse.Namespace(resident="kernel", device="cpu", codec="svb")
    cfg = EngineConfig.from_args(ns)
    assert (cfg.resident, cfg.device, cfg.codec_policy) == ("kernel", "cpu", "svb")
    eng = make_topk_engine(tidx, cfg)
    assert eng.resident == "kernel" and eng.arena is tidx.arena_for("svb")
