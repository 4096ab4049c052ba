"""The port's host half against the JAX package: corpus, costs, partitioners,
index build functions and the index hand-over, all compared exactly."""

import numpy as np
import pytest

import repro.core.costs as rcosts
import repro.core.partition as rpart
from repro.core.index import build_partitioned_index as ref_build
from repro.core.index import build_unpartitioned_index as ref_build_unpart
from repro.data.postings import make_corpus as ref_corpus
from repro.data.postings import make_posting_list as ref_posting_list
from repro.data.postings import make_queries as ref_queries

import repro_torch.core.costs as tcosts
import repro_torch.core.partition as tpart
from repro_torch.convert import index_arrays, index_from_arrays
from repro_torch.core.index import build_partitioned_index as port_build
from repro_torch.core.index import build_unpartitioned_index as port_build_unpart
from repro_torch.data.postings import make_corpus as port_corpus
from repro_torch.data.postings import make_posting_list as port_posting_list
from repro_torch.data.postings import make_queries as port_queries

INDEX_ARRAYS = ("endpoints", "sizes", "tags", "offsets", "payload",
                "list_part_offsets", "list_sizes")


def _corpus(seed, n_lists=6, min_len=200, max_len=4_000):
    return ref_corpus(np.random.default_rng(seed), n_lists=n_lists,
                      min_len=min_len, max_len=max_len)


def assert_same_index(got, want):
    for k in INDEX_ARRAYS:
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype, k
        assert np.array_equal(g, w), k
    assert got.n_lists == want.n_lists and got.F == want.F
    assert got.codecs == want.codecs
    assert got.bits_per_int() == want.bits_per_int()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_corpus_and_queries_match(seed):
    kw = dict(n_lists=9, min_len=100, max_len=6_000)
    want = ref_corpus(np.random.default_rng(seed), **kw)
    got = port_corpus(np.random.default_rng(seed), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    rq, pq = np.random.default_rng(seed + 100), np.random.default_rng(seed + 100)
    assert [list(map(int, q)) for q in port_queries(pq, 9, 40, 3)] == [
        list(map(int, q)) for q in ref_queries(rq, 9, 40, 3)
    ]


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(p_stay=0.9, frac_dense=0.5),
     dict(p_stay=0.6, frac_dense=0.1, mean_sparse_gap=40.0)],
    ids=["defaults", "equal-stays", "flipping-chain"],
)
def test_make_posting_list_matches(kw):
    """The vectorized sticky chain gives the reference loop's states, also
    where ``stay_d < stay_s`` keeps the step-by-step path."""
    want = ref_posting_list(np.random.default_rng(3), 5_000, **kw)
    got = port_posting_list(np.random.default_rng(3), 5_000, **kw)
    assert np.array_equal(got, want)


def test_costs_match():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.integers(0, 2**31, 500), [0, 1, 127, 128, 2**31 - 1]])
    assert np.array_equal(tcosts.bit_length_np(x), rcosts.bit_length_np(x))
    assert np.array_equal(tcosts.vbyte_cost_bits_np(x), rcosts.vbyte_cost_bits_np(x))
    seq = np.unique(rng.integers(0, 50_000, 3_000))
    gaps = tcosts.gaps_from_sorted(seq)
    assert np.array_equal(gaps, rcosts.gaps_from_sorted(seq))
    for a, b in zip(tcosts.elem_costs_np(gaps), rcosts.elem_costs_np(gaps)):
        assert np.array_equal(a, b)
    assert np.array_equal(tcosts.gain_deltas_np(gaps), rcosts.gain_deltas_np(gaps))


@pytest.mark.parametrize("seed", [0, 2])
def test_partitioners_match(seed):
    seq = _corpus(seed, n_lists=2, min_len=2_000, max_len=2_000)[1]
    gaps = rcosts.gaps_from_sorted(seq)
    P = rpart.optimal_partitioning(gaps)
    assert np.array_equal(tpart.optimal_partitioning(gaps), P)
    assert np.array_equal(tpart.eps_optimal(gaps), rpart.eps_optimal(gaps))
    assert np.array_equal(tpart.uniform_partitioning(len(gaps), 128),
                          rpart.uniform_partitioning(len(gaps), 128))
    assert tpart.partitioning_cost(gaps, P) == rpart.partitioning_cost(gaps, P)
    assert tpart.unpartitioned_cost(gaps) == rpart.unpartitioned_cost(gaps)
    for a, b in zip(tpart.partition_payload_costs(gaps, P),
                    rpart.partition_payload_costs(gaps, P)):
        assert np.array_equal(a, b)
    small = gaps[:300]
    cost_t, P_t = tpart.dp_optimal(small)
    cost_r, P_r = rpart.dp_optimal(small)
    assert cost_t == cost_r and np.array_equal(P_t, P_r)


@pytest.mark.parametrize("codecs", ["svb", "auto", "ef"])
@pytest.mark.parametrize("strategy", ["optimal", "uniform", "eps", "single"])
def test_partitioned_index_byte_identical(strategy, codecs):
    # the eps-optimal partitioner is a slow python loop: keep its lists short
    corpus = _corpus(11 + len(strategy), n_lists=5,
                     max_len=600 if strategy == "eps" else 4_000)
    assert_same_index(port_build(corpus, strategy, codecs=codecs),
                      ref_build(corpus, strategy, codecs=codecs))


@pytest.mark.parametrize("seed", [3, 4])
def test_unpartitioned_index_byte_identical(seed):
    corpus = _corpus(seed)
    assert_same_index(port_build_unpart(corpus), ref_build_unpart(corpus))


def test_index_from_arrays_serves_the_reference_index():
    """An index built by the JAX package, carried over as arrays, equals the
    port's own build and answers the scalar loop the same way."""
    corpus = _corpus(21, n_lists=4)
    ref_idx = ref_build(corpus, "optimal", codecs="auto")
    carried = index_from_arrays(index_arrays(ref_idx))
    assert_same_index(carried, port_build(corpus, "optimal", codecs="auto"))
    for q in ([0, 1], [2, 3, 1]):
        assert np.array_equal(carried.intersect_scalar(q), ref_idx.intersect_scalar(q))
    with pytest.raises(ValueError, match="missing"):
        index_from_arrays({"endpoints": ref_idx.endpoints})
