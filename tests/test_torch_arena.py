"""The port's block arena against the JAX package: host arrays byte-identical
under every codec policy, device tensors narrowed to the same dtypes."""

import numpy as np
import pytest
import torch

from repro.core.index import build_partitioned_index as ref_build
from repro.data.postings import make_corpus, make_freqs

from repro_torch.core.arena import CODEC_EF, build_arena
from repro_torch.core.index import build_partitioned_index as port_build

HOST_FIELDS = (
    "lens", "data", "block_base", "block_keys", "lane_valid", "part_of_block",
    "first_blk", "n_blk", "sizes", "bases", "part_list", "list_blk_offsets",
    "block_codec", "codec_row", "ef_lo", "ef_hi", "ef_lbits",
)
DEVICE_FIELDS = (
    "lens", "data", "block_base", "block_keys", "part_of_block", "first_blk",
    "list_blk_offsets", "block_codec", "codec_row", "ef_lo", "ef_hi",
    "ef_lbits",
)


def _cut_at(points):
    def partitioner(gaps):
        pts = sorted(set(int(p) for p in points) | {len(gaps)})
        return np.asarray([p for p in pts if 0 < p <= len(gaps)], np.int64)

    return partitioner


def mixed_corpus(seed):
    """Clustered runs (Elias-Fano wins) followed by sparse one-byte gaps
    (Stream-VByte wins), and a second list sharing both."""
    rng = np.random.default_rng(seed)
    low = np.cumsum(rng.choice([1, 2, 6, 10, 20, 30], size=700)) - 1
    sparse = low[-1] + 1 + np.cumsum(rng.integers(65, 128, size=1500))
    return [np.concatenate([low, sparse]).astype(np.int64),
            np.unique(np.concatenate([low[::3], sparse[::2]])).astype(np.int64)]


def build_both(kind, codecs, seed=0):
    if kind == "mixed":
        corpus = mixed_corpus(seed)
        kw = dict(partitioner=_cut_at([300, 700]), codecs=codecs)
    else:
        corpus = make_corpus(np.random.default_rng(seed), n_lists=4,
                             min_len=300, max_len=3_000)
        kw = dict(strategy="optimal", codecs=codecs)
    return ref_build(corpus, **kw), port_build(corpus, **kw)


def assert_same_arena(got, want):
    for k in HOST_FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        if w is None:
            assert g is None, k
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k
    for k in ("stride", "n_blocks", "device_ok", "multi"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.nbytes() == want.nbytes()


@pytest.mark.parametrize("policy", ["svb", "auto", "ef"])
@pytest.mark.parametrize("codecs", ["svb", "auto"])
@pytest.mark.parametrize("kind", ["generator", "mixed"])
def test_arena_host_arrays_byte_identical(kind, codecs, policy):
    ref_idx, port_idx = build_both(kind, codecs)
    want = ref_idx.arena_for(policy)
    got = port_idx.arena_for(policy)
    assert_same_arena(got, want)
    if policy == "ef":
        assert got.multi and (got.block_codec == CODEC_EF).any()
    if kind == "mixed" and codecs == "auto" and policy == "auto":
        assert got.multi and (got.block_codec != CODEC_EF).any()


def test_second_policy_reuses_the_transcode():
    """arena_for of a second policy over the same index re-splits codecs
    only; a fresh build_arena gives the same arrays."""
    ref_idx, port_idx = build_both("mixed", "auto", seed=1)
    first = port_idx.arena_for("svb")
    assert port_idx._transcode is not None
    again = port_idx.arena_for("ef")
    assert_same_arena(again, ref_idx.arena_for("ef"))
    assert_same_arena(first, build_arena(port_idx, "svb"))


@pytest.mark.parametrize("policy", ["svb", "ef"])
def test_device_tensors_narrowed_like_the_reference(policy):
    ref_idx, port_idx = build_both("mixed", "auto", seed=2)
    want = ref_idx.arena_for(policy).dev
    got = port_idx.arena_for(policy).on("cpu")
    names = [k for k in DEVICE_FIELDS if hasattr(want, k)]
    assert sorted(names) == sorted(vars(got))
    for k in names:
        w, g = np.asarray(getattr(want, k)), getattr(got, k)
        assert str(g.dtype) == f"torch.{w.dtype}", k
        assert np.array_equal(g.numpy(), w), k
    assert port_idx.arena_for(policy).device_nbytes("cpu") == sum(
        t.numel() * t.element_size() for t in vars(got).values())
    assert got is port_idx.arena_for(policy).on(torch.device("cpu"))


def test_device_ok_false_when_keys_overflow_int32():
    rng = np.random.default_rng(3)
    lists = [np.sort(rng.choice(2**30, 500, replace=False)).astype(np.int64)
             for _ in range(3)]
    want = ref_build(lists, "optimal").arena_for("svb")
    got = port_build(lists, "optimal").arena_for("svb")
    assert not got.device_ok
    assert_same_arena(got, want)


def test_index_with_freqs_waits_for_the_ranked_slice():
    """The ranked slice has landed: an index with freqs gets an arena with
    the reference's ranked sidecar (it used to raise NotImplementedError),
    and the docID half of that arena is unchanged by the sidecar."""
    corpus = make_corpus(np.random.default_rng(4), n_lists=2, min_len=200,
                         max_len=400)
    freqs = make_freqs(np.random.default_rng(5), corpus)
    idx = port_build(corpus, "optimal", freqs=freqs)
    ref = ref_build(corpus, "optimal", freqs=freqs)
    got, want = idx.arena_for("svb"), ref.arena_for("svb")
    assert_same_arena(got, want)
    for k in ("freq_lens", "freq_data", "norm_q", "block_max_q", "idf",
              "list_ub", "norm_table"):
        g, w = getattr(got.ranked, k), getattr(want.ranked, k)
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    plain = port_build(corpus, "optimal").arena_for("svb")
    assert plain.ranked is None
    for k in HOST_FIELDS:
        g, w = getattr(got, k), getattr(plain, k)
        assert (g is None and w is None) or np.array_equal(g, w), k
    assert got.nbytes() == plain.nbytes() + got.ranked.nbytes()
