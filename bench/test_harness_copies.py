"""The benchmark's copies held to the program's counterparts at a small
size, so that drift shows as a failing test and not as a moved yardstick:
the query draw and the bound counts equal, the torch generator's chains
solved as a walk of the same draws would be, and its laws those of the
program's generator (``repro_torch.data.postings``) but for the two
deliberate differences of docIDs (the sparse state's stay, the universe)."""

import numpy as np
import pytest
import torch

from bench.harness import gen
from bench.metrics import _bounds

LAW = dict(documents=3_000_000, mean_dense_gap=1.3, p_stay=0.999,
           frac_dense=0.85)


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 9])
def test_the_query_draw_is_the_programs(seed):
    from repro_torch.data import postings

    a = gen.make_queries(np.random.default_rng(seed), 10, 30, 3)
    b = postings.make_queries(np.random.default_rng(seed), 10, 30, 3)
    assert [list(map(int, q)) for q in a] == [list(map(int, q)) for q in b]


def _walk(u, s0, stay_on, stay_off):
    out, s = [], s0
    for x in u:
        out.append(s)
        s = (x < stay_on) if s else (x >= stay_off)
    return out


def _walk_lists(u, s0, offs, stay_on, stay_off):
    out = []
    for t in range(len(offs) - 1):
        a, b = int(offs[t]), int(offs[t + 1])
        out += _walk(u[a:b].tolist(), bool(s0[t]), stay_on, stay_off)
    return torch.tensor(out)


@pytest.mark.parametrize("seed", [2, 2**31 + 1])
def test_the_torch_copy_solves_its_chains_as_a_walk_would(seed):
    # the same draws, in the same order, one list and one step at a time
    lens = [300, 4000, 1, 777, 2500]
    law = dict(LAW, documents=400_000, p_stay=0.9, frac_dense=0.7)
    docs, offs = gen.make_corpus_torch(seed, "cpu", lens, **law)
    g = gen.torch_generator(seed, "cpu")
    assert torch.diff(offs).tolist() == lens
    n = sum(lens)
    u = torch.rand(n, dtype=torch.float64, generator=g)
    s0 = torch.rand(5, dtype=torch.float64, generator=g) < 0.7
    dense = _walk_lists(u, s0, offs, 0.9, 1 - 0.1 * 0.7 / 0.3)
    gd = torch.empty(n, dtype=torch.float64).geometric_(1 / 1.3, generator=g)
    v = torch.rand(n, dtype=torch.float64, generator=g)
    w = torch.rand(5, dtype=torch.float64, generator=g)
    for t in range(5):
        a, b = int(offs[t]), int(offs[t + 1])
        mean = max(1.0, (400_000 / lens[t] - 0.7 * 1.3) / 0.3)
        gaps = []
        for i in range(a, b):
            if dense[i]:
                gaps.append(int(gd[i]))
            else:
                gaps.append(1 + int(np.floor(np.log1p(-float(v[i]))
                                             / np.log1p(-1 / mean))))
        span = sum(gaps)
        if span > 400_000:
            fixed = sum(x for x, d in zip(gaps, dense[a:b]) if d)
            n_sp = int((~dense[a:b]).sum())
            c = (400_000 - fixed - n_sp) / max(span - fixed - n_sp, 1)
            c *= 1 - 1e-12
            gaps = [x if d else 1 + int(np.floor((x - 1) * c))
                    for x, d in zip(gaps, dense[a:b])]
            span = sum(gaps)
        start = int(np.floor(float(w[t]) * (400_000 - span + 1)))
        assert docs[a:b].tolist() == (start + np.cumsum(gaps) - 1).tolist()

    tf = gen.make_freqs_torch(seed, offs, "cpu", p_stay=0.8, frac_hot=0.3)
    g = gen.torch_generator(seed * 2 + 1, "cpu")
    u = torch.rand(n, dtype=torch.float64, generator=g)
    s0 = torch.rand(5, dtype=torch.float64, generator=g) < 0.3
    hot = _walk_lists(u, s0, offs, 0.8, 1 - 0.2 * 0.3 / 0.7)
    zh = gen.zipf_torch(g, 1.25, n, "cpu")
    zc = gen.zipf_torch(g, 3.0, n, "cpu")
    assert torch.equal(tf, torch.where(hot, zh, zc).clamp(max=4096))


CFG = dict(n_lists=24, min_len=2000, max_len=40_000, zipf_a=1.4, freqs=True,
           sizes_seed=0, postings=LAW)


@pytest.mark.parametrize("seed", [5, 2**31 + 6])
def test_the_chain_solver_is_the_programs(seed):
    from repro_torch.data import postings

    rng = np.random.default_rng(seed)
    for p_stay, share in ((0.999, 0.85), (0.995, 0.15), (0.6, 0.5)):
        u = rng.random(5000)
        want = postings._hot_states(u, True, p_stay,
                                    gen.other_stay(p_stay, share))
        got = gen.chain_states(torch.from_numpy(u), torch.tensor([True]),
                               torch.tensor([0, 5000]), p_stay, share)
        assert np.array_equal(got.numpy(), want)


def test_the_torch_copy_draws_the_programs_law():
    """Frequencies of the program's law; docIDs of its dense law with the
    sparse state as its parameters state it, in the universe."""
    from repro_torch.data import postings

    lists, freqs = gen.make_inputs(4, CFG, "cpu")
    nl = postings.make_corpus(np.random.default_rng(4), n_lists=24,
                              min_len=2000, max_len=40_000)
    nf = postings.make_freqs(np.random.default_rng(5), nl)
    tf_t, tf_n = np.concatenate(freqs), np.concatenate(nf)
    assert tf_t.min() >= 1 and tf_t.max() <= 4096
    assert abs(np.mean(tf_t == 1) - np.mean(tf_n == 1)) < 0.02
    gaps = np.concatenate([np.diff(x) for x in lists])
    # the program's dense gaps: Geometric of mean 1.3 (its share of 1s)
    ones_n = np.mean(np.concatenate([np.diff(x) for x in nl]) == 1)
    assert abs(np.mean(gaps == 1) / 0.85 - ones_n) < 0.03
    for x in lists:
        assert x[0] >= 0 and x[-1] < LAW["documents"]
        assert (np.diff(x) > 0).all()
    span = sum(int(x[-1]) - int(x[0]) for x in lists)
    assert span > 0.8 * len(lists) * LAW["documents"]
    # about 15% of the gaps are sparse (well over the dense law's tail)
    assert 0.10 < np.mean(gaps > 20) < 0.18


def test_zipf_torch_draws_numpys_zipf():
    g = gen.torch_generator(11, "cpu")
    x = gen.zipf_torch(g, 3.0, 200_000, "cpu").numpy()
    y = np.random.default_rng(11).zipf(3.0, 200_000)
    for v in (1, 2, 3):
        assert abs(np.mean(x == v) - np.mean(y == v)) < 0.005


def _arena_case():
    from repro_torch.core import build_partitioned_index

    lists, _ = gen.make_inputs(5, dict(CFG, n_lists=6, min_len=300,
                                       max_len=8000, freqs=False), "cpu")
    idx = build_partitioned_index(lists, "optimal", codecs="auto")
    return lists, idx.arena_for("auto")


def test_decode_search_bytes_counts_the_kernel_tables_bytes():
    """Each distinct row: its 512 B of lens, the bytes of its data that
    hold values (the sum of its lens), its base and codec row; each
    distinct cursor 16 B: the count of the port's kernel table."""
    lists, a = _arena_case()
    d = a.on("cpu")
    rng = np.random.default_rng(1)
    from repro_torch.core.arena import CODEC_EF

    svb = (np.nonzero(a.block_codec != CODEC_EF)[0] if a.multi
           else np.arange(a.n_blocks))
    rows = svb[rng.integers(0, len(svb), 500)]
    rows = np.concatenate([rows, rows[:50]])  # repeated cursors
    pe = rng.integers(0, a.stride, len(rows))
    pe[-50:] = pe[:50]
    args = (d.lens, d.data, d.block_base, torch.from_numpy(rows.astype(np.int32)),
            torch.from_numpy(pe.astype(np.int32)), d.codec_row if a.multi else None)
    u = np.unique(rows)
    tiles = a.codec_row[u] if a.multi else u
    want = (len(u) * (512 + 4 + (4 if a.multi else 0))
            + int(a.lens[tiles].sum()) + 500 * 16)
    assert _bounds.decode_search_bytes(args, {}) == want


def test_score_rows_bytes_counts_the_kernel_tables_bytes():
    norm_q = torch.zeros((40, 128), dtype=torch.uint8)
    idf = torch.zeros(7)
    table = torch.zeros(256)
    rows = torch.tensor([3, 3, 9, 0, 0, 0], dtype=torch.int32)
    args = (None, None, norm_q, idf, None, table, 2.2, rows)
    assert _bounds.score_rows_bytes(args, {}) == 3 * 1668 + 7 * 4 + 1024
    assert _bounds.score_rows_bytes(args[:7], {}) == 40 * 1668 + 7 * 4 + 1024
    assert _bounds.roofline_pct(3.35e9, 2e-3, 3.35e12) == pytest.approx(50.0)
    assert _bounds.roofline_pct(10, 0.0, 3.35e12) is None


@pytest.mark.parametrize("seeds", [(1, 2**31 + 1), (7, 8)])
def test_every_seed_gets_the_same_sizes_in_another_order(seeds):
    a, _ = gen.make_inputs(seeds[0], CFG, "cpu")
    b, _ = gen.make_inputs(seeds[1], CFG, "cpu")
    la, lb = [len(x) for x in a], [len(x) for x in b]
    assert sorted(la) == sorted(lb) == sorted(gen.config_lengths(CFG))
    assert la != lb
    assert la == list(gen.list_lengths(CFG, seeds[0]))


def test_every_seed_sends_the_same_queries_in_its_own_order():
    """One set of query sizes a configuration, sent in the seed's order as
    drawn, with no regrouping: a batch's work varies as the draw's does."""
    cfg = dict(CFG, n_lists=64, min_len=10, max_len=2000)
    sizes, batch_work = {}, {}
    for seed in (3, 2**31 + 4):
        pool = gen.query_pool(seed, cfg, 256, 2)
        lens = gen.list_lengths(cfg, seed)
        assert all(len(set(q)) == 2 for q in pool)
        sizes[seed] = [tuple(sorted(lens[q])) for q in pool]
        batch_work[seed] = [sum(min(p) for p in sizes[seed][b:b + 32])
                            for b in range(0, 256, 32)]
    assert sorted(sizes[3]) == sorted(sizes[2**31 + 4])
    assert sizes[3] != sizes[2**31 + 4]
    # the pool is the seed's permutation of the configuration's draw
    rng = np.random.default_rng([cfg["sizes_seed"], 1])
    ranks = gen.make_queries(rng, 64, 256, 2)
    order = np.random.default_rng([3, 1]).permutation(256)
    by_rank = gen.config_lengths(cfg)
    assert sizes[3] == [tuple(sorted(by_rank[ranks[i]])) for i in order]
    assert max(batch_work[3]) > 1.2 * min(batch_work[3])
