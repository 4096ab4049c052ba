"""The plain reference against a brute force written from the
definitions, its frozen BM25 arithmetic against the program's exhaustive
oracle, and each cell's control against the reference: the control has to
read wrong where a sound answer reads right."""

import numpy as np
import pytest

from bench.harness import cell, gen
from bench.reference import search


def _corpus(seed, n_lists=6, min_len=40, max_len=3000):
    from repro_torch.data import postings

    rng = np.random.default_rng(seed)
    lists = postings.make_corpus(rng, n_lists=n_lists, min_len=min_len,
                                 max_len=max_len)
    return lists, postings.make_freqs(rng, lists)


def _brute_bm25(lists, freqs, query, k):
    """Python loops over every posting, in f32 scalars, summed in f64."""
    dl = {}
    for docs, tfs in zip(lists, freqs):
        for d, tf in zip(docs.tolist(), tfs.tolist()):
            dl[d] = dl.get(d, 0) + tf
    n_docs = 1 + max(int(x[-1]) for x in lists)
    dls = np.zeros(n_docs, np.int64)
    for d, v in dl.items():
        dls[d] = v
    real = dls[dls > 0].astype(np.float64)
    avg = float(dls.sum()) / len(real)
    kr = [1.2 * (1.0 - 0.75 + 0.75 * x / avg) for x in real]
    kmin, kmax = min(kr), max(kr)
    kmin32, kstep32 = np.float32(kmin), np.float32((kmax - kmin) / 255)
    scores = {}
    for t, m in zip(*np.unique(query, return_counts=True)):
        df = len(lists[t])
        idf = np.float32(np.log1p((len(real) - df + 0.5) / (df + 0.5)))
        for d, tf in zip(lists[t].tolist(), freqs[t].tolist()):
            kd = 1.2 * (1.0 - 0.75 + 0.75 * dls[d] / avg)
            q = min(max(int(np.rint((kd - float(kmin32)) / float(kstep32))), 0),
                    255)
            k_hat = np.float32(kmin32 + np.float32(kstep32) * np.float32(q))
            tf32 = np.float32(tf)
            c = np.float32(idf * np.float32(tf32 * np.float32(2.2)
                                            / np.float32(tf32 + k_hat)))
            scores[d] = scores.get(d, 0.0) + float(m) * float(c)
    best = sorted(scores.items(), key=lambda ds: (-ds[1], ds[0]))[:k]
    return (np.array([d for d, _ in best], np.int64),
            np.array([s for _, s in best], np.float64))


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_and_and_top10_equal_a_brute_force(seed):
    lists, freqs = _corpus(seed)
    corpus = search.Corpus(lists, "cpu")
    scores = search.Scores(corpus, freqs)
    rng = np.random.default_rng(seed + 1)
    for _ in range(12):
        q = [int(t) for t in rng.choice(len(lists), 2, replace=False)]
        want = sorted(set(lists[q[0]].tolist()) & set(lists[q[1]].tolist()))
        assert search.intersect(corpus, q).tolist() == want
        got = scores.topk(q, 10)
        bd, bs = _brute_bm25(lists, freqs, q, 10)
        assert np.array_equal(got[0], bd) and np.array_equal(got[1], bs)


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_top10_equals_the_programs_exhaustive_oracle(seed):
    from repro_torch.core import build_partitioned_index
    from repro_torch.ranked.bm25 import exhaustive_topk

    lists, freqs = _corpus(seed, n_lists=8, max_len=20_000)
    idx = build_partitioned_index(lists, "optimal", freqs=freqs, codecs="auto")
    queries = gen.warm_pool(seed, len(lists), 24, 2)
    scores = search.Scores(search.Corpus(lists, "cpu"), freqs)
    for q, (wd, ws) in zip(queries, exhaustive_topk(idx, queries, 10)):
        gd, gs = scores.topk(q, 10)
        assert np.array_equal(gd, wd) and np.array_equal(gs, ws)


@pytest.mark.parametrize("op", ["and", "topk"])
def test_the_control_reads_wrong_where_the_reference_reads_right(op):
    lists, freqs = _corpus(7, n_lists=8, max_len=20_000)
    pool = gen.warm_pool(7, len(lists), 64, 2)
    qidx = list(range(len(pool)))
    ref = cell.reference(op, 10, lists, freqs, "cpu")
    ctl = cell.reference(op, 10, lists, freqs, "cpu", control=True)
    sound = [ref(pool[i]) for i in qidx]
    assert cell.count_wrong(op, qidx, sound, pool, ref) == 0
    control = [ctl(pool[i]) for i in qidx]
    assert cell.count_wrong(op, qidx, control, pool, ref) >= len(qidx) // 4


def test_the_control_tool_reads_a_cell_at_a_small_size(tmp_path):
    from bench.conftest import make_tiny_root
    from bench.tools.control import control_readings

    root = make_tiny_root(tmp_path)
    for w in ("gov2.and-b64", "gov2.topk10-c64"):
        (rec,) = control_readings(w, [2**31 + 5], 64, root=root, device="cpu")
        assert rec["checked"] == 64 and rec["wrong_answers"] > 0
