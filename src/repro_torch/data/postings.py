"""Synthetic clustered posting lists, calibrated to the paper's datasets.

The paper (Fig. 1) shows inverted lists mixing *dense* regions (d-gaps ~1-2,
better served by the characteristic bit-vector) and *sparse* regions (large
d-gaps, better served by VByte).  We generate lists with a two-state sticky
Markov chain over {dense, sparse}:

  dense state : gap ~ 1 + Geometric(p_dense)   (mean ~2, like Gov2's 2.13)
  sparse state: gap ~ 1 + Geometric(p_sparse)  (mean ~1850, like Gov2)

List lengths follow a Zipf-ish distribution over [min_len, max_len].  The
default parameters reproduce the paper's headline behaviour: un-partitioned
VByte ~9.5 bpi, optimally partitioned ~2x smaller (Table 3's Gov2 column).

Counterpart of ``repro/data/postings.py``: the same seed gives the same
lists.  One quirk is kept as the reference has it: ``stay_s`` is the
probability that the SPARSE state moves to dense, so sparse runs last
about one step and the mean gap stays near 3.3, not the ~278 the
parameters suggest.
"""

from __future__ import annotations

import numpy as np


def make_posting_list(
    rng: np.random.Generator,
    n: int,
    mean_dense_gap: float = 1.3,
    mean_sparse_gap: float = 1850.0,
    p_stay: float = 0.999,
    frac_dense: float = 0.85,
) -> np.ndarray:
    """One strictly increasing docID list of length n."""
    # sticky two-state chain; stationary dense fraction = frac_dense
    stay_d = p_stay
    stay_s = 1.0 - (1.0 - p_stay) * frac_dense / max(1e-9, (1.0 - frac_dense))
    stay_s = min(max(stay_s, 0.5), 0.99999)
    u = rng.random(n)
    s = rng.random() < frac_dense
    states = _sticky_states(u, s, stay_d, stay_s)  # True = dense
    gd = 1 + rng.geometric(min(1.0, 1.0 / mean_dense_gap), size=n) - 1
    gs = 1 + rng.geometric(min(1.0, 1.0 / mean_sparse_gap), size=n) - 1
    gaps = np.where(states, gd, gs).astype(np.int64)
    gaps = np.maximum(gaps, 1)
    return np.cumsum(gaps) - 1


def _sticky_states(u: np.ndarray, s0: bool, stay_d: float,
                   stay_s: float) -> np.ndarray:
    """States of the chain ``s[i+1] = u[i] < (stay_d if s[i] else stay_s)``.

    Step i forces the next state wherever both branches agree (True where
    ``u < min``, False where ``u >= max``); between the two thresholds it
    keeps the state when ``stay_d > stay_s`` and flips it otherwise.  With
    ``stay_d >= stay_s`` every state is therefore the last forced value,
    a forward fill -- the same states as the step-by-step loop, which is
    kept for the flipping case.
    """
    n = u.size
    states = np.empty(n, dtype=bool)
    if n == 0:
        return states
    if stay_d < stay_s:
        s = s0
        for i in range(n):
            states[i] = s
            s = u[i] < (stay_d if s else stay_s)
        return states
    nxt = u < stay_d  # next state wherever step i forces one
    forced = (u < stay_s) | ~nxt
    last = np.where(forced, np.arange(n), -1)
    np.maximum.accumulate(last, out=last)
    states[0] = s0
    prev = last[:-1]
    states[1:] = np.where(prev >= 0, nxt[np.maximum(prev, 0)], s0)
    return states


def make_corpus(
    rng: np.random.Generator,
    n_lists: int = 64,
    min_len: int = 200,
    max_len: int = 100_000,
    zipf_a: float = 1.4,
    **kw,
) -> list[np.ndarray]:
    """A small synthetic corpus with Zipfian list sizes."""
    # Zipf-distributed lengths clipped to [min_len, max_len]
    raw = rng.zipf(zipf_a, size=n_lists).astype(np.float64)
    lens = (min_len * raw).astype(np.int64)
    lens = np.clip(lens, min_len, max_len)
    return [make_posting_list(rng, int(n), **kw) for n in lens]


def make_queries(
    rng: np.random.Generator, n_lists: int, n_queries: int = 50, arity: int = 2
) -> list[list[int]]:
    """Random conjunctive queries (term id tuples), TREC-style workload."""
    return [
        list(rng.choice(n_lists, size=arity, replace=False)) for _ in range(n_queries)
    ]


def make_freqs(
    rng: np.random.Generator,
    lists: list[np.ndarray],
    zipf_hot: float = 1.25,
    zipf_cold: float = 3.0,
    p_stay: float = 0.995,
    frac_hot: float = 0.15,
    max_tf: int = 4096,
) -> list[np.ndarray]:
    """Within-document term frequencies for each posting: clustered Zipf.

    One tf >= 1 per posting of each list -- the second payload stream the
    ranked (BM25) subsystem carries alongside the docID gaps.  Real tf
    streams are skewed AND autocorrelated: a term is frequent across a
    topical run of documents and incidental elsewhere.  A sticky two-state
    chain (hot: heavy-tailed Zipf, cold: tf mostly 1) reproduces both, which
    is exactly what makes per-block score maxima vary -- the structure
    Block-Max WAND/MaxScore pruning exploits.  IID tf would give every
    128-posting block a similar max and no block-max structure to find.
    """
    stay_h = p_stay
    stay_c = 1.0 - (1.0 - p_stay) * frac_hot / max(1e-9, 1.0 - frac_hot)
    stay_c = min(max(stay_c, 0.5), 0.99999)
    out = []
    for seq in lists:
        n = len(seq)
        u = rng.random(n)
        s = rng.random() < frac_hot
        states = _hot_states(u, s, stay_h, stay_c)  # True = hot
        hot = rng.zipf(zipf_hot, size=n)
        cold = rng.zipf(zipf_cold, size=n)
        tf = np.where(states, hot, cold)
        out.append(np.minimum(tf, max_tf).astype(np.int64))
    return out


def _hot_states(u: np.ndarray, s0: bool, stay_h: float,
                stay_c: float) -> np.ndarray:
    """States of the hot/cold chain of ``make_freqs``, vectorized and exact.

    The reference walks it in a Python loop: ``states[i] = s`` then ``s =
    (u[i] < stay_h) if s else (u[i] >= stay_c)``.  Step i maps the state
    through ``a = u[i] < stay_h`` (from hot) and ``b = u[i] >= stay_c``
    (from cold): where ``a == b`` it SETS the state to ``a``, where ``a``
    and not ``b`` it keeps it, and where ``b`` and not ``a`` it flips it.
    So state i is the value of the last set before it (``s0`` if none),
    flipped once per flip step in between -- the same booleans, with no
    loop over the postings.
    """
    n = len(u)
    a = u < stay_h
    b = u >= stay_c
    flip = b & ~a
    flips = np.zeros(n + 1, np.int64)
    np.cumsum(flip, out=flips[1:])
    set_at = np.where(a == b, np.arange(n), -1)
    last_set = np.maximum.accumulate(set_at) if n else set_at
    before = np.empty(n, np.int64)  # last set step strictly before i
    if n:
        before[0] = -1
        before[1:] = last_set[:-1]
    value = np.where(before >= 0, a[np.maximum(before, 0)], bool(s0))
    between = flips[np.arange(n)] - flips[before + 1]
    return value ^ (between & 1).astype(bool)


def make_ranked_corpus(
    rng: np.random.Generator, **kw
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(docID lists, per-posting term frequencies) for the ranked workload."""
    lists = make_corpus(rng, **kw)
    return lists, make_freqs(rng, lists)


def doc_lengths(
    lists: list[np.ndarray], freqs: list[np.ndarray]
) -> np.ndarray:
    """Document lengths implied by the corpus: dl(d) = sum of tf over lists.

    Returns an int64 array over the docID universe [0, max docID]; docs that
    appear in no list have length 0 (they are never scored).
    """
    n_docs = 1 + max((int(seq[-1]) for seq in lists if len(seq)), default=-1)
    dl = np.zeros(max(n_docs, 0), np.int64)
    for seq, tf in zip(lists, freqs):
        np.add.at(dl, seq, tf)
    return dl
