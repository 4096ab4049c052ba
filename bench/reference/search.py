"""The plain reference: boolean AND and exhaustive BM25 top-k over the
generated posting lists, written from their definitions.

It works from what the harness generated (the docID lists, the term
frequencies, the queries) and from nothing the program built.  The big
elementwise steps run in plain PyTorch on the device it is handed (the card
in a run, the CPU in the tests); the scoring arithmetic runs in NumPy.

Scoring (a frozen copy of the f32 BM25 contract the system states):

    idf(t)     = f32( ln(1 + (N - df + 0.5) / (df + 0.5)) )     N = real docs
    K(d)       = k1 * (1 - b + b * dl(d) / avgdl)                  (f64)
    K_hat(d)   = table[q(d)],  q(d) = rint((K(d) - kmin) / kstep) in 0..255,
                 table[q] = f32(kmin) + f32(kstep) * q             (f32)
    score(t,d) = idf(t) * (tf * (k1 + 1)) / (tf + K_hat(d))         (f32)

with (kmin, kmax) the range of K over the real documents and kstep =
(kmax - kmin) / 255; dl(d) is the sum of tf over the lists holding d.  A
document's score is the f64 sum over the query's distinct terms of
multiplicity x score, exact in f64; the top k are ordered by score
descending, then docID ascending.
"""

from __future__ import annotations

import numpy as np
import torch

K1 = 1.2
B = 0.75
NORM_LEVELS = 256


class Corpus:
    """The generated lists on ``device``, concatenated: list t is
    ``docs[offs[t]:offs[t + 1]]``."""

    def __init__(self, lists, device):
        lens = np.array([len(x) for x in lists], np.int64)
        self.offs = np.zeros(len(lists) + 1, np.int64)
        self.offs[1:] = np.cumsum(lens)
        self.host = np.concatenate(lists).astype(np.int64, copy=False)
        self.docs = torch.from_numpy(self.host).to(device)
        self.device = torch.device(device)

    def list(self, t: int) -> torch.Tensor:
        return self.docs[self.offs[t]:self.offs[t + 1]]


# ---------------------------------------------------------------------------
# boolean AND
# ---------------------------------------------------------------------------


def _members(sorted_list: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """probes[i] in sorted_list, elementwise."""
    k = torch.searchsorted(sorted_list, probes)
    k = k.clamp(max=max(len(sorted_list) - 1, 0))
    return (sorted_list[k] == probes) if len(sorted_list) else torch.zeros_like(
        probes, dtype=torch.bool)


def intersect(corpus: Corpus, query) -> np.ndarray:
    """Sorted docIDs in every list of ``query``."""
    terms = sorted({int(t) for t in query},
                   key=lambda t: corpus.offs[t + 1] - corpus.offs[t])
    if not terms:
        return np.zeros(0, np.int64)
    cand = corpus.list(terms[0])
    for t in terms[1:]:
        cand = cand[_members(corpus.list(t), cand)]
    return cand.cpu().numpy()


def intersect_coarse(corpus: Corpus, query, shift: int = 3) -> np.ndarray:
    """The control of the AND cells: membership decided per bucket of
    2^shift docIDs (a block filter without its exact check), which breaks
    the guarantee that every answer is the exact intersection."""
    terms = sorted({int(t) for t in query},
                   key=lambda t: corpus.offs[t + 1] - corpus.offs[t])
    if not terms:
        return np.zeros(0, np.int64)
    cand = corpus.list(terms[0])
    for t in terms[1:]:
        cand = cand[_members(corpus.list(t) >> shift, cand >> shift)]
    return cand.cpu().numpy()


# ---------------------------------------------------------------------------
# BM25 top-k
# ---------------------------------------------------------------------------


def _norm_codes(dl: np.ndarray):
    """(q [n_docs] uint8, table [256] f32) of the length norms."""
    real = dl[dl > 0].astype(np.float64)
    avg = float(int(dl.sum())) / len(real) if len(real) else 1.0
    if len(real) == 0:
        return np.zeros(len(dl), np.uint8), np.full(NORM_LEVELS, K1, np.float32)
    k_real = K1 * (1.0 - B + B * real / max(avg, 1e-9))
    kmin = np.float32(k_real.min())
    kstep = np.float32((float(k_real.max()) - float(k_real.min()))
                       / (NORM_LEVELS - 1))
    k = K1 * (1.0 - B + B * dl.astype(np.float64) / max(avg, 1e-9))
    if float(kstep) == 0.0:
        q = np.zeros(len(dl), np.uint8)
    else:
        q = np.clip(np.rint((k - float(kmin)) / float(kstep)), 0,
                    NORM_LEVELS - 1).astype(np.uint8)
    table = (kmin + kstep * np.arange(NORM_LEVELS, dtype=np.float32)).astype(
        np.float32)
    return q, table


class Scores:
    """Every posting's BM25 contribution (f32, as f64 on ``corpus``'s
    device), from the generated lists and frequencies.

    ``dtype`` is the precision of the arithmetic: ``np.float32`` is the
    reference; ``"bfloat16"`` is the control (the same formula with every
    operand and every operation rounded to bfloat16)."""

    def __init__(self, corpus: Corpus, freqs, dtype=np.float32):
        tf = np.concatenate(freqs).astype(np.int64, copy=False)
        docs = corpus.host
        dl = np.bincount(docs, weights=tf).astype(np.int64)
        n_real = int(np.count_nonzero(dl))
        df = np.diff(corpus.offs).astype(np.float64)
        idf_t = np.log1p((n_real - df + 0.5) / (df + 0.5)).astype(np.float32)
        q, table = _norm_codes(dl)
        lens = np.diff(corpus.offs)
        idf = np.repeat(idf_t, lens)
        k_hat = table[q[docs]]
        if dtype == "bfloat16":
            c = _score_bf16(tf, k_hat, idf)
        else:
            tf32 = tf.astype(np.float32)
            num = tf32 * np.float32(K1 + 1.0)
            c = (idf * (num / (tf32 + k_hat))).astype(np.float32)
        self.contrib = torch.from_numpy(c.astype(np.float64)).to(corpus.device)
        self.corpus = corpus

    def topk(self, query, k: int):
        """(docIDs, f64 scores) of the k best documents of ``query``'s
        union of lists."""
        terms, mult = np.unique(np.asarray(query, np.int64), return_counts=True)
        c = self.corpus
        docs = torch.cat([c.list(int(t)) for t in terms])
        sc = torch.cat([self.contrib[c.offs[t]:c.offs[t + 1]] * float(m)
                        for t, m in zip(terms, mult)])
        if len(docs) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        u, inv = torch.unique(docs, return_inverse=True)
        acc = torch.zeros(len(u), dtype=torch.float64, device=docs.device)
        acc.index_add_(0, inv, sc)
        if len(u) > k:
            kth = torch.topk(acc, k).values[-1]
            keep = acc >= kth
            u, acc = u[keep], acc[keep]
        d, s = u.cpu().numpy(), acc.cpu().numpy()
        order = np.lexsort((d, -s))[:k]
        return d[order], s[order]


def _score_bf16(tf, k_hat, idf) -> np.ndarray:
    """The contribution formula in bfloat16 arithmetic (torch on the CPU,
    in blocks), returned as f32 values."""
    out = np.empty(len(tf), np.float32)
    step = 1 << 24
    k1p1 = torch.tensor(K1 + 1.0, dtype=torch.bfloat16)
    for s in range(0, len(tf), step):
        t = torch.from_numpy(tf[s:s + step]).to(torch.bfloat16)
        kh = torch.from_numpy(k_hat[s:s + step]).to(torch.bfloat16)
        i = torch.from_numpy(idf[s:s + step]).to(torch.bfloat16)
        out[s:s + step] = (i * (t * k1p1 / (t + kh))).float().numpy()
    return out
