"""BM25 scoring contract shared by all ranked backends.

Counterpart of ``repro/ranked/bm25.py``, copied as host numpy (the port
imports nothing of the reference).  Every implementation -- the CUDA
kernels, their plain PyTorch versions, the numpy mirror, and the
exhaustive oracle -- computes the SAME function, in the same float32
operation order, so results are bit-comparable across backends:

    idf(t)     = float32( ln(1 + (N - df + 0.5) / (df + 0.5)) )
    K_hat(d)   = float32( kmin + kstep * q(d) )          # quantized norm
    score(t,d) = idf(t) * (tf * (k1 + 1)) / (tf + K_hat(d))

with ``q(d)`` an 8-bit quantization of the true length norm
``K(d) = k1 * (1 - b + b * dl(d) / avgdl)`` over [kmin, kmax] (256 linear
levels, round-to-nearest).  Quantizing the NORM rather than the score keeps
the arena's per-posting sidecar at one byte while the contract stays exact:
the oracle scores with the same K_hat, so "identical top-k" is well defined.

Query scores ACCUMULATE in float64: contributions are float32 values whose
exponents span far less than the 29 bits of f64 headroom, so the per-doc sum
is exact and independent of accumulation order -- the engine may sum
term-major, the oracle doc-major, and ties still break identically (by
docID, ascending).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NORM_LEVELS = 256


@dataclass(frozen=True)
class BM25Params:
    k1: float = 1.2
    b: float = 0.75


DEFAULT_BM25 = BM25Params()


def idf(n_docs: int, df: np.ndarray) -> np.ndarray:
    """Robertson-Sparck Jones idf (the +1 variant: always positive), f32."""
    df = np.asarray(df, dtype=np.float64)
    return np.log1p((n_docs - df + 0.5) / (df + 0.5)).astype(np.float32)


def norm_grid(doc_lens: np.ndarray, avg_dl: float, p: BM25Params = DEFAULT_BM25):
    """(kmin, kstep) of the 256-level norm quantizer for this collection.

    The grid spans the true norm range of the REAL documents; kstep is 0 for
    degenerate collections (all lengths equal), making K_hat == kmin exact.
    """
    dl = np.asarray(doc_lens, dtype=np.float64)
    dl = dl[dl > 0]
    if dl.size == 0:
        return np.float32(p.k1), np.float32(0.0)
    k = p.k1 * (1.0 - p.b + p.b * dl / max(avg_dl, 1e-9))
    kmin, kmax = float(k.min()), float(k.max())
    return np.float32(kmin), np.float32((kmax - kmin) / (NORM_LEVELS - 1))


def quantize_norms(
    doc_lens: np.ndarray, avg_dl: float, p: BM25Params = DEFAULT_BM25
) -> tuple[np.ndarray, np.float32, np.float32]:
    """(q [n_docs] uint8, kmin, kstep): 8-bit norm codes per document."""
    kmin, kstep = norm_grid(doc_lens, avg_dl, p)
    dl = np.asarray(doc_lens, dtype=np.float64)
    k = p.k1 * (1.0 - p.b + p.b * dl / max(avg_dl, 1e-9))
    if float(kstep) == 0.0:
        q = np.zeros(len(dl), np.uint8)
    else:
        q = np.clip(
            np.rint((k - float(kmin)) / float(kstep)), 0, NORM_LEVELS - 1
        ).astype(np.uint8)
    return q, kmin, kstep


def norm_table(kmin, kstep) -> np.ndarray:
    """The 256-entry f32 dequantization table: table[q] = kmin + kstep * q.

    Materialized ONCE in numpy and then GATHERED by every backend (the
    CUDA kernels keep it in shared memory) instead of being recomputed on
    the device: a compiler may contract a mul+add chain into an FMA, which
    would drift the kernel 1 ulp off the numpy/oracle contract.  A table
    gather is exact everywhere.
    """
    return (
        np.float32(kmin)
        + np.float32(kstep) * np.arange(NORM_LEVELS, dtype=np.float32)
    ).astype(np.float32)


def dequant_norm(q, kmin, kstep):
    """K_hat from the 8-bit code -- THE contract dequantization, f32."""
    return norm_table(kmin, kstep)[np.asarray(q, dtype=np.int64)]


def score_tf(tf, k_hat, idf_t, p: BM25Params = DEFAULT_BM25) -> np.ndarray:
    """Per-posting BM25 contribution, float32, contract operation order."""
    tf = np.asarray(tf, dtype=np.float32)
    num = tf * np.float32(p.k1 + 1.0)
    return (np.asarray(idf_t, np.float32) * (num / (tf + np.asarray(k_hat, np.float32)))).astype(np.float32)


def query_weights(terms) -> tuple[np.ndarray, np.ndarray]:
    """(unique terms, multiplicities): repeated query terms score m times."""
    t, m = np.unique(np.asarray(terms, dtype=np.int64), return_counts=True)
    return t, m.astype(np.float64)


def topk_select(docs: np.ndarray, scores: np.ndarray, k: int):
    """Exact top-k of (score desc, docID asc) -- the shared tie-break rule."""
    if len(docs) > max(4 * k, 64):
        # cheap pre-cut: keep everything tied with the k-th best score
        kth = np.partition(scores, len(scores) - k)[len(scores) - k]
        keep = scores >= kth
        docs, scores = docs[keep], scores[keep]
    order = np.lexsort((docs, -scores))[:k]
    return docs[order], scores[order]


def _decode_list_scalar(index, t: int) -> np.ndarray:
    """Decode list t straight from the compressed payload, partition by
    partition -- no arena, no decoded-list cache.  The cost model of a
    scalar engine: every query pays the decode again."""
    sl = slice(
        int(index.list_part_offsets[t]), int(index.list_part_offsets[t + 1])
    )
    chunks, base = [], -1
    for p in range(sl.start, sl.stop):
        vals = index._decode_partition(p, base)
        base = int(index.endpoints[p])
        chunks.append(vals)
    return np.concatenate(chunks) if chunks else np.zeros(0, np.int64)


def exhaustive_topk(
    index, queries: list[list[int]], k: int, p: BM25Params = DEFAULT_BM25
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Scalar exhaustive-scoring oracle: score EVERY doc of each query's
    union-of-lists, f64-accumulated from the f32 contract contributions.

    The reference the Block-Max engine must match exactly (docIDs AND
    scores, ties broken by docID) and the baseline it is benchmarked
    against.  Deliberately per-query, prune-free, and cache-free: each
    query re-decodes its lists from the compressed payload, which is what
    "no arena, no block-max structure" serving costs.
    """
    q_norms, kmin, kstep = quantize_norms(index.doc_lens, index.avg_dl, p)
    n_real = index.n_docs_real
    out = []
    for q in queries:
        terms, mult = query_weights(q)
        if len(terms) == 0:
            out.append((np.zeros(0, np.int64), np.zeros(0, np.float64)))
            continue
        decoded = {int(t): _decode_list_scalar(index, int(t)) for t in terms}
        docs = np.unique(np.concatenate(list(decoded.values())))
        acc = np.zeros(len(docs), np.float64)
        for t, m in zip(terms, mult):
            vals = decoded[int(t)]
            if not len(vals):
                continue
            tf = index.decode_list_freqs(int(t))
            idf_t = idf(n_real, np.asarray([len(vals)]))[0]
            k_hat = dequant_norm(q_norms[vals], kmin, kstep)
            contrib = score_tf(tf, k_hat, idf_t, p)
            acc[np.searchsorted(docs, vals)] += m * contrib.astype(np.float64)
        out.append(topk_select(docs, acc, k))
    return out
