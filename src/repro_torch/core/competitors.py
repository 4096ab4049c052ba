"""Space cost models for the paper's Table 6 competitors.

Counterpart of ``repro/core/competitors.py``: host numpy, copied so the
port imports nothing of the reference, and giving the same integers.
Exact bit-counting models (no decoders):

  * Elias-Fano (EF) and partitioned Elias-Fano (PEF, uniform + eps-optimal DP
    with the same sparsified machinery as ``partition.eps_optimal``),
  * Binary Interpolative Coding (BIC) -- exact recursive bit count,
  * OptPFD -- per-128-block exhaustive (b, exceptions) optimization,
  * byte-wise ANS -- order-0 entropy of the VByte byte stream (an estimate of
    Moffat-Petri's byte-aligned ANS; marked as such in benchmarks).

All costs are in bits for one strictly-increasing sequence.
"""

from __future__ import annotations

import math

import numpy as np

from .costs import DEFAULT_F, bit_length_np, gaps_from_sorted


# --------------------------------------------------------------------------
# Elias-Fano
# --------------------------------------------------------------------------

def ef_cost_bits(n: int, u: int) -> int:
    """Classic EF: n * (2 + max(0, ceil(log2(u/n))))  (+ no index overhead)."""
    if n == 0:
        return 0
    if u <= 0:
        return 2 * n
    l = max(0, int(math.ceil(math.log2(max(u, 1) / n))))
    return n * (l + 2)


def elias_fano_sequence_cost(seq: np.ndarray) -> int:
    seq = np.asarray(seq, dtype=np.int64)
    return ef_cost_bits(len(seq), int(seq[-1]) + 1)


# --------------------------------------------------------------------------
# Partitioned Elias-Fano (uniform and eps-optimal, [21])
# --------------------------------------------------------------------------

def _pef_partition_cost(n: int, u: int) -> int:
    """Per-partition PEF cost: min(EF, characteristic bit-vector, run).

    The run encoder costs 0 payload bits when the partition is the dense
    run [base+1 .. base+n] (u == n).
    """
    if u == n:
        return 0
    return min(ef_cost_bits(n, u), u)


def pef_uniform_cost(seq: np.ndarray, F: int = DEFAULT_F, block: int = 128) -> int:
    seq = np.asarray(seq, dtype=np.int64)
    n = len(seq)
    total = 0
    base = -1
    for s in range(0, n, block):
        r = min(s + block, n)
        u = int(seq[r - 1]) - base
        total += F + _pef_partition_cost(r - s, u)
        base = int(seq[r - 1])
    return total


def pef_eps_optimal_cost(
    seq: np.ndarray, F: int = DEFAULT_F, eps1: float = 0.03, eps2: float = 0.3
) -> int:
    """eps-optimal DP with the PEF cost function (monotone in the endpoint)."""
    seq = np.asarray(seq, dtype=np.int64)
    n = len(seq)
    if n == 0:
        return 0

    def window_cost(l: int, r: int) -> float:
        base = int(seq[l - 1]) if l > 0 else -1
        u = int(seq[r - 1]) - base
        return float(_pef_partition_cost(r - l, u))

    def frontier(l: int, bound: float) -> int:
        # max r with window_cost(l, r) <= bound; cost is monotone in r
        lo, hi = l + 1, n
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if window_cost(l, mid) <= bound:
                lo = mid
            else:
                hi = mid - 1
        return lo

    from .partition import eps_optimal

    P = eps_optimal(
        np.ones(n, dtype=np.int64),  # gaps unused with cost_fns override
        F=F,
        eps1=eps1,
        eps2=eps2,
        cost_fns=(window_cost, frontier),
    )
    total = 0
    prev = 0
    for r in P:
        total += F + int(window_cost(prev, int(r)))
        prev = int(r)
    return total


# --------------------------------------------------------------------------
# Binary Interpolative Coding (exact recursive bit count)
# --------------------------------------------------------------------------

def bic_cost_bits(seq: np.ndarray, lo: int | None = None, hi: int | None = None) -> int:
    """Exact BIC cost: middle element coded in ceil(log2(range)) bits."""
    seq = np.asarray(seq, dtype=np.int64)
    total = 0
    stack = [(0, len(seq), -1 if lo is None else lo, int(seq[-1]) + 1 if hi is None else hi)]
    # encode within open interval (lo, hi): values strictly between
    while stack:
        s, e, l, h = stack.pop()
        n = e - s
        if n == 0:
            continue
        if h - l - 1 == n:
            continue  # dense run: zero bits (classic BIC optimization)
        mid = s + n // 2
        v = int(seq[mid])
        # v lies in [l + 1 + (mid - s), h - 1 - (e - 1 - mid)]
        lo_v = l + 1 + (mid - s)
        hi_v = h - 1 - (e - 1 - mid)
        r = hi_v - lo_v + 1
        if r > 1:
            total += max(1, int(math.ceil(math.log2(r))))
        stack.append((s, mid, l, v))
        stack.append((mid + 1, e, v, h))
    return total + 32  # per-list header (n, universe)


# --------------------------------------------------------------------------
# OptPFD (per-block optimal b + exceptions)
# --------------------------------------------------------------------------

def optpfd_cost_bits(seq: np.ndarray, block: int = 128) -> int:
    """Classic OptPFD model: payload b bits/value, exceptions stored aside.

    Exception cost model: 8 bits position + (maxbits - b) bits value remainder,
    plus an 8-bit block header; per block choose b minimizing the total.
    """
    gaps = gaps_from_sorted(np.asarray(seq, dtype=np.int64)) - 1
    bits = bit_length_np(np.maximum(gaps, 0))
    bits = np.where(gaps == 0, 0, bits)
    total = 0
    for s in range(0, len(gaps), block):
        blk = bits[s : s + block]
        nb = len(blk)
        maxb = int(blk.max()) if nb else 0
        best = 8 + nb * maxb
        for b in range(0, maxb):
            exc = blk > b
            n_exc = int(exc.sum())
            cost = 8 + nb * b + n_exc * (8 + maxb - b)
            if cost < best:
                best = cost
        total += best
    return total


# --------------------------------------------------------------------------
# Byte-wise ANS (order-0 entropy estimate of the VByte byte stream)
# --------------------------------------------------------------------------

def ans_cost_bits(seq: np.ndarray, table_overhead_bits: int = 256 * 12) -> int:
    from .vbyte import vbyte_encode

    gaps = gaps_from_sorted(np.asarray(seq, dtype=np.int64))
    stream = vbyte_encode((gaps - 1).astype(np.uint64))
    counts = np.bincount(stream, minlength=256).astype(np.float64)
    p = counts[counts > 0] / stream.size
    h0 = float(-(p * np.log2(p)).sum())
    return int(math.ceil(stream.size * h0)) + table_overhead_bits
