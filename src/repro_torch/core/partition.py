"""Partitioning algorithms for the 2-level representation.

* ``optimal_partitioning``      -- the paper's Θ(n)-time / O(1)-space exact
                                   algorithm (Fig. 4 + update Fig. 5 + close
                                   Fig. 6), faithful to the pseudocode.
* ``dp_optimal``                -- O(n^2) exact dynamic program; the oracle the
                                   tests validate optimality against.
* ``eps_optimal``               -- the (1+eps)-approximate sparsified DP of
                                   Ferragina et al. / Ottaviano-Venturini [21,
                                   30], generic in the encoder cost (used both
                                   for VByte eps-opt, Table 3, and PEF).
* ``uniform_partitioning``      -- fixed-size blocks (the `VByte unif.` rows).

Cost convention shared by all algorithms (see DESIGN.md section 8): a
partitioning P = [p_1 < ... < p_m = n] of gap array ``gaps`` costs

    sum over partitions [l, r) of  ( F + min(E(l, r), B(l, r)) )

with E(l, r) = sum of VByte bits of (gap_k - 1) and B(l, r) = sum of gap_k.

Counterpart of the host half of ``repro/core/partition.py``; the scan
formulation of the same state machine arrives with the device partitioner.
"""

from __future__ import annotations

import numpy as np

from .costs import DEFAULT_F, elem_costs_np, gain_deltas_np


# ==========================================================================
# The paper's algorithm (Fig. 4/5/6), faithful translation.
# ==========================================================================

def optimal_partitioning(gaps: np.ndarray, F: int = DEFAULT_F) -> np.ndarray:
    """Return partition endpoints P (strictly increasing, last == n).

    Direct transcription of the paper's pseudocode.  State:
      g        gain relative to the start of the current interval
      mn, mx   min / max gain seen in the current interval
      j, i     positions achieving mn / mx (candidate dominating points
               for encoder E / encoder B respectively)
      T        amortization threshold: F for the first partition, 2F after
    """
    deltas = gain_deltas_np(gaps)
    n = deltas.size
    P: list[int] = []
    if n == 0:
        return np.array([0], dtype=np.int64)

    T = F
    i = j = 0
    g = 0
    mn = mx = 0

    def update(which: str, k: int) -> None:
        # paper Fig. 5: update(g0, g1, p0, p1)
        nonlocal T, i, j, g, mn, mx
        if which == "E":  # update(min, max, j, i): emit j, dominating for E
            P.append(j)
            T = 2 * F
            i = k + 1
            g = g - mn
            mn = 0
            mx = g
        else:  # update(max, min, i, j): emit i, dominating for B
            P.append(i)
            T = 2 * F
            j = k + 1
            g = g - mx
            mx = 0
            mn = g

    # python ints: the same arithmetic as int(deltas[k]), without a numpy
    # scalar per step
    for k, d in enumerate(deltas.tolist()):
        g += d
        if d >= 0:  # g is non-decreasing at this step
            if g > mx:
                mx = g
                i = k + 1
            if mn < -T and mn - g < -2 * F:
                update("E", k)
        else:
            if g < mn:
                mn = g
                j = k + 1
            if mx > T and mx - g > 2 * F:
                update("B", k)

    # close() -- paper Fig. 6
    if mx > F and mx - g > F:
        update("B", n)
    if mn < -F and mn - g < -F:
        update("E", n)
    if g > 0:
        P.append(n)  # update(max, min, n, j): closes with encoder B
    else:
        P.append(n)  # update(min, max, n, i): closes with encoder E

    # P must be strictly increasing; dominating points are unique, but close()
    # can re-emit a boundary equal to the last one when the tail is empty.
    out = []
    last = 0
    for p in P:
        if p > last:
            out.append(p)
            last = p
    if not out or out[-1] != n:
        out.append(n)
    return np.asarray(out, dtype=np.int64)



# ==========================================================================
# Shared cost evaluation
# ==========================================================================

def partition_payload_costs(gaps: np.ndarray, P: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-partition (E_cost, B_cost) in bits for endpoints P."""
    e, b = elem_costs_np(gaps)
    ce = np.concatenate([[0], np.cumsum(e)])
    cb = np.concatenate([[0], np.cumsum(b)])
    P = np.asarray(P, dtype=np.int64)
    starts = np.concatenate([[0], P[:-1]])
    return ce[P] - ce[starts], cb[P] - cb[starts]


def partitioning_cost(gaps: np.ndarray, P: np.ndarray, F: int = DEFAULT_F) -> int:
    """Total bits = m*F + sum of min(E, B) per partition."""
    pe, pb = partition_payload_costs(gaps, P)
    return int(len(P) * F + np.minimum(pe, pb).sum())


def unpartitioned_cost(gaps: np.ndarray, F: int = DEFAULT_F) -> int:
    return partitioning_cost(gaps, np.array([len(gaps)]), F)


# ==========================================================================
# O(n^2) exact DP oracle
# ==========================================================================

def dp_optimal(gaps: np.ndarray, F: int = DEFAULT_F) -> tuple[int, np.ndarray]:
    """Exact DP: dp[r] = min over l < r of dp[l] + F + min(E(l,r), B(l,r))."""
    e, b = elem_costs_np(gaps)
    n = len(gaps)
    ce = np.concatenate([[0], np.cumsum(e)])
    cb = np.concatenate([[0], np.cumsum(b)])
    dp = np.full(n + 1, np.iinfo(np.int64).max, dtype=np.int64)
    parent = np.zeros(n + 1, dtype=np.int64)
    dp[0] = 0
    for r in range(1, n + 1):
        ecost = ce[r] - ce[:r]
        bcost = cb[r] - cb[:r]
        cand = dp[:r] + F + np.minimum(ecost, bcost)
        l = int(np.argmin(cand))
        dp[r] = cand[l]
        parent[r] = l
    # reconstruct
    P = [n]
    cur = n
    while parent[cur] != 0:
        cur = int(parent[cur])
        P.append(cur)
    return int(dp[n]), np.asarray(sorted(P), dtype=np.int64)


# ==========================================================================
# (1+eps)-approximate sparsified DP  (Ferragina et al. / PEF [21, 30])
# ==========================================================================

def eps_optimal(
    gaps: np.ndarray,
    F: int = DEFAULT_F,
    eps1: float = 0.03,
    eps2: float = 0.3,
    cost_fns=None,
) -> np.ndarray:
    """Sparsified shortest-path DP.

    Edges out of every position go to the frontier positions where the window
    cost first crosses each geometric bound F*(1+eps2)^l, capped at L = F/eps1
    (plus the always-present unit edge to keep feasibility).  Window costs are
    monotone in the right endpoint for both encoders, so frontiers are found
    with two pointers / searchsorted on the additive prefix sums.

    ``cost_fns``: optional (prefix_arrays, window_cost(l, r)) override used by
    the PEF competitor model; default is the VByte/bit-vector pair.
    """
    n = len(gaps)
    if n == 0:
        return np.array([0], dtype=np.int64)
    if cost_fns is None:
        e, b = elem_costs_np(gaps)
        ce = np.concatenate([[0], np.cumsum(e)]).astype(np.float64)
        cb = np.concatenate([[0], np.cumsum(b)]).astype(np.float64)

        def window_cost(l: int, r: int) -> float:
            return min(ce[r] - ce[l], cb[r] - cb[l])

        def frontier(l: int, bound: float) -> int:
            # max r such that window_cost(l, r) <= bound (>= l+1)
            re = int(np.searchsorted(ce, ce[l] + bound, side="right")) - 1
            rb = int(np.searchsorted(cb, cb[l] + bound, side="right")) - 1
            return max(re, rb, l + 1)
    else:
        window_cost, frontier = cost_fns

    L = F / max(eps1, 1e-9)
    bounds = []
    c = float(F)
    while c < L:
        bounds.append(c)
        c *= 1.0 + eps2
    bounds.append(L)

    INF = float("inf")
    dp = np.full(n + 1, INF)
    parent = np.zeros(n + 1, dtype=np.int64)
    dp[0] = 0.0
    for l in range(n):
        if dp[l] == INF:
            continue
        tgt = {min(frontier(l, bd), n) for bd in bounds}
        tgt.add(l + 1)
        base = dp[l] + F
        for r in tgt:
            c = base + window_cost(l, r)
            if c < dp[r]:
                dp[r] = c
                parent[r] = l
    P = [n]
    cur = n
    while parent[cur] != 0:
        cur = int(parent[cur])
        P.append(cur)
    return np.asarray(sorted(P), dtype=np.int64)


# ==========================================================================
# Uniform partitioning
# ==========================================================================

def uniform_partitioning(n: int, block: int = 128) -> np.ndarray:
    if n == 0:
        return np.array([0], dtype=np.int64)
    P = np.arange(block, n, block, dtype=np.int64)
    return np.concatenate([P, [n]])
