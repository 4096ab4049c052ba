"""Partitioning algorithms for the 2-level representation.

* ``optimal_partitioning``      -- the paper's Θ(n)-time / O(1)-space exact
                                   algorithm (Fig. 4 + update Fig. 5 + close
                                   Fig. 6), faithful to the pseudocode.
* ``optimal_partitioning_scan`` -- the same state machine as a scan (one step
                                   per element, O(1) int32 carry), run by the
                                   CUDA kernel ``partition_scan`` on the card;
                                   ``optimal_partitioning_via_scan`` wraps it.
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

Counterpart of ``repro/core/partition.py``; its ``lax.scan`` becomes the
CUDA kernel ``kernels/partition_scan``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..api import resolve_device
from ..kernels.partition_scan.kernel import partition_scan, partition_scan_bounds
from .costs import DEFAULT_F, elem_costs_np, gain_deltas_np


# ==========================================================================
# The paper's algorithm (Fig. 4/5/6), faithful translation.
# ==========================================================================

def optimal_partitioning(gaps: np.ndarray, F: int = DEFAULT_F) -> np.ndarray:
    """Return partition endpoints P (strictly increasing, last == n)."""
    deltas = gain_deltas_np(gaps)
    return _state_machine(deltas, F, deltas.size)


def _state_machine(deltas: np.ndarray, F: int, n: int) -> np.ndarray:
    """The paper's O(1)-space dominating-point machine (Fig. 4, update
    Fig. 5) over the first n per-element gain deltas; shared by
    ``optimal_partitioning`` and the blocked partitioner.  State:
      g        gain relative to the start of the current interval
      mn, mx   min / max gain seen in the current interval
      j, i     positions achieving mn / mx (candidate dominating points
               for encoder E / encoder B respectively)
      T        amortization threshold: F for the first partition, 2F after
    """
    if n == 0:
        return np.array([0], dtype=np.int64)
    P: list[int] = []
    T = F
    i = j = 0
    g = 0
    mn = mx = 0
    # python ints: the same arithmetic as int(deltas[k]), without a numpy
    # scalar per step
    for k, d in enumerate(deltas[:n].tolist()):
        g += d
        if d >= 0:  # g is non-decreasing at this step
            if g > mx:
                mx, i = g, k + 1
            if mn < -T and mn - g < -2 * F:
                # update(min, max, j, i): emit j, dominating for E
                P.append(j)
                T, i, g = 2 * F, k + 1, g - mn
                mn, mx = 0, g
        else:
            if g < mn:
                mn, j = g, k + 1
            if mx > T and mx - g > 2 * F:
                # update(max, min, i, j): emit i, dominating for B
                P.append(i)
                T, j, g = 2 * F, k + 1, g - mx
                mx, mn = 0, g
    return _close(P, i, j, g, mn, mx, F, n)


def _close(P: list, i: int, j: int, g: int, mn: int, mx: int, F: int,
           n: int) -> np.ndarray:
    """close() -- paper Fig. 6 -- on the machine's final state, then P as
    strictly increasing endpoints ending at n."""
    # after either update the other's test fails: its gap is then 0
    if mx > F and mx - g > F:
        P.append(i)  # update(max, min, i, j)
    elif mn < -F and mn - g < -F:
        P.append(j)  # update(min, max, j, i)
    P.append(n)  # encoder B closes when g > 0, encoder E otherwise
    # dominating points are unique, but close() can re-emit a boundary
    # equal to the last one when the tail is empty
    out: list[int] = []
    last = 0
    for p in P:
        if p > last:
            out.append(p)
            last = p
    return np.asarray(out, dtype=np.int64)


# ==========================================================================
# Same state machine as a scan on the card.
# ==========================================================================

def _deltas_on(deltas, device) -> torch.Tensor:
    return torch.as_tensor(deltas).to(resolve_device(device), torch.int32).contiguous()


def optimal_partitioning_scan(deltas, F: int = DEFAULT_F, device="cuda"):
    """Scan version.  Input: per-element gain deltas (int32).

    Returns (carry, boundary_mask, boundary_pos) as tensors on ``device``
    (the card unless the caller passes ``device="cpu"``): carry [7] int32 is
    (T, i, j, g, mn, mx, k) after the last step; for step k, if the state
    machine emitted a partition boundary, mask[k] = True and pos[k] is the
    boundary.  The final close() boundaries come from the carry, appended by
    the host-side wrapper ``optimal_partitioning_via_scan``.
    """
    return partition_scan(_deltas_on(deltas, device), F)


def optimal_partitioning_via_scan(gaps: np.ndarray, F: int = DEFAULT_F,
                                  device="cuda") -> np.ndarray:
    """Host wrapper: deltas on the host, the scan on ``device``, then close()
    on the final carry.  Only the carry and the emitted boundaries come
    back (two fetches: the carry with their count, then the boundaries);
    the ``partition_scan`` span of ``repro_torch.obs`` times the copy up,
    the scan and both fetches."""
    deltas = gain_deltas_np(gaps)
    n = int(deltas.shape[0])
    if n == 0:
        return np.array([0], dtype=np.int64)
    with obs.span("partition_scan"):
        carry, bounds = partition_scan_bounds(_deltas_on(deltas, device), F)
        _T, i, j, g, mn, mx, _k, m = carry.tolist()
        P = bounds[:m].tolist()
    return _close(P, i, j, g, mn, mx, F, n)


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
