"""Tiny deterministic corpus for the analyser's dynamic pass.

Counterpart of ``repro/analyze/workload.py``: the same numpy draws, so the
port's audit and the reference's run on one corpus.  The host-sync
auditor has to RUN the engines to see their transfers, so it needs an
index; this one is small enough that the whole audit (build + warm batch
+ audited batch) stays in seconds, and seeded so the measured sync sites
are identical on every machine.

The warm/audit query split is the point: ``WARM_QUERIES`` and
``AUDIT_QUERIES`` touch DISJOINT term sets of the same batch shapes, so
the audited batch runs after every one-time set-up (flat mirror, pivot
chunks, kernel builds) but misses the ranked engine's hot-block score
cache -- a warm cache would hide the score path's device fetch and
under-count the ranked hot path's syncs.
"""

from __future__ import annotations

import functools

import numpy as np

from ..core.index import build_partitioned_index

N_LISTS = 8
WARM_QUERIES = [[0, 1], [1, 2, 3]]
AUDIT_QUERIES = [[4, 5], [5, 6, 7]]


@functools.lru_cache(maxsize=1)
def tiny_ranked_index(seed: int = 0):
    """An 8-list freq-carrying index over a 2000-doc universe, memoized
    (the audit and its tests rebuild engines, never the index)."""
    rng = np.random.default_rng(seed)
    lists, freqs = [], []
    for i in range(N_LISTS):
        vals = np.unique(rng.integers(0, 2_000, 260 + 40 * i))
        lists.append(vals.astype(np.int64))
        freqs.append(rng.integers(1, 9, len(vals)).astype(np.int64))
    return build_partitioned_index(lists, "optimal", freqs=freqs)
