"""Quickstart: the paper's algorithm in five minutes.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Counterpart of ``examples/quickstart.py``, with its asserts and its
printed numbers: a clustered posting list, its optimal partitioning
checked against the exact DP on a prefix, the partitioned index against
the blocked-VByte baseline, and one NextGEQ query, answered by the host
loop and by the index's batched engine on ``device`` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..api import resolve_device
from ..core import (
    QueryEngine,
    build_partitioned_index,
    build_unpartitioned_index,
    dp_optimal,
    gaps_from_sorted,
    optimal_partitioning,
    partitioning_cost,
)
from ..data.postings import make_posting_list


def run(device="cuda") -> dict:
    """The reference script's steps; returns the numbers it prints."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    # 1. a clustered docID sequence (dense runs + sparse jumps, Gov2-calibrated)
    seq = make_posting_list(rng, 50_000, mean_dense_gap=2.13, frac_dense=0.8)
    gaps = gaps_from_sorted(seq)

    # 2. the paper's Theta(n) exact optimal partitioning (Fig. 4-6)
    P = optimal_partitioning(gaps, F=64)
    cost = partitioning_cost(gaps, P, F=64)
    print(f"optimal partitioning: {len(P)} partitions, {cost/len(seq):.2f} bits/int")

    # 3. it really is optimal: compare with the O(n^2) DP oracle on a prefix
    c_dp, _ = dp_optimal(gaps[:300], 64)
    c_fast = partitioning_cost(gaps[:300], optimal_partitioning(gaps[:300], 64), 64)
    assert c_dp == c_fast
    print(f"matches the exact DP oracle on a 300-int prefix: {c_dp} bits")

    # 4. full 2-level index vs the blocked-VByte baseline (the 2x claim)
    idx = build_partitioned_index([seq], "optimal")
    base = build_unpartitioned_index([seq])
    print(f"index space: {idx.bits_per_int():.2f} bpi vs un-partitioned "
          f"{base.bits_per_int():.2f} bpi -> "
          f"{base.bits_per_int()/idx.bits_per_int():.2f}x smaller")

    # 5. query it: the host loop, then the batched engine on the device
    probe = int(seq[1234]) + 1
    v, _ = idx.next_geq(0, probe)
    assert v == int(seq[1235])
    (on_dev,) = QueryEngine(idx, device=dev).next_geq_batch([0], [probe])
    assert on_dev == v
    print(f"NextGEQ({probe}) = {v}  (correct)")
    return {"partitions": len(P), "bits_per_int": cost / len(seq),
            "dp_bits": int(c_dp), "bpi": idx.bits_per_int(),
            "base_bpi": base.bits_per_int(), "next_geq": int(v)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
